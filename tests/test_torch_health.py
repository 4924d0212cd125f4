"""paddle_tpu_torch.health against the JAX package's paddle_tpu.health.

The nets and state of test_torch_monitor_step (the README MLP with Adam, a
2-layer conv net with Momentum; the JAX package's seeded startup state
carried into the port), run with FLAGS_health=1 in both packages: the
ledger records' stats agree at rtol 1e-5 in fp32 (single steps and an
iters=2 run, FLAGS_health_interval sampling), the gauges have the same
series, detectors fed one record sequence fire the same events, and
compare_ledgers of a JAX ledger and a port ledger of the same 20-step MLP
run reports parity. In the port alone: the stats of the captured step
(test_torch_step's recording stand-in for the CUDA graph) equal the
interpreter's bitwise, with the fused update writing the parameters in
place, and agree with a float64 host recompute from the interpreter's
fetched grads and its parameters before and after; a fused program's plan
watches every member of a bucket; toggling FLAGS_health prepares and
captures the step anew. The `cuda` case holds graph and interpreter
bitwise on a card.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu import health as jhealth
from paddle_tpu import monitor as jmonitor

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert, flags, health, monitor

from test_torch_monitor_step import (  # noqa: F401 (fixtures too)
    MODELS, _fresh_state, batches, build, cuda_device, jax_init, setup)
from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)

RTOL = 1e-5


def ledger_run(pkg, model, init, path, steps=3, iters_runs=1, fuse=False,
               place=None, **flag_values):
    """`steps` single steps then `iters_runs` iters=2 runs with
    FLAGS_monitor and FLAGS_health=1 (the health gauges go to the monitor
    registry) and a ledger at `path`: the ledger's records."""
    fluid, main, loss, scope = setup(pkg, model, init, place)
    fl = jflags if pkg == "jax" else flags
    bs = batches(model, steps + 2 * iters_runs)
    with fluid.scope_guard(scope), \
            fl.flag_guard(**{"monitor": True, "health": 1,
                             "health_ledger": path, "fuse": fuse,
                             **flag_values}):
        exe = fluid.Executor(place or fluid.CPUPlace())
        for b in bs[:steps]:
            exe.run(main, feed=b, fetch_list=[loss])
        for k in range(iters_runs):
            exe.run(main, feed=bs[steps + 2 * k:steps + 2 * k + 2],
                    fetch_list=[loss], iters=2)
    (jhealth if pkg == "jax" else health).ledger.reset()
    return (jhealth if pkg == "jax" else health).read_ledger(path)


def assert_records_close(got, want, rtol=RTOL):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert g["kind"] == w["kind"]
        assert sorted(g) == sorted(w)
        assert g["nonfinite_params"] == w["nonfinite_params"]
        assert g["events"] == w["events"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)
        np.testing.assert_allclose(g["global_grad_norm"],
                                   w["global_grad_norm"], rtol=rtol)
        assert sorted(g["params"]) == sorted(w["params"])
        for label, st in w["params"].items():
            for k in ("grad_norm", "weight_norm", "update_ratio"):
                np.testing.assert_allclose(g["params"][label][k], st[k],
                                           rtol=rtol, err_msg=(label, k))
            assert g["params"][label]["nonfinite"] == st["nonfinite"]


@pytest.mark.parametrize("model", MODELS)
def test_stats_agree_with_jax(tmp_path, model):
    init = jax_init(model)
    got = {pkg: ledger_run(pkg, model, init, str(tmp_path / f"{pkg}.jsonl"))
           for pkg in ("jax", "port")}
    assert [r["step"] for r in got["port"]] == [0, 1, 2, 3, 4]
    assert_records_close(got["port"], got["jax"])
    assert health.last_record()["step"] == 4
    # the same gauge series in both registries
    keys = {pkg: sorted(k for k in mon.registry().snapshot()
                        if k.startswith("health_"))
            for pkg, mon in (("jax", jmonitor), ("port", monitor))}
    assert keys["port"] == keys["jax"] and keys["port"]


def test_interval_samples_the_same_steps(tmp_path):
    init = jax_init("mlp")
    got = {pkg: ledger_run(pkg, "mlp", init, str(tmp_path / f"{pkg}.jsonl"),
                           steps=3, iters_runs=2, health_interval=2)
           for pkg in ("jax", "port")}
    assert [r["step"] for r in got["port"]] == [0, 2, 4, 6]
    assert_records_close(got["port"], got["jax"])


def test_the_journal_carries_the_health_summary(tmp_path):
    init = jax_init("mlp")
    recs = {}
    for pkg in ("jax", "port"):
        mon = jmonitor if pkg == "jax" else monitor
        fl = jflags if pkg == "jax" else flags
        with fl.flag_guard(monitor=True,
                           monitor_journal=str(tmp_path / f"{pkg}.j")):
            ledger_run(pkg, "mlp", init, str(tmp_path / f"{pkg}.h"),
                       steps=2, iters_runs=0)
        mon.reset()
        recs[pkg] = mon.read_journal(str(tmp_path / f"{pkg}.j"))
    for pkg, rs in recs.items():
        # (the JAX package's startup run journals a record too)
        assert [r["health"]["step"] for r in rs if "health" in r] == [0, 1]
    assert sorted(recs["port"][-1]["health"]) == \
        sorted(recs["jax"][-1]["health"])


def _records(seq):
    return [{"step": i, "loss": loss, "global_grad_norm": g,
             "nonfinite_params": bad, "params": {}}
            for i, (loss, g, bad) in enumerate(seq)]


SEQUENCES = {
    "spike": [(1.0 - 0.01 * i, 1.0, 0) for i in range(12)]
    + [(9.0, 1.0, 0), (0.85, 1.0, 0)],
    "explode_vanish": [(1.0, 1.0 + 0.01 * i, 0) for i in range(8)]
    + [(1.0, 500.0, 0), (1.0, 2e4, 0), (1.0, 1e-12, 0)],
    "nonfinite": [(1.0, 1.0, 0), (float("nan"), 1.0, 0),
                  (1.0, float("inf"), 2), (1.0, 1.0, 0)],
    "divergence": [(1.0, 1.0, 0)] * 3 + [(50.0 * (i + 1), 1.0, 0)
                                         for i in range(12)],
    "plateau": [(1.0, 1.0, 0)] * 12,
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_detectors_fire_the_same_events(name):
    settings = {"monitor": True, "health_plateau_patience": 4,
                "health_ema": 0.5}
    got = {}
    for pkg, h, fl in (("jax", jhealth, jflags), ("port", health, flags)):
        bank = h.DetectorBank()
        with fl.flag_guard(**settings):
            got[pkg] = [(bank.observe(r), r["loss_ema"])
                        for r in _records(SEQUENCES[name])]
        got[pkg + "_queued"] = h.drain_events()
    assert got["port"] == got["jax"]
    assert got["port_queued"] == got["jax_queued"]
    assert any(events for events, _ in got["port"])
    snap = {pkg: {k: v for k, v in mon.registry().snapshot().items()
                  if k.startswith("health_events_total")}
            for pkg, mon in (("jax", jmonitor), ("port", monitor))}
    assert snap["port"] == snap["jax"]


def test_ledgers_of_the_same_run_report_parity(tmp_path):
    """The JAX package's ledger and the port's of the same 20-step MLP run
    (same state, same batches), compared in both directions by both
    packages' compare_ledgers: parity at the default tolerances."""
    init = jax_init("mlp")
    led = {pkg: ledger_run(pkg, "mlp", init, str(tmp_path / f"{pkg}.jsonl"),
                           steps=20, iters_runs=0)
           for pkg in ("jax", "port")}
    for h in (health, jhealth):
        for a, b in (("jax", "port"), ("port", "jax")):
            rep = h.compare_ledgers(led[a], led[b])
            assert rep["ok"], rep
            assert rep["common_steps"] == 20
            assert rep["traj_max_abs_diff"] < 1e-5
    assert health.summarize_ledger(led["port"]) == \
        jhealth.summarize_ledger(led["port"])
    assert health.compare.format_ledger_summary(
        health.summarize_ledger(led["port"])) == \
        jhealth.compare.format_ledger_summary(
            jhealth.summarize_ledger(led["port"]))


def _stats_run(model, init, feeds, fetch_grads=False, iters=None):
    """One run of `model` with FLAGS_fuse (the update in place) and
    FLAGS_health: (its last record's params, the fetched grads, the
    parameters before and after, the step mode)."""
    fluid, main, loss, scope = setup("port", model, init)
    plan = health.plan_for(main)
    before = convert.numpy_state(scope, main)
    fetch = [loss] + (plan.fetch_names if fetch_grads else [])
    with fluid.scope_guard(scope), flags.flag_guard(health=1, fuse=True):
        exe = fluid.Executor(fluid.CPUPlace())
        for f in feeds[:-1]:
            exe.run(main, feed=f, fetch_list=fetch, iters=iters)
        before = convert.numpy_state(scope, main)
        outs = exe.run(main, feed=feeds[-1], fetch_list=fetch, iters=iters)
        mode = exe.step_mode(main)
    after = convert.numpy_state(scope, main)
    grads = dict(zip(plan.labels, outs[1:]))
    return health.last_record()["params"], grads, before, after, mode


@pytest.mark.parametrize("iters", [None, 2])
@pytest.mark.parametrize("model", MODELS)
def test_captured_stats_equal_the_interpreter_bitwise(recorded_graphs, model,
                                                      iters):
    """Health on, the fused update writing the parameters in place: the
    eager first step, the capture and its replays give the interpreter's
    stats bit for bit."""
    init = jax_init(model)
    bs = batches(model, 6)
    feeds = bs[:3] if iters is None else [bs[0:2], bs[2:4], bs[4:6]]
    want = None
    with flags.flag_guard(cuda_graph=False):
        want = _stats_run(model, init, feeds, iters=iters)
    got = _stats_run(model, init, feeds, iters=iters)
    assert (want[-1], got[-1]) == ("interpreter", "graph")
    assert got[0] == want[0]


@pytest.mark.parametrize("model", MODELS)
def test_stats_agree_with_a_float64_host_recompute(model):
    """One step's stats against float64 sums over the interpreter's fetched
    grads and its parameters before and after the (in-place) update."""
    init = jax_init(model)
    params, grads, before, after, _ = _stats_run(
        model, init, batches(model, 2), fetch_grads=True)
    assert sorted(params) == sorted(grads) and params
    for label, st in params.items():
        g = np.asarray(grads[label], np.float64)
        w0 = before[label].astype(np.float64)
        w1 = after[label].astype(np.float64)
        np.testing.assert_allclose(st["grad_norm"], math.sqrt((g * g).sum()),
                                   rtol=1e-6, err_msg=label)
        np.testing.assert_allclose(st["weight_norm"],
                                   math.sqrt((w1 * w1).sum()), rtol=1e-6)
        dn = math.sqrt(((w1 - w0) ** 2).sum())
        np.testing.assert_allclose(st["update_ratio"],
                                   dn / math.sqrt((w1 * w1).sum()),
                                   rtol=1e-5, err_msg=label)
        assert st["nonfinite"] == 0


def test_a_fused_plan_watches_every_bucket_member():
    """The fused update names its bucket's members in its Param/Grad slots,
    pair by pair: the plan of the fused clone watches the parameters the
    unfused program's plan watches (the JAX package's plan_for reads only
    the first pair of each op)."""
    from paddle_tpu_torch import fusion

    main, _, loss = build(tfluid, "conv")
    fused, fplan = fusion.apply(main, feed_names=["img", "label"],
                                fetch_names=[loss.name])
    assert any(b["n"] > 1 for b in fplan.buckets)
    assert sorted(health.plan_for(fused).labels) == \
        sorted(health.plan_for(main).labels)
    assert len(health.plan_for(main).labels) == 6


def test_toggling_health_prepares_and_captures_anew(recorded_graphs):
    init = jax_init("conv")
    fluid, main, loss, scope = setup("port", "conv", init)
    b = batches("conv", 1)[0]
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        entries = []
        for on in (0, 0, 1, 1, 1, 0):
            with flags.flag_guard(health=on):
                exe.run(main, feed=b, fetch_list=[loss])
            entries.append(exe.compile_cache_info()["entries"])
        assert exe.step_mode(main) == "graph"
    # health off: a prepare (its eager step), then the capture; on: a
    # prepare of its own (eager), then its capture, then a replay; off
    # again: the first graph, replayed
    assert entries == [1, 2, 3, 4, 4, 4]
    assert health.last_record()["step"] == 4


def test_health_off_is_one_flag_check_and_writes_nothing(tmp_path):
    init = jax_init("mlp")
    fluid, main, loss, scope = setup("port", "mlp", init)
    path = tmp_path / "ledger.jsonl"
    with fluid.scope_guard(scope), flags.flag_guard(health_ledger=str(path)):
        assert health.plan_if_enabled(main) is None
        fluid.Executor(fluid.CPUPlace()).run(
            main, feed=batches("mlp", 1)[0], fetch_list=[loss])
    assert health.last_record() is None and not path.exists()
    assert not [k for k in monitor.registry().snapshot()
                if k.startswith("health_")]


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_captured_stats_equal_the_interpreter_on_the_card(cuda_device,
                                                          model):
    init = jax_init(model)
    bs = batches(model, 4)
    feeds = [bs[0:2], bs[2:4]]
    got = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for graph in (True, False):
            fluid, main, loss, scope = setup("port", model, init,
                                             tfluid.CUDAPlace(0))
            with fluid.scope_guard(scope), \
                    flags.flag_guard(health=1, fuse=True, cuda_graph=graph):
                exe = fluid.Executor(tfluid.CUDAPlace(0))
                for f in feeds:
                    exe.run(main, feed=f, fetch_list=[loss], iters=2)
                got[exe.step_mode(main)] = health.last_record()["params"]
    finally:
        torch.backends.cudnn.deterministic = prev
    assert got["graph"] == got["interpreter"]
