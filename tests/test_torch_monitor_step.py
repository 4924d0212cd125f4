"""The port's step monitor (paddle_tpu_torch.monitor: step.py, journal.py,
mfu.py, skew.py), FLAGS_benchmark and FLAGS_check_nan_inf, held against
the JAX package's on the same runs.

Two nets, built by the same layer calls in both packages: the README's MLP
(784-64-10, Adam) and a 2-layer conv net (two 3x3 convolutions, an fc,
Momentum). The JAX package's seeded startup state is carried into the port
with convert.load_numpy_state and both are fed the same seeded numpy
batches. Checked: the journal records (keys, step, kind, iters, cache
outcome), the disabled mode's single flag check, replica_skew, mfu and the
peak table, the compile probe's FLOPs against the exact matmul and
convolution count of the step (the derived grads' recomputed forward not
counted), the FLAGS_benchmark gauge and stderr line, the NaN check's
naming on the interpreter (against the JAX package's eager path) and on
the captured step (against its compiled step; on the CPU through
test_torch_step's recording stand-in for the CUDA graph), every ported
flag's default, and ParallelExecutor at W = 2 gloo ranks (kind
"parallel_executor", per-rank skew). The `cuda` cases run the monitored
graph path on a card and skip here.
"""

import re

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import health as jhealth
from paddle_tpu import monitor as jmonitor
from paddle_tpu import trace as jtrace
from paddle_tpu.core import executor_core as jcore

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert, flags, health, monitor, trace
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope

import torch_dp_worker as worker
from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)

BATCH = {"mlp": 8, "conv": 4}
SHAPE = {"mlp": [784], "conv": [1, 8, 8]}
MODELS = ("mlp", "conv")


def reset_state():
    """Fresh programs, scope and names in the port; fresh monitor, trace,
    health and flags in both packages (so that FLAGS_monitor is on, its
    default, for the next test whatever this one set)."""
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    for pkg in (monitor, jmonitor, trace, jtrace, health, jhealth):
        pkg.reset()
    flags.reset()
    jflags.reset()


@pytest.fixture(autouse=True)
def _fresh_state():
    torch.set_num_threads(2)
    reset_state()
    yield
    reset_state()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step runs there")
    return torch.device("cuda", 0)


def build(fluid, model):
    """(main, startup, loss) of `model` under a fresh unique_name.guard, so
    both packages name every var alike."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        img = fluid.layers.data(name="img", shape=SHAPE[model],
                                dtype="float32")
        if model == "mlp":  # the README's
            hidden = fluid.layers.fc(input=img, size=64, act="relu")
            probs = fluid.layers.fc(input=hidden, size=10, act="softmax")
            opt = fluid.optimizer.AdamOptimizer(learning_rate=0.003)
        else:
            c1 = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                     padding=1, act="relu")
            c2 = fluid.layers.conv2d(c1, num_filters=6, filter_size=3,
                                     padding=1, act="relu")
            probs = fluid.layers.fc(input=c2, size=10, act="softmax")
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=probs, label=label))
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss


def batches(model, n, seed=5):
    rs = np.random.RandomState(seed)
    return [{"img": rs.rand(BATCH[model], *SHAPE[model]).astype(np.float32),
             "label": rs.randint(0, 10, (BATCH[model], 1)).astype(np.int64)}
            for _ in range(n)]


def jax_init(model):
    main, startup, _ = build(jfluid, model)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(scope.find_var(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def setup(pkg, model, init, place=None):
    """(fluid, main, loss, scope) with `init` loaded: the JAX package's
    startup run, the port's carried over with convert."""
    fluid = jfluid if pkg == "jax" else tfluid
    main, startup, loss = build(fluid, model)
    scope = fluid.Scope()
    if pkg == "jax":
        with jfluid.scope_guard(scope):
            jfluid.Executor(jfluid.CPUPlace()).run(startup)
    else:
        convert.load_numpy_state(scope, main, init,
                                 place or tfluid.CPUPlace())
    return fluid, main, loss, scope


def journaled_runs(pkg, model, init, path):
    """Three single steps on one executor, then two iters=2 runs on a
    second: the journal's records."""
    fluid, main, loss, scope = setup(pkg, model, init)
    fl, mon = (jflags, jmonitor) if pkg == "jax" else (flags, monitor)
    bs = batches(model, 7)
    mon.reset()
    # FLAGS_monitor on explicitly: a test file run before this one on the
    # same worker may have left it off in either package
    with fluid.scope_guard(scope), \
            fl.flag_guard(monitor=True, monitor_journal=path):
        exe = fluid.Executor(fluid.CPUPlace())
        for b in bs[:3]:
            exe.run(main, feed=b, fetch_list=[loss])
        exe = fluid.Executor(fluid.CPUPlace())
        for k in (3, 5):
            exe.run(main, feed=bs[k:k + 2], fetch_list=[loss], iters=2)
    mon.reset()  # closes the journal
    return mon.read_journal(path)


@pytest.mark.parametrize("model", MODELS)
def test_journal_records_match_jax(tmp_path, model):
    init = jax_init(model)
    got = {pkg: journaled_runs(pkg, model, init,
                               str(tmp_path / f"{pkg}.jsonl"))
           for pkg in ("jax", "port")}
    for pkg, recs in got.items():
        assert [r["step"] for r in recs] == [1, 2, 3, 4, 5], pkg
        assert [r["kind"] for r in recs] == ["executor"] * 5
        assert [r["iters"] for r in recs] == [None] * 3 + [2, 2]
        assert [r["cache"] for r in recs] == ["miss", "hit", "hit",
                                              "miss", "hit"]
        for r in recs:
            assert r["total_ms"] > 0
            assert {"feed_encode", "fetch_readback"} <= set(r["phases_ms"])
            assert ("compile" in r["phases_ms"]) == (r["cache"] == "miss")
    assert [sorted(r) for r in got["port"]] == \
        [sorted(r) for r in got["jax"]]
    # a hit is dispatch only; a miss's first step is compile work
    for r in got["port"]:
        if r["cache"] == "hit":
            assert set(r["phases_ms"]) == {"feed_encode", "dispatch",
                                           "fetch_readback"}
    single_miss = got["port"][0]["phases_ms"]
    assert set(single_miss) == set(got["jax"][0]["phases_ms"])


@pytest.mark.parametrize("model", MODELS)
def test_summaries_of_the_same_records_are_equal(tmp_path, model):
    init = jax_init(model)
    for pkg in ("jax", "port"):
        recs = journaled_runs(pkg, model, init,
                              str(tmp_path / f"{pkg}.jsonl"))
        port_sum = monitor.summarize_journal(recs)
        assert port_sum == jmonitor.summarize_journal(recs)
        assert monitor.format_summary(port_sum) == \
            jmonitor.format_summary(port_sum)
        assert port_sum["steps"] == 5
        assert port_sum["cache"] == {"hit": 3, "miss": 2}


def _tiny(fluid):
    main, startup, loss = build(fluid, "mlp")
    return main, startup, loss


def test_disabled_mode_is_one_flag_check(monkeypatch):
    """FLAGS_monitor=0: exe.run costs exactly ONE monitor.enabled() call —
    no StepRecord, no registry mutation, no last_step capture (the JAX
    package's tests/test_monitor.py case)."""
    main, startup, loss = _tiny(tfluid)
    feed = batches("mlp", 1)[0]
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])  # warm the cache
        monitor.reset()

        calls = []
        real_enabled = monitor.enabled
        monkeypatch.setattr(monitor, "enabled",
                            lambda: calls.append(1) or real_enabled())

        def boom(*a, **k):  # step_begin must never run when disabled
            raise AssertionError("step_begin called with FLAGS_monitor=0")

        monkeypatch.setattr(monitor, "step_begin", boom)
        with flags.flag_guard(monitor=False):
            exe.run(main, feed=feed, fetch_list=[loss])
            assert len(calls) == 1
            exe.run(main, feed=feed, fetch_list=[loss])
            assert len(calls) == 2
    assert monitor.last_step() is None
    assert monitor.registry().snapshot() == {}


def test_monitor_is_on_by_default_and_counts_every_run():
    assert flags.get("monitor") is True
    main, startup, loss = _tiny(tfluid)
    feed = batches("mlp", 1)[0]
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss])
    snap = monitor.registry().snapshot()
    assert snap['steps_total{kind="executor"}'] == 4
    assert snap['compile_cache_misses_total{cache="executor"}'] == 2
    assert snap['compile_cache_hits_total{cache="executor"}'] == 2
    assert monitor.steps_done() == 4
    last = monitor.last_step()
    assert last["cache"] == "hit" and last["iters"] is None
    info = monitor.compile_info()
    assert last["fingerprint"] in info and info[last["fingerprint"]][
        "wall_s"] > 0


@pytest.mark.parametrize("times,ids", [
    ([10.0, 10.5, 31.0, 9.75], None),
    ([4.0, 4.0], [3, 7]),
    ([0.0, 0.0, 0.0], None),
    ([12.5], [0]),
])
def test_replica_skew_matches_jax(times, ids):
    assert monitor.replica_skew(times, ids) == \
        jmonitor.replica_skew(times, ids)


class _Kind:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("kind", [
    "TPU v4", "TPU v5 lite", "TPU v5p", "TPU v6 lite", "TPU v3", "cpu",
    "Some Future Chip"])
def test_peak_table_matches_jax_on_its_kinds(kind):
    for name, tflops in jmonitor.CHIP_PEAK_TFLOPS.items():
        assert monitor.CHIP_PEAK_TFLOPS[name] == tflops
    assert monitor.chip_peak_flops(_Kind(kind)) == \
        jmonitor.chip_peak_flops(_Kind(kind))
    for override in (0.0, 123.5):
        with flags.flag_guard(monitor_chip_peak_tflops=override), \
                jflags.flag_guard(monitor_chip_peak_tflops=override):
            assert monitor.chip_peak_flops(_Kind(kind)) == \
                jmonitor.chip_peak_flops(_Kind(kind))


def test_h100_peaks_are_the_dense_data_sheet_figures(monkeypatch):
    assert monitor.chip_peak_flops(_Kind("NVIDIA H100 80GB HBM3")) == \
        989.4e12
    assert monitor.chip_peak_flops(_Kind("NVIDIA H100 PCIe")) == 756.5e12
    assert monitor.chip_peak_flops(_Kind("NVIDIA H100 NVL")) is None
    assert monitor.chip_peak_flops(torch.device("cpu")) is None
    # a card is read by its torch.cuda name
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert monitor.chip_peak_flops() == 989.4e12
    assert monitor.chip_peak_flops(torch.device("cuda", 0)) == 989.4e12
    with flags.flag_guard(monitor_chip_peak_tflops=500.0):
        assert monitor.chip_peak_flops() == 500e12


@pytest.mark.parametrize("args", [
    (24.6e9 * 128, 5.42, 989.4e12), (1e12, 2.0, None), (None, 2.0, 1e15),
    (3e9, 0.0, 1e15)])
def test_mfu_matches_jax(args):
    flops, sps, peak = args
    dev = _Kind("TPU v4")
    assert monitor.mfu(flops, sps, peak_flops=peak, device=dev) == \
        jmonitor.mfu(flops, sps, peak_flops=peak, device=dev)


def step_matmul_flops(model):
    """The exact matmul and convolution FLOPs of one training step of
    `model` (2 a multiply-add): each forward product once, and in the
    backward one product for the weight's grad and one for the input's,
    where the input has a grad (not the fed image)."""
    b = BATCH[model]
    if model == "mlp":
        fc1, fc2 = 2 * b * 784 * 64, 2 * b * 64 * 10
        return (fc1 + fc2) + (fc1 + 2 * fc2)
    conv1 = 2 * b * 64 * 4 * 1 * 9    # 8x8 out, 4 filters of 1x3x3
    conv2 = 2 * b * 64 * 6 * 4 * 9    # 6 filters of 4x3x3
    fc = 2 * b * 384 * 10
    return (conv1 + conv2 + fc) + (conv1 + 2 * conv2 + 2 * fc)


@pytest.mark.parametrize("iters", [None, 2])
@pytest.mark.parametrize("model", MODELS)
def test_probe_counts_the_step_without_the_recomputed_forward(model, iters):
    """FLAGS_monitor_hlo_cost: a miss runs its first eager step under the
    FLOP counter. Every derived grad runs its forward again (registry.
    make_vjp_kernel), which the count leaves out: one run's FLOPs are
    exactly iters x the step's products (3x the forward's, less the fed
    input's grad), not 4x."""
    init = jax_init(model)
    fluid, main, loss, scope = setup("port", model, init)
    bs = batches(model, 2)
    with fluid.scope_guard(scope), \
            flags.flag_guard(monitor_hlo_cost=True):
        exe = fluid.Executor(fluid.CPUPlace())
        if iters is None:
            exe.run(main, feed=bs[0], fetch_list=[loss])
        else:
            exe.run(main, feed=bs, fetch_list=[loss], iters=iters)
        fp = monitor.last_step()["fingerprint"]
        info = monitor.compile_info()[fp]
        assert info["flops"] == step_matmul_flops(model) * (iters or 1)
        assert "bytes_accessed" not in info
        # a hit probes nothing more
        exe.run(main, feed=bs[0], fetch_list=[loss])
    assert monitor.compile_info()[fp]["flops"] == info["flops"]
    snap = monitor.registry().snapshot()
    assert snap[f'hlo_flops{{fingerprint="{fp}"}}'] == info["flops"]


def test_probe_off_by_default_and_with_the_monitor_off():
    init = jax_init("mlp")
    fluid, main, loss, scope = setup("port", "mlp", init)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(main, feed=batches("mlp", 1)[0], fetch_list=[loss])
        with flags.flag_guard(monitor_hlo_cost=True, monitor=False):
            fluid.Executor(fluid.CPUPlace()).run(
                main, feed=batches("mlp", 1)[0], fetch_list=[loss])
    assert all("flops" not in v for v in monitor.compile_info().values())


def test_benchmark_sets_its_gauge_and_prints_the_jax_line(capsys):
    init = jax_init("mlp")
    lines = {}
    for pkg in ("jax", "port"):
        fluid, main, loss, scope = setup(pkg, "mlp", init)
        fl, mon = (jflags, jmonitor) if pkg == "jax" else (flags, monitor)
        b = batches("mlp", 1)[0]
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(main, feed=b, fetch_list=[loss])
            capsys.readouterr()
            with fl.flag_guard(benchmark=True):
                exe.run(main, feed=b, fetch_list=[loss])
        err = capsys.readouterr().err.strip().splitlines()
        lines[pkg] = err
        reg = mon.registry()
        assert reg.gauge("benchmark_run_ms").value > 0
        assert reg.histogram("benchmark_run_ms_hist").snapshot()[
            "count"] == 1
    line = re.compile(r"^\[paddle_tpu\] run: \d+\.\d{3} ms \(fetches=1\)$")
    for pkg, err in lines.items():
        assert len(err) == 1 and line.match(err[0]), (pkg, err)


def _poisoned(pkg, model, init, name):
    init = dict(init)
    init[name] = np.full_like(init[name], np.nan)
    fluid, main, loss, scope = setup(pkg, model, init)
    if pkg == "jax":
        scope.set_var(name, jax.numpy.asarray(init[name]))
    return fluid, main, loss, scope


@pytest.mark.parametrize("model,poison", [
    ("mlp", "fc_0.w_0"), ("mlp", "fc_1.w_1"), ("conv", "conv2d_1.w_0")])
def test_interpreter_names_the_op_and_var_as_the_jax_eager_path(
        model, poison):
    """The port's interpreter checks each op's outputs; the JAX package does
    so on its eager path (executor_core.run_ops with an eager context):
    the same first op and var, in the same words."""
    init = jax_init(model)
    feed = batches(model, 1)[0]
    msgs = {}
    fluid, main, loss, scope = _poisoned("jax", model, init, poison)
    env = {n: scope.find_var(n) for n in init}
    env.update({n: jax.numpy.asarray(v) for n, v in feed.items()})
    ctx = jcore.OpContext(rng=jax.random.PRNGKey(0), eager=True,
                          scope=scope, place=jfluid.CPUPlace())
    with jflags.flag_guard(check_nan_inf=True), \
            pytest.raises(RuntimeError) as err:
        jcore.run_ops(main.global_block().ops, env, ctx)
    msgs["jax"] = str(err.value)
    fluid, main, loss, scope = _poisoned("port", model, init, poison)
    with fluid.scope_guard(scope), flags.flag_guard(check_nan_inf=True), \
            pytest.raises(RuntimeError) as err:
        fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                             fetch_list=[loss])
    msgs["port"] = str(err.value)
    assert msgs["port"] == msgs["jax"]
    assert "after op '" in msgs["port"] and "contains NaN" in msgs["port"]


@pytest.mark.parametrize("iters", [None, 2])
def test_captured_step_names_the_var_as_the_jax_compiled_step(
        recorded_graphs, iters):
    """On the graph path (the recording stand-in) the check runs once after
    the replays, over the fetches and the written state, as the JAX
    package's compiled step does after its dispatch: the same var, in the
    same words. The eager first step and the capture pass clean."""
    init = jax_init("mlp")
    bs = batches("mlp", 2)
    feed = bs[0] if iters is None else bs
    msgs = {}
    for pkg in ("jax", "port"):
        fluid, main, loss, scope = setup(pkg, "mlp", init)
        fl = jflags if pkg == "jax" else flags
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            for _ in range(2):  # eager, then the capture (port)
                exe.run(main, feed=feed, fetch_list=[], iters=iters)
            if pkg == "port":
                assert exe.step_mode(main) == "graph"
            w = np.full((784, 64), np.nan, np.float32)
            scope.set_var("fc_0.w_0", jax.numpy.asarray(w) if pkg == "jax"
                          else torch.from_numpy(w))
            with fl.flag_guard(check_nan_inf=True), \
                    pytest.raises(RuntimeError) as err:
                exe.run(main, feed=feed, fetch_list=[], iters=iters)
            msgs[pkg] = str(err.value)
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"].endswith(
        ("after compiled step" if iters is None
         else "after compiled 2-step scan") + " (FLAGS_check_nan_inf)")


def test_a_clean_run_passes_every_check(recorded_graphs):
    init = jax_init("conv")
    fluid, main, loss, scope = setup("port", "conv", init)
    with fluid.scope_guard(scope), flags.flag_guard(check_nan_inf=True):
        exe = fluid.Executor(fluid.CPUPlace())
        for b in batches("conv", 3):
            (lv,) = exe.run(main, feed=b, fetch_list=[loss])
            assert np.isfinite(lv).all()
        assert exe.step_mode(main) == "graph"


def _jax_flag_defs():
    import paddle_tpu.health.detectors  # noqa: F401 (defines flags)
    import paddle_tpu.health.ledger  # noqa: F401
    import paddle_tpu.monitor.mfu  # noqa: F401
    import paddle_tpu.monitor.step  # noqa: F401
    from paddle_tpu import flags as jf

    return dict(jf._defs)


def test_every_ported_flag_has_the_jax_name_type_and_default():
    """Each flag the port defines that the JAX package also defines has
    its type and default; the instruments' flags are all among them."""
    jdefs = _jax_flag_defs()
    shared = sorted(set(flags._defs) & set(jdefs))
    for name in shared:
        assert flags._defs[name][:2] == jdefs[name][:2], name
    ported = {"monitor", "monitor_journal", "monitor_journal_max_mb",
              "monitor_hlo_cost", "monitor_replica_skew",
              "monitor_chip_peak_tflops", "benchmark", "check_nan_inf",
              "health", "health_interval", "health_ledger",
              "health_window", "health_spike_z", "health_grad_explode",
              "health_grad_ratio", "health_grad_vanish",
              "health_diverge_factor", "health_plateau_patience",
              "health_plateau_tol", "health_ema"}
    assert ported <= set(shared)
    assert flags._defs["monitor"][:2] == (bool, True)


def test_the_step_span_reaches_the_flight_recorder():
    main, startup, loss = _tiny(tfluid)
    with tfluid.scope_guard(tfluid.Scope()), flags.flag_guard(trace=True):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=batches("mlp", 1)[0], fetch_list=[loss])
        spans, _ = trace.snapshot()
    names = [s["name"] for s in spans]
    assert names.count("executor.step") == 2
    assert {"compile", "feed_encode", "fetch_readback"} <= set(names)


# ---------------------------------------------------------------------------
# ParallelExecutor: W = 2 gloo ranks
# ---------------------------------------------------------------------------
def test_parallel_executor_journals_its_kind_and_the_ranks_skew(tmp_path):
    """Each rank of a W = 2 gloo group journals kind "parallel_executor"
    with its per-rank completion times (FLAGS_monitor_replica_skew: waited
    for and all-gathered after the run) and sets the skew gauges; the JAX
    package's ParallelExecutor over two devices journals the same keys."""
    net, opt = "mlp", "momentum"
    main, startup, loss, _ = worker.build(jfluid, net, opt)
    rs = np.random.RandomState(3)
    xs = rs.rand(3, 8, *worker.SHAPES[net]).astype(np.float32)
    ys = rs.randint(0, worker.CLASSES, (3, 8, 1)).astype(np.int64)
    scope = jfluid.Scope()
    jpath = str(tmp_path / "jax.jsonl")
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
    with jfluid.scope_guard(scope), \
            jflags.flag_guard(monitor_journal=jpath,
                              monitor_replica_skew=True):
        pe = jfluid.ParallelExecutor(
            use_cuda=False, loss_name=loss.name, main_program=main,
            devices=jax.devices()[:2])
        for x, y in zip(xs, ys):
            pe.run([loss], feed={"img": x, "label": y})
    jmonitor.reset()
    jrecs = jmonitor.read_journal(jpath)
    np.savez(tmp_path / "init.npz", **init)
    np.savez(tmp_path / "data.npz", x=xs, y=ys)
    case = {"kind": "pe", "name": "monitored", "net": net, "opt": opt,
            "zero1": False, "fuse": False, "gss": "",
            "init": str(tmp_path / "init.npz"),
            "data": str(tmp_path / "data.npz"),
            "monitor": str(tmp_path / "w2")}
    res = worker.launch(2, [case], str(tmp_path / "w2"))["monitored"]
    for rank in range(2):
        recs = monitor.read_journal(
            str(tmp_path / "w2" / f"monitored.{rank}.jsonl"))
        assert [r["kind"] for r in recs] == ["parallel_executor"] * 3
        assert [r["cache"] for r in recs] == ["miss", "hit", "hit"]
        assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs], (
            recs[0], jrecs[0])
        for r in recs:
            assert r["replica_ids"] == [0, 1]
            assert len(r["replica_ms"]) == 2 and min(r["replica_ms"]) > 0
            assert r["skew"]["replicas"] == 2
        assert res[rank]["skew_gauge"] >= 1.0
        assert list(res[rank]["replica_gauges"]) == [0, 1]
    # both ranks gathered the same times
    r0, r1 = (monitor.read_journal(
        str(tmp_path / "w2" / f"monitored.{r}.jsonl")) for r in range(2))
    assert [r["replica_ms"] for r in r0] == [r["replica_ms"] for r in r1]


def test_parallel_executor_one_rank_journals_without_skew(tmp_path):
    main, startup, loss, _ = worker.build(tfluid, "mlp", "sgd")
    rs = np.random.RandomState(0)
    path = str(tmp_path / "pe.jsonl")
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    with tfluid.scope_guard(scope), \
            flags.flag_guard(monitor_journal=path,
                             monitor_replica_skew=True):
        pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main)
        x = rs.rand(2, 8, 32).astype(np.float32)
        y = rs.randint(0, 4, (2, 8, 1)).astype(np.int64)
        pe.run([loss], feed={"img": x, "label": y}, iters=2)
    monitor.reset()
    (rec,) = monitor.read_journal(path)
    assert rec["kind"] == "parallel_executor" and rec["iters"] == 2
    assert "skew" not in rec and rec["cache"] == "miss"


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_monitored_graph_path_on_the_card(cuda_device, tmp_path, model):
    """On a card the first run (a prepared-step miss) is the eager step
    under the probe, the capture and a replay: compile and dispatch
    phases; the next is a replay, dispatch only. The probe counts the
    same FLOPs as on the host; the benchmark line carries peak_hbm; the
    NaN check after a replay names the poisoned var."""
    init = jax_init(model)
    place = tfluid.CUDAPlace(0)
    fluid, main, loss, scope = setup("port", model, init, place)
    path = str(tmp_path / "card.jsonl")
    bs = batches(model, 4)
    with fluid.scope_guard(scope), \
            flags.flag_guard(monitor_journal=path, monitor_hlo_cost=True):
        exe = fluid.Executor(place)
        exe.run(main, feed=bs[:2], fetch_list=[loss], iters=2)
        exe.run(main, feed=bs[:2], fetch_list=[loss], iters=2)
        assert exe.step_mode(main) == "graph"
        fp = monitor.last_step()["fingerprint"]
        assert monitor.compile_info()[fp]["flops"] == \
            2 * step_matmul_flops(model)
        with flags.flag_guard(benchmark=True):
            exe.run(main, feed=bs[2], fetch_list=[loss])
        assert monitor.registry().gauge("benchmark_run_ms").value > 0
        name = "fc_0.w_0" if model == "mlp" else "conv2d_0.w_0"
        scope.find_var(name).fill_(float("nan"))
        with flags.flag_guard(check_nan_inf=True), \
                pytest.raises(RuntimeError, match="contains NaN after "
                                                  "compiled step"):
            exe.run(main, feed=bs[3], fetch_list=[loss])
    monitor.reset()
    recs = monitor.read_journal(path)
    assert {"compile", "dispatch"} <= set(recs[0]["phases_ms"])
    assert "compile" not in recs[1]["phases_ms"]
