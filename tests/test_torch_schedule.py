"""The static overlap schedule in the port (analysis/schedule.py,
FLAGS_overlap_plan, `analyze schedule`) against the JAX package's.

- The plan: on the same zero1-rewritten programs (the MLP, the conv net
  and the embedding net, at 2 and 8 shards and three bucket sizes) the
  port's schedule, given the JAX package's cost knobs
  (197 TFLOP/s, 180 GB/s), has the JAX package's buckets, moves, order
  and digest, and its critical, serial, compute and comm ms equal within
  rtol 1e-9 (the same arithmetic on the same numbers). The port reads a
  program in the JAX package's layout (zero1.global_view: [W, shard]
  where a rank holds [1, shard]). With the port's H100 defaults (989.4
  TFLOP/s, 450 GB/s) the buckets, moves and order are the same: they
  depend on bytes only. A program with batch norm (the batch-norm net,
  the CIFAR ResNet) the JAX package refuses with PTA031 (ROADMAP §3 item
  32: its batch_norm_grad reads the running statistics its forward op
  overwrote); the port plans it, and its reorder verifies clean.
- The JAX package's tests/test_analysis.py schedule cases, each on the
  port: the report, the reorder re-verified clean at `full`, a seeded
  gather rewire refused with PTA033 by analyze and apply_plan, the
  bucket knob, the gauges. `analyze schedule --selftest --json` gives
  the JAX command's report under the JAX knobs, with its rc codes.
- ParallelExecutor under zero1 at dp 2 (two gloo ranks,
  tests/torch_dp_worker.py): the step with FLAGS_overlap_plan on is
  bitwise the step with it off (losses and the whole state), its
  hoisted scatters marked asynchronous, and within rtol 1e-4 / atol 1e-6
  (fp32; 1e-5 for the batch-norm net's state, as in
  tests/test_torch_parallel.py) of the JAX package's ParallelExecutor
  with the flag on (with it off for the batch-norm net, which the JAX
  package's schedule refuses: ROADMAP §3 item 32). Over gloo the
  scatters stay synchronous: the reorder changes only the order (the
  NCCL path is the card test's, tests/test_torch_dp_rest_card.py).
"""

import json

import numpy as np
import pytest


import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu.analysis import dataflow as jdataflow
from paddle_tpu.analysis import schedule as jschedule
from paddle_tpu.cli import main as jax_cli

import paddle_tpu_torch as fluid
from paddle_tpu_torch import analysis, flags, monitor
from paddle_tpu_torch.analysis import ProgramVerificationError, dataflow
from paddle_tpu_torch.analysis import schedule
from paddle_tpu_torch.cli import main as cli_main
from paddle_tpu_torch.parallel import zero1 as tzero1

import test_torch_analysis as ta
import test_torch_parallel as tp
import torch_dp_worker as worker
from test_torch_analysis import _fresh_port_state  # noqa: F401

JAX_KNOBS = {"peak_flops": 197e12, "ici_bytes_per_s": 1.8e11}
MS_RTOL = 1e-9
PROGRAMS = {"mlp": ta._mlp, "conv": ta._conv, "embedding": ta._embedding}
BATCH_NORM_PROGRAMS = {"batch_norm": ta._batch_norm_net,
                       "resnet_cifar10": ta._resnet_cifar10}


def _zero1(pkg, builder, parts):
    """(program to cost, program to reorder, feeds, fetches, plan) of
    `builder`'s program rewritten by `pkg`'s zero1 at `parts` shards: the
    JAX package's rewrite is both; the port's is costed in the JAX
    package's layout (zero1.global_view)."""
    main, feeds, fetches = ta._build(pkg, builder)
    rewritten, plan = pkg.parallel.zero1.apply(main, parts)
    costed = tzero1.global_view(rewritten, plan) if pkg is fluid \
        else rewritten
    return costed, rewritten, feeds, fetches, plan


def _plan_dict(sched):
    d = sched.to_dict()
    ms = {k: d.pop(k) for k in ("critical_path_ms", "serial_ms",
                                "compute_ms", "comm_ms",
                                "overlap_headroom_ms")}
    path = d.pop("critical_path")
    d.pop("knobs")
    return d, ms, path


def _assert_same_schedule(want, got):
    wd, wms, wpath = _plan_dict(want)
    gd, gms, gpath = _plan_dict(got)
    assert gd == wd
    for k in wms:
        np.testing.assert_allclose(gms[k], wms[k], rtol=MS_RTOL, err_msg=k)
    assert [(p["op_idx"], p["op"]) for p in gpath] \
        == [(p["op_idx"], p["op"]) for p in wpath]
    np.testing.assert_allclose([p["ms"] for p in gpath],
                               [p["ms"] for p in wpath], rtol=MS_RTOL)
    assert got.plan.order == want.plan.order
    assert got.plan.digest() == want.plan.digest()


# ---------------------------------------------------------------------------
# the plan against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bucket_bytes", [1, 256, 4 << 20])
@pytest.mark.parametrize("parts", [2, 8])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_the_plan_is_the_jax_packages(name, parts, bucket_bytes):
    out = []
    for pkg, mod in ((jfluid, jschedule), (fluid, schedule)):
        costed, _, feeds, _, _ = _zero1(pkg, PROGRAMS[name], parts)
        out.append(mod.analyze(costed, mesh_axes={"dp": parts},
                               feed_names=feeds, batch_size=4,
                               bucket_bytes=bucket_bytes, **JAX_KNOBS))
    want, got = out
    assert want.plan.moves, "the case must hoist something"
    _assert_same_schedule(want, got)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_the_h100_defaults_give_the_same_buckets(name):
    costed, _, feeds, _, _ = _zero1(fluid, PROGRAMS[name], 8)
    h100 = schedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds)
    v5e = schedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds,
                           **JAX_KNOBS)
    assert schedule.DEFAULT_PEAK_FLOPS == 989.4e12
    assert schedule.DEFAULT_ICI_BYTES_PER_S == 450e9
    assert h100.knobs["peak_flops"] == 989.4e12
    assert h100.plan.buckets == v5e.plan.buckets
    assert h100.plan.order == v5e.plan.order
    # every comm node costs bytes / link, every compute node flops / peak
    np.testing.assert_allclose(h100.comm_ms, v5e.comm_ms * 180 / 450,
                               rtol=MS_RTOL)
    np.testing.assert_allclose(h100.compute_ms,
                               v5e.compute_ms * 197 / 989.4, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(BATCH_NORM_PROGRAMS))
def test_batch_norm_programs_plan_where_the_jax_package_refuses(name):
    """§3 item 32: the JAX package's batch_norm_grad reads the running
    Mean/Variance that its forward op overwrote in place, which its own
    PTA031 check refuses, so its schedule (and FLAGS_overlap_plan) refuses
    every batch-norm program. The port's training-mode batch_norm_grad
    reads neither: it plans, hoists and re-verifies."""
    costed, _, feeds, _, _ = _zero1(jfluid, BATCH_NORM_PROGRAMS[name], 8)
    with pytest.raises(jfluid.analysis.ProgramVerificationError) as ei:
        jschedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds)
    assert "PTA031" in ei.value.report.codes()
    costed, rewritten, feeds, fetches, plan = _zero1(
        fluid, BATCH_NORM_PROGRAMS[name], 8)
    sched = schedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds)
    assert sched.plan.moves and sched.comm_ms > 0
    reordered, _ = schedule.apply_plan(rewritten, sched.plan,
                                       feed_names=feeds)
    full = analysis.verify(tzero1.global_view(reordered, plan), level="full",
                           feed_names=feeds, fetch_names=fetches,
                           mesh_axes={"dp": 8}, zplan=plan)
    assert full.ok, [str(d) for d in full.errors()]


def test_the_rank_layout_costs_as_the_global_view():
    """A rank's program ([1, shard] rows) costs its collectives as the
    global view does: the gather's ring bytes are the whole [W, shard]."""
    costed, rewritten, feeds, _, _ = _zero1(fluid, ta._mlp, 4)
    a = schedule.analyze(costed, mesh_axes={"dp": 4}, feed_names=feeds)
    b = schedule.analyze(rewritten, mesh_axes={"dp": 4}, feed_names=feeds)
    assert a.plan.buckets == b.plan.buckets
    assert a.comm_ms == b.comm_ms


# ---------------------------------------------------------------------------
# the JAX package's tests/test_analysis.py schedule cases, on the port
# ---------------------------------------------------------------------------
def test_schedule_analyze_reports_critical_path_and_buckets():
    costed, _, feeds, _, _ = _zero1(fluid, ta._mlp, 8)
    sched = schedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds)
    assert sched.critical_path_ms > 0
    assert sched.serial_ms >= sched.critical_path_ms
    assert sched.comm_ms > 0  # the zero1 collectives are costed
    assert len(sched.plan.buckets) > 0 and len(sched.plan.moves) > 0
    d = sched.to_dict()
    assert d["overlap"]["hoistable_bytes"] > 0
    assert "critical path" in sched.render()


def test_schedule_apply_plan_reorders_and_reverifies():
    costed, rewritten, feeds, fetches, plan = _zero1(fluid, ta._mlp, 8)
    sched = schedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds)
    reordered, oplan = schedule.apply_plan(rewritten, sched.plan,
                                           feed_names=feeds)
    assert reordered is not rewritten
    old = [op.type for op in rewritten.global_block().ops]
    new = [op.type for op in reordered.global_block().ops]
    assert sorted(old) == sorted(new) and old != new
    first_opt = next(i for i, op in enumerate(reordered.global_block().ops)
                     if op.type == "sgd")
    n_scatter_before = sum(1 for op in
                           reordered.global_block().ops[:first_opt]
                           if op.type == "zero1_scatter")
    assert n_scatter_before >= len(oplan.moves)
    # the reordered program still verifies completely clean (its global
    # view, as ParallelExecutor verifies it)
    full = analysis.verify(tzero1.global_view(reordered, plan), level="full",
                           feed_names=feeds, fetch_names=fetches,
                           mesh_axes={"dp": 8}, zplan=plan)
    assert full.ok and not full.warnings(), \
        [str(dd) for dd in full.diagnostics]


def test_schedule_rejects_hazardous_program():
    costed, rewritten, feeds, _, _ = _zero1(fluid, ta._mlp, 8)
    for prog in (costed, rewritten):
        gb = prog.global_block()
        gat = next(op for op in gb.ops if op.type == "zero1_gather")
        pupd = gat.input("X")[0]
        gat.rename_input(pupd, pupd.replace("@zero1_upd", "@zero1_shard"))
        prog._mutation += 1
    with pytest.raises(ProgramVerificationError) as ei:
        schedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds)
    assert "PTA033" in ei.value.report.codes()
    with pytest.raises(ProgramVerificationError):
        schedule.apply_plan(rewritten, feed_names=feeds)


def test_schedule_bucket_bytes_knob_changes_plan():
    costed, _, feeds, _, _ = _zero1(fluid, ta._mlp, 8)
    g = dataflow.build_graph(costed, feed_names=feeds)
    one_big = schedule.build_overlap_plan(g, bucket_bytes=4 << 20)
    tiny = schedule.build_overlap_plan(g, bucket_bytes=1)
    assert len(tiny.buckets) > len(one_big.buckets)
    assert tiny.digest() != one_big.digest()
    assert sorted(i for b in tiny.buckets for i in b["ops"]) \
        == sorted(i for b in one_big.buckets for i in b["ops"])
    # FLAGS_overlap_bucket_bytes is the default knob, as in the JAX package
    with flags.flag_guard(overlap_bucket_bytes=1):
        assert schedule.build_overlap_plan(g).buckets == tiny.buckets
    jg = jdataflow.build_graph(_zero1(jfluid, ta._mlp, 8)[0],
                               feed_names=feeds)
    assert jschedule.build_overlap_plan(jg, bucket_bytes=1).buckets \
        == tiny.buckets


def test_schedule_record_gauges_roundtrip():
    costed, _, feeds, _, _ = _zero1(fluid, ta._mlp, 8)
    sched = schedule.analyze(costed, mesh_axes={"dp": 8}, feed_names=feeds)
    schedule.record_gauges(sched)
    reg = monitor.registry()
    assert reg.gauge("dataflow_critical_path_ms").value \
        == pytest.approx(sched.critical_path_ms)
    assert reg.gauge("overlap_hoistable_bytes").value \
        == float(sched.plan.hoistable_bytes)
    assert reg.gauge("overlap_bucket_count").value \
        == float(len(sched.plan.buckets))
    assert reg.gauge("dataflow_comm_ms").value \
        == pytest.approx(sched.comm_ms)


def test_the_flags_are_the_jax_packages():
    for name in ("overlap_plan", "overlap_bucket_bytes"):
        assert flags.get(name) == jflags.get(name)
    assert flags.get("overlap_bucket_bytes") == schedule.DEFAULT_BUCKET_BYTES
    assert sorted(schedule.__all__) == sorted(jschedule.__all__)


# ---------------------------------------------------------------------------
# analyze schedule (CLI)
# ---------------------------------------------------------------------------
def _json_of(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--mesh", "dp=2"],
                                   ["--zero1", "4", "--bucket-bytes", "64",
                                    "--batch", "32"]],
                         ids=["default", "dp2", "zero1_4_bucket64"])
def test_cli_selftest_json_is_the_jax_commands(extra, capsys):
    argv = ["analyze", "schedule", "--selftest", "--json"] + extra
    rc_j, want = _json_of(jax_cli, argv, capsys)
    rc_t, got = _json_of(cli_main, argv + ["--peak-tflops", "197",
                                           "--link-gbps", "180"], capsys)
    assert rc_t == rc_j == 0 and got["ok"] and want["ok"]
    assert got["seeded_rejected"] and got["seeded_codes"] == ["PTA033"]
    assert got["seeded_codes"] == want["seeded_codes"]
    w, g = want["schedule"], got["schedule"]
    assert g["overlap"] == w["overlap"]
    assert g["critical_path"] == w["critical_path"]
    for k in ("critical_path_ms", "serial_ms", "comm_ms"):
        np.testing.assert_allclose(g[k], w[k], rtol=MS_RTOL)


def test_cli_selftest_text_and_h100_defaults(capsys):
    assert cli_main(["analyze", "schedule", "--selftest"]) == 0
    out = capsys.readouterr().out
    assert "analyze schedule selftest: OK" in out
    assert "rejected ['PTA033']" in out and "overlap plan:" in out
    rc, rep = _json_of(cli_main, ["analyze", "schedule", "--selftest",
                                  "--json"], capsys)
    assert rc == 0
    assert rep["schedule"]["knobs"]["peak_flops"] == 989.4e12
    assert rep["schedule"]["knobs"]["ici_bytes_per_s"] == 450e9


def test_cli_model_dir_and_usage_errors(tmp_path, capsys):
    assert cli_main(["analyze", "schedule"]) == 2
    assert cli_main(["analyze", "schedule",
                     "--model-dir", "/nonexistent-dir-xyz"]) == 2
    assert cli_main(["analyze", "schedule", "--selftest",
                     "--mesh", "dp=oops"]) == 2
    capsys.readouterr()
    # a saved model: the forward program, zero1 leaves it alone, no moves
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        pred = fluid.layers.fc(fluid.layers.fc(x, size=16, act="relu"),
                               size=4)
    exe = fluid.Executor(fluid.CPUPlace())
    d = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                      main_program=main)
    rc, rep = _json_of(cli_main, ["analyze", "schedule", "--model-dir", d,
                                  "--json", "--zero1", "2",
                                  "--mesh", "dp=2"], capsys)
    assert rc == 0 and rep["n_ops"] > 0
    assert rep["overlap"]["n_moves"] == 0


# ---------------------------------------------------------------------------
# ParallelExecutor with FLAGS_overlap_plan, two gloo ranks
# ---------------------------------------------------------------------------
OVERLAP_NETS = [("conv_bn", "momentum"), ("mlp", "adam")]
OVERLAP_CASES = {  # name: (net, opt, fuse, bucket bytes or None)
    "conv_bn_off": ("conv_bn", "momentum", True, None),
    "conv_bn_on": ("conv_bn", "momentum", True, 64),
    "mlp_adam_off": ("mlp", "adam", False, None),
    "mlp_adam_on": ("mlp", "adam", False, 4 << 20),
}


def _jax_pe_overlap(net, opt, bucket_bytes):
    """The JAX package's ParallelExecutor under zero1 over 2 devices with
    FLAGS_overlap_plan on: (losses, full-layout state)."""
    saved = {n: jflags.get(n) for n in ("overlap_plan",
                                        "overlap_bucket_bytes")}
    jflags.set("overlap_plan", True)
    jflags.set("overlap_bucket_bytes", bucket_bytes)
    try:
        losses, state, _ = tp.jax_pe(net, opt, 2, zero1=True)
    finally:
        for n, v in saved.items():
            jflags.set(n, v)
    return losses, state


@pytest.fixture(scope="module")
def overlap_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("overlap"))
    files = tp.write_inputs(tmp, OVERLAP_NETS)
    cases = [tp.port_case(name, net, opt, files[(net, opt)], zero1=True,
                          fuse=fuse, overlap=bucket)
             for name, (net, opt, fuse, bucket) in OVERLAP_CASES.items()]
    port = worker.launch(2, cases, tmp)
    # the batch-norm net against the JAX package's run with the flag off:
    # its schedule refuses batch norm (§3 item 32)
    jax_runs = {"mlp_adam_on": _jax_pe_overlap("mlp", "adam", 4 << 20),
                "conv_bn_on": tp.jax_pe("conv_bn", "momentum", 2,
                                        zero1=True)[:2]}
    return {"port": port, "jax": jax_runs}


@pytest.mark.parametrize("net", ["conv_bn", "mlp_adam"])
def test_overlap_on_is_bitwise_overlap_off(overlap_runs, net):
    for rank in range(2):
        on = overlap_runs["port"][f"{net}_on"][rank]
        off = overlap_runs["port"][f"{net}_off"][rank]
        np.testing.assert_array_equal(on["losses"], off["losses"])
        for n, v in tp.state_of(off).items():
            np.testing.assert_array_equal(tp.state_of(on)[n], v, err_msg=n)
        # the scatters moved up into the backward, marked asynchronous
        assert int(on["n_overlap_async"]) > 0
        assert int(off["n_overlap_async"]) == 0
        assert list(on["op_order"]) != list(off["op_order"])
        assert sorted(on["op_order"]) == sorted(off["op_order"])


@pytest.mark.parametrize("net", ["conv_bn", "mlp_adam"])
def test_overlap_matches_the_jax_parallel_executor(overlap_runs, net):
    got = overlap_runs["port"][f"{net}_on"][0]
    losses, state = overlap_runs["jax"][f"{net}_on"]
    np.testing.assert_allclose(got["losses"], losses, rtol=tp.RTOL,
                               atol=tp.ATOL)
    tp.assert_state_close(tp.state_of(got), state,
                          atol=tp.STATE_ATOL.get("conv_bn_momentum", tp.ATOL)
                          if net == "conv_bn" else tp.ATOL)


def test_overlap_hoists_the_buckets_the_schedule_plans(overlap_runs):
    """In the rank's program (the batch-norm net at 64-byte buckets) every
    gradient's reduce-scatter is hoisted, one per update, ahead of the
    first update (which its own parameter's scatter also precedes)."""
    on = overlap_runs["port"]["conv_bn_on"][0]
    order = list(on["op_order"])
    first_update = order.index("momentum")
    assert int(on["n_overlap_async"]) == order.count("momentum") == 6
    assert order[:first_update].count("zero1_scatter") \
        == int(on["n_overlap_async"]) + 1
