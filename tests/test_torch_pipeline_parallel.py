"""Pipeline parallelism (parallel/pipeline) in the port, held to the JAX
package on the CPU.

* partition and rewrite: the same programs (the JAX tests' MLP, a conv
  net with batch norm) give the JAX package's stage assignment, digest,
  boundaries and stage programs (desc_str(), DIFFERENCES below);
  PTA040/PTA041 are refused as the JAX package refuses them;
* the 1F1B schedule and its bubbles are the JAX package's;
* the runner: losses within rtol 1e-4 of the JAX runner from the same
  numpy start; bitwise equal to the port's own n_stages = 1 run at
  p in {2, 4}, on the interpreter, on the recorded graph path, and under
  bf16 AMP with FLAGS_fuse (the interface vars keep their producers'
  dtypes); the monitor gauges;
* the checkpoint manifest's `pipeline` section and a refused
  pp-mismatched restore;
* `analyze pipeline --selftest` (rc 0) and `--model-dir`.
"""

import json

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.analysis.diagnostics import Report as JReport
from paddle_tpu.parallel import pipeline as jpipe

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp, convert, flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.analysis.diagnostics import (ProgramVerificationError,
                                                   Report)
from paddle_tpu_torch.cli import main as cli_main
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.parallel import pipeline as tpipe

from test_torch_imports import _strip_bn_grad_running_stats
from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)

FEEDS = ["x", "y"]
STEPS = 3
# where the port's stage programs differ from the JAX package's: the
# conv net's batch_norm_grad reads no running Mean/Variance in the port
# (ROADMAP §3 item 4), so the JAX package's hazard check refuses the conv
# net (PTA031 on the running stats, which the JAX batch norm updates in
# place) and its side is built with check=False; each stage program is
# otherwise the same string
DIFFERENCES = {
    "mlp": "none",
    "conv_bn": "batch_norm_grad without the running Mean/Variance inputs "
               "(ROADMAP §3 item 4), stripped from the JAX desc before "
               "the comparison; the JAX rewrite and runner run with "
               "check=False (its PTA031 refuses every batch norm program)",
}
JAX_CHECK = {"mlp": True, "conv_bn": False}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    tflags.reset()
    tpipe.reset_registry()
    jpipe.reset_registry()
    yield
    tflags.reset()
    tpipe.reset_registry()
    jpipe.reset_registry()


def _mlp(fluid):
    """tests/test_pipeline_parallel.py's trainer (fixed layer names)."""
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(x, 32, act="relu", name="tpp1")
    h = fluid.layers.fc(h, 16, act="relu", name="tpp2")
    p = fluid.layers.fc(h, 1, name="tpp3")
    loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _conv_bn(fluid):
    x = fluid.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.conv2d(input=x, num_filters=4, filter_size=3,
                            padding=1, bias_attr=False)
    h = fluid.layers.batch_norm(input=h, act="relu")
    h = fluid.layers.conv2d(input=h, num_filters=4, filter_size=3,
                            padding=1, bias_attr=False)
    h = fluid.layers.batch_norm(input=h, act="relu")
    h = fluid.layers.pool2d(input=h, pool_size=2, pool_stride=2,
                            pool_type="max")
    p = fluid.layers.fc(input=h, size=4, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=p, label=y))
    fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss


MODELS = {"mlp": _mlp, "conv_bn": _conv_bn}


def _build(fluid, model):
    main, start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, start):
        loss = MODELS[model](fluid)
    return main, start, loss.name


def _feed(model, m, seed=0, per_mb=4):
    rs = np.random.RandomState(seed)
    n = per_mb * m
    if model == "mlp":
        return {"x": rs.randn(n, 16).astype(np.float32),
                "y": rs.randn(n, 1).astype(np.float32)}
    return {"x": rs.randn(n, 3, 8, 8).astype(np.float32),
            "y": rs.randint(0, 4, (n, 1)).astype(np.int64)}


def _jax_start(model):
    main, start, _ = _build(jfluid, model)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(start)
    return {n: np.asarray(scope.find_var(n)) for n, v in
            main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _jax_losses(model, p, m, init, steps=STEPS):
    main, start, loss_name = _build(jfluid, model)
    scope = jfluid.Scope()
    feed = _feed(model, m)
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(start)
        for n, a in init.items():
            scope.var(n)
            scope.set_var(n, a)
        runner = jpipe.PipelineRunner(main, p, loss_name=loss_name,
                                      feed_names=FEEDS, n_microbatches=m,
                                      scope=scope, check=JAX_CHECK[model])
        return [float(np.asarray(runner.run(feed)["loss"]).reshape(-1)[0])
                for _ in range(steps)]


def _port_run(model, p, m, init, steps=STEPS):
    """(losses as float32 arrays, the last report, numpy state)."""
    main, start, loss_name = _build(tfluid, model)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(start, scope=scope)
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    runner = tpipe.PipelineRunner(main, p, loss_name=loss_name,
                                  feed_names=FEEDS, n_microbatches=m,
                                  scope=scope, place=tfluid.CPUPlace())
    feed = _feed(model, m)
    reports = [runner.run(feed) for _ in range(steps)]
    return ([r["loss"] for r in reports], reports[-1],
            convert.numpy_state(scope, main))


# ---------------------------------------------------------------------------
# partition and rewrite
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_partition_is_the_jax_packages(model, p):
    jmain, _, _ = _build(jfluid, model)
    tmain, _, _ = _build(tfluid, model)
    jplan = jpipe.partition(jmain, p, feed_names=FEEDS, batch_size=8)
    tplan = tpipe.partition(tmain, p, feed_names=FEEDS, batch_size=8)
    assert tplan.assignment == jplan.assignment
    assert tplan.digest() == jplan.digest()
    assert tplan.to_dict() == jplan.to_dict()
    assert tplan.describe() == jplan.describe()


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_stage_programs_are_the_jax_packages(model, p):
    jmain, _, jloss = _build(jfluid, model)
    tmain, _, tloss = _build(tfluid, model)
    jst = jpipe.build_stage_programs(
        jmain, jpipe.partition(jmain, p, feed_names=FEEDS),
        feed_names=FEEDS, fetch_names=[jloss], check=JAX_CHECK[model])
    tst = tpipe.build_stage_programs(
        tmain, tpipe.partition(tmain, p, feed_names=FEEDS),
        feed_names=FEEDS, fetch_names=[tloss])
    assert sorted(tst) == sorted(jst)
    for cell, jsp in jst.items():
        tsp = tst[cell]
        for k in ("data_feeds", "boundary_in", "local_in", "boundary_out",
                  "local_out", "user_fetches", "fetch_names"):
            assert getattr(tsp, k) == getattr(jsp, k), (cell, k)
        assert tsp.describe() == jsp.describe()
        assert tsp.program._pipeline_stage == jsp.program._pipeline_stage
        want = jsp.program.desc_str()
        if DIFFERENCES[model] != "none":
            want = _strip_bn_grad_running_stats(want)
        assert tsp.program.desc_str() == want, cell


def _force_backwards_edge(pkg, main, plan):
    """The JAX test's seeded backwards edge: the first matmul onto the last
    stage, its first forward consumer onto stage 0."""
    ops = main.global_block().ops
    u = min(i for i, op in enumerate(ops)
            if plan.phases[i] == pkg.PHASE_FWD and op.type == "mul")
    outs = set(ops[u].output_arg_names())
    v = min(i for i, op in enumerate(ops)
            if i > u and plan.phases[i] == pkg.PHASE_FWD
            and outs & set(op.input_arg_names()))
    plan.assignment[u] = plan.n_stages - 1
    plan.assignment[v] = 0
    return plan


def test_a_backwards_edge_is_refused_with_pta040_as_in_jax():
    got = {}
    for pkg, fluid, report in ((jpipe, jfluid, JReport),
                               (tpipe, tfluid, Report)):
        main, _, loss = _build(fluid, "mlp")
        plan = _force_backwards_edge(pkg, main,
                                     pkg.partition(main, 2,
                                                   feed_names=FEEDS))
        rep = pkg.check_partition(main, plan,
                                  report(level="full", context="t"),
                                  feed_names=FEEDS)
        got[fluid] = sorted(rep.codes())
    assert got[tfluid] == got[jfluid] and "PTA040" in got[tfluid]
    main, _, loss = _build(tfluid, "mlp")
    plan = _force_backwards_edge(tpipe, main,
                                 tpipe.partition(main, 2, feed_names=FEEDS))
    with pytest.raises(ProgramVerificationError) as ei:
        tpipe.build_stage_programs(main, plan, feed_names=FEEDS,
                                   fetch_names=[loss])
    assert "PTA040" in str(ei.value)


def test_a_rewritten_boundary_var_is_flagged_pta041_as_in_jax():
    """increment(in_place=True) writes its operand a second time; a plan
    that ships it across a stage boundary is flagged in both packages."""
    got = {}
    for pkg, fluid, report in ((jpipe, jfluid, JReport),
                               (tpipe, tfluid, Report)):
        main, start = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, start):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            s = fluid.layers.reduce_sum(x)
            t = fluid.layers.scale(s, scale=2.0)
            fluid.layers.increment(x=s, value=1.0, in_place=True)
            fluid.layers.scale(t, scale=1.0)
        n = len(main.global_block().ops)
        plan = pkg.StagePlan(
            2, {i: (0 if i < 2 else 1) for i in range(n)},
            [pkg.PHASE_FWD] * n, [1.0, 1.0],
            [{"var": s.name, "src": 0, "dst": 1, "bytes": 4.0}], 4.0)
        rep = pkg.check_partition(main, plan,
                                  report(level="full", context="t"),
                                  feed_names=["x"])
        got[fluid] = sorted(rep.codes())
    assert got[tfluid] == got[jfluid] and "PTA041" in got[tfluid]


def test_partition_refuses_too_many_stages_as_in_jax():
    for pkg, fluid in ((jpipe, jfluid), (tpipe, tfluid)):
        main, _, _ = _build(fluid, "mlp")
        with pytest.raises(ValueError, match="forward ops into 99"):
            pkg.partition(main, 99, feed_names=FEEDS)
        with pytest.raises(ValueError, match=">= 1"):
            pkg.partition(main, 0, feed_names=FEEDS)


# ---------------------------------------------------------------------------
# the 1F1B schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p,m", [(1, 4), (2, 4), (3, 6), (4, 4), (4, 8),
                                 (2, 1)])
def test_schedule_and_bubbles_are_the_jax_packages(p, m):
    events = tpipe.schedule_1f1b(p, m)
    assert events == jpipe.schedule_1f1b(p, m)
    assert tpipe.analytic_bubble(p, m) == jpipe.analytic_bubble(p, m)
    durs = {(k, s): 1.0 + 0.25 * s + (0.5 if k == "B" else 0.0)
            for k in "FB" for s in range(p)}
    for d in (None, durs):
        assert tpipe.simulate_schedule(events, d) == \
            jpipe.simulate_schedule(events, d)
    assert tpipe.simulate_schedule(events)["bubble_fraction"] == \
        pytest.approx(tpipe.analytic_bubble(p, m), abs=1e-12)
    with pytest.raises(ValueError):
        tpipe.schedule_1f1b(0, m)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", sorted(MODELS))
def test_runner_losses_match_the_jax_runner(model):
    init = _jax_start(model)
    want = _jax_losses(model, 2, 2, init)
    got, rep, _ = _port_run(model, 2, 2, init)
    np.testing.assert_allclose(_floats(got), want, rtol=1e-4)
    assert rep["plan"]["digest"] == tpipe.partition(
        _build(tfluid, model)[0], 2, feed_names=FEEDS).digest()


def _floats(losses):
    return [float(np.asarray(x).reshape(-1)[0]) for x in losses]


def _assert_bitwise(a, b):
    assert [x.tobytes() for x in a[0]] == [x.tobytes() for x in b[0]]
    assert sorted(a[2]) == sorted(b[2])
    for n in a[2]:
        np.testing.assert_array_equal(a[2][n], b[2][n], err_msg=n)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_pipeline_replay_is_bitwise_its_one_stage_run(model, p):
    m = 4
    init = _jax_start(model)
    ref = _port_run(model, 1, m, init)
    got = _port_run(model, p, m, init)
    _assert_bitwise(got, ref)
    losses = _floats(ref[0])
    assert losses[-1] < losses[0], "the property must hold on a LEARNING run"
    rep = got[1]
    assert rep["bubble_fraction"] == pytest.approx(
        tpipe.analytic_bubble(p, m), abs=1e-12)
    assert rep["n_stages"] == p and rep["n_microbatches"] == m
    assert 0.0 <= rep["bubble_measured"] < 1.0 and rep["makespan_s"] > 0


def test_pipeline_replay_is_bitwise_on_the_graph_path(recorded_graphs):  # noqa: F811,E501
    """Each cell is captured once and replayed (the recording stand-in):
    the losses and state are still the one-stage run's."""
    init = _jax_start("conv_bn")
    ref = _port_run("conv_bn", 1, 2, init)
    got = _port_run("conv_bn", 2, 2, init)
    _assert_bitwise(got, ref)
    with tflags.flag_guard(cuda_graph=False):
        interp = _port_run("conv_bn", 2, 2, init)
    _assert_bitwise(got, interp)


def test_pipeline_replay_is_bitwise_under_amp_and_fuse():
    """bf16 AMP and FLAGS_fuse: a boundary var declared float32 carries a
    bf16 value, which its @PPIN feed keeps; bf16 grads accumulate in
    float32; the optimizer cells take the fused momentum bucket."""
    init = _jax_start("conv_bn")
    with tflags.flag_guard(fuse=True), tamp.auto_cast():
        ref = _port_run("conv_bn", 1, 2, init)
        got = _port_run("conv_bn", 3, 2, init)
    _assert_bitwise(got, ref)
    with tamp.auto_cast():
        unfused = _port_run("conv_bn", 3, 2, init)
    np.testing.assert_allclose(_floats(got[0]), _floats(unfused[0]),
                               rtol=1e-3)


def test_interface_vars_keep_their_producers_dtype():
    init = _jax_start("conv_bn")
    main, start, loss_name = _build(tfluid, "conv_bn")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(start, scope=scope)
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    runner = tpipe.PipelineRunner(main, 2, loss_name=loss_name,
                                  feed_names=FEEDS, n_microbatches=2,
                                  scope=scope, place=tfluid.CPUPlace())
    with tamp.auto_cast():
        runner.run(_feed("conv_bn", 2))
    typed = [v.dtype for sp in runner.stages.values()
             for n, v in sp.program.global_block().vars.items()
             if n.endswith(tpipe.PP_IN_SUFFIX)]
    assert "bfloat16" in typed
    # the source program is left as it was
    assert all(v.dtype != "bfloat16"
               for v in main.global_block().vars.values())


def test_runner_validates_microbatching():
    main, start, loss_name = _build(tfluid, "mlp")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(start, scope=scope)
    runner = tpipe.PipelineRunner(main, 2, loss_name=loss_name,
                                  feed_names=FEEDS, n_microbatches=3,
                                  scope=scope, place=tfluid.CPUPlace())
    with pytest.raises(ValueError, match="not splittable"):
        runner.run({"x": np.zeros((8, 16), np.float32),
                    "y": np.zeros((8, 1), np.float32)})
    with pytest.raises(ValueError):
        tpipe.PipelineRunner(main, 0, loss_name=loss_name, feed_names=FEEDS,
                             place=tfluid.CPUPlace())


def test_runner_exports_the_jax_packages_gauges():
    m = 4
    init = _jax_start("mlp")
    with tflags.flag_guard(monitor=True):
        _port_run("mlp", 2, m, init, steps=1)
    snap = tmonitor.registry().snapshot()
    assert snap.get("pipeline_stages") == 2.0
    assert snap.get("pipeline_microbatches") == float(m)
    assert snap.get("pipeline_bubble_fraction") == pytest.approx(
        tpipe.analytic_bubble(2, m))
    assert snap.get("pipeline_bubble_analytic") == pytest.approx(
        tpipe.analytic_bubble(2, m))
    assert 0.0 <= snap.get("pipeline_bubble_measured") < 1.0


def test_pipeline_stages_flag_and_registry():
    assert tflags.get("pipeline_stages") == 0
    tpipe.register_pipeline({"stages": 4, "microbatches": 2})
    assert tpipe.active_pipeline() == {"stages": 4, "microbatches": 2}
    assert tpipe.manifest_section() == {"axis": "pp", "schedule": "1f1b",
                                        "stages": 4, "microbatches": 2}
    tpipe.reset_registry()
    assert tpipe.manifest_section() is None


# ---------------------------------------------------------------------------
# the checkpoint manifest
# ---------------------------------------------------------------------------
def test_checkpoint_manifest_stamps_pp_geometry(tmp_path, capsys):
    from paddle_tpu_torch.resilience.checkpoint import (CheckpointManager,
                                                        inspect_dir)

    m = 2
    main, start, loss_name = _build(tfluid, "mlp")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(start, scope=scope)
    runner = tpipe.PipelineRunner(main, 2, loss_name=loss_name,
                                  feed_names=FEEDS, n_microbatches=m,
                                  scope=scope, place=tfluid.CPUPlace())
    runner.run(_feed("mlp", m))
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(3, scope=scope, program=main)
    rep = inspect_dir(str(tmp_path))
    info = rep["manifest"]["pipeline"]
    assert info["stages"] == 2 and info["microbatches"] == m
    assert info["axis"] == "pp" and info["schedule"] == "1f1b"
    assert info["digest"] == runner.plan.digest()
    assert "mesh" not in rep["manifest"]

    rc = cli_main(["checkpoint", "inspect", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "pipeline: stages=2" in out and "schedule=1f1b" in out

    # dp may change; a pp mismatch refuses BEFORE any var is loaded
    fresh = tfluid.Scope()
    cm.restore(scope=fresh, program=main, place=tfluid.CPUPlace(),
               expect_mesh={"dp": 2, "pp": 2})
    assert fresh.find_var("tpp1.w_0") is not None
    refused = tfluid.Scope()
    with pytest.raises(ValueError, match="mesh geometry conflict.*pp"):
        cm.restore(scope=refused, program=main, place=tfluid.CPUPlace(),
                   expect_mesh={"dp": 4, "pp": 4})
    assert refused.find_var("tpp1.w_0") is None
    # the JAX layout: the pp axis in the mesh section refuses as well
    cm.mesh_axes = {"dp": 4, "pp": 2}
    cm.save(4, scope=scope, program=main)
    assert inspect_dir(str(tmp_path))["manifest"]["mesh"] == {"dp": 4,
                                                             "pp": 2}
    with pytest.raises(ValueError, match="mesh geometry conflict.*pp"):
        cm.restore(scope=tfluid.Scope(), program=main,
                   place=tfluid.CPUPlace(), expect_mesh={"pp": 1})


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p,m", [(2, 4), (4, 4)])
def test_cli_analyze_pipeline_selftest(p, m, capsys):
    rc = cli_main(["analyze", "pipeline", "--selftest", "--stages", str(p),
                   "--microbatches", str(m), "--place", "cpu", "--json"])
    res = json.loads(capsys.readouterr().out)
    assert rc == 0 and res["ok"] and res["parity_bitwise"]
    assert res["bubble_fraction"] == pytest.approx(
        (p - 1) / (m + p - 1), abs=1e-12)
    assert res["seeded_rejected"] and "PTA040" in res["seeded_codes"]


def test_cli_analyze_pipeline_model_dir_and_usage(tmp_path, capsys):
    main, start, loss_name = _build(tfluid, "mlp")
    pred = [n for n in main.global_block().vars if n.startswith("tpp3")
            and ".tmp_" in n][0]
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(start, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(str(tmp_path), ["x"],
                                       [main.global_block().var(pred)], exe,
                                       main_program=main)
    capsys.readouterr()
    rc = cli_main(["analyze", "pipeline", "--model-dir", str(tmp_path),
                   "--stages", "2", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["plan"]["n_stages"] == 2
    assert out["bubble_analytic"] == pytest.approx(1 / 5)
    assert cli_main(["analyze", "pipeline"]) == 2
    assert cli_main(["analyze", "pipeline", "--selftest",
                     "--stages", "0"]) == 2
    capsys.readouterr()
    # --stages defaults to FLAGS_pipeline_stages, and to 2 where it is 0
    for flag, want in ((0, 2), (3, 3)):
        with tflags.flag_guard(pipeline_stages=flag):
            rc = cli_main(["analyze", "pipeline", "--model-dir",
                           str(tmp_path), "--json"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["plan"]["n_stages"] == want
