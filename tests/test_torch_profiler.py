"""paddle_tpu_torch.profiler's session and trace.costs' slowest-ops table.

The session on torch.profiler, on the host: interpreted steps record one
host event per op ("op::<type>", the JAX package's eager events), a
captured step's replays (test_torch_step's recording stand-in for the CUDA
graph) record none, the summary table is the JAX package's, and
export_chrome_trace merges the host lane, the flight recorder's spans and
torch.profiler's rows into one timeline; cuda_profiler and the
profiler(...) context manager. trace.costs against the JAX package on the
same programs (the nets of test_torch_monitor_step): the per-op estimates
and their attribution are equal, slowest_ops joins the compile probe's
measured FLOPs, and a flight-recorder dump carries the table. The `cuda`
case traces a replayed step on a card.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import trace as jtrace

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags, monitor, profiler, trace

from test_torch_monitor_step import (  # noqa: F401 (fixtures too)
    MODELS, _fresh_state, batches, build, cuda_device, jax_init, setup,
    step_matmul_flops)
from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def _fresh_profiler():
    profiler.reset_profiler()
    yield
    if profiler.enabled():
        profiler.stop_profiler(profile_path=None)
    profiler.reset_profiler()


@pytest.mark.parametrize("model", MODELS)
def test_interpreted_steps_record_an_event_per_op(tmp_path, model, capsys):
    init = jax_init(model)
    fluid, main, loss, scope = setup("port", model, init)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(main, feed=batches(model, 1)[0], fetch_list=[loss])
        profiler.start_profiler("All", trace_dir=str(tmp_path / "t"))
        for b in batches(model, 2):
            exe.run(main, feed=b, fetch_list=[loss])
        profiler.stop_profiler("calls", str(tmp_path / "profile"))
    n_ops = len(exe._prepared[next(iter(exe._prepared))][2].ops)
    events = [ev.name for ev in profiler._host_events]
    assert len(events) == 2 * n_ops
    assert all(e.startswith("op::") for e in events)
    types = {e[len("op::"):] for e in events}
    assert {"mul", "elementwise_add", "mean"} <= types
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == ["Event", "Calls", "Total(ms)", "Min(ms)",
                                "Max(ms)", "Ave(ms)"]
    assert (tmp_path / "profile.txt").read_text().splitlines() == table
    counters = {n for n, _, _ in profiler._counter_events}
    assert 'monitor/last_step_ms{kind="executor"}' in counters


def test_the_jax_summary_table_from_the_same_events(capsys):
    """The summary table of the same host events is the JAX package's,
    sorted by each key."""
    from paddle_tpu import profiler as jprofiler

    events = [("op::mul", 0.0, 0.003), ("op::relu", 0.004, 0.0045),
              ("op::mul", 0.005, 0.0062), ("op::mean", 0.007, 0.0071)]
    for key in ("calls", "total", "max", "min", "ave", None):
        out = {}
        for name, mod in (("jax", jprofiler), ("port", profiler)):
            mod.reset_profiler()
            for ev_name, t0, t1 in events:
                ev = mod._Event(ev_name)
                ev.start, ev.end = t0, t1
                mod._host_events.append(ev)
            mod._print_summary(key, "/nonexistent/dir/profile")
            out[name] = capsys.readouterr().out
            mod.reset_profiler()
        assert out["port"] == out["jax"]


def test_replays_record_no_op_events(recorded_graphs, tmp_path):
    init = jax_init("conv")
    fluid, main, loss, scope = setup("port", "conv", init)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        for b in batches("conv", 2):  # eager, then the capture
            exe.run(main, feed=b, fetch_list=[loss])
        profiler.start_profiler("All")
        for b in batches("conv", 3):
            exe.run(main, feed=b, fetch_list=[loss])
        profiler.stop_profiler(profile_path=str(tmp_path / "p"))
        assert exe.step_mode(main) == "graph"
    assert profiler._host_events == []
    assert profiler._counter_events  # the monitor's gauges


def test_export_merges_host_spans_and_profiler_rows(tmp_path):
    init = jax_init("mlp")
    fluid, main, loss, scope = setup("port", "mlp", init)
    with fluid.scope_guard(scope), flags.flag_guard(trace=True):
        exe = fluid.Executor(fluid.CPUPlace())
        profiler.start_profiler("All", trace_dir=str(tmp_path / "t"))
        exe.run(main, feed=batches("mlp", 1)[0], fetch_list=[loss])
        profiler.stop_profiler(profile_path=str(tmp_path / "p"))
    path = profiler.export_chrome_trace(str(tmp_path / "merged.json"))
    events = json.load(open(path))["traceEvents"]
    by_pid = {}
    for e in events:
        by_pid.setdefault(e.get("pid"), []).append(e)
    host = by_pid[0]
    assert host[0]["args"]["name"] == "paddle_tpu_torch host"
    ops = [e for e in host if e["ph"] == "X"]
    assert ops and all(e["name"].startswith("op::") for e in ops)
    assert min(e["ts"] for e in ops) >= 0
    spans = {e["name"] for e in by_pid.get(jtrace.CHROME_PID, [])}
    assert trace.CHROME_PID == jtrace.CHROME_PID
    assert "executor.step" in spans
    rows = [e for pid, evs in by_pid.items()
            if isinstance(pid, int) and pid >= 100 for e in evs]
    assert any(e.get("name") == "aten::mm" for e in rows)
    # the profiler's rows land on the host events' clock: each op's aten
    # rows inside (or within a millisecond of) its host event
    mm = [e for e in rows if e.get("name") == "aten::mm"]
    span = (min(e["ts"] for e in ops) - 1e3,
            max(e["ts"] + e["dur"] for e in ops) + 1e3)
    assert all(span[0] <= e["ts"] <= span[1] for e in mm)


def test_cuda_profiler_and_the_profiler_context(tmp_path, capsys):
    init = jax_init("mlp")
    fluid, main, loss, scope = setup("port", "mlp", init)
    b = batches("mlp", 1)[0]
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        with profiler.cuda_profiler(str(tmp_path / "cp")):
            exe.run(main, feed=b, fetch_list=[loss])
        assert (tmp_path / "cp" / "device_trace.json").exists()
        with profiler.profiler("CPU", "total", str(tmp_path / "prof")):
            exe.run(main, feed=b, fetch_list=[loss])
    assert not profiler.enabled()
    assert capsys.readouterr().out.splitlines()[0].startswith("Event")
    assert (tmp_path / "prof.txt").exists()


@pytest.mark.parametrize("model", MODELS)
def test_op_costs_and_attribution_match_jax(model):
    jmain = build(jfluid, model)[0]
    tmain = build(tfluid, model)[0]
    for batch in (1, 8):
        assert trace.op_costs(tmain, batch) == jtrace.op_costs(jmain, batch)
        for total in (None, 1e9):
            assert trace.attribute_costs(tmain, total, batch) == \
                jtrace.attribute_costs(jmain, total, batch)


@pytest.mark.parametrize("model", MODELS)
def test_slowest_ops_joins_the_probe_total(tmp_path, model):
    """Every prepared-step miss registers its program; with the probe on,
    slowest_ops scales the op estimates onto the measured FLOPs, and a
    flight-recorder dump carries that table."""
    init = jax_init(model)
    fluid, main, loss, scope = setup("port", model, init)
    with fluid.scope_guard(scope), flags.flag_guard(monitor_hlo_cost=True):
        fluid.Executor(fluid.CPUPlace()).run(
            main, feed=batches(model, 1)[0], fetch_list=[loss])
    fp = monitor.last_step()["fingerprint"]
    assert fp in trace.registered_fingerprints()
    rep = trace.slowest_ops(fp, batch_size=8, top=5)
    assert rep["measured"] and rep["fingerprint"] == fp
    assert rep["total_flops"] == step_matmul_flops(model)
    assert len(rep["ops"]) == 5
    want = trace.attribute_costs(main, step_matmul_flops(model), 8)[:5]
    assert rep["ops"] == want
    table = trace.format_ops_table(rep)
    assert "[flop-counter probe]" in table.splitlines()[0]
    assert len(table.splitlines()) == 7
    assert trace.slowest_ops()["fingerprint"] == fp  # the largest measured
    with flags.flag_guard(trace=True):
        path = trace.dump("probe", out_dir=str(tmp_path))
    manifest = trace.load_dump(path)["manifest"]
    assert manifest["slowest_ops"]["fingerprint"] == fp
    assert manifest["slowest_ops"]["measured"]


def test_slowest_ops_without_a_probe_is_the_estimate():
    init = jax_init("mlp")
    fluid, main, loss, scope = setup("port", "mlp", init)
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(
            main, feed=batches("mlp", 1)[0], fetch_list=[loss])
    rep = trace.slowest_ops(monitor.last_step()["fingerprint"])
    assert not rep["measured"] and rep["total_flops"] is None
    assert "analytic estimate" in trace.format_ops_table(rep)
    assert trace.format_ops_table(None) == jtrace.format_ops_table(None)


@pytest.mark.cuda
def test_a_session_traces_the_replayed_step_on_the_card(cuda_device,
                                                        tmp_path):
    init = jax_init("conv")
    place = tfluid.CUDAPlace(0)
    fluid, main, loss, scope = setup("port", "conv", init, place)
    bs = batches("conv", 5)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place)
        for b in bs[:2]:
            exe.run(main, feed=b, fetch_list=[loss])
        profiler.start_profiler("All", trace_dir=str(tmp_path / "t"))
        for b in bs[2:]:
            exe.run(main, feed=b, fetch_list=[loss])
        torch.cuda.synchronize()
        profiler.stop_profiler(profile_path=str(tmp_path / "p"))
        assert exe.step_mode(main) == "graph"
    events = json.load(open(profiler.export_chrome_trace(
        str(tmp_path / "m.json"))))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and all(e["pid"] != 0 for e in kernels)
    assert any(e.get("ph") == "C" and e.get("pid") == 0 for e in events)
    assert np.isfinite([e["ts"] for e in kernels]).all()
