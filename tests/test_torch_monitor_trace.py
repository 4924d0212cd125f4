"""paddle_tpu_torch.monitor (the metrics registry), .trace (spans, the
flight recorder, dumps) and .profiler (the host recorder), each held
against the JAX package's output for the same call sequence: registry
snapshots, exports and Prometheus exposition text, histogram percentiles,
span trees (parents, links, attrs; ids, which are random, compared by
their order of appearance), ring wrap-around, dump manifests, spans.jsonl
and chrome events, dump cooldowns. Then the serving path's spans in the
port: the batch span's fan-in links, an HTTP request's lifecycle as one
trace in a dump, the SLO-violation dump, and tracing off recording
nothing.
"""

import json
import math
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu import trace as jtrace
from paddle_tpu.monitor import MetricsRegistry as JRegistry

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, monitor, profiler, serve, trace
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.monitor import MetricsRegistry
from paddle_tpu_torch.serve.http import make_http_server

PKGS = {"port": (monitor, trace, flags), "jax": (jmonitor, jtrace, jflags)}


@pytest.fixture(autouse=True)
def _fresh_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    for mon, tr, _ in PKGS.values():
        mon.reset()
        tr.reset()
    flags.reset()
    yield
    for mon, tr, _ in PKGS.values():
        mon.reset()
        tr.reset()
    flags.reset()


def _traced(fl, **extra):
    return fl.flag_guard(trace=True, **extra)


def _normalized(spans):
    """Spans with their random ids replaced by their order of first
    appearance, and without clocks and thread names."""
    ids = {}

    def norm(i):
        return None if i is None else ids.setdefault(i, len(ids))

    out = []
    for s in spans:
        d = {k: v for k, v in s.items()
             if k not in ("t0", "t1", "thread", "trace", "span", "parent",
                          "links")}
        d["trace"] = norm(s["trace"])
        d["span"] = norm(s["span"])
        d["parent"] = norm(s.get("parent"))
        d["links"] = [(norm(l["trace"]), norm(l["span"]))
                      for l in s.get("links", [])]
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _registry_calls(reg):
    c = reg.counter("steps_total", help="steps run", kind="executor")
    c.inc()
    c.inc(3)
    reg.counter("steps_total", kind="eager").inc(2)
    reg.counter("odd_total", path='C:\\tmp\\"x"\nend').inc()
    g = reg.gauge("last_step_ms", help="last step")
    g.set(12.5)
    g.add(0.5)
    h = reg.histogram("step_ms", help="step latency",
                      buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    reg.histogram("serve_ms", buckets=serve.SERVE_MS_BUCKETS,
                  model="m").observe(3.25)
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("steps_total", kind="executor")
    return reg


def test_registry_snapshot_export_and_exposition_match_jax():
    port = _registry_calls(MetricsRegistry())
    jax = _registry_calls(JRegistry())
    assert port.snapshot() == jax.snapshot()
    assert port.export() == jax.export()
    assert port.exposition() == jax.exposition()
    text = port.exposition()
    assert 'steps_total{kind="executor"} 4.0' in text
    assert 'path="C:\\\\tmp\\\\\\"x\\"\\nend"' in text
    assert 'step_ms_bucket{le="+Inf"} 4' in text
    port.reset()
    assert port.snapshot() == {} and port.exposition() == ""


def test_process_registry_matches_jax():
    for mon, _, _ in PKGS.values():
        mon.registry().counter("serve_requests_total", help="h").inc(2)
        mon.registry().gauge("serve_queue_rows").set(3)
    assert monitor.exposition() == jmonitor.exposition()
    monitor.reset()
    assert monitor.registry().snapshot() == {}


@pytest.mark.parametrize("values,buckets", [
    ((), (1.0, 10.0, 100.0)),
    ((7.0,), (1.0, 10.0, 100.0)),
    (tuple(float(v) for v in range(1, 101)), (0.0, 100.0)),
    ((0.5, 5.0, 9.0), (1.0,)),
    ((0.07, 0.3, 2.5, 2.5, 11.0, 4000.0), None),
], ids=["empty", "one", "uniform", "inf_bucket", "spread"])
def test_histogram_percentiles_match_jax(values, buckets):
    ps = (0, 25, 50, 95, 99, 100)
    got = {}
    for name, cls in (("port", MetricsRegistry), ("jax", JRegistry)):
        h = cls().histogram("lat_ms", buckets=buckets)
        for v in values:
            h.observe(v)
        got[name] = h.percentiles(*ps)
        with pytest.raises(ValueError):
            h.percentiles(101)
    for p in ps:
        a, b = got["port"][p], got["jax"][p]
        assert (math.isnan(a) and math.isnan(b)) or a == b, p


# ---------------------------------------------------------------------------
# spans and the flight recorder
# ---------------------------------------------------------------------------

def _span_calls(tr):
    root = tr.new_context(parent=None)
    with tr.attach(root):
        with tr.span("outer", kind="t", a=1) as outer:
            with tr.span("inner") as inner:
                inner.set(b=2)
            tr.record("retro", 1.0, 1.5, parent=outer.ctx, attrs={"k": 1})
            linked = tr.record("linked", 2.0, 3.0, links=[outer.ctx, None])
    with pytest.raises(RuntimeError):
        with tr.span("boom", links=[linked]):
            raise RuntimeError("x")
    tr.record("root", 0.0, 0.1, parent=None)
    spans, dropped = tr.snapshot()
    return sorted(spans, key=lambda s: s["name"]), dropped


def test_span_tree_matches_jax():
    got = {}
    for name, (_, tr, fl) in PKGS.items():
        with _traced(fl):
            got[name] = _span_calls(tr)
    (port, pd), (jax, jd) = got["port"], got["jax"]
    assert pd == jd == 0
    assert _normalized(port) == _normalized(jax)
    by_name = {s["name"]: s for s in port}
    assert by_name["inner"]["parent"] == by_name["outer"]["span"]
    assert by_name["retro"]["parent"] == by_name["outer"]["span"]
    assert by_name["boom"]["attrs"]["error"] == "RuntimeError"
    assert by_name["root"]["parent"] is None


def test_ring_wrap_and_reset_match_jax():
    got = {}
    for name, (_, tr, fl) in PKGS.items():
        with _traced(fl, trace_buffer=16):
            for i in range(40):
                tr.record(f"s{i}", float(i), float(i) + 0.5)
            spans, dropped = tr.snapshot()
            tr.reset()
            assert tr.snapshot() == ([], 0)
            tr.record("after", 0.0, 1.0)  # a stale ring re-registers
            after = [s["name"] for s in tr.snapshot()[0]]
        got[name] = ([s["name"] for s in spans], dropped, after)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [f"s{i}" for i in range(24, 40)]
    assert got["port"][1] == 24


def test_off_by_default_is_noop():
    assert not trace.enabled()
    a, b = trace.span("x"), trace.span("y", k=1)
    assert a is b
    with a as h:
        h.set(ignored=True)
        assert h.ctx is None
    assert trace.record("x", 0.0, 1.0) is None
    assert trace.maybe_dump("anything") is None
    assert trace.snapshot() == ([], 0)


def test_dumps_match_jax_and_load_across(tmp_path):
    dumps = {}
    for name, (mon, tr, fl) in PKGS.items():
        with _traced(fl):
            with tr.span("a", kind="k", attr1="v"):
                tr.record("b", 1.0, 2.0)
            dumps[name] = tr.dump(reason="unit test!",
                                  out_dir=str(tmp_path / name))
        assert tr.last_dump() == dumps[name]
        assert "trace_unit_test_" in dumps[name]
        assert mon.registry().snapshot()[
            'trace_dumps_total{reason="unit_test_"}'] == 1
    loaded = {n: trace.load_dump(p) for n, p in dumps.items()}
    assert jtrace.load_dump(dumps["port"]) == loaded["port"]
    # the JAX package's slowest-ops table joins the XLA costs of whatever
    # programs its process compiled before; the port has none to join
    assert loaded["port"]["manifest"]["slowest_ops"] is None
    man = {n: {k: v for k, v in d["manifest"].items()
               if k not in ("ts", "pid", "clock", "slowest_ops")}
           for n, d in loaded.items()}
    assert man["port"] == man["jax"]
    assert man["port"]["format"] == trace.FORMAT == jtrace.FORMAT
    assert set(loaded["port"]["manifest"]["clock"]) == {"perf_counter",
                                                         "epoch"}
    assert _normalized(loaded["port"]["spans"]) == \
        _normalized(loaded["jax"]["spans"])
    chrome = {}
    for n, p in dumps.items():
        with open(f"{p}/trace.json") as f:
            evs = json.load(f)["traceEvents"]
        chrome[n] = [(e["ph"], e["name"], e["pid"], e.get("cat"))
                     for e in evs]
    assert chrome["port"] == chrome["jax"]


def test_maybe_dump_cooldown_matches_jax(tmp_path):
    got = {}
    for name, (_, tr, fl) in PKGS.items():
        out = tmp_path / name
        with _traced(fl, trace_dump_dir=str(out), trace_dump_cooldown_s=60):
            tr.record("x", 0.0, 1.0)
            first = tr.maybe_dump("storm")
            second = tr.maybe_dump("storm")
            other = tr.maybe_dump("other")
        got[name] = (first is not None, second, other is not None,
                     sorted(p.name.rsplit("_", 1)[0] for p in out.iterdir()))
    assert got["port"] == got["jax"] == (
        True, None, True, ["trace_other", "trace_storm"])


def test_profiler_host_recorder_without_a_session():
    """The host recorder's tables stay empty while no session is on, and
    starting one (torch.profiler) is not ported yet."""
    profiler.reset_profiler()
    monitor.registry().gauge("g").set(1.0)
    profiler.record_counter("c", 2)
    profiler.record_bytes("b", 10)
    with profiler.record_event("e"):
        pass
    assert profiler._counter_events == [] and profiler._host_events == []
    for call in (lambda: profiler.start_profiler("All"),
                 profiler.stop_profiler,
                 lambda: profiler.export_chrome_trace("x.json")):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()


# ---------------------------------------------------------------------------
# the serving path's spans
# ---------------------------------------------------------------------------

def _fc_server(max_batch=4, feat=4, out=3, **cfg):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[feat], dtype="float32")
        y = fluid.layers.fc(input=x, size=out)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
    return serve.Server(prog, ["x"], [y], place=fluid.CPUPlace(),
                        scope=scope,
                        config=serve.ServeConfig(max_batch=max_batch, **cfg))


def test_batch_span_links_survive_coalescing():
    server = _fc_server(max_wait_ms=50.0)
    with _traced(flags):
        with server:
            # two requests submitted inside the batching window coalesce
            # into ONE dispatch
            x = np.ones(4, np.float32)
            f1 = server.submit({"x": x})
            f2 = server.submit({"x": 2 * x})
            f1.result(timeout=30)
            f2.result(timeout=30)
        spans, _ = trace.snapshot()
    reqs = [s for s in spans if s["name"] == "serve.request"]
    batches = [s for s in spans if s["name"] == "serve.batch"
               and s["attrs"]["rows"] == 2]
    assert len(reqs) == 2 and len(batches) == 1
    batch = batches[0]
    # fan-in: the batch links to BOTH coalesced requests' identities...
    linked = {(l["trace"], l["span"]) for l in batch["links"]}
    assert linked == {(r["trace"], r["span"]) for r in reqs}
    # ...and each request links back to the batch that carried it
    for r in reqs:
        assert {(l["trace"], l["span"]) for l in r["links"]} == \
            {(batch["trace"], batch["span"])}
    assert reqs[0]["trace"] != reqs[1]["trace"]
    assert batch["thread"] == "serve-worker-0"


def test_http_request_lifecycle_is_one_trace_in_dump(tmp_path):
    """POST /v1/infer -> queue -> batch -> dispatch -> readback
    reconstructs as ONE trace from a flight-recorder dump."""
    server = _fc_server()
    with _traced(flags):
        with server:
            httpd = make_http_server(server, port=0)
            port = httpd.server_address[1]
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            try:
                body = json.dumps(
                    {"inputs": {"x": [1.0, 2.0, 3.0, 4.0]}}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/infer", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    assert resp.status == 200
            finally:
                httpd.shutdown()
                httpd.server_close()
        path = trace.dump(reason="lifecycle", out_dir=str(tmp_path))
    spans = trace.load_dump(path)["spans"]
    http = next(s for s in spans if s["name"] == "serve.http")
    lifecycle = [s for s in spans if s["trace"] == http["trace"]]
    names = {s["name"] for s in lifecycle}
    assert {"serve.http", "serve.request", "serve.queue", "serve.pad",
            "serve.dispatch", "serve.readback"} <= names
    req_span = next(s for s in lifecycle if s["name"] == "serve.request")
    assert req_span["parent"] == http["span"]
    for name in ("serve.queue", "serve.dispatch", "serve.readback"):
        child = next(s for s in lifecycle if s["name"] == name)
        assert child["parent"] == req_span["span"]
        assert child["t0"] >= req_span["t0"] - 1e-6
        assert child["t1"] <= req_span["t1"] + 1e-6
    batch_link = req_span["links"][0]
    batch = next(s for s in spans if s["span"] == batch_link["span"])
    assert batch["name"] == "serve.batch"
    assert {(l["trace"], l["span"]) for l in batch["links"]} >= \
        {(req_span["trace"], req_span["span"])}


def test_serve_slo_violation_triggers_dump(tmp_path):
    server = _fc_server(slo_ms=0.000001)  # everything violates
    with _traced(flags, trace_dump_dir=str(tmp_path)):
        with server:
            server.submit({"x": np.ones(4, np.float32)}).result(timeout=30)
            time.sleep(0.1)  # the dump happens on the worker thread
        assert server.stats()["slo_violations"] == 1
    dumps = list(tmp_path.glob("trace_serve_slo_*"))
    assert len(dumps) == 1
    spans = trace.load_dump(str(dumps[0]))["spans"]
    req = next(s for s in spans if s["name"] == "serve.request")
    assert req["attrs"]["slo_violated"] is True


def test_tracing_off_serve_path_records_nothing():
    server = _fc_server()
    assert not trace.enabled()
    with server:
        out, = server.submit({"x": np.ones(4, np.float32)}).result(
            timeout=30)
        assert out.shape == (1, 3)
    assert trace.snapshot() == ([], 0)
