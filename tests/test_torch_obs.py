"""paddle_tpu_torch.obs against the JAX package's obs.

The 29 cases of tests/test_obs.py on the port: fleet collector
aggregation (sum/max/histogram-merge, HELP/TYPE carry-through, TTL
expiry, seq-gap drop accounting), clock-aligned timeline merge (skewed
anchors, rotation, stragglers), merged chrome traces with per-process pid
lanes, the push client tail readers, the obs HTTP surface, and the
obs/monitor CLI views. Where a function is pure (parse_exposition,
merge_hists, merge_step_timeline, merge_chrome_traces,
overlap_efficiency, render_summary; and the collector's exposition and
summary over the same pushes) the port's output is held equal to the JAX
package's on the same inputs.
"""

import json
import os
import threading
import time

import pytest

from paddle_tpu import monitor as jmonitor
from paddle_tpu import obs as jobs

from paddle_tpu_torch import cli, flags, monitor, obs
from paddle_tpu_torch.monitor.journal import JournalWriter
from paddle_tpu_torch.obs.client import JsonlTail
from paddle_tpu_torch.obs.collector import merge_hists, parse_exposition
from paddle_tpu_torch.trace.export import write_dump


@pytest.fixture(autouse=True)
def _fresh_monitor():
    monitor.reset()
    jmonitor.reset()
    flags.reset()
    yield
    monitor.reset()
    jmonitor.reset()
    flags.reset()


def _both(payloads, **kw):
    """The port's and the JAX package's Collector fed the same payloads:
    (port collector, its exposition), after asserting the JAX
    collector's exposition is the same text."""
    col, jcol = obs.Collector(**kw), jobs.Collector(**kw)
    for p in payloads:
        col.ingest(json.loads(json.dumps(p)))
        jcol.ingest(json.loads(json.dumps(p)))
    text = col.exposition()
    assert text == jcol.exposition()
    return col, text


def _payload(replica, metrics=None, journal=None, seq=1, pid=None,
             clock=None, role="trainer", trace_dumps=None, health=None):
    return {
        "v": 1, "seq": seq,
        "labels": {"job": "j", "role": role, "replica": replica,
                   "pid": pid if pid is not None else hash(replica) % 10000,
                   "epoch": time.time()},
        "clock": clock or {"perf_counter": time.perf_counter(),
                           "epoch": time.time()},
        "metrics": metrics or [],
        "journal": journal or [],
        "health": health or [],
        "trace_dumps": trace_dumps or [],
    }


def _counter(name, value, help="", **labels):
    return {"name": name, "kind": "counter", "help": help,
            "labels": labels, "value": float(value)}


def _gauge(name, value, help="", **labels):
    return {"name": name, "kind": "gauge", "help": help,
            "labels": labels, "value": float(value)}


def _hist(name, values, help="", **labels):
    reg = monitor.MetricsRegistry()
    h = reg.histogram(name, help=help, **labels)
    for v in values:
        h.observe(v)
    return reg.export()[0]


# ---------------------------------------------------------------------------
# aggregation semantics
# ---------------------------------------------------------------------------

def test_collector_counter_sum_gauge_max_hist_merge():
    col, text = _both([
        _payload("r0", metrics=[
            _counter("steps_total", 5, kind="executor"),
            _gauge("last_step_ms", 12.0),
            _hist("step_ms", [5.0, 9.0])]),
        _payload("r1", metrics=[
            _counter("steps_total", 7, kind="executor"),
            _gauge("last_step_ms", 30.0),
            _hist("step_ms", [7.0, 100.0])])], ttl_s=60.0)
    # per-replica series carry identity labels
    assert 'steps_total{job="j",kind="executor",replica="r0",' \
           'role="trainer"} 5.0' in text
    # aggregate series: counters SUM...
    assert 'steps_total{kind="executor"} 12.0' in text
    # ...gauges take the MAX...
    assert "\nlast_step_ms 30.0" in text
    # ...histograms merge bucket-wise (cumulative counts add)
    assert 'step_ms_bucket{le="10.0"} 3' in text
    assert 'step_ms_bucket{le="+Inf"} 4' in text
    assert "\nstep_ms_count 4" in text


def test_exposition_emits_help_and_type_per_family():
    col, text = _both([_payload("r0", metrics=[
        _counter("steps_total", 1, help="steps run", kind="executor"),
        _hist("step_ms", [5.0], help="step wall time")])], ttl_s=60.0)
    for family, kind in (("steps_total", "counter"),
                         ("step_ms", "histogram"),
                         ("obs_pushes_total", "counter"),
                         ("obs_processes", "gauge")):
        assert f"# TYPE {family} {kind}" in text
        assert f"# HELP {family} " in text
    # every exposition sample line belongs to a family that declared TYPE
    typed = {line.split()[2] for line in text.splitlines()
             if line.startswith("# TYPE ")}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{")[0].split()[0]
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
        assert base in typed, f"sample {name} has no # TYPE"


def test_registry_exposition_families_all_have_help():
    """Satellite regression: every metric the hot paths register carries
    a HELP string, so scrapers see # HELP on each family."""
    import numpy as np

    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        fluid.layers.reduce_mean(fluid.layers.fc(input=x, size=3))
    place = fluid.CPUPlace()
    exe = fluid.Executor(place)
    exe.run(startup)
    exe.run(main, feed={"x": np.ones((2, 4), np.float32)})
    missing = [m.name for m in monitor.registry().metrics() if not m.help]
    assert not missing, f"metrics without HELP text: {sorted(set(missing))}"
    text = monitor.registry().exposition()
    families = {m.name for m in monitor.registry().metrics()}
    for fam in families:
        assert f"# HELP {fam} " in text


def test_collector_ttl_expires_and_revives():
    col = obs.Collector(ttl_s=0.05)
    col.ingest(_payload("r0", metrics=[_gauge("g", 1.0)]))
    assert len(col.processes()) == 1
    time.sleep(0.08)
    assert col.processes() == []
    summary = col.summary()
    assert summary["fleet"]["expired"] == 1
    assert "\ng 1.0" not in col.exposition()
    # a new push under the same identity revives the process
    col.ingest(_payload("r0", metrics=[_gauge("g", 2.0)]))
    assert len(col.processes()) == 1
    assert col.summary()["fleet"]["expired"] == 0


def test_collector_seq_gap_counts_dropped_snapshots():
    col = obs.Collector(ttl_s=60.0)
    col.ingest(_payload("r0", seq=1))
    col.ingest(_payload("r0", seq=2))
    assert col.summary()["fleet"]["dropped_snapshots"] == 0
    col.ingest(_payload("r0", seq=5))  # 3 and 4 never arrived
    s = col.summary()
    assert s["fleet"]["dropped_snapshots"] == 2
    assert s["processes"][0]["dropped"] == 2


def test_collector_straggler_gauge_fires():
    col = obs.Collector(ttl_s=60.0, straggler_ratio=1.2,
                        straggler_steps=3)
    base = time.time()
    fast = [{"ts": base + i, "step": i, "total_ms": 10.0}
            for i in range(6)]
    slow = [{"ts": base + i, "step": i,
             "total_ms": 10.0 if i < 3 else 40.0} for i in range(6)]
    col, text = _both([_payload("r0", journal=fast, pid=1),
                       _payload("r1", journal=fast, pid=2),
                       _payload("r2", journal=slow, pid=3)],
                      ttl_s=60.0, straggler_ratio=1.2, straggler_steps=3)
    assert 'fleet_straggler{replica="r2"} 1.0' in text
    assert 'fleet_straggler{replica="r0"} 0.0' in text
    assert col.summary()["fleet"]["stragglers"] == {"r2": 3}
    assert "fleet_step_skew_ms 30.0" in text


def test_collector_overlap_efficiency_gauge():
    # analytic split 80 compute + 20 comm; measured median 90 ms
    # => 10 ms exposed, 10/20 hidden => efficiency 0.5
    col, text = _both([_payload("r0", metrics=[
        _gauge("dataflow_compute_ms", 80.0),
        _gauge("dataflow_comm_ms", 20.0),
        _hist("step_ms", [90.0, 90.0, 90.0])])], ttl_s=60.0)
    line = next(l for l in text.splitlines()
                if l.startswith('fleet_overlap_efficiency{replica="r0"}'))
    assert abs(float(line.split()[-1]) - 0.5) < 0.05


def test_merge_hists_intersects_mismatched_edges():
    a = {"count": 2, "sum": 3.0, "min": 1.0, "max": 2.0,
         "buckets": {"1.0": 1, "2.0": 2, "+Inf": 2}}
    b = {"count": 1, "sum": 5.0, "min": 5.0, "max": 5.0,
         "buckets": {"2.0": 0, "+Inf": 1}}
    m = merge_hists([a, b])
    assert m == jobs.merge_hists([a, b])
    assert m["count"] == 3 and m["sum"] == 8.0
    assert m["min"] == 1.0 and m["max"] == 5.0
    # the "1.0" edge exists in only one source: dropped, not fabricated
    assert set(m["buckets"]) == {"2.0", "+Inf"}
    assert m["buckets"]["+Inf"] == 3


# ---------------------------------------------------------------------------
# scrape mode
# ---------------------------------------------------------------------------

def test_parse_exposition_roundtrip():
    reg = monitor.MetricsRegistry()
    reg.counter("reqs_total", help="requests", code="200").inc(7)
    reg.gauge("queue_rows", help="queued rows").set(3.0)
    h = reg.histogram("req_ms", help="latency")
    for v in (1.0, 50.0):
        h.observe(v)
    parsed = parse_exposition(reg.exposition())
    assert parsed == jobs.parse_exposition(reg.exposition())
    by_name = {m["name"]: m for m in parsed}
    assert by_name["reqs_total"]["kind"] == "counter"
    assert by_name["reqs_total"]["value"] == 7.0
    assert by_name["reqs_total"]["labels"] == {"code": "200"}
    assert by_name["reqs_total"]["help"] == "requests"
    assert by_name["queue_rows"]["value"] == 3.0
    hist = by_name["req_ms"]
    assert hist["kind"] == "histogram"
    assert hist["hist"]["count"] == 2
    assert hist["hist"]["buckets"]["+Inf"] == 2
    assert hist["hist"]["sum"] == 51.0


def test_scrape_tick_aggregates_target():
    reg = monitor.MetricsRegistry()
    reg.counter("reqs_total", help="requests").inc(4)
    col = obs.Collector(ttl_s=60.0,
                        fetch=lambda endpoint: reg.exposition())
    col.add_scrape_target("edge0", "127.0.0.1:1")
    assert col.scrape_tick() == 1
    text = col.exposition()
    assert 'reqs_total{job="paddle",replica="edge0",role="scrape"} 4.0' \
        in text
    assert col.summary()["processes"][0]["via"] == "scrape"


# ---------------------------------------------------------------------------
# clock-aligned timeline merge
# ---------------------------------------------------------------------------

def test_merge_step_timeline_skewed_anchors_monotonic():
    """Two synthetic journals whose hosts disagree by 100 s of epoch
    skew: after anchor correction the merged event stream is monotonic
    and interleaves by TRUE time."""
    true_start = 1000.0
    # process A's clock = true; B's clock runs 100 s ahead
    a = [{"ts": true_start + i, "step": i, "total_ms": 5.0}
         for i in range(4)]
    b = [{"ts": true_start + 100.0 + i + 0.5, "step": i, "total_ms": 5.0}
         for i in range(4)]
    procs = [
        {"name": "a", "journal": a, "offset_s": 0.0},
        # collector measured B's clock 100 s ahead -> offset -100
        {"name": "b", "journal": b, "offset_s": -100.0},
    ]
    merged = obs.merge_step_timeline(procs)
    assert merged == jobs.merge_step_timeline(procs)
    ts = [e["t"] for e in merged["events"]]
    assert ts == sorted(ts)
    assert [e["name"] for e in merged["events"]] == \
        ["a", "b", "a", "b", "a", "b", "a", "b"]
    assert len(merged["steps"]) == 4
    assert merged["stragglers"] == {}


def test_clock_offset_from_push_anchor():
    clock = {"perf_counter": 50.0, "epoch": 2000.0}
    # collector received the payload at its own epoch 2100 -> the
    # process clock is 100 s behind the collector's
    assert obs.clock_offset(clock, 2100.0) == 100.0
    assert obs.clock_offset(None, 2100.0) == 0.0
    assert obs.epoch_of(51.5, clock) == 2001.5
    for args in ((clock, 2100.0), (None, 2100.0), (clock, 1999.25)):
        assert obs.clock_offset(*args) == jobs.clock_offset(*args)


def test_journal_rotation_tail_no_sample_loss(tmp_path):
    """A JsonlTail reader across a rotation (<path>.1) sees every
    record exactly once, including those written between its last read
    and the roll."""
    path = str(tmp_path / "journal.jsonl")
    tail = JsonlTail(path)
    with flags.flag_guard(monitor_journal_max_mb=0.0005):  # ~500 bytes
        w = JournalWriter(path)
        pad = "x" * 120
        for i in range(3):
            w.write({"step": i, "total_ms": 1.0, "pad": pad})
        got = tail.read_new()
        assert [r["step"] for r in got] == [0, 1, 2]
        # step 3 overflows the cap and rolls the file to .1 (one roll
        # between reads — the retention contract of a single .1 segment)
        for i in range(3, 6):
            w.write({"step": i, "total_ms": 1.0, "pad": pad})
        w.close()
    assert os.path.exists(path + ".1")
    got += tail.read_new()
    assert [r["step"] for r in got] == list(range(6))
    assert tail.read_new() == []


def test_tail_skips_torn_line_then_recovers(tmp_path):
    path = str(tmp_path / "j.jsonl")
    tail = JsonlTail(path)
    with open(path, "w") as f:
        f.write('{"step": 0}\n{"step": 1')   # torn mid-append
    assert [r["step"] for r in tail.read_new()] == [0]
    with open(path, "a") as f:
        f.write(', "total_ms": 2.0}\n')      # the writer finished it
    assert [r["step"] for r in tail.read_new()] == [1]


def test_merged_timeline_last_record_wins_on_replay():
    recs = [{"ts": 1.0, "step": 5, "total_ms": 50.0},
            {"ts": 2.0, "step": 5, "total_ms": 10.0}]  # replayed faster
    other = [{"ts": 1.5, "step": 5, "total_ms": 12.0}]
    procs = [{"name": "a", "journal": recs, "offset_s": 0.0},
             {"name": "b", "journal": other, "offset_s": 0.0}]
    merged = obs.merge_step_timeline(procs)
    assert merged == jobs.merge_step_timeline(procs)
    (step,) = merged["steps"]
    assert step["replicas"] == {"a": 10.0, "b": 12.0}
    assert step["slowest"] == "b"


# ---------------------------------------------------------------------------
# merged chrome traces: one pid lane per process
# ---------------------------------------------------------------------------

def _spans(n, t0, name="step"):
    return [{"trace": f"t{i}", "span": f"s{i}", "parent": None,
             "name": name, "kind": "span", "t0": t0 + i,
             "t1": t0 + i + 0.5, "thread": "MainThread"}
            for i in range(n)]


def test_merge_chrome_traces_distinct_pid_lanes():
    """The per-dump exporter reuses chrome pid 1 in EVERY process; the
    fleet merge must lane on the manifest's real pid instead."""
    dumps = [
        {"manifest": {"pid": 111,
                      "clock": {"perf_counter": 10.0, "epoch": 1000.0}},
         "spans": _spans(2, t0=11.0)},
        {"manifest": {"pid": 222,
                      "clock": {"perf_counter": 500.0, "epoch": 1000.5}},
         "spans": _spans(2, t0=501.0)},
    ]
    trace = obs.merge_chrome_traces(dumps, names=["r0", "r1"])
    assert trace == jobs.merge_chrome_traces(dumps, names=["r0", "r1"])
    events = trace["traceEvents"]
    pids = {e["pid"] for e in events}
    assert pids == {111, 222}
    names = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"r0", "r1"}
    # clock alignment: r0's first span is at true epoch 1001.0
    # (11.0 - 10.0 + 1000.0), r1's at 1001.5 (501.0 - 500.0 + 1000.5) —
    # despite perf_counter bases 10 vs 500, the merged lanes land 0.5 s
    # (500000 us) apart on ONE global origin
    xs = sorted((e["pid"], e["ts"]) for e in events if e["ph"] == "X")
    assert xs[0] == (111, 0.0)
    assert abs(xs[2][1] - 500000.0) < 1.0   # r1's first span, in us
    assert min(t for _, t in xs) >= 0.0


def test_merge_chrome_traces_recycled_pid_dedup():
    clock = {"perf_counter": 0.0, "epoch": 1000.0}
    dumps = [{"manifest": {"pid": 7, "clock": clock},
              "spans": _spans(1, t0=1.0)},
             {"manifest": {"pid": 7, "clock": clock},
              "spans": _spans(1, t0=2.0)}]
    trace = obs.merge_chrome_traces(dumps)
    assert trace == jobs.merge_chrome_traces(dumps)
    assert len({e["pid"] for e in trace["traceEvents"]}) == 2


def test_two_process_dump_merge_via_disk(tmp_path):
    """End-to-end over the real dump format: write_dump twice (same OS
    pid — this test process), merge, and the trace stays loadable with
    two lanes thanks to recycled-pid dedup."""
    from paddle_tpu_torch.trace import load_dump

    d1 = write_dump(str(tmp_path / "a"), _spans(3, time.perf_counter()))
    d2 = write_dump(str(tmp_path / "b"), _spans(2, time.perf_counter()))
    merged = obs.merge_chrome_traces([load_dump(d1), load_dump(d2)],
                                     names=["procA", "procB"])
    out = tmp_path / "merged.json"
    with open(out, "w") as f:
        json.dump(merged, f)
    loaded = json.load(open(out))
    assert len({e["pid"] for e in loaded["traceEvents"]}) == 2
    assert sum(1 for e in loaded["traceEvents"] if e["ph"] == "X") == 5


# ---------------------------------------------------------------------------
# overlap efficiency + hist quantiles
# ---------------------------------------------------------------------------

def test_overlap_efficiency_bounds():
    assert obs.overlap_efficiency(80.0, 20.0, 80.0) == 1.0   # fully hidden
    assert obs.overlap_efficiency(80.0, 20.0, 100.0) == 0.0  # serialized
    assert obs.overlap_efficiency(80.0, 20.0, 90.0) == 0.5
    assert obs.overlap_efficiency(80.0, 20.0, 500.0) == 0.0  # clamped
    assert obs.overlap_efficiency(80.0, 0.0, 90.0) is None
    assert obs.overlap_efficiency(None, 20.0, 90.0) is None
    for args in ((80.0, 20.0, 80.0), (80.0, 20.0, 100.0),
                 (80.0, 20.0, 90.0), (80.0, 20.0, 500.0), (80.0, 0.0, 90.0),
                 (None, 20.0, 90.0), (3.5, 1.25, 4.0), (10.0, 5.0, None)):
        assert obs.overlap_efficiency(*args) == \
            jobs.overlap_efficiency(*args)


def test_hist_quantile_json_roundtrip():
    reg = monitor.MetricsRegistry()
    h = reg.histogram("x_ms")
    for v in (1.0, 3.0, 8.0, 40.0, 400.0):
        h.observe(v)
    snap = json.loads(json.dumps(reg.export()))[0]["hist"]
    q50 = obs.hist_quantile(snap, 50)
    q99 = obs.hist_quantile(snap, 99)
    assert 2.0 <= q50 <= 10.0
    assert 40.0 <= q99 <= 400.0
    assert obs.hist_quantile({"count": 0, "buckets": {}}, 50) is None
    for q in (1, 50, 90, 99, 100):
        assert obs.hist_quantile(snap, q) == jobs.hist_quantile(snap, q)


# ---------------------------------------------------------------------------
# HTTP round trip: client push loop -> collector server
# ---------------------------------------------------------------------------

def test_push_client_to_collector_http(tmp_path):
    journal_path = str(tmp_path / "steps.jsonl")
    col = obs.Collector(ttl_s=60.0)
    httpd = obs.make_obs_http(col, port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with flags.flag_guard(monitor=True, monitor_journal=journal_path):
            monitor.registry().counter("steps_total", help="steps",
                                       kind="executor").inc(3)
            w = JournalWriter(journal_path)
            for i in range(4):
                w.write({"step": i, "total_ms": 2.0})
            w.close()
            client = obs.ObsClient(endpoint=f"127.0.0.1:{port}",
                                   role="trainer", replica="r0",
                                   interval_s=30.0)
            assert client.push_once()
            assert client.push_once()   # second push: only-new tail
        procs = col.processes()
        assert len(procs) == 1
        entry = procs[0]
        assert entry.seq == 2 and entry.dropped == 0
        assert [r["step"] for r in entry.journal] == [0, 1, 2, 3]
        assert entry.labels["replica"] == "r0"
        assert abs(entry.offset_s) < 5.0   # same host, same clock
        text = col.exposition()
        assert 'steps_total{job="paddle",kind="executor",replica="r0"' \
            in text
        summary = col.summary()
        assert summary["fleet"]["pushes"] == 2
        assert summary["fleet"]["dropped_snapshots"] == 0
        assert summary["processes"][0]["journal_steps"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_bad_push_payload_is_400():
    import http.client

    col = obs.Collector(ttl_s=60.0)
    httpd = obs.make_obs_http(col, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
        conn.request("POST", "/v1/obs/push", "[1, 2]",
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 400
        conn.close()
        assert col.processes() == []
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_failed_push_retries_tail_without_loss(tmp_path):
    """A transient collector outage must not lose journal samples or
    burn sequence numbers: the failed attempt's tail rides the retry
    under the SAME seq, so the collector counts zero drops."""
    journal_path = str(tmp_path / "steps.jsonl")
    col = obs.Collector(ttl_s=60.0)
    httpd = obs.make_obs_http(col, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with flags.flag_guard(monitor_journal=journal_path):
            w = JournalWriter(journal_path)
            w.write({"step": 0, "total_ms": 1.0})
            client = obs.ObsClient(endpoint="127.0.0.1:1", replica="r0",
                                   interval_s=30.0, timeout_s=0.2)
            assert not client.push_once()     # outage: nothing listens
            assert client.failures == 1
            w.write({"step": 1, "total_ms": 1.0})
            w.close()
            client.endpoint = f"127.0.0.1:{port}"   # collector back up
            assert client.push_once()
        (entry,) = col.processes()
        assert [r["step"] for r in entry.journal] == [0, 1]
        assert entry.seq == 1 and entry.dropped == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_collector_ignores_replayed_seq_tails():
    col = obs.Collector(ttl_s=60.0)
    col.ingest(_payload("r0", seq=1,
                        journal=[{"ts": 1.0, "step": 0,
                                  "total_ms": 1.0}]))
    # the ack was lost: the client retransmits the same snapshot
    col.ingest(_payload("r0", seq=1,
                        journal=[{"ts": 1.0, "step": 0,
                                  "total_ms": 1.0}]))
    (entry,) = col.processes()
    assert len(entry.journal) == 1
    assert entry.dropped == 0


def test_maybe_start_noop_without_flag():
    assert obs.maybe_start("trainer") is None


# ---------------------------------------------------------------------------
# CLI: obs top / obs timeline / monitor multi-journal
# ---------------------------------------------------------------------------

def test_obs_top_once_renders_table(capsys):
    col = obs.Collector(ttl_s=60.0)
    col.ingest(_payload("r0", metrics=[
        _counter("steps_total", 9, kind="executor"),
        _hist("step_ms", [5.0, 7.0])]))
    httpd = obs.make_obs_http(col, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        rc = cli.main(["obs", "top", "--collector",
                       f"127.0.0.1:{port}", "--once"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "REPLICA" in out and "r0" in out
        assert "fleet: 1 up" in out
        assert "\x1b[" not in out   # no ANSI control outside a TTY
        rc = cli.main(["obs", "top", "--collector",
                       f"127.0.0.1:{port}", "--once", "--json"])
        out = capsys.readouterr().out
        assert rc == 0
        summary = json.loads(out)
        assert summary["fleet"]["processes"] == 1
        # the table is the JAX package's rendering of the same summary
        assert obs.render_summary(summary) == jobs.render_summary(summary)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_obs_top_unreachable_collector_rc2(capsys):
    rc = cli.main(["obs", "top", "--collector", "127.0.0.1:1", "--once"])
    assert rc == 2
    assert "unreachable" in capsys.readouterr().err


def test_obs_timeline_cli_merges_dumps(tmp_path, capsys):
    d1 = write_dump(str(tmp_path / "a"), _spans(2, time.perf_counter()))
    d2 = write_dump(str(tmp_path / "b"), _spans(3, time.perf_counter()))
    out = str(tmp_path / "trace.json")
    rc = cli.main(["obs", "timeline", "--dump", d1, "--dump", d2,
                   "--out", out])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "merged trace: 2 dump(s)" in printed
    loaded = json.load(open(out))
    assert len({e["pid"] for e in loaded["traceEvents"]}) == 2
    assert sum(1 for e in loaded["traceEvents"] if e["ph"] == "X") == 5


def test_monitor_cli_multi_journal_comparison(tmp_path, capsys):
    base = time.time()
    for name, slow in (("a.jsonl", 1.0), ("b.jsonl", 3.0)):
        w = JournalWriter(str(tmp_path / name))
        for i in range(5):
            w.write({"ts": base + i, "step": i, "kind": "executor",
                     "total_ms": 10.0 * slow, "cache": "hit"})
        w.close()
    rc = cli.main(["monitor", str(tmp_path / "a.jsonl"),
                   str(tmp_path / "b.jsonl")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "a.jsonl" in out and "b.jsonl" in out
    assert "max skew 20.0 ms" in out
    assert "straggler: b.jsonl" in out
    # glob form resolves to the same pair
    rc = cli.main(["monitor", str(tmp_path / "*.jsonl"), "--json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert len(data["journals"]) == 2
    assert data["fleet"]["stragglers"] == {"b.jsonl": 5}
    # single journal keeps the classic summary view
    rc = cli.main(["monitor", str(tmp_path / "a.jsonl"), "--json"])
    single = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert single["steps"] == 5
