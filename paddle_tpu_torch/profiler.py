"""Profiler (reference python/paddle/fluid/profiler.py + platform/profiler.cc;
the JAX package's paddle_tpu/profiler.py).

torch.profiler (CUPTI's device tracer, the JAX package's jax.profiler
counterpart) plus a host-side event table mirroring the reference's
RecordEvent aggregation (profiler.cc:326 ParseEvents), so `profiler(...)`
prints the familiar per-op summary for interpreted runs: RAII host events
(record_event; the interpreter wraps every op in one, "op::<type>"),
counter samples (record_counter — every monitor Gauge.set lands here) and
cumulative byte flows (record_bytes), kept while a session is on.

A session with a trace_dir also runs torch.profiler over the CPU and, with
a card, CUDA activities; stop_profiler writes its chrome trace into
trace_dir, and export_chrome_trace merges it with the host lane into one
timeline.
"""

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

__all__ = ["cuda_profiler", "reset_profiler", "profiler", "start_profiler",
           "stop_profiler", "record_event", "record_counter",
           "record_bytes", "export_chrome_trace"]

_host_events = []  # (name, start, end)
_counter_events = []  # (name, t, value) — chrome-trace "C" counter samples
_byte_totals = defaultdict(float)  # name -> cumulative bytes (record_bytes)
# one lock for the counter/byte tables: threads report concurrently, and a
# record_bytes total-update + sample-append must be atomic or a racing
# thread publishes a stale cumulative point (a dip in a monotone MB track)
_rec_lock = threading.Lock()
_enabled = False
_session = None  # the running torch.profiler.profile and its trace_dir
_last_trace = None  # (device trace file, perf_counter at its marker)
_trace_t0 = None  # perf_counter at the merged timeline's origin

_DEVICE_TRACE = "device_trace.json"
# the user annotation that marks the host clock's origin (_trace_t0) on
# the device trace's clock
_ORIGIN = "paddle_tpu_torch::profiler_origin"


class _Event:
    __slots__ = ("name", "start", "end")

    def __init__(self, name):
        self.name = name
        self.start = time.perf_counter()
        self.end = None


@contextlib.contextmanager
def record_event(name):
    """RAII host event (reference platform/profiler.h:72 RecordEvent)."""
    ev = _Event(name)
    try:
        yield
    finally:
        ev.end = time.perf_counter()
        if _enabled:
            _host_events.append(ev)


def enabled():
    """Whether a profiling session is on (the interpreter's per-op events
    are recorded only then)."""
    return _enabled


def record_counter(name, value):
    """Sample a named counter (a queue depth, a gauge's value); rendered as
    a chrome-trace counter track ("ph": "C") in export_chrome_trace."""
    if _enabled:
        with _rec_lock:
            _counter_events.append((name, time.perf_counter(), float(value)))


def record_bytes(name, nbytes):
    """Accumulate a named byte flow; rendered as a cumulative MB counter
    track in the merged chrome trace, so throughput reads off its slope."""
    if _enabled:
        with _rec_lock:
            _byte_totals[name] += float(nbytes)
            _counter_events.append(
                (name + "/MB", time.perf_counter(),
                 _byte_totals[name] / 1e6))


def reset_profiler():
    global _last_trace, _trace_t0
    del _host_events[:]
    with _rec_lock:
        del _counter_events[:]
        _byte_totals.clear()
    _last_trace = None
    _trace_t0 = None


def _start_device_trace():
    """(a running torch.profiler over the CPU and, with a card, CUDA
    activities; the perf_counter instant its origin marker stands for)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    with record_function(_ORIGIN):
        marker = time.perf_counter()
    return prof, marker


def _stop_device_trace(session, trace_dir):
    """Stop a session's profiler and write its chrome trace into
    trace_dir, kept for export_chrome_trace."""
    global _last_trace
    prof, marker = session
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, _DEVICE_TRACE)
    prof.export_chrome_trace(path)
    _last_trace = (path, marker)


def start_profiler(state="All", trace_dir=None):
    """Start a session: host events, counters and bytes are recorded from
    now on; with `trace_dir`, torch.profiler traces the host and the card
    too. `state` ('CPU', 'GPU', 'All') is accepted for API parity: the
    card's activity is traced whenever there is a card."""
    global _enabled, _session, _last_trace, _trace_t0
    _enabled = True
    # a fresh session must not inherit the previous session's device trace
    # or its time origin (stale merge + mis-shifted host spans otherwise)
    _last_trace = None
    _trace_t0 = None
    if trace_dir:
        _session = (_start_device_trace(), str(trace_dir))
        _trace_t0 = _session[0][1]


def stop_profiler(sorted_key=None, profile_path=None):
    """End the session: write the device trace (with a trace_dir) and
    print the host events' summary table, also written to
    `profile_path`.txt (default: <tmpdir>/profile.txt)."""
    global _enabled, _session
    _enabled = False
    if _session is not None:
        device, trace_dir = _session
        _session = None
        _stop_device_trace(device, trace_dir)
    if profile_path is None:
        profile_path = os.path.join(tempfile.gettempdir(), "profile")
    _print_summary(sorted_key, profile_path)


def _print_summary(sorted_key, profile_path):
    if not _host_events:
        return
    stats = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])  # calls, total, min, max
    for ev in _host_events:
        s = stats[ev.name]
        dur = (ev.end - ev.start) * 1000.0
        s[0] += 1
        s[1] += dur
        s[2] = min(s[2], dur)
        s[3] = max(s[3], dur)
    items = list(stats.items())
    key_fn = {
        "calls": lambda kv: -kv[1][0],
        "total": lambda kv: -kv[1][1],
        "max": lambda kv: -kv[1][3],
        "min": lambda kv: -kv[1][2],
        "ave": lambda kv: -(kv[1][1] / kv[1][0]),
    }.get(sorted_key, lambda kv: -kv[1][1])
    items.sort(key=key_fn)
    header = f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}{'Max(ms)':>10}{'Ave(ms)':>10}"
    lines = [header, "-" * len(header)]
    for name, (calls, total, mn, mx) in items:
        lines.append(
            f"{name:<40}{calls:>8}{total:>12.4f}{mn:>10.4f}{mx:>10.4f}{total / calls:>10.4f}"
        )
    report = "\n".join(lines)
    print(report)
    try:
        with open(profile_path + ".txt", "w") as f:
            f.write(report)
    except OSError:
        pass


_DEVICE_PID_BASE = 100  # keep device pids clear of the host lane's pid 0


def _load_device_trace(last, t0):
    """The chrome-trace events of `last` (the device trace file and the
    perf_counter instant of its origin marker), shifted onto the origin
    `t0` and with pids offset into the device range. Returns [] when no
    trace was written."""
    if last is None or not os.path.exists(last[0]):
        return []
    path, marker = last
    with open(path) as f:
        raw = json.load(f).get("traceEvents", [])
    origin = next((float(e["ts"]) for e in raw if isinstance(e, dict)
                   and e.get("name") == _ORIGIN and "ts" in e), 0.0)
    shifted = []
    for e in raw:
        if not isinstance(e, dict) or "pid" not in e:
            continue
        e = dict(e)
        try:
            e["pid"] = _DEVICE_PID_BASE + int(e["pid"])
        except (TypeError, ValueError):
            e["pid"] = f"{_DEVICE_PID_BASE}:{e['pid']}"
        if "ts" in e:
            e["ts"] = float(e["ts"]) - origin + (marker - t0) * 1e6
        shifted.append(e)
    return shifted


def export_chrome_trace(path):
    """ONE merged chrome://tracing / Perfetto JSON with BOTH lanes — host
    RecordEvent spans and counters (pid 0), the flight recorder's spans
    (pid 1), and torch.profiler's host and device rows (pids from 100)
    (reference tools/timeline.py:36-97, which merges host events with
    CUPTI device records via device_tracer.cc:44 the same way).

    Alignment: the session marks its start on the profiler's clock with a
    user annotation taken at a known perf_counter instant; the device
    rows are shifted so that mark is ts 0, and the host events onto the
    same origin."""
    t0 = _trace_t0 if _trace_t0 is not None else (
        min((ev.start for ev in _host_events), default=0.0))
    events = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "paddle_tpu_torch host"}},
        {"ph": "M", "pid": 0, "name": "process_sort_index",
         "args": {"sort_index": 0}},
    ]
    for ev in _host_events:
        events.append({
            "name": ev.name,
            "ph": "X",  # complete event
            "ts": (ev.start - t0) * 1e6,
            "dur": (ev.end - ev.start) * 1e6,
            "pid": 0,
            "tid": "host",
            "cat": "host",
        })
    for name, t, value in _counter_events:
        events.append({
            "name": name,
            "ph": "C",
            "ts": (t - t0) * 1e6,
            "pid": 0,
            "args": {"value": value},
        })
    # third lane: flight-recorder spans (pid 1) on the same time origin —
    # serve and step spans line up against host events and the device
    # trace
    from . import trace as _trace_mod

    spans, _dropped = _trace_mod.snapshot()
    if spans:
        events.extend(_trace_mod.chrome_events(spans, t0=t0))
    events.extend(_load_device_trace(_last_trace, t0))
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return path


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """API parity with reference profiler.py:33: a torch.profiler trace of
    the block. `output_file` names the trace DIRECTORY (the device trace
    lands in it as device_trace.json); it is also kept, with the session's
    time origin, so a following export_chrome_trace merges this block's
    device lane."""
    global _trace_t0
    device = _start_device_trace()
    if _trace_t0 is None:
        # keep an enclosing start_profiler's origin; otherwise this block
        # defines the merged timeline's zero
        _trace_t0 = device[1]
    try:
        yield
    finally:
        _stop_device_trace(device, str(output_file))


@contextlib.contextmanager
def profiler(state, sorted_key=None, profile_path=None):
    """reference profiler.py:76. state in {'CPU','GPU','All'}: every state
    traces the host and, with a card, the card (torch.profiler, written
    under <tmpdir>/paddle_tpu_torch_trace) beside the host events."""
    start_profiler(state, trace_dir=os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_trace"))
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
