"""Profiler host recorder (reference python/paddle/fluid/profiler.py +
platform/profiler.cc; the JAX package's paddle_tpu/profiler.py:44-83).

The host-side tables: RAII host events (record_event), counter samples
(record_counter — every monitor Gauge.set lands here) and cumulative byte
flows (record_bytes), kept while a profiling session is on, and
reset_profiler. The session itself — start_profiler/stop_profiler over
torch.profiler and export_chrome_trace's merged timeline — is not ported
yet (ROADMAP queue 1 item 8): those calls raise NotImplementedError, so
no session is ever on and the recorders only check the flag.
"""

import contextlib
import threading
import time
from collections import defaultdict

__all__ = ["reset_profiler", "start_profiler", "stop_profiler",
           "record_event", "record_counter", "record_bytes",
           "export_chrome_trace"]

_host_events = []  # (name, start, end)
_counter_events = []  # (name, t, value) — chrome-trace "C" counter samples
_byte_totals = defaultdict(float)  # name -> cumulative bytes (record_bytes)
# one lock for the counter/byte tables: threads report concurrently, and a
# record_bytes total-update + sample-append must be atomic
_rec_lock = threading.Lock()
_enabled = False

_SESSION = ("a profiling session over torch.profiler is not ported yet "
            "(ROADMAP queue 1 item 8: the rest of profiler.py)")


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


def record_counter(name, value):
    """Sample a named counter (a queue depth, a gauge's value)."""
    if _enabled:
        with _rec_lock:
            _counter_events.append((name, time.perf_counter(), float(value)))


def record_bytes(name, nbytes):
    """Accumulate a named byte flow; sampled as a cumulative MB counter."""
    if _enabled:
        with _rec_lock:
            _byte_totals[name] += float(nbytes)
            _counter_events.append(
                (name + "/MB", time.perf_counter(),
                 _byte_totals[name] / 1e6))


def reset_profiler():
    del _host_events[:]
    with _rec_lock:
        del _counter_events[:]
        _byte_totals.clear()


def start_profiler(state="All", trace_dir=None):
    raise NotImplementedError(_SESSION)


def stop_profiler(sorted_key=None, profile_path=None):
    raise NotImplementedError(_SESSION)


def export_chrome_trace(path):
    raise NotImplementedError(_SESSION)
