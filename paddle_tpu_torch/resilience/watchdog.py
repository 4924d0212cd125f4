"""Hang watchdog: when a step exceeds FLAGS_step_deadline_ms, dump every
thread's stack (and the chrome trace, when the profiler is live) instead
of letting the job burn quota in silence.

A hung collective or a deadlocked feeder looks identical from the
outside: the process is alive, the accelerator is idle, nothing is
logged. The watchdog turns that into a post-mortem: `arm()` before the
device dispatch, `disarm()` after; a single daemon monitor thread checks
armed entries every ~200ms and on deadline writes
`<FLAGS_hang_dump_dir>/hang_<label>_<n>.txt` with `sys._current_frames()`
stacks, then keeps the run alive (dump-only — killing a slow-but-alive
step is the retry layer's call, not the watchdog's).

Disabled by default (`FLAGS_step_deadline_ms=0`) so the hot path costs
one flag read.

The deadline runs on the host's clock. A captured step's replay returns
before the card has finished it, so the Executor arms the deadline over
the whole run, the fetch readback included: a card that hangs shows up
at that readback, the run's first wait for the card.
"""

import contextlib
import faulthandler
import io as _stdio
import os
import sys
import threading
import time
import traceback

from .. import flags
from .. import monitor

__all__ = ["arm", "armed", "disarm", "last_dump", "reset", "dump_stacks"]

_lock = threading.Lock()
_armed = {}          # token -> {label, deadline_at, dumped}
_next_token = [0]
_monitor = [None]    # the single watcher thread
_last_dump = [None]  # path of the most recent dump file
_dump_seq = [0]


def dump_stacks(label="manual", out=None):
    """Write all thread stacks (+ chrome trace if profiling) to a file in
    FLAGS_hang_dump_dir (cwd when unset); returns the path."""
    dump_dir = flags.get("hang_dump_dir") or "."
    os.makedirs(dump_dir, exist_ok=True)
    with _lock:
        _dump_seq[0] += 1
        seq = _dump_seq[0]
    path = os.path.join(dump_dir, f"hang_{label}_{seq}.txt")
    buf = _stdio.StringIO()
    buf.write(f"=== paddle_tpu_torch watchdog dump: {label} "
              f"pid={os.getpid()} t={time.ctime()} ===\n")
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        buf.write(f"\n--- thread {names.get(ident, '?')} "
                  f"(ident={ident}) ---\n")
        buf.write("".join(traceback.format_stack(frame)))
    with open(path, "w") as f:
        f.write(buf.getvalue())
        try:
            faulthandler.dump_traceback(file=f)  # C-level view too
        except Exception:
            pass
    trace_path = None
    try:
        from .. import profiler

        if profiler.enabled():  # a session is on: its merged timeline
            trace_path = os.path.join(dump_dir,
                                      f"hang_{label}_{seq}.trace.json")
            profiler.export_chrome_trace(trace_path)
    except Exception:
        trace_path = None
    # flight recorder: a hang is exactly what the span ring buffer is for
    # — what every thread was doing in the seconds before the deadline
    try:
        from .. import trace as _trace_mod

        if _trace_mod.enabled():
            _trace_mod.dump(reason=f"hang_{label}", out_dir=dump_dir)
    except Exception:
        pass
    _last_dump[0] = path
    monitor.registry().counter(
        "watchdog_dumps_total",
        help="stack dumps written for steps exceeding the deadline",
        label=label).inc()
    return path


def _watch_loop():
    while True:
        time.sleep(0.2)
        now = time.monotonic()
        fire = []
        with _lock:
            if not _armed:
                _monitor[0] = None
                return  # nothing armed; thread retires
            for token, e in _armed.items():
                if not e["dumped"] and now >= e["deadline_at"]:
                    e["dumped"] = True
                    fire.append(e["label"])
        for label in fire:
            try:
                dump_stacks(label)
            except Exception:
                pass


def arm(label="step", deadline_ms=None):
    """Start the countdown for one step; returns a token for disarm().
    Returns None (no-op) when the deadline flag is 0/unset."""
    ms = deadline_ms if deadline_ms is not None \
        else flags.get("step_deadline_ms")
    if not ms or ms <= 0:
        return None
    with _lock:
        _next_token[0] += 1
        token = _next_token[0]
        _armed[token] = {"label": label, "dumped": False,
                         "deadline_at": time.monotonic() + ms / 1000.0}
        if _monitor[0] is None or not _monitor[0].is_alive():
            _monitor[0] = threading.Thread(
                target=_watch_loop, daemon=True,
                name="resilience-watchdog")
            _monitor[0].start()
    return token


def disarm(token):
    """Cancel a countdown; safe with the None token from a disabled arm.
    Returns True if the step had already been dumped as hung."""
    if token is None:
        return False
    with _lock:
        e = _armed.pop(token, None)
    return bool(e and e["dumped"])


@contextlib.contextmanager
def armed(label="step", deadline_ms=None):
    """arm/disarm around a block: `with watchdog.armed("executor"): ...`.
    Free (no thread, no lock) when FLAGS_step_deadline_ms is 0."""
    token = arm(label, deadline_ms=deadline_ms)
    try:
        yield token
    finally:
        disarm(token)


def last_dump():
    return _last_dump[0]


def reset():
    """Test hook: forget armed entries and the last dump path."""
    with _lock:
        _armed.clear()
        _last_dump[0] = None
