"""Flight recorder: always-on per-thread span ring buffers + dump triggers.

A black-box recorder, not a profiler session: while FLAGS_trace=1 every
span lands in the APPENDING THREAD's fixed-size ring (FLAGS_trace_buffer
spans each), so the last N spans per thread are always available with no
cross-thread contention on the hot path — appends touch only thread-local
state (list slot assignment is atomic under the GIL); the global registry
lock is taken once per thread lifetime, when its ring is created.

The recorder is read two ways:

    snapshot()            -> (spans sorted by t0, dropped_count)
    dump(reason)          -> trace_<reason>_<n>/ directory with
                             spans.jsonl + trace.json (chrome) +
                             manifest.json        (export.py formats)

maybe_dump(reason) is the anomaly hook the serve SLO / overload paths
and the model-health detectors call: per-reason cooldown (FLAGS_trace_dump_cooldown_s) so a storm of
violations produces one post-mortem, not a disk flood; a no-op (one flag
check) when tracing is off. Dumps never raise into the caller.

A copy of the JAX package's paddle_tpu/trace/recorder.py: a dump's
manifest carries the slowest-ops table (trace/costs.py) when a prepared
step's FLOPs were measured, null otherwise.
"""

import os
import re
import threading
import time

from .. import flags
from .. import monitor

__all__ = ["append", "snapshot", "reset", "dump", "maybe_dump",
           "last_dump"]

_lock = threading.Lock()
_rings = []          # [(thread_name, _Ring)] — grows per recording thread
_gen = [0]           # bumped by reset(): stale thread-local rings re-register
_tls = threading.local()
_dump_seq = [0]
_last_dump = [None]
_last_trigger = {}   # reason -> time.monotonic() of last accepted dump

_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]+")


class _Ring:
    """Fixed-size overwrite-oldest span buffer owned by ONE thread; only
    snapshot() reads it cross-thread (GIL-consistent slot reads — a torn
    snapshot can at worst miss/duplicate the span being written)."""

    __slots__ = ("buf", "cap", "n")

    def __init__(self, cap):
        self.cap = max(16, int(cap))
        self.buf = [None] * self.cap
        self.n = 0

    def append(self, sp):
        self.buf[self.n % self.cap] = sp
        self.n += 1

    def items(self):
        if self.n <= self.cap:
            return [s for s in self.buf[:self.n] if s is not None]
        i = self.n % self.cap
        return [s for s in self.buf[i:] + self.buf[:i] if s is not None]

    def dropped(self):
        return max(0, self.n - self.cap)


def append(sp):
    """Land one span dict in the calling thread's ring (span.py's only
    entry point; callers have already passed the enabled() gate)."""
    ring = getattr(_tls, "ring", None)
    if ring is None or getattr(_tls, "gen", -1) != _gen[0]:
        ring = _Ring(flags.get("trace_buffer"))
        with _lock:
            _tls.ring = ring
            _tls.gen = _gen[0]
            _rings.append((threading.current_thread().name, ring))
    ring.append(sp)


def snapshot():
    """(spans sorted by t0, dropped span count) across every thread's
    ring — the live read the dump and the unified chrome export use."""
    with _lock:
        rings = list(_rings)
    spans, dropped = [], 0
    for _, ring in rings:
        spans.extend(ring.items())
        dropped += ring.dropped()
    spans.sort(key=lambda s: s["t0"])
    return spans, dropped


def reset():
    """Fresh recorder (tests / long-lived processes): forget every ring,
    trigger cooldowns, and the last-dump path. Threads still holding a
    stale thread-local ring re-register on their next append."""
    with _lock:
        _gen[0] += 1
        _rings.clear()
        _last_trigger.clear()
        _last_dump[0] = None


def last_dump():
    """Path of the most recent dump directory, or None."""
    return _last_dump[0]


def dump(reason="manual", out_dir=None):
    """Write the flight recorder to <out_dir>/trace_<reason>_<n>/
    (out_dir defaults to FLAGS_trace_dump_dir, then cwd) and return the
    directory path. Format: export.write_dump (spans.jsonl + chrome
    trace.json + manifest.json, with the slowest-ops table when cost
    attribution is available)."""
    from . import costs, export

    reason = _REASON_RE.sub("_", str(reason)) or "manual"
    spans, dropped = snapshot()
    base = out_dir or flags.get("trace_dump_dir") or "."
    with _lock:
        _dump_seq[0] += 1
        seq = _dump_seq[0]
        buffers = len(_rings)
    path = os.path.join(base, f"trace_{reason}_{seq}")
    try:
        slowest = costs.slowest_ops()
    except Exception:
        slowest = None
    export.write_dump(path, spans, reason=reason, dropped=dropped,
                      buffers=buffers, slowest_ops=slowest)
    _last_dump[0] = path
    monitor.registry().counter(
        "trace_dumps_total",
        help="flight-recorder dumps written, by trigger reason",
        reason=reason).inc()
    _prune_dumps(base)
    return path


_DUMP_DIR_RE = re.compile(r"^trace_.+_\d+$")


def _prune_dumps(base):
    """FLAGS_trace_dump_keep retention: remove the oldest trace_*_<n>/
    siblings beyond the cap. Best-effort — retention must never fail the
    dump that triggered it."""
    keep = flags.get("trace_dump_keep")
    if not keep or keep <= 0:
        return
    try:
        dirs = []
        for name in os.listdir(base):
            p = os.path.join(base, name)
            if _DUMP_DIR_RE.match(name) and os.path.isdir(p):
                dirs.append((os.path.getmtime(p), name, p))
        dirs.sort()
        for _, _, p in dirs[:max(0, len(dirs) - int(keep))]:
            import shutil

            shutil.rmtree(p, ignore_errors=True)
            monitor.registry().counter(
                "trace_dumps_pruned_total",
                help="flight-recorder dumps removed by the "
                     "FLAGS_trace_dump_keep retention cap").inc()
    except OSError:
        pass


def maybe_dump(reason):
    """Anomaly hook (serve SLO violation / overload, a health detector
    event): dump unless tracing is off or `reason` dumped within the cooldown window. Never raises — a failed post-mortem must not take
    down the path that triggered it. Returns the dump path or None."""
    from .span import enabled

    if not enabled():
        return None
    cooldown = flags.get("trace_dump_cooldown_s")
    now = time.monotonic()
    with _lock:
        last = _last_trigger.get(reason)
        if last is not None and cooldown > 0 and now - last < cooldown:
            return None
        _last_trigger[reason] = now
    try:
        return dump(reason)
    except Exception:
        return None
