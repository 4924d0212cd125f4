"""Step-level monitor: phase records, compile-cache visibility, journal.

The executors call exactly three things on the hot path:

    mon = monitor.step_begin("executor") if monitor.enabled() else None
    ...
    mon.phase("dispatch", seconds)          # guarded by `mon is not None`
    ...
    monitor.step_end(mon, iters=K)

step_begin is gated on ONE flag check; with FLAGS_monitor=0 nothing else
runs — no allocation, no registry mutation, no journal I/O (asserted by
tests/test_torch_monitor_step.py). step_end folds the record into the
process registry (counters/gauges/histograms), captures it as
last_step(), and appends one JSONL line when FLAGS_monitor_journal names
a path. It reads the host clock only: phases are enqueue times, and
nothing here waits for the card.

Compile-cache visibility: executors mark every prepared-step lookup
(mark_cache), and on a miss, with FLAGS_monitor_hlo_cost on, run the first
eager step of the prepared program under compile_probe(): the FLOPs that
torch.utils.flop_counter counts there (matmuls and convolutions, forward
and backward) per fingerprint, where the JAX package records XLA's HLO
cost analysis of the lowered step. A copy of the JAX package's
paddle_tpu/monitor/step.py but for that probe and the ported flags'
help strings.
"""

import contextlib
import threading
import time

from .. import flags
from .journal import JournalWriter
from .registry import MetricsRegistry
from .skew import replica_skew

__all__ = ["StepRecord", "enabled", "registry", "exposition", "reset",
           "step_begin", "step_end", "last_step", "compile_info",
           "record_compile", "compile_probe", "fingerprint_of",
           "steps_done", "restore_steps"]

flags.define(
    "monitor_hlo_cost", bool, False,
    "On every prepared-step miss, run the program's first eager step "
    "under torch.utils.flop_counter.FlopCounterMode and record its FLOPs "
    "per program fingerprint (times iters for an iters=K run, so the "
    "figure is per dispatch) — the model-FLOPs source for MFU accounting. "
    "It counts the matmuls and convolutions, 2 FLOPs per multiply-add, "
    "forward and backward, but not the forward a derived grad runs again; "
    "bytes accessed are not counted (None). Off by default: the counter "
    "slows the step it watches.")
flags.define(
    "monitor_replica_skew", bool, False,
    "Measure per-rank step-completion times over the ParallelExecutor's "
    "group each step (max/median skew, slowest rank). Waits for the card "
    "and all-gathers the times each step — a straggler-hunting mode, not "
    "a production default.")

_registry = MetricsRegistry()
_lock = threading.Lock()
_state = {
    "steps": 0,          # process-wide step index
    "last": None,        # last completed step record (dict)
    "journal": None,     # open JournalWriter
    "journal_path": None,
    "compile_info": {},  # fingerprint -> {wall_s, flops, bytes_accessed}
}


def enabled():
    """THE per-step flag check: everything else is gated on its result."""
    return bool(flags.get("monitor"))


_trace_mod = [None]


def _trace():
    """Lazy paddle_tpu_torch.trace handle (trace imports monitor; importing
    it at module top would be circular)."""
    if _trace_mod[0] is None:
        from .. import trace

        _trace_mod[0] = trace
    return _trace_mod[0]


def registry():
    return _registry


def exposition():
    """Prometheus-style text exposition of the process registry."""
    return _registry.exposition()


def reset():
    """Fresh telemetry session: drop metrics, step records, compile info,
    and close any open journal (tests / long-lived processes)."""
    with _lock:
        _state["steps"] = 0
        _state["last"] = None
        _state["compile_info"] = {}
        w, _state["journal"], _state["journal_path"] = \
            _state["journal"], None, None
    if w is not None:
        w.close()
    _registry.reset()


class StepRecord:
    """Accumulates one step's phases; built only when monitoring is on."""

    __slots__ = ("kind", "t0", "phases", "cache", "cache_level",
                 "fingerprint", "extra", "intervals")

    def __init__(self, kind):
        self.kind = kind
        self.t0 = time.perf_counter()
        self.phases = {}        # name -> seconds
        self.cache = None       # "hit" | "miss"
        self.cache_level = None  # "l1" | "l2" on a hit
        self.fingerprint = None
        self.extra = None    # journal-only extras
        self.intervals = []  # (name, t0, t1) per occurrence — the phase
        #                      boundaries step_end replays as trace spans

    def phase(self, name, seconds, interval=None):
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)
        if interval is None:
            # direct callers report a duration after the fact; anchor the
            # interval so it ENDS now (executor calls phase() right after
            # timing the block)
            t1 = time.perf_counter()
            interval = (t1 - float(seconds), t1)
        self.intervals.append((name, interval[0], interval[1]))

    @contextlib.contextmanager
    def timed(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.phase(name, t1 - t0, interval=(t0, t1))

    def mark_cache(self, hit, fingerprint=None, level=None):
        """level: "l1" (in-process) or "l2" (the prepared plan read from
        the persistent store) on a hit. A warm-started process therefore
        reports compile_cache_misses == 0, as the JAX package's does."""
        self.cache = "hit" if hit else "miss"
        self.cache_level = level if hit else None
        self.fingerprint = fingerprint
        _registry.counter(
            "compile_cache_hits_total" if hit else
            "compile_cache_misses_total",
            help="executor compile-cache lookups",
            cache=self.kind).inc()


def cache_evicted(kind="executor"):
    """Count one compile-cache eviction (FLAGS_compile_cache_cap)."""
    _registry.counter("compile_cache_evictions_total",
                      help="compile-cache entries evicted by the cap",
                      cache=kind).inc()


_L2_HELP = {
    "hits": "persistent compile-cache loads (warm starts)",
    "misses": "persistent compile-cache lookups with no entry",
    "fallbacks": "corrupt/stale/undecodable persistent entries "
                 "prepared over",
    "puts": "prepared plans written into the persistent store",
    "put_bytes": "bytes written to the persistent store",
}


def cache_l2(kind, which, n=1):
    """Count one persistent (L2) compile-cache event:
    compile_cache_l2_<which>_total{cache=kind}. Callers
    (paddle_tpu_torch.cache) gate on enabled() so FLAGS_monitor=0 keeps
    the registry untouched."""
    _registry.counter(
        f"compile_cache_l2_{which}_total",
        help=_L2_HELP.get(which, "persistent compile-cache events"),
        cache=kind).inc(n)


def step_begin(kind="executor"):
    """One step's record; callers gate on enabled() themselves so the
    disabled path stays a single flag check."""
    return StepRecord(kind)


def fingerprint_of(cache_key):
    """Short stable-within-process id of a prepared-step key (joins the
    journal's cache lines with compile_info entries)."""
    return format(hash(cache_key) & 0xFFFFFFFF, "08x")


def record_compile(fingerprint, wall_s=None, flops=None,
                   bytes_accessed=None):
    """Fold one compile's wall time / FLOPs into compile_info and the
    registry (per-fingerprint gauges)."""
    with _lock:
        info = _state["compile_info"].setdefault(str(fingerprint), {})
        if wall_s is not None:
            info["wall_s"] = float(wall_s)
        if flops is not None:
            info["flops"] = float(flops)
        if bytes_accessed is not None:
            info["bytes_accessed"] = float(bytes_accessed)
    if wall_s is not None:
        _registry.gauge("compile_wall_seconds",
                        help="prepare, first step and capture wall time per "
                             "program fingerprint",
                        fingerprint=str(fingerprint)).set(wall_s)
    if flops is not None:
        _registry.gauge("hlo_flops",
                        help="compile probe: matmul and convolution FLOPs per "
                             "dispatch",
                        fingerprint=str(fingerprint)).set(flops)
    if bytes_accessed is not None:
        _registry.gauge("hlo_bytes_accessed",
                        help="compile probe: bytes accessed per dispatch",
                        fingerprint=str(fingerprint)).set(bytes_accessed)


def compile_info():
    """{fingerprint: {wall_s, flops, bytes_accessed}} snapshot."""
    with _lock:
        return {k: dict(v) for k, v in _state["compile_info"].items()}


class _Probe:
    """The FLOP counter over one eager step (compile_probe). The forward
    that a derived grad runs again (core/registry.py make_vjp_kernel) is
    left out: its kernels run inside `uncounted()`, whose FLOPs are
    subtracted, while the grad's backward kernels count. The JAX package's
    XLA computes that forward once."""

    _active = threading.local()

    def __init__(self, fingerprint, steps):
        self.fingerprint = fingerprint
        self.steps = int(steps)
        self.excluded = 0
        self._counter = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self._counter = FlopCounterMode(display=False)
        self._counter.__enter__()
        _Probe._active.probe = self
        return self

    def __exit__(self, *exc):
        _Probe._active.probe = None
        self._counter.__exit__(*exc)
        if exc[0] is None:
            record_compile(self.fingerprint, flops=self.flops())
        return False

    def flops(self):
        """FLOPs of one dispatch: the counted step's times `steps`."""
        return (self._counter.get_total_flops() - self.excluded) \
            * self.steps

    @contextlib.contextmanager
    def uncounted(self):
        """Leave the FLOPs of the block out of the count."""
        before = self._counter.get_total_flops()
        try:
            yield
        finally:
            self.excluded += self._counter.get_total_flops() - before


def active_probe():
    """The compile probe counting on this thread, or None."""
    return getattr(_Probe._active, "probe", None)


def compile_probe(fingerprint, steps=1):
    """Probe for the executors: a context manager around the first eager
    step of a prepared program that records the step's FLOPs (times
    `steps`, the run's iters) under `fingerprint`. bytes_accessed stays
    unrecorded: the flop counter does not count bytes."""
    return _Probe(fingerprint, steps)


def _journal_writer():
    path = flags.get("monitor_journal")
    if not path:
        return None
    with _lock:
        if _state["journal_path"] != path:
            old = _state["journal"]
            if old is not None:
                old.close()
            _state["journal"] = JournalWriter(path)
            _state["journal_path"] = path
        return _state["journal"]


def step_end(rec, iters=None, datapipe=None, replica_ms=None,
             replica_ids=None):
    """Close one StepRecord: registry metrics, last_step capture, journal.

    datapipe: the DataPipe the step pulled from (its per-step stage-stat
    deltas merge into the record); replica_ms/replica_ids: per-rank
    completion stamps from skew.measure_replica_ms."""
    if rec is None:
        return None
    total_ms = (time.perf_counter() - rec.t0) * 1000.0
    _registry.counter("steps_total", help="executor steps run",
                      kind=rec.kind).inc()
    _registry.histogram("step_ms", help="wall time per executor step",
                        kind=rec.kind).observe(total_ms)
    _registry.gauge("last_step_ms", help="wall time of the last step",
                    kind=rec.kind).set(total_ms)
    phases_ms = {}
    for name, s in rec.phases.items():
        ms = s * 1000.0
        phases_ms[name] = round(ms, 6)
        _registry.histogram("step_phase_ms",
                            help="per-phase wall time within a step",
                            kind=rec.kind, phase=name).observe(ms)
        _registry.gauge("last_phase_ms",
                        help="per-phase wall time of the last step",
                        kind=rec.kind, phase=name).set(ms)

    with _lock:
        _state["steps"] += 1
        step_idx = _state["steps"]
    record = {
        "ts": time.time(),
        "step": step_idx,
        "kind": rec.kind,
        "iters": iters,
        "total_ms": round(total_ms, 6),
        "phases_ms": phases_ms,
    }
    if rec.cache is not None:
        record["cache"] = rec.cache
        record["fingerprint"] = rec.fingerprint
        if rec.cache_level is not None:
            record["cache_level"] = rec.cache_level
    if rec.extra:
        record.update(rec.extra)

    if datapipe is not None:
        try:
            delta = (datapipe.stats_delta()
                     if hasattr(datapipe, "stats_delta")
                     else datapipe.stats())
        except Exception:
            delta = None
        if delta:
            record["datapipe"] = delta
        wire = getattr(datapipe, "wire_spec", None)
        if wire is not None and hasattr(wire, "describe"):
            record["wire"] = wire.describe()

    if replica_ms:
        sk = replica_skew(replica_ms, ids=replica_ids)
        record["replica_ms"] = [round(t, 6) for t in replica_ms]
        if replica_ids is not None:
            record["replica_ids"] = list(replica_ids)
        record["skew"] = sk
        for i, t in enumerate(replica_ms):
            rid = replica_ids[i] if replica_ids is not None else i
            _registry.gauge("replica_step_ms",
                            help="per-replica step completion time",
                            replica=str(rid)).set(t)
        if sk["max_over_median"] is not None:
            _registry.gauge("replica_skew_max_over_median",
                            help="straggler signal: max/median "
                                 "per-replica step time").set(
                sk["max_over_median"])

    with _lock:
        _state["last"] = record
    writer = _journal_writer()
    if writer is not None:
        writer.write(record)

    # retroactive trace emission: the step and its phase boundaries are
    # already measured above, so the flight recorder gets them for free —
    # one extra flag check per step when tracing is off
    tr = _trace()
    if tr.enabled():
        attrs = {"step": step_idx}
        if iters is not None:
            attrs["iters"] = iters
        if rec.cache is not None:
            attrs["cache"] = rec.cache
            attrs["fingerprint"] = rec.fingerprint
        ctx = tr.record(f"{rec.kind}.step", rec.t0,
                        rec.t0 + total_ms / 1000.0, kind="step",
                        attrs=attrs)
        for name, p0, p1 in rec.intervals:
            tr.record(name, p0, p1, kind="phase", parent=ctx)
    return record


def last_step():
    """The most recent completed step record (dict), or None."""
    with _lock:
        rec = _state["last"]
        return dict(rec) if rec is not None else None


def steps_done():
    """Process-wide completed-step count (rides checkpoint manifests)."""
    with _lock:
        return _state["steps"]


def restore_steps(n):
    """Rewind/advance the step counter to a checkpoint's value, so journal
    step indices stay monotonic across a restore."""
    with _lock:
        _state["steps"] = int(n)
