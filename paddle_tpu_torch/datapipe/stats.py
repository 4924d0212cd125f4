"""Per-stage observability for the datapipe subsystem.

Every pipeline stage owns a StageStats: item/byte counts, busy time (doing
the stage's own work), wait-in time (blocked on the upstream queue) and
wait-out time (blocked pushing downstream — backpressure), plus sampled
queue depths. PipeStats aggregates them in wiring order and renders the
dict `DataPipe.stats()` returns (and bench.py prints).

Profiler integration: stage work spans are emitted through
profiler.record_event (so they land in the host lane of the merged
chrome trace) and queue depths through profiler.record_counter.
"""

import threading
import time

__all__ = ["StageStats", "PipeStats"]


class StageStats:
    """Counters for one pipeline stage; all mutation is lock-protected
    (stages touch their stats from worker threads)."""

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self.items = 0
        self.bytes = 0
        self.busy_s = 0.0
        self.wait_in_s = 0.0
        self.wait_out_s = 0.0
        self.bp_wait_s = 0.0  # blocked on capacity tickets (backpressure)
        self._depth_sum = 0
        self._depth_n = 0
        self._t_first = None
        self._t_last = None

    # -- recording -----------------------------------------------------
    def add_item(self, busy_s=0.0, nbytes=0, count=1):
        """Record `count` items finished in one go (coalesced dispatch
        acks a whole run at once) with their combined busy time/bytes."""
        now = time.perf_counter()
        with self._lock:
            self.items += int(count)
            self.bytes += int(nbytes)
            self.busy_s += busy_s
            if self._t_first is None:
                self._t_first = now
            self._t_last = now

    def add_wait_in(self, dt):
        with self._lock:
            self.wait_in_s += dt

    def add_wait_out(self, dt):
        with self._lock:
            self.wait_out_s += dt

    def add_bp_wait(self, dt):
        """Time this stage spent blocked acquiring a capacity ticket —
        distinct from wait_out (a consumer not showing up): bp_wait means
        the DOWNSTREAM budget (prefetch depth, ring slots) is full."""
        with self._lock:
            self.bp_wait_s += dt

    def sample_depth(self, depth):
        with self._lock:
            self._depth_sum += int(depth)
            self._depth_n += 1
        from .. import monitor, profiler

        profiler.record_counter(f"datapipe/{self.name}/qdepth", depth)
        if monitor.enabled():
            monitor.registry().gauge(
                "datapipe_queue_depth",
                help="sampled stage queue depth",
                stage=self.name).set(depth)

    def span(self):
        """Context manager timing one unit of stage work; also emits a
        profiler host event so stages show up in the merged timeline."""
        from .. import profiler

        return profiler.record_event(f"datapipe/{self.name}")

    # -- reporting -----------------------------------------------------
    def snapshot(self):
        with self._lock:
            span = ((self._t_last - self._t_first)
                    if self._t_first is not None and self.items > 1 else 0.0)
            d = {
                "items": self.items,
                "bytes": self.bytes,
                "busy_s": round(self.busy_s, 6),
                "wait_in_s": round(self.wait_in_s, 6),
                "wait_out_s": round(self.wait_out_s, 6),
                "bp_wait_s": round(self.bp_wait_s, 6),
            }
            if span > 0:
                d["items_per_sec"] = round(self.items / span, 2)
                # fraction of the stage's active span spent doing its own
                # work — ~1.0 marks the pipeline's bottleneck stage
                d["occupancy"] = round(min(self.busy_s / span, 1.0), 4)
                if self.bytes:
                    d["MB_per_sec"] = round(self.bytes / 1e6 / span, 2)
            if self._depth_n:
                d["queue_depth_avg"] = round(
                    self._depth_sum / self._depth_n, 2)
            return d


class PipeStats:
    """Ordered collection of StageStats for one DataPipe."""

    def __init__(self):
        self._stages = []  # wiring order
        self._lock = threading.Lock()
        self._delta_base = {}  # stage name -> counters at last delta()

    def stage(self, name):
        with self._lock:
            # unique-ify repeated stage kinds (two map stages, ...)
            names = {s.name for s in self._stages}
            base, n = name, 1
            while name in names:
                n += 1
                name = f"{base}_{n}"
            s = StageStats(name)
            self._stages.append(s)
            return s

    def snapshot(self):
        """{stage_name: counters} in wiring order, plus 'fractions': each
        stage's busy time as a fraction of the pipeline wall span and the
        consumer-visible wait fraction (how starved the device loop was)."""
        with self._lock:
            stages = list(self._stages)
        out = {s.name: s.snapshot() for s in stages}
        total_busy = sum(out[s.name]["busy_s"] for s in stages)
        if total_busy > 0:
            out["fractions"] = {
                s.name: round(out[s.name]["busy_s"] / total_busy, 4)
                for s in stages
            }
        bn = self._bottleneck(out)
        if bn is not None:
            out["bottleneck_stage"] = bn
        lane = self._bottleneck_lane(out)
        if lane is not None:
            out["bottleneck_lane"] = lane
        return out

    @staticmethod
    def _bottleneck(snap):
        """The stage with the most cumulative busy time — the one to
        speed up for throughput. Per-lane linkN rows duplicate the
        transfer stage's busy and are excluded."""
        best, best_busy = None, 0.0
        for name, d in snap.items():
            if not isinstance(d, dict) or "busy_s" not in d \
                    or name.startswith("link"):
                continue
            if d["busy_s"] > best_busy:
                best, best_busy = name, d["busy_s"]
        return best

    @staticmethod
    def _bottleneck_lane(snap):
        """The busiest transfer LANE when more than one moved data. The
        aggregate `transfer` row merges every lane's busy-ms, which used
        to attribute a slow second stream to link0; this names the actual
        slow lane so a stuck transfer thread is visible per-lane."""
        lanes = [(name, d) for name, d in snap.items()
                 if isinstance(d, dict) and name.startswith("link")
                 and d.get("items", 0) > 0]
        if len(lanes) < 2:
            return None
        return max(lanes, key=lambda nd: nd[1].get("busy_s", 0.0))[0]

    _DELTA_KEYS = ("items", "bytes", "busy_s", "wait_in_s", "wait_out_s",
                   "bp_wait_s")

    def delta(self):
        """Per-stage counter DELTAS since the previous delta() call — what
        one executor step consumed/waited, not lifetime totals (the
        monitor's step journal merges this, one record per step)."""
        with self._lock:
            stages = list(self._stages)
        out = {}
        with self._lock:
            for s in stages:
                snap = s.snapshot()
                base = self._delta_base.get(s.name, {})
                d = {k: round(snap.get(k, 0) - base.get(k, 0), 6)
                     for k in self._DELTA_KEYS}
                self._delta_base[s.name] = {
                    k: snap.get(k, 0) for k in self._DELTA_KEYS}
                out[s.name] = d
        bn = self._bottleneck(out)
        if bn is not None:
            out["bottleneck_stage"] = bn
        lane = self._bottleneck_lane(out)
        if lane is not None:
            out["bottleneck_lane"] = lane
        from .. import monitor

        if monitor.enabled():
            reg = monitor.registry()
            for name, d in out.items():
                if not isinstance(d, dict):
                    continue
                reg.gauge("datapipe_stage_busy_ms",
                          help="stage busy time over the last step",
                          stage=name).set(round(d["busy_s"] * 1e3, 3))
                reg.gauge("datapipe_stage_bp_wait_ms",
                          help="stage backpressure wait over the last step",
                          stage=name).set(round(d["bp_wait_s"] * 1e3, 3))
        return out
