"""Metrics registry: counters, gauges, time histograms.

Reference contrast: reference Fluid's profiler.cc aggregates host events
only AFTER a profiling session ends (ParseEvents -> printed table).
Production training wants live, structured, scrapeable metrics: every hot
path reports into one process-global registry, which renders either as a
python snapshot dict, a Prometheus-style text exposition (for scraping),
or — for gauges — as counter samples in the profiler's host recorder
(profiler.record_counter). A copy of the JAX package's
paddle_tpu/monitor/registry.py.

All mutation is lock-protected per metric (hot paths report from executor
and datapipe worker threads concurrently); reads take a consistent
per-metric snapshot.
"""

import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_MS_BUCKETS"]

# time histograms default to millisecond buckets spanning sub-ms dispatch
# to multi-second compiles
DEFAULT_MS_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0, 2000.0, 5000.0, 15000.0, 60000.0,
                      float("inf"))

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _escape_label_value(v):
    """Prometheus text-format label-value escaping: backslash first, then
    double-quote and newline (exposition format spec)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _series_name(name, labels):
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class _Metric:
    __slots__ = ("name", "labels", "help", "_lock")

    def __init__(self, name, labels, help=""):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        self._lock = threading.Lock()

    @property
    def series(self):
        return _series_name(self.name, self.labels)


class Counter(_Metric):
    """Monotone event count (steps run, cache hits, bytes moved)."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, name, labels=None, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge(_Metric):
    """Last-value metric (current step ms, queue depth, compile wall time).

    Every set() also lands as a profiler counter sample, so when a
    profiling session is live the gauge renders as a "ph":"C" counter
    track in the merged chrome trace (no-op otherwise)."""

    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self, name, labels=None, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, v):
        v = float(v)
        with self._lock:
            self._value = v
        from .. import profiler

        profiler.record_counter(f"monitor/{self.series}", v)

    def add(self, dv):
        with self._lock:
            self._value += float(dv)
            v = self._value
        from .. import profiler

        profiler.record_counter(f"monitor/{self.series}", v)

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Histogram(_Metric):
    """Bucketed distribution (step / phase latencies in ms)."""

    kind = "histogram"
    __slots__ = ("buckets", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name, labels=None, help="", buckets=None):
        super().__init__(name, labels, help)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_MS_BUCKETS)))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self.buckets = bs
        self._counts = [0] * len(bs)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break

    def snapshot(self):
        with self._lock:
            cum, acc = [], 0
            for c in self._counts:
                acc += c
                cum.append(acc)
            return {
                "count": self._count,
                "sum": round(self._sum, 6),
                "min": self._min,
                "max": self._max,
                "avg": (self._sum / self._count) if self._count else None,
                "buckets": {("+Inf" if b == float("inf") else b): n
                            for b, n in zip(self.buckets, cum)},
            }

    def percentiles(self, *ps):
        """Estimate percentiles from the bucketed counts: {p: value}.

        Linear interpolation inside the bucket holding the target rank
        (Prometheus histogram_quantile semantics), with the observed
        min/max standing in for the open edges (the lower edge of the
        first occupied bucket, the upper edge of the +Inf bucket) and
        clamping the estimate — so a one-value histogram reports that
        value exactly instead of a bucket boundary. Empty histogram ->
        {p: NaN}: NaN propagates through arithmetic and formats as 'nan'
        instead of blowing up the first comparison the way None does."""
        for p in ps:
            if not 0.0 <= float(p) <= 100.0:
                raise ValueError(f"percentile {p} outside [0, 100]")
        with self._lock:
            count = self._count
            counts = list(self._counts)
            mn, mx = self._min, self._max
        if count == 0:
            return {p: float("nan") for p in ps}
        out = {}
        for p in ps:
            rank = float(p) / 100.0 * count
            acc = 0
            value = mx
            for i, c in enumerate(counts):
                acc += c
                if c == 0 or acc < rank:
                    continue
                lo = self.buckets[i - 1] if i > 0 else mn
                hi = mx if self.buckets[i] == float("inf") \
                    else self.buckets[i]
                frac = (rank - (acc - c)) / c
                value = lo + frac * (hi - lo)
                break
            out[p] = min(max(value, mn), mx)
        return out


class MetricsRegistry:
    """Get-or-create metric store keyed on (name, labels).

    registry.counter("steps_total", kind="executor").inc()
    registry.gauge("last_step_ms").set(12.5)
    registry.histogram("step_ms").observe(12.5)
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}  # (name, sorted label items) -> metric

    def _get(self, cls, name, help, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels=labels, help=help, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name, help="", **labels):
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", **labels):
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", buckets=None, **labels):
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self):
        """{series_name: value | histogram dict} for every metric."""
        return {m.series: m.snapshot() for m in self.metrics()}

    def export(self):
        """Structured series export for cross-process aggregation
        (the JAX package's obs push payloads): one dict per metric carrying
        the name, kind, HELP text and labels next to the value, so a remote
        collector can re-emit a faithful exposition — including the
        `# HELP`/`# TYPE` comment lines — without sharing this process's
        registry objects. Histograms export their full snapshot
        (cumulative buckets + count/sum/min/max), which merges across
        processes by bucket-wise addition."""
        out = []
        for m in self.metrics():
            d = {"name": m.name, "kind": m.kind, "help": m.help,
                 "labels": dict(m.labels)}
            if isinstance(m, Histogram):
                snap = m.snapshot()
                # JSON object keys are strings; normalize the bucket
                # edges now so local and round-tripped exports compare
                # equal at the collector
                snap["buckets"] = {str(k): v
                                   for k, v in snap["buckets"].items()}
                d["hist"] = snap
            else:
                d["value"] = m.snapshot()
            out.append(d)
        return out

    def reset(self):
        """Drop every registered metric (tests / fresh sessions)."""
        with self._lock:
            self._metrics.clear()

    def exposition(self):
        """Prometheus text exposition (one scrape page).

        Names are sanitized to the Prometheus charset; label VALUES are
        escaped per the text-format spec (backslash, double-quote and
        newline) — a fingerprint or path label containing any of those
        must not corrupt the scrape page. Histograms emit cumulative
        _bucket{le=...} series plus _sum/_count, counters get the
        conventional _total suffix left to the caller's naming."""
        by_name = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            fam = by_name[name]
            pname = _NAME_RE.sub("_", name)
            help_ = next((m.help for m in fam if m.help), "")
            if help_:
                lines.append(f"# HELP {pname} {help_}")
            lines.append(f"# TYPE {pname} {fam[0].kind}")
            for m in fam:
                items = sorted(m.labels.items())
                base = ",".join(
                    f'{_NAME_RE.sub("_", k)}="{_escape_label_value(v)}"'
                    for k, v in items)
                if isinstance(m, Histogram):
                    snap = m.snapshot()
                    for le, n in snap["buckets"].items():
                        lab = base + ("," if base else "") + f'le="{le}"'
                        lines.append(f"{pname}_bucket{{{lab}}} {n}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{pname}_sum{suffix} {snap['sum']}")
                    lines.append(f"{pname}_count{suffix} {snap['count']}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{pname}{suffix} {m.snapshot()}")
        return "\n".join(lines) + ("\n" if lines else "")
