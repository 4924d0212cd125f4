"""Clock-aligned merge of per-process observability artifacts.

Every process in a fleet keeps its own step journal (monitor/journal.py),
health ledger and flight-recorder rings; this module merges them into ONE
global view:

  merge_step_timeline   per-process step journals -> a global step
                        timeline with per-step cross-replica skew and
                        straggler attribution (slowest replica per step,
                        consecutive-straggler detection — the signal the
                        collector publishes as fleet_straggler{replica=})
  merge_chrome_traces   flight-recorder dumps -> one chrome trace with a
                        DISTINCT pid lane per process (the manifest's
                        real pid), all lanes re-anchored onto one global
                        epoch timeline via each manifest's
                        perf_counter<->epoch clock anchor
  overlap_efficiency    a static schedule's costs (analytic
                        compute/comm split) joined with a MEASURED step
                        time -> fraction of collective time hidden under
                        compute (the overlap metric of arXiv 2004.13336);
                        the serving interop runner reads it too
                        (serve/continuous/interop.py)

Clock model: journal `ts` stamps are each process's own time.time();
hosts skew. A push payload samples {perf_counter, epoch} at send time and
the collector samples its own epoch at receive time, so
clock_offset(clock, ref_epoch) maps a process's epoch stamps onto the
collector's clock (network delay is the residual error — milliseconds,
versus the seconds NTP-less hosts drift). Span t0/t1 are perf_counter
seconds; epoch_of() converts them through the same anchor.

The JAX package's paddle_tpu/obs/timeline.py.
"""

from ..trace.export import chrome_events

__all__ = ["epoch_of", "clock_offset", "hist_quantile",
           "merge_step_timeline", "merge_chrome_traces",
           "overlap_efficiency", "format_timeline"]


def epoch_of(t, clock):
    """perf_counter seconds -> epoch seconds through a {perf_counter,
    epoch} anchor sampled together (trace manifest / push payload)."""
    return float(t) - float(clock["perf_counter"]) + float(clock["epoch"])


def clock_offset(clock, ref_epoch):
    """Seconds to ADD to a process's epoch stamps to land them on the
    reference clock: the reference's epoch sample (collector receive
    time) minus the process's own epoch sample taken at the same instant
    (push time). None/missing anchor -> 0.0 (trust the local clock)."""
    if not clock or clock.get("epoch") is None:
        return 0.0
    return float(ref_epoch) - float(clock["epoch"])


def hist_quantile(hist, p):
    """Quantile estimate from a Histogram.snapshot() dict (cumulative
    `buckets` keyed by upper edge — float or "+Inf" — plus count/min/max).
    Works on JSON round-tripped snapshots (string keys). None when empty.
    Same linear-interpolation semantics as registry.Histogram.percentiles,
    kept separate because the collector only ever holds snapshots."""
    if not hist:
        return None
    count = int(hist.get("count") or 0)
    if count <= 0:
        return None
    edges = []
    for k, v in (hist.get("buckets") or {}).items():
        le = float("inf") if str(k) in ("+Inf", "inf") else float(k)
        edges.append((le, int(v)))
    if not edges:
        return None
    edges.sort()
    mn, mx = hist.get("min"), hist.get("max")
    rank = float(p) / 100.0 * count
    prev_le, prev_c = None, 0
    for le, c in edges:
        if c > prev_c and c >= rank:
            lo = prev_le if prev_le is not None else \
                (mn if mn is not None else 0.0)
            hi = le
            if le == float("inf"):
                hi = mx if mx is not None else (prev_le or 0.0)
            frac = (rank - prev_c) / (c - prev_c)
            v = lo + frac * (hi - lo)
            if mn is not None:
                v = max(v, float(mn))
            if mx is not None:
                v = min(v, float(mx))
            return v
        prev_le, prev_c = le, c
    return float(mx) if mx is not None else None


def merge_step_timeline(processes, straggler_ratio=1.2,
                        straggler_steps=3):
    """Merge per-process step journals into one global timeline.

    processes: [{"name": str, "journal": [step records], and optionally
    "offset_s": float (clock_offset output) or "clock" + "ref_epoch"}].
    Journals align on the per-process step INDEX (each process counts its
    own steps; in data-parallel fleets step N is the same global batch).

    Returns {
      "events":    every step record as {"t" (corrected epoch), "name",
                   "step", "total_ms"} sorted by corrected time — the
                   monotonic global timeline,
      "steps":     [{"step", "replicas": {name: total_ms}, "skew_ms"
                   (max-min), "max_over_median", "slowest"}] for steps
                   covered by >= 2 processes,
      "stragglers": {name: longest consecutive-slowest run length} for
                   processes that were the slowest replica on >=
                   `straggler_steps` CONSECUTIVE multi-replica steps
                   while exceeding `straggler_ratio` x the step median,
      "per_process": {name: {"steps", "first_step", "last_step",
                   "mean_ms"}},
    }
    """
    events = []
    by_step = {}
    per_process = {}
    for proc in processes:
        name = proc["name"]
        offset = proc.get("offset_s")
        if offset is None:
            offset = clock_offset(proc.get("clock"),
                                  proc.get("ref_epoch", 0.0)) \
                if proc.get("clock") and proc.get("ref_epoch") is not None \
                else 0.0
        totals = []
        steps_seen = []
        for rec in proc.get("journal") or []:
            step = rec.get("step")
            total = rec.get("total_ms")
            if step is None or total is None:
                continue
            step, total = int(step), float(total)
            ts = rec.get("ts")
            t = (float(ts) + offset) if ts is not None else None
            events.append({"t": t, "name": name, "step": step,
                           "total_ms": total})
            # a step replayed after a rollback/restore overwrites its
            # earlier attempt: the LAST record for (process, step) wins
            by_step.setdefault(step, {})[name] = total
            totals.append(total)
            steps_seen.append(step)
        if steps_seen:
            per_process[name] = {
                "steps": len(steps_seen),
                "first_step": min(steps_seen),
                "last_step": max(steps_seen),
                "mean_ms": sum(totals) / len(totals),
            }
    events.sort(key=lambda e: (e["t"] if e["t"] is not None else 0.0,
                               e["step"], e["name"]))
    steps = []
    runs = {}        # name -> current consecutive-slowest run
    longest = {}     # name -> longest qualifying run
    for step in sorted(by_step):
        reps = by_step[step]
        if len(reps) < 2:
            continue
        vals = sorted(reps.values())
        n = len(vals)
        # same median semantics as monitor/skew.replica_skew: average
        # the middle pair for even n (a 2-replica fleet must not use
        # the slow replica itself as the baseline)
        median = vals[n // 2] if n % 2 == 1 \
            else 0.5 * (vals[n // 2 - 1] + vals[n // 2])
        slowest = max(reps, key=lambda n: reps[n])
        ratio = (reps[slowest] / median) if median > 0 else None
        steps.append({
            "step": step,
            "replicas": dict(reps),
            "skew_ms": vals[-1] - vals[0],
            "max_over_median": ratio,
            "slowest": slowest,
        })
        qualifying = ratio is not None and ratio >= straggler_ratio
        for name in runs:
            if name != slowest or not qualifying:
                runs[name] = 0
        if qualifying:
            runs[slowest] = runs.get(slowest, 0) + 1
            if runs[slowest] >= straggler_steps:
                longest[slowest] = max(longest.get(slowest, 0),
                                       runs[slowest])
        else:
            runs[slowest] = 0
    return {"events": events, "steps": steps, "stragglers": longest,
            "per_process": per_process}


def merge_chrome_traces(dumps, names=None):
    """Flight-recorder dumps -> ONE chrome trace dict with a distinct pid
    lane per process.

    dumps: [{"manifest": dict, "spans": [span dicts]}] (trace.load_dump
    output). Each lane's pid is the dumping process's REAL pid from its
    manifest (stable per process — the per-dump exporter reuses pid 1 for
    every process, so naive concatenation collides every fleet member
    into one lane). Lanes are re-anchored onto one global epoch timeline
    through each manifest's {perf_counter, epoch} clock anchor; a dump
    without an anchor falls back to its own earliest span as origin
    (lane renders, alignment degrades to per-process relative time).

    names: optional [str] per dump for the lane's process_name metadata
    (defaults to "<role?> pid <pid>").
    """
    per = []
    origin_epoch = None
    for i, d in enumerate(dumps):
        man = d.get("manifest") or {}
        spans = d.get("spans") or []
        clock = man.get("clock") or {}
        pid = man.get("pid")
        if pid is None:
            pid = 1000 + i  # manifest predates the pid field: synthetic
        anchored = clock.get("perf_counter") is not None \
            and clock.get("epoch") is not None
        t_min = min((s["t0"] for s in spans), default=None)
        e_min = epoch_of(t_min, clock) \
            if anchored and t_min is not None else None
        if e_min is not None:
            origin_epoch = e_min if origin_epoch is None \
                else min(origin_epoch, e_min)
        per.append((int(pid), spans, clock if anchored else None, t_min))
    events = []
    seen_pids = set()
    for i, (pid, spans, clock, t_min) in enumerate(per):
        while pid in seen_pids:   # same-pid collision (recycled pids)
            pid += 100000
        seen_pids.add(pid)
        if not spans:
            continue
        if clock is not None and origin_epoch is not None:
            # the perf_counter value IN THIS PROCESS at the global origin
            t0 = origin_epoch - float(clock["epoch"]) \
                + float(clock["perf_counter"])
        else:
            t0 = t_min
        name = (names[i] if names and i < len(names) and names[i]
                else f"pid {pid}")
        events.extend(chrome_events(spans, t0=t0, pid=pid,
                                    process_name=name))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def overlap_efficiency(compute_ms, comm_ms, measured_step_ms):
    """Fraction of collective time hidden under compute, in [0, 1].

    Joins the static schedule's analytic split (analysis/schedule.py:
    serial = compute + comm) with a MEASURED step wall time: whatever the
    measured step took beyond the analytic compute is exposed (serialized)
    comm, so hidden = comm - exposed. 1.0 = the step ran at the compute
    cost (perfect overlap), 0.0 = fully serialized (measured >= compute +
    comm). None when the analytic comm share is zero/absent — there is
    nothing to hide."""
    if not comm_ms or comm_ms <= 0 or measured_step_ms is None \
            or compute_ms is None:
        return None
    exposed = max(0.0, float(measured_step_ms) - float(compute_ms))
    return max(0.0, min(1.0, (float(comm_ms) - exposed) / float(comm_ms)))


def format_timeline(merged, top=8):
    """Human rendering of merge_step_timeline output."""
    lines = []
    pp = merged["per_process"]
    lines.append(f"processes: {len(pp)}  multi-replica steps: "
                 f"{len(merged['steps'])}")
    for name in sorted(pp):
        st = pp[name]
        lines.append(
            f"  {name:<20} steps {st['first_step']}..{st['last_step']} "
            f"({st['steps']})  mean {st['mean_ms']:.3f} ms")
    if merged["steps"]:
        worst = sorted(merged["steps"], key=lambda s: -s["skew_ms"])[:top]
        lines.append(f"  {'step':>6} {'skew_ms':>10} {'max/med':>8} "
                     f"slowest")
        for s in worst:
            ratio = s["max_over_median"]
            lines.append(
                f"  {s['step']:>6} {s['skew_ms']:>10.3f} "
                f"{ratio if ratio is None else round(ratio, 3)!s:>8} "
                f"{s['slowest']}")
    if merged["stragglers"]:
        lines.append("  stragglers: " + ", ".join(
            f"{n} (x{k} consecutive)"
            for n, k in sorted(merged["stragglers"].items())))
    return "\n".join(lines)
