"""JSONL step journal: one line per executor step, durable observability.

The registry (registry.py) answers "what is happening now"; the journal
answers "what happened at step N" after the run is over — each step_end
appends one self-contained JSON object, so a crashed or remote run leaves
a parseable artifact. `python -m paddle_tpu_torch monitor <journal>`
(cli.py) renders the summary; read_journal/summarize_journal are the
library surface. A copy of the JAX package's paddle_tpu/monitor/journal.py:
the two packages write and read one schema, so either CLI renders either
package's journal with the same text.

Schema (one object per line; optional fields omitted when absent):
  ts            wall-clock seconds (time.time) at step end
  step          process-wide monotone step index
  kind          "executor" | "executor_eager" | "parallel_executor"
  iters         K of a multi-step scan dispatch (null for single step)
  total_ms      wall time of the whole run() call
  phases_ms     {"feed_encode": .., "compile": .., "dispatch": ..,
                 "fetch_readback": ..}  (phases that occurred this step;
                in the port "compile" is the prepare, the first eager step
                of a prepared program and the CUDA graph's capture,
                "dispatch" the replays' or the interpreter's enqueue time)
  cache         "hit" | "miss"  (the prepared-step cache's outcome)
  cache_level   "l1" | "l2" on hits ("l2": the prepared plan came from
                FLAGS_compile_cache_dir)
  cache_evictions    L1 entries evicted by FLAGS_compile_cache_cap
  cache_l2_fallback  reason string when a persistent entry was corrupt/
                     stale/undecodable and the step was prepared afresh
  fingerprint   8-hex id of the prepared-step key (joins compile_info)
  datapipe      per-stage delta stats when the step pulled from a DataPipe
  wire          {feed: wire-format repr} when a WireSpec rode the chunk
  replica_ms    per-rank completion times (ParallelExecutor, skew-flagged)
  replica_ids   ranks aligned with replica_ms
  skew          {"replicas", "max_ms", "median_ms", "max_over_median",
                 "slowest"}
  collective_bytes       {"all_reduce": B} or {"reduce_scatter": B,
                         "all_gather": B} — analytic per-step dp-collective
                         traffic (parallel_executor; ring model)
  optimizer_state_bytes  per-replica optimizer accumulator bytes
  zero1         true when the step ran the sharded weight update
"""

import json
import os
import threading

from .. import flags

__all__ = ["JournalWriter", "read_journal", "summarize_journal",
           "format_summary"]

flags.define("monitor_journal_max_mb", float, 0.0,
             "Size-gated journal rotation: when a JSONL journal (monitor "
             "step journal, health ledger) grows past this many MB it "
             "rolls over to <path>.1 (one rollover segment kept; "
             "read_journal transparently reads the pair). 0 = unbounded.")


def _default(o):
    """Journal records should never fail to serialize: numpy scalars and
    arrays degrade to python numbers/lists, anything else to repr."""
    try:
        import numpy as np

        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:
        pass
    return repr(o)


class JournalWriter:
    """Append-only JSONL writer, flushed per record (a crash loses at most
    the in-flight line)."""

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def write(self, record):
        line = json.dumps(record, default=_default)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()
            self._maybe_rotate()

    def _maybe_rotate(self):
        """Roll the journal over to <path>.1 once it outgrows
        FLAGS_monitor_journal_max_mb (caller holds the lock)."""
        max_mb = flags.get("monitor_journal_max_mb")
        if not max_mb or max_mb <= 0:
            return
        try:
            size = self._f.tell()
        except OSError:
            return
        if size <= max_mb * 1e6:
            return
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a")

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_journal(path):
    """Parse a JSONL journal -> list of step records (skips blank lines;
    a torn line — crash mid-write — is dropped with a warning, not
    fatal: the reader should know records went missing, silently eating
    them hid real data loss). When a rotation segment `<path>.1` exists
    (FLAGS_monitor_journal_max_mb rollover) it is read first, so the
    caller sees the pair as one chronological journal."""
    import warnings

    rolled = str(path) + ".1"
    paths = ([rolled] if os.path.exists(rolled) else []) + [str(path)]
    records = []
    for p in paths:
        with open(p) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError as e:
                    warnings.warn(
                        f"journal {p}: skipping unparseable line "
                        f"{lineno} ({e}) — truncated write?",
                        RuntimeWarning, stacklevel=2)
                    continue
    return records


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, max(0, int(round(
        q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def summarize_journal(records):
    """Aggregate step records -> summary dict (cli.py renders it)."""
    totals = sorted(float(r["total_ms"]) for r in records
                    if r.get("total_ms") is not None)
    phases = {}
    for r in records:
        for name, ms in (r.get("phases_ms") or {}).items():
            phases.setdefault(name, []).append(float(ms))
    cache = {"hit": 0, "miss": 0}
    hit_l2 = 0
    evictions = 0
    l2_fallbacks = 0
    for r in records:
        c = r.get("cache")
        if c in cache:
            cache[c] += 1
        if c == "hit" and r.get("cache_level") == "l2":
            hit_l2 += 1
        evictions += int(r.get("cache_evictions") or 0)
        if r.get("cache_l2_fallback"):
            l2_fallbacks += 1
    if hit_l2:
        cache["hit_l2"] = hit_l2
    skews = [r["skew"]["max_over_median"] for r in records
             if isinstance(r.get("skew"), dict)
             and r["skew"].get("max_over_median") is not None]
    slowest = {}
    for r in records:
        if isinstance(r.get("skew"), dict) and "slowest" in r["skew"]:
            s = r["skew"]["slowest"]
            slowest[s] = slowest.get(s, 0) + 1
    out = {
        "steps": len(records),
        "kinds": sorted({r.get("kind") for r in records if r.get("kind")}),
        "step_ms": {
            "mean": (sum(totals) / len(totals)) if totals else None,
            "p50": _percentile(totals, 50),
            "p95": _percentile(totals, 95),
            "max": totals[-1] if totals else None,
        },
        "phases_ms_mean": {
            n: sum(v) / len(v) for n, v in sorted(phases.items())
        },
        "cache": cache,
        "cache_evictions": evictions,
        "cache_l2_fallbacks": l2_fallbacks,
    }
    if skews:
        out["skew_max_over_median"] = {
            "mean": sum(skews) / len(skews),
            "max": max(skews),
        }
    if slowest:
        out["slowest_replica_counts"] = slowest
    # ZeRO-1 / collective accounting (parallel_executor extras): the last
    # record wins — layout is a per-run property, not a per-step average
    coll = [r for r in records
            if isinstance(r.get("collective_bytes"), dict)]
    if coll:
        last = coll[-1]
        out["collective_bytes_per_step"] = {
            k: int(v) for k, v in last["collective_bytes"].items()}
        if last.get("optimizer_state_bytes") is not None:
            out["optimizer_state_bytes_per_replica"] = int(
                last["optimizer_state_bytes"])
        if last.get("zero1") is not None:
            out["zero1"] = bool(last.get("zero1"))
    return out


def format_summary(summary):
    """Human-readable rendering of summarize_journal's dict."""
    lines = [f"steps: {summary['steps']}  "
             f"kinds: {', '.join(summary['kinds']) or '-'}"]
    sm = summary["step_ms"]
    if sm["mean"] is not None:
        lines.append(
            f"step_ms: mean={sm['mean']:.3f} p50={sm['p50']:.3f} "
            f"p95={sm['p95']:.3f} max={sm['max']:.3f}")
    if summary["phases_ms_mean"]:
        total = sum(summary["phases_ms_mean"].values()) or 1.0
        lines.append(f"{'phase':<16}{'mean_ms':>12}{'share':>8}")
        for n, v in sorted(summary["phases_ms_mean"].items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"{n:<16}{v:>12.3f}{v / total:>8.1%}")
    c = summary["cache"]
    line = f"compile cache: {c['hit']} hits / {c['miss']} misses"
    if c.get("hit_l2"):
        line += f" ({c['hit_l2']} persistent warm starts)"
    ev = summary.get("cache_evictions") or 0
    if ev:
        line += f", {ev} evictions"
    fb = summary.get("cache_l2_fallbacks") or 0
    if fb:
        line += f", {fb} L2 fallbacks"
    lines.append(line)
    if "skew_max_over_median" in summary:
        s = summary["skew_max_over_median"]
        lines.append(
            f"replica skew (max/median): mean={s['mean']:.3f} "
            f"max={s['max']:.3f}")
    if "slowest_replica_counts" in summary:
        top = sorted(summary["slowest_replica_counts"].items(),
                     key=lambda kv: -kv[1])
        lines.append("slowest replica: " + ", ".join(
            f"{r} x{n}" for r, n in top[:4]))
    if "collective_bytes_per_step" in summary:
        cb = summary["collective_bytes_per_step"]
        mode = "zero1" if summary.get("zero1") else "all-reduce"
        lines.append(
            f"dp collectives ({mode}): " + ", ".join(
                f"{op}={b / 1e6:.3f}MB" for op, b in sorted(cb.items())))
    if "optimizer_state_bytes_per_replica" in summary:
        lines.append(
            f"optimizer state per replica: "
            f"{summary['optimizer_state_bytes_per_replica'] / 1e6:.3f}MB")
    return "\n".join(lines)
