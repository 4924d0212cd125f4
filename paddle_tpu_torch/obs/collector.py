"""Fleet observability collector: the cross-process metrics/trace/health
sink.

Every process in a job — Trainer loops, serve fleet replicas, the fleet
router, the elastic master — either PUSHES periodic snapshots here
(client.py, `POST /v1/obs/push`) or is SCRAPED (polling an existing
`GET /metrics` exposition). The collector keys each process on its
(job, role, replica, pid) labels and keeps, per process:

    metrics      the latest registry export (name/kind/help/labels/value)
    journal      a capped tail of step-journal records
    health       a capped tail of health-ledger records
    trace_dumps  flight-recorder dump manifests (dir + manifest), each
                 carrying the process's perf_counter<->epoch clock anchor
    clock        the push-time {perf_counter, epoch} sample; joined with
                 the collector's receive time it yields the per-process
                 clock offset every timeline merge uses

Aggregation semantics (GET /metrics):
  * every pushed series re-emitted with {job, role, replica} identity
    labels merged in (the per-replica view a dashboard slices on), and
  * one aggregate series per (name, original labels) WITHOUT identity
    labels: counters SUM across processes, gauges take the MAX, and
    histograms merge bucket-wise (cumulative counts add) — so fleet p99
    comes from one merged histogram, not an average of averages.
  * `# HELP`/`# TYPE` comment lines per family, carried through from the
    source registries' descriptions.

Stale-process expiry uses the membership TTL idiom (serve/fleet,
parallel/master): a process silent past FLAGS_obs_ttl_s leaves the
aggregate (and is counted in obs_expired_total) but stays visible as
expired in the summary; a new push under the same key revives it.

Fleet-derived gauges the collector itself maintains:
  fleet_straggler{replica=}      1 while the replica is the slowest on
                                 consecutive multi-replica steps (see
                                 timeline.merge_step_timeline)
  fleet_step_skew_ms             max-min step time at the latest
                                 multi-replica step
  fleet_overlap_efficiency{replica=}
                                 comm hidden under compute: the overlap
                                 schedule's analytic compute/comm gauges
                                 (where a process publishes them)
                                 joined with the measured step median
  obs_pushes_total / obs_scrapes_total / obs_dropped_snapshots_total /
  obs_expired_total / obs_processes

Zero-drop accounting: push payloads carry a per-process `seq`; a gap
between consecutive sequence numbers counts the missing snapshots into
obs_dropped_snapshots_total, which a lossless run keeps at 0.

The JAX package's paddle_tpu/obs/collector.py; a port process and a JAX
process push the same payloads, so one collector serves both.
"""

import json
import re
import threading
import time

from .. import flags
from ..monitor.registry import MetricsRegistry, _escape_label_value, \
    _NAME_RE
from . import timeline as tl

__all__ = ["Collector", "ProcessEntry", "parse_exposition",
           "merge_hists", "make_obs_http", "serve_obs"]

flags.define(
    "obs_ttl_s", float, 15.0,
    "Fleet collector stale-process expiry: a pushed/scraped process "
    "silent past this many seconds leaves the aggregated exposition "
    "(same TTL idiom as fleet membership). It stays listed as expired "
    "in the summary and revives on its next push.")

_IDENTITY_KEYS = ("job", "role", "replica")


class ProcessEntry:
    """One process's latest snapshot + capped artifact tails."""

    __slots__ = ("key", "labels", "via", "clock", "offset_s", "metrics",
                 "journal", "health", "trace_dumps", "last_seen",
                 "last_ts", "seq", "dropped", "pushes",
                 "_prev_steps", "_prev_seen", "step_rate")

    def __init__(self, key, labels, via="push"):
        self.key = key
        self.labels = dict(labels)
        self.via = via
        self.clock = None
        self.offset_s = 0.0
        self.metrics = []
        self.journal = []
        self.health = []
        self.trace_dumps = []       # [{"dir", "manifest"}], dedup by dir
        self.last_seen = time.monotonic()
        self.last_ts = time.time()
        self.seq = None
        self.dropped = 0
        self.pushes = 0
        self._prev_steps = None
        self._prev_seen = None
        self.step_rate = None

    # -- metric lookups over the latest export --------------------------
    def metric_values(self, name, kinds=("counter", "gauge")):
        return [m.get("value", 0.0) for m in self.metrics
                if m["name"] == name and m.get("kind") in kinds]

    def metric_sum(self, name, kinds=("counter", "gauge")):
        vals = self.metric_values(name, kinds)
        return sum(vals) if vals else None

    def metric_max(self, name, kinds=("gauge", "counter")):
        vals = self.metric_values(name, kinds)
        return max(vals) if vals else None

    def merged_hist(self, name):
        hists = [m["hist"] for m in self.metrics
                 if m["name"] == name and m.get("kind") == "histogram"]
        return merge_hists(hists) if hists else None

    def _note_steps(self):
        """Update the steps/sec estimate from successive snapshots."""
        steps = self.metric_sum("steps_total", kinds=("counter",))
        now = time.monotonic()
        if steps is not None and self._prev_steps is not None \
                and now > self._prev_seen:
            dt = now - self._prev_seen
            self.step_rate = max(0.0, steps - self._prev_steps) / dt
        if steps is not None:
            self._prev_steps, self._prev_seen = steps, now


def merge_hists(hists):
    """Bucket-wise merge of Histogram.snapshot() dicts (cumulative counts
    add; min/max combine; sum/count add). Bucket edges are matched on
    their string form — registries share code, so fleet members emit the
    same edges; an edge missing from one process is dropped from the
    merge (cumulative counts cannot be interpolated safely)."""
    out = {"count": 0, "sum": 0.0, "min": None, "max": None, "buckets": {}}
    keysets = []
    for h in hists:
        if not h:
            continue
        out["count"] += int(h.get("count") or 0)
        out["sum"] += float(h.get("sum") or 0.0)
        for edge in ("min", "max"):
            v = h.get(edge)
            if v is None:
                continue
            cur = out[edge]
            out[edge] = v if cur is None else \
                (min(cur, v) if edge == "min" else max(cur, v))
        buckets = {str(k): int(v) for k, v in (h.get("buckets") or {})
                   .items()}
        keysets.append(set(buckets))
        for k, v in buckets.items():
            out["buckets"][k] = out["buckets"].get(k, 0) + v
    if keysets:
        common = set.intersection(*keysets)
        out["buckets"] = {k: v for k, v in out["buckets"].items()
                          if k in common}
    return out


# -- Prometheus text parsing (scrape mode) ------------------------------
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')


def _unescape(v):
    return v.replace("\\n", "\n").replace('\\"', '"') \
        .replace("\\\\", "\\")


def parse_exposition(text):
    """Prometheus text exposition -> registry-export-style dicts
    ([{"name","kind","help","labels","value"|"hist"}]) — the scrape-mode
    inverse of MetricsRegistry.export(). Histogram families are
    reassembled from their _bucket/_sum/_count series (min/max are not
    recoverable from a scrape; hist_quantile tolerates their absence).
    Unparseable lines are skipped — a scrape must degrade, not raise."""
    kinds, helps = {}, {}
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) == 4:
                kinds[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                helps[parts[2]] = parts[3] if len(parts) == 4 else ""
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labelstr, value = m.groups()
        try:
            value = float(value)
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labelstr or "")}
        samples.append((name, labels, value))

    out = []
    hist_parts = {}   # (base, labelkey) -> {"buckets", "sum", "count"}
    for name, labels, value in samples:
        base, part = name, None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) \
                    and kinds.get(name[: -len(suffix)]) == "histogram":
                base, part = name[: -len(suffix)], suffix[1:]
                break
        if part is not None:
            lab = dict(labels)
            le = lab.pop("le", None)
            key = (base, tuple(sorted(lab.items())))
            h = hist_parts.setdefault(
                key, {"buckets": {}, "sum": 0.0, "count": 0,
                      "labels": lab})
            if part == "bucket" and le is not None:
                h["buckets"][le] = int(value)
            elif part == "sum":
                h["sum"] = value
            elif part == "count":
                h["count"] = int(value)
            continue
        out.append({"name": name, "kind": kinds.get(name, "gauge"),
                    "help": helps.get(name, ""), "labels": labels,
                    "value": value})
    for (base, _), h in hist_parts.items():
        out.append({"name": base, "kind": "histogram",
                    "help": helps.get(base, ""), "labels": h["labels"],
                    "hist": {"count": h["count"], "sum": h["sum"],
                             "min": None, "max": None,
                             "buckets": h["buckets"]}})
    return out


def _fetch_metrics(endpoint, timeout_s=2.0):
    """GET http://endpoint/metrics -> exposition text (raises OSError)."""
    import http.client

    host, port = endpoint.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise OSError(f"scrape {endpoint}: HTTP {resp.status}")
        return body.decode("utf-8", "replace")
    finally:
        conn.close()


class Collector:
    """The in-process aggregation core; make_obs_http wraps it in the
    HTTP surface, tests drive it directly."""

    def __init__(self, ttl_s=None, straggler_ratio=1.2, straggler_steps=3,
                 journal_cap=4096, fetch=None):
        self.ttl_s = float(ttl_s if ttl_s is not None
                           else flags.get("obs_ttl_s"))
        self.straggler_ratio = float(straggler_ratio)
        self.straggler_steps = int(straggler_steps)
        self.journal_cap = int(journal_cap)
        self.registry = MetricsRegistry()   # collector-owned fleet gauges
        self._fetch = fetch if fetch is not None else _fetch_metrics
        self._lock = threading.Lock()
        self._procs = {}      # key -> ProcessEntry (live)
        self._expired = {}    # key -> ProcessEntry (TTL-lapsed)
        self._scrape_targets = []   # (name, endpoint, labels)

    # -- ingestion ------------------------------------------------------
    @staticmethod
    def _key_of(labels):
        return (str(labels.get("job", "")), str(labels.get("role", "")),
                str(labels.get("replica", "")),
                int(labels.get("pid", 0) or 0))

    def ingest(self, payload):
        """One push payload in; returns the ack dict. ValueError on a
        structurally bad payload (the HTTP layer maps it to 400)."""
        if not isinstance(payload, dict) \
                or not isinstance(payload.get("labels"), dict):
            raise ValueError('payload must be {"labels": {...}, ...}')
        labels = payload["labels"]
        key = self._key_of(labels)
        now_epoch = time.time()
        with self._lock:
            entry = self._procs.get(key) or self._expired.pop(key, None)
            if entry is None:
                entry = ProcessEntry(key, labels)
            self._procs[key] = entry
            entry.labels = dict(labels)
            entry.via = "push"
            entry.last_seen = time.monotonic()
            entry.last_ts = now_epoch
            seq = payload.get("seq")
            replay = False
            if seq is not None:
                seq = int(seq)
                if entry.seq is not None:
                    if seq > entry.seq + 1:
                        gap = seq - entry.seq - 1
                        entry.dropped += gap
                        self.registry.counter(
                            "obs_dropped_snapshots_total",
                            help="push snapshots lost between a "
                                 "client's consecutive sequence "
                                 "numbers").inc(gap)
                    # a client retries a failed push under the SAME seq;
                    # if the first attempt actually landed (lost ack),
                    # appending its tails again would duplicate samples
                    replay = seq <= entry.seq
                entry.seq = max(entry.seq or 0, seq)
            clock = payload.get("clock")
            if isinstance(clock, dict):
                entry.clock = clock
                entry.offset_s = tl.clock_offset(clock, now_epoch)
            if isinstance(payload.get("metrics"), list):
                entry.metrics = payload["metrics"]
                entry._note_steps()
            for field, cap in (("journal", self.journal_cap),
                               ("health", self.journal_cap)):
                tail = payload.get(field)
                if isinstance(tail, list) and tail and not replay:
                    store = getattr(entry, field)
                    store.extend(r for r in tail if isinstance(r, dict))
                    del store[: max(0, len(store) - cap)]
            for d in payload.get("trace_dumps") or []:
                if isinstance(d, dict) and d.get("dir") \
                        and all(x.get("dir") != d["dir"]
                                for x in entry.trace_dumps):
                    entry.trace_dumps.append(
                        {"dir": str(d["dir"]),
                         "manifest": d.get("manifest")})
            entry.pushes += 1
        self.registry.counter(
            "obs_pushes_total",
            help="push snapshots accepted by the collector").inc()
        return {"ok": True, "seq": entry.seq}

    # -- scrape mode ----------------------------------------------------
    def add_scrape_target(self, name, endpoint, labels=None):
        """Poll an existing GET /metrics exposition (serve replica,
        router, any Prometheus endpoint) as a fleet member."""
        base = {"job": flags.get("obs_job") or "job", "role": "scrape",
                "replica": str(name), "pid": 0}
        base.update(labels or {})
        with self._lock:
            self._scrape_targets.append((str(name), str(endpoint), base))

    def scrape_tick(self):
        """One scrape sweep over every target; unreachable targets are
        skipped (TTL expiry handles persistent silence)."""
        with self._lock:
            targets = list(self._scrape_targets)
        ok = 0
        for name, endpoint, labels in targets:
            try:
                metrics = parse_exposition(self._fetch(endpoint))
            except (OSError, ValueError):
                continue
            key = self._key_of(labels)
            with self._lock:
                entry = self._procs.get(key) \
                    or self._expired.pop(key, None) \
                    or ProcessEntry(key, labels, via="scrape")
                self._procs[key] = entry
                entry.via = "scrape"
                entry.metrics = metrics
                entry.last_seen = time.monotonic()
                entry.last_ts = time.time()
                entry._note_steps()
            ok += 1
        if ok:
            self.registry.counter(
                "obs_scrapes_total",
                help="successful scrape sweeps over /metrics "
                     "targets").inc(ok)
        return ok

    # -- liveness -------------------------------------------------------
    def _expire_locked(self):
        now = time.monotonic()
        lapsed = [k for k, e in self._procs.items()
                  if now - e.last_seen > self.ttl_s]
        for k in lapsed:
            self._expired[k] = self._procs.pop(k)
            self.registry.counter(
                "obs_expired_total",
                help="processes dropped from the aggregate by the "
                     "FLAGS_obs_ttl_s stale-process expiry").inc()

    def processes(self):
        """Live (non-expired) entries, expiring stale ones first."""
        with self._lock:
            self._expire_locked()
            return list(self._procs.values())

    # -- fleet-derived gauges + timeline --------------------------------
    def _merged_timeline(self, live):
        return tl.merge_step_timeline(
            [{"name": e.labels.get("replica") or str(e.key),
              "journal": e.journal, "offset_s": e.offset_s}
             for e in live if e.journal],
            straggler_ratio=self.straggler_ratio,
            straggler_steps=self.straggler_steps)

    def _refresh(self):
        """Recompute skew/straggler/overlap gauges from the live set."""
        live = self.processes()
        self.registry.gauge(
            "obs_processes",
            help="live (non-expired) processes in the aggregate").set(
            len(live))
        merged = self._merged_timeline(live)
        if merged["steps"]:
            last = merged["steps"][-1]
            self.registry.gauge(
                "fleet_step_skew_ms",
                help="max-min per-replica step time at the latest "
                     "multi-replica step").set(last["skew_ms"])
            if last["max_over_median"] is not None:
                self.registry.gauge(
                    "fleet_step_skew_max_over_median",
                    help="straggler signal at the latest multi-replica "
                         "step").set(last["max_over_median"])
        stragglers = merged["stragglers"]
        for e in live:
            rep = e.labels.get("replica") or str(e.key)
            self.registry.gauge(
                "fleet_straggler",
                help="1 while this replica is the slowest on >= the "
                     "configured consecutive multi-replica steps",
                replica=rep).set(1.0 if rep in stragglers else 0.0)
            eff = tl.overlap_efficiency(
                e.metric_max("dataflow_compute_ms"),
                e.metric_max("dataflow_comm_ms"),
                tl.hist_quantile(e.merged_hist("step_ms"), 50))
            if eff is not None:
                self.registry.gauge(
                    "fleet_overlap_efficiency",
                    help="fraction of analytic collective time hidden "
                         "under compute (schedule costs joined with the "
                         "measured step median)",
                    replica=rep).set(eff)
        return live, merged

    def timeline(self):
        """Merged step timeline + the fleet's known trace-dump dirs."""
        live, merged = self._refresh()
        dumps = []
        for e in live:
            rep = e.labels.get("replica") or str(e.key)
            for d in e.trace_dumps:
                dumps.append({"replica": rep, "dir": d["dir"]})
        return {"timeline": merged, "dumps": dumps}

    # -- rendering ------------------------------------------------------
    def exposition(self):
        """Aggregated Prometheus text exposition (see module docstring
        for the per-replica + sum/max/histogram-merge semantics)."""
        live, _ = self._refresh()
        fams = {}
        for e in live:
            ident = {k: str(e.labels.get(k, "")) for k in _IDENTITY_KEYS}
            for m in e.metrics:
                name, kind = m.get("name"), m.get("kind")
                if not name or kind not in ("counter", "gauge",
                                            "histogram"):
                    continue
                fam = fams.setdefault(
                    name, {"kind": kind, "help": m.get("help") or "",
                           "rows": [], "agg": {}})
                if fam["kind"] != kind:
                    continue   # kind clash across processes: first wins
                if not fam["help"] and m.get("help"):
                    fam["help"] = m["help"]
                labels = {k: str(v)
                          for k, v in (m.get("labels") or {}).items()}
                row_labels = dict(labels)
                row_labels.update(ident)
                aggkey = tuple(sorted(labels.items()))
                if kind == "histogram":
                    fam["rows"].append((row_labels, m.get("hist")))
                    fam["agg"].setdefault(aggkey, []).append(
                        m.get("hist"))
                else:
                    v = float(m.get("value") or 0.0)
                    fam["rows"].append((row_labels, v))
                    agg = fam["agg"]
                    if kind == "counter":
                        agg[aggkey] = agg.get(aggkey, 0.0) + v
                    else:
                        agg[aggkey] = max(agg.get(aggkey, v), v)

        lines = []
        for name in sorted(fams):
            fam = fams[name]
            pname = _NAME_RE.sub("_", name)
            if fam["help"]:
                lines.append(f"# HELP {pname} {fam['help']}")
            lines.append(f"# TYPE {pname} {fam['kind']}")
            if fam["kind"] == "histogram":
                for labels, hist in fam["rows"]:
                    self._hist_lines(lines, pname, labels, hist)
                for aggkey, hists in sorted(fam["agg"].items()):
                    self._hist_lines(lines, pname, dict(aggkey),
                                     merge_hists(hists))
            else:
                for labels, v in fam["rows"]:
                    lines.append(f"{pname}{_label_suffix(labels)} {v}")
                for aggkey, v in sorted(fam["agg"].items()):
                    lines.append(
                        f"{pname}{_label_suffix(dict(aggkey))} {v}")
        own = self.registry.exposition()
        return own + "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def _hist_lines(lines, pname, labels, hist):
        if not hist:
            return
        base = _label_suffix(labels, trailing_comma=True)
        for le, n in sorted(
                ((float("inf") if str(k) in ("+Inf", "inf") else float(k),
                  v) for k, v in (hist.get("buckets") or {}).items())):
            le_s = "+Inf" if le == float("inf") else le
            lines.append(f'{pname}_bucket{base[:-1]},le="{le_s}"}} {n}'
                         if base else f'{pname}_bucket{{le="{le_s}"}} {n}')
        suffix = _label_suffix(labels)
        lines.append(f"{pname}_sum{suffix} {hist.get('sum', 0.0)}")
        lines.append(f"{pname}_count{suffix} {hist.get('count', 0)}")

    def summary(self):
        """The JSON view `obs top` renders: per-process vitals + fleet
        rollup."""
        live, merged = self._refresh()
        snap = self.registry.snapshot()
        procs = []
        for e in sorted(live, key=lambda e: (
                e.labels.get("role", ""), e.labels.get("replica", ""))):
            rep = e.labels.get("replica") or str(e.key)
            step_hist = e.merged_hist("step_ms")
            req_hist = e.merged_hist("serve_request_ms") \
                or e.merged_hist("fleet_request_ms")
            hits = e.metric_sum("compile_cache_hits_total",
                                kinds=("counter",))
            misses = e.metric_sum("compile_cache_misses_total",
                                  kinds=("counter",))
            lookups = (hits or 0.0) + (misses or 0.0)
            hbm = None
            for g in ("hbm_live_bytes_per_replica",
                      "analysis_peak_hbm_bytes_per_replica"):
                hbm = e.metric_max(g, kinds=("gauge",))
                if hbm is not None:
                    break
            procs.append({
                "labels": dict(e.labels),
                "via": e.via,
                "age_s": round(time.monotonic() - e.last_seen, 3),
                "seq": e.seq,
                "dropped": e.dropped,
                "steps_total": e.metric_sum("steps_total",
                                            kinds=("counter",)),
                "step_rate": e.step_rate,
                "p50_ms": tl.hist_quantile(step_hist or req_hist, 50),
                "p99_ms": tl.hist_quantile(step_hist or req_hist, 99),
                "queue_rows": e.metric_max("serve_queue_rows",
                                           kinds=("gauge",)),
                "hbm_bytes": hbm,
                "cache_hit_ratio": ((hits or 0.0) / lookups)
                                   if lookups else None,
                "health_events": e.metric_sum("health_events_total",
                                              kinds=("counter",)),
                "journal_steps": len(e.journal),
                "straggler": rep in merged["stragglers"],
            })
        with self._lock:
            expired = [{"labels": dict(e.labels),
                        "age_s": round(time.monotonic() - e.last_seen, 3)}
                       for e in self._expired.values()]
        return {
            "ts": time.time(),
            "processes": procs,
            "expired": expired,
            "fleet": {
                "processes": len(procs),
                "expired": len(expired),
                "pushes": snap.get("obs_pushes_total", 0),
                "scrapes": snap.get("obs_scrapes_total", 0),
                "dropped_snapshots": snap.get(
                    "obs_dropped_snapshots_total", 0),
                "multi_replica_steps": len(merged["steps"]),
                "max_skew_ms": max((s["skew_ms"] for s in merged["steps"]),
                                   default=None),
                "stragglers": merged["stragglers"],
            },
        }


def _label_suffix(labels, trailing_comma=False):
    labels = {k: v for k, v in labels.items() if v != ""}
    if not labels:
        return ""
    inner = ",".join(
        f'{_NAME_RE.sub("_", k)}="{_escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + ("," if trailing_comma else "}")


# -- HTTP surface -------------------------------------------------------
def make_obs_http(collector, host="127.0.0.1", port=9200):
    """ThreadingHTTPServer over a Collector:
    POST /v1/obs/push, GET /metrics /v1/obs/summary /v1/obs/timeline
    /healthz. Caller owns serve_forever()/shutdown()."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code, body, content_type="application/json"):
            data = body if isinstance(body, bytes) \
                else body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, code, obj):
            self._reply(code, json.dumps(obj))

        def do_GET(self):
            col = self.server.collector
            if self.path == "/healthz":
                self._reply(200, "ok\n", content_type="text/plain")
            elif self.path == "/metrics":
                self._reply(200, col.exposition(),
                            content_type="text/plain; version=0.0.4")
            elif self.path == "/v1/obs/summary":
                self._json(200, col.summary())
            elif self.path == "/v1/obs/timeline":
                self._json(200, col.timeline())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            col = self.server.collector
            if self.path != "/v1/obs/push":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                ack = col.ingest(payload)
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, ack)

    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.collector = collector
    return httpd


def serve_obs(collector, host="127.0.0.1", port=9200,
              scrape_interval_s=2.0):
    """Blocking collector frontend: serve until KeyboardInterrupt,
    running the scrape sweep on a background cadence when targets are
    registered."""
    httpd = make_obs_http(collector, host, port)
    stop = threading.Event()

    def _scrape_loop():
        while not stop.wait(scrape_interval_s):
            collector.scrape_tick()

    scraper = None
    if collector._scrape_targets:
        collector.scrape_tick()
        scraper = threading.Thread(target=_scrape_loop, name="obs-scrape",
                                   daemon=True)
        scraper.start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
    return httpd
