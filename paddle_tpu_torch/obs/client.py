"""Obs push client: the in-process side of fleet collection.

A background thread samples, every FLAGS_obs_push_interval_s seconds:

  * the process-global metrics registry (monitor.registry().export()),
  * the NEW tail of the step journal (FLAGS_monitor_journal) and health
    ledger (FLAGS_health_ledger) since the previous push — byte-offset
    incremental reads that follow rotation (`<path>.1`) without losing
    the records written between the last read and the roll,
  * any flight-recorder dump directories that appeared since the last
    push (trace.last_dump()), shipped as {dir, manifest} so the
    collector can later merge the chrome traces on the manifests' clock
    anchors,

and POSTs them to the collector (`/v1/obs/push`) stamped with the
process identity labels {job, role, replica, pid, epoch} plus a fresh
{perf_counter, epoch} clock anchor and a monotone `seq` number (the
collector's zero-drop accounting).

Failure contract: observability must never take the workload down. Push
errors are counted (obs_push_failures_total) and retried on the next
tick; the thread is a daemon; stop() sends one final push (flushing the
remaining journal tail) with a short timeout and swallows its errors.

maybe_start(role) is the one-line wiring hook used by the Trainer /
resilience session, serve fleet replicas (`--obs`), the router and the
elastic master: a no-op returning None unless FLAGS_obs_push names a
collector endpoint.
"""

import json
import os
import threading
import time

from .. import flags
from .. import monitor

__all__ = ["ObsClient", "JsonlTail", "maybe_start"]

flags.define(
    "obs_push", str, "",
    "Fleet collector endpoint (host:port) this process pushes "
    "observability snapshots to (POST /v1/obs/push). Empty = fleet "
    "collection off; obs.maybe_start() is then a no-op.")
flags.define(
    "obs_push_interval_s", float, 1.0,
    "Seconds between obs push snapshots (metrics export + journal/"
    "health tails + new trace-dump manifests).")
flags.define(
    "obs_job", str, "paddle",
    "`job` identity label stamped on obs push payloads — one collector "
    "can aggregate several jobs side by side.")
flags.define(
    "obs_role", str, "",
    "`role` identity label on obs pushes (trainer / replica / router / "
    "master). Empty = whatever role the wiring hook passes.")
flags.define(
    "obs_replica", str, "",
    "`replica` identity label on obs pushes. Empty = <role>-<pid>, "
    "which is unique but unstable across restarts; fleet CLIs pass "
    "their replica name.")


def _flag_or_empty(name):
    """flags.get tolerating a flag whose defining module (e.g.
    health.ledger) has not been imported by this process."""
    try:
        return flags.get(name)
    except KeyError:
        return ""


class JsonlTail:
    """Incremental byte-offset reader over a rotating JSONL file
    (monitor journal / health ledger idiom: writer rolls the file to
    `<path>.1` via os.replace when it outgrows the cap).

    read_new() returns only records appended since the previous call.
    Rotation is detected as the file shrinking below our offset; the
    remainder of the rolled segment (`.1`) is drained from the old
    offset before restarting at byte 0 of the fresh file — no sample is
    lost across a roll. Torn trailing lines (a writer mid-append, or a
    roll mid-line) are left for the next read on the live file and
    skipped with a count on the sealed one."""

    def __init__(self, path_fn):
        self._path_fn = path_fn if callable(path_fn) else (lambda: path_fn)
        self._offset = 0
        self.torn = 0

    def _parse(self, data, complete_only):
        recs, consumed = [], 0
        end = len(data)
        if complete_only:
            end = data.rfind("\n") + 1
        for line in data[:end].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                self.torn += 1
                continue
            if isinstance(rec, dict):
                recs.append(rec)
        consumed = end
        return recs, consumed

    def read_new(self):
        path = self._path_fn()
        if not path:
            return []
        recs = []
        try:
            size = os.path.getsize(path)
        except OSError:
            return []
        if size < self._offset:
            # the writer rolled: finish the sealed segment first
            try:
                with open(path + ".1", "r") as f:
                    f.seek(self._offset)
                    rolled, _ = self._parse(f.read(),
                                            complete_only=False)
                    recs.extend(rolled)
            except OSError:
                pass
            self._offset = 0
        try:
            with open(path, "r") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return recs
        fresh, consumed = self._parse(data, complete_only=True)
        recs.extend(fresh)
        self._offset += consumed
        return recs


class ObsClient:
    """Periodic push loop; one per process. start()/stop() or use as a
    context manager."""

    def __init__(self, endpoint=None, job=None, role=None, replica=None,
                 interval_s=None, timeout_s=2.0):
        self.endpoint = endpoint or flags.get("obs_push")
        if not self.endpoint:
            raise ValueError("ObsClient needs a collector endpoint "
                             "(FLAGS_obs_push or endpoint=)")
        role = role or flags.get("obs_role") or "proc"
        self.labels = {
            "job": job or flags.get("obs_job"),
            "role": role,
            "replica": (replica or flags.get("obs_replica")
                        or f"{role}-{os.getpid()}"),
            "pid": os.getpid(),
        }
        self.interval_s = float(interval_s if interval_s is not None
                                else flags.get("obs_push_interval_s"))
        self.timeout_s = float(timeout_s)
        self._journal = JsonlTail(lambda: _flag_or_empty("monitor_journal"))
        self._health = JsonlTail(lambda: _flag_or_empty("health_ledger"))
        self._seq = 0               # last ACKED sequence number
        self.failures = 0
        # tails consumed by a FAILED push are re-buffered here and ride
        # the next attempt — a transient collector outage must not lose
        # samples (capped so a long outage degrades, not OOMs)
        self._pend_journal = []
        self._pend_health = []
        self._pend_dumps = []
        self._pend_cap = 4096
        self._sent_dumps = set()
        self._stop = threading.Event()
        self._thread = None

    # -- payload --------------------------------------------------------
    def _new_trace_dumps(self):
        from .. import trace

        out = []
        last = trace.last_dump()
        if last and last not in self._sent_dumps:
            try:
                with open(os.path.join(last, "manifest.json")) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                return out
            self._sent_dumps.add(last)
            out.append({"dir": os.path.abspath(last),
                        "manifest": manifest})
        return out

    def build_payload(self):
        """Snapshot everything new since the last ACKED push. The seq is
        last_acked + 1: a failed attempt retries under the SAME number
        (the collector treats seq <= last-seen as a retransmit), so only
        genuinely missing snapshots count as dropped."""
        journal = self._pend_journal + self._journal.read_new()
        health = self._pend_health + self._health.read_new()
        dumps = self._pend_dumps + self._new_trace_dumps()
        self._pend_journal, self._pend_health, self._pend_dumps = \
            [], [], []
        labels = dict(self.labels)
        labels["epoch"] = time.time()
        return {
            "v": 1,
            "seq": self._seq + 1,
            "labels": labels,
            "clock": {"perf_counter": time.perf_counter(),
                      "epoch": time.time()},
            "metrics": monitor.registry().export(),
            "journal": journal,
            "health": health,
            "trace_dumps": dumps,
        }

    def push_once(self):
        """One snapshot -> collector. Returns True on a 200 ack; never
        raises (observability must not break the workload)."""
        import http.client

        payload = self.build_payload()
        try:
            host, port = self.endpoint.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port),
                                              timeout=self.timeout_s)
            try:
                conn.request(
                    "POST", "/v1/obs/push", json.dumps(payload),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                ok = resp.status == 200
            finally:
                conn.close()
        except (OSError, ValueError):
            ok = False
        if ok:
            self._seq = payload["seq"]
        else:
            self.failures += 1
            self._pend_journal = (payload["journal"]
                                  + self._pend_journal)[-self._pend_cap:]
            self._pend_health = (payload["health"]
                                 + self._pend_health)[-self._pend_cap:]
            self._pend_dumps = payload["trace_dumps"] + self._pend_dumps
            if monitor.enabled():
                monitor.registry().counter(
                    "obs_push_failures_total",
                    help="obs snapshots that failed to reach the "
                         "collector (retried next tick)").inc()
        return ok

    # -- lifecycle ------------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.push_once()

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-push", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_push=True):
        """Stop the loop; by default flush one final snapshot so the
        collector sees the terminal journal tail and last trace dump."""
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=self.timeout_s + self.interval_s)
        if final_push:
            self.push_once()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def maybe_start(role, replica=None, endpoint=None):
    """Start a push client when FLAGS_obs_push (or endpoint=) names a
    collector; returns the started ObsClient or None. Never raises —
    the workload must come up even with a bad obs config."""
    endpoint = endpoint or flags.get("obs_push")
    if not endpoint:
        return None
    try:
        return ObsClient(endpoint=endpoint, role=role,
                         replica=replica).start()
    except (ValueError, OSError):
        return None
