"""Health probing: the router's active view of every replica.

Each tick, every known replica gets a GET /healthz (and, while serving,
a GET /stats) over a fresh connection. The answers drive the membership
state machine:

    connection refused            -> dead immediately (nothing listens —
                                     a SIGKILLed replica shows up here
                                     within one probe interval)
    timeout / reset / other error -> breaker failure; dead after K
                                     consecutive (a wedge is ambiguous,
                                     a refused connect is not)
    503 "draining"                -> lame_duck (finishing its backlog)
    503 warming/stopped           -> dead (alive but not serving)
    200 + stats                   -> healthy, or degraded when the queue
                                     is deep, p99 exceeds the objective,
                                     or post-warmup compiles appeared

The prober also expires heartbeat TTLs and, when a `discover` source is
wired (a callable returning {name: endpoint}; the JAX package's elastic
master registry comes with ROADMAP queue 1 item 8), folds newly
registered replicas into membership — so a fleet can grow without
touching the router.

`tick()` is public and synchronous: tests drive the state machine
deterministically with an injected `fetch` instead of sleeping through
probe intervals.

A port of the JAX package's paddle_tpu/serve/fleet/health.py.
"""

import http.client
import json
import threading

from ... import monitor
from .membership import DEAD, DEGRADED, HEALTHY, LAME_DUCK

__all__ = ["HealthProber", "http_fetch"]


def http_fetch(endpoint, timeout=2.0):
    """Probe one replica: -> (healthz_state, stats_or_None). healthz
    body text is the state ("ok", "draining", "warming", "stopped");
    raises OSError family on transport failure. Fresh connections on
    purpose: a probe must measure connectability, and a draining replica
    answers with Connection: close anyway."""
    host, port = endpoint.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        state = resp.read().decode("utf-8", "replace").strip() or "unknown"
        if resp.status == 200:
            state = "ok"
    finally:
        conn.close()
    stats = None
    if state == "ok":
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            conn.request("GET", "/stats")
            resp = conn.getresponse()
            if resp.status == 200:
                stats = json.loads(resp.read().decode("utf-8"))
        finally:
            conn.close()
    return state, stats


class HealthProber:
    def __init__(self, membership, interval_s=0.5, fetch=None,
                 discover=None, degraded_queue_rows=None,
                 degraded_p99_ms=None):
        self.membership = membership
        self.interval_s = float(interval_s)
        self.fetch = fetch if fetch is not None else http_fetch
        self.discover = discover  # () -> {name: endpoint} or None
        self.degraded_queue_rows = degraded_queue_rows
        self.degraded_p99_ms = degraded_p99_ms
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-prober", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=10.0)
        self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the prober must not die
                pass
            self._stop.wait(self.interval_s)

    # -- one probing round ----------------------------------------------
    def tick(self):
        ms = self.membership
        if self.discover is not None:
            try:
                for name, endpoint in (self.discover() or {}).items():
                    ms.heartbeat(name, endpoint)
            except Exception:  # noqa: BLE001 — discovery is best-effort
                pass
        ms.expire()
        for rep in ms.replicas():
            self._probe(rep)
        monitor.registry().counter(
            "fleet_probe_rounds_total",
            help="health-probe sweeps over the fleet").inc()

    def _probe(self, rep):
        ms = self.membership
        try:
            state, stats = self.fetch(rep.endpoint)
        except ConnectionRefusedError as e:
            # unambiguous: nothing is listening. One probe interval is
            # all it takes for a SIGKILLed replica to leave the fleet.
            rep.breaker.record_failure()
            if rep.state != DEAD:
                ms.set_state(rep, DEAD, error=e)
            rep.last_probe = None
            return
        except Exception as e:  # noqa: BLE001 — timeout/reset/URL errors
            rep.breaker.record_failure()
            if rep.breaker.consecutive_failures \
                    >= rep.breaker.failure_threshold \
                    and rep.state != DEAD:
                ms.set_state(rep, DEAD, error=e)
            rep.last_probe = None
            return
        rep.last_probe = (state, stats)
        if state == "draining":
            if rep.state != LAME_DUCK:
                ms.set_state(rep, LAME_DUCK)
            return
        if state != "ok":
            # responsive but not serving (warming / stopped)
            if rep.state != DEAD:
                ms.set_state(rep, DEAD, error=f"healthz: {state}")
            return
        rep.breaker.record_success()
        if stats:
            rep.stats = stats
        want = HEALTHY
        if rep.state == LAME_DUCK:
            # a drain is router-initiated; a passing probe does not
            # un-drain a replica
            return
        if stats and self._degraded(rep, stats):
            want = DEGRADED
        if rep.state != want:
            ms.set_state(rep, want)

    def _degraded(self, rep, stats):
        try:
            if self.degraded_queue_rows is not None and \
                    float(stats.get("queue_rows") or 0) \
                    >= self.degraded_queue_rows:
                return True
            if self.degraded_p99_ms is not None:
                p99 = stats.get("p99_ms")
                if p99 is not None and float(p99) == float(p99) \
                        and float(p99) > self.degraded_p99_ms:
                    return True
            # multi-model replicas advertise per-model SLOs: a replica
            # blowing ONE hosted model's SLO by 2x is degraded even when
            # its aggregate p99 (diluted by the other models) looks fine
            for mst in (stats.get("models") or {}).values():
                mp99, slo = mst.get("p99_ms"), mst.get("slo_ms")
                if mp99 is not None and slo and \
                        float(mp99) == float(mp99) and \
                        float(mp99) > 2.0 * float(slo):
                    return True
            compiles = float(stats.get("steady_state_compiles") or 0)
        except (TypeError, ValueError):
            return False
        # "recompiling" means the count is RISING. steady_state_compiles
        # is cumulative (it never decreases), so treating any nonzero
        # value as degraded would pin a replica degraded forever after
        # its first post-warmup compile; compare against the previous
        # probe instead, and recover within one round of it going flat.
        prev = rep.compiles_seen
        rep.compiles_seen = compiles
        if prev is None:
            return compiles > 0
        return compiles > prev
