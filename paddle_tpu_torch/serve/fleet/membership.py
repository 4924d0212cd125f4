"""Fleet membership: who the replicas are and whether to send them work.

Liveness rides the elastic master's `MembershipTable`
(parallel/master.py): ONE TTL'd, epoch-fenced membership primitive
serves both control planes — elastic trainers (parallel/elastic.py,
through the master's RPC ops) and the serving fleet.
The fleet carries no TTL arithmetic of its own: a heartbeat refreshes a
table lease, a lapse IS a leave (the table bumps its epoch and the next
beat must re-JOIN under a strictly newer one, so a zombie can never
resurrect an epoch the fleet already moved past), and `expire()` merely
translates reaped leases into replica state.

The router owns this state; replicas only report. Each replica carries:

  state      healthy    probes pass, load nominal      -> routable
             degraded   probes pass, but the queue is
                        deep / p99 over objective /
                        post-warmup compiles observed  -> routable last
             dead       probes fail, TTL expired, or
                        refused connections            -> not routable
             lame_duck  draining by request            -> not routable
  breaker    a per-replica circuit breaker: K consecutive request
             failures open it (requests stop even if a probe hasn't run
             yet); after a cooldown it half-opens and admits exactly ONE
             probe request — success recloses, failure reopens.

Membership is the single writer of the fleet gauges
(`fleet_healthy_replicas`, per-replica `fleet_replica_state`), so a
scrape of the router answers "how much capacity is live" without
touching any replica.

A port of the JAX package's paddle_tpu/serve/fleet/membership.py.
"""

import threading
import time

from ... import monitor
from ...parallel.master import MembershipTable

__all__ = ["HEALTHY", "DEGRADED", "DEAD", "LAME_DUCK", "CircuitBreaker",
           "Replica", "Membership", "STATE_VALUES"]

HEALTHY = "healthy"
DEGRADED = "degraded"
DEAD = "dead"
LAME_DUCK = "lame_duck"

# gauge encoding for fleet_replica_state{replica=...}
STATE_VALUES = {DEAD: 0, DEGRADED: 1, HEALTHY: 2, LAME_DUCK: 3}

_ROUTABLE = (HEALTHY, DEGRADED)


class CircuitBreaker:
    """closed -> (K consecutive failures) -> open -> (cooldown) ->
    half_open -> one probe -> closed | open.

    try_acquire() is the dispatch-time gate: always True while closed,
    False while open (until the cooldown elapses, when it transitions to
    half_open and hands out exactly one probe slot), False while a
    half-open probe is already in flight. The clock is injectable so
    tests step time instead of sleeping."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold=3, cooldown_s=2.0, clock=None):
        self.failure_threshold = int(failure_threshold)
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.cooldown_s = float(cooldown_s)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probing = False

    @property
    def state(self):
        with self._lock:
            if self._state == self.OPEN \
                    and self._clock() >= self._open_until:
                return self.HALF_OPEN  # would half-open on next acquire
            return self._state

    @property
    def consecutive_failures(self):
        with self._lock:
            return self._failures

    def try_acquire(self):
        """May a request be dispatched through this breaker right now?"""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() < self._open_until:
                    return False
                self._state = self.HALF_OPEN
                self._probing = True
                return True  # THE probe slot
            # half-open: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self):
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN \
                    or self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._open_until = self._clock() + self.cooldown_s
                self._probing = False


class Replica:
    """One backend Server's view from the router."""

    def __init__(self, name, endpoint, via_heartbeat=False, breaker=None):
        self.name = name
        self.endpoint = endpoint
        self.via_heartbeat = via_heartbeat
        self.state = DEAD  # unproven until the first probe/heartbeat
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.stats = {}
        self.last_heartbeat = None
        self.last_probe = None
        self.last_error = None
        # cumulative steady_state_compiles at the last probe: the prober
        # degrades on a RISING count, recovers when it goes flat
        self.compiles_seen = None

    @property
    def queue_rows(self):
        try:
            return float(self.stats.get("queue_rows") or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def __repr__(self):
        return (f"Replica({self.name!r}, {self.endpoint!r}, "
                f"state={self.state!r})")


class Membership:
    def __init__(self, heartbeat_ttl_s=10.0, breaker_failures=3,
                 breaker_cooldown_s=2.0, clock=None):
        self.heartbeat_ttl_s = float(heartbeat_ttl_s)
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._replicas = {}  # name -> Replica
        # the SAME TTL'd, epoch-fenced table the elastic master serves
        # trainers with; Replica objects keep the serving-side
        # annotations (breaker, probe stats, routability state) the
        # trainer plane has no use for — liveness lives in the table.
        # All table calls run under self._lock (the table itself is
        # unsynchronized by contract).
        self.table = MembershipTable(clock=self._clock)

    @property
    def epoch(self):
        """Monotonic membership epoch: bumps on every join, leave, and
        TTL lapse (the elastic trainer plane's generation fence)."""
        with self._lock:
            return self.table.epoch

    def _make_breaker(self):
        return CircuitBreaker(failure_threshold=self.breaker_failures,
                              cooldown_s=self.breaker_cooldown_s,
                              clock=self._clock)

    def add(self, name, endpoint, via_heartbeat=False, state=DEAD):
        """Register (or re-endpoint) a replica; static adds start DEAD
        and earn routability from the first successful probe. Static
        registrations hold a non-expiring table lease — only
        heartbeat-registered replicas ride the TTL."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                rep = Replica(name, endpoint, via_heartbeat=via_heartbeat,
                              breaker=self._make_breaker())
                rep.state = state
                self._replicas[name] = rep
            else:
                rep.endpoint = endpoint
            if name not in self.table:
                ttl = (self.heartbeat_ttl_s if via_heartbeat
                       else float("inf"))
                self.table.join(name, endpoint, ttl=ttl)
        self._update_gauges()
        return rep

    def heartbeat(self, name, endpoint):
        """A replica said hello: refresh its table lease (registering it
        on the first beat). A heartbeat proves the process is alive, not
        that it serves — routability still comes from the prober. A beat
        from a replica whose lease already lapsed cannot refresh the old
        lease: the table reaped it (epoch moved), so it re-JOINs under a
        strictly newer epoch."""
        rep = self.add(name, endpoint, via_heartbeat=True)
        with self._lock:
            rep.via_heartbeat = True
            rep.last_heartbeat = self._clock()
            m = self.table.get(name)
            if m is None or m["ttl"] == float("inf"):
                # lapsed, or promoted from a static registration: take a
                # fresh TTL'd lease (a new epoch — never resurrect)
                self.table.join(name, endpoint,
                                ttl=self.heartbeat_ttl_s)
            else:
                self.table.heartbeat(name, self.table.epoch)
        return rep

    def remove(self, name):
        with self._lock:
            self._replicas.pop(name, None)
            self.table.leave(name)
        self._update_gauges()

    def get(self, name):
        with self._lock:
            return self._replicas[name]

    def replicas(self):
        with self._lock:
            return list(self._replicas.values())

    def candidates(self, exclude=()):
        """Replicas routing may consider (the breaker gate is applied at
        dispatch, where the half-open single-probe slot is consumed)."""
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.state in _ROUTABLE and r.name not in exclude]

    def set_state(self, rep, state, error=None):
        if state not in STATE_VALUES:
            raise ValueError(f"unknown replica state {state!r}")
        with self._lock:
            rep.state = state
            rep.last_error = error
        self._update_gauges()

    def expire(self):
        """Replicas whose table lease lapsed go dead — the no-goodbye
        death path. The TTL bookkeeping itself lives in the shared
        MembershipTable: the reap bumps the membership epoch, and the
        zombie's next beat re-joins under a newer one."""
        changed = False
        with self._lock:
            for name in self.table.reap():
                rep = self._replicas.get(name)
                if rep is not None and rep.state != DEAD:
                    rep.state = DEAD
                    rep.last_error = "heartbeat TTL expired"
                    changed = True
        if changed:
            self._update_gauges()

    def healthy_count(self):
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.state == HEALTHY)

    def _update_gauges(self):
        reg = monitor.registry()
        with self._lock:
            reps = list(self._replicas.values())
        reg.gauge("fleet_healthy_replicas",
                  help="replicas in state=healthy").set(
            sum(1 for r in reps if r.state == HEALTHY))
        reg.gauge("fleet_routable_replicas",
                  help="replicas routing may pick "
                       "(healthy + degraded)").set(
            sum(1 for r in reps if r.state in _ROUTABLE))
        for r in reps:
            reg.gauge("fleet_replica_state",
                      help="0=dead 1=degraded 2=healthy 3=lame_duck",
                      replica=r.name).set(STATE_VALUES[r.state])

    def describe(self):
        """JSON-able membership snapshot for the router's /stats."""
        with self._lock:
            reps = list(self._replicas.values())
        return {r.name: {
            "endpoint": r.endpoint,
            "state": r.state,
            "breaker": r.breaker.state,
            "consecutive_failures": r.breaker.consecutive_failures,
            "queue_rows": r.queue_rows,
            "p99_ms": r.stats.get("p99_ms"),
            "via_heartbeat": r.via_heartbeat,
            "last_error": (str(r.last_error)
                           if r.last_error is not None else None),
        } for r in reps}
