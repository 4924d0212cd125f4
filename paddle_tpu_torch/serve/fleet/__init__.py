"""paddle_tpu_torch.serve.fleet — fault-tolerant multi-replica serving.

One Router load-balances POST /v1/infer over N serve.http replicas:

    from paddle_tpu_torch.serve import fleet

    router = fleet.Router({"r0": "127.0.0.1:8001",
                           "r1": "127.0.0.1:8002",
                           "r2": "127.0.0.1:8003"})
    with router:                       # health probing runs
        status, headers, body = router.route(payload)
        router.drain("r1")             # lame-duck + wait for exit

Membership tracks healthy / degraded / dead / lame_duck per replica
(active /healthz + /stats probes, per-replica circuit breakers), with
liveness riding the TTL'd epoch-fenced MembershipTable
(parallel/master.py) — ONE membership primitive for elastic training and
the fleet; routing picks least-queue-depth and owns failures — 503s and
transient transport faults retry on another replica under a per-request
deadline and a fleet-wide retry budget, with optional hedging. Killing
one of N replicas mid-load loses zero accepted requests; draining one
finishes its backlog and exits clean (rolling restarts drop nothing).

An Autoscaler holds a latency target by spawning/draining replica
processes (hysteresis, cooldowns, min/max bounds; scale-in reuses
Router.drain so nothing accepted is lost).

`python -m paddle_tpu_torch fleet replica|router ...` runs either half as
a process (a replica serves on the first card unless `--place cpu`);
`make_fleet_http` is the router's own HTTP frontend. The JAX package's
links to the elastic master (replica discovery and heartbeats), to obs/
and to the distributed compile service come with ROADMAP queue 1 item 8.

A port of the JAX package's paddle_tpu/serve/fleet.
"""

from .autoscaler import Autoscaler, AutoscalerConfig, ProcessReplicaSpawner
from .health import HealthProber, http_fetch
from .membership import (DEAD, DEGRADED, HEALTHY, LAME_DUCK, STATE_VALUES,
                         CircuitBreaker, Membership, Replica)
from .policy import LeastQueueDepthPolicy, scale_in_victim
from .router import (FleetConfig, Router, http_transport, make_fleet_http,
                     serve_fleet)

__all__ = [
    "HEALTHY", "DEGRADED", "DEAD", "LAME_DUCK", "STATE_VALUES",
    "CircuitBreaker", "Replica", "Membership",
    "HealthProber", "http_fetch",
    "LeastQueueDepthPolicy", "scale_in_victim",
    "Autoscaler", "AutoscalerConfig", "ProcessReplicaSpawner",
    "FleetConfig", "Router", "http_transport", "make_fleet_http",
    "serve_fleet",
]
