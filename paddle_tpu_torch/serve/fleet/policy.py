"""Dispatch policy: which routable replica gets the next request.

Least-queue-depth over the healthy set, falling back to degraded
replicas only when no healthy one is eligible. queue depth comes from
the last /stats probe (the engine's row-accounted admission queue), so
the policy naturally spreads load away from a replica whose batcher is
falling behind — the same signal its own admission control would
eventually 503 on. Ties rotate deterministically so equal replicas
share load instead of the dict-order replica eating it all.

Multi-model: when the request names a model, the pick is SLO-weighted
over the replicas HOSTING that model (a replica's /stats advertises a
"models" block; one without the block predates multi-model and is
assumed to serve everything). Each candidate scores
queue_rows + p99/slo lag on that model, so a replica running the named
model hot against its own SLO loses the pick even when its queue is
level with the rest.

A port of the JAX package's paddle_tpu/serve/fleet/policy.py.
"""

import threading

from .membership import HEALTHY

__all__ = ["LeastQueueDepthPolicy", "scale_in_victim"]


def scale_in_victim(candidates, prefer=()):
    """Which routable replica the autoscaler should drain next.

    Prefer the most recently autoscaled-up replica that is still
    routable (LIFO: the baseline fleet outlives the surge capacity);
    otherwise the shallowest queue loses — draining the replica with the
    least backlog finishes fastest and strands the least work behind a
    LAME_DUCK. Returns a name or None."""
    names = {r.name: r for r in candidates}
    for name in reversed(list(prefer)):
        if name in names:
            return name
    if not names:
        return None
    return min(sorted(names.values(), key=lambda r: r.name),
               key=lambda r: r.queue_rows).name


def _hosts_model(replica, model):
    """Does this replica serve `model`? A replica whose /stats never
    advertised a "models" block predates multi-model — treat it as
    serving everything (backward compatible with old replicas)."""
    models = (replica.stats or {}).get("models")
    if not models:
        return True
    return model in models


def _model_lag(replica, model):
    """p99/slo pressure of `model` on this replica, in queue-row-
    comparable units: 0 when unknown, p99_ms / slo_ms otherwise. A
    replica at 2x its SLO on the named model scores as two phantom
    queued rows per SLO of lag."""
    st = ((replica.stats or {}).get("models") or {}).get(model)
    if not st:
        return 0.0
    p99, slo = st.get("p99_ms"), st.get("slo_ms")
    if p99 is None or p99 != p99 or not slo:
        return 0.0
    return float(p99) / float(slo)


class LeastQueueDepthPolicy:
    def __init__(self):
        self._lock = threading.Lock()
        self._ticket = 0

    def pick(self, candidates, exclude=(), model=None):
        """-> Replica or None. `candidates` come from
        Membership.candidates() (already routable); `exclude` holds the
        names this request already tried; `model` (optional) restricts
        to replicas hosting it and weights the pick by that model's
        SLO lag."""
        eligible = [r for r in candidates if r.name not in exclude]
        if model is not None:
            hosting = [r for r in eligible if _hosts_model(r, model)]
            # nobody advertises the model: fall back to the full pool
            # and let the replica answer 404 (deterministic, unretried)
            eligible = hosting or eligible
        if not eligible:
            return None
        healthy = [r for r in eligible if r.state == HEALTHY]
        pool = healthy or eligible

        def score(r):
            s = r.queue_rows
            if model is not None:
                s += _model_lag(r, model)
            return s

        best = min(score(r) for r in pool)
        ties = sorted((r for r in pool if score(r) == best),
                      key=lambda r: r.name)
        with self._lock:
            self._ticket += 1
            return ties[self._ticket % len(ties)]
