"""paddle_tpu_torch.serve.fleet.autoscaler: the control loop that holds
a latency target by resizing the fleet.

The JAX package's tests/test_autoscaler.py cases, ported to the port:
windowed-p99 math over cumulative histogram snapshots, config
validation, breach/calm consecutive-round counters, the hysteresis dead
band, cooldowns, min/max bounds, drain-before-kill scale-in with LIFO
victim preference and per-model targets — all against an injected
clock, a fake router (real Membership, fake latency window) and a fake
spawner, so nothing sleeps and no process is spawned. New cases: the
windowed p99 and the victim pick equal the JAX package's on the same
inputs; ProcessReplicaSpawner against a real `python -m paddle_tpu_torch
fleet replica --place cpu` process (spawn, bind, drain, exit 0) lives in
tests/test_torch_fleet.py.
"""

import pytest

from paddle_tpu_torch import monitor
from paddle_tpu_torch.serve.fleet import (HEALTHY, Autoscaler,
                                          AutoscalerConfig, Membership,
                                          scale_in_victim)
from paddle_tpu_torch.serve.fleet.autoscaler import _window_p99


@pytest.fixture(autouse=True)
def _fresh_monitor():
    monitor.reset()
    yield
    monitor.reset()


# ---------------------------------------------------------------------------
# windowed p99 over cumulative snapshots
# ---------------------------------------------------------------------------

EDGES = (10.0, 100.0, 1000.0, float("inf"))


def _cum(b10, b100, b1000, binf):
    return {10.0: b10, 100.0: b100, 1000.0: b1000, "+Inf": binf}


def test_window_p99_interpolates_and_handles_empty_window():
    assert _window_p99(EDGES, None, _cum(0, 0, 0, 0)) is None
    # 100 observations all in (10, 100]: linear interpolation in-bucket
    cur = _cum(0, 100, 100, 100)
    v = _window_p99(EDGES, None, cur)
    assert abs(v - (10.0 + 0.99 * 90.0)) < 1e-9
    # WINDOWED: identical prev/cur snapshots mean zero new requests
    assert _window_p99(EDGES, cur, cur) is None
    # only the delta counts: 100 new requests, all over the last edge —
    # the +Inf bucket conservatively reports its finite lower edge
    assert _window_p99(EDGES, cur, _cum(0, 100, 100, 200)) == 1000.0
    # a fast window after a slow history stays fast
    assert _window_p99(EDGES, cur, _cum(50, 150, 150, 150)) <= 10.0


def test_autoscaler_config_validation():
    with pytest.raises(ValueError):
        AutoscalerConfig(target_p99_ms=0)
    with pytest.raises(ValueError):
        AutoscalerConfig(hysteresis=0.0)
    with pytest.raises(ValueError):
        AutoscalerConfig(hysteresis=1.5)
    with pytest.raises(ValueError):
        AutoscalerConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        AutoscalerConfig(breach_rounds=0)
    cfg = AutoscalerConfig(high_queue_rows=8)
    assert cfg.high_queue_rows == 8.0


# ---------------------------------------------------------------------------
# the loop against a fake router/spawner
# ---------------------------------------------------------------------------

class _FakeSpawner:
    def __init__(self):
        self.seq = 0
        self.stopped = []

    def spawn_many(self, n):
        out = []
        for _ in range(n):
            out.append((f"as{self.seq}", f"h:{100 + self.seq}"))
            self.seq += 1
        return out

    def stop(self, name):
        self.stopped.append(name)
        return 0


class _FakeRouter:
    """Real Membership (the unified table) + a scripted latency window."""

    def __init__(self, clock):
        self.membership = Membership(heartbeat_ttl_s=1e9, clock=clock)
        self.edges = EDGES
        self.cum = _cum(0, 0, 0, 0)
        self.drained = []

    def latency_window(self):
        return self.edges, dict(self.cum)

    def observe(self, fast=0, slow=0):
        """fast lands <= 10 ms, slow in (10, 100]."""
        self.cum[10.0] += fast
        for k in (100.0, 1000.0, "+Inf"):
            self.cum[k] += fast + slow

    def drain(self, name, timeout_s=60.0):
        self.drained.append(name)
        return {"replica": name, "lost": 0, "status": "drained"}


def _fleet(clock, names=("r0", "r1")):
    r = _FakeRouter(clock)
    for name in names:
        rep = r.membership.add(name, f"{name}:1")
        r.membership.set_state(rep, HEALTHY)
    return r


def test_scale_out_needs_breach_rounds_then_respects_cooldown_and_max():
    now = [0.0]
    r = _fleet(lambda: now[0])
    sp = _FakeSpawner()
    a = Autoscaler(r, sp, AutoscalerConfig(
        target_p99_ms=50.0, min_replicas=2, max_replicas=4, scale_step=2,
        breach_rounds=2, calm_rounds=4, cooldown_out_s=5.0,
        cooldown_in_s=5.0), clock=lambda: now[0])
    a.tick()  # empty window: neither hot nor cold counts as a breach
    assert sp.seq == 0 and a.last_p99 is None
    r.observe(slow=50)  # window p99 ~ 99 ms > 50 ms target
    now[0] = 1.0
    a.tick()  # breach 1: one hot tick never spawns
    assert sp.seq == 0 and a.describe()["breach_rounds"] == 1
    r.observe(slow=50)
    now[0] = 2.0
    a.tick()  # breach 2: scale out by step
    assert sp.seq == 2 and a.scale_outs == 2
    # the joiners landed on the router's membership (the unified table,
    # under a TTL'd heartbeat lease) but stay unroutable until probed
    assert "as0" in r.membership.table and "as1" in r.membership.table
    assert r.membership.get("as0").state != HEALTHY
    for n in ("as0", "as1"):
        r.membership.set_state(r.membership.get(n), HEALTHY)
    r.observe(slow=50)
    now[0] = 3.0
    a.tick()  # hot again, but at max_replicas AND inside the cooldown
    assert sp.seq == 2
    snap = monitor.registry().snapshot()
    assert snap["fleet_autoscaler_scale_outs_total"] == 2
    assert snap["fleet_autoscaler_routable_replicas"] == 4


def test_queue_trigger_dead_band_and_lifo_drain_back_to_min():
    now = [0.0]
    r = _fleet(lambda: now[0])
    sp = _FakeSpawner()
    a = Autoscaler(r, sp, AutoscalerConfig(
        target_p99_ms=1e9, high_queue_rows=8, min_replicas=2,
        max_replicas=4, scale_step=2, breach_rounds=2, calm_rounds=2,
        cooldown_out_s=0.0, cooldown_in_s=0.0), clock=lambda: now[0])
    # dead band: a non-empty queue below the trigger advances NEITHER
    # counter — the fleet holds steady instead of flapping
    r.membership.get("r0").stats = {"queue_rows": 4}
    for t in (0.0, 0.5, 1.0, 1.5):
        now[0] = t
        a.tick()
    d = a.describe()
    assert sp.seq == 0 and d["breach_rounds"] == 0 and d["calm_rounds"] == 0
    # queue breach: two hot rounds spawn the step
    r.membership.get("r0").stats = {"queue_rows": 16}
    now[0] = 2.0
    a.tick()
    now[0] = 3.0
    a.tick()
    assert sp.seq == 2
    for n in ("as0", "as1"):
        r.membership.set_state(r.membership.get(n), HEALTHY)
    # calm: drain LIFO — the surge capacity goes first, baseline survives
    r.membership.get("r0").stats = {"queue_rows": 0}
    now[0] = 10.0
    a.tick()
    assert r.drained == []  # calm 1: one calm tick never kills
    now[0] = 11.0
    a.tick()
    assert r.drained == ["as1"] and sp.stopped == ["as1"]
    assert "as1" not in r.membership.table  # left the unified table
    assert "as1" not in {x.name for x in r.membership.replicas()}
    now[0] = 12.0
    a.tick()
    now[0] = 13.0
    a.tick()
    assert r.drained == ["as1", "as0"]
    # min bound: the baseline pair is never drained
    now[0] = 14.0
    a.tick()
    now[0] = 15.0
    a.tick()
    assert r.drained == ["as1", "as0"] and a.scale_ins == 2
    # drain-before-kill bookkeeping: drained clean, exited 0, lost none
    assert [rep["exit_code"] for rep in a.drain_reports] == [0, 0]
    assert all(rep["lost"] == 0 for rep in a.drain_reports)
    assert monitor.registry().snapshot()[
        "fleet_autoscaler_scale_ins_total"] == 2


def test_hysteresis_scale_in_needs_p99_well_below_target():
    now = [0.0]
    r = _fleet(lambda: now[0], names=("r0", "r1", "r2"))
    sp = _FakeSpawner()
    a = Autoscaler(r, sp, AutoscalerConfig(
        target_p99_ms=150.0, min_replicas=1, max_replicas=4,
        breach_rounds=2, calm_rounds=2, hysteresis=0.5,
        cooldown_out_s=0.0, cooldown_in_s=0.0), clock=lambda: now[0])
    # p99 ~ 99 ms: under the 150 ms target but ABOVE target*hysteresis
    # (75 ms) — the dead band again, from the cold side
    for t in (0.0, 1.0, 2.0, 3.0):
        r.observe(slow=50)
        now[0] = t
        a.tick()
    assert r.drained == [] and a.describe()["calm_rounds"] == 0
    # p99 <= 10 ms: genuinely cold — two calm rounds drain one replica
    for t in (4.0, 5.0):
        r.observe(fast=50)
        now[0] = t
        a.tick()
    assert len(r.drained) == 1 and a.scale_ins == 1


def test_scale_in_victim_prefers_lifo_then_shallowest_queue():
    ms = Membership()
    reps = []
    for name, rows in (("r0", 5.0), ("r1", 1.0), ("as0", 9.0)):
        rep = ms.add(name, f"{name}:1")
        rep.stats = {"queue_rows": rows}
        reps.append(rep)
    # LIFO: the most recently autoscaled-up name wins while routable
    assert scale_in_victim(reps, prefer=["as0"]) == "as0"
    assert scale_in_victim(reps, prefer=["gone"]) == "r1"  # shallowest
    assert scale_in_victim([], prefer=["as0"]) is None


# ---------------------------------------------------------------------------
# per-model latency windows
# ---------------------------------------------------------------------------

class _ModelRouter(_FakeRouter):
    """Adds scripted per-model windows on top of the aggregate one."""

    def __init__(self, clock):
        super().__init__(clock)
        self.model_cum = {}

    def latency_window(self, model=None):
        if model is None:
            return self.edges, dict(self.cum)
        return self.edges, dict(self.model_cum.get(model) or
                                _cum(0, 0, 0, 0))

    def observe_model(self, model, fast=0, slow=0):
        cum = self.model_cum.setdefault(model, _cum(0, 0, 0, 0))
        cum[10.0] += fast
        for k in (100.0, 1000.0, "+Inf"):
            cum[k] += fast + slow


def _model_fleet(clock, names=("r0", "r1")):
    r = _ModelRouter(clock)
    for name in names:
        rep = r.membership.add(name, f"{name}:1")
        r.membership.set_state(rep, HEALTHY)
    return r


def test_model_targets_validation():
    with pytest.raises(ValueError):
        AutoscalerConfig(model_targets={"m": 0})
    cfg = AutoscalerConfig(model_targets={"m": 20})
    assert cfg.model_targets == {"m": 20.0}


def test_hot_model_scales_out_through_cold_aggregate():
    """One model breaching its own target fires scale-out even while a
    flood of cold-model traffic holds the aggregate p99 under the fleet
    target — the exact conflation per-model windows exist to break."""
    now = [0.0]
    r = _model_fleet(lambda: now[0])
    sp = _FakeSpawner()
    a = Autoscaler(r, sp, AutoscalerConfig(
        target_p99_ms=50.0, model_targets={"hot": 20.0},
        min_replicas=2, max_replicas=4, breach_rounds=2,
        calm_rounds=4, cooldown_out_s=1.0),
        clock=lambda: now[0])
    for rnd in range(2):
        # aggregate: 1000 fast + the 5 slow -> windowed p99 <= 10 ms,
        # far under the 50 ms fleet target
        r.observe(fast=1000, slow=5)
        # the hot model's own window: all 5 slow -> p99 ~ 99 ms > 20
        r.observe_model("hot", slow=5)
        now[0] += 1.0
        a.tick()
    assert a.last_p99 is not None and a.last_p99 <= 50.0
    assert a.last_hot_models == ["hot"]
    assert a.describe()["hot_models"] == ["hot"]
    assert a.scale_outs == 1
    assert sp.seq == 1
    reg = monitor.registry().snapshot()
    assert reg['fleet_autoscaler_window_p99_ms{model="hot"}'] > 20.0


def test_model_above_half_target_blocks_scale_in():
    """Scale-in needs every named model calm: a model sitting between
    hysteresis * target and target holds the dead band."""
    now = [0.0]
    r = _model_fleet(lambda: now[0], names=("r0", "r1", "r2"))
    sp = _FakeSpawner()
    a = Autoscaler(r, sp, AutoscalerConfig(
        target_p99_ms=500.0, model_targets={"m": 120.0},
        min_replicas=1, max_replicas=4, breach_rounds=2,
        calm_rounds=1, cooldown_in_s=0.0), clock=lambda: now[0])
    # m's window p99 ~ 99 ms: under its 120 ms target (not hot) but
    # over 120 * 0.5 (not calm) -> dead band, no scale-in
    r.observe(fast=100, slow=5)
    r.observe_model("m", slow=5)
    now[0] += 1.0
    a.tick()
    assert a.last_hot_models == []
    assert a.scale_ins == 0
    assert a.describe()["calm_rounds"] == 0
    # a genuinely calm round (no traffic anywhere) arms scale-in
    now[0] += 1.0
    a.tick()
    assert a.scale_ins == 1


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_window_p99_is_the_jax_packages():
    from paddle_tpu.serve.fleet.autoscaler import _window_p99 as jwin

    cases = [(None, _cum(0, 0, 0, 0)), (None, _cum(0, 100, 100, 100)),
             (_cum(0, 100, 100, 100), _cum(0, 100, 100, 200)),
             (_cum(0, 100, 100, 100), _cum(50, 150, 150, 150)),
             (_cum(3, 7, 7, 9), _cum(10, 40, 90, 95))]
    for prev, cur in cases:
        for p in (0.5, 0.99):
            assert _window_p99(EDGES, prev, cur, p) == \
                jwin(EDGES, prev, cur, p)


def test_scale_in_victim_is_the_jax_packages():
    from paddle_tpu.serve.fleet import Membership as JMembership
    from paddle_tpu.serve.fleet import scale_in_victim as jvictim

    picks = []
    for ms_cls, victim in ((JMembership, jvictim),
                           (Membership, scale_in_victim)):
        ms = ms_cls()
        for name, rows in (("b", 3), ("a", 3), ("c", 1), ("d", 7)):
            rep = ms.add(name, f"{name}:1")
            rep.stats = {"queue_rows": rows}
        reps = ms.replicas()
        picks.append([victim(reps), victim(reps, prefer=["d", "a"]),
                      victim(reps, prefer=["zz"]), victim([])])
    assert picks[0] == picks[1] == [["c", "a", "c", None]][0]
