"""paddle_tpu_torch.parallel.master against the JAX package's master.

Each membership, lease, snapshot, barrier and compile-store case of
tests/test_elastic.py, and the two compile-service cases of
tests/test_compile_cache.py, is one scenario run twice with one call
sequence: on the JAX package's MasterService/MasterClient and on the
port's. Each run asserts the JAX test's expectations and returns what it
observed (counts, epochs, barrier releases, stats); the two runs must
observe the same. The wire is one protocol (parallel/rpc.py framing), so
a port client also drives a JAX master and the reverse.
"""

import threading
import time

import pytest

import paddle_tpu.parallel.master as jmaster
import paddle_tpu.parallel.rpc as jrpc

import paddle_tpu_torch.parallel.master as tmaster
import paddle_tpu_torch.parallel.rpc as trpc

PACKAGES = {"jax": (jmaster, jrpc), "port": (tmaster, trpc)}


def _svc(m, **kw):
    kw.setdefault("lease_timeout", 0.3)
    kw.setdefault("failure_max", 2)
    return m.MasterService(**kw)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# task leases
# ---------------------------------------------------------------------------
def partition_and_basic_flow(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=2)
    svc.set_dataset(list(range(7)))  # 4 tasks: [0,1],[2,3],[4,5],[6]
    assert svc.counts()["todo"] == 4
    got = []
    while True:
        try:
            t = svc.get_task(0)
        except m.NoMoreAvailable:
            break
        got.extend(t.chunks)
        svc.task_finished(t.id)
        if svc.counts()["cur_pass"] == 1:
            break
    assert sorted(got) == list(range(7))
    c = svc.counts()
    assert c["cur_pass"] == 1 and c["todo"] == 4 and c["done"] == 0
    svc.stop()
    return {"got": got, "counts": c,
            "partition": [t.chunks for t in m._partition(list(range(7)), 3)]}


def lease_timeout_requeues_and_failure_cap_discards(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=1, lease_timeout=0.2, failure_max=1)
    svc.set_dataset(["a"])
    svc.get_task(0)
    pending = svc.counts()["pending"]
    time.sleep(0.5)  # lease expires -> requeued (failure 1)
    after = svc.counts()
    assert after == {"todo": 1, "pending": 0, "done": 0, "failed": 0,
                     "cur_pass": 0}
    t = svc.get_task(0)
    svc.task_failed(t.id, t.epoch)  # failure 2 > failure_max -> discarded
    failed = svc.counts()["failed"]
    with pytest.raises(m.AllTasksFailed):
        svc.get_task(0)
    svc.stop()
    return {"pending": pending, "after": after, "failed": failed}


def stale_failure_report_ignored(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=1, lease_timeout=0.2, failure_max=5)
    svc.set_dataset(["a"])
    t1 = svc.get_task(0)
    e1 = t1.epoch
    time.sleep(0.5)  # worker 1 considered dead; task requeued
    t2 = svc.get_task(0)
    assert t2.id == t1.id and t2.epoch == e1 + 1
    svc.task_failed(t1.id, e1)  # late report with stale epoch
    pending = svc.counts()["pending"]
    assert pending == 1
    svc.task_finished(t2.id)
    c = svc.counts()
    assert c["cur_pass"] == 1
    svc.stop()
    return {"epochs": (e1, t2.epoch), "counts": c}


def pass_rolls_over_when_last_task_fails_at_cap(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=1, lease_timeout=60.0, failure_max=0)
    svc.set_dataset(["good", "bad"])
    ta = svc.get_task(0)
    tb = svc.get_task(0)
    svc.task_finished(ta.id)
    svc.task_failed(tb.id, tb.epoch)  # cap 0 -> discarded
    c = svc.counts()
    assert c["cur_pass"] == 1 and c["todo"] == 2 and c["failed"] == 0
    t = svc.get_task(1)  # next pass serves immediately, no livelock
    assert t.chunks[0] in ("good", "bad")
    svc.stop()
    return {"counts": c, "next": t.chunks}


def snapshot_recover_resumes_pass(m, rpc, tmp_path):
    path = str(tmp_path / "master_snapshot.bin")
    svc = _svc(m, chunks_per_task=1, snapshot_path=path, snapshot_every=1)
    svc.set_dataset(["a", "b", "c"])
    t = svc.get_task(0)
    svc.task_finished(t.id)
    svc.get_task(0)  # leased but never finished: master dies now
    svc.stop()
    svc2 = m.MasterService.recover(path, chunks_per_task=1,
                                   lease_timeout=0.3, failure_max=2)
    c = svc2.counts()
    # 1 done, the in-flight lease conservatively requeued with the last
    assert c["done"] == 1 and c["todo"] == 2 and c["pending"] == 0
    remaining = []
    for _ in range(2):
        t = svc2.get_task(0)
        remaining.append(t.chunks[0])
        svc2.task_finished(t.id)
    assert set(remaining) | {"a"} >= {"a", "b", "c"}
    assert svc2.counts()["cur_pass"] == 1
    svc2.stop()
    return {"recovered": c, "remaining": sorted(remaining)}


def master_over_tcp_and_discovery(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=2)
    port = svc.serve()
    c = m.MasterClient(f"127.0.0.1:{port}")
    try:
        c.set_dataset([1, 2, 3, 4])
        c.register("pserver", "ps0", "127.0.0.1:6000", ttl=5.0)
        c.register("pserver", "ps1", "127.0.0.1:6001", ttl=0.1)
        t = c.get_task(0)
        assert isinstance(t, m.Task) and len(t.chunks) == 2
        c.task_finished(t.id)
        time.sleep(0.5)  # ps1's TTL expires
        looked = c.lookup("pserver")
        assert looked == {"ps0": "127.0.0.1:6000"}
        assert c.counts()["done"] == 1
        # a departing client must NOT take the service down with it
        c.close()
        c2 = m.MasterClient(f"127.0.0.1:{port}")
        done = c2.counts()["done"]
        c2.close()
        assert done == 1 and not svc._stop
    finally:
        svc.stop()
    return {"chunks": t.chunks, "lookup": looked}


def killed_trainer_mid_epoch_pass_completes(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=1, lease_timeout=0.3, failure_max=3)
    port = svc.serve()
    chunks = [f"chunk{i}" for i in range(6)]
    held = []

    def trainer_a():
        c = m.MasterClient(f"127.0.0.1:{port}")
        c.set_dataset(chunks)
        held.append((c, c.get_task(0)))  # dies mid-task: never reports

    consumed = []

    def trainer_b():
        c = m.MasterClient(f"127.0.0.1:{port}")
        c.set_dataset(chunks)  # idempotent second init
        for chunk in m.task_iterator(c, pass_id=0, max_wait=10.0):
            consumed.append(chunk)
            time.sleep(0.01)
        c.close()

    ta = threading.Thread(target=trainer_a, daemon=True)
    ta.start()
    ta.join(10)
    tb = threading.Thread(target=trainer_b, daemon=True)
    tb.start()
    tb.join(30)
    assert not tb.is_alive()
    c = svc.counts()
    assert c["cur_pass"] == 1 and c["failed"] == 0 and c["pending"] == 0
    assert sorted(consumed) == sorted(chunks)
    held[0][0].close()
    svc.stop()
    return {"counts": c, "consumed": sorted(consumed)}


def dead_trainer_connection_requeues_leases_immediately(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=1, lease_timeout=30.0, failure_max=3)
    port = svc.serve()
    try:
        a = m.MasterClient(f"127.0.0.1:{port}")
        a.set_dataset(["a", "b", "c"])
        t = a.get_task(0)
        assert svc.counts()["pending"] == 1
        a.close()  # dies holding the lease
        _wait(lambda: not svc.counts()["pending"])
        c = svc.counts()
        assert c["pending"] == 0 and c["todo"] == 3
        b = m.MasterClient(f"127.0.0.1:{port}")
        ids = set()
        for _ in range(3):
            t2 = b.get_task(0)
            ids.add(t2.id)
            b.task_finished(t2.id)
        assert t.id in ids
        b.close()
    finally:
        svc.stop()
    return {"after_death": c, "ids": sorted(ids)}


def disconnect_reclaim_ignores_releases_and_stale_epochs(m, rpc, tmp_path):
    svc = _svc(m, chunks_per_task=1, lease_timeout=1.0, failure_max=5)
    port = svc.serve()
    try:
        a = m.MasterClient(f"127.0.0.1:{port}")
        a.set_dataset(["only"])
        ta = a.get_task(0)
        time.sleep(1.6)  # A's lease expires; the task requeues (timeout)
        b = m.MasterClient(f"127.0.0.1:{port}")
        tb = b.get_task(0)  # re-leased under a new epoch
        assert tb.id == ta.id and tb.epoch > ta.epoch
        a.close()  # A's stale held lease must not clobber B's
        time.sleep(0.3)
        pending = svc.counts()["pending"]
        assert pending == 1
        b.task_finished(tb.id)
        assert svc.counts()["cur_pass"] == 1
        b.close()
    finally:
        svc.stop()
    return {"epochs": (ta.epoch, tb.epoch), "pending": pending}


# ---------------------------------------------------------------------------
# discovery and membership
# ---------------------------------------------------------------------------
def lookup_excludes_expired_registrations(m, rpc, tmp_path):
    svc = _svc(m)
    svc.register("pserver", "a", "addr-a", ttl=30.0)
    svc.register("pserver", "b", "addr-b", ttl=0.05)
    time.sleep(0.2)
    first = svc.lookup("pserver")
    assert first == {"a": "addr-a"}
    svc.register("pserver", "b", "addr-b2", ttl=30.0)
    second = svc.lookup("pserver")
    assert second == {"a": "addr-a", "b": "addr-b2"}
    svc.stop()
    return {"first": first, "second": second}


def membership_epoch_bumps_on_join_leave_and_ttl_lapse(m, rpc, tmp_path):
    svc = _svc(m)
    e1 = svc.elastic_join("w0", ttl=30.0)["epoch"]
    e2 = svc.elastic_join("w1", ttl=0.1)["epoch"]
    assert e2 == e1 + 1
    time.sleep(0.3)
    mem = svc.elastic_membership()
    assert list(mem["members"]) == ["w0"] and mem["epoch"] > e2
    e3 = mem["epoch"]
    svc.elastic_join("w2", ttl=30.0)
    e4 = svc.elastic_leave("w2")["epoch"]
    assert e4 > e3
    svc.stop()
    return {"epochs": (e1, e2, e3, e4)}


def lapsed_member_heartbeat_refused_and_rejoin_never_resurrects(
        m, rpc, tmp_path):
    svc = _svc(m)
    svc.elastic_join("w0", ttl=30.0)
    e = svc.elastic_join("w1", ttl=0.1)["epoch"]
    time.sleep(0.3)
    hb = svc.elastic_heartbeat("w1", e)
    assert hb["known"] is False and hb["epoch"] > e
    lapse_epoch = hb["epoch"]
    assert list(svc.elastic_membership()["members"]) == ["w0"]
    hb0 = svc.elastic_heartbeat("w0", e)
    assert hb0["known"] is True and hb0["stale"] is True
    e2 = svc.elastic_join("w1", ttl=30.0)["epoch"]
    assert e2 > lapse_epoch
    svc.stop()
    return {"hb": hb, "hb0": hb0, "rejoin": e2}


def fleet_and_elastic_share_one_membership_primitive(m, rpc, tmp_path):
    if m is jmaster:
        from paddle_tpu.serve.fleet import Membership
    else:
        from paddle_tpu_torch.serve.fleet import Membership
    svc = _svc(m)
    fleet = Membership()
    assert type(svc._table) is m.MembershipTable
    assert type(fleet.table) is m.MembershipTable
    seen = []

    def contract(table, lock):
        with lock:
            e = table.join("shared", ttl=0.05)
        time.sleep(0.15)
        with lock:
            hb = table.heartbeat("shared", e)  # lapsed: reaps, refuses
            assert hb["known"] is False and "shared" not in table
            lapse = table.epoch
            assert lapse > e
            e2 = table.join("shared", ttl=30.0)
            assert e2 > lapse
            table.leave("shared")
        seen.append((e, lapse, e2))

    contract(svc._table, svc._mu)
    contract(fleet.table, fleet._lock)
    svc.stop()
    return {"epochs": seen}


# ---------------------------------------------------------------------------
# barriers
# ---------------------------------------------------------------------------
def resize_barrier_restarts_on_concurrent_leave_and_join(m, rpc, tmp_path):
    svc = _svc(m)
    svc.elastic_join("w0", ttl=30.0)
    e = svc.elastic_join("w1", ttl=30.0)["epoch"]
    results = {}

    def arrive(name, epoch):
        results[name] = svc.elastic_barrier(name, epoch, "resize",
                                            timeout=10.0)

    t = threading.Thread(target=arrive, args=("w0", e), daemon=True)
    t.start()
    time.sleep(0.15)  # w0 parked; w1 never arrives
    svc.elastic_join("w2", ttl=30.0)
    svc.elastic_leave("w1")
    e2 = svc.elastic_membership()["epoch"]
    t.join(10.0)
    first = results["w0"]
    assert first["ok"] is False and first.get("restart") \
        and first["epoch"] == e2
    ts = [threading.Thread(target=arrive, args=(n, e2), daemon=True)
          for n in ("w0", "w2")]
    for th in ts:
        th.start()
    for th in ts:
        th.join(10.0)
    assert results["w0"]["ok"] and results["w2"]["ok"]
    assert results["w0"]["members"] == ["w0", "w2"]
    assert {results["w0"]["rank"], results["w2"]["rank"]} == {0, 1}
    svc.stop()
    return {"restart": first, "released": results}


def commit_barrier_restarts_on_rejoin_during_restore(m, rpc, tmp_path):
    svc = _svc(m)
    svc.elastic_join("w0", ttl=30.0)
    e = svc.elastic_join("w1", ttl=30.0)["epoch"]
    out = {}

    def arrive(name, epoch, phase):
        out[(name, phase)] = svc.elastic_barrier(name, epoch, phase,
                                                 timeout=10.0)

    ts = [threading.Thread(target=arrive, args=(n, e, "resize"),
                           daemon=True) for n in ("w0", "w1")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
    assert out[("w0", "resize")]["ok"] and out[("w1", "resize")]["ok"]
    e2 = svc.elastic_join("w2", ttl=30.0)["epoch"]
    r = svc.elastic_barrier("w0", e, "commit", timeout=10.0)
    assert r["ok"] is False and r.get("restart") and r["epoch"] == e2
    ts = [threading.Thread(target=arrive, args=(n, e2, "resize"),
                           daemon=True) for n in ("w0", "w1", "w2")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
    rel = out[("w0", "resize")]
    assert rel["ok"] and rel["members"] == ["w0", "w1", "w2"]
    svc.stop()
    return {"commit": r, "released": rel}


def barrier_wait_refreshes_waiter_ttl(m, rpc, tmp_path):
    svc = _svc(m)
    svc.elastic_join("w0", ttl=0.3)
    e = svc.elastic_join("w1", ttl=30.0)["epoch"]
    out = {}

    def park():
        out["w0"] = svc.elastic_barrier("w0", e, "resize", timeout=10.0)

    t = threading.Thread(target=park, daemon=True)
    t.start()
    time.sleep(0.8)  # > w0's TTL: only the in-barrier refresh keeps it
    alive = "w0" in svc.elastic_membership()["members"]
    assert alive
    out["w1"] = svc.elastic_barrier("w1", e, "resize", timeout=10.0)
    t.join(10.0)
    assert out["w0"]["ok"] and out["w1"]["ok"]
    svc.stop()
    return {"released": out}


def stale_socket_teardown_does_not_evict_rejoined_member(m, rpc, tmp_path):
    svc = _svc(m)
    port = svc.serve()
    try:
        a = m.MasterClient(f"127.0.0.1:{port}")
        b = m.MasterClient(f"127.0.0.1:{port}")
        a.elastic_join("w", ttl=30.0)
        e = b.elastic_join("w", ttl=30.0)["epoch"]  # re-incarnation
        a.close()  # stale socket dies
        time.sleep(0.5)  # let the teardown path run
        mem = b.elastic_membership()
        assert "w" in mem["members"] and mem["epoch"] == e
        b.close()  # the CURRENT connection's death does evict
        _wait(lambda: "w" not in svc.elastic_membership()["members"])
        assert "w" not in svc.elastic_membership()["members"]
    finally:
        svc.stop()
    return {"kept": mem}


# ---------------------------------------------------------------------------
# the compile store (tests/test_compile_cache.py's service cases)
# ---------------------------------------------------------------------------
def compile_service_single_flight_lease_and_parked_fetch(m, rpc, tmp_path):
    svc = m.MasterService()
    digest = "c" * 64
    try:
        grants = []

        def racer():
            grants.append(svc.compiled_lease(digest)["granted"])

        ts = [threading.Thread(target=racer) for _ in range(5)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert sum(grants) == 1  # single-flight: ONE compiler
        got = {}

        def parked():
            got["blob"] = svc.compiled_get(digest, wait_s=30.0)

        t = threading.Thread(target=parked)
        t.start()
        time.sleep(0.1)
        assert t.is_alive()  # parked on the leaseholder's publish
        svc.compiled_put(digest, b"ptac-blob")
        t.join(10)
        assert got["blob"] == b"ptac-blob"
        stats = svc.compiled_stats()
        assert stats["leases"] == 1 and stats["lease_rejects"] == 4
        assert stats["waits"] >= 1 and stats["active_leases"] == 0
        cached = svc.compiled_lease(digest)
        assert cached == {"granted": False, "cached": True}
        dup = svc.compiled_put(digest, b"ptac-blob2")
        assert dup["duplicate"]
        assert svc.compiled_stats()["duplicate_puts"] == 1
    finally:
        svc.stop()
    return {"grants": sorted(grants), "cached": cached, "dup": dup,
            "stats": {k: stats[k] for k in ("leases", "lease_rejects",
                                            "puts", "entries", "bytes")}}


def compile_service_rejects_malformed_digest_not_connection(
        m, rpc, tmp_path):
    svc = m.MasterService()
    port = svc.serve()
    c = m.MasterClient(f"127.0.0.1:{port}")
    try:
        with pytest.raises(rpc.RpcError):
            c.compiled_get("../../etc/passwd")
        with pytest.raises(rpc.RpcError):
            c.compiled_lease("A" * 64)  # uppercase hex: refused
        stats = c.compiled_stats()
        assert stats["entries"] == 0  # connection survived
    finally:
        c.close()
        svc.stop()
    return {"stats": stats}


SCENARIOS = [
    partition_and_basic_flow,
    lease_timeout_requeues_and_failure_cap_discards,
    stale_failure_report_ignored,
    pass_rolls_over_when_last_task_fails_at_cap,
    snapshot_recover_resumes_pass,
    master_over_tcp_and_discovery,
    killed_trainer_mid_epoch_pass_completes,
    dead_trainer_connection_requeues_leases_immediately,
    disconnect_reclaim_ignores_releases_and_stale_epochs,
    lookup_excludes_expired_registrations,
    membership_epoch_bumps_on_join_leave_and_ttl_lapse,
    lapsed_member_heartbeat_refused_and_rejoin_never_resurrects,
    fleet_and_elastic_share_one_membership_primitive,
    resize_barrier_restarts_on_concurrent_leave_and_join,
    commit_barrier_restarts_on_rejoin_during_restore,
    barrier_wait_refreshes_waiter_ttl,
    stale_socket_teardown_does_not_evict_rejoined_member,
    compile_service_single_flight_lease_and_parked_fetch,
    compile_service_rejects_malformed_digest_not_connection,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_the_port_master_observes_what_the_jax_master_does(scenario,
                                                            tmp_path):
    got = {}
    for name, (m, rpc) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = scenario(m, rpc, d)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_one_wire_between_the_packages(server, client):
    """A port client drives a JAX master and the reverse: leases,
    discovery, membership, a barrier and the compile store over the
    shared framing."""
    smod, cmod = PACKAGES[server][0], PACKAGES[client][0]
    svc = _svc(smod, chunks_per_task=1)
    port = svc.serve()
    c = cmod.MasterClient(f"127.0.0.1:{port}")
    try:
        c.set_dataset(["a", "b"])
        t = c.get_task(0)
        assert isinstance(t, cmod.Task) and t.chunks in (["a"], ["b"])
        c.task_finished(t.id)
        with pytest.raises(cmod.PassAfter):
            c.get_task(1)
        c.register("serve", "r0", "127.0.0.1:1", 30.0)
        assert c.lookup("serve") == {"r0": "127.0.0.1:1"}
        e = c.elastic_join("w0", "h:1", 30.0)["epoch"]
        b = c.elastic_barrier("w0", e, "resize", 5.0)
        assert b["ok"] and b["members"] == ["w0"] and b["rank"] == 0
        digest = "d" * 64
        assert c.compiled_lease(digest)["granted"]
        assert c.compiled_put(digest, b"blob")["stored"]
        assert c.compiled_get(digest) == b"blob"
        assert c.elastic_leave("w0")["epoch"] == e + 1
    finally:
        c.close()
        svc.stop()


def test_heartbeater_keeps_a_registration_alive_and_close_lets_it_lapse():
    """The fleet replica's registration: re-registered every ttl/3, so it
    outlives its TTL; after close() the entry lapses one TTL later."""
    svc = _svc(tmaster)
    port = svc.serve()
    try:
        hb = tmaster.Heartbeater(tmaster.MasterClient(f"127.0.0.1:{port}"),
                                 "serve", "r0", "127.0.0.1:9", ttl=0.6)
        hb.start()
        _wait(lambda: svc.lookup("serve"))
        time.sleep(1.0)  # > ttl: only the beats keep it
        assert svc.lookup("serve") == {"r0": "127.0.0.1:9"}
        assert hb.beats >= 2
        hb.close()
        time.sleep(0.8)
        assert svc.lookup("serve") == {}
    finally:
        svc.stop()
