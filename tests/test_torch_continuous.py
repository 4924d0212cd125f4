"""paddle_tpu_torch.serve.continuous against the JAX package's
paddle_tpu.serve.continuous.

The JAX package's tests/test_continuous.py cases, ported to the port on
CPUPlace(): the slot bank (ladder addressing, verbatim gather/scatter),
the dataflow branch partitioner, the ContinuousServer step loop
(join/leave mid-batch, zero steady-state captures, drain/stop semantics,
per-model SLO scheduling), multi-model HTTP (the "model"/"steps" fields,
404 on unknown names), the per-model metric labels the fleet consumes,
and the interop runner. Adapted where the JAX case asserts what only the
JAX package has:
  * test_continuous_decode_parity_with_join_leave and
    test_http_model_field_continuous: bitwise against the solo replay at
    the server's one rung (slot_buckets=(R,): one live row and R - 1 of
    the bank's zero pad rows), not at one row. torch's matmul gives the
    M = 1 row other bits than M >= 2 (ROADMAP §3: the port's difference
    from the JAX contract);
    test_default_ladder_is_bitwise_per_rung_not_across_rungs shows it.
New cases: the decode held against the JAX package's ContinuousServer on
the same weights (the tanh(fc) cell and the two-head program within
rtol 1e-5 / atol 1e-6, a small NMT greedy step within rtol 1e-4); no
place means the card, which raises here; the warm-up on the executor's
graph path (test_torch_step's recording stand-in for the CUDA graph):
every rung captured at start(), zero steady-state captures after
join/leave traffic, still bitwise its solo replay. The same cases on
CUDAPlace(0) are in tests/test_torch_continuous_card.py (no JAX there).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import monitor as jmonitor
from paddle_tpu.serve.continuous import ContinuousConfig as JConfig
from paddle_tpu.serve.continuous import ContinuousServer as JServer

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert, flags, monitor, serve
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.serve.continuous import (ContinuousConfig,
                                               ContinuousServer, SlotBank,
                                               independent_branches)
from paddle_tpu_torch.serve.http import make_http_server

from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    monitor.reset()
    ttrace.reset()
    flags.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    ttrace.reset()
    flags.reset()
    jmonitor.reset()


def _decode_program(pkg=fluid, feat=4, place=CPU):
    """A one-step decode cell: y = tanh(fc(x)), state x <- y. Returns
    (prog, scope, x_name, y_var)."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(prog, startup):
        x = pkg.layers.data(name="x", shape=[feat], dtype="float32")
        y = pkg.layers.fc(input=x, size=feat, act="tanh")
    scope = pkg.Scope()
    exe = pkg.Executor(place)
    with pkg.scope_guard(scope):
        exe.run(startup)
    return prog, scope, "x", y


def _server(models=(("m", 50.0),), max_slots=4, feat=4, place=CPU, **cfg):
    srv = ContinuousServer(place=place,
                           config=ContinuousConfig(max_slots=max_slots,
                                                   **cfg))
    progs = {}
    for name, slo in models:
        prog, scope, xn, y = _decode_program(feat=feat, place=place)
        srv.add_model(name, prog, [xn], [y], state={xn: y.name},
                      scope=scope, slo_ms=slo)
        progs[name] = (prog, scope, y)
    return srv, progs


def _solo_decode(prog, scope, y, row, steps, rows=1, place=CPU):
    """Reference: the same K-step decode replayed solo through a plain
    Executor at `rows` rows — the request's row first, zero pad rows
    after it, as the slot bank pads a rung (bitwise comparator for the
    continuous path)."""
    exe = fluid.Executor(place)
    cur = np.zeros((rows, np.asarray(row).size), dtype="float32")
    cur[0] = np.asarray(row, dtype="float32").reshape(-1)
    out = []
    with fluid.scope_guard(scope):
        for _ in range(steps):
            got = exe.run(prog, feed={"x": cur}, fetch_list=[y])[0]
            out.append(got[0])
            cur = np.zeros_like(cur)
            cur[0] = got[0]
    return np.stack(out, axis=0)


# ---------------------------------------------------------------------------
# slot bank
# ---------------------------------------------------------------------------

def test_slot_bank_alloc_release_ladder():
    bank = SlotBank(4, {"x": ((3,), "float32")}, place=CPU)
    assert bank.rungs == (1, 2, 4)
    assert bank.free_slots == 4
    s0 = bank.alloc("r0")
    s1 = bank.alloc("r1")
    assert (s0, s1) == (0, 1)  # lowest slot first: stable lane order
    assert bank.active_slots() == (0, 1)
    bank.release(s0)
    assert bank.active_slots() == (1,)
    assert bank.alloc("r2") == 0  # freed slot is reused
    for r in ("r3", "r4"):
        bank.alloc(r)
    assert bank.free_slots == 0
    assert bank.alloc("r5") is None  # full bank refuses, never evicts


def test_slot_bank_lane_index_pads_with_scratch():
    bank = SlotBank(4, {"x": ((2,), "float32")}, place=CPU)
    bank.alloc("a")
    bank.alloc("b")
    bank.release(0)
    idx = bank.lane_index(2)
    assert idx.tolist() == [1, bank.scratch]


def test_slot_bank_roundtrip_is_verbatim():
    bank = SlotBank(2, {"x": ((3,), "float32")}, place=CPU)
    s = bank.alloc("a")
    row = np.array([1.5, -2.25, 3.125], dtype="float32")
    bank.write_row(s, {"x": row})
    idx = bank.lane_index(1)
    got = bank.gather(idx)["x"].numpy()
    assert np.array_equal(got[0], row)
    bank.scatter(idx, {"x": torch.from_numpy(got * 2)})
    got2 = bank.gather(idx)["x"].numpy()
    assert np.array_equal(got2[0], row * 2)


def test_slot_bank_rng_rows_track_seed_and_step():
    bank = SlotBank(2, {"x": ((1,), "float32")}, place=CPU)
    s = bank.alloc("a", seed=7)
    bank.steps[s] = 3
    rows = bank.rng_rows(bank.lane_index(2))
    assert rows.dtype == np.uint32
    assert rows[0].tolist() == [7, 3]
    assert rows[1].tolist() == [0, 0]  # scratch lane: inert key


def test_slot_bank_scatter_never_writes_the_scratch_row():
    """Pad lanes all index the one scratch row: scatter writes the live
    lanes only, so the row stays zero and no two writes race for it."""
    bank = SlotBank(4, {"x": ((2,), "float32"), "k": ((), "int64")},
                    place=CPU)
    bank.alloc("a")
    idx = bank.lane_index(4)
    assert idx.tolist() == [0] + [bank.scratch] * 3
    vals = {"x": torch.arange(8, dtype=torch.float32).reshape(4, 2) + 1,
            "k": torch.tensor([5, 6, 7, 8])}
    bank.scatter(idx, vals)
    got = bank.gather(np.array([0, bank.scratch]))
    assert got["x"].tolist() == [[1.0, 2.0], [0.0, 0.0]]
    assert got["k"].tolist() == [5, 0]
    assert bank.gather(idx)["x"].dtype == torch.float32


def test_slot_bank_lives_on_the_card_unless_told():
    """No place means the first card: with none, the bank raises rather
    than fall back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotBank(2, {"x": ((1,), "float32")})


# ---------------------------------------------------------------------------
# inter-op branch partitioning
# ---------------------------------------------------------------------------

def _two_heads(pkg, shared):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(prog, startup):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        h = pkg.layers.fc(input=x, size=4) if shared else x
        a = pkg.layers.fc(input=h, size=3)
        b = pkg.layers.fc(input=h, size=2)
    return prog, a, b


@pytest.mark.parametrize("shared,want", [(False, [[0], [1]]),
                                         (True, [[0, 1]])])
def test_independent_branches_as_the_jax_package(shared, want):
    """Disjoint heads split, a shared trunk groups them — the same
    partition as the JAX package's on the same layer calls."""
    from paddle_tpu.serve.continuous import independent_branches as jib

    prog, a, b = _two_heads(fluid, shared)
    groups = independent_branches(prog, ["x"], [a.name, b.name])
    assert sorted(map(sorted, groups)) == want
    jprog, ja, jb = _two_heads(jfluid, shared)
    assert jib(jprog, ["x"], [ja.name, jb.name]) == groups


# ---------------------------------------------------------------------------
# continuous scheduling
# ---------------------------------------------------------------------------

def test_continuous_basic_decode_and_zero_compiles():
    srv, progs = _server()
    with srv:
        rows = [np.random.RandomState(i).randn(4).astype("float32")
                for i in range(3)]
        futs = [srv.submit({"x": r}, steps=4) for r in rows]
        res = [f.result(timeout=30) for f in futs]
    for r in res:
        assert r[0].shape == (4, 4)
    st = srv.stats()
    assert st["steady_state_compiles"] == 0
    assert st["models"]["m"]["completed"] == 3


def test_continuous_join_midstream_no_head_of_line_blocking():
    """A short request submitted while a long stream is mid-decode rides
    the running batch instead of waiting for the stream to finish."""
    srv, progs = _server(max_slots=4)
    srv.start(warm=True, loop=False)  # deterministic: we drive steps
    try:
        long_fut = srv.submit(
            {"x": np.ones(4, dtype="float32")}, steps=64)
        for _ in range(5):
            srv.step_once()
        short_fut = srv.submit(
            {"x": np.zeros(4, dtype="float32")}, steps=1)
        # ONE more turn of the loop must finish the short request — it
        # joined the running batch at the very next step
        srv.step_once()
        assert short_fut.done()
        assert not long_fut.done()
        while not long_fut.done():
            srv.step_once()
        assert len(long_fut.result(timeout=5)[0]) == 64
    finally:
        srv.stop()


def _join_leave(srv, rows):
    """The JAX case's join/leave schedule: r1 alone, r2 joins, r2 leaves,
    r3 joins while r1 runs on. -> [(row, future, steps)]."""
    r1, r2, r3 = rows
    f1 = srv.submit({"x": r1}, steps=5)
    srv.step_once()                       # batch={r1}
    f2 = srv.submit({"x": r2}, steps=2)
    srv.step_once()                       # batch={r1,r2}
    srv.step_once()                       # r2 leaves after this step
    f3 = srv.submit({"x": r3}, steps=3)
    while not (f1.done() and f2.done() and f3.done()):
        srv.step_once()
    return ((r1, f1, 5), (r2, f2, 2), (r3, f3, 3))


def test_continuous_decode_parity_with_join_leave():
    """A K-step decode through the continuous scheduler — with other
    requests joining and leaving the batch mid-stream — is BITWISE
    identical to the same request replayed solo at the server's rung."""
    srv, progs = _server(max_slots=4, slot_buckets=(4,))
    prog, scope, y = progs["m"]
    srv.start(warm=True, loop=False)
    try:
        rng = np.random.RandomState(0)
        rows = [rng.randn(4).astype("float32") for _ in range(3)]
        for row, fut, steps in _join_leave(srv, rows):
            got = fut.result(timeout=5)[0]
            ref = _solo_decode(prog, scope, y, row, steps, rows=4)
            assert got.shape == ref.shape
            assert np.array_equal(got, ref), \
                "continuous decode diverged from solo replay"
    finally:
        srv.stop()
    assert srv.stats()["steady_state_compiles"] == 0


def _solo_by_rungs(prog, scope, y, row, rungs):
    """The solo replay that follows a request's rung schedule: step t at
    rungs[t] rows (the row first, zero pad rows after it)."""
    exe = fluid.Executor(CPU)
    cur = np.asarray(row, dtype="float32").reshape(-1)
    out = []
    with fluid.scope_guard(scope):
        for b in rungs:
            x = np.zeros((b, cur.size), dtype="float32")
            x[0] = cur
            cur = exe.run(prog, feed={"x": x}, fetch_list=[y])[0][0]
            out.append(cur)
    return np.stack(out, axis=0)


def test_default_ladder_is_bitwise_per_rung_not_across_rungs():
    """The finding behind the fixed-rung contract (ROADMAP §3). Under the
    default ladder the join/leave decode steps at rungs 1, 2 and 4. Each
    request is bitwise its solo replay at the rung of each of its steps,
    and within rtol 1e-4 of its one-row replay — but not bitwise: torch's
    CPU matmul (mul op, K = N = 16) gives the one-row rung other bits
    than the wider ones (here 85 of 160 values differ, by up to 142 ulps
    after a few tanh steps). The test asserts the bits differ exactly
    when the one-row rung's step does."""
    srv, progs = _server(max_slots=4, feat=16)
    prog, scope, y = progs["m"]
    m = srv.models["m"]
    assert m.bank.rungs == (1, 2, 4)
    rungs = {}  # id(request) -> [rung of each of its steps]
    run_step = m.run_step

    def record(feed):
        b = feed["x"].shape[0]
        for slot in m.bank.active_slots():
            rungs.setdefault(id(m.bank.requests[slot]), []).append(b)
        return run_step(feed)

    m.run_step = record
    srv.start(warm=True, loop=False)
    try:
        rng = np.random.RandomState(0)
        rows = [rng.randn(16).astype("float32") for _ in range(3)]
        reqs = []
        orig_alloc = m.bank.alloc

        def alloc(request, seed=0):
            reqs.append(request)
            return orig_alloc(request, seed=seed)

        m.bank.alloc = alloc
        done = _join_leave(srv, rows)
    finally:
        srv.stop()
    schedule = [rungs[id(r)] for r in reqs]
    assert schedule == [[1, 2, 2, 2, 2], [2, 2], [2, 2, 1]]
    n_diff = 0
    for (row, fut, steps), sched in zip(done, schedule):
        got = fut.result(timeout=5)[0]
        assert np.array_equal(got, _solo_by_rungs(prog, scope, y, row,
                                                  sched))
        one = _solo_by_rungs(prog, scope, y, row, [1] * steps)
        np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-6)
        n_diff += int((got != one).sum())
    x = np.random.RandomState(1).randn(2, 16).astype("float32")
    with fluid.scope_guard(scope):
        exe = fluid.Executor(CPU)
        wide = exe.run(prog, feed={"x": x}, fetch_list=[y])[0][0]
        narrow = exe.run(prog, feed={"x": x[:1]}, fetch_list=[y])[0][0]
    assert (n_diff > 0) == (not np.array_equal(wide, narrow)), n_diff


def test_continuous_multi_model_isolation_and_least_lag():
    """Two models on one server: separate compile caches, separate slot
    banks, per-model stats — and the tighter-SLO model is not starved."""
    srv, progs = _server(models=(("hot", 10.0), ("cold", 1000.0)))
    srv.start(warm=True, loop=False)
    try:
        fh = srv.submit({"x": np.ones(4, dtype="float32")},
                        model="hot", steps=3)
        fc = srv.submit({"x": np.ones(4, dtype="float32")},
                        model="cold", steps=3)
        while not (fh.done() and fc.done()):
            srv.step_once()
        fh.result(timeout=5), fc.result(timeout=5)
    finally:
        srv.stop()
    st = srv.stats()
    assert set(st["models"]) == {"hot", "cold"}
    for name in ("hot", "cold"):
        ms = st["models"][name]
        assert ms["completed"] == 1
        assert ms["steady_state_compiles"] == 0
    assert srv.models["hot"].exe is not srv.models["cold"].exe
    with pytest.raises(serve.UnknownModel):
        srv.resolve_model("nope")


def test_continuous_least_lag_picks_the_tighter_slo():
    """Weighted least-lag: both models waited equally long, so the one
    whose wait is larger relative to its SLO is stepped first."""
    srv, _ = _server(models=(("slow", 1000.0), ("fast", 10.0)))
    srv.start(warm=True, loop=False)
    try:
        for name in ("slow", "fast"):
            srv.submit({"x": np.ones(4, dtype="float32")}, model=name,
                       steps=2)
        srv._admit()
        for m in srv.models.values():
            m.last_service_t = 0.0
        assert srv._pick().name == "fast"
    finally:
        srv.stop()


def test_continuous_overload_and_bad_steps():
    srv, _ = _server(max_slots=1, max_pending=1)
    srv.start(warm=True, loop=False)  # nothing drains pending
    try:
        with pytest.raises(ValueError):
            srv.submit({"x": np.ones(4, dtype="float32")}, steps=0)
        with pytest.raises(serve.UnknownModel):
            srv.submit({"x": np.ones(4, dtype="float32")}, model="zz")
        srv.submit({"x": np.ones(4, dtype="float32")}, steps=4)
        with pytest.raises(serve.ServerOverloaded):
            srv.submit({"x": np.ones(4, dtype="float32")}, steps=4)
        reg = monitor.registry()
        assert reg.counter("serve_rejected_total").value == 1
        assert reg.counter("serve_rejected_total", model="m").value == 1
    finally:
        srv.stop()


def test_continuous_drain_finishes_backlog_stop_fails_it():
    srv, _ = _server(max_slots=2)
    srv.start(warm=True)
    fut = srv.submit({"x": np.ones(4, dtype="float32")}, steps=8)
    assert srv.drain(timeout=30)
    assert fut.done() and len(fut.result()[0]) == 8
    with pytest.raises(serve.ServerClosed):
        srv.submit({"x": np.ones(4, dtype="float32")})

    srv2, _ = _server(max_slots=2)
    srv2.start(warm=True, loop=False)
    fut2 = srv2.submit({"x": np.ones(4, dtype="float32")}, steps=8)
    srv2.stop()  # never stepped: the request must fail, not hang
    with pytest.raises(serve.ServerClosed):
        fut2.result(timeout=5)


def test_continuous_server_needs_a_card_unless_told():
    """No place means the first card, as the port's entry points all
    do: with none it raises instead of serving on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousServer()


# ---------------------------------------------------------------------------
# per-model metric labels (fleet-facing)
# ---------------------------------------------------------------------------

def test_per_model_series_do_not_conflate():
    """Two models on one server: each model's labeled series counts only
    its own traffic, while the unlabeled aggregates keep the totals."""
    srv, _ = _server(models=(("a", 100.0), ("b", 100.0)))
    with srv:
        for _ in range(3):
            srv.infer({"x": np.ones(4, dtype="float32")}, model="a",
                      timeout=30)
        srv.infer({"x": np.ones(4, dtype="float32")}, model="b",
                  timeout=30)
    reg = monitor.registry()
    assert reg.counter("serve_requests_total", model="a").value == 3
    assert reg.counter("serve_requests_total", model="b").value == 1
    assert reg.counter("serve_requests_total").value == 4
    pa = reg.histogram("serve_request_ms",
                       model="a").snapshot()["count"]
    pb = reg.histogram("serve_request_ms",
                       model="b").snapshot()["count"]
    assert (pa, pb) == (3, 1)
    assert reg.histogram("serve_request_ms").snapshot()["count"] == 4


def test_modelset_per_model_series_do_not_conflate():
    """Same guarantee for the one-shot ModelSet path."""
    def _one(name):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(prog, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.fc(input=x, size=3)
        scope = fluid.Scope()
        exe = fluid.Executor(CPU)
        with fluid.scope_guard(scope):
            exe.run(startup)
        return serve.Server(
            prog, ["x"], [y], place=CPU, scope=scope,
            config=serve.ServeConfig(max_batch=4, max_wait_ms=0.0),
            model=name)

    ms = serve.ModelSet({"a": _one("a"), "b": _one("b")})
    with ms:
        batch = np.ones((1, 4), dtype="float32")
        ms.infer({"x": batch}, model="a", timeout=30)
        ms.infer({"x": batch}, model="a", timeout=30)
        ms.infer({"x": batch}, model="b", timeout=30)
        with pytest.raises(serve.UnknownModel):
            ms.submit({"x": batch}, model="zz")
    reg = monitor.registry()
    assert reg.counter("serve_requests_total", model="a").value == 2
    assert reg.counter("serve_requests_total", model="b").value == 1
    st = ms.stats()
    assert st["requests"] == 3
    assert set(st["models"]) == {"a", "b"}
    assert st["models"]["a"]["requests"] == 2


# ---------------------------------------------------------------------------
# HTTP: the "model" / "steps" fields
# ---------------------------------------------------------------------------

def _post(port, obj, path="/v1/infer"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve_http(engine):
    httpd = make_http_server(engine, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def test_http_model_field_continuous():
    srv, progs = _server(models=(("a", 100.0), ("b", 100.0)),
                         slot_buckets=(4,))
    prog, scope, y = progs["a"]
    with srv:
        httpd, port = _serve_http(srv)
        try:
            row = [0.5, -1.0, 2.0, 0.25]
            code, out = _post(port, {"inputs": {"x": row},
                                     "model": "a", "steps": 3})
            assert code == 200
            got = np.asarray(out["outputs"][0], dtype="float32")
            ref = _solo_decode(prog, scope, y,
                               np.asarray(row, dtype="float32"), 3, rows=4)
            assert np.array_equal(got, ref)
            # omitted model = default (first added)
            code, _ = _post(port, {"inputs": {"x": row}})
            assert code == 200
            # unknown model is a deterministic 404, not a retryable 503
            code, out = _post(port, {"inputs": {"x": row},
                                     "model": "zz"})
            assert code == 404
            assert "zz" in out["error"]
            code, out = _post(port, {"inputs": {"x": row}, "model": 7})
            assert code == 400
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_http_steps_rejected_on_oneshot_server():
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(input=x, size=3)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(scope):
        exe.run(startup)
    server = serve.Server(prog, ["x"], [y], place=CPU, scope=scope,
                          config=serve.ServeConfig(max_batch=4),
                          model="solo")
    with server:
        httpd, port = _serve_http(server)
        try:
            row = [[0.0, 1.0, 2.0, 3.0]]
            code, _ = _post(port, {"inputs": {"x": row},
                                   "model": "solo"})
            assert code == 200
            code, out = _post(port, {"inputs": {"x": row}, "steps": 4})
            assert code == 400
            assert "continuous" in out["error"]
            code, _ = _post(port, {"inputs": {"x": row}, "model": "zz"})
            assert code == 404
        finally:
            httpd.shutdown()
            httpd.server_close()


# ---------------------------------------------------------------------------
# inter-op runner through the scheduler
# ---------------------------------------------------------------------------

def _head_program(pkg, place):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(prog, startup):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        h = pkg.layers.fc(input=x, size=4, act="tanh")
        head = pkg.layers.fc(input=x, size=4)
    scope = pkg.Scope()
    exe = pkg.Executor(place)
    with pkg.scope_guard(scope):
        exe.run(startup)
    return prog, scope, exe, h, head


def test_continuous_interop_two_head_model():
    """A two-head model runs through InterOpRunner branches with results
    identical to the single-dispatch path and no steady-state capture."""
    prog, scope, exe, h, head = _head_program(fluid, CPU)
    srv = ContinuousServer(place=CPU, config=ContinuousConfig(max_slots=2))
    m = srv.add_model("two", prog, ["x"], [h, head],
                      state={"x": h.name}, scope=scope, interop=True)
    assert m.runner is not None and len(m.runner.groups) == 2
    srv.start(warm=True)
    try:
        row = np.arange(4, dtype="float32")
        out_h, out_head = srv.infer({"x": row}, steps=3, timeout=30)
        with fluid.scope_guard(scope):
            cur, ref_h, ref_head = row.reshape(1, 4), [], []
            for _ in range(3):
                rh, rhead = exe.run(prog, feed={"x": cur},
                                    fetch_list=[h, head])
                ref_h.append(rh[0])
                ref_head.append(rhead[0])
                cur = rh
        assert np.array_equal(out_h, np.stack(ref_h))
        assert np.array_equal(out_head, np.stack(ref_head))
        assert srv.stats()["steady_state_compiles"] == 0
        assert srv.model_stats("two")["interop_branches"] == 2
        assert all(c is not None for c in m.runner.branch_cost_ms)
    finally:
        srv.stop()


def test_overlap_efficiency_is_the_jax_packages():
    from paddle_tpu.obs.timeline import overlap_efficiency as jeff

    from paddle_tpu_torch.serve.continuous.interop import overlap_efficiency

    for args in ((2.0, 1.0, 2.0), (2.0, 1.0, 3.5), (2.0, 1.0, 2.4),
                 (2.0, 0.0, 2.0), (None, 1.0, 2.0), (2.0, 1.0, None)):
        assert overlap_efficiency(*args) == jeff(*args)


# ---------------------------------------------------------------------------
# against the JAX package's ContinuousServer on the same weights
# ---------------------------------------------------------------------------

def _carry(jscope, jprog, tscope_, tprog):
    """The JAX program's parameters into the port's scope (same names)."""
    arrays = {n: np.asarray(jscope.find_var(n))
              for n, v in jprog.global_block().vars.items()
              if v.persistable and jscope.find_var(n) is not None}
    convert.load_numpy_state(tscope_, tprog, arrays, CPU)


def _both_servers(build_j, build_t, max_slots, **add):
    """A JAX and a port ContinuousServer over the same weights, each with
    one model "m" (add_model kwargs from `add(prog, outs)`)."""
    jprog, jscope, jouts = build_j()
    tprog, tscope_, touts = build_t()
    _carry(jscope, jprog, tscope_, tprog)
    jsrv = JServer(place=jfluid.CPUPlace(),
                   config=JConfig(max_slots=max_slots))
    tsrv = ContinuousServer(place=CPU,
                            config=ContinuousConfig(max_slots=max_slots))
    for srv, prog, scope, outs in ((jsrv, jprog, jscope, jouts),
                                   (tsrv, tprog, tscope_, touts)):
        feeds, fetch, kw = add["spec"](outs)
        srv.add_model("m", prog, feeds, fetch, scope=scope, **kw)
    return jsrv, tsrv


def _traffic(srv, rows, steps):
    """Every row submitted at once: they join one running batch and
    leave it as their step counts run out."""
    with srv:
        futs = [srv.submit(r, steps=k) for r, k in zip(rows, steps)]
        return [f.result(timeout=120) for f in futs]


def test_cell_decode_matches_the_jax_package():
    """The tanh(fc) cell's decode through both ContinuousServers, same
    weights and rows: within rtol 1e-5 / atol 1e-6 at every step."""
    def build(pkg):
        def b():
            prog, scope, _, y = _decode_program(
                pkg, feat=8,
                place=pkg.CPUPlace())
            return prog, scope, y
        return b

    jsrv, tsrv = _both_servers(
        build(jfluid), build(fluid), 4,
        spec=lambda y: (["x"], [y], {"state": {"x": y.name}}))
    rs = np.random.RandomState(11)
    rows = [{"x": rs.randn(8).astype("float32")} for _ in range(6)]
    steps = [5, 2, 7, 1, 3, 6]
    want = _traffic(jsrv, rows, steps)
    got = _traffic(tsrv, rows, steps)
    for w, g, k in zip(want, got, steps):
        assert g[0].shape == (k, 8)
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=1e-5,
                                   atol=1e-6)
    assert tsrv.stats()["steady_state_compiles"] == 0


def test_interop_decode_matches_the_jax_package():
    def build(pkg):
        def b():
            prog, scope, _, h, head = _head_program(pkg, pkg.CPUPlace())
            return prog, scope, (h, head)
        return b

    jsrv, tsrv = _both_servers(
        build(jfluid), build(fluid), 2,
        spec=lambda o: (["x"], list(o), {"state": {"x": o[0].name},
                                         "interop": True}))
    assert len(tsrv.models["m"].runner.groups) == 2
    rs = np.random.RandomState(3)
    rows = [{"x": rs.randn(4).astype("float32")} for _ in range(3)]
    steps = [3, 1, 2]
    want = _traffic(jsrv, rows, steps)
    got = _traffic(tsrv, rows, steps)
    for w, g in zip(want, got):
        for wo, go in zip(w, g):
            np.testing.assert_allclose(go, np.asarray(wo), rtol=1e-5,
                                       atol=1e-6)


# a small NMT: embedding 16, hidden 16, vocabulary 50, sources of <= 6
NMT_SMALL = dict(embedding_dim=16, encoder_size=16, decoder_size=16,
                 source_dict_dim=50, target_dict_dim=50, max_source_len=6,
                 max_target_len=6)


def _jax_greedy_step(train_prog, Ts):
    """The JAX package's counterpart of greedy_step_program: the same ops
    on the same names (built here: the JAX package has no such
    function)."""
    dec = next(op for b in train_prog.blocks for op in b.ops
               if op.type == "attention_lstm_decoder")
    weights = {s: dec.input(s)[0] for s in (
        "WAttState", "WAttScore", "WStep", "BStep", "WOut", "BOut")}
    table_n = next(op for op in train_prog.global_block().ops
                   if op.type == "lookup_table" and op.input("Ids")[0]
                   == "target_sequence").input("W")[0]
    gb = train_prog.global_block()
    V, E = gb.vars[table_n].shape
    D = gb.vars[weights["WOut"]].shape[0]
    He = gb.vars[weights["WStep"]].shape[0] - D - E
    prog = jfluid.Program()
    with jfluid.program_guard(prog, jfluid.Program()):
        L = jfluid.layers
        pe = L.data(name="prev_emb", shape=[E], dtype="float32")
        ph = L.data(name="prev_h", shape=[D], dtype="float32")
        pc = L.data(name="prev_c", shape=[D], dtype="float32")
        ev = L.data(name="enc_vec", shape=[Ts, He], dtype="float32")
        ej = L.data(name="enc_proj", shape=[Ts, D], dtype="float32")
        sm = L.data(name="src_mask", shape=[Ts], dtype="float32")
        blk = prog.global_block()
        for n in list(weights.values()) + [table_n]:
            v = gb.vars[n]
            blk.create_var(name=n, shape=v.shape, dtype=v.dtype,
                           persistable=True)
        h = blk.create_var(name="greedy_h", shape=[-1, D], dtype="float32")
        c = blk.create_var(name="greedy_c", shape=[-1, D], dtype="float32")
        lp = blk.create_var(name="greedy_logprobs", shape=[-1, V],
                            dtype="float32")
        blk.append_op(
            type="attention_lstm_step",
            inputs={"PrevEmb": [pe.name], "PrevH": [ph.name],
                    "PrevC": [pc.name], "EncoderVec": [ev.name],
                    "EncoderProj": [ej.name], "SrcMask": [sm.name],
                    **{s: [n] for s, n in weights.items()}},
            outputs={"H": [h.name], "C": [c.name], "LogProbs": [lp.name]},
            attrs={})
        tok = blk.create_var(name="greedy_token", shape=[-1],
                             dtype="int64")
        blk.append_op(type="arg_max", inputs={"X": [lp.name]},
                      outputs={"Out": [tok.name]}, attrs={"axis": 1})
        ids = L.reshape(tok, shape=[-1, 1])
        emb = blk.create_var(name="greedy_next_emb", shape=[-1, E],
                             dtype="float32")
        blk.append_op(type="lookup_table",
                      inputs={"W": [table_n], "Ids": [ids.name]},
                      outputs={"Out": [emb.name]},
                      attrs={"padding_idx": -1})
    state = {"prev_emb": emb.name, "prev_h": h.name, "prev_c": c.name}
    return prog, [tok, h], state


def _small_nmt():
    """The small NMT in both packages, the port's weights the JAX
    package's; -> (jprog, jscope, tprog, tscope, texe)."""
    progs = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            if pkg is jfluid:
                from paddle_tpu.models import machine_translation as jmt
                jmt.seq_to_seq_net(**NMT_SMALL)
            else:
                tmt.seq_to_seq_net(**NMT_SMALL)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(scope):
            exe.run(startup)
        progs[pkg] = (main, scope, exe)
    jprog, jscope, _ = progs[jfluid]
    tprog, tscope_, texe = progs[fluid]
    _carry(jscope, jprog, tscope_, tprog)
    return jprog, jscope, tprog, tscope_, texe


def test_nmt_greedy_step_matches_the_jax_package():
    """Greedy NMT streams (the port's greedy_step_program; its feeds from
    the port's encoder run once for the batch) through both
    ContinuousServers on the same weights: the same tokens, h within
    rtol 1e-4 at every step; the port's own decode bitwise its solo
    replay at the fixed rung."""
    Ts = NMT_SMALL["max_source_len"]
    jprog, jscope, tprog, tscope_, texe = _small_nmt()
    rs = np.random.RandomState(5)
    srcs = [rs.randint(2, 50, (n,)) for n in (3, 6, 2, 5, 4)]
    lt = fluid.create_lod_tensor(
        np.concatenate(srcs).reshape(-1, 1).astype("int64"),
        [[len(s) for s in srcs]], CPU)
    feeds = tmt.greedy_feeds(texe, tprog, lt, Ts, scope=tscope_)
    assert len(feeds) == 5 and feeds[1]["enc_vec"].shape == (Ts, 32)
    steps = [6, 2, 4, 1, 5]
    sprog, names, fetch, state = tmt.greedy_step_program(tprog, Ts)
    tsrv = ContinuousServer(place=CPU, config=ContinuousConfig(
        max_slots=4, slot_buckets=(4,)))
    tsrv.add_model("nmt", sprog, names, fetch, state=state, scope=tscope_)
    jsp, jfetch, jstate = _jax_greedy_step(jprog, Ts)
    jsrv = JServer(place=jfluid.CPUPlace(), config=JConfig(max_slots=4))
    jsrv.add_model("nmt", jsp, names, jfetch, state=jstate, scope=jscope)
    got = _traffic(tsrv, feeds, steps)
    want = _traffic(jsrv, feeds, steps)
    assert tsrv.stats()["steady_state_compiles"] == 0
    for g, w, k in zip(got, want, steps):
        assert g[0].shape == (k,) and g[1].shape == (k, 16)
        assert g[0].tolist() == np.asarray(w[0]).reshape(k).tolist()
        np.testing.assert_allclose(g[1], np.asarray(w[1]), rtol=1e-4,
                                   atol=1e-6)
    # the port's own contract: each stream bitwise its solo replay at the
    # server's rung (one live row, three zero pad rows)
    exe = fluid.Executor(CPU)
    for f, g, k in zip(feeds, got, steps):
        cur = {n: np.zeros((4,) + np.shape(v), dtype=np.asarray(v).dtype)
               for n, v in f.items()}
        for n, v in f.items():
            cur[n][0] = v
        toks, hs = [], []
        with fluid.scope_guard(tscope_):
            for _ in range(k):
                t, h, emb, c = exe.run(
                    sprog, feed=cur, fetch_list=fetch + [
                        state["prev_emb"], state["prev_c"]])
                toks.append(t[0])
                hs.append(h[0])
                for n, v in (("prev_emb", emb), ("prev_h", h),
                             ("prev_c", c)):
                    cur[n] = np.zeros_like(cur[n])
                    cur[n][0] = v[0]
        assert np.array_equal(g[0], np.asarray(toks))
        assert np.array_equal(g[1], np.stack(hs))


# ---------------------------------------------------------------------------
# the graph path (recorded stand-in on the CPU)
# ---------------------------------------------------------------------------

def test_every_rung_is_captured_at_start_and_none_after(recorded_graphs):
    """On the executor's graph path start() captures each rung's step
    (two runs: eager, then the capture); join/leave traffic replays them
    with zero steady-state captures, bitwise the solo replay."""
    srv, progs = _server(max_slots=4, slot_buckets=(4,))
    prog, scope, y = progs["m"]
    m = srv.models["m"]
    srv.start(warm=True, loop=False)
    try:
        assert m.exe.step_mode(prog) == "graph"
        assert len(m.exe.captured_steps(prog, scope)) == 1
        rng = np.random.RandomState(1)
        rows = [rng.randn(4).astype("float32") for _ in range(3)]
        done = _join_leave(srv, rows)
        assert srv.stats()["steady_state_compiles"] == 0
    finally:
        srv.stop()
    for row, fut, steps in done:
        ref = _solo_decode(prog, scope, y, row, steps, rows=4)
        assert np.array_equal(fut.result(timeout=5)[0], ref)


def test_default_ladder_captures_one_graph_a_rung(recorded_graphs):
    srv, progs = _server(max_slots=8)
    prog, scope, _ = progs["m"]
    m = srv.models["m"]
    srv.start(warm=True, loop=False)
    try:
        assert m.bank.rungs == (1, 2, 4, 8)
        assert len(m.exe.captured_steps(prog, scope)) == 4
        futs = [srv.submit({"x": np.full(4, i, dtype="float32")},
                           steps=i + 1) for i in range(6)]
        while not all(f.done() for f in futs):
            srv.step_once()
        assert srv.stats()["steady_state_compiles"] == 0
    finally:
        srv.stop()
