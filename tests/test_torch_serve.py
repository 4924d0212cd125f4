"""paddle_tpu_torch.serve against the JAX package's paddle_tpu.serve.

The JAX package's tests/test_serve.py cases, ported to the port on
CPUPlace(): bucket ladder math, dynamic batching semantics (coalescing,
max_wait flush, admission control), warm-up's zero-steady-state-compile
contract, multi-replica dispatch, drain, the HTTP frontend, the
from_inference_model / from_infer_func factories, Inferencer.serve, the
InferenceTranspiler's conv+bn fold and the bitwise held-request case.
Adapted where the JAX case asserts what only the JAX package has:
  * the warm-up case reads the executor's compile_cache_info() misses,
    where the JAX case reads the monitor's per-step cache counter (the
    port's executor keeps no per-step monitor records yet);
  * test_inferencer_parallel_accel_follows_place: the JAX case's
    TPUPlace(0) -> use_tpu=True becomes CUDAPlace(0) -> use_cuda=True,
    a `cuda` case that skips without a card.
New cases: the served rows against the JAX package's Server on the same
weights; the folded weights bitwise equal to the JAX transpiler's; no
place means the card, which raises here; the warm-up on the executor's
graph path (on the CPU with test_torch_step's recording stand-in for the
CUDA graph): every bucket captured at start(), zero steady-state
captures after mixed traffic, an amp toggle counted as one, and
load_params after warm-up reaching the next served result. The `cuda`
cases run the same on CUDAPlace(0) and skip here.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import monitor as jmonitor
from paddle_tpu import serve as jserve

import paddle_tpu_torch as fluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import flags, monitor, serve
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.serve import engine as serve_engine
from paddle_tpu_torch.serve.buckets import bucket_for, ladder, pad_rows
from paddle_tpu_torch.serve.http import make_http_server

from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def _fresh_port_state():
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
    tamp.disable()
    monitor.reset()
    ttrace.reset()
    flags.reset()
    jmonitor.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the served graphs are captured there")
    return torch.device("cuda", 0)


def _fc_server(max_batch=4, replicas=1, feat=4, out=3,
               place=fluid.CPUPlace(), **cfg):
    """A Server over a tiny fc program, plus the (exe, scope, prog, fetch)
    needed to compute reference results."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[feat], dtype="float32")
        y = fluid.layers.fc(input=x, size=out)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(startup)
    server = serve.Server(
        prog, ["x"], [y], place=place, scope=scope,
        config=serve.ServeConfig(max_batch=max_batch, replicas=replicas,
                                 **cfg))
    return server, exe, scope, prog, y


def _ref(exe, scope, prog, y, batch):
    with fluid.scope_guard(scope):
        return exe.run(prog, feed={"x": batch}, fetch_list=[y])[0]


# ---------------------------------------------------------------------------
# bucket ladder
# ---------------------------------------------------------------------------

def test_ladder_powers_of_two():
    assert ladder(8) == (1, 2, 4, 8)
    assert ladder(1) == (1,)
    # a non-power-of-two max becomes the top rung
    assert ladder(6) == (1, 2, 4, 6)


def test_ladder_explicit_and_errors():
    assert ladder(8, [4, 1]) == (1, 4, 8)  # sorted, max appended
    with pytest.raises(ValueError):
        ladder(0)
    with pytest.raises(ValueError):
        ladder(8, [0, 4])
    with pytest.raises(ValueError):
        ladder(8, [16])


def test_bucket_for():
    rungs = ladder(8)
    assert [bucket_for(r, rungs) for r in (1, 2, 3, 5, 8)] == \
        [1, 2, 4, 8, 8]
    assert bucket_for(9, rungs) is None


def test_pad_rows_round_trip():
    feed = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
            "y": np.arange(3, dtype=np.int32)}
    padded = pad_rows(feed, 3, 8)
    for name in feed:
        assert padded[name].shape[0] == 8
        # original rows intact, padding zero
        np.testing.assert_array_equal(padded[name][:3], feed[name])
        assert not padded[name][3:].any()
    # bucket == rows: same dict back, no copy
    assert pad_rows(feed, 3, 3) is feed
    with pytest.raises(ValueError):
        pad_rows(feed, 3, 2)
    with pytest.raises(ValueError):
        pad_rows(feed, 4, 8)  # leading axis mismatch


# ---------------------------------------------------------------------------
# engine semantics
# ---------------------------------------------------------------------------

def test_single_and_batched_requests_match_reference():
    server, exe, scope, prog, y = _fc_server()
    with server:
        one = np.arange(4, dtype=np.float32)
        out, = server.submit({"x": one}).result(timeout=30)
        assert out.shape == (1, 3)
        np.testing.assert_allclose(
            out, _ref(exe, scope, prog, y, one[None]), rtol=1e-5)

        batch = np.random.RandomState(0).randn(3, 4).astype(np.float32)
        out3, = server.submit({"x": batch}).result(timeout=30)
        assert out3.shape == (3, 3)  # sliced back from the padded bucket
        np.testing.assert_allclose(
            out3, _ref(exe, scope, prog, y, batch), rtol=1e-5)


def test_max_wait_ms_flushes_underfull_batch():
    # one lone request never fills a bucket; the deadline must flush it
    server, *_ = _fc_server(max_wait_ms=30.0)
    with server:
        t0 = time.perf_counter()
        server.submit({"x": np.zeros(4, np.float32)}).result(timeout=30)
        elapsed = time.perf_counter() - t0
    assert elapsed < 10.0  # deadline (30 ms) flushed it, not a hang
    snap = monitor.registry().snapshot()
    assert snap.get('serve_batches_total{bucket="1"}', 0) == 1


def test_full_bucket_flushes_before_deadline():
    # offered load == max_batch: the batcher must NOT sit out max_wait_ms
    server, exe, scope, prog, y = _fc_server(
        max_batch=4, max_wait_ms=5_000.0)
    with server:
        futs = [server.submit({"x": np.full(4, float(i), np.float32)})
                for i in range(4)]
        t0 = time.perf_counter()
        outs = [f.result(timeout=30) for f in futs]
        assert time.perf_counter() - t0 < 30.0  # << the 5 s deadline
    for i, (out,) in enumerate(outs):
        np.testing.assert_allclose(
            out, _ref(exe, scope, prog, y,
                      np.full((1, 4), float(i), np.float32)), rtol=1e-5)


def test_backpressure_rejects_beyond_max_queue_rows():
    # white-box: mark ready without starting the batcher, so the queue
    # deterministically fills instead of racing the drain
    server, *_ = _fc_server(max_batch=4, max_queue_rows=8)
    server._ready = True
    feed = {"x": np.zeros((4, 4), np.float32)}
    server.submit(feed)
    server.submit(feed)  # queue now at 8/8 rows
    with pytest.raises(serve.ServerOverloaded):
        server.submit(feed)
    snap = monitor.registry().snapshot()
    assert snap["serve_rejected_total"] == 1
    assert snap["serve_requests_total"] == 2
    server.stop()


def test_request_validation():
    server, *_ = _fc_server(max_batch=4)
    with server:
        with pytest.raises(ValueError):  # oversize must split client-side
            server.submit({"x": np.zeros((5, 4), np.float32)})
        with pytest.raises(ValueError):  # rank matches neither form
            server.submit({"x": np.zeros((1, 1, 4), np.float32)})
        with pytest.raises(ValueError):  # missing feed
            server.submit({})
        with pytest.raises(ValueError):  # unknown name
            server.submit({"x": np.zeros(4, np.float32),
                           "bogus": np.zeros(1)})


def test_submit_before_start_and_after_stop():
    server, *_ = _fc_server()
    with pytest.raises(serve.ServeError):
        server.submit({"x": np.zeros(4, np.float32)})
    server.start()
    server.stop()
    with pytest.raises(serve.ServerClosed):
        server.submit({"x": np.zeros(4, np.float32)})


def test_warmup_precompiles_every_bucket_no_steady_state_misses():
    server, *_ = _fc_server(max_batch=4)
    server.start()
    # warm-up prepared one step per bucket (interpreted on the CPU)
    assert server._warm_entries == len(server.config.buckets) == 3
    assert server.step_modes() == {b: ["interpreter"] for b in (1, 2, 4)}
    misses_after_warm = server.stats()["compile_cache"]["l1_misses"]
    # every admissible request size, twice over
    for rows in (1, 2, 3, 4, 1, 2, 3, 4):
        server.submit(
            {"x": np.zeros((rows, 4), np.float32)}).result(timeout=30)
    stats = server.stats()
    assert stats["compile_cache"]["l1_misses"] == misses_after_warm
    assert stats["steady_state_compiles"] == 0
    server.stop()


def test_concurrent_clients_get_their_own_rows():
    server, exe, scope, prog, y = _fc_server(max_batch=8, max_wait_ms=2.0)
    results = {}
    with server:
        def client(i):
            v = np.full((4,), float(i), dtype=np.float32)
            out, = server.submit({"x": v}).result(timeout=60)
            results[i] = out

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(results) == 24
    for i in range(24):
        want = _ref(exe, scope, prog, y,
                    np.full((1, 4), float(i), np.float32))
        np.testing.assert_allclose(results[i], want, rtol=1e-5)
    # coalescing actually happened: fewer batches than requests
    snap = monitor.registry().snapshot()
    batches = sum(v for k, v in snap.items()
                  if k.startswith("serve_batches_total"))
    assert batches < 24
    assert snap["serve_rows_total"] == 24


def test_multi_replica_round_robin():
    server, exe, scope, prog, y = _fc_server(max_batch=2, replicas=2)
    with server:
        # sequential submits -> one batch each -> strict replica alternation
        for i in range(4):
            v = np.full((4,), float(i), dtype=np.float32)
            out, = server.submit({"x": v}).result(timeout=30)
            np.testing.assert_allclose(
                out, _ref(exe, scope, prog, y, v[None]), rtol=1e-5)
    snap = monitor.registry().snapshot()
    assert snap['serve_replica_requests_total{replica="0"}'] == 2
    assert snap['serve_replica_requests_total{replica="1"}'] == 2
    # replica 1 serves from its own copies of the weights
    (_, s0), (_, s1) = server._replicas
    for n in ("fc_0.w_0", "fc_0.w_1"):
        assert s1.find_var(n) is not s0.find_var(n)
        assert torch.equal(s1.find_var(n), s0.find_var(n))


def test_stop_fails_queued_requests():
    server, *_ = _fc_server(max_batch=4, max_queue_rows=8)
    server._ready = True  # queue without a batcher draining
    fut = server.submit({"x": np.zeros(4, np.float32)})
    server.stop()
    with pytest.raises(serve.ServerClosed):
        fut.result(timeout=5)


def test_stats_and_percentiles_shape():
    server, *_ = _fc_server()
    with server:
        for _ in range(5):
            server.submit({"x": np.zeros(4, np.float32)}).result(timeout=30)
        stats = server.stats()
    assert stats["requests"] == 5
    for key in ("p50_ms", "p95_ms", "p99_ms"):
        assert stats[key] is not None and stats[key] >= 0.0
    assert stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"]
    pct = server.latency_percentiles(50, 99)
    assert set(pct) == {50, 99}


def test_reset_stats_measures_one_load_at_a_time():
    server, *_ = _fc_server()
    with server:
        for _ in range(3):
            server.submit({"x": np.zeros(4, np.float32)}).result(timeout=30)
        server.reset_stats()
        assert server.stats()["requests"] == 0
        assert np.isnan(server.stats()["p50_ms"])
        server.submit({"x": np.zeros((3, 4), np.float32)}).result(timeout=30)
        stats = server.stats()
    assert stats["requests"] == 1 and stats["rows"] == 3
    assert stats["padded_rows"] == 1 and stats["pad_fraction"] == 0.25
    assert stats["steady_state_compiles"] == 0
    # the process registry keeps counting across the reset
    assert monitor.registry().snapshot()["serve_requests_total"] == 4


def test_cancelled_future_does_not_kill_worker():
    # a client that gives up (result(timeout) expired -> Future.cancel())
    # leaves a CANCELLED future in the batch; the worker must survive it
    # and still resolve the other requests in the same batch
    server, exe, scope, prog, y = _fc_server(max_batch=4)
    server._build_replicas()
    cancelled = serve_engine._Request(
        {"x": np.zeros((1, 4), np.float32)}, 1)
    assert cancelled.future.cancel()
    live = serve_engine._Request({"x": np.ones((1, 4), np.float32)}, 1)
    feed = {"x": np.concatenate([cancelled.feed["x"], live.feed["x"]])}
    q = serve_engine._BoundedQueue(2)
    q.put(([cancelled, live], feed, 2, 2, 0.0))
    q.close()
    server._worker(0, q)  # returns after draining; must not raise
    out, = live.future.result(timeout=0)
    np.testing.assert_allclose(
        out, _ref(exe, scope, prog, y, np.ones((1, 4), np.float32)),
        rtol=1e-5)


def test_bounded_queue_close_unblocks_put_and_drains_get():
    q = serve_engine._BoundedQueue(1)
    q.put("a")
    outcome = []

    def blocked_put():
        try:
            q.put("b")
        except serve.ServerClosed:
            outcome.append("closed")

    t = threading.Thread(target=blocked_put)
    t.start()
    time.sleep(0.05)  # let the put block on the full queue
    q.close()
    t.join(timeout=10)
    assert not t.is_alive() and outcome == ["closed"]
    assert q.get() == "a"   # pre-close items still drain
    assert q.get() is None  # then the close is reported


def test_stop_fails_batches_left_in_dispatch_queues():
    # a batch stranded in a dispatch queue (worker gone) must not leave
    # its futures unresolved after stop()
    server, *_ = _fc_server()
    req = serve_engine._Request({"x": np.zeros((1, 4), np.float32)}, 1)
    q = serve_engine._BoundedQueue(2)
    q.put(([req], req.feed, 1, 1, 0.0))
    server._dispatch_queues.append(q)
    server.stop()
    with pytest.raises(serve.ServerClosed):
        req.future.result(timeout=5)


def test_two_servers_keep_stats_separate():
    s1, *_ = _fc_server()
    s2, *_ = _fc_server()
    with s1, s2:
        for _ in range(3):
            s1.submit({"x": np.zeros(4, np.float32)}).result(timeout=30)
        s2.submit({"x": np.ones(4, np.float32)}).result(timeout=30)
        st1, st2 = s1.stats(), s2.stats()
    assert st1["requests"] == 3 and st1["rows"] == 3
    assert st2["requests"] == 1 and st2["rows"] == 1
    assert s1.latency_percentiles(50)[50] is not None
    # the shared registry still aggregates across both servers
    assert monitor.registry().snapshot()["serve_requests_total"] == 4


def test_queue_rows_gauge_tracks_drain():
    server, *_ = _fc_server()
    with server:
        server.submit({"x": np.zeros(4, np.float32)}).result(timeout=30)
        # the result resolving implies the batcher flushed the queue; the
        # gauge must reflect the drained depth, not submit's high water
        assert monitor.registry().gauge("serve_queue_rows").value == 0


def test_from_inference_model_factory(tmp_path):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(input=x, size=3)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    with fluid.program_guard(prog, startup):
        fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe)
    ref = exe.run(prog, feed={"x": np.ones((1, 4), np.float32)},
                  fetch_list=[y])[0]

    server = serve.Server.from_inference_model(
        str(tmp_path), place=fluid.CPUPlace())
    with server:
        out, = server.submit({"x": np.ones(4, np.float32)}).result(
            timeout=30)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_model_set_dispatches_by_name():
    s1, exe, scope, prog, y = _fc_server()
    s2, *_ = _fc_server(out=5)
    models = serve.ModelSet({"a": s1, "b": s2})
    with models:
        one = np.ones(4, np.float32)
        a, = models.infer({"x": one}, timeout=30)
        b, = models.infer({"x": one}, model="b", timeout=30)
        with pytest.raises(serve.UnknownModel):
            models.submit({"x": one}, model="c")
        stats = models.stats()
    np.testing.assert_allclose(a, _ref(exe, scope, prog, y, one[None]),
                               rtol=1e-5)
    assert b.shape == (1, 5)
    assert stats["requests"] == 2 and stats["steady_state_compiles"] == 0
    assert stats["default_model"] == "a"


# ---------------------------------------------------------------------------
# HTTP frontend
# ---------------------------------------------------------------------------

def test_http_frontend_round_trip():
    server, exe, scope, prog, y = _fc_server()
    with server:
        httpd = make_http_server(server, port=0)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz") as r:
                assert r.status == 200
            body = json.dumps(
                {"inputs": {"x": [1.0, 2.0, 3.0, 4.0]}}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/infer", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                out = np.asarray(json.loads(r.read())["outputs"][0])
            want = _ref(exe, scope, prog, y,
                        np.array([[1.0, 2.0, 3.0, 4.0]], np.float32))
            np.testing.assert_allclose(out, want, rtol=1e-5)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats") as r:
                stats = json.loads(r.read())
            assert stats["requests"] >= 1
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics") as r:
                assert b"serve_request_ms" in r.read()
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_http_non_object_body_is_400():
    # valid JSON that is not an object must be a 400, not a dropped
    # connection from an AttributeError inside the handler
    server, *_ = _fc_server()
    with server:
        httpd = make_http_server(server, port=0)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            for body in (b"[1, 2]", b'"x"', b"not json at all"):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/infer", data=body,
                    headers={"Content-Type": "application/json"})
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req)
                assert ei.value.code == 400
        finally:
            httpd.shutdown()
            httpd.server_close()


# ---------------------------------------------------------------------------
# graceful drain (lame-duck) + the load-balancer-shaped failure mapping
# ---------------------------------------------------------------------------

def test_drain_serves_backlog_then_refuses_new_work():
    # a long max_wait + underfull batch = requests still queued/held when
    # drain hits; sealing must SERVE them (stop() would fail them)
    server, exe, scope, prog, y = _fc_server(max_batch=8,
                                             max_wait_ms=2000.0)
    server.start()
    futs = [server.submit({"x": np.full(4, float(i), np.float32)})
            for i in range(3)]
    t0 = time.perf_counter()
    assert server.drain(timeout=30.0)
    # the seal also short-circuits the batching wait: no 2 s linger
    assert time.perf_counter() - t0 < 10.0
    # the backlog was SERVED, not failed — that's drain vs stop
    for i, fut in enumerate(futs):
        out, = fut.result(timeout=0)
        np.testing.assert_allclose(
            out, _ref(exe, scope, prog, y,
                      np.full((1, 4), float(i), np.float32)), rtol=1e-5)
    assert server.state() == "stopped"
    with pytest.raises(serve.ServerClosed):
        server.submit({"x": np.zeros(4, np.float32)})


def test_draining_server_rejects_submit_with_server_draining():
    server, *_ = _fc_server()
    with server:
        server._draining = True  # lame-duck flag alone gates admission
        with pytest.raises(serve.ServerDraining):
            server.submit({"x": np.zeros(4, np.float32)})
        server._draining = False
    # ServerDraining IS a ServerClosed: existing handlers keep working
    assert issubclass(serve.ServerDraining, serve.ServerClosed)


def test_drain_is_idempotent_and_updates_state_telemetry():
    server, *_ = _fc_server()
    server.start()
    server.submit({"x": np.zeros(4, np.float32)}).result(timeout=30)
    assert server.state() == "serving" and not server.draining()
    assert server.drain(timeout=30.0)
    assert server.drain(timeout=30.0)  # second drain: already stopped
    snap = monitor.registry().snapshot()
    assert snap["serve_drains_total"] == 1
    assert snap["serve_draining"] == 0
    assert snap["serve_drain_duration_ms"] >= 0.0
    assert server.stats()["state"] == "stopped"


def _http_fixture(server):
    httpd = make_http_server(server, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, port


def _post_infer(port, body=None):
    body = body if body is not None else json.dumps(
        {"inputs": {"x": [[1.0, 2.0, 3.0, 4.0]]}}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/infer", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers)


def test_http_overloaded_is_503_with_retry_after():
    # a full queue is "healthy but busy": the 503 + Retry-After contract
    # is what lets a router retry elsewhere instead of giving up. No
    # batcher running (the queue stays full), same idiom as
    # test_backpressure_rejects_beyond_max_queue_rows.
    server, *_ = _fc_server(max_batch=4, max_queue_rows=4)
    server._ready = True
    server.submit({"x": np.zeros((4, 4), np.float32)})  # queue now full
    httpd, port = _http_fixture(server)
    try:
        code, headers = _post_infer(port)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()  # fails the parked request, resolving its future
    assert code == 503
    assert int(headers["Retry-After"]) >= 1


def test_http_draining_is_503_with_connection_close():
    server, *_ = _fc_server()
    with server:
        httpd, port = _http_fixture(server)
        try:
            server._draining = True
            code, headers = _post_infer(port)
            assert code == 503
            assert headers["Connection"].lower() == "close"
            # healthz mirrors the state for the prober
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz")
                assert False, "healthz must 503 while draining"
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert e.read().strip() == b"draining"
        finally:
            server._draining = False
            httpd.shutdown()
            httpd.server_close()


def test_http_stopped_is_503_with_connection_close():
    server, *_ = _fc_server()
    server.start()
    httpd, port = _http_fixture(server)
    try:
        server.stop()
        code, headers = _post_infer(port)
        assert code == 503
        assert headers["Connection"].lower() == "close"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_admin_drain_endpoint_drains_and_shuts_down():
    server, exe, scope, prog, y = _fc_server()
    server.start()
    httpd, port = _http_fixture(server)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/admin/drain", data=b"{}")
        with urllib.request.urlopen(req) as r:
            assert r.status == 202
            assert json.loads(r.read())["state"] == "draining"
        deadline = time.time() + 30
        while server.state() != "stopped" and time.time() < deadline:
            time.sleep(0.05)
        assert server.state() == "stopped"
        assert server.stats()["queue_rows"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# conv+bn folding (InferenceTranspiler) numeric equivalence
# ---------------------------------------------------------------------------

def _conv_bn_program(fl, layout, with_bias):
    prog, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(prog, startup):
        shape = [8, 8, 3] if layout == "NHWC" else [3, 8, 8]
        img = fl.layers.data(name="img", shape=shape, dtype="float32")
        conv = fl.layers.conv2d(
            input=img, num_filters=4, filter_size=3, padding=1,
            data_format=layout, bias_attr=None if with_bias else False)
        out = fl.layers.batch_norm(
            conv, is_test=True, data_layout=layout)
    return prog, startup, out


def _random_persistables(prog, shapes, rng):
    """{name: random float32 array} for the persistables of `prog` whose
    shapes `shapes` gives. bn's Variance input must stay positive (it
    feeds a sqrt); the var is named like any parameter (batch_norm_0.w_3),
    so find it via the op."""
    variance_names = set()
    for op in prog.global_block().ops:
        if op.type == "batch_norm":
            variance_names.update(op.input("Variance"))
    arrays = {}
    for name in sorted(shapes):
        if name in variance_names:
            arrays[name] = rng.uniform(0.5, 2.0, shapes[name]).astype(
                np.float32)
        else:
            arrays[name] = rng.standard_normal(shapes[name]).astype(
                np.float32)
    return arrays


def _set_all(scope, arrays, to=None):
    for n, a in arrays.items():
        scope.var(n)
        scope.set_var(n, to(a) if to else a)


def _persistable_shapes(prog, scope):
    return {n: tuple(scope.find_var(n).shape)
            for n, v in prog.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("with_bias", [True, False],
                         ids=["bias", "no_bias"])
def test_fuse_batch_norm_numeric_equivalence(layout, with_bias):
    prog, startup, out = _conv_bn_program(fluid, layout, with_bias)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        rng = np.random.RandomState(7)
        _set_all(scope, _random_persistables(
            prog, _persistable_shapes(prog, scope), rng), torch.from_numpy)
        shape = (2, 8, 8, 3) if layout == "NHWC" else (2, 3, 8, 8)
        feed = {"img": rng.standard_normal(shape).astype(np.float32)}
        before = exe.run(prog, feed=feed, fetch_list=[out])[0]
        assert np.all(np.isfinite(before))

        fluid.InferenceTranspiler().transpile(
            prog, fluid.CPUPlace(), scope=scope)
        ops = [op.type for op in prog.global_block().ops]
        assert "batch_norm" not in ops  # folded away
        # the bias add survives (with-bias) or was materialized (no-bias)
        assert ops == ["conv2d", "elementwise_add"]
        after = exe.run(prog, feed=feed, fetch_list=[out])[0]
    np.testing.assert_allclose(after, before, rtol=1e-4, atol=1e-5)


def test_fuse_batch_norm_skips_training_mode():
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3)
        fluid.layers.batch_norm(conv)  # is_test=False: must NOT fold
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.InferenceTranspiler().transpile(
            prog, fluid.CPUPlace(), scope=scope)
    assert "batch_norm" in [op.type for op in prog.global_block().ops]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("with_bias", [True, False],
                         ids=["bias", "no_bias"])
def test_folded_weights_bitwise_equal_the_jax_transpilers(layout,
                                                          with_bias):
    """The same numpy weights folded by both transpilers give the same
    bits (the same numpy float32 arithmetic), the same op list, and the
    port keeps each folded value a float32 tensor on the value's device."""
    progs = {}
    for name, fl in (("port", fluid), ("jax", jfluid)):
        progs[name] = _conv_bn_program(fl, layout, with_bias)
    tscope_, jscope_ = fluid.Scope(), jfluid.Scope()
    with fluid.scope_guard(tscope_):
        fluid.Executor(fluid.CPUPlace()).run(progs["port"][1])
    arrays = _random_persistables(
        progs["port"][0], _persistable_shapes(progs["port"][0], tscope_),
        np.random.RandomState(11))
    _set_all(tscope_, arrays, torch.from_numpy)
    _set_all(jscope_, arrays)
    fluid.InferenceTranspiler().transpile(progs["port"][0],
                                          fluid.CPUPlace(), scope=tscope_)
    jfluid.InferenceTranspiler().transpile(progs["jax"][0],
                                           jfluid.CPUPlace(), scope=jscope_)
    assert progs["port"][0].desc_str() == progs["jax"][0].desc_str()
    names = sorted(_persistable_shapes(progs["port"][0], tscope_))
    assert names == sorted(
        n for n, v in progs["jax"][0].global_block().vars.items()
        if v.persistable and jscope_.find_var(n) is not None)
    for n in names:
        t = tscope_.find_var(n)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jscope_.find_var(n)), err_msg=n)


# ---------------------------------------------------------------------------
# Inferencer: the parallel path's card flag follows the place
# ---------------------------------------------------------------------------

def _save_params_for_infer_func(tmp_path, fl=fluid):
    prog, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(prog, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        fl.layers.fc(input=x, size=3)
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup)
    with fl.program_guard(prog, startup):
        fl.io.save_params(exe, str(tmp_path), main_program=prog)


def _infer_func():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    return fluid.layers.fc(input=x, size=3)


def _jax_infer_func():
    x = jfluid.layers.data(name="x", shape=[4], dtype="float32")
    return jfluid.layers.fc(input=x, size=3)


@pytest.mark.parametrize("place,want_cuda", [
    (fluid.CPUPlace(), False),
    # the JAX case's TPUPlace(0) -> use_tpu=True, in its CUDA meaning
    pytest.param(fluid.CUDAPlace(0), True, marks=pytest.mark.cuda),
])
def test_inferencer_parallel_accel_follows_place(tmp_path, place, want_cuda,
                                                 monkeypatch):
    if want_cuda and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NCCL-backed ParallelExecutor")
    _save_params_for_infer_func(tmp_path)
    captured = {}
    real_init = fluid.ParallelExecutor.__init__

    def spy_init(self, *args, **kwargs):
        captured.update(kwargs)
        return real_init(self, *args, **kwargs)

    monkeypatch.setattr(fluid.ParallelExecutor, "__init__", spy_init)
    inferencer = fluid.Inferencer(
        infer_func=_infer_func, param_path=str(tmp_path), place=place,
        parallel=True)
    assert captured.get("use_cuda") is want_cuda
    out = inferencer.infer({"x": np.ones((8, 4), np.float32)})
    assert np.asarray(out[0]).shape[-1] == 3


def test_inferencer_serve_convenience(tmp_path):
    _save_params_for_infer_func(tmp_path)
    inferencer = fluid.Inferencer(
        infer_func=_infer_func, param_path=str(tmp_path),
        place=fluid.CPUPlace())
    want = inferencer.infer({"x": np.ones((1, 4), np.float32)})[0]
    server = inferencer.serve(
        config=serve.ServeConfig(max_batch=2), start=True)
    try:
        got, = server.submit({"x": np.ones(4, np.float32)}).result(
            timeout=30)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    finally:
        server.stop()


def _conv_bn_infer_func():
    img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                               padding=1, bias_attr=False)
    bn = fluid.layers.batch_norm(conv, act="relu")
    return fluid.layers.fc(input=bn, size=3)


def test_infer_func_programs_run_in_test_mode(tmp_path):
    """Inferencer and Server.from_infer_func build the infer_func's
    program in test mode, as the reference Inferencer clones it: its
    batch_norm reads the saved running statistics (a row's result does not
    depend on its batch), and the InferenceTranspiler folds it. (The JAX
    package builds them in the layers' training mode, where batch_norm
    normalises over the batch and is never folded.)"""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        out = _conv_bn_infer_func()
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    rs = np.random.RandomState(3)
    x = rs.standard_normal((3, 3, 8, 8)).astype(np.float32)
    with fluid.scope_guard(scope):
        exe.run(startup)
        _set_all(scope, _random_persistables(
            prog, _persistable_shapes(prog, scope), rs), torch.from_numpy)
        fluid.io.save_params(exe, str(tmp_path), prog)
        want = exe.run(prog.clone(for_test=True), feed={"img": x},
                       fetch_list=[out])[0]
    inferencer = fluid.Inferencer(_conv_bn_infer_func, str(tmp_path),
                                  place=fluid.CPUPlace())
    bns = [op for op in inferencer.inference_program.global_block().ops
           if op.type == "batch_norm"]
    assert len(bns) == 1 and bns[0].attrs["is_test"]
    np.testing.assert_allclose(inferencer.infer({"img": x})[0], want,
                               rtol=1e-5, atol=1e-6)
    for transpile in (False, True):
        server = serve.Server.from_infer_func(
            _conv_bn_infer_func, str(tmp_path), place=fluid.CPUPlace(),
            config=serve.ServeConfig(max_batch=4), transpile=transpile)
        ops = [op for op in server.program.global_block().ops]
        assert ("batch_norm" in [op.type for op in ops]) != transpile
        assert all(op.attrs["is_test"] for op in ops
                   if op.type == "batch_norm")
        with server:
            got = np.concatenate([server.infer({"img": row}, timeout=30)[0]
                                  for row in x])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_no_place_means_the_card_and_raises_without_one(tmp_path):
    """check_and_get_place(None) is CUDAPlace(0): with no card the
    Inferencer and the Server raise instead of running on the CPU (the
    JAX package falls back to its CPUPlace there)."""
    from paddle_tpu_torch.trainer import check_and_get_place

    if torch.cuda.is_available():
        assert check_and_get_place(None) == fluid.CUDAPlace(0)
        pytest.skip("a card is present: no place is the card, which runs")
    _save_params_for_infer_func(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_and_get_place(None)
    assert check_and_get_place(fluid.CPUPlace()) == fluid.CPUPlace()
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Inferencer(infer_func=_infer_func, param_path=str(tmp_path))
    prog = fluid.Program()
    with fluid.program_guard(prog):
        y = _infer_func()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.Server(prog, ["x"], [y])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.Server.from_infer_func(_infer_func, str(tmp_path))


# ---------------------------------------------------------------------------
# batcher fairness: held/aged requests never get a fresh window
# ---------------------------------------------------------------------------

def test_batcher_held_request_window_not_reopened():
    """Regression: the batching window is anchored at the oldest
    member's SUBMIT time. A request carried over from a previous batch
    (held) or aged in the queue has already spent its window and must
    flush at once; re-stamping it with a fresh max_wait_ms let a steady
    trickle of full buckets starve an underfull remainder indefinitely."""
    server, exe, scope, prog, y = _fc_server(max_batch=4,
                                             max_wait_ms=5000.0)
    with server:
        batch = np.ones((3, 4), dtype="float32")
        a = serve_engine._Request({"x": batch}, 3)
        b = serve_engine._Request({"x": batch}, 3)
        # forge both as submitted long ago — their window is spent
        a.t_submit -= 10.0
        b.t_submit -= 10.0
        server._queue.put(a)
        server._queue.put(b)
        # a (3 rows) flushes with b held (3+3 > max_batch); b must then
        # flush immediately too — far inside the 5 s fresh window the
        # old code would have granted it
        ra = a.future.result(timeout=2.0)
        rb = b.future.result(timeout=2.0)
    ref = _ref(exe, scope, prog, y, batch)
    assert np.array_equal(ra[0], ref)
    assert np.array_equal(rb[0], ref)


# ---------------------------------------------------------------------------
# against the JAX package's Server
# ---------------------------------------------------------------------------

def test_served_rows_match_the_jax_server(tmp_path):
    """One parameter directory, saved by the JAX package, served by both
    packages' Servers (from_infer_func, folding off) on the CPU: the same
    requests give the same rows within rtol 1e-4."""
    _save_params_for_infer_func(tmp_path, jfluid)
    cfg = dict(max_batch=4, max_wait_ms=1.0)
    rs = np.random.RandomState(5)
    requests = [rs.randn(r, 4).astype(np.float32) for r in (1, 3, 2, 4, 1)]
    got = {}
    for name, mod, place, func in (
            ("port", serve, fluid.CPUPlace(), _infer_func),
            ("jax", jserve, jfluid.CPUPlace(), _jax_infer_func)):
        server = mod.Server.from_infer_func(
            func, str(tmp_path), place=place,
            config=mod.ServeConfig(**cfg), transpile=False)
        with server:
            got[name] = [server.submit({"x": r}).result(timeout=60)[0]
                         for r in requests]
            assert server.stats()["steady_state_compiles"] == 0
    for t, j in zip(got["port"], got["jax"]):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the graph path: warm-up captures every bucket
# ---------------------------------------------------------------------------

def _graph_path_case(place):
    """A started fc server on `place` whose buckets (1, 2, 4) the warm-up
    captured, after mixed traffic: (server, exe, scope, prog, y)."""
    server, exe, scope, prog, y = _fc_server(max_batch=4, place=place)
    server.start()
    assert server.step_modes() == {b: ["graph"] for b in (1, 2, 4)}
    # one prepared step and one captured graph per bucket
    assert server._warm_entries == 6
    rep_exe, rep_scope = server._replicas[0]
    assert len(rep_exe.captured_steps(prog, rep_scope)) == 3
    rs = np.random.RandomState(2)
    for rows in (1, 2, 3, 4, 3, 1):
        x = rs.randn(rows, 4).astype(np.float32)
        out, = server.submit({"x": x}).result(timeout=60)
        with flags.flag_guard(cuda_graph=False):
            np.testing.assert_allclose(
                out, _ref(exe, scope, prog, y, x), rtol=1e-5, atol=1e-6)
    stats = server.stats()
    assert stats["steady_state_compiles"] == 0
    info = rep_exe.compile_cache_info()
    assert info["misses"] == 6  # 3 prepares + 3 captures, all in warm-up
    return server, exe, scope, prog, y


def _load_after_warmup_case(place, tmp_path):
    """load_params after warm-up replaces the scope's tensors; the next
    served result follows the loaded weights (CapturedStep.sync_scope
    carries them into the graph's tensors), with no new capture."""
    server, exe, scope, prog, y = _fc_server(max_batch=2, place=place)
    x = np.arange(4, dtype=np.float32)
    with server:
        before, = server.submit({"x": x}).result(timeout=60)
        new = {"fc_0.w_0": np.full((4, 3), 0.5, np.float32),
               "fc_0.w_1": np.array([1.0, -1.0, 2.0], np.float32)}
        for n, a in new.items():
            np.save(str(tmp_path / n) + ".npy", a)
        with fluid.scope_guard(server.scope):
            fluid.io.load_params(fluid.Executor(place), str(tmp_path), prog)
        after, = server.submit({"x": x}).result(timeout=60)
        assert server.stats()["steady_state_compiles"] == 0
    want = x[None] @ new["fc_0.w_0"] + new["fc_0.w_1"]
    np.testing.assert_allclose(after, want, rtol=1e-6)
    assert not np.allclose(before, want)


def _amp_toggle_case(place):
    """amp toggled after start() is a new key: one new prepare and one
    new capture, counted as steady-state compiles."""
    server, *_ = _fc_server(max_batch=1, place=place)
    with server:
        server.infer({"x": np.ones(4, np.float32)}, timeout=60)
        assert server.stats()["steady_state_compiles"] == 0
        tamp.enable("bfloat16")
        try:
            server.infer({"x": np.ones(4, np.float32)}, timeout=60)
            server.infer({"x": np.ones(4, np.float32)}, timeout=60)
        finally:
            tamp.disable()
        assert server.stats()["steady_state_compiles"] == 2


def test_warmup_captures_every_bucket_on_the_graph_path(recorded_graphs):
    server, *_ = _graph_path_case(fluid.CPUPlace())
    server.stop()


def test_load_params_after_warmup_reaches_the_next_result(recorded_graphs,
                                                          tmp_path):
    _load_after_warmup_case(fluid.CPUPlace(), tmp_path)


def test_amp_toggled_after_start_counts_as_a_compile(recorded_graphs):
    _amp_toggle_case(fluid.CPUPlace())


@pytest.mark.cuda
def test_server_on_the_card_captures_every_bucket(cuda_device):
    """On CUDAPlace(0): every bucket a captured CUDA graph at start(), the
    served rows those of the interpreter, zero steady-state compiles after
    mixed traffic; the replays ran in the worker thread, under the
    executor's own device."""
    server, *_ = _graph_path_case(fluid.CUDAPlace(0))
    try:
        assert any(t.name == "serve-worker-0" for t in server._threads)
    finally:
        server.stop()


@pytest.mark.cuda
def test_load_params_after_warmup_on_the_card(cuda_device, tmp_path):
    _load_after_warmup_case(fluid.CUDAPlace(0), tmp_path)


@pytest.mark.cuda
def test_amp_toggle_on_the_card(cuda_device):
    _amp_toggle_case(fluid.CUDAPlace(0))
