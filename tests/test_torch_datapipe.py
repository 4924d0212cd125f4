"""paddle_tpu_torch.datapipe against the JAX package's datapipe.

The counterparts of tests/test_datapipe.py on the port (shards, thread
and process decode, order, backpressure, errors, the batcher's tail
modes, staging into host tensors with CPUPlace(), the shared-memory
fusion, close mid-stream), and cross-package checks: the same pipe spec
over the same RecordIO file yields the same sample sequence from both
packages, sharded and not, with order kept; stats() has the same keys; a
forked decode worker never initialises CUDA.
"""

import multiprocessing
import pickle
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import datapipe as jdatapipe

import paddle_tpu_torch as fluid
from paddle_tpu_torch import datapipe, recordio
from paddle_tpu_torch.datapipe import shm as tshm

DEADLINE_S = 5.0


@pytest.fixture(autouse=True)
def no_port_datapipe_leaks():
    """Fail the test if it leaks datapipe workers of either package:
    threads (datapipe-*), worker processes (datapipe-*) or the port's
    shared-memory segments; every wait has a deadline."""

    def threads():
        return {t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("datapipe-")}

    def procs():
        return {p for p in multiprocessing.active_children()
                if p.name.startswith("datapipe-") and p.is_alive()}

    before = (threads(), procs(), set(tshm.live_segments()))
    yield
    deadline = time.time() + DEADLINE_S
    while True:
        leaked = (threads() - before[0], procs() - before[1],
                  set(tshm.live_segments()) - before[2])
        if not any(leaked) or time.time() > deadline:
            break
        time.sleep(0.05)
    assert not any(leaked), f"leaked datapipe workers: {leaked}"


def _write_recordio(path, payloads, module=recordio):
    with module.Writer(str(path), max_num_records=4) as w:
        for p in payloads:
            w.write(p)


def _host(v):
    """A staged value (torch tensor or jax array) as numpy."""
    return v.numpy() if hasattr(v, "numpy") and not isinstance(
        v, np.ndarray) and type(v).__module__.startswith("torch") \
        else np.asarray(v)


# -- sharded sources -------------------------------------------------------
def test_recordio_shards_disjoint_and_complete(tmp_path):
    """Record i belongs to shard i % num_shards, the stride spans file
    boundaries, and the shards partition the record stream exactly."""
    p1, p2 = tmp_path / "a.recordio", tmp_path / "b.recordio"
    all_recs = [b"rec-%03d" % i for i in range(23)]
    _write_recordio(p1, all_recs[:13])
    _write_recordio(p2, all_recs[13:])
    shards = [list(datapipe.RecordIOSource([str(p1), str(p2)], num_shards=3,
                                           shard_index=idx, batch_read=4))
              for idx in range(3)]
    for idx, got in enumerate(shards):
        assert got == all_recs[idx::3]
    assert sorted(b for s in shards for b in s) == sorted(all_recs)


def test_generator_source_shard_override():
    pipe = datapipe.DataPipe.from_reader(lambda: iter(range(10)))
    assert list(pipe.shard(2, 0)) == [0, 2, 4, 6, 8]
    assert list(pipe.shard(2, 1)) == [1, 3, 5, 7, 9]
    assert list(pipe) == list(range(10))


def test_default_shards_follow_torch_distributed():
    """Without a torch.distributed group the default is one shard; the JAX
    package's default (jax.process_count) is one shard here too."""
    assert datapipe.default_shard_assignment() == (1, 0)
    assert jdatapipe.default_shard_assignment() == (1, 0)


# -- parallel map ----------------------------------------------------------
def test_parallel_map_preserves_order():
    delays = np.random.RandomState(0).uniform(0., 0.004, 60)

    def slow_sq(i):
        time.sleep(delays[i])
        return i * i

    out = list(datapipe.ParallelMap(range(60), slow_sq, num_workers=4))
    assert out == [i * i for i in range(60)]


def test_parallel_map_unordered_completes():
    out = list(datapipe.ParallelMap(range(40), lambda i: i,
                                    num_workers=4, order=False))
    assert sorted(out) == list(range(40))


def _bounded_pull(stage_cls, fn, **kw):
    pulled = []

    def src():
        for i in range(60):
            pulled.append(i)
            yield i

    it = iter(stage_cls(src(), fn, num_workers=2, buffer_size=4, **kw))
    consumed = max_excess = 0
    for _ in it:
        consumed += 1
        time.sleep(0.003)  # slow consumer
        max_excess = max(max_excess, len(pulled) - consumed)
        if consumed >= 25:
            break
    it.close()
    return max_excess


def test_parallel_map_backpressure_bounds_inflight():
    # tickets bound in-flight to buffer_size; +1 for the racing pull
    assert _bounded_pull(datapipe.ParallelMap, lambda i: i) <= 5


def test_parallel_map_worker_error_propagates():
    def boom(i):
        if i == 7:
            raise ValueError("decode failed on 7")
        return i

    with pytest.raises(ValueError, match="decode failed"):
        for _ in datapipe.ParallelMap(range(20), boom, num_workers=3):
            pass


# -- batcher tail modes ----------------------------------------------------
def test_batcher_drop_remainder_vs_pad():
    samples = [{"x": np.full((3,), i, np.float32)} for i in range(10)]
    dropped = list(datapipe.Batcher(iter(samples), batch_size=4))
    assert len(dropped) == 2
    for bi, b in enumerate(dropped):
        np.testing.assert_array_equal(
            b["x"][:, 0], np.arange(bi * 4, bi * 4 + 4, dtype=np.float32))
    padded = list(datapipe.Batcher(iter(samples), batch_size=4,
                                   pad_to_batch=True))
    assert [int(b["__valid__"].sum()) for b in padded] == [4, 4, 2]
    np.testing.assert_array_equal(padded[2]["__valid__"],
                                  [True, True, False, False])
    np.testing.assert_array_equal(padded[2]["x"][:, 0], [8, 9, 9, 9])


def test_pad_to_batch_mask_excludes_pad_rows_from_mean_loss():
    """A padded tail batch's masked mean, computed in the step from the
    staged __valid__ mask, is the mean over the real rows only."""
    samples = [{"x": np.full((1,), float(i), np.float32)} for i in range(6)]
    pipe = (datapipe.DataPipe.from_reader(lambda: iter(samples))
            .batch(4, drop_remainder=False, pad_to_batch=True)
            .prefetch_to_device(place=fluid.CPUPlace(), chunk=1,
                                capacity=2))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[1], dtype="float32")
        valid = fluid.layers.data(name="__valid__", shape=[-1],
                                  append_batch_size=False, dtype="bool")
        w = fluid.layers.cast(valid, "float32")
        per_row = fluid.layers.reduce_sum(x, dim=1)
        masked_mean = fluid.layers.elementwise_div(
            fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(per_row, w)),
            fluid.layers.reduce_sum(w))
    exe = fluid.Executor(fluid.CPUPlace())
    means = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        while True:
            try:
                out, = exe.run(main, feed=pipe, fetch_list=[masked_mean])
            except StopIteration:
                break
            means.extend(np.asarray(out).ravel().tolist())
    pipe.close()
    np.testing.assert_allclose(means, [1.5, 4.5], rtol=1e-6)


def test_batcher_ring_reuse_does_not_alias_emitted_batches():
    samples = [{"x": np.full((2,), i, np.float32)} for i in range(12)]
    batches = list(datapipe.Batcher(iter(samples), batch_size=2, ring=2))
    for bi, b in enumerate(batches):
        np.testing.assert_array_equal(b["x"][:, 0], [2 * bi, 2 * bi + 1])


# -- staging + shutdown ----------------------------------------------------
def _wait_threads(base):
    deadline = time.time() + DEADLINE_S
    while threading.active_count() > base and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= base, \
        [t.name for t in threading.enumerate()]


def test_full_pipe_order_shutdown_and_stats():
    """map -> batch -> prefetch_to_device(CPUPlace()): chunks arrive in
    order as [K, ...] host tensors, workers are reaped on exhaustion and
    on early close, every stage shows in stats()."""
    import torch

    base = threading.active_count()

    def make_pipe():
        return (datapipe.DataPipe
                .from_reader(lambda: iter(
                    {"x": np.full((2,), i, np.float32)} for i in range(64)))
                .map(lambda s: {"x": s["x"] + 1.0}, num_workers=3)
                .batch(4)
                .prefetch_to_device(place=fluid.CPUPlace(), chunk=2,
                                    capacity=2, transfer_threads=2))

    pipe = make_pipe()
    chunks = list(pipe)
    assert len(chunks) == 8
    for ci, ch in enumerate(chunks):
        assert isinstance(ch["x"], torch.Tensor)
        assert tuple(ch["x"].shape) == (2, 4, 2)
        np.testing.assert_array_equal(
            ch["x"][:, :, 0].reshape(-1).numpy(),
            np.arange(ci * 8, ci * 8 + 8, dtype=np.float32) + 1.0)
    _wait_threads(base)
    st = pipe.stats()
    assert (st["map"]["items"], st["batch"]["items"], st["stack"]["items"],
            st["transfer"]["items"]) == (64, 16, 16, 8)
    assert "fractions" in st
    it = iter(make_pipe())
    next(it)
    next(it)
    it.close()
    _wait_threads(base)


def test_feeder_backpressure_capacity_bound():
    pulled = []

    def src():
        for i in range(40):
            pulled.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    it = iter(datapipe.AsyncDeviceFeeder(src(), chunk=2,
                                         place=fluid.CPUPlace(), capacity=2,
                                         transfer_threads=2))
    next(it)
    time.sleep(0.3)
    assert len(pulled) <= 2 * (1 + 2 + 1), pulled
    it.close()


def test_pipe_next_feed_reset():
    pipe = (datapipe.DataPipe
            .from_reader(lambda: iter(
                {"x": np.full((2,), i, np.float32)} for i in range(8)))
            .batch(2)
            .prefetch_to_device(place=fluid.CPUPlace(), chunk=2))
    assert pipe.feed_iters == 2
    first = pipe.next_feed()["x"].numpy().copy()
    second = pipe.next_feed()["x"].numpy().copy()
    assert first[0, 0, 0] == 0.0 and second[0, 0, 0] == 4.0
    with pytest.raises(StopIteration):
        pipe.next_feed()
    pipe.reset()
    np.testing.assert_array_equal(pipe.next_feed()["x"].numpy(), first)
    pipe.close()


def test_legacy_reader_adapter_through_executor():
    """fluid.reader.to_datapipe adapts a positional-tuple reader; the
    Executor takes the pipe as feed= and defaults iters to
    pipe.feed_iters."""

    def reader():
        for i in range(16):
            yield (np.full((3,), i, np.float32),)

    pipe = (fluid.reader.to_datapipe(reader, ["x"])
            .batch(4)
            .prefetch_to_device(place=fluid.CPUPlace(), chunk=2,
                                capacity=2))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.scale(x, scale=2.0)
    exe = fluid.Executor(fluid.CPUPlace())
    outs = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        while True:
            try:
                out, = exe.run(main, feed=pipe, fetch_list=[y])
            except StopIteration:
                break
            outs.append(np.asarray(out))
    assert len(outs) == 2 and outs[0].shape == (2, 4, 3)
    flat = np.concatenate([o.reshape(-1, 3) for o in outs])
    np.testing.assert_allclose(flat[:, 0], 2.0 * np.arange(16))
    pipe.close()


def test_feeder_staged_items_do_not_alias_reused_host_buffers():
    """A staged item survives the upstream reader refilling its one
    reused buffer (and the feeder refilling its staging buffer)."""
    buf = np.empty((16,), np.float32)

    def src():
        for i in range(6):
            buf[:] = float(i)
            yield {"x": buf}

    staged = list(datapipe.AsyncDeviceFeeder(
        src(), place=fluid.CPUPlace(), capacity=2, transfer_threads=1,
        donate=False))
    assert [float(s["x"][0]) for s in staged] == [0., 1., 2., 3., 4., 5.]


# -- process-pool decode ---------------------------------------------------
def _pm_slow_sq(i):
    time.sleep((i * 37 % 10) / 2500.0)
    return i * i


def _pm_ident(i):
    return i


def _pm_boom(i):
    if i == 7:
        raise ValueError("decode failed on 7")
    return i


def _pm_decode(i):
    return {"data": np.full((4, 6), i % 251, np.uint8),
            "label": np.full((4, 1), i % 10, np.int64)}


def _pm_cuda_state(i):
    import torch

    return {"i": np.array([i], np.int64),
            "cuda": np.array([torch.cuda.is_initialized()])}


def test_process_map_preserves_order():
    out = list(datapipe.ProcessPoolMap(range(40), _pm_slow_sq,
                                       num_workers=3))
    assert out == [i * i for i in range(40)]


def test_process_map_unordered_completes():
    out = list(datapipe.ProcessPoolMap(range(30), _pm_ident, num_workers=3,
                                       order=False))
    assert sorted(out) == list(range(30))


def test_process_map_worker_error_propagates():
    it = iter(datapipe.ProcessPoolMap(range(20), _pm_boom, num_workers=2))
    with pytest.raises(ValueError, match="decode failed on 7"):
        for _ in it:
            pass
    it.close()


def test_process_map_backpressure_bounds_inflight():
    assert _bounded_pull(datapipe.ProcessPoolMap, _pm_ident) <= 5


def test_process_map_close_mid_stream_reaps_workers():
    it = iter(datapipe.ProcessPoolMap(range(200), _pm_ident, num_workers=3))
    next(it)
    it.close()  # the leak fixture asserts the reap


def test_process_pipe_fused_shm_end_to_end():
    """map(processes=True) fused with prefetch_to_device(chunk=K): chunks
    cross the shared-memory ring, are stacked into the feeder's staging
    buffer, arrive in order with the auto uint8 wire marker and a ring
    lease, and close() unlinks every segment."""
    from paddle_tpu_torch.datapipe.transfer import pop_markers

    pipe = (datapipe.DataPipe(range(24))
            .map(_pm_decode, num_workers=2, processes=True)
            .prefetch_to_device(place=fluid.CPUPlace(), chunk=4,
                                capacity=2))
    n = 0
    for ci, ch in enumerate(pipe):
        feed, wire, lease = pop_markers(ch)
        data = feed["data"].numpy()
        assert data.shape == (4, 4, 6) and data.dtype == np.uint8
        np.testing.assert_array_equal(
            data[:, 0, 0], [(ci * 4 + k) % 251 for k in range(4)])
        assert wire is not None and "data" in wire
        lease.release()
        n += 1
    assert n == 6
    assert "data" in pipe.wire_spec
    st = pipe.stats()
    assert st["map"]["items"] == 24
    assert st.get("bottleneck_stage") in st
    pipe.close()
    assert datapipe.live_segments() == []


def test_process_pipe_plain_feeds_batcher():
    pipe = (datapipe.DataPipe(range(16))
            .map(_pm_decode, num_workers=2, processes=True)
            .batch(2))
    vals = [int(b["data"][0, 0, 0]) for b in pipe]
    assert vals == [i % 251 for i in range(0, 16, 2)]
    pipe.close()
    assert datapipe.live_segments() == []


def test_forked_decode_workers_never_initialise_cuda():
    """A decode worker is forked from the parent and gets numpy arrays:
    torch.cuda.is_initialized() is False in every worker, plain and
    fused."""
    plain = list(datapipe.ProcessPoolMap(range(8), _pm_cuda_state,
                                         num_workers=2))
    assert [int(s["i"][0]) for s in plain] == list(range(8))
    assert not any(bool(s["cuda"][0]) for s in plain)
    pipe = (datapipe.DataPipe(range(8))
            .map(_pm_cuda_state, num_workers=2, processes=True)
            .prefetch_to_device(place=fluid.CPUPlace(), chunk=4))
    flags = [bool(v) for ch in pipe for v in ch["cuda"].reshape(-1)]
    pipe.close()
    assert flags == [False] * 8


# -- the same pipe in both packages ---------------------------------------
def _parse(rec):
    i, x = pickle.loads(rec)
    return {"x": x, "i": np.array([i], np.int64)}


def _decode(s):
    return {"x": (s["x"] * 2).astype(np.float32), "i": s["i"]}


def _spec(package, path, shard, processes, place):
    pipe = package.datapipe.DataPipe.from_recordio(
        str(path), parse_fn=_parse, batch_read=3)
    if shard is not None:
        pipe = pipe.shard(*shard)
    return (pipe.map(_decode, num_workers=3, processes=processes)
            .batch(2).prefetch_to_device(place, chunk=2))


@pytest.mark.parametrize("shard", [None, (3, 1)], ids=["whole", "shard1of3"])
@pytest.mark.parametrize("processes", [False, True],
                         ids=["threads", "processes"])
def test_same_pipe_same_samples_in_both_packages(tmp_path, shard,
                                                 processes):
    rs = np.random.RandomState(7)
    recs = [pickle.dumps((i, rs.rand(5).astype(np.float32)))
            for i in range(37)]
    path = tmp_path / "s.recordio"
    _write_recordio(path, recs)
    got = {}
    for name, package, place in (("jax", jfluid, jfluid.CPUPlace()),
                                 ("port", fluid, fluid.CPUPlace())):
        pipe = _spec(package, path, shard, processes, place)
        seq = [{k: _host(v) for k, v in ch.items() if not k.startswith("__")}
               for ch in pipe]
        got[name] = (seq, pipe.stats())
        pipe.close()
    (jseq, jst), (tseq, tst) = got["jax"], got["port"]
    assert len(tseq) == len(jseq) > 0
    for j, t in zip(jseq, tseq):
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    ids = np.concatenate([t["i"].reshape(-1) for t in tseq])
    step = 1 if shard is None else shard[0]
    first = 0 if shard is None else shard[1]
    np.testing.assert_array_equal(ids, np.arange(first, 37, step)[:len(ids)])
    # bottleneck_lane names the busier lane only when two lanes moved data,
    # which the threads' timing decides in either package
    assert sorted(set(tst) - {"bottleneck_lane"}) == \
        sorted(set(jst) - {"bottleneck_lane"})
    for stage in ("map", "batch", "stack", "transfer"):
        assert sorted(tst[stage]) == sorted(jst[stage]), stage
