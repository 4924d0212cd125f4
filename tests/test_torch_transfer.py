"""The port's transfer engine (paddle_tpu_torch/datapipe/transfer.py) and
the feeder's staging (datapipe/feeder.py) against the JAX package's.

- WireFormat.encode is bitwise equal to the JAX package's (numpy on both
  sides; bfloat16 compared as bits);
- the decode equals JAX's: bitwise for a pure cast, within 1 f32 ulp for
  the affine decode;
- a uint8-wire pipe through Executor.run gives the host-normalised
  reference's losses, and the JAX package's; the link moves a quarter of
  the float32 bytes; the prepared step is keyed on the wire;
- markers, auto_wire and its flag gate, stage_fn chunks never leased, the
  reorder buffer under skewed transfers, early close;
- a staged chunk is never overwritten while its consumer still holds it
  (the ring of device chunk buffers reuses a chunk only after its lease is
  released), and the ring stays at `capacity` chunks under the executor;
- on a card (`cuda`-marked, skipped here): pinned staging buffers, the
  side-stream copy ordered before the consumer's reads, the device ring.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.datapipe import transfer as jtransfer

import paddle_tpu_torch as fluid
from paddle_tpu_torch import datapipe, flags
from paddle_tpu_torch.datapipe import feeder as tfeeder
from paddle_tpu_torch.datapipe import shm as tshm
from paddle_tpu_torch.datapipe.transfer import (DONATE_KEY, WIRE_KEY,
                                                WireFormat, WireSpec,
                                                pop_markers)

DEADLINE_S = 5.0


@pytest.fixture(autouse=True)
def _no_leaks():
    def threads():
        return {t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("datapipe-")}

    before = (threads(), set(tshm.live_segments()))
    yield
    deadline = time.time() + DEADLINE_S
    while (threads() - before[0] or set(tshm.live_segments()) - before[1]) \
            and time.time() < deadline:
        time.sleep(0.05)
    assert not threads() - before[0]
    assert not set(tshm.live_segments()) - before[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned staging and the copy stream "
                    "exist only there")
    return torch.device("cuda", 0)


def _bits(a):
    """An encoded array's bits (a bf16 array of either package as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 \
        and a.dtype.kind in "Vfu" else a


# -- encode and decode against the JAX package -------------------------------
FORMATS = [
    ("uint8_scale", dict(wire_dtype="uint8", compute_dtype="float32",
                         scale=1.0 / 255.0)),
    ("uint8_affine", dict(wire_dtype="uint8", scale=0.02, shift=-1.5)),
    ("int8_scale", dict(wire_dtype="int8", scale=0.5)),
    ("bfloat16", dict(wire_dtype="bfloat16")),
    ("float16", dict(wire_dtype="float16")),
]


@pytest.mark.parametrize("name,kw", FORMATS, ids=[f[0] for f in FORMATS])
def test_encode_is_bitwise_equal_to_the_jax_package(name, kw):
    rs = np.random.RandomState(0)
    srcs = [rs.uniform(-2, 3, (5, 7)).astype(np.float32),
            np.array([0.0, -0.0, 1e-8, 65504.0, -1e30, 3.4e38, 0.5, 1.5,
                      2.5, 255.0, 256.0], np.float32),
            rs.randint(0, 256, (4, 3)).astype(np.uint8)]
    tf, jf = WireFormat(**kw), jtransfer.WireFormat(**kw)
    assert tf.fingerprint() == jf.fingerprint()
    for src in srcs:
        got, want = tf.encode(src), jf.encode(src)
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _decode_pair(fmt_kw, enc_t, enc_j, var_dtype):
    got = WireFormat(**fmt_kw).decode(enc_t, var_dtype)
    want = np.asarray(jtransfer.WireFormat(**fmt_kw).decode(
        jnp.asarray(enc_j), var_dtype))
    return got.float().numpy() if got.dtype == torch.bfloat16 \
        else got.numpy(), want


def test_pure_cast_decode_is_bitwise_equal():
    rs = np.random.RandomState(1)
    u8 = rs.randint(0, 256, (6, 5)).astype(np.uint8)
    got, want = _decode_pair(dict(wire_dtype="uint8"), torch.from_numpy(u8),
                             u8, "float32")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    f = rs.uniform(-3, 3, (6, 5)).astype(np.float32)
    bits = WireFormat("bfloat16").encode(f)
    jenc = jtransfer.WireFormat("bfloat16").encode(f)
    staged = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    got, want = _decode_pair(dict(wire_dtype="bfloat16"), staged, jenc,
                             "float32")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(scale=1.0 / 255.0),
                                dict(scale=0.02, shift=-1.5),
                                dict(shift=3.25)])
def test_affine_decode_within_one_ulp(kw):
    rs = np.random.RandomState(2)
    u8 = rs.randint(0, 256, (64, 9)).astype(np.uint8)
    got, want = _decode_pair(dict(wire_dtype="uint8", **kw),
                             torch.from_numpy(u8), u8, "float32")
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want))


def test_wireformat_quantize_clips_out_of_range():
    fmt = WireFormat("uint8", scale=1.0 / 255.0)
    np.testing.assert_array_equal(
        fmt.encode(np.array([-0.5, 2.0], np.float32)), [0, 255])
    u8 = np.arange(12, dtype=np.uint8)
    assert fmt.encode(u8) is u8  # already in the wire dtype


def test_wirespec_fingerprint_and_markers():
    spec = WireSpec.uint8_images("img")
    assert "img" in spec and "other" not in spec
    assert spec.fingerprint() == WireSpec.uint8_images("img").fingerprint()
    assert spec.fingerprint() != WireSpec.bfloat16("img").fingerprint()
    assert spec.fingerprint() == \
        jtransfer.WireSpec.uint8_images("img").fingerprint()
    lease = object()
    chunk = {"img": np.zeros((2, 3), np.uint8), WIRE_KEY: spec,
             DONATE_KEY: lease}
    feed, wire, got = pop_markers(chunk)
    assert wire is spec and got is lease and set(feed) == {"img"}
    assert WIRE_KEY in chunk  # the caller's dict untouched
    plain = {"img": np.zeros((2, 3), np.uint8)}
    assert pop_markers(plain) == (plain, None, None)


def test_auto_wire_covers_uint8_feeds_only():
    spec = datapipe.auto_wire({"img": np.zeros((4, 4), np.uint8),
                               "label": np.zeros((4, 1), np.int32),
                               "__valid__": np.ones(4, bool)})
    assert "img" in spec and "label" not in spec and "__valid__" not in spec
    assert datapipe.auto_wire({"x": np.zeros(4, np.float32)}) is None


def test_auto_wire_flag_gate():
    sample = {"img": np.zeros((4, 4), np.uint8)}
    assert datapipe.auto_wire(sample) is not None
    with flags.flag_guard(wire_compress=False):
        assert datapipe.auto_wire(sample) is None


# -- the wire through Executor.run ------------------------------------------
def _train_program(package):
    main, startup = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(main, startup):
        x = package.layers.data(name="x", shape=[4], dtype="float32")
        y = package.layers.data(name="y", shape=[1], dtype="int64")
        h = package.layers.fc(input=x, size=8, act="tanh")
        p = package.layers.fc(input=h, size=3, act="softmax")
        loss = package.layers.mean(
            package.layers.cross_entropy(input=p, label=y))
        package.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def _pixels(n=24):
    rs = np.random.RandomState(7)
    return (rs.randint(0, 256, size=(n, 4)).astype(np.uint8),
            rs.randint(0, 3, size=(n, 1)).astype(np.int64))


def _pixel_pipe(package, wire, imgs, labels, steps=3, batch=8):
    return (package.datapipe.DataPipe.from_reader(
                lambda: ({"x": imgs[i], "y": labels[i]}
                         for i in range(len(imgs))))
            .batch(batch)
            .prefetch_to_device(place=package.CPUPlace(), chunk=steps,
                                capacity=2, wire=wire))


def test_uint8_wire_pipe_matches_host_normalized_reference():
    """uint8 on the link, cast and x 1/255 in the step: the 3-step losses
    equal those of the float32 feed normalised on the host in the same
    order (cast, then the f32 product), and the JAX package's pipe's."""
    from paddle_tpu_torch import convert

    imgs, labels = _pixels()
    scale = 1.0 / 255.0
    main, startup, loss = _train_program(fluid)
    jmain, jstartup, jloss = _train_program(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        init = {n: np.asarray(jscope.find_var(n)) for n in
                (v.name for v in jmain.global_block().vars.values()
                 if v.persistable) if jscope.find_var(n) is not None}
        jpipe = _pixel_pipe(jfluid, jtransfer.WireSpec.uint8_images(
            "x", scale=scale), imgs, labels)
        jl = np.asarray(jexe.run(jmain, feed=jpipe, fetch_list=[jloss])[0])
        jpipe.close()
    exe = fluid.Executor(fluid.CPUPlace())
    losses = {}
    for how in ("wire", "host"):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, main, init, fluid.CPUPlace())
        with fluid.scope_guard(scope):
            if how == "wire":
                pipe = _pixel_pipe(fluid, WireSpec.uint8_images(
                    "x", scale=scale), imgs, labels)
                losses[how] = exe.run(main, feed=pipe, fetch_list=[loss])[0]
                st = pipe.stats()
                pipe.close()
            else:
                f32 = imgs.astype(np.float32) * np.float32(scale)
                losses[how] = exe.run(
                    main, feed={"x": f32.reshape(3, 8, 4),
                                "y": labels.reshape(3, 8, 1)},
                    fetch_list=[loss], iters=3)[0]
    np.testing.assert_array_equal(losses["wire"], losses["host"])
    np.testing.assert_allclose(losses["wire"].reshape(-1), jl.reshape(-1),
                               rtol=1e-5)
    # the link moved uint8: a quarter of the float32 pixel bytes
    assert st["transfer"]["bytes"] == imgs.nbytes + labels.nbytes
    assert sum(st[k]["bytes"] for k in st if k.startswith("link")) == \
        st["transfer"]["bytes"]


def test_wire_cuts_link_bytes_to_a_quarter_of_float32():
    rs = np.random.RandomState(3)
    data = rs.uniform(0, 1, size=(16, 4)).astype(np.float32)

    def bytes_through(wire):
        pipe = (datapipe.DataPipe
                .from_reader(lambda: ({"x": data[i]} for i in range(16)))
                .batch(4)
                .prefetch_to_device(place=fluid.CPUPlace(), chunk=2,
                                    capacity=2, wire=wire))
        for _ in pipe:
            pass
        pipe.close()
        return pipe.stats()["transfer"]["bytes"]

    assert bytes_through(None) == data.nbytes
    assert bytes_through(WireSpec.uint8_images("x")) * 4 == data.nbytes


def test_the_prepared_step_is_keyed_on_the_wire():
    """A wired and an unwired feed of one program, and two wires, prepare
    separate steps: none runs on a step built for another feed's dtype or
    decode."""
    imgs, labels = _pixels()
    main, startup, loss = _train_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        before = exe.compile_cache_info()["entries"]
        for wire in (WireSpec.uint8_images("x"),
                     WireSpec.uint8_images("x", scale=0.5)):
            pipe = _pixel_pipe(fluid, wire, imgs, labels)
            exe.run(main, feed=pipe, fetch_list=[loss])
            pipe.close()
        exe.run(main, feed={"x": imgs[:8].astype(np.float32),
                            "y": labels[:8]}, fetch_list=[loss])
        exe.run(main, feed={"x": imgs[:8].astype(np.float32),
                            "y": labels[:8], WIRE_KEY: WireSpec.uint8_images(
                                "x")}, fetch_list=[loss])
        assert exe.compile_cache_info()["entries"] - before == 4


def test_host_op_programs_decode_at_feed_time(tmp_path):
    """A program with a host op (here a save) runs on the interpreter and
    decodes its wired feed when the feed arrives, as the JAX package's
    eager path does."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.reduce_sum(x)
        w = fluid.layers.create_global_var(shape=[1], value=1.0,
                                           dtype="float32", persistable=True,
                                           name="w")
        main.global_block().append_op(
            type="save", inputs={"X": [w]}, outputs={},
            attrs={"file_path": str(tmp_path / "w")})
    u8 = np.arange(8, dtype=np.uint8).reshape(2, 4)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        out, = exe.run(main, feed={"x": u8, WIRE_KEY: WireSpec.uint8_images(
            "x", scale=0.5)}, fetch_list=[y])
    assert exe.step_mode(main) == "interpreter"
    assert float(out) == float(np.sum(u8.astype(np.float32) * 0.5))


# -- staging: leases, the ring, stage_fn, reorder -----------------------------
def test_staged_chunk_is_not_overwritten_while_its_consumer_holds_it():
    """The counterpart of the JAX package's
    test_feeder_staged_items_do_not_alias_reused_host_buffers, with a slow
    consumer: the feeder runs ahead while the consumer holds chunk k
    unreleased, and chunk k keeps its values; released chunks are reused,
    so the ring stays at `capacity` slots under the executor."""
    buf = np.empty((2,), np.float32)

    def src():
        for i in range(40):
            buf[:] = float(i)  # one reused upstream buffer
            yield {"x": buf}

    feeder = datapipe.AsyncDeviceFeeder(src, chunk=2,
                                        place=fluid.CPUPlace(), capacity=2,
                                        transfer_threads=2)
    it = iter(feeder)
    for k in range(20):
        chunk = next(it)
        want = chunk["x"].clone()
        time.sleep(0.02)  # slow consumer: the workers stage ahead
        np.testing.assert_array_equal(chunk["x"].numpy(), want.numpy())
        np.testing.assert_array_equal(want[:, 0].numpy(), [2 * k, 2 * k + 1])
        chunk[DONATE_KEY].release()
        assert len(feeder._active["ring"].slots) <= 2
    it.close()


def test_unreleased_chunks_are_never_reused():
    """A consumer that keeps chunks without releasing them (list(pipe))
    keeps their values: the ring forgets such slots and makes new ones."""
    pipe = (datapipe.DataPipe.from_reader(
                lambda: ({"x": np.full((2,), i, np.float32)}
                         for i in range(32)))
            .batch(2)
            .prefetch_to_device(place=fluid.CPUPlace(), chunk=2,
                                capacity=2))
    xs = [c["x"] for c in pipe]
    pipe.close()
    got = np.concatenate([x[:, :, 0].reshape(-1).numpy() for x in xs])
    np.testing.assert_array_equal(got, np.arange(32, dtype=np.float32))


def test_the_executor_releases_each_chunk_after_its_run():
    imgs, labels = _pixels(48)
    main, startup, loss = _train_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    pipe = _pixel_pipe(fluid, "auto", imgs, labels, steps=2, batch=4)
    leases = []
    real = pop_markers

    def spy(feed):
        out = real(feed)
        if out[2] is not None:
            leases.append(out[2])
        return out

    # Executor.run pops the markers through transfer.staged_feed
    import paddle_tpu_torch.datapipe.transfer as ttransfer

    ttransfer.pop_markers = spy
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            n = 0
            while True:
                try:
                    exe.run(main, feed=pipe, fetch_list=[loss])
                except StopIteration:
                    break
                n += 1
    finally:
        ttransfer.pop_markers = real
        pipe.close()
    assert n == 6 and len(leases) == 6
    assert all(lease.released for lease in leases)


def test_stage_fn_chunks_never_leased():
    owned = {}

    def stage(idx, stacked):
        owned[idx] = {n: torch.from_numpy(a) for n, a in stacked.items()}
        return owned[idx]

    feeder = datapipe.AsyncDeviceFeeder(
        lambda: ({"x": np.full((2,), i, np.float32)} for i in range(8)),
        chunk=2, place=fluid.CPUPlace(), capacity=2, transfer_threads=1,
        stage_fn=stage, wire=WireSpec.bfloat16("x"))
    staged = list(feeder)
    assert len(staged) == 4
    for ch in staged:
        assert WIRE_KEY in ch and DONATE_KEY not in ch
    for d in owned.values():
        assert set(d) == {"x"}


def test_reorder_buffer_emits_in_order_under_skewed_transfer_delay():
    completed = []

    def slow_stage(idx, stacked):
        time.sleep([0.15, 0.1, 0.05, 0.0][idx % 4])
        completed.append(idx)
        return {n: torch.from_numpy(a) for n, a in stacked.items()}

    feeder = datapipe.AsyncDeviceFeeder(
        lambda: ({"x": np.full((2,), i, np.float32)} for i in range(24)),
        chunk=2, place=fluid.CPUPlace(), capacity=4, transfer_threads=3,
        stage_fn=slow_stage)
    got = [float(ch["x"][0, 0]) for ch in feeder]
    assert got == [2.0 * i for i in range(12)]
    assert sorted(completed) == list(range(12))
    assert completed != list(range(12))


def test_reorder_early_close_releases_tickets_and_threads():
    def slow_stage(idx, stacked):
        time.sleep(0.05 if idx % 2 == 0 else 0.0)
        return {n: torch.from_numpy(a) for n, a in stacked.items()}

    feeder = datapipe.AsyncDeviceFeeder(
        lambda: ({"x": np.full((2,), i, np.float32)} for i in range(16)),
        chunk=2, place=fluid.CPUPlace(), capacity=3, transfer_threads=2,
        stage_fn=slow_stage)
    it = iter(feeder)
    next(it)
    next(it)
    it.close()
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline and any(
            t.name.startswith("datapipe-feed-") for t in
            threading.enumerate()):
        time.sleep(0.02)
    assert not any(t.name.startswith("datapipe-feed-")
                   for t in threading.enumerate())
    assert [float(ch["x"][0, 0]) for ch in feeder] == \
        [2.0 * i for i in range(8)]


def test_device_chunk_feeder_warns_exactly_once_per_process():
    import warnings

    import paddle_tpu_torch.pipeline as pipeline_mod

    pipeline_mod._deprecation_warned = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fluid.DeviceChunkFeeder(lambda: iter(()), chunk=2,
                                place=fluid.CPUPlace())
        fluid.DeviceChunkFeeder(lambda: iter(()), chunk=2,
                                place=fluid.CPUPlace())
    dep = [i for i in w if issubclass(i.category, DeprecationWarning)
           and "DeviceChunkFeeder" in str(i.message)]
    assert len(dep) == 1


def test_a_cuda_place_without_a_card_raises():
    """No fallback that hides the device: staging to CUDAPlace(0) on a
    machine without a card raises at iteration."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    feeder = datapipe.AsyncDeviceFeeder(
        [{"x": np.zeros(2, np.float32)}], chunk=1, place=fluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(feeder))


def _u8_decode_sample(i):
    rs = np.random.RandomState(i)
    return {"x": rs.randint(0, 256, size=(4, 4), dtype=np.uint8)}


def test_affine_decode_fusion_matches_float32_reference():
    """The fused process pipe with WireSpec.uint8_images (shm ring, then
    the feeder's staging buffer, decode in the step) against
    host-normalised float32 feeds of the same samples."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.reduce_mean(x, dim=1)
    exe = fluid.Executor(fluid.CPUPlace())
    pipe = (datapipe.DataPipe(range(12))
            .map(_u8_decode_sample, num_workers=2, processes=True)
            .prefetch_to_device(place=fluid.CPUPlace(), chunk=3, capacity=2,
                                wire=WireSpec.uint8_images("x")))
    got = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        while True:
            try:
                out, = exe.run(main, feed=pipe, fetch_list=[y])
            except StopIteration:
                break
            got.append(np.asarray(out).reshape(-1))
        want = [np.asarray(exe.run(main, feed={
            "x": _u8_decode_sample(i)["x"].astype(np.float32)
            * np.float32(1.0 / 255.0)}, fetch_list=[y])[0]).reshape(-1)
            for i in range(12)]
    pipe.close()
    assert datapipe.live_segments() == []
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


# -- on a card ----------------------------------------------------------------
@pytest.mark.cuda
def test_pinned_staging_and_the_copy_stream_on_the_card(cuda_device):
    """On a card each transfer thread stages into pinned host memory and
    copies on a stream of its own; the consumer reads the chunk right away
    on its stream and sees the right values, and the chunk lands in the
    device ring."""
    seen_pinned = []
    real_empty = torch.empty

    def spy_empty(*a, **kw):
        t = real_empty(*a, **kw)
        if kw.get("pin_memory"):
            seen_pinned.append(t.is_pinned())
        return t

    data = np.arange(4 * 64 * 1024, dtype=np.float32).reshape(4, -1)
    tfeeder.torch.empty = spy_empty
    try:
        feeder = datapipe.AsyncDeviceFeeder(
            lambda: ({"x": data[i % 4] + i} for i in range(16)), chunk=2,
            place=fluid.CUDAPlace(0), capacity=2, transfer_threads=2)
        out = []
        for ch in feeder:
            assert ch["x"].device.type == "cuda"
            out.append(ch["x"].sum(dtype=torch.float64).item())
            ch[DONATE_KEY].release()
    finally:
        tfeeder.torch.empty = real_empty
    assert seen_pinned and all(seen_pinned)
    want = [sum(float((data[i % 4] + i).astype(np.float64).sum())
                for i in (2 * k, 2 * k + 1)) for k in range(8)]
    np.testing.assert_allclose(out, want)


@pytest.mark.cuda
def test_the_device_ring_waits_for_the_consumers_stream(cuda_device):
    """A released chunk is refilled only after the work its consumer
    enqueued before the release: a long kernel reading the chunk on the
    consumer's stream sees the chunk's own values."""
    feeder = datapipe.AsyncDeviceFeeder(
        lambda: ({"x": np.full((1 << 20,), i, np.float32)}
                 for i in range(12)),
        chunk=1, place=fluid.CUDAPlace(0), capacity=2, transfer_threads=2)
    sums = []
    for ch in feeder:
        x = ch["x"]
        acc = torch.zeros((), device=cuda_device, dtype=torch.float64)
        for _ in range(50):  # keep the stream busy reading x
            acc = acc + x.double().sum()
        ch[DONATE_KEY].release()  # an event after the reads
        sums.append(acc)
    got = [float(s.item()) / 50 / (1 << 20) for s in sums]
    assert got == [float(i) for i in range(12)]
