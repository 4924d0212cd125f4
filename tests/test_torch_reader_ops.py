"""The port's reader ops (paddle_tpu_torch/ops/reader_ops.py) and reader
layers against the JAX package's: the 9 op types are registered as host
ops (their programs run on the interpreter); the reader pipeline of
tests/test_recordio_readers.py::test_reader_pipeline_trains trains in both
packages from one RecordIO file and one init, losses within rtol 1e-4
(fp32); shuffle, open_files, multi_pass, random_data_generator and
open_datapipe read what the JAX package's read; a LoD slot reads as a
SeqTensor; the double buffer returns None after EOF until reset, and on a
card stages each dense slot from pinned memory on its own stream.
"""

import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.ops import reader_ops as jreader_ops

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert, recordio
from paddle_tpu_torch.core import executor_core
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import reader_ops

READER_OP_TYPES = [
    "create_recordio_file_reader", "open_files",
    "create_random_data_generator", "create_shuffle_reader",
    "create_batch_reader", "create_double_buffer_reader",
    "create_datapipe_reader", "create_multi_pass_reader", "read"]


@pytest.fixture(autouse=True)
def _fresh_state():
    from paddle_tpu_torch.core import framework, scope

    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    scope.reset_global_scope()
    yield


@pytest.mark.parametrize("op_type", READER_OP_TYPES)
def test_the_reader_op_types_are_registered_host_ops(op_type):
    assert treg.get_op_def(op_type) is not None
    assert op_type in executor_core.READER_OPS <= executor_core.HOST_OPS
    assert jreader_ops is not None and \
        jfluid.core.registry.get_op_def(op_type) is not None


def _write_xy(path, n=64, seed=0, module=recordio):
    rs = np.random.RandomState(seed)
    W = rs.randn(8, 3).astype("float32")
    with module.Writer(str(path)) as w:
        for _ in range(n):
            x = rs.rand(8).astype("float32")
            y = np.array([int(np.argmax(x @ W))], dtype="int64")
            w.write(pickle.dumps([(x, None), (y, None)]))


def _reader_program(package, path, decorate):
    main, startup = package.Program(), package.Program()
    with package.unique_name.guard(), package.program_guard(main, startup):
        reader = package.layers.open_recordio_file(
            str(path), shapes=[[-1, 8], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "int64"])
        reader = decorate(package, reader)
        img, label = package.layers.read_file(reader)
        h = package.layers.fc(input=img, size=16, act="relu")
        p = package.layers.fc(input=h, size=3, act="softmax")
        loss = package.layers.mean(
            package.layers.cross_entropy(input=p, label=label))
        package.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def _train_until_eof(package, exe, main, loss, limit=100):
    losses = []
    for _ in range(limit):
        try:
            lv, = exe.run(main, feed={}, fetch_list=[loss])
        except StopIteration:
            return losses
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    raise AssertionError("the reader did not end")


def _both(path, decorate):
    """(jax losses, port losses) of the reader program from one init."""
    jmain, jstartup, jloss = _reader_program(jfluid, path, decorate)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        init = {n: np.asarray(jscope.find_var(n))
                for n, v in jmain.global_block().vars.items()
                if v.persistable and v.type != "reader"
                and jscope.find_var(n) is not None}
        jl = _train_until_eof(jfluid, jexe, jmain, jloss)
    tmain, tstartup, tloss = _reader_program(fluid, path, decorate)
    texe = fluid.Executor(fluid.CPUPlace())
    tscope = fluid.Scope()
    with fluid.scope_guard(tscope):
        texe.run(tstartup)
        convert.load_numpy_state(tscope, tmain, init, fluid.CPUPlace())
        tl = _train_until_eof(fluid, texe, tmain, tloss)
        assert texe.step_mode(tmain) == "interpreter"
    return np.array(jl), np.array(tl)


def test_reader_pipeline_trains(tmp_path):
    """recordio file -> open_recordio_file + batch + double_buffer ->
    read_file -> train, in both packages from one file and one init."""
    path = tmp_path / "train.rio"
    _write_xy(path)
    jl, tl = _both(path, lambda f, r: f.layers.double_buffer(
        f.layers.batch(r, batch_size=16)))
    assert len(tl) == len(jl) == 4  # 64 samples / bs16
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_shuffle_and_multi_pass_train_as_in_the_jax_package(tmp_path):
    path = tmp_path / "train.rio"
    _write_xy(path, n=40, seed=1)
    jl, tl = _both(path, lambda f, r: f.layers.multi_pass(
        f.layers.batch(f.layers.shuffle(r, buffer_size=16), batch_size=8),
        pass_num=2))
    assert len(tl) == len(jl) == 10  # 2 passes of 40 / 8
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def _read_all(package, main, startup, outs, limit=50):
    exe = package.Executor(package.CPUPlace())
    got = []
    with package.scope_guard(package.Scope()):
        exe.run(startup)
        for _ in range(limit):
            try:
                vals = exe.run(main, feed={}, fetch_list=outs,
                               return_numpy=False)
            except StopIteration:
                return got
            got.append([np.asarray(v.numpy() if hasattr(v, "numpy")
                                   and not isinstance(v, np.ndarray)
                                   else v) for v in vals])
    raise AssertionError("the reader did not end")


def test_open_files_reads_round_robin_as_in_the_jax_package(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.rio"
        with recordio.Writer(str(p)) as w:
            for k in range(2 + i):
                w.write(pickle.dumps([(np.full((2,), 10 * i + k,
                                               np.float32), None)]))
        paths.append(str(p))
    got = {}
    for name, package in (("jax", jfluid), ("port", fluid)):
        main, startup = package.Program(), package.Program()
        with package.unique_name.guard(), \
                package.program_guard(main, startup):
            r = package.layers.open_files(paths, shapes=[[-1, 2]],
                                          lod_levels=[0],
                                          dtypes=["float32"])
            x = package.layers.read_file(package.layers.batch(r, 2))
            y = package.layers.scale(x, scale=1.0)
        got[name] = _read_all(package, main, startup, [y])
    assert len(got["port"]) == len(got["jax"]) == 5
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(t[0], j[0])


def test_random_data_generator_draws_the_jax_packages_numbers():
    got = {}
    for name, package in (("jax", jfluid), ("port", fluid)):
        main, startup = package.Program(), package.Program()
        with package.unique_name.guard(), \
                package.program_guard(main, startup):
            r = package.layers.random_data_generator(
                low=-1.0, high=2.0, shapes=[[3, 4], [2]], lod_levels=[0, 0])
            a, b = package.layers.read_file(r)
            ya = package.layers.scale(a, scale=1.0)
            yb = package.layers.scale(b, scale=1.0)
        exe = package.Executor(package.CPUPlace())
        with package.scope_guard(package.Scope()):
            exe.run(startup)
            got[name] = [np.asarray(v) for _ in range(3)
                         for v in exe.run(main, fetch_list=[ya, yb])]
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(t, j)


def test_open_datapipe_feeds_read_file():
    rows = [{"x": np.full((3,), i, np.float32),
             "y": np.array([i], np.int64)} for i in range(8)]
    pipe = fluid.DataPipe.from_reader(lambda: iter(rows)).batch(4)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        r = fluid.layers.open_datapipe(pipe, ["x", "y"], [[-1, 3], [-1, 1]],
                                       ["float32", "int64"])
        x, y = fluid.layers.read_file(r)
        s = fluid.layers.reduce_sum(x)
        yy = fluid.layers.scale(fluid.layers.cast(y, "float32"), scale=1.0)
    got = _read_all(fluid, main, startup, [s, yy])
    pipe.close()
    assert [float(g[0]) for g in got] == [3.0 * (0 + 1 + 2 + 3),
                                          3.0 * (4 + 5 + 6 + 7)]
    np.testing.assert_array_equal(got[1][1].reshape(-1), [4, 5, 6, 7])


def test_a_lod_slot_reads_as_a_sequence(tmp_path):
    """A ragged slot (lod_level 1) batches to flat rows plus lengths and
    reads as a SeqTensor: sequence_pool(sum) gives the JAX package's
    per-sequence sums."""
    path = tmp_path / "seq.rio"
    rs = np.random.RandomState(5)
    with recordio.Writer(str(path)) as w:
        for i in range(6):
            n = int(rs.randint(1, 5))
            w.write(pickle.dumps([(rs.rand(n, 2).astype(np.float32), [n])]))
    got = {}
    for name, package in (("jax", jfluid), ("port", fluid)):
        main, startup = package.Program(), package.Program()
        with package.unique_name.guard(), \
                package.program_guard(main, startup):
            r = package.layers.open_recordio_file(
                str(path), shapes=[[-1, 2]], lod_levels=[1],
                dtypes=["float32"])
            x = package.layers.read_file(package.layers.batch(r, 3))
            pooled = package.layers.sequence_pool(x, "sum")
        got[name] = _read_all(package, main, startup, [pooled])
    assert len(got["port"]) == len(got["jax"]) == 2
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-6)


def test_iters_refuses_reader_programs(tmp_path):
    path = tmp_path / "train.rio"
    _write_xy(path, n=16)
    main, startup, loss = _reader_program(
        fluid, path, lambda f, r: f.layers.batch(r, batch_size=4))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        with pytest.raises(ValueError, match="reader"):
            exe.run(main, feed={}, fetch_list=[loss], iters=2)


class _CountReader(reader_ops.ReaderBase):
    def __init__(self, n):
        self.n = n
        self.i = 0

    def read_next(self):
        if self.i >= self.n:
            return None
        self.i += 1
        return [(np.array([self.i], dtype="float32"), None)]

    def reset(self):
        self.i = 0


def test_double_buffer_post_eof_reads():
    """Every read after EOF returns None (it does not block) until
    reset(), as the JAX package's double buffer does."""
    r = reader_ops.DoubleBufferReader(_CountReader(3))
    got = [r.read_next() for _ in range(3)]
    assert [float(g[0][0][0]) for g in got] == [1.0, 2.0, 3.0]
    assert all(isinstance(g[0][0], torch.Tensor) for g in got)
    for _ in range(5):
        assert r.read_next() is None
    r.reset()
    assert r.read_next() is not None
    j = jreader_ops.DoubleBufferReader(_JCount(3))
    assert [j.read_next() is None for _ in range(5)] == \
        [False, False, False, True, True]


class _JCount(jreader_ops.ReaderBase):
    def __init__(self, n):
        self.n, self.i = n, 0

    def read_next(self):
        if self.i >= self.n:
            return None
        self.i += 1
        return [(np.array([self.i], dtype="float32"), None)]

    def reset(self):
        self.i = 0


def test_double_buffer_worker_error_reaches_the_reader():
    class Boom(_CountReader):
        def read_next(self):
            raise IOError("torn record")

    r = reader_ops.DoubleBufferReader(Boom(1))
    with pytest.raises(IOError, match="torn record"):
        r.read_next()
    assert r.read_next() is None


def test_a_cuda_double_buffer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        r = fluid.layers.random_data_generator(0.0, 1.0, [[2]], [0])
        fluid.layers.read_file(fluid.layers.double_buffer(
            r, place=fluid.CUDAPlace(0)))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        with pytest.raises(RuntimeError, match="CUDA"):
            exe.run(main)


@pytest.mark.cuda
def test_double_buffer_stages_from_pinned_memory_on_its_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    r = reader_ops.DoubleBufferReader(_CountReader(3), device=dev)
    for i in range(3):
        (staged, lod), = r.read_next()
        assert isinstance(staged, reader_ops._Staged)
        assert staged.pinned.is_pinned()
        t = staged.take()
        assert t.device == dev and float(t.item()) == i + 1.0
    assert r.read_next() is None
    r.reset()
