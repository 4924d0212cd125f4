"""paddle_tpu_torch.io (fluid.io) and its host ops against the JAX
package's paddle_tpu.io.

In the port, on the CPU: save_vars/load_vars one file per var and
combined, params vs persistables, LoD sidecars, int64 vars written as the
JAX package writes them (int32), save_inference_model /
load_inference_model (only the forward program's persistables in the
directory), save_checkpoint / load_checkpoint with _SUCCESS markers and
LRU retention, delete_var, and the executor's handling of a program of
host ops (interpreted, uncached). Across the packages, on the same layer
calls under a fresh unique_name.guard() (an MLP and a conv+bn net): a
directory the JAX package saves loads in the port and one the port saves
loads in the JAX package, arrays bitwise equal and inference outputs
within rtol 1e-4 in f32; `__model__` and every `.npy` byte-equal between
the two packages' directories once the weights are carried across.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.registry import SeqTensor


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    fluid.unique_name.switch()
    fluid.flags.reset()
    yield
    fluid.flags.reset()


def _mlp_train(fl):
    """The README MLP with Adam: (main, startup, probs)."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[16], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fl.layers.fc(input=img, size=8, act="relu")
        probs = fl.layers.fc(input=hidden, size=4, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=probs,
                                                      label=label))
        fl.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)
    return main, startup, probs


def _mlp_net(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[16], dtype="float32")
        hidden = fl.layers.fc(input=img, size=8, act="relu")
        out = fl.layers.fc(input=hidden, size=4, act="softmax")
    return main, startup, out, {"img": (16,)}


def _conv_bn_net(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = fl.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                padding=1, bias_attr=False)
        bn = fl.layers.batch_norm(conv, act="relu", is_test=True)
        out = fl.layers.fc(input=bn, size=5, act="softmax")
    return main, startup, out, {"img": (3, 8, 8)}


NETS = {"mlp": _mlp_net, "conv_bn": _conv_bn_net}


def _feed(shapes, rows=3, seed=4):
    rs = np.random.RandomState(seed)
    return {n: rs.standard_normal((rows,) + s).astype(np.float32)
            for n, s in shapes.items()}


def _state(scope, program):
    return convert.numpy_state(scope, program)


def _files(d):
    return sorted(os.listdir(d))


# ---------------------------------------------------------------------------
# round trips in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filename", [None, "params.npz"],
                         ids=["one_file_per_var", "combined"])
def test_save_vars_load_vars_round_trip(tmp_path, filename):
    main, startup, _ = _mlp_train(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    src = fluid.Scope()
    with fluid.scope_guard(src):
        exe.run(startup)
        fluid.io.save_persistables(exe, str(tmp_path), main, filename)
    want = _state(src, main)
    if filename is None:
        assert _files(tmp_path) == sorted(n + ".npy" for n in want)
    else:
        assert _files(tmp_path) == [filename]
    dst = fluid.Scope()
    with fluid.scope_guard(dst):
        fluid.io.load_persistables(exe, str(tmp_path), main, filename)
    got = _state(dst, main)
    assert sorted(got) == sorted(want)
    for n in want:
        assert dst.find_var(n).dtype == src.find_var(n).dtype, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_params_vs_persistables(tmp_path):
    """save_params writes the Parameters only; save_persistables adds the
    optimizer's state (Adam's moments and beta powers, the learning
    rate)."""
    main, startup, _ = _mlp_train(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    rs = np.random.RandomState(0)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed={"img": rs.rand(4, 16).astype(np.float32),
                            "label": rs.randint(0, 4, (4, 1))})
        fluid.io.save_params(exe, str(tmp_path / "p"), main)
        fluid.io.save_persistables(exe, str(tmp_path / "s"), main)
    params = {p.name for p in main.global_block().all_parameters()}
    assert _files(tmp_path / "p") == sorted(n + ".npy" for n in params)
    persist = {n for n, v in main.global_block().vars.items()
               if v.persistable}
    assert _files(tmp_path / "s") == sorted(n + ".npy" for n in persist)
    assert len(persist) > len(params)


@pytest.mark.parametrize("filename", [None, "all.npz"],
                         ids=["sidecar", "combined"])
def test_lod_values_round_trip(tmp_path, filename):
    """A ragged value keeps its sequence lengths: a `.lod.json` sidecar
    beside its `.npy` (one file per var), a `<name>@@lod` array in the
    combined file; it loads back as a SeqTensor."""
    prog = fluid.Program()
    block = prog.global_block()
    seq = block.create_var(name="seq", shape=[-1, 3], dtype="float32",
                           lod_level=1, persistable=True)
    dense = block.create_var(name="dense", shape=[2], dtype="float32",
                             persistable=True)
    data = np.arange(18, dtype=np.float32).reshape(6, 3)
    lengths = np.array([2, 4], np.int32)
    src = fluid.Scope()
    src.set_var("seq", SeqTensor(torch.from_numpy(data),
                                 torch.from_numpy(lengths), lengths))
    src.set_var("dense", torch.ones(2))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(src):
        fluid.io.save_vars(exe, str(tmp_path), vars=[seq, dense],
                           filename=filename)
    if filename is None:
        assert _files(tmp_path) == ["dense.npy", "seq.lod.json", "seq.npy"]
    dst = fluid.Scope()
    with fluid.scope_guard(dst):
        fluid.io.load_vars(exe, str(tmp_path), vars=[seq, dense],
                           filename=filename)
    got = dst.find_var("seq")
    assert isinstance(got, SeqTensor)
    np.testing.assert_array_equal(got.data.numpy(), data)
    np.testing.assert_array_equal(got.lengths.numpy(), lengths)
    np.testing.assert_array_equal(got.host_lengths, lengths)
    assert got.lengths.dtype == torch.int32
    np.testing.assert_array_equal(dst.find_var("dense").numpy(), np.ones(2))


def test_int64_var_is_written_as_the_jax_package_writes_it(tmp_path):
    """An int64 var is written as int32, the dtype the JAX package (64-bit
    types off) holds and writes it in; it loads back as int64."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        step = fluid.layers.create_global_var(
            shape=[1], value=7, dtype="int64", persistable=True,
            name="step")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_vars(exe, str(tmp_path), vars=[step])
    assert np.load(tmp_path / "step.npy").dtype == np.int32
    dst = fluid.Scope()
    with fluid.scope_guard(dst):
        fluid.io.load_vars(exe, str(tmp_path), vars=[step])
    assert dst.find_var("step").dtype == torch.int64
    assert int(dst.find_var("step")[0]) == 7


def test_inference_model_round_trip(tmp_path):
    """The directory holds `__model__` and the forward program's
    persistables only (no optimizer state); the loaded program computes
    what the trained one does."""
    main, startup, probs = _mlp_train(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    rs = np.random.RandomState(1)
    x = rs.rand(4, 16).astype(np.float32)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed={"img": x, "label": rs.randint(0, 4, (4, 1))})
        test_prog = main.clone(for_test=True)
        want = exe.run(test_prog, feed={"img": x}, fetch_list=[probs])[0]
        fluid.io.save_inference_model(str(tmp_path), ["img"], [probs], exe,
                                      main_program=main)
    params = {p.name for p in main.global_block().all_parameters()}
    assert _files(tmp_path) == sorted(
        ["__model__"] + [n + ".npy" for n in params])
    with fluid.scope_guard(fluid.Scope()):
        prog, feeds, fetches = fluid.io.load_inference_model(
            str(tmp_path), exe)
        assert feeds == ["img"] and [v.name for v in fetches] == [probs.name]
        got = exe.run(prog, feed={"img": x}, fetch_list=fetches)[0]
    np.testing.assert_array_equal(got, want)


def test_checkpoints_success_markers_and_retention(tmp_path):
    main, startup, _ = _mlp_train(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    d = str(tmp_path)
    with fluid.scope_guard(scope):
        exe.run(startup)
        saved = []
        for k in range(3):
            scope.set_var("fc_0.w_1", torch.full((8,), float(k)))
            fluid.io.save_checkpoint(exe, d, max_num_checkpoints=2,
                                     save_interval_secs=0, main_program=main)
            saved.append(_state(scope, main))
        # the two newest committed checkpoints stay, each with its marker
        assert _files(d) == ["checkpoint_1", "checkpoint_2"]
        for name in _files(d):
            assert os.path.isfile(os.path.join(d, name, "_SUCCESS"))
        # a serial dir without its marker is crash debris: never loaded
        os.makedirs(os.path.join(d, "checkpoint_9"))
        scope.set_var("fc_0.w_1", torch.zeros(8))
        fluid.io.load_checkpoint(exe, d, main_program=main)
    got = _state(scope, main)
    for n, a in saved[-1].items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)
    np.testing.assert_array_equal(got["fc_0.w_1"], np.full(8, 2.0))
    fluid.io.clean_checkpoint(d)
    assert _files(d) == []


def test_delete_var_drops_the_var_from_the_scope():
    prog = fluid.Program()
    block = prog.global_block()
    block.create_var(name="victim", shape=[1], dtype="float32",
                     persistable=True)
    block.append_op("delete_var", {"X": ["victim"]}, {}, {})
    scope = fluid.Scope()
    scope.set_var("victim", torch.ones(1))
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(prog)
    assert not scope.has_var("victim")


def test_host_op_programs_are_interpreted_and_not_cached(tmp_path):
    """A program of save ops keeps its ops through dead-code elimination
    (they write no var), is held out of a CUDA graph by its host op, and
    is prepared afresh at every run: it adds no entry to the executor's
    cache."""
    main, startup, _ = _mlp_train(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        entries = exe.compile_cache_info()["entries"]
        for _ in range(2):
            fluid.io.save_params(exe, str(tmp_path), main)
        assert exe.compile_cache_info()["entries"] == entries
    save = fluid.Program()
    var = save.global_block().create_var(name="w", shape=[1],
                                         dtype="float32", persistable=True)
    save.global_block().append_op("save", {"X": [var]}, {},
                                  {"file_path": str(tmp_path / "w")})
    step = tcore.build_step_fn(save, [], [], fluid.CPUPlace())
    assert [op.type for op in step.ops] == ["save"]
    assert step.blocker is save.global_block().ops[0]
    assert tcore.HOST_OPS >= {"save", "load", "save_combine",
                              "load_combine", "delete_var"}


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _jax_init(net, seed=3):
    """The JAX package's net, its startup run, the BN statistics and every
    weight replaced by seeded random values: (main, out, shapes, scope,
    exe, {name: array})."""
    main, startup, out, shapes = net(jfluid)
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
    # bn's Variance feeds a sqrt: keep it positive
    variances = {n for op in main.global_block().ops
                 if op.type == "batch_norm" for n in op.input("Variance")}
    rs = np.random.RandomState(seed)
    arrays = {}
    for n, v in sorted(main.global_block().vars.items()):
        if v.persistable and scope.find_var(n) is not None:
            shape = np.asarray(scope.find_var(n)).shape
            a = rs.uniform(0.5, 2.0, shape) if n in variances \
                else rs.standard_normal(shape) * 0.5
            arrays[n] = a.astype(np.float32)
            scope.set_var(n, jnp.asarray(arrays[n]))
    return main, out, shapes, scope, exe, arrays


def _jax_run(prog, scope, exe, feed, fetch):
    with jfluid.scope_guard(scope):
        return np.asarray(exe.run(prog, feed=feed, fetch_list=fetch)[0])


@pytest.mark.parametrize("net", sorted(NETS))
def test_jax_saves_the_port_loads(tmp_path, net):
    jmain, jout, shapes, jscope, jexe, arrays = _jax_init(NETS[net])
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(str(tmp_path), list(shapes), [jout],
                                       jexe, main_program=jmain)
    feed = _feed(shapes)
    jprog, _, jfetch = jfluid.io.load_inference_model(
        str(tmp_path), jfluid.Executor(jfluid.CPUPlace()))
    want = _jax_run(jprog, jscope, jexe, feed, jfetch)

    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(
            str(tmp_path), exe)
        got = exe.run(prog, feed=feed, fetch_list=fetches)[0]
    assert feeds == list(shapes)
    loaded = _state(scope, prog)
    assert sorted(loaded) == sorted(arrays)
    for n, a in arrays.items():
        assert loaded[n].dtype == a.dtype
        np.testing.assert_array_equal(loaded[n], a, err_msg=n)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("net", sorted(NETS))
def test_the_port_saves_jax_loads(tmp_path, net):
    _, _, _, _, _, arrays = _jax_init(NETS[net])
    main, startup, out, shapes = NETS[net](fluid)
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    convert.load_numpy_state(scope, main, arrays, fluid.CPUPlace())
    feed = _feed(shapes)
    with fluid.scope_guard(scope):
        want = exe.run(main, feed=feed, fetch_list=[out])[0]
        fluid.io.save_inference_model(str(tmp_path), list(shapes), [out],
                                      exe, main_program=main)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jprog, feeds, fetches = jfluid.io.load_inference_model(
            str(tmp_path), jexe)
    assert feeds == list(shapes)
    for n, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)), a,
                                      err_msg=n)
    got = _jax_run(jprog, jscope, jexe, feed, fetches)
    np.testing.assert_allclose(want, got, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("net", sorted(NETS))
def test_directories_are_byte_equal(tmp_path, net):
    """The same net, the same weights: the two packages write the same
    files, byte for byte (`__model__` and every `.npy`), and the same
    persistables directory (save_persistables), int64 vars included."""
    jmain, jout, shapes, jscope, jexe, arrays = _jax_init(NETS[net])
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(str(tmp_path / "jax"), list(shapes),
                                       [jout], jexe, main_program=jmain)
    main, _, out, _ = NETS[net](fluid)
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    convert.load_numpy_state(scope, main, arrays, fluid.CPUPlace())
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path / "port"), list(shapes),
                                      [out], exe, main_program=main)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port")
    assert "__model__" in names and len(names) == len(arrays) + 1
    for f in names:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f


def test_int64_persistables_are_byte_equal(tmp_path):
    """A persistable int64 var, initialized by each package's startup:
    the same bytes on disk (int32), and each package loads the other's."""
    dirs = {}
    for name, fl in (("jax", jfluid), ("port", fluid)):
        prog, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(prog, startup):
            fl.layers.create_global_var(shape=[2], value=5, dtype="int64",
                                        persistable=True, name="counter")
        exe = fl.Executor(fl.CPUPlace())
        with fl.scope_guard(fl.Scope()):
            exe.run(startup)
            fl.io.save_persistables(exe, str(tmp_path / name), prog)
        dirs[name] = (prog, exe)
    assert (tmp_path / "jax" / "counter.npy").read_bytes() == \
        (tmp_path / "port" / "counter.npy").read_bytes()
    prog, exe = dirs["port"]
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(exe, str(tmp_path / "jax"), prog)
    assert scope.find_var("counter").dtype == torch.int64
    assert scope.find_var("counter").tolist() == [5, 5]
