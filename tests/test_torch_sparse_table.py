"""SelectedRows, the sparse table and the distributed lookup table in the
port, held to the JAX package on the CPU.

- SelectedRows to_dense and merge, the SparseTable's auto-grow and sgd
  (bitwise the JAX table: the same per-id init draw, the same numpy
  update);
- the kernels: lookup_table_grad with is_sparse (and without W, the
  distributed table's), split_ids and merge_ids, sum, scale and sgd on
  SelectedRows, each against the JAX package's;
- an is_sparse program: its parameters within rtol 1e-6 of the dense
  gradient's program, the JAX package's within rtol 1e-5; FLAGS_fuse
  leaves its sparse update on the per-op path; the recorded graph path
  bitwise the interpreter;
- the distributed-table programs (trainer, pserver, startup) with the
  JAX package's desc_str();
- two table pservers in threads, trained from the JAX run's numpy start:
  each holds only its shard's rows, and every row equals the JAX
  package's run within rtol 1e-5.
Servers bind ports the OS picks, every wait has a timeout, and every
server is stopped in a `finally`.
"""

import json
import socket
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.ops import rpc_ops as jrpc_ops
from paddle_tpu.parallel import rpc as jrpc

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert, flags as tflags, fusion
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.selected_rows import (SelectedRows, SparseTable,
                                                 merge_selected_rows)
from paddle_tpu_torch.ops import rpc_ops as trpc_ops
from paddle_tpu_torch.parallel import rpc as trpc

from test_torch_step import recorded_graphs  # noqa: F401 (a fixture)

JOIN_S = 30
# an RPC that waits longer fails the test instead of hanging it
RPC_DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_port_state(monkeypatch):
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    tflags.reset()
    monkeypatch.setattr(trpc_ops, "RPC_DEADLINE_S", RPC_DEADLINE_S)
    yield
    tflags.reset()
    jflags.reset()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def desc(program):
    """A program's desc_str() JSON, with a list of blocks (listen_and_serv's
    OptimizeBlocks, on which both packages' desc_str() raise TypeError)
    encoded block by block."""
    return json.dumps(program.to_dict(), sort_keys=True,
                      default=lambda b: {"__block__": b.idx})


class _Op:
    def __init__(self, type, inputs, outputs, attrs):
        self.type, self.inputs, self.outputs, self.attrs = (
            type, inputs, outputs, attrs)

    def input(self, slot):
        return self.inputs[slot]

    def output(self, slot):
        return self.outputs[slot]

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]


def _run_both(op_list, jenv, tenv):
    """Run the ops in both packages' interpreters on their envs."""
    jcore.run_ops([_Op(*o) for o in op_list], jenv, jcore.OpContext(
        eager=True))
    tcore.run_ops([_Op(*o) for o in op_list], tenv, tcore.OpContext(
        tfluid.CPUPlace()))
    return jenv, tenv


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# SelectedRows and SparseTable
# ---------------------------------------------------------------------------
def test_selected_rows_to_dense_and_merge():
    rows = np.array([1, 3, 1])
    vals = np.array([[1.0, 1.0], [2.0, 2.0], [10.0, 10.0]], np.float32)
    t = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 5)
    j = jsr.SelectedRows(rows, vals, 5)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    assert t.to_dense().shape == (5, 2)
    tm, jm = merge_selected_rows(t), jsr.merge_selected_rows(j)
    np.testing.assert_array_equal(tm.rows, jm.rows)
    np.testing.assert_array_equal(tm.values, jm.values)
    np.testing.assert_array_equal(tm.rows, [1, 3])
    np.testing.assert_array_equal(tm.values, [[11.0, 11.0], [2.0, 2.0]])


def test_sparse_table_auto_grow_and_sgd_bitwise():
    tables = [SparseTable(value_dim=4, height=100, seed=7),
              jsr.SparseTable(value_dim=4, height=100, seed=7)]
    r = [t.gather([5, 9, 5]) for t in tables]
    np.testing.assert_array_equal(r[0], r[1])
    np.testing.assert_array_equal(r[0][0], r[0][2])
    assert len(tables[0]) == len(tables[1]) == 2
    rs = np.random.RandomState(2)
    for _ in range(3):
        rows = rs.randint(0, 100, 12)
        vals = rs.randn(12, 4).astype(np.float32)
        tables[0].sgd_update(SelectedRows(torch.from_numpy(rows),
                                          torch.from_numpy(vals), 100), 0.3)
        tables[1].sgd_update(jsr.SelectedRows(rows, vals, 100), 0.3)
    np.testing.assert_array_equal(tables[0].rows(), tables[1].rows())
    np.testing.assert_array_equal(tables[0].to_dense(),
                                  tables[1].to_dense())
    np.testing.assert_array_equal(tables[0].gather([3, 77], auto_grow=False),
                                  tables[1].gather([3, 77], auto_grow=False))
    with pytest.raises(IndexError):
        tables[0].gather([120])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_w", [True, False], ids=["W", "distributed"])
def test_lookup_table_grad_sparse_against_the_jax_package(with_w):
    rs = np.random.RandomState(5)
    ids = np.array([[1], [4], [1], [7]], np.int64)
    dout = rs.randn(4, 3).astype(np.float32)
    attrs = {"is_sparse": True, "padding_idx": 7}
    inputs = {"Ids": ["Ids"], "W": ["W"] if with_w else [],
              "Out@GRAD": ["dOut"]}
    if not with_w:
        attrs["height"] = 10
    op = [("lookup_table_grad", inputs, {"W@GRAD": ["dW"]}, attrs)]
    w = np.zeros((10, 3), np.float32)
    jenv, tenv = _run_both(
        op, {"W": jnp.asarray(w), "Ids": jnp.asarray(ids),
             "dOut": jnp.asarray(dout)},
        {"W": torch.from_numpy(w), "Ids": torch.from_numpy(ids),
         "dOut": torch.from_numpy(dout)})
    j, t = jenv["dW"], tenv["dW"]
    assert isinstance(t, SelectedRows) and t.height == j.height == 10
    np.testing.assert_array_equal(_np(t.rows), np.asarray(j.rows))
    np.testing.assert_array_equal(_np(t.values), np.asarray(j.values))
    assert not _np(t.values)[3].any()  # the padding id's row
    ref = np.zeros((10, 3), np.float32)
    np.add.at(ref, [1, 4, 1], dout[:3])
    np.testing.assert_array_equal(t.to_dense().numpy(), ref)


def test_split_merge_ids_against_the_jax_package():
    ids = np.array([[7], [2], [9], [2], [4]], np.int64)
    rows = {i: np.full(3, float(i), np.float32) for i in [2, 4, 7, 9]}
    split = [("split_ids", {"Ids": ["Ids"]}, {"Out": ["s0", "s1", "s2"]},
              {})]
    jenv, tenv = _run_both(split, {"Ids": jnp.asarray(ids)},
                           {"Ids": torch.from_numpy(ids)})
    for i in range(3):
        np.testing.assert_array_equal(_np(tenv[f"s{i}"]),
                                      np.asarray(jenv[f"s{i}"]))
        assert all(int(k) % 3 == i for k in _np(tenv[f"s{i}"]))
    fetched = {f"r{i}": np.stack([rows[int(k)] for k in _np(tenv[f"s{i}"])])
               if len(tenv[f"s{i}"]) else np.zeros((0, 3), np.float32)
               for i in range(3)}
    jenv.update(fetched)
    tenv.update(fetched)
    merge = [("merge_ids", {"Ids": ["Ids"], "X": ["s0", "s1", "s2"],
                            "Rows": ["r0", "r1", "r2"]},
              {"Out": ["Out"]}, {})]
    _run_both(merge, jenv, tenv)
    assert isinstance(tenv["Out"], torch.Tensor)
    np.testing.assert_array_equal(tenv["Out"].numpy(),
                                  np.asarray(jenv["Out"]))
    np.testing.assert_array_equal(
        tenv["Out"].numpy(), np.stack([rows[int(i)] for i in ids[:, 0]]))


def test_split_ids_of_a_selected_rows():
    rows = np.array([3, 4, 6, 3])
    vals = np.arange(8, dtype=np.float32).reshape(4, 2)
    op = [("split_ids", {"Ids": ["G"]}, {"Out": ["g0", "g1"]}, {})]
    jenv, tenv = _run_both(
        op, {"G": jsr.SelectedRows(rows, vals, 10)},
        {"G": SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                           10)})
    for name in ("g0", "g1"):
        t, j = tenv[name], jenv[name]
        np.testing.assert_array_equal(_np(t.rows), np.asarray(j.rows))
        np.testing.assert_array_equal(_np(t.values), np.asarray(j.values))
        assert t.height == j.height == 10
    np.testing.assert_array_equal(_np(tenv["g1"].rows), [3, 3])


def test_sum_scale_and_sgd_on_selected_rows():
    rs = np.random.RandomState(9)
    a = (np.array([0, 2]), rs.randn(2, 2).astype(np.float32))
    b = (np.array([2]), rs.randn(1, 2).astype(np.float32))
    p = rs.randn(4, 2).astype(np.float32)
    dense = rs.randn(4, 2).astype(np.float32)
    lr = np.array([0.5], np.float32)
    ops = [("sum", {"X": ["a", "b"]}, {"Out": ["s"]}, {}),
           ("scale", {"X": ["s"]}, {"Out": ["h"]}, {"scale": 0.5}),
           ("sum", {"X": ["h", "d"]}, {"Out": ["mixed"]}, {}),
           ("sgd", {"Param": ["p"], "Grad": ["h"], "LearningRate": ["lr"]},
            {"ParamOut": ["p2"]}, {})]
    jenv, tenv = _run_both(
        ops, {"a": jsr.SelectedRows(*a, 4), "b": jsr.SelectedRows(*b, 4),
              "d": jnp.asarray(dense), "p": jnp.asarray(p),
              "lr": jnp.asarray(lr)},
        {"a": SelectedRows(*map(torch.from_numpy, a), 4),
         "b": SelectedRows(*map(torch.from_numpy, b), 4),
         "d": torch.from_numpy(dense), "p": torch.from_numpy(p),
         "lr": torch.from_numpy(lr)})
    for name in ("s", "h"):
        assert isinstance(tenv[name], SelectedRows)
        np.testing.assert_array_equal(_np(tenv[name].rows),
                                      np.asarray(jenv[name].rows))
        np.testing.assert_array_equal(_np(tenv[name].values),
                                      np.asarray(jenv[name].values))
    np.testing.assert_allclose(tenv["mixed"].numpy(),
                               np.asarray(jenv["mixed"]), rtol=1e-6)
    np.testing.assert_allclose(tenv["p2"].numpy(), np.asarray(jenv["p2"]),
                               rtol=1e-6)
    assert not np.array_equal(tenv["p2"].numpy()[[0, 2]], p[[0, 2]])
    np.testing.assert_array_equal(tenv["p2"].numpy()[[1, 3]], p[[1, 3]])
    # the pserver's table update: the same bits as the JAX table's
    tables = [SparseTable(2, height=4, seed=3), jsr.SparseTable(2, height=4,
                                                                seed=3)]
    op = [("sgd", {"Param": ["t"], "Grad": ["h"], "LearningRate": ["lr"]},
           {"ParamOut": ["t"]}, {})]
    _run_both(op, {"t": tables[1], "h": jenv["h"], "lr": jnp.asarray(lr)},
              {"t": tables[0], "h": tenv["h"], "lr": torch.from_numpy(lr)})
    np.testing.assert_array_equal(tables[0].to_dense(), tables[1].to_dense())
    assert len(tables[0]) == 2


def test_selected_rows_values_take_the_amp_cast():
    from paddle_tpu_torch import amp

    sr = SelectedRows(torch.tensor([1]), torch.ones(1, 2), 3)
    cast = amp._cast_value(sr, "bfloat16", ("float32",))
    assert isinstance(cast, SelectedRows) and cast.height == 3
    assert cast.values.dtype == torch.bfloat16 and cast.rows is sr.rows
    assert amp._cast_value(sr, "float32") is sr


def test_the_nan_check_reads_a_selected_rows_values():
    sr = SelectedRows(torch.tensor([0]), torch.tensor([[1.0, np.nan]]), 2)
    with pytest.raises(RuntimeError, match="'g' contains NaN"):
        tcore.check_values_finite([("g", sr)])


# ---------------------------------------------------------------------------
# an is_sparse program
# ---------------------------------------------------------------------------
def _emb_program(fluid, is_sparse, opt="sgd"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            ids, size=[50, 8], is_sparse=is_sparse,
            param_attr=fluid.ParamAttr(name="emb_w"))
        pred = fluid.layers.fc(input=emb, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            input=pred, label=label))
        {"sgd": lambda: fluid.optimizer.SGD(learning_rate=0.5),
         "momentum": lambda: fluid.optimizer.Momentum(0.5, 0.9)}[opt]() \
            .minimize(loss)
    return main, startup, loss


def _emb_feeds(steps=4):
    rs = np.random.RandomState(4)
    return [{"ids": rs.randint(0, 50, (16, 1)).astype(np.int64),
             "label": rs.randn(16, 1).astype(np.float32)}
            for _ in range(steps)]


def _jax_start(main, startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope, {n: np.asarray(scope.find_var(n)) for b in main.blocks
                   for n, v in b.vars.items()
                   if v.persistable and scope.find_var(n) is not None}


def _port_run(main, startup, loss, init, feeds):
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0]) for f in feeds]
    return losses, convert.numpy_state(scope, main), exe


def test_an_is_sparse_program_trains_as_the_dense_one():
    feeds = _emb_feeds()
    jmain, jstart, jloss = _emb_program(jfluid, True)
    jscope, init = _jax_start(jmain, jstart)
    jlosses = []
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        for f in feeds:
            jlosses.append(float(np.asarray(exe.run(
                jmain, feed=f, fetch_list=[jloss])[0]).reshape(-1)[0]))
    sparse = _port_run(*_emb_program(tfluid, True), init, feeds)
    dense = _port_run(*_emb_program(tfluid, False), init, feeds)
    np.testing.assert_allclose(sparse[0], dense[0], rtol=1e-6)
    for n in sparse[1]:
        np.testing.assert_allclose(sparse[1][n], dense[1][n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        np.testing.assert_allclose(sparse[1][n],
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    np.testing.assert_allclose(sparse[0], jlosses, rtol=1e-5)
    touched = np.unique(np.concatenate([f["ids"][:, 0] for f in feeds]))
    untouched = np.setdiff1d(np.arange(50), touched)
    np.testing.assert_array_equal(sparse[1]["emb_w"][untouched],
                                  init["emb_w"][untouched])


def test_fuse_leaves_the_sparse_update_per_op():
    """FLAGS_fuse's plan leaves an update whose Grad is a SelectedRows
    (the is_sparse embedding's) on the per-op path, and buckets the
    rest."""
    main, _, loss = _emb_program(tfluid, True, "momentum")
    assert fusion.sparse_grad_names(main.global_block().ops) == {
        "emb_w@GRAD"}
    fused, plan = fusion.apply(main, feed_names=["ids", "label"],
                               fetch_names=[loss.name])
    assert [p for p, _ in plan.skipped] == ["emb_w"]
    left = [op.input("Param") for op in fused.global_block().ops
            if op.type == "momentum"]
    assert left == [["emb_w"]]
    assert [b["params"] for b in plan.buckets] == [["fc_0.w_0",
                                                     "fc_0.w_1"]]


def test_fuse_runs_a_sparse_sgd_program_as_unfused():
    init = _jax_start(*_emb_program(jfluid, True)[:2])[1]
    feeds = _emb_feeds()
    with tflags.flag_guard(fuse=True):
        fused = _port_run(*_emb_program(tfluid, True), init, feeds)
    plain = _port_run(*_emb_program(tfluid, True), init, feeds)
    assert fused[0] == plain[0]
    for n in plain[1]:
        np.testing.assert_array_equal(fused[1][n], plain[1][n])


def test_an_is_sparse_program_on_the_graph_path_is_the_interpreter(
        recorded_graphs):  # noqa: F811
    """The sparse gradient (ids and rows of static shape) lives inside the
    captured step: the recorded graph path gives the interpreter's losses
    and parameters bitwise."""
    init = _jax_start(*_emb_program(jfluid, True)[:2])[1]
    feeds = _emb_feeds()
    main, startup, loss = _emb_program(tfluid, True)
    graph = _port_run(main, startup, loss, init, feeds)
    assert graph[2].step_mode(main) == "graph"
    with tflags.flag_guard(cuda_graph=False):
        interp = _port_run(*_emb_program(tfluid, True), init, feeds)
    assert graph[0] == interp[0]
    for n in interp[1]:
        np.testing.assert_array_equal(graph[1][n], interp[1][n])


# ---------------------------------------------------------------------------
# the distributed lookup table
# ---------------------------------------------------------------------------
def _table_model(fluid, vocab=40, dim=8):
    ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
    label = fluid.layers.data(name="label", shape=[1], dtype="float32")
    emb = fluid.layers.embedding(
        ids, size=[vocab, dim], is_sparse=True, is_distributed=True,
        param_attr=fluid.ParamAttr(name="table_w"))
    fc = fluid.layers.fc(input=emb, size=1,
                         param_attr=fluid.ParamAttr(name="fc_w"))
    loss = fluid.layers.mean(
        fluid.layers.square_error_cost(input=fc, label=label))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _table_programs(fluid, pservers, trainers=1):
    """(trainer, trainer startup, loss, {ep: (pserver, its startup)})."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _table_model(fluid)
        t = fluid.DistributeTranspiler()
        t.transpile(trainer_id=0, pservers=pservers, trainers=trainers)
        ps = {}
        for ep in pservers.split(","):
            pp = t.get_pserver_program(ep)
            ps[ep] = (pp, t.get_startup_program(ep, pp))
        return t.get_trainer_program(), startup, loss, ps


@pytest.mark.parametrize("trainers", [1, 2])
def test_distributed_table_programs_are_the_jax_packages(trainers):
    pservers = "127.0.0.1:1,127.0.0.1:2"
    j = _table_programs(jfluid, pservers, trainers)
    t = _table_programs(tfluid, pservers, trainers)
    assert desc(t[0]) == desc(j[0])
    assert desc(t[1]) == desc(j[1])
    for ep in pservers.split(","):
        assert desc(t[3][ep][0]) == desc(j[3][ep][0])
        assert desc(t[3][ep][1]) == desc(j[3][ep][1])
    types = [op.type for op in t[0].global_block().ops]
    assert "lookup_table" not in types and types.count("split_ids") == 2
    ls = t[3]["127.0.0.1:1"][0].global_block().ops[-1]
    assert [op.type for op in ls.attrs["PrefetchBlock"].ops] == \
        ["lookup_sparse_table"]
    assert [op.type for op in ls.attrs["OptimizeBlocks"][-1].ops] == (
        ["sum", "scale", "sgd"] if trainers == 2 else ["sgd"])


def _serve(fluid, pp, sp, scope, started, errors):
    try:
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(sp, scope=scope)
        started.set()
        exe.run(pp, scope=scope)
    except BaseException as e:  # reported by the test
        errors.append(e)
        started.set()


def _dense_pserver_state(scope, program):
    return {n: np.asarray(scope.find_var(n)) for n, v in
            program.global_block().vars.items()
            if v.persistable and n != "table_w"
            and scope.find_var(n) is not None}


def _train_table(fluid, rpc, rpc_ops, steps, init=None):
    """Two table pservers of `fluid` in threads and its trainer here.
    `init` (the JAX run's start: {"trainer": state, "pservers": [the
    dense state of each pserver, in order]}) is carried into the port's.
    Returns (losses, [each pserver's table], the start)."""
    eps = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    main, startup, loss, ps = _table_programs(fluid, ",".join(eps))
    scopes = [fluid.Scope() for _ in eps]
    threads, errors, start = [], [], {"pservers": []}
    try:
        for i, ep in enumerate(eps):
            pp, sp = ps[ep]
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(sp, scope=scopes[i])
            if init is not None:
                for n, arr in init["pservers"][i].items():
                    scopes[i].set_var(n, torch.from_numpy(arr.copy()))
            start["pservers"].append(_dense_pserver_state(scopes[i], pp))
            started = threading.Event()
            th = threading.Thread(target=_serve, daemon=True, args=(
                fluid, pp, fluid.Program(), scopes[i], started, errors))
            th.start()
            threads.append(th)
            assert started.wait(JOIN_S) and not errors, errors
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        if init is not None:  # the trainer holds no table_w to load
            for n, arr in init["trainer"].items():
                scope.set_var(n, torch.from_numpy(arr.copy()))
        start["trainer"] = {
            n: np.asarray(scope.find_var(n)) for n, v in
            main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}
        rs = np.random.RandomState(0)
        target = rs.uniform(-1, 1, size=(40,)).astype(np.float32)
        losses = []
        for _ in range(steps):
            ids = rs.randint(0, 40, size=(16, 1)).astype(np.int64)
            lbl = target[ids.reshape(-1)].reshape(-1, 1)
            out, = exe.run(main, feed={"ids": ids, "label": lbl},
                           fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(out).reshape(-1)[0]))
    finally:
        rpc_ops.reset_clients()
        for ep in eps:
            try:
                rpc.VariableClient(ep, connect_timeout=0.3).shutdown()
            except OSError:
                pass
        for th in threads:
            th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    return losses, [sc.find_var("table_w") for sc in scopes], start


def test_two_table_pservers_train_as_the_jax_packages():
    """Two mod-sharded table pservers a package, in threads, 12 steps from
    the JAX run's numpy start: the same losses and, pserver by pserver,
    the same table rows (rtol 1e-5); each pserver holds only its shard's
    ids."""
    jlosses, jtables, start = _train_table(jfluid, jrpc, jrpc_ops, 12)
    tlosses, ttables, _ = _train_table(tfluid, trpc, trpc_ops, 12,
                                       init=start)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for i, (tt, jt) in enumerate(zip(ttables, jtables)):
        assert isinstance(tt, SparseTable) and len(tt) > 0
        assert all(int(r) % 2 == i for r in tt.rows())
        np.testing.assert_array_equal(np.sort(tt.rows()), np.sort(jt.rows()))
        np.testing.assert_allclose(tt.to_dense(), jt.to_dense(), rtol=1e-5,
                                   atol=1e-7)
