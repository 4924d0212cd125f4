"""The parameter server in the port, held to the JAX package on the CPU.

- the RPC runtime: a round trip of tensors and a LoD tensor; the wire's
  bytes are the JAX package's, and a port client with a JAX server, or a
  JAX client with a port server, exchange tensors, LoD tensors and
  SelectedRows;
- the transpiler: the trainer, pserver and startup programs with the
  JAX package's desc_str() for one-pserver Momentum and unsplit
  two-pserver SGD; where a parameter splits, exactly the three repairs
  of ROADMAP §3 items 22-24 (each beside the JAX package's failure);
- the dispatchers and the split plans;
- runs with pservers in daemon threads (the OS picks every port, every
  wait has a timeout, every server is stopped in a `finally`): async
  mode, two sync trainers, a pserver restored from its checkpoint, a
  small distributed run within rtol 1e-5 of the JAX package's from the
  same numpy start (carried by `convert`), two split pservers under
  Momentum, and fluid.Trainer under the TRAINER and PSERVER roles;
- the `train` command's environment, the JAX command's.
"""

import os
import pickle
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import cli as jcli
from paddle_tpu import flags as jflags
from paddle_tpu.core import registry as jreg
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.ops import rpc_ops as jrpc_ops
from paddle_tpu.parallel import rpc as jrpc
from paddle_tpu.transpiler import distribute_transpiler as jdt
from paddle_tpu.transpiler import ps_dispatcher as jpsd

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch import convert, flags as tflags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops import rpc_ops as trpc_ops
from paddle_tpu_torch.parallel import rpc as trpc
from paddle_tpu_torch.transpiler import distribute_transpiler as tdt
from paddle_tpu_torch.transpiler import ps_dispatcher as tpsd

from test_torch_sparse_table import JOIN_S, RPC_DEADLINE_S, desc, free_port

STEPS = 3


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


def _server(rpc, **kw):
    server = rpc.VariableServer(**kw)
    server.start()
    return server


# ---------------------------------------------------------------------------
# the RPC runtime
# ---------------------------------------------------------------------------
def test_rpc_variable_roundtrip():
    store, rounds = {}, []
    server = _server(trpc, num_trainers=1, get_var=lambda n: store[n],
                     put_var=store.__setitem__, on_round=rounds.append)
    try:
        c = trpc.VariableClient(f"127.0.0.1:{server.port}", timeout=JOIN_S)
        x = np.arange(12, dtype="float32").reshape(3, 4)
        c.send_var("w@GRAD", torch.from_numpy(x))
        c.batch_barrier()
        assert rounds == [["w@GRAD"]]
        np.testing.assert_array_equal(store["w@GRAD"], x)
        store["w"] = torch.from_numpy(x * 2)
        np.testing.assert_array_equal(c.get_var("w"), x * 2)
        with pytest.raises(trpc.RpcError, match="nope"):
            c.get_var("nope")
        c.fetch_barrier()
        lt = tfluid.create_lod_tensor(
            np.arange(6, dtype="int64").reshape(6, 1), [[4, 2]],
            tfluid.CPUPlace())
        c.send_var("seq", lt)
        assert store["seq"].lod() == [[0, 4, 6]]
        np.testing.assert_array_equal(store["seq"].numpy(), lt.numpy())
        c.shutdown()
    finally:
        server.close()


def _wire_values(package):
    """One value of each kind, as `package` holds it."""
    x = np.arange(6, dtype="float32").reshape(2, 3)
    rows, vals = np.array([2, 7]), np.ones((2, 3), np.float32)
    lt = package.create_lod_tensor(np.arange(5, dtype="int64").reshape(5, 1),
                                   [[3, 2]], package.CPUPlace())
    if package is tfluid:
        return {"t": torch.from_numpy(x), "lod": lt,
                "sr": SelectedRows(torch.from_numpy(rows),
                                   torch.from_numpy(vals), 9)}
    return {"t": x, "lod": lt, "sr": jsr.SelectedRows(rows, vals, 9)}


def test_the_wire_bytes_are_the_jax_packages():
    got = _wire_values(tfluid)
    want = _wire_values(jfluid)
    for k in got:
        assert pickle.dumps(("send", k, trpc.serialize_var(got[k])),
                            protocol=4) == \
            pickle.dumps(("send", k, jrpc.serialize_var(want[k])),
                         protocol=4), k


def _check_received(value, want):
    if hasattr(want, "rows"):
        np.testing.assert_array_equal(np.asarray(value.rows),
                                      np.asarray(want.rows))
        np.testing.assert_array_equal(np.asarray(value.values),
                                      np.asarray(want.values))
        assert value.height == want.height
    elif hasattr(want, "lod") and callable(want.lod):
        assert value.lod() == want.lod()
        np.testing.assert_array_equal(np.asarray(value.numpy()),
                                      np.asarray(want.numpy()))
    else:
        np.testing.assert_array_equal(np.asarray(value), np.asarray(want))


@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_the_wire_crosses_the_packages(client, server):
    """A client of one package sends each kind to a server of the other,
    which stores what it received and serves it back."""
    crpc = trpc if client == "port" else jrpc
    srpc = trpc if server == "port" else jrpc
    store = {}
    srv = _server(srpc, num_trainers=1, get_var=lambda n: store[n],
                  put_var=store.__setitem__)
    try:
        c = crpc.VariableClient(f"127.0.0.1:{srv.port}")
        sent = _wire_values(tfluid if client == "port" else jfluid)
        ref = _wire_values(jfluid)
        for k, v in sent.items():
            c.send_var(k, v)
            _check_received(store[k], ref[k])
        c.batch_barrier()
        for k in sent:
            _check_received(c.get_var(k), ref[k])
        c.fetch_barrier()
        c.shutdown()
    finally:
        srv.stop()


def test_async_server_updates_on_each_grad():
    store = {"W": torch.ones(4, 2)}
    updates = []

    def on_grad(name):
        store["W"] = store["W"] - 0.1 * torch.from_numpy(store[name])
        updates.append(name)

    server = _server(trpc, num_trainers=1, sync_mode=False,
                     get_var=lambda n: store[n], put_var=store.__setitem__,
                     on_grad=on_grad)
    try:
        c = trpc.VariableClient(f"127.0.0.1:{server.port}", timeout=JOIN_S)
        c.send_var("W@GRAD", np.full((4, 2), 2.0, np.float32))
        np.testing.assert_allclose(c.get_var("W"), np.ones((4, 2)) - 0.2)
        assert updates == ["W@GRAD"]
        c.shutdown()
    finally:
        server.close()


# ---------------------------------------------------------------------------
# the transpiler
# ---------------------------------------------------------------------------
def _net(fluid, opt, width=4, size=2):
    x = fluid.layers.data(name="x", shape=[width], dtype="float32")
    h = fluid.layers.fc(input=x, size=size, bias_attr=False,
                        param_attr=fluid.ParamAttr(name="W"))
    loss = fluid.layers.mean(h)
    {"sgd": lambda: fluid.optimizer.SGD(learning_rate=0.1),
     "momentum": lambda: fluid.optimizer.Momentum(0.1, 0.9),
     "adam": lambda: fluid.optimizer.Adam(0.01)}[opt]().minimize(loss)
    return loss


def _mlp(fluid, opt="momentum"):
    x = fluid.layers.data(name="x", shape=[6], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=8, act="relu")
    p = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(input=p,
                                                            label=y))
    {"sgd": lambda: fluid.optimizer.SGD(learning_rate=0.1),
     "momentum": lambda: fluid.optimizer.Momentum(0.05, 0.9)}[opt]() \
        .minimize(loss)
    return loss


def _transpile(fluid, build, pservers, trainers=1, trainer_id=0,
               sync_mode=True, split_method=None):
    """(trainer, its startup, loss, {ep: (pserver, its startup)}); the
    JAX package's pserver programs may raise, which propagates."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = build(fluid)
        t = fluid.DistributeTranspiler()
        kw = {} if split_method is None else {"split_method": split_method}
        t.transpile(trainer_id=trainer_id, pservers=pservers,
                    trainers=trainers, sync_mode=sync_mode, **kw)
        ps = {}
        for ep in pservers.split(","):
            pp = t.get_pserver_program(ep)
            ps[ep] = (pp, t.get_startup_program(ep, pp))
        return t.get_trainer_program(), startup, loss, ps


@pytest.mark.parametrize("case", [
    ("momentum", "127.0.0.1:1", 1, True),
    ("sgd", "127.0.0.1:1,127.0.0.1:2", 1, True),
    ("momentum", "127.0.0.1:1", 2, True),
    ("sgd", "127.0.0.1:1,127.0.0.1:2", 1, False)],
    ids=["momentum_one_pserver", "sgd_two_pservers",
         "momentum_two_trainers", "sgd_async"])
def test_unsplit_programs_are_the_jax_packages(case):
    opt, pservers, trainers, sync = case
    build = (lambda f: _net(f, opt)) if opt == "sgd" else \
        (lambda f: _mlp(f, opt))
    t = _transpile(tfluid, build, pservers, trainers, sync_mode=sync)
    j = _transpile(jfluid, build, pservers, trainers, sync_mode=sync)
    assert desc(t[0]) == desc(j[0])
    assert desc(t[1]) == desc(j[1])
    for ep in t[3]:
        assert desc(t[3][ep][0]) == desc(j[3][ep][0])
        assert desc(t[3][ep][1]) == desc(j[3][ep][1])
    types = [op.type for op in t[0].global_block().ops]
    assert (opt not in types) and ("send_vars" in types) \
        and (("send_barrier" in types) == sync)
    first = next(iter(t[3]))  # its OptimizeBlocks: a list of blocks
    for pp in (t[3][first][0], j[3][first][0]):
        with pytest.raises(TypeError):
            pp.desc_str()


# the programs of a split parameter (W 256 x 128 over two pservers): where
# they differ from the JAX package's, and why (ROADMAP §3 items 22-24)
DIFFERENCES = {
    "trainer": "none: its split_byref is the JAX package's op, which the "
               "port registers a kernel for (item 22)",
    "startup": "each block runs W's own initializer (uniform_random) at "
               "the block's shape where the JAX package fills it with "
               "zeros (item 23), and a block accumulator is initialized "
               "at the block's shape (item 24)",
    "pserver": "a block's optimizer op takes `<accumulator>.block<i>` of "
               "the block's shape, where the JAX package passes the whole "
               "accumulator and its pserver program raises (item 24)",
}
SPLIT = "127.0.0.1:1,127.0.0.1:2"


def _wide(opt):
    return lambda f: _net(f, opt, width=256, size=128)


def test_a_split_sgd_program_differs_by_the_startup_repair_only():
    t = _transpile(tfluid, _wide("sgd"), SPLIT)
    j = _transpile(jfluid, _wide("sgd"), SPLIT)
    assert desc(t[0]) == desc(j[0])
    assert "split_byref" in [op.type for op in t[0].global_block().ops]
    for i, ep in enumerate(SPLIT.split(",")):
        assert desc(t[3][ep][0]) == desc(j[3][ep][0])
        tops = [(op.type, op.output_arg_names())
                for op in t[3][ep][1].global_block().ops]
        jops = [(op.type, op.output_arg_names())
                for op in j[3][ep][1].global_block().ops]
        assert [o for o in jops if o not in tops] == [
            ("fill_constant", [f"W.block{i}"])]
        assert [o for o in tops if o not in jops] == [
            ("uniform_random", [f"W.block{i}"])]
        init = t[3][ep][1].global_block().ops[-1]
        assert init.attrs["shape"] == [128, 128]


def test_repair_split_byref_has_a_kernel():
    """ROADMAP §3 item 22: the JAX package registers no split_byref, so
    its split trainer program cannot run; the port's views X's rows."""
    assert jreg.get_op_def("split_byref") is None
    x = torch.arange(12.0).reshape(6, 2)
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core import executor_core as tcore

    outs = treg.run_kernel(treg.lookup("split_byref"),
                           tcore.OpContext(tfluid.CPUPlace()), {"X": [x]},
                           {"sections": [4, 2], "axis": 0})["Out"]
    assert [o.shape for o in outs] == [(4, 2), (2, 2)]
    assert all(o.untyped_storage().data_ptr() == x.untyped_storage()
               .data_ptr() for o in outs)
    np.testing.assert_array_equal(torch.cat(outs).numpy(), x.numpy())
    t = _transpile(jfluid, _wide("sgd"), SPLIT)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(t[1])
    with pytest.raises(Exception, match="split_byref"):
        exe.run(t[0], feed={"x": np.ones((2, 256), np.float32)},
                fetch_list=[t[2]])


def test_repair_split_blocks_start_from_their_initializer():
    """ROADMAP §3 item 23: the JAX pserver starts a split block at zero;
    the port's draws it from W's initializer at the block's shape."""
    for fluid, zero in ((jfluid, True), (tfluid, False)):
        _, _, _, ps = _transpile(fluid, _wide("sgd"), SPLIT)
        for i, (pp, sp) in enumerate(ps.values()):
            scope = fluid.Scope()
            fluid.Executor(fluid.CPUPlace()).run(sp, scope=scope)
            block = np.asarray(scope.find_var(f"W.block{i}"))
            assert block.shape == (128, 128)
            assert (not block.any()) == zero
            if not zero:
                limit = np.sqrt(6.0 / (256 + 128))  # Xavier's uniform
                assert np.abs(block).max() <= limit
                assert block.std() > limit / 3


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_repair_block_accumulators_take_the_blocks_shape(opt):
    """ROADMAP §3 item 24: the JAX package's pserver program for a split
    parameter under an optimizer with accumulators raises; the port's
    block takes accumulators of its own shape."""
    with pytest.raises(Exception, match="ShapeError|must match"):
        _transpile(jfluid, _wide(opt), SPLIT)
    _, _, _, ps = _transpile(tfluid, _wide(opt), SPLIT)
    accs = {"momentum": ["W_velocity_0"],
            "adam": ["W_moment1_0", "W_moment2_0"]}[opt]
    for i, (pp, sp) in enumerate(ps.values()):
        (op,) = pp.blocks[1].ops
        for a in accs:
            name = f"{a}.block{i}"
            assert name in op.input_arg_names()
            assert name in op.output_arg_names()
            assert pp.global_block().vars[name].shape == (128, 128)
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(sp, scope=scope)
        for a in accs:
            assert tuple(scope.find_var(f"{a}.block{i}").shape) == (128, 128)


def test_ps_dispatchers_are_the_jax_packages():
    class V:
        def __init__(self, name):
            self.name = name

    eps = ["a:1", "b:2", "c:3"]
    names = [[V("p0"), V("p1")], [V("p2"), V("p3")], [V("w.block0"),
                                                      V("b.block1")]]
    for cls in ("RoundRobin", "HashName"):
        t, j = getattr(tpsd, cls)(eps), getattr(jpsd, cls)(eps)
        assert [t.dispatch(v) for v in names] == \
            [j.dispatch(v) for v in names]
        t.reset()
        j.reset()
        assert t.dispatch(names[0]) == j.dispatch(names[0])
    assert tpsd.RoundRobin(eps).dispatch(names[0]) == ["a:1", "b:2"]


@pytest.mark.parametrize("shape,n,floor", [
    ((10,), 4, 8192), ((1000, 64), 4, 8192), ((256, 128), 2, 8192),
    ((3, 5, 7, 11), 3, 100), ((2048, 1000), 2, 8192)])
def test_split_plans_are_the_jax_packages(shape, n, floor):
    class V:
        def __init__(self, name, shape):
            self.name, self.shape = name, shape

    got = tdt.split_dense_variable([V("w", shape)], n, floor)
    assert got == jdt.split_dense_variable([V("w", shape)], n, floor)
    assert sum(int(p.split(":")[2]) for p in got) == int(np.prod(shape))


# ---------------------------------------------------------------------------
# runs, pservers in threads
# ---------------------------------------------------------------------------
class Cluster:
    """Pservers of `fluid` serving in daemon threads on ports the OS picks,
    each from its startup program or from `states` ({ep index: {name:
    array}}), stopped (and joined) by close()."""

    def __init__(self, fluid, rpc, rpc_ops, build, n=1, trainers=1,
                 sync_mode=True, states=None, ckpt=None):
        self.fluid, self.rpc, self.rpc_ops = fluid, rpc, rpc_ops
        self.eps = [f"127.0.0.1:{free_port()}" for _ in range(n)]
        self.build, self.trainers, self.sync_mode = build, trainers, sync_mode
        self.scopes = [fluid.Scope() for _ in self.eps]
        self.threads, self.errors = [], []
        ps = _transpile(fluid, build, ",".join(self.eps), trainers,
                        sync_mode=sync_mode)[3]
        try:
            for i, ep in enumerate(self.eps):
                pp, sp = ps[ep]
                if ckpt is not None:
                    pp.global_block().ops[-1].attrs["checkpoint_path"] = \
                        ckpt
                fluid.Executor(fluid.CPUPlace()).run(sp, scope=self.scopes[i])
                for name, arr in (states or {}).get(i, {}).items():
                    self.scopes[i].set_var(name, torch.from_numpy(
                        np.array(arr)))
                th = threading.Thread(target=self._serve, args=(pp, i),
                                      daemon=True)
                th.start()
                self.threads.append(th)
                self._wait_ready(ep, th)
        except BaseException:
            self.close()
            raise

    def _wait_ready(self, ep, th):
        """Until the pserver at `ep` accepts a connection (it restores its
        checkpoint first), or JOIN_S."""
        deadline = time.monotonic() + JOIN_S
        while True:
            try:
                socket.create_connection(ep.rsplit(":", 1), timeout=1).close()
                return
            except OSError:
                if time.monotonic() > deadline or not th.is_alive():
                    raise AssertionError(f"pserver {ep} did not start: "
                                         f"{self.errors}")
                time.sleep(0.01)

    def _serve(self, pp, i):
        try:
            self.fluid.Executor(self.fluid.CPUPlace()).run(
                pp, scope=self.scopes[i])
        except BaseException as e:
            self.errors.append(e)

    def programs(self, trainer_id=0):
        return _transpile(self.fluid, self.build, ",".join(self.eps),
                          self.trainers, trainer_id,
                          sync_mode=self.sync_mode)

    def state(self, i):
        return {n: np.array(self.scopes[i].find_var(n))
                for n in self.scopes[i].local_var_names()
                if self.scopes[i].find_var(n) is not None
                and not n.endswith("@GRAD")}

    def close(self):
        self.rpc_ops.reset_clients()
        for ep in self.eps:
            try:
                self.rpc.VariableClient(ep, connect_timeout=0.3).shutdown()
            except OSError:
                pass
        for th in self.threads:
            th.join(JOIN_S)
        assert not any(th.is_alive() for th in self.threads)
        assert not self.errors, self.errors


def _feeds(steps=STEPS, batch=8, seed=3):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(batch, 6).astype(np.float32),
             "y": rs.randn(batch, 1).astype(np.float32)}
            for _ in range(steps)]


def _train(fluid, main, startup, loss, feeds, init=None, scope=None):
    scope = scope or fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if init is not None:
        convert.load_numpy_state(scope, main, init, tfluid.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in feeds]
    return losses, scope


PARAMS = ["fc_0.w_0", "fc_0.w_1", "fc_1.w_0", "fc_1.w_1"]


def _thread_clients(rpc_ops, rpc):
    """A `_client` for the JAX package's `rpc_ops` with one connection an
    endpoint for each thread, as the port keeps (its own is one an
    endpoint, which trainers in threads would share), each reply waited
    for at most RPC_DEADLINE_S; kept in its `_client_cache`, so its
    reset_clients closes them."""
    lock = threading.Lock()

    def client(ep):
        key = (threading.get_ident(), ep)
        with lock:
            c = rpc_ops._client_cache.get(key)
            if c is None:
                c = rpc_ops._client_cache[key] = rpc.VariableClient(ep)
                c._sock.settimeout(RPC_DEADLINE_S)
        return c
    return client


def _in_threads(fn, n):
    """[fn(0), ..., fn(n - 1)], each trainer in a daemon thread of its own
    (one alone in this thread), each waited for at most JOIN_S."""
    if n == 1:
        return [fn(0)]
    results, errors = {}, []

    def run(t):
        try:
            results[t] = fn(t)
        except BaseException as e:
            errors.append(e)

    ths = [threading.Thread(target=run, args=(t,), daemon=True)
           for t in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in ths) and not errors, errors
    return [results[t] for t in range(n)]


def _jax_train(main, startup, loss, feeds):
    """The JAX package's trainer: (its numpy start after its startup, its
    losses, its scope)."""
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.find_var(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in feeds]
    return init, losses, scope


@pytest.mark.parametrize("sync_mode,trainers", [
    (True, 1), (False, 1), (True, 2)],
    ids=["sync", "async", "sync-two-trainers"])
def test_a_distributed_run_is_the_jax_packages(sync_mode, trainers,
                                               monkeypatch):
    """One pserver, Momentum, sync or async mode, one trainer or two (in
    threads, whose grads each sync round averages): the port's run from
    the JAX run's numpy start (each trainer's and the pserver's state,
    through convert) ends within rtol 1e-5 of it, each trainer's losses
    and parameters, and its parameters are the pserver's."""
    monkeypatch.setattr(jrpc_ops, "_client",
                        _thread_clients(jrpc_ops, jrpc))
    feeds = [_feeds(seed=3 + t) for t in range(trainers)]
    jc = Cluster(jfluid, jrpc, jrpc_ops, _mlp, trainers=trainers,
                 sync_mode=sync_mode)
    try:
        jstart = {0: jc.state(0)}
        progs = [jc.programs(t) for t in range(trainers)]
        jruns = _in_threads(lambda t: _jax_train(*progs[t][:3], feeds[t]),
                            trainers)
    finally:
        jc.close()
    tc = Cluster(tfluid, trpc, trpc_ops, _mlp, trainers=trainers,
                 sync_mode=sync_mode, states=jstart)
    try:
        progs = [tc.programs(t) for t in range(trainers)]
        truns = _in_threads(lambda t: _train(
            tfluid, *progs[t][:3], feeds[t], init=jruns[t][0]), trainers)
        served = tc.state(0)
    finally:
        tc.close()
    for (_, jlosses, jscope), (tlosses, port_scope) in zip(jruns, truns):
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
        for n in PARAMS:
            np.testing.assert_allclose(np.array(port_scope.find_var(n)),
                                       np.asarray(jscope.find_var(n)),
                                       rtol=1e-5, atol=1e-7, err_msg=n)
            np.testing.assert_array_equal(np.array(port_scope.find_var(n)),
                                          served[n])


def _local(build, feeds, init):
    """The untranspiled program of `build` from `init`: the reference the
    pserver runs are held to."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = build(tfluid)
    return _train(tfluid, main, startup, loss, feeds, init)


def _pull_start(main, startup):
    """The trainer's start: its startup's state, each param pulled from
    the pserver its recv names (a get before the first round), a split
    one's blocks joined."""
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    blocks = {}
    for op in main.global_block().ops:
        if op.type == "recv":
            for name, ep in zip(op.output("Out"), op.attrs["epmap"]):
                blocks.setdefault(name.split(".block")[0], []).append(
                    trpc_ops._client(ep).get_var(name))
    for name, parts in blocks.items():
        assert scope.find_var(name) is not None, name
        scope.set_var(name, torch.from_numpy(np.concatenate(parts)))
    return convert.numpy_state(scope, main)


@pytest.mark.parametrize("sync_mode", [True, False], ids=["sync", "async"])
def test_pserver_runs_are_the_untranspiled_program(sync_mode):
    """One trainer against one pserver, sync and async mode: after a pull
    of the pserver's params, the same losses and parameters as the
    untranspiled program from that start, bitwise."""
    feeds = _feeds()
    c = Cluster(tfluid, trpc, trpc_ops, _mlp, sync_mode=sync_mode)
    try:
        main, startup, loss, _ = c.programs()
        start = _pull_start(main, startup)
        losses, scope = _train(tfluid, main, startup, loss, feeds, start)
    finally:
        c.close()
    want, wscope = _local(_mlp, feeds, start)
    assert losses == want
    for n in PARAMS:
        np.testing.assert_array_equal(np.array(scope.find_var(n)),
                                      np.array(wscope.find_var(n)))


def test_two_split_pservers_under_momentum():
    """A parameter split over two pservers (the repairs' path): the same
    losses and parameters as the untranspiled program from the pulled
    start, bitwise."""
    def wide(f):
        x = f.layers.data(name="x", shape=[6], dtype="float32")
        y = f.layers.data(name="y", shape=[1], dtype="float32")
        h = f.layers.fc(input=x, size=4096, act="relu")
        p = f.layers.fc(input=h, size=1)
        loss = f.layers.mean(f.layers.square_error_cost(input=p, label=y))
        f.optimizer.Momentum(0.01, 0.9).minimize(loss)
        return loss

    feeds = _feeds()
    c = Cluster(tfluid, trpc, trpc_ops, wide, n=2)
    try:
        main, startup, loss, _ = c.programs()
        types = [op.type for op in main.global_block().ops]
        # fc_0.w_0 (6 x 4096) splits; the others are under 2 x 8192
        assert types.count("split_byref") == 1 and "concat" in types
        start = _pull_start(main, startup)
        losses, scope = _train(tfluid, main, startup, loss, feeds, start)
    finally:
        c.close()
    want, wscope = _local(wide, feeds, start)
    assert losses == want
    for n in ("fc_0.w_0", "fc_1.w_0"):
        np.testing.assert_array_equal(np.array(scope.find_var(n)),
                                      np.array(wscope.find_var(n)))


def test_two_sync_trainers_average_their_grads():
    """Two trainers in threads (one connection each) against one sync
    pserver: each round applies the mean of their grads, so both end with
    the parameters of the untranspiled program on the two halves' batch,
    within rtol 1e-6."""
    feeds = [_feeds(seed=5), _feeds(seed=6)]
    c = Cluster(tfluid, trpc, trpc_ops, lambda f: _mlp(f, "sgd"),
                trainers=2)
    results, errors = {}, []
    try:
        start = None
        progs = [c.programs(t) for t in range(2)]
        start = _pull_start(progs[0][0], progs[0][1])

        def trainer(t):
            try:
                main, startup, loss, _ = progs[t]
                results[t] = _train(tfluid, main, startup, loss, feeds[t],
                                    start)
            except BaseException as e:
                errors.append(e)

        ths = [threading.Thread(target=trainer, args=(t,)) for t in (0, 1)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(JOIN_S)
        assert not any(th.is_alive() for th in ths) and not errors, errors
    finally:
        c.close()
    both = [{k: np.concatenate([a[k], b[k]]) for k in a}
            for a, b in zip(*feeds)]
    _, wscope = _local(lambda f: _mlp(f, "sgd"), both, start)
    for n in PARAMS:
        a, b = (np.array(results[t][1].find_var(n)) for t in (0, 1))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.array(wscope.find_var(n)),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_a_pserver_restores_from_its_checkpoint(tmp_path):
    """A pserver with a checkpoint path saves after every round; a new one
    on the same path serves those params and velocities, and training
    goes on as if nothing stopped."""
    ckpt = str(tmp_path / "ps.ckpt")
    feeds = _feeds(4)
    c = Cluster(tfluid, trpc, trpc_ops, _mlp, ckpt=ckpt)
    try:
        main, startup, loss, _ = c.programs()
        start = _pull_start(main, startup)
        _, scope = _train(tfluid, main, startup, loss, feeds[:2], start)
        saved = c.state(0)
    finally:
        c.close()
    assert os.path.exists(ckpt)
    c = Cluster(tfluid, trpc, trpc_ops, _mlp, ckpt=ckpt)
    try:
        restored = c.state(0)
        main, startup, loss, _ = c.programs()
        exe = tfluid.Executor(tfluid.CPUPlace())
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0].reshape(-1)[0])
                  for f in feeds[2:]]
    finally:
        c.close()
    for n in PARAMS + ["fc_0.w_0_velocity_0"]:
        if n in saved:
            np.testing.assert_array_equal(saved[n], restored[n])
    want, wscope = _local(_mlp, feeds, start)
    assert losses == want[2:]
    for n in PARAMS:
        np.testing.assert_array_equal(np.array(scope.find_var(n)),
                                      np.array(wscope.find_var(n)))


# ---------------------------------------------------------------------------
# the Trainer's roles and the train command
# ---------------------------------------------------------------------------
def test_the_trainer_under_the_pserver_and_trainer_roles(monkeypatch):
    def train_func():
        x = tfluid.layers.data(name="x", shape=[6], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        p = tfluid.layers.fc(input=x, size=1)
        return tfluid.layers.mean(
            tfluid.layers.square_error_cost(input=p, label=y))

    def opt():
        return tfluid.optimizer.SGD(learning_rate=0.1)

    port = free_port()
    monkeypatch.setenv("PADDLE_PSERVER_IPS", "127.0.0.1")
    monkeypatch.setenv("PADDLE_PSERVER_PORT", str(port))
    monkeypatch.setenv("PADDLE_CURRENT_IP", "127.0.0.1")
    monkeypatch.setenv("PADDLE_TRAINING_ROLE", "PSERVER")
    tfluid.unique_name.switch()
    ps = tfluid.Trainer(train_func, opt, place=tfluid.CPUPlace())
    assert ps.train_program.global_block().ops[-1].type == "listen_and_serv"
    errors = []

    def serve():
        try:
            ps.train(num_epochs=1, event_handler=lambda e: None)
        except BaseException as e:
            errors.append(e)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    monkeypatch.setenv("PADDLE_TRAINING_ROLE", "TRAINER")
    steps = []
    try:
        tfluid.unique_name.switch()
        tr = tfluid.Trainer(train_func, opt, place=tfluid.CPUPlace())
        w0 = np.array(tr.scope.find_var("fc_0.w_0"))

        def reader():
            rs = np.random.RandomState(0)
            for _ in range(3):
                x = rs.randn(8, 6).astype(np.float32)
                yield [(x[i], x[i, :1]) for i in range(8)]

        tr.train(num_epochs=1, reader=reader, feed_order=["x", "y"],
                 event_handler=lambda e: steps.append(type(e).__name__))
        w1 = np.array(tr.scope.find_var("fc_0.w_0"))
    finally:
        trpc_ops.reset_clients()
        th.join(JOIN_S)
    assert not th.is_alive() and not errors, errors
    assert steps.count("EndStepEvent") == 3
    assert not np.array_equal(w0, w1)
    np.testing.assert_array_equal(
        w1, np.array(ps.scope.find_var("fc_0.w_0")))


def test_the_train_command_sets_the_jax_commands_environment(monkeypatch):
    argv = ["train", "--role", "pserver", "--trainers", "2",
            "--trainer-id", "1", "--pservers", "127.0.0.1:1,127.0.0.1:2",
            "--current-endpoint", "127.0.0.1:2", "script.py", "--steps", "3"]
    calls = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        def execve(path, args, env, name=name):
            calls[name] = (path, args, {k: v for k, v in env.items()
                                        if k.startswith("PADDLE_")})

        monkeypatch.setattr(mod.os, "execve", execve)
        mod.main(argv)
    assert calls["port"] == calls["jax"]
    assert calls["port"][2] == {
        "PADDLE_TRAINING_ROLE": "PSERVER", "PADDLE_TRAINERS": "2",
        "PADDLE_TRAINER_ID": "1",
        "PADDLE_PSERVERS": "127.0.0.1:1,127.0.0.1:2",
        "PADDLE_CURRENT_ENDPOINT": "127.0.0.1:2"}
    assert calls["port"][1][1:] == ["script.py", "--steps", "3"]


def test_bf16_crosses_the_wire_as_its_float32_values():
    """numpy has no bfloat16: the port sends a bf16 tensor widened to
    float32 (exactly), and reads the JAX package's "bfloat16" arrays as
    their float32 values."""
    import jax.numpy as jnp

    x = torch.tensor([[1.5, -2.25], [3.0, 1e-3]], dtype=torch.bfloat16)
    msg = trpc.serialize_var(x)
    assert msg["dtype"] == "float32"
    np.testing.assert_array_equal(trpc.deserialize_var(msg),
                                  x.float().numpy())
    jmsg = jrpc.serialize_var(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert jmsg["dtype"] == "bfloat16"
    got = trpc.deserialize_var(jmsg)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())


def _pserver_checkpoint(tmp_path):
    path = str(tmp_path / "pserver.ckpt")
    scope = tfluid.Scope()
    scope.var("W")
    scope.set_var("W", torch.arange(12, dtype=torch.float32).reshape(3, 4))
    trpc_ops.save_pserver_checkpoint(path, scope, ["W"])
    return path


def test_load_pserver_checkpoint_goes_to_the_card_unless_told(
        tmp_path, monkeypatch):
    """With no device argument the state goes to the card, CUDAPlace(0):
    where there is none it raises, never loading onto the host instead."""
    path = _pserver_checkpoint(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        trpc_ops.load_pserver_checkpoint(path, tfluid.Scope())


def test_load_pserver_checkpoint_on_the_host_when_asked(tmp_path):
    path = _pserver_checkpoint(tmp_path)
    scope = tfluid.Scope()
    assert trpc_ops.load_pserver_checkpoint(path, scope, "cpu") == ["W"]
    w = scope.find_var("W")
    assert w.device.type == "cpu"
    np.testing.assert_array_equal(
        w.numpy(), np.arange(12, dtype=np.float32).reshape(3, 4))
