"""The parameter server on the card (marked `cuda`, skipped without one;
this file imports no JAX: run it on the card with
`python -m pytest tests/test_torch_pserver_card.py -m cuda`).

- a pserver program run by Executor(CUDAPlace(0)) updates on the card,
  and a trainer on the card against it ends bitwise equal to the
  untranspiled program's captured steps from the same (pulled) start;
- an is_sparse program's captured step is its interpreter's, bitwise;
- the params `recv` writes into the scope reach a captured program
  sharing the scope at its next replay.
"""

import socket
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert, flags
from paddle_tpu_torch.ops import rpc_ops
from paddle_tpu_torch.parallel import rpc

JOIN_S = 60


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mlp():
    x = fluid.layers.data(name="x", shape=[32], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=64, act="relu")
    p = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(input=p,
                                                            label=y))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


def _programs(ep=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _mlp()
        if ep is None:
            return main, startup, loss, None
        t = fluid.DistributeTranspiler()
        t.transpile(trainer_id=0, pservers=ep, trainers=1)
        pp = t.get_pserver_program(ep)
        return (t.get_trainer_program(), startup, loss,
                (pp, t.get_startup_program(ep, pp)))


def _feeds(n):
    rs = np.random.RandomState(3)
    return [{"x": rs.randn(16, 32).astype(np.float32),
             "y": rs.randn(16, 1).astype(np.float32)} for _ in range(n)]


class _Pserver:
    """One pserver on the card in a daemon thread."""

    def __init__(self, ep, pp, sp):
        self.ep, self.scope, self.errors = ep, fluid.Scope(), []
        fluid.Executor(fluid.CUDAPlace(0)).run(sp, scope=self.scope)
        self.thread = threading.Thread(target=self._serve, args=(pp,),
                                       daemon=True)
        self.thread.start()

    def _serve(self, pp):
        try:
            fluid.Executor(fluid.CUDAPlace(0)).run(pp, scope=self.scope)
        except BaseException as e:
            self.errors.append(e)

    def close(self):
        rpc_ops.reset_clients()
        try:
            rpc.VariableClient(self.ep, connect_timeout=0.3).shutdown()
        except OSError:
            pass
        self.thread.join(JOIN_S)
        assert not self.thread.is_alive() and not self.errors, self.errors


def _pull(main, startup, scope):
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    for op in main.global_block().ops:
        if op.type == "recv":
            for name, ep in zip(op.output("Out"), op.attrs["epmap"]):
                scope.set_var(name, torch.from_numpy(
                    rpc_ops._client(ep).get_var(name)).cuda())


@pytest.mark.cuda
def test_a_pserver_on_the_card_trains_as_the_captured_program():
    _need_card()
    ep = f"127.0.0.1:{_free_port()}"
    main, startup, loss, (pp, sp) = _programs(ep)
    feeds = _feeds(4)
    ps = _Pserver(ep, pp, sp)
    try:
        scope = fluid.Scope()
        _pull(main, startup, scope)
        start = convert.numpy_state(scope, main)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
               for f in feeds]
        assert exe.step_mode(main) == "interpreter"
        served = {n: ps.scope.find_var(n) for n in ("fc_0.w_0", "fc_1.w_0")}
        assert all(t.device.type == "cuda" for t in served.values())
    finally:
        ps.close()
    pmain, pstartup, ploss, _ = _programs()
    pscope = fluid.Scope()
    pexe = fluid.Executor(fluid.CUDAPlace(0))
    pexe.run(pstartup, scope=pscope)
    convert.load_numpy_state(pscope, pmain, start, fluid.CUDAPlace(0))
    want = [pexe.run(pmain, feed=f, fetch_list=[ploss], scope=pscope)[0]
            for f in feeds]
    assert pexe.step_mode(pmain) == "graph"
    np.testing.assert_array_equal(np.array(got), np.array(want))
    for n, t in served.items():
        np.testing.assert_array_equal(t.cpu().numpy(),
                                      pscope.find_var(n).cpu().numpy())
        np.testing.assert_array_equal(scope.find_var(n).cpu().numpy(),
                                      pscope.find_var(n).cpu().numpy())


@pytest.mark.cuda
def test_an_is_sparse_program_is_captured_as_interpreted():
    _need_card()

    def run(graph):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            e = fluid.layers.embedding(ids, size=[1000, 64], is_sparse=True,
                                       param_attr=fluid.ParamAttr(name="e"))
            p = fluid.layers.fc(input=e, size=1)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                input=p, label=y))
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        main.random_seed = startup.random_seed = 7
        rs = np.random.RandomState(5)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        with flags.flag_guard(cuda_graph=graph):
            losses = [exe.run(main, feed={
                "ids": rs.randint(0, 1000, (64, 1)).astype(np.int64),
                "y": rs.randn(64, 1).astype(np.float32)}, fetch_list=[loss],
                scope=scope)[0] for _ in range(4)]
            mode = exe.step_mode(main)
        return mode, np.array(losses), scope.find_var("e").cpu().numpy()

    g, i = run(True), run(False)
    assert (g[0], i[0]) == ("graph", "interpreter")
    np.testing.assert_array_equal(g[1], i[1])
    np.testing.assert_array_equal(g[2], i[2])


@pytest.mark.cuda
def test_recv_writes_the_params_a_captured_program_reads():
    _need_card()
    ep = f"127.0.0.1:{_free_port()}"
    main, startup, loss, (pp, sp) = _programs(ep)
    test = main.clone(for_test=True)
    ps = _Pserver(ep, pp, sp)
    try:
        scope = fluid.Scope()
        _pull(main, startup, scope)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        f = _feeds(1)[0]
        before = [exe.run(test, feed=f, fetch_list=[loss], scope=scope)[0]
                  for _ in range(2)]  # eager, then the capture
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        after = exe.run(test, feed=f, fetch_list=[loss], scope=scope)[0]
        assert exe.step_mode(test) == "graph"
    finally:
        ps.close()
    assert before[0] == before[1] and after != before[0]
