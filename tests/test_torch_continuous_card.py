"""paddle_tpu_torch.serve.continuous on the card (no JAX in this file).

On CUDAPlace(0) each rung's step is a captured CUDA graph and the slot
bank lives on the card: a join/leave decode is bitwise its solo replay
through a plain Executor at the server's rung (one live row, the rest
the bank's zero pad rows), with zero steady-state captures; the interop
runner replays each branch on a CUDA stream of its own, bitwise the
single program. `cuda` cases: they skip without a card.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.serve.continuous import (ContinuousConfig,
                                               ContinuousServer)


@pytest.fixture(autouse=True)
def _fresh_state():
    monitor.reset()
    flags.reset()
    yield
    monitor.reset()
    flags.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rungs' graphs are captured there")
    return torch.device("cuda", 0)


def _decode_program(place, feat=4):
    """y = tanh(fc(x)), state x <- y (tests/test_torch_continuous.py's
    cell)."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[feat], dtype="float32")
        y = fluid.layers.fc(input=x, size=feat, act="tanh")
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(place).run(startup)
    return prog, scope, y


def _solo_decode(prog, scope, y, row, steps, rows, place):
    exe = fluid.Executor(place)
    cur = np.zeros((rows, np.asarray(row).size), dtype="float32")
    cur[0] = row
    out = []
    with fluid.scope_guard(scope):
        for _ in range(steps):
            got = exe.run(prog, feed={"x": cur}, fetch_list=[y])[0]
            out.append(got[0])
            cur = np.zeros_like(cur)
            cur[0] = got[0]
    return np.stack(out, axis=0)


def _join_leave(srv, rows):
    r1, r2, r3 = rows
    f1 = srv.submit({"x": r1}, steps=5)
    srv.step_once()
    f2 = srv.submit({"x": r2}, steps=2)
    srv.step_once()
    srv.step_once()
    f3 = srv.submit({"x": r3}, steps=3)
    while not (f1.done() and f2.done() and f3.done()):
        srv.step_once()
    return ((r1, f1, 5), (r2, f2, 2), (r3, f3, 3))


@pytest.mark.cuda
def test_card_join_leave_is_bitwise_its_solo_replay(cuda_device):
    """On the card: the rung's step is a captured CUDA graph, the bank
    lives on the card, and the join/leave decode is bitwise the solo
    replay at the same rung; zero steady-state captures."""
    card = fluid.CUDAPlace(0)
    prog, scope, y = _decode_program(card, feat=16)
    srv = ContinuousServer(place=card, config=ContinuousConfig(
        max_slots=4, slot_buckets=(4,)))
    m = srv.add_model("m", prog, ["x"], [y], state={"x": y.name},
                      scope=scope)
    srv.start(warm=True, loop=False)
    try:
        assert m.exe.step_mode(prog) == "graph"
        assert m.bank.gather(np.array([0]))["x"].is_cuda
        rng = np.random.RandomState(0)
        rows = [rng.randn(16).astype("float32") for _ in range(3)]
        done = _join_leave(srv, rows)
        assert srv.stats()["steady_state_compiles"] == 0
    finally:
        srv.stop()
    for row, fut, steps in done:
        ref = _solo_decode(prog, scope, y, row, steps, rows=4, place=card)
        assert np.array_equal(fut.result(timeout=5)[0], ref)


@pytest.mark.cuda
def test_card_interop_branches_on_their_streams(cuda_device):
    """On the card each branch replays its own graph on its own stream;
    the outputs are bitwise the single program's."""
    card = fluid.CUDAPlace(0)
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=4, act="tanh")
        head = fluid.layers.fc(input=x, size=4)
    scope = fluid.Scope()
    exe = fluid.Executor(card)
    with fluid.scope_guard(scope):
        exe.run(startup)
    srv = ContinuousServer(place=card, config=ContinuousConfig(
        max_slots=2, slot_buckets=(2,)))
    m = srv.add_model("two", prog, ["x"], [h, head], state={"x": h.name},
                      scope=scope, interop=True)
    assert len(m.runner.streams) == 2
    srv.start(warm=True)
    try:
        row = np.arange(4, dtype="float32")
        out_h, out_head = srv.infer({"x": row}, steps=3, timeout=30)
        assert srv.stats()["steady_state_compiles"] == 0
    finally:
        srv.stop()
    with fluid.scope_guard(scope):
        cur, ref_h, ref_head = np.zeros((2, 4), "float32"), [], []
        cur[0] = row
        for _ in range(3):
            rh, rhead = exe.run(prog, feed={"x": cur}, fetch_list=[h, head])
            ref_h.append(rh[0])
            ref_head.append(rhead[0])
            cur = np.zeros_like(cur)
            cur[0] = rh[0]
    assert np.array_equal(out_h, np.stack(ref_h))
    assert np.array_equal(out_head, np.stack(ref_head))
