"""The compile-time services on the card (marked `cuda`, skipped without
one; this file imports no JAX: run it on the card with
`python -m pytest tests/test_torch_compile_services_card.py -m cuda`).

- FLAGS_compile_cache_cap evicts the least recently used prepared step
  and frees its CapturedStep and CUDA graph, and the recaptured step's
  outputs are the first capture's, bitwise;
- FLAGS_verify refuses a broken program at its prepare, before any op of
  it runs;
- a Go block sends CUDA tensors through a buffered channel to Selects
  with a default case: the values equal the host's;
- a goroutine launching work on its own stream leaves another program's
  capture intact (captures run capture_error_mode="thread_local").
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import concurrency, flags
from paddle_tpu_torch.analysis import ProgramVerificationError


def _mlp():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        p = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _momentum_net():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3)
        b = fluid.layers.batch_norm(c, act="relu")
        p = fluid.layers.fc(b, size=5, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(p, lab))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
        main.random_seed = startup.random_seed = 5
    return main, startup, loss


def _go_select_program(n):
    """A Go block computes n [256, 256] products on its own stream and
    sends each through a buffered channel, then says "done" over a second
    one; the main block waits for "done", and n Selects with a default
    case receive the n values. Returns the n received vars."""
    csp = concurrency
    ch = csp.make_channel(dtype="float32", capacity=n)
    done = csp.make_channel(dtype="float32", capacity=1)
    x = fluid.layers.fill_constant(shape=[256, 256], dtype="float32",
                                   value=0.5)
    with csp.Go():
        y = x
        for k in range(n):
            y = fluid.layers.matmul(y, x)
            csp.channel_send(ch, fluid.layers.scale(y, scale=float(k + 1)))
        csp.channel_send(done, x)
    flag = fluid.layers.fill_constant(shape=[256, 256], dtype="float32",
                                      value=0.0)
    csp.channel_recv(done, flag)
    outs = []
    for _ in range(n):
        got = fluid.layers.fill_constant(shape=[256, 256], dtype="float32",
                                         value=-1.0)
        sel = csp.Select()
        with sel:
            with sel.case(csp.channel_recv, ch, got):
                pass
            with sel.default():
                pass
        outs.append(got)
    return outs


@pytest.mark.cuda
def test_eviction_frees_the_graph_and_recaptures_bitwise_on_the_card():
    """Batches 8, 16, 32, then 8 again under FLAGS_compile_cache_cap=2 on
    the card: two evictions; the evicted steps' CapturedSteps and their
    CUDA graphs are collected (nothing else holds them), and the
    recaptured batch-8 outputs are the first capture's, bitwise. The
    bytes this frees at the headline's width are chip_smoke.py's (phase
    compile_services (c)): at this size the allocator's 2 MB segments
    hide them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    main, startup, _ = _momentum_net()
    test_prog = main.clone(for_test=True)
    fetch = next(op.output("Out")[0] for op in test_prog.global_block().ops
                 if op.type == "softmax")
    rs = np.random.RandomState(0)
    feeds = {b: rs.rand(b, 3, 8, 8).astype(np.float32)
             for b in (8, 16, 32)}
    fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    graphs = []

    def run(exe, b):
        out = [exe.run(test_prog, feed={"img": feeds[b]},
                       fetch_list=[fetch])[0] for _ in range(3)][-1]
        step = next(s for s in exe.captured_steps(test_prog)
                    if s.feeds["img"].shape[0] == b)
        graphs.append((weakref.ref(step), weakref.ref(step.graph)))
        return out

    with flags.flag_guard(compile_cache_cap=2):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        first = run(exe, 8)
        run(exe, 16)
        run(exe, 32)
        again = run(exe, 8)
        info = exe.compile_cache_info()
    gc.collect()
    assert info["evictions"] == 2
    assert len(exe.captured_steps(test_prog)) == 2
    alive = [step() is not None or graph() is not None
             for step, graph in graphs]
    assert alive == [False, False, True, True]
    np.testing.assert_array_equal(again, first)


@pytest.mark.cuda
def test_verify_failure_raises_before_any_launch_on_the_card(monkeypatch):
    """On the card too a broken program is refused at its prepare: no op
    of it runs, eagerly or in a capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.core import executor_core

    main, _, loss = _mlp()
    fetches = [loss.name]
    broken = main.clone()
    ops = broken.global_block().ops
    del ops[next(i for i, op in enumerate(ops) if op.type == "mul")]
    broken._mutation += 1
    launched = []
    monkeypatch.setattr(executor_core, "run_ops",
                        lambda *a, **k: launched.append(a))
    with flags.flag_guard(verify="full"):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with pytest.raises(ProgramVerificationError) as ei:
            exe.run(broken, feed={"x": np.ones((4, 8), np.float32),
                                  "y": np.ones((4, 1), np.float32)},
                    fetch_list=fetches)
    assert "PTA001" in ei.value.report.codes()
    assert launched == [] and exe.captured_steps(broken) == []


@pytest.mark.cuda
def test_go_and_select_carry_cuda_tensors_as_on_the_host():
    """The same program on the card and on the host: equal values — the
    receiver's stream waits for the goroutine's event before it reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            outs = _go_select_program(4)
        got[str(place)] = fluid.Executor(place).run(main, fetch_list=outs)
    card, host = got.values()
    for c, h in zip(card, host):
        np.testing.assert_array_equal(c, h)


@pytest.mark.cuda
def test_goroutine_work_does_not_break_a_capture():
    """Captures run under capture_error_mode="thread_local"
    (executor_core.CapturedStep): a goroutine that launches work on its
    own stream while the executor captures another program leaves the
    capture intact, and the captured step's replays equal its eager
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stop = threading.Event()
    a = torch.rand(512, 512, device="cuda")

    def spin():
        with torch.cuda.stream(torch.cuda.Stream()):
            while not stop.is_set():
                (a @ a).sum()

    t = threading.Thread(target=spin, daemon=True)
    t.start()
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[64], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, size=32))
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        feed = {"x": np.ones((8, 64), np.float32)}
        outs = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                for _ in range(3)]
    finally:
        stop.set()
        t.join()
    assert exe.step_mode(main) == "graph"
    assert len(exe.captured_steps(main)) == 1
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])
