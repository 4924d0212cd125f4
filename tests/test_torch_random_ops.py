"""Random numbers in the port: dropout in training, the program's random
stream (executor_core.RandomStream), and random ops inside the captured
step.

The port draws from one torch.Generator per (Executor, program), seeded
once from program.random_seed; the JAX package draws from
fold_in(PRNGKey(seed), step). The two packages' numbers differ, so these
tests hold the port to itself: Out == X * Mask bitwise, the keep fraction
of a large draw, reproducibility from the seed, fresh masks at every step,
a grad that reads the forward's mask, and the graph path equal to the
interpreter bitwise with dropout on. On the CPU the executor's graph path
runs with the recording stand-in of tests/test_torch_step.py; the tests
marked `cuda` run the real CUDA graph and skip without a card.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk

from test_torch_step import cuda_device, deterministic_cudnn  # noqa: F401
from test_torch_step import recorded_graphs  # noqa: F401

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    fk.reset_launch_counts()
    yield
    tamp.disable()


def _dropout(x, p, seed=0, rng=None):
    ctx = tcore.OpContext(tfluid.CPUPlace(), rng)
    outs = treg.run_kernel(treg.lookup("dropout"), ctx, {"X": [x]},
                           {"dropout_prob": p, "seed": seed})
    return outs["Out"][0], outs["Mask"][0]


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_keeps_one_minus_p_and_out_is_x_times_mask(p, dtype):
    """n = 1e5: the keep fraction's standard deviation is at most
    sqrt(0.25 / 1e5) = 1.6e-3, so 1 - p within 5e-3 is three of them."""
    x = torch.from_numpy(np.random.RandomState(0).randn(100, 1000)
                         .astype(np.float32)).to(dtype)
    out, mask = _dropout(x, p)
    assert mask.dtype == out.dtype == dtype
    assert set(torch.unique(mask).tolist()) == {0.0, 1.0}
    assert torch.equal(out, x * mask)
    assert abs(mask.float().mean().item() - (1 - p)) < 5e-3


def test_the_stream_draws_a_new_mask_every_call_and_a_seed_fixes_one():
    x = torch.ones(64, 64)
    rng = tcore.RandomStream("cpu", 5)
    a, b = (_dropout(x, 0.5, rng=rng)[1] for _ in range(2))
    assert not torch.equal(a, b)
    replay = tcore.RandomStream("cpu", 5)
    assert torch.equal(_dropout(x, 0.5, rng=replay)[1], a)
    # a non-zero seed attr: the same mask at every call, on any stream
    s1, s2 = (_dropout(x, 0.5, seed=7, rng=rng)[1] for _ in range(2))
    s3 = _dropout(x, 0.5, seed=7, rng=tcore.RandomStream("cpu", 9))[1]
    assert torch.equal(s1, s2) and torch.equal(s1, s3)
    assert not torch.equal(s1, _dropout(x, 0.5, seed=8, rng=rng)[1])
    assert s1 is not s2  # held once, handed out as copies


def test_seeded_uniform_random_is_fixed_and_its_cache_is_not_shared():
    rng = tcore.RandomStream("cpu", 0)
    ctx = tcore.OpContext(tfluid.CPUPlace(), rng)
    attrs = {"shape": [3, 4], "min": -1.0, "max": 1.0, "seed": 3}
    run = treg.lookup("uniform_random")
    a = run.fn(ctx, {}, attrs)["Out"][0]
    a.zero_()  # a caller that writes its output in place
    b = run.fn(ctx, {}, attrs)["Out"][0]
    assert b.abs().sum() > 0
    assert torch.equal(b, run.fn(ctx, {}, attrs)["Out"][0])
    other = run.fn(ctx, {}, dict(attrs, max=2.0))["Out"][0]
    assert not torch.equal(b, other)


def test_dropout_grad_is_registered_and_never_derived(monkeypatch):
    """The grad reads the forward's Mask; a grad derived from the forward
    (make_vjp_kernel) would run it again and draw a new mask."""
    assert treg.get_op_def("dropout_grad").fn.__name__ == "dropout_grad_op"
    assert treg.get_op_def("dropout").stop_gradient_outputs == ("Mask",)

    derive = treg.make_vjp_kernel

    def refuse_dropout(fwd_def):
        if fwd_def.type == "dropout":
            raise AssertionError("dropout_grad derived from the forward")
        return derive(fwd_def)

    monkeypatch.setattr(treg, "make_vjp_kernel", refuse_dropout)
    assert treg.lookup("dropout_grad").fn.__name__ == "dropout_grad_op"
    main, startup, loss, names = _mlp_with_dropout(train=True)
    grad_op = next(op for op in main.global_block().ops
                   if op.type == "dropout_grad")
    assert grad_op.input("Mask") == [names["mask"]]
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        mask, g_out, g_in = exe.run(
            main, feed=_feed(0),
            fetch_list=[names["mask"], names["out"] + "@GRAD",
                        names["x"] + "@GRAD"])
    assert 0 < mask.mean() < 1
    np.testing.assert_array_equal(g_in, g_out * mask)


def test_clone_for_test_scales_and_keeps_everything():
    main, startup, loss, names = _mlp_with_dropout(train=False)
    test = main.clone(for_test=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        x, out, mask = exe.run(test, feed=_feed(0), fetch_list=[
            names["x"], names["out"], names["mask"]])
    np.testing.assert_array_equal(mask, np.ones_like(x))
    np.testing.assert_array_equal(out, x * np.float32(1 - 0.3))


# ---------------------------------------------------------------------------
# the executor's stream
# ---------------------------------------------------------------------------
def _mlp_with_dropout(train=True, seed=11):
    """x [16] -> fc 32 relu -> dropout 0.3 -> fc 10 softmax -> mean cross
    entropy, Momentum; with the names of the dropout's input, output and
    mask."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[16], dtype="float32")
        label = tfluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = tfluid.layers.fc(input=img, size=32, act="relu")
        drop = tfluid.layers.dropout(hidden, dropout_prob=0.3)
        probs = tfluid.layers.fc(input=drop, size=10, act="softmax")
        loss = tfluid.layers.mean(
            tfluid.layers.cross_entropy(input=probs, label=label))
        if train:
            tfluid.optimizer.Momentum(learning_rate=0.1,
                                      momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = seed
    op = next(o for o in main.global_block().ops if o.type == "dropout")
    names = {"x": op.input("X")[0], "out": op.output("Out")[0],
             "mask": op.output("Mask")[0]}
    return main, startup, loss, names


def _feed(i, batch=8):
    rs = np.random.RandomState(100 + i)
    return {"img": rs.randn(batch, 16).astype(np.float32),
            "label": rs.randint(0, 10, (batch, 1)).astype(np.int64)}


def _train(place, seed=11, init=None, iters=False, steps=STEPS):
    """`steps` Momentum steps of the dropout MLP from `init` (or its own
    startup): (losses, masks, state, step mode)."""
    main, startup, loss, names = _mlp_with_dropout(seed=seed)
    scope = tfluid.Scope()
    if init is None:
        with tfluid.scope_guard(scope):
            tfluid.Executor(tfluid.CPUPlace()).run(startup)
        init = convert.numpy_state(scope, main)
    convert.load_numpy_state(scope, main, init, place)
    exe = tfluid.Executor(place)
    fetch = [loss, names["mask"]]
    with tfluid.scope_guard(scope), tflags.flag_guard(fuse=True):
        if iters:
            stacked = {n: np.stack([_feed(i)[n] for i in range(steps)])
                       for n in ("img", "label")}
            losses, masks = exe.run(main, feed=stacked, fetch_list=fetch,
                                    iters=steps)
        else:
            outs = [exe.run(main, feed=_feed(i), fetch_list=fetch)
                    for i in range(steps)]
            losses = np.stack([o[0] for o in outs])
            masks = np.stack([o[1] for o in outs])
    return (losses.reshape(-1), masks, convert.numpy_state(scope, main),
            exe.step_mode(main))


def test_the_executor_stream_is_reproducible_from_the_program_seed():
    losses, masks, _, mode = _train(tfluid.CPUPlace())
    assert mode == "interpreter"
    again = _train(tfluid.CPUPlace())
    np.testing.assert_array_equal(again[0], losses)
    np.testing.assert_array_equal(again[1], masks)
    assert not np.array_equal(masks[0], masks[1])  # a new mask every step
    other = _train(tfluid.CPUPlace(), seed=12)[1]
    assert not np.array_equal(other[0], masks[0])
    # iters=K draws what K single steps draw
    k_losses, k_masks = _train(tfluid.CPUPlace(), iters=True)[:2]
    np.testing.assert_array_equal(k_losses, losses)
    np.testing.assert_array_equal(k_masks, masks)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("iters", [False, True], ids=["steps", "iters"])
def test_recorded_graph_with_dropout_equals_the_interpreter(recorded_graphs,
                                                            iters, amp):
    """The graph path (eager first step, capture, replays that draw from
    the registered generator) gives the interpreter's losses, masks and
    state bitwise, and a new mask at every replay. Under amp the mask is
    bf16 and comes back widened to float32 (numpy has no bfloat16)."""
    init = _train(tfluid.CPUPlace())[2]
    with tamp.auto_cast(enabled=amp):
        with tflags.flag_guard(cuda_graph=False):
            want = _train(tfluid.CPUPlace(), init=init)
        got = _train(tfluid.CPUPlace(), init=init, iters=iters)
    assert got[1].dtype == np.float32
    assert (want[3], got[3]) == ("interpreter", "graph")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert set(got[2]) == set(want[2])
    for n in want[2]:
        np.testing.assert_array_equal(got[2][n], want[2][n], err_msg=n)
    assert not np.array_equal(got[1][1], got[1][2])  # two replays


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("iters", [False, True], ids=["steps", "iters"])
def test_graph_with_dropout_equals_interpreter_on_the_card(
        cuda_device, deterministic_cudnn, iters, amp):
    init = _train(tfluid.CPUPlace())[2]
    place = tfluid.CUDAPlace(0)
    with tamp.auto_cast(enabled=amp):
        with tflags.flag_guard(cuda_graph=False):
            want = _train(place, init=init)
        got = _train(place, init=init, iters=iters)
    assert (want[3], got[3]) == ("interpreter", "graph")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    for n in want[2]:
        np.testing.assert_array_equal(got[2][n], want[2][n], err_msg=n)


@pytest.mark.cuda
def test_replays_draw_new_masks_on_the_card(cuda_device):
    _, masks, _, mode = _train(tfluid.CUDAPlace(0), steps=5)
    assert mode == "graph"
    # step 0 is the eager warm-up, steps 1-4 are replays
    for a in range(5):
        for b in range(a + 1, 5):
            assert not np.array_equal(masks[a], masks[b]), (a, b)
    assert abs(masks.mean() - 0.7) < 0.05
