"""The learning-rate schedules (layers/learning_rate_scheduler.py) against
the JAX package's, and the step counter under the captured step.

Each schedule drives an SGD-trained fc from the JAX package's initial
state; the learning rate fetched at each of 5 interpreter steps matches
the JAX package's within rtol 1e-6 (exp and pow may round one ulp apart)
and the losses within rtol 1e-4. On the graph path (the recording
stand-in for a CUDA graph of tests/test_torch_step.py on the CPU, a real
graph on a card) the counter, an int64 persistable that `increment`
writes in place, advances at every replay, the decayed rate reaches the
fused momentum update at every replay, and graph and interpreter stay
bitwise equal.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fusion import kernels as fk

from test_torch_step import recorded_graphs  # noqa: F401

STEPS = 5
LR_RTOL = 1e-6
LOSS_RTOL = 1e-4
COUNTER = "@LR_DECAY_COUNTER@"


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    fk.reset_launch_counts()
    yield


# schedule: (layer name, args, kwargs, its value at counter value k)
SCHEDULES = {
    "exponential_decay": ("exponential_decay", (0.1, 2, 0.5), {},
                          lambda k: 0.1 * 0.5 ** (k / 2)),
    "exponential_decay_staircase": (
        "exponential_decay", (0.1, 2, 0.5), {"staircase": True},
        lambda k: 0.1 * 0.5 ** (k // 2)),
    "natural_exp_decay": ("natural_exp_decay", (0.1, 3, 0.5), {},
                          lambda k: 0.1 * math.exp(-0.5 * k / 3)),
    "inverse_time_decay": ("inverse_time_decay", (0.1, 2, 0.5),
                           {"staircase": True},
                           lambda k: 0.1 / (1 + 0.5 * (k // 2))),
    "polynomial_decay": ("polynomial_decay", (0.1, 3),
                         {"end_learning_rate": 0.01, "power": 2.0},
                         lambda k: 0.09 * (1 - min(k / 3, 1)) ** 2 + 0.01),
    "polynomial_decay_cycle": (
        "polynomial_decay", (0.1, 2), {"cycle": True},
        lambda k: (0.1 - 1e-4) * (1 - k / (2 * max(math.ceil(k / 2), 1)))
        + 1e-4),
    "noam_decay": ("noam_decay", (64, 3), {},
                   lambda k: 64 ** -0.5 * min((k + 1) ** -0.5,
                                              (k + 1) * 3 ** -1.5)),
}


def build(fluid, schedule, momentum=False, clip=False):
    name, args, kwargs, _ = SCHEDULES[schedule]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.fc(input=x, size=3)))
        lr = getattr(fluid.layers, name)(*args, **kwargs)
        if clip:
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(clip_norm=0.5))
        opt = (fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
               if momentum else fluid.optimizer.SGD(learning_rate=lr))
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 5
    return main, startup, loss, lr


def _feeds():
    rs = np.random.RandomState(4)
    return [{"x": rs.randn(8, 6).astype(np.float32)} for _ in range(STEPS)]


def _jax_run(schedule, **kw):
    main, startup, loss, lr = build(jfluid, schedule, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        outs = [exe.run(main, feed=f, fetch_list=[loss, lr])
                for f in _feeds()]
    return init, np.asarray([[float(np.asarray(v).reshape(-1)[0])
                              for v in o] for o in outs])


def _port_run(schedule, init, place, **kw):
    main, _, loss, lr = build(tfluid, schedule, **kw)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(place)
        outs = [exe.run(main, feed=f, fetch_list=[loss, lr])
                for f in _feeds()]
        mode = exe.step_mode(main)
        state = convert.numpy_state(scope, main)
    got = np.asarray([[float(np.asarray(v).reshape(-1)[0]) for v in o]
                      for o in outs])
    return got, state, mode


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_matches_the_jax_package(schedule):
    init, want = _jax_run(schedule)
    got, state, _ = _port_run(schedule, init, tfluid.CPUPlace())
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=LR_RTOL)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL)
    # the counter ran from its `begin` - 1 once a step, and the rate is
    # the schedule's at each step's counter value
    begin = 1 if schedule == "noam_decay" else 0
    assert state[COUNTER].dtype == np.int64
    assert int(state[COUNTER][0]) == begin + STEPS - 1
    value = SCHEDULES[schedule][3]
    np.testing.assert_allclose(got[:, 1], [value(k) for k in range(STEPS)],
                               rtol=LR_RTOL)


def test_piecewise_decay_names_the_missing_switch():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        with pytest.raises(NotImplementedError, match="Switch"):
            tfluid.layers.piecewise_decay([2, 4], [0.1, 0.01, 0.001])


def test_counter_layers_build_the_jax_packages_ops():
    """less_than, equal, increment and zeros_like (layers/control_flow.py)
    append the JAX package's ops."""
    progs = []
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, fluid.Program()):
            i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
            n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=3)
            fluid.layers.less_than(i, n)
            fluid.layers.equal(i, n)
            fluid.layers.increment(i, value=2.0)
            fluid.layers.zeros_like(n)
        progs.append(main)
    assert progs[1].desc_str() == progs[0].desc_str()


def _graph_vs_interpreter(place):
    """exponential_decay on fused Momentum with GradientClipByGlobalNorm:
    the interpreter's run and the graph path's."""
    init, want = _jax_run("exponential_decay", momentum=True, clip=True)
    runs = {}
    with tflags.flag_guard(fuse=True):
        for graph in (False, True):
            fk.reset_launch_counts()
            with tflags.flag_guard(cuda_graph=graph):
                runs[graph] = _port_run("exponential_decay", init, place,
                                        momentum=True, clip=True)
            runs[graph] += (fk.momentum_bucket.launches,)
    return want, runs


def _assert_graph_run(want, runs):
    got, state, mode, launches = runs[True]
    i_got, i_state, i_mode, _ = runs[False]
    assert (mode, i_mode) == ("graph", "interpreter")
    assert launches == STEPS  # one bucket a step, every replay
    np.testing.assert_array_equal(got, i_got)
    for n, v in i_state.items():
        np.testing.assert_array_equal(state[n], v, err_msg=n)
    # a new rate every step: the counter's, not the capture's
    value = SCHEDULES["exponential_decay"][3]
    np.testing.assert_allclose(got[:, 1], [value(k) for k in range(STEPS)],
                               rtol=LR_RTOL)
    assert int(state[COUNTER][0]) == STEPS - 1
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_decaying_rate_reaches_every_replay(recorded_graphs):  # noqa: F811
    _assert_graph_run(*_graph_vs_interpreter(tfluid.CPUPlace()))


@pytest.mark.cuda
def test_decaying_rate_reaches_every_replay_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _assert_graph_run(*_graph_vs_interpreter(tfluid.CUDAPlace(0)))
