"""The eight update rules the port gained beside sgd, momentum and adam —
adamax, adagrad, decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd,
proximal_adagrad — against the JAX package's ops, and their optimizer
classes through the Executor.

Op level: the same seeded parameter, accumulators and five gradients go
through five steps of the JAX op and of the port's op (each step's
outputs are the next step's inputs on each side). Every element of the
parameter and of each accumulator stays within ULPS units in the last
place at the array's scale: np.spacing of the largest magnitude in the
JAX package's array. The scale is the array's, not the element's, since
an element can be the difference of two terms of that size (ftrl's
linear accumulator; a parameter that crosses zero); measured: at most
0.4 of such a unit. The two are not bitwise equal: XLA on the CPU fuses the elementwise expression and
rewrites x / sqrt(y) as x * rsqrt(y) with an rsqrt that is not
correctly rounded, and computes pow its own way (ftrl); torch rounds
each operation.

Program level: each optimizer's minimize on the same MLP from the JAX
package's initial state, 5 Executor steps: losses within rtol 1e-4 of the
JAX package's, and the captured step on a card bitwise equal to the
interpreter (the test marked `cuda`, which skips without one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.optimizer import ZERO1_SHARDABLE_SLOTS

STEPS = 5
ULPS = 4
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


# rule: (accumulator (in, out) slots with their initial values, attrs)
RULES = {
    "adamax": ([("Moment", "MomentOut", 0.0), ("InfNorm", "InfNormOut", 0.0)],
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ([("Moment", "MomentOut", 0.0)], {"epsilon": 1e-6}),
    "decayed_adagrad": ([("Moment", "MomentOut", 0.0)],
                        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ([("AvgSquaredGrad", "AvgSquaredGradOut", 0.0),
                  ("AvgSquaredUpdate", "AvgSquaredUpdateOut", 0.0)],
                 {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": ([("MeanSquare", "MeanSquareOut", 0.0),
                 ("Moment", "MomentOut", 0.0)],
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "ftrl": ([("SquaredAccumulator", "SquaredAccumOut", 0.1),
              ("LinearAccumulator", "LinearAccumOut", 0.0)],
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "proximal_gd": ([], {"l1": 0.01, "l2": 0.02}),
    "proximal_adagrad": ([("Moment", "MomentOut", 0.1)],
                         {"l1": 0.01, "l2": 0.02}),
}


def _inputs(rule, n=257):
    rs = np.random.RandomState(len(rule))
    ins = {"Param": [rs.randn(n).astype(np.float32)],
           "LearningRate": [np.array([0.05], np.float32)]}
    if rule == "adamax":
        ins["Beta1Pow"] = [np.array([0.9], np.float32)]
    for slot, _, init in RULES[rule][0]:
        ins[slot] = [np.full(n, init, np.float32)]
    grads = [rs.randn(n).astype(np.float32) for _ in range(STEPS)]
    return ins, grads


def _jax_step(rule, ins, attrs):
    outs = jreg.run_kernel(jreg.lookup(rule), jcore.OpContext(),
                           {s: [jnp.asarray(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: np.asarray(v[0]) for s, v in outs.items()}


def _port_step(rule, ins, attrs, device="cpu"):
    place = tfluid.CPUPlace() if device == "cpu" else tfluid.CUDAPlace(0)
    outs = treg.run_kernel(treg.lookup(rule), tcore.OpContext(place),
                           {s: [torch.from_numpy(np.array(v)).to(device)
                                for v in vs] for s, vs in ins.items()},
                           dict(attrs))
    return {s: v[0].cpu().numpy() for s, v in outs.items()}


def _run(rule, step, **kw):
    """Five steps of `rule` through `step`: {output slot: final value}."""
    ins, grads = _inputs(rule)
    slots, attrs = RULES[rule]
    for g in grads:
        outs = step(rule, dict(ins, Grad=[g]), attrs, **kw)
        ins["Param"] = [outs["ParamOut"]]
        for slot, out_slot, _ in slots:
            ins[slot] = [outs[out_slot]]
    return outs


def _assert_within_ulps(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert np.isfinite(want).all(), name
    bound = ULPS * np.spacing(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= bound, (name, float(err.max()), float(bound))


@pytest.mark.parametrize("rule", sorted(RULES))
def test_five_steps_match_the_jax_op_within_ulps(rule):
    want = _run(rule, _jax_step)
    got = _run(rule, _port_step)
    assert set(got) == set(want)
    for slot in want:
        _assert_within_ulps(got[slot], want[slot], slot)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_is_zero1_shardable_as_in_the_jax_package(rule):
    """Each rule's accumulators are the zero1 slots of the JAX package's
    table (ftrl and proximal_adagrad, which divide by an accumulator
    that is zero on padded lanes, stay replicated there too)."""
    from paddle_tpu.optimizer import ZERO1_SHARDABLE_SLOTS as JSLOTS

    assert ZERO1_SHARDABLE_SLOTS.get(rule) == JSLOTS.get(rule)
    accums = {(s, o) for s, o, _ in RULES[rule][0]}
    assert set(ZERO1_SHARDABLE_SLOTS.get(rule, ())) <= accums


# ---------------------------------------------------------------------------
# the optimizer classes through the Executor
# ---------------------------------------------------------------------------
OPTIMIZERS = {
    "adamax": lambda f: f.optimizer.Adamax(learning_rate=0.01),
    "adagrad": lambda f: f.optimizer.Adagrad(learning_rate=0.05),
    "decayed_adagrad": lambda f: f.optimizer.DecayedAdagrad(
        learning_rate=0.05),
    "adadelta": lambda f: f.optimizer.Adadelta(learning_rate=1.0),
    "rmsprop": lambda f: f.optimizer.RMSProp(learning_rate=0.01,
                                             momentum=0.5),
    "ftrl": lambda f: f.optimizer.Ftrl(learning_rate=0.05, l1=0.001,
                                       l2=0.001),
    "proximal_gd": lambda f: f.optimizer.ProximalGD(learning_rate=0.05,
                                                    l1=0.001),
    "proximal_adagrad": lambda f: f.optimizer.ProximalAdagrad(
        learning_rate=0.05, l2=0.001),
}


def build_mlp(fluid, rule):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        probs = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=probs,
                                                            label=y))
        OPTIMIZERS[rule](fluid).minimize(loss)
    main.random_seed = startup.random_seed = 3
    return main, startup, loss


def _batches(steps=STEPS):
    rs = np.random.RandomState(2)
    return [(rs.randn(16, 8).astype(np.float32),
             rs.randint(0, 4, (16, 1)).astype(np.int64))
            for _ in range(steps)]


def _jax_losses(rule):
    main, startup, loss = build_mlp(jfluid, rule)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        losses = [float(np.asarray(exe.run(main, feed={"x": x, "y": y},
                                           fetch_list=[loss])[0])[0])
                  for x, y in _batches()]
    return init, np.asarray(losses)


def _port_run(rule, init, place, steps=STEPS):
    main, _, loss = build_mlp(tfluid, rule)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, main, init, place)
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(place)
        losses = [float(exe.run(main, feed={"x": x, "y": y},
                                fetch_list=[loss])[0][0])
                  for x, y in _batches(steps)]
        mode = exe.step_mode(main)
    return np.asarray(losses), convert.numpy_state(scope, main), mode


@pytest.mark.parametrize("rule", sorted(OPTIMIZERS))
def test_optimizer_trains_as_in_the_jax_package(rule):
    init, want = _jax_losses(rule)
    got, _, _ = _port_run(rule, init, tfluid.CPUPlace())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_on_the_card_matches_the_cpu(rule):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = _run(rule, _port_step)
    got = _run(rule, _port_step, device="cuda")
    for slot in want:
        _assert_within_ulps(got[slot], want[slot], slot)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(OPTIMIZERS))
def test_captured_step_equals_the_interpreter_bitwise(rule):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    init, _ = _jax_losses(rule)
    place = tfluid.CUDAPlace(0)
    graph = _port_run(rule, init, place)
    with tfluid.flags.flag_guard(cuda_graph=False):
        interp = _port_run(rule, init, place)
    assert graph[2] == "graph" and interp[2] == "interpreter"
    np.testing.assert_array_equal(graph[0], interp[0])
    for n, v in interp[1].items():
        np.testing.assert_array_equal(graph[1][n], v, err_msg=n)
