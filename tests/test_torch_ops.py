"""Op-level parity: each kernel of the port's training slice against the
JAX package's kernel, forward and gradient.

The same numpy inputs (np.random.RandomState) go through the JAX kernel
and the port's kernel on the CPU; gradients come from each side's derived
`<op>_grad` kernel (jax.vjp there, torch.autograd here) with the same
random cotangents. Tolerances (fp32, different summation orders):
forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import executor_core as jcore
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor_core as tcore
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.registry import SeqTensor

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool from oversubscribing the cores the other workers use
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _run_jax(op_type, ins, attrs):
    outs = jreg.run_kernel(jreg.lookup(op_type), jcore.OpContext(),
                           {s: [jnp.asarray(v) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else np.asarray(v) for v in vs]
            for s, vs in outs.items()}


def _run_port(op_type, ins, attrs):
    outs = treg.run_kernel(treg.lookup(op_type),
                           tcore.OpContext(tfluid.CPUPlace()),
                           {s: [torch.from_numpy(np.array(v)) for v in vs]
                            for s, vs in ins.items()}, dict(attrs))
    return {s: [None if v is None else v.numpy() for v in vs]
            for s, vs in outs.items()}


def _compare(op_type, ins, attrs, grad_slots=(), seed=0):
    """Forward outputs, then (for each output slot in grad_slots) the
    derived grad op's input gradients."""
    jo, to = _run_jax(op_type, ins, attrs), _run_port(op_type, ins, attrs)
    for slot, vals in jo.items():
        for j, t in zip(vals, to.get(slot, [])):
            if j is None or t is None:
                continue
            np.testing.assert_allclose(t, j.astype(t.dtype), err_msg=slot,
                                       **FWD)
    if not grad_slots:
        return
    rs = np.random.RandomState(seed + 1)
    gins = dict(ins)
    for slot in grad_slots:
        gins[f"{slot}@GRAD"] = [rs.randn(*np.shape(v)).astype(np.float32)
                                for v in jo[slot]]
    jg = _run_jax(op_type + "_grad", gins, attrs)
    tg = _run_port(op_type + "_grad", gins, attrs)

    def filled(outs):  # int inputs get no gradient on either side
        return {s for s, vs in outs.items() if any(v is not None for v in vs)}

    assert filled(tg) == filled(jg)
    for slot in filled(jg):
        for j, t in zip(jg[slot], tg[slot]):
            np.testing.assert_allclose(t, j, err_msg=slot, **GRAD)


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad", [0, 1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_conv2d(layout, stride, pad):
    rs = np.random.RandomState(10 * stride + pad)
    k = 7 if pad == 3 else 3
    x = _rand(rs, 2, 9, 9, 3) if layout == "NHWC" else _rand(rs, 2, 3, 9, 9)
    w = _rand(rs, 4, 3, k, k, scale=0.2)
    attrs = {"strides": [stride, stride], "paddings": [pad, pad],
             "dilations": [1, 1], "groups": 1, "data_format": layout}
    _compare("conv2d", {"Input": [x], "Filter": [w]}, attrs,
             grad_slots=("Output",))


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------
POOL_CASES = {
    "plain": {"ksize": [3, 3], "strides": [2, 2], "paddings": [0, 0]},
    "padded": {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
    "global": {"ksize": [2, 2], "strides": [1, 1], "paddings": [0, 0],
               "global_pooling": True},
    "ceil": {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
             "ceil_mode": True},
    "padded_inclusive": {"ksize": [3, 3], "strides": [2, 2],
                         "paddings": [1, 1], "exclusive": False},
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
@pytest.mark.parametrize("ptype", ["avg", "max"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_pool2d(layout, ptype, case):
    rs = np.random.RandomState(len(case))
    x = _rand(rs, 2, 8, 8, 3) if layout == "NHWC" else _rand(rs, 2, 3, 8, 8)
    attrs = dict(POOL_CASES[case], pooling_type=ptype, data_format=layout)
    _compare("pool2d", {"X": [x]}, attrs, grad_slots=("Out",))


# ---------------------------------------------------------------------------
# batch_norm (train + test, running stats included)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm(layout, is_test):
    rs = np.random.RandomState(7)
    c = 5
    x = _rand(rs, 3, 4, 4, c, scale=2.0) + 0.5 if layout == "NHWC" \
        else _rand(rs, 3, c, 4, 4, scale=2.0) + 0.5
    ins = {"X": [x], "Scale": [rs.rand(c).astype(np.float32) + 0.5],
           "Bias": [_rand(rs, c)], "Mean": [_rand(rs, c, scale=0.1)],
           "Variance": [rs.rand(c).astype(np.float32) + 0.5]}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": layout,
             "is_test": is_test}
    _compare("batch_norm", ins, attrs, grad_slots=("Y",))


def test_batch_norm_grad_op_skips_running_stats_in_training():
    """The port's batch_norm grad maker drops Mean/Variance from the
    training-mode grad op; the derived kernel still gives the JAX grads."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data(name="x", shape=[3, 4, 4], dtype="float32")
        y = tfluid.layers.batch_norm(input=x)
        tfluid.append_backward(tfluid.layers.mean(y))
    grad = [op for op in main.global_block().ops
            if op.type == "batch_norm_grad"]
    assert len(grad) == 1
    assert "Mean" not in grad[0].inputs and "Variance" not in grad[0].inputs
    rs = np.random.RandomState(3)
    ins = {"X": [_rand(rs, 2, 3, 4, 4)],
           "Scale": [rs.rand(3).astype(np.float32)], "Bias": [_rand(rs, 3)]}
    gy = _rand(rs, 2, 3, 4, 4)
    tg = _run_port("batch_norm_grad", dict(ins, **{"Y@GRAD": [gy]}),
                   {"epsilon": 1e-5})
    jins = dict(ins, Mean=[np.zeros(3, np.float32)],
                Variance=[np.ones(3, np.float32)], **{"Y@GRAD": [gy]})
    jg = _run_jax("batch_norm_grad", jins, {"epsilon": 1e-5})
    for slot in ("X@GRAD", "Scale@GRAD", "Bias@GRAD"):
        np.testing.assert_allclose(tg[slot][0], jg[slot][0], **GRAD)


# ---------------------------------------------------------------------------
# math / activation / loss
# ---------------------------------------------------------------------------
def test_mul():
    rs = np.random.RandomState(1)
    _compare("mul", {"X": [_rand(rs, 4, 2, 3)], "Y": [_rand(rs, 6, 5)]},
             {"x_num_col_dims": 1, "y_num_col_dims": 1}, grad_slots=("Out",))


@pytest.mark.parametrize("yshape,axis", [((2, 3, 4, 5), -1), ((3,), 1),
                                         ((4, 5), -1), ((3, 4), 1)],
                         ids=["same", "axis1", "trailing", "mid"])
def test_elementwise_add(yshape, axis):
    rs = np.random.RandomState(2)
    _compare("elementwise_add", {"X": [_rand(rs, 2, 3, 4, 5)],
                                 "Y": [_rand(rs, *yshape)]},
             {"axis": axis}, grad_slots=("Out",))


def test_relu():
    rs = np.random.RandomState(3)
    _compare("relu", {"X": [_rand(rs, 4, 7)]}, {}, grad_slots=("Out",))


def test_softmax():
    rs = np.random.RandomState(4)
    _compare("softmax", {"X": [_rand(rs, 4, 10, scale=3.0)]}, {},
             grad_slots=("Out",))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cross_entropy(soft):
    rs = np.random.RandomState(5)
    p = rs.rand(6, 10).astype(np.float32) + 0.05
    p /= p.sum(axis=1, keepdims=True)
    if soft:
        label = rs.rand(6, 10).astype(np.float32)
        label /= label.sum(axis=1, keepdims=True)
    else:
        label = rs.randint(0, 10, size=(6, 1)).astype(np.int32)
    _compare("cross_entropy", {"X": [p], "Label": [label]},
             {"soft_label": soft}, grad_slots=("Y",))


def test_mean():
    rs = np.random.RandomState(6)
    _compare("mean", {"X": [_rand(rs, 5, 7)]}, {}, grad_slots=("Out",))


def test_mean_grad_takes_scalar_cotangent_for_its_one_element_output():
    rs = np.random.RandomState(6)
    x = _rand(rs, 5, 7)
    g = _run_port("mean_grad", {"X": [x], "Out@GRAD": [np.float32(2.0)]},
                  {})["X@GRAD"][0]
    np.testing.assert_allclose(g, np.full_like(x, 2.0 / x.size), **FWD)


def test_sum():
    rs = np.random.RandomState(7)
    _compare("sum", {"X": [_rand(rs, 3, 4) for _ in range(3)]}, {},
             grad_slots=("Out",))


def test_scale():
    rs = np.random.RandomState(8)
    _compare("scale", {"X": [_rand(rs, 3, 4)]},
             {"scale": 0.5, "bias": 1.25, "bias_after_scale": False},
             grad_slots=("Out",))


def test_relu_on_a_seq_tensor_keeps_its_lengths():
    x = torch.tensor([[-1.0], [2.0], [-3.0]])
    lengths = torch.tensor([2, 1])
    outs = treg.run_kernel(treg.lookup("relu"),
                           tcore.OpContext(tfluid.CPUPlace()),
                           {"X": [SeqTensor(x, lengths)]}, {})
    y = outs["Out"][0]
    assert isinstance(y, SeqTensor) and y.lengths is lengths
    assert y.data.tolist() == [[0.0], [2.0], [0.0]]


# ---------------------------------------------------------------------------
# tensor ops
# ---------------------------------------------------------------------------
def test_fill_constant_cast_assign():
    _compare("fill_constant", {}, {"shape": [2, 3], "value": 1.5,
                                   "dtype": "float32"})
    rs = np.random.RandomState(9)
    x = _rand(rs, 3, 4, scale=10.0)
    _compare("cast", {"X": [x]}, {"out_dtype": "int32"})
    _compare("assign", {"X": [x]}, {})


@pytest.mark.parametrize("op", ["uniform_random", "gaussian_random"])
def test_random_ops_follow_their_distribution_and_seed(op):
    """The backends draw different numbers from one seed; the port's draw
    matches the distribution and is reproducible from the op's seed."""
    attrs = {"shape": [200, 100], "dtype": "float32", "seed": 11,
             "min": -2.0, "max": 2.0, "mean": 1.0, "std": 0.5}
    a = _run_port(op, {}, attrs)["Out"][0]
    b = _run_port(op, {}, attrs)["Out"][0]
    np.testing.assert_array_equal(a, b)
    if op == "uniform_random":
        assert a.min() >= -2.0 and a.max() < 2.0
        assert abs(a.mean()) < 0.05 and abs(a.std() - 4 / np.sqrt(12)) < 0.05
    else:
        assert abs(a.mean() - 1.0) < 0.02 and abs(a.std() - 0.5) < 0.02


# ---------------------------------------------------------------------------
# optimizer ops
# ---------------------------------------------------------------------------
def _opt_inputs(rs, n=37):
    return {"Param": [_rand(rs, n)], "Grad": [_rand(rs, n)],
            "LearningRate": [np.asarray([0.1], np.float32)]}


def test_sgd():
    _compare("sgd", _opt_inputs(np.random.RandomState(12)), {})


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum(nesterov):
    rs = np.random.RandomState(13)
    ins = dict(_opt_inputs(rs), Velocity=[_rand(rs, 37)])
    _compare("momentum", ins, {"mu": 0.9, "use_nesterov": nesterov})


def test_adam():
    rs = np.random.RandomState(14)
    ins = dict(_opt_inputs(rs), Moment1=[_rand(rs, 37)],
               Moment2=[np.abs(_rand(rs, 37))],
               Beta1Pow=[np.asarray([0.9 ** 3], np.float32)],
               Beta2Pow=[np.asarray([0.999 ** 3], np.float32)])
    _compare("adam", ins, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
