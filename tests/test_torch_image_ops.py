"""Op-level parity of the image-classification slice: the activation
family, the elementwise family with axis broadcast, top_k, accuracy, and
dropout in test mode and its grad given a mask, each against the JAX
package's kernel on the same numpy inputs.

Gradients come from each side's `<op>_grad` kernel: derived from the
forward (jax.vjp there, torch.autograd here) for every op but
dropout_grad, which both packages register by hand. Tolerances (fp32 on
the CPU, different summation and transcendental implementations):
outputs and gradients rtol 1e-4, with atol 1e-6 (outputs) and 1e-5
(gradients) for values near 0.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import scope as tscope

from test_torch_ops import _run_jax, _run_port

FWD = dict(rtol=1e-4, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    torch.set_num_threads(2)
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    yield


def _same(t, j, what, tol):
    """The port's value against the JAX package's: fluid's [1] against a
    0-d value is the same number; int64 indices against the JAX package's
    int32 (x64 off there) compare as values."""
    j = np.asarray(j)
    if t.shape == (1,) and j.shape == ():
        j = j.reshape(1)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    if t.dtype.kind in "iu":
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=what)
    else:
        np.testing.assert_allclose(t, j.astype(t.dtype), err_msg=what, **tol)


def _compare(op_type, ins, attrs, grad_slots=(), seed=0):
    """Forward outputs, then (for each output slot in grad_slots) the grad
    op's input gradients, with the same random cotangents."""
    jo, to = _run_jax(op_type, ins, attrs), _run_port(op_type, ins, attrs)
    assert set(to) >= set(jo)
    for slot, vals in jo.items():
        for j, t in zip(vals, to[slot]):
            _same(t, j, slot, FWD)
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

    assert filled(tg) == filled(jg) != set()
    for slot in filled(jg):
        for j, t in zip(jg[slot], tg[slot]):
            _same(t, j, slot, GRAD)


# ---------------------------------------------------------------------------
# activations: the JAX package's whole family, default attrs and, where an
# op takes attrs, one non-default set
# ---------------------------------------------------------------------------
POSITIVE = {"sqrt", "log", "reciprocal", "pow"}
ACTIVATIONS = {
    "sigmoid": {}, "logsigmoid": {}, "exp": {}, "relu": {}, "tanh": {},
    "tanh_shrink": {}, "softshrink": {"lambda": 0.3}, "hard_shrink":
    {"threshold": 0.7}, "sqrt": {}, "abs": {}, "ceil": {}, "floor": {},
    "round": {}, "cos": {}, "sin": {}, "reciprocal": {}, "log": {},
    "square": {}, "softplus": {}, "softsign": {}, "brelu":
    {"t_min": -1.0, "t_max": 1.5}, "leaky_relu": {"alpha": 0.1},
    "soft_relu": {"threshold": 2.0}, "elu": {"alpha": 0.7}, "relu6":
    {"threshold": 3.0}, "pow": {"factor": 2.5}, "stanh":
    {"scale_a": 0.5, "scale_b": 1.2}, "hard_sigmoid":
    {"slope": 0.3, "offset": 0.4}, "thresholded_relu": {"threshold": 0.4},
    "swish": {"beta": 1.5}, "gelu": {},
}
ACT_CASES = [(op, {}) for op in sorted(ACTIVATIONS)] + [
    (op, a) for op, a in sorted(ACTIVATIONS.items()) if a]


def test_the_family_is_the_jax_packages():
    import paddle_tpu.ops.activation_ops  # noqa: F401  registers them

    jax_family = {t for t, d in jreg._registry.items()
                  if d.fn is not None
                  and d.fn.__module__ == "paddle_tpu.ops.activation_ops"}
    assert jax_family == set(ACTIVATIONS)
    for op in ACTIVATIONS:
        assert treg.get_op_def(op) is not None, op
        assert treg.get_op_def(op + "_grad") is None, op  # derived


@pytest.mark.parametrize("op,attrs", ACT_CASES,
                         ids=[f"{op}-{'attrs' if a else 'default'}"
                              for op, a in ACT_CASES])
def test_activation(op, attrs):
    rs = np.random.RandomState(sorted(ACTIVATIONS).index(op))
    if op in POSITIVE:
        x = rs.uniform(0.2, 2.0, (3, 4, 5)).astype(np.float32)
    else:
        x = (rs.randn(3, 4, 5) * 2).astype(np.float32)
    _compare(op, {"X": [x]}, attrs, grad_slots=("Out",))


# ---------------------------------------------------------------------------
# the elementwise family: Y aligned with X's dims at axis 0 (the SE gate,
# X [N, C, H, W] * Y [N, C]), trailing (axis -1) and in the middle
# ---------------------------------------------------------------------------
ELEMENTWISE = ["elementwise_sub", "elementwise_mul", "elementwise_div",
               "elementwise_max", "elementwise_min", "elementwise_pow"]
BROADCASTS = {"axis0": ((2, 3, 4, 5), (2, 3), 0),
              "trailing": ((2, 3, 4, 5), (4, 5), -1),
              "middle": ((2, 3, 4, 5), (3, 4), 1)}


@pytest.mark.parametrize("bcast", sorted(BROADCASTS))
@pytest.mark.parametrize("op", ELEMENTWISE)
def test_elementwise(op, bcast):
    """Outputs, and both inputs' grads: Y's sums X's grad over the dims it
    is broadcast along (for the SE gate: H and W)."""
    xshape, yshape, axis = BROADCASTS[bcast]
    rs = np.random.RandomState(ELEMENTWISE.index(op))
    x = rs.randn(*xshape).astype(np.float32)
    y = rs.randn(*yshape).astype(np.float32)
    if op == "elementwise_pow":
        x = np.abs(x) + 0.5
    if op == "elementwise_div":
        y = np.sign(y) * (np.abs(y) + 0.5)
    _compare(op, {"X": [x], "Y": [y]}, {"axis": axis}, grad_slots=("Out",))


# ---------------------------------------------------------------------------
# top_k and accuracy
# ---------------------------------------------------------------------------
def test_top_k():
    rs = np.random.RandomState(5)
    x = rs.randn(6, 12).astype(np.float32)
    _compare("top_k", {"X": [x]}, {"k": 3}, grad_slots=("Out",))
    assert _run_port("top_k", {"X": [x]}, {"k": 3})["Indices"][0].dtype \
        == np.int64


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy(k):
    rs = np.random.RandomState(6)
    x = rs.randn(8, 10).astype(np.float32)
    label = rs.randint(0, 10, (8, 1)).astype(np.int64)
    label[:3, 0] = np.argmax(x[:3], axis=1)  # some rows are hits
    top = _run_port("top_k", {"X": [x]}, {"k": k})
    ins = {"Out": top["Out"], "Indices": top["Indices"], "Label": [label]}
    _compare("accuracy", ins, {})
    got = _run_port("accuracy", ins, {})
    hits = sum(label[i, 0] in np.argsort(-x[i])[:k] for i in range(8))
    assert got["Correct"][0].tolist() == [hits]
    assert got["Total"][0].tolist() == [8]
    assert got["Accuracy"][0].dtype == np.float32
    assert got["Correct"][0].dtype == got["Total"][0].dtype == np.int32
    op = treg.get_op_def("accuracy")
    assert set(op.stop_gradient_outputs) == {"Accuracy", "Correct", "Total"}


# ---------------------------------------------------------------------------
# dropout: test mode and the grad given a mask (training draws differ
# between the packages: tests/test_torch_random_ops.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_in_test_mode(p):
    rs = np.random.RandomState(7)
    x = rs.randn(4, 7).astype(np.float32)
    _compare("dropout", {"X": [x]}, {"dropout_prob": p, "is_test": True})
    got = _run_port("dropout", {"X": [x]},
                    {"dropout_prob": p, "is_test": True})
    np.testing.assert_array_equal(got["Mask"][0], np.ones_like(x))


def test_dropout_grad_given_a_mask():
    rs = np.random.RandomState(8)
    g = rs.randn(4, 7).astype(np.float32)
    mask = (rs.rand(4, 7) < 0.7).astype(np.float32)
    ins = {"Out@GRAD": [g], "Mask": [mask]}
    attrs = {"dropout_prob": 0.3}
    want = _run_jax("dropout_grad", ins, attrs)["X@GRAD"][0]
    got = _run_port("dropout_grad", ins, attrs)["X@GRAD"][0]
    np.testing.assert_allclose(got, want, **GRAD)
    np.testing.assert_array_equal(got, g * mask)
