"""Auto-generated simple layer wrappers.

Reference parity: python/paddle/fluid/layers/ops.py +
layer_function_generator.py — one Python function per simple (X->Out) op.
"""

from ..layer_helper import LayerHelper
from ..core.framework import Variable

_unary_ops = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal", "log",
    "square", "softplus", "softsign", "brelu", "leaky_relu", "soft_relu", "elu",
    "relu6", "pow", "stanh", "hard_shrink", "hard_sigmoid", "thresholded_relu",
    "swish", "gelu",
]

_binary_ops = [
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
]

__all__ = (
    _unary_ops
    + _binary_ops
    + [
        "mean", "scale", "clip", "clip_by_norm", "sums", "logical_and",
        "logical_or", "logical_xor", "logical_not", "uniform_random",
        "gaussian_random", "cumsum", "maxout",
        "elementwise_binary_dispatch",
    ]
)


def _make_unary(op_type):
    def func(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name, **kwargs)
        out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape, lod_level=x.lod_level)
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Variable)}
        helper.append_op(op_type, {"X": [x]}, {"Out": [out]}, attrs)
        return out

    func.__name__ = op_type
    func.__doc__ = f"{op_type} activation (see ops/activation_ops.py)."
    return func


for _op in _unary_ops:
    globals()[_op] = _make_unary(_op)


def _make_binary(op_type):
    def func(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape, lod_level=x.lod_level)
        helper.append_op(op_type, {"X": [x], "Y": [y]}, {"Out": [out]}, {"axis": axis})
        return helper.append_activation(out)

    func.__name__ = op_type
    return func


for _op in _binary_ops:
    globals()[_op] = _make_binary(_op)


def elementwise_binary_dispatch(x, other, op_type):
    """Implements Variable.__add__ etc. (reference math_op_patch.py)."""
    if isinstance(other, Variable):
        return globals()[op_type](x, other)
    # scalar fast path via scale/shift
    val = float(other)
    if op_type == "elementwise_add":
        return scale(x, scale=1.0, bias=val)
    if op_type == "elementwise_sub":
        return scale(x, scale=1.0, bias=-val)
    if op_type == "elementwise_mul":
        return scale(x, scale=val)
    if op_type == "elementwise_div":
        return scale(x, scale=1.0 / val)
    raise NotImplementedError(op_type)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=())
    helper.append_op("mean", {"X": [x]}, {"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape, lod_level=x.lod_level)
    helper.append_op(
        "scale",
        {"X": [x]},
        {"Out": [out]},
        {"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op("clip", {"X": [x]}, {"Out": [out]}, {"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op("clip_by_norm", {"X": [x]}, {"Out": [out]}, {"max_norm": max_norm})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op("sum", {"X": input}, {"Out": [out]})
    return out


def _logical(op_type, x, y=None, out=None, name=None):
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_tmp_variable(dtype="bool", shape=x.shape)
    ins = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
    helper.append_op(op_type, ins, {"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out, name)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", x, None, out, name)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_tmp_variable(dtype=dtype, shape=shape, stop_gradient=True)
    helper.append_op(
        "uniform_random",
        {},
        {"Out": [out]},
        {"shape": list(shape), "dtype": dtype, "min": min, "max": max, "seed": seed},
    )
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_tmp_variable(dtype=dtype, shape=shape, stop_gradient=True)
    helper.append_op(
        "gaussian_random",
        {},
        {"Out": [out]},
        {"shape": list(shape), "dtype": dtype, "mean": mean, "std": std, "seed": seed},
    )
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op(
        "cumsum",
        {"X": [x]},
        {"Out": [out]},
        {"axis": axis, "exclusive": exclusive, "reverse": reverse},
    )
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    shape = None
    if x.shape:
        shape = (x.shape[0], x.shape[1] // groups, x.shape[2], x.shape[3])
    out = helper.create_tmp_variable(dtype=x.dtype, shape=shape)
    helper.append_op("maxout", {"X": [x]}, {"Out": [out]}, {"groups": groups})
    return out
