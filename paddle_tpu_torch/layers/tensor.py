"""Tensor layers (reference python/paddle/fluid/layers/tensor.py)."""

import numpy as np

from ..layer_helper import LayerHelper
from ..core.framework import Variable
from ..core import dtypes
from ..initializer import Constant

__all__ = [
    "create_tensor", "create_parameter", "create_global_var", "cast",
    "concat", "assign", "fill_constant_batch_size_like", "fill_constant",
    "argmin", "argmax", "ones", "zeros", "reverse", "split", "one_hot",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name
    )
    helper.set_variable_initializer(var, initializer=Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(
        dtype=dtypes.canonicalize(dtype), shape=x.shape, lod_level=x.lod_level
    )
    helper.append_op(
        "cast",
        {"X": [x]},
        {"Out": [out]},
        {"in_dtype": x.dtype, "out_dtype": dtypes.canonicalize(dtype)},
    )
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shape = None
    if all(v.shape is not None for v in input):
        shapes = [list(v.shape) for v in input]
        ndim = len(shapes[0])
        ax = axis % ndim
        if all(len(s) == ndim for s in shapes):
            shape = list(shapes[0])
            dims = [s[ax] for s in shapes]
            shape[ax] = -1 if any(d == -1 for d in dims) else sum(dims)
            shape = tuple(shape)
    out = helper.create_tmp_variable(
        dtype=helper.input_dtype(), shape=shape, lod_level=input[0].lod_level)
    helper.append_op("concat", {"X": input}, {"Out": [out]}, {"axis": axis})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_tmp_variable(
                dtype=input.dtype, shape=input.shape, lod_level=input.lod_level
            )
        helper.append_op("assign", {"X": [input]}, {"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_tmp_variable(dtype=str(input.dtype), shape=input.shape)
        helper.append_op(
            "assign_value",
            {},
            {"Out": [output]},
            {"shape": list(input.shape), "dtype": str(input.dtype), "values": input},
        )
    else:
        raise ValueError("Wrong type for assign input: %s" % type(input))
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_tmp_variable(
            dtype=dtypes.canonicalize(dtype), shape=tuple(shape), stop_gradient=True
        )
    helper.append_op(
        "fill_constant",
        {},
        {"Out": [out]},
        {"shape": list(shape), "dtype": dtypes.canonicalize(dtype), "value": float(value)},
    )
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(
        dtype=dtypes.canonicalize(dtype), shape=tuple(shape), stop_gradient=True
    )
    helper.append_op(
        "fill_constant_batch_size_like",
        {"Input": [input]},
        {"Out": [out]},
        {
            "shape": list(shape),
            "dtype": dtypes.canonicalize(dtype),
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    out.stop_gradient = True
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op("arg_min", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op("arg_max", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op("reverse", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """reference layers/nn.py:2365 split."""
    helper = LayerHelper("split", name=name)
    input_shape = input.shape
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "sections": [], "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_tmp_variable(dtype=input.dtype) for _ in range(num)]
    helper.append_op("split", {"X": [input]}, {"Out": outs}, attrs)
    return outs


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op("one_hot", {"X": [input]}, {"Out": [out]}, {"depth": depth})
    return out
