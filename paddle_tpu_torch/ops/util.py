"""Kernel-authoring helpers."""

import torch

from ..core import dtypes


def first(ins, slot, default=None):
    vals = ins.get(slot)
    if not vals:
        return default
    return vals[0]


def many(ins, slot):
    return [v for v in ins.get(slot, []) if v is not None]


def out(**slots):
    return {k: v if isinstance(v, list) else [v] for k, v in slots.items()}


def at_least_f32(x):
    """x in f32 where the JAX package computes in f32 (a bf16 or f32 x),
    or in its own wider dtype (f64, which the JAX package never sees)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def astype(x, dtype):
    return x.to(dtypes.to_torch(dtype))


def bcast_y_to_x(x, y, axis):
    """Reference elementwise broadcast: Y's shape matches a contiguous
    subsequence of X's dims starting at `axis` (default: trailing align,
    computed on the untrimmed Y rank); Y's trailing size-1 dims are trimmed
    before alignment. operators/elementwise_op_function.h semantics
    (trim_trailing_singular_dims + get_mid_dims)."""
    if x.ndim == y.ndim:
        return y
    if axis == -1 or axis is None:
        axis = x.ndim - y.ndim
    shape = list(y.shape)
    while len(shape) > 1 and shape[-1] == 1:
        shape.pop()
    if axis + len(shape) > x.ndim:
        raise ValueError(
            f"elementwise Y{tuple(y.shape)} does not fit X{tuple(x.shape)} "
            f"at axis={axis}")
    new_shape = [1] * axis + shape + [1] * (x.ndim - axis - len(shape))
    return y.reshape(new_shape)
