"""Comparison and logical ops (reference operators/{compare,logical}_op.cc),
the part of the JAX package's paddle_tpu/ops/control_flow_ops.py that
carries no sub-block: `while`, `conditional_block` and the tensor-array
ops come with the control-flow slice.

Each broadcasts X and Y as numpy does and gives a bool tensor, which no
gradient passes through (set_stop_gradient_outputs), so the backward walk
never routes a cotangent into a condition.
"""

import torch

from ..core.registry import register_op, set_stop_gradient_outputs
from .util import first, out


def _cmp(fn):
    def kernel(ctx, ins, attrs):
        return out(Out=fn(first(ins, "X"), first(ins, "Y")))

    return kernel


for _name, _fn in [
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("logical_and", torch.logical_and),
    ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    register_op(_name)(_cmp(_fn))


@register_op("logical_not")
def logical_not_op(ctx, ins, attrs):
    return out(Out=torch.logical_not(first(ins, "X")))


for _name in ("less_than", "less_equal", "greater_than", "greater_equal",
              "equal", "not_equal", "logical_and", "logical_or",
              "logical_xor", "logical_not"):
    set_stop_gradient_outputs(_name, ["Out"])
