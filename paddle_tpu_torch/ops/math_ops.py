"""Math ops: the fc core, elementwise add, scale, mean and grad summation.

Reference parity: operators/mul_op.cc, elementwise_add_op.cc,
scale_op.cc, mean_op.cc, sum_op.cc. Matrix products go to torch.matmul
(cuBLAS on the card), as the JAX package leaves them to XLA.
"""

import math

import torch

from ..core.registry import register_op
from .util import first, many, out, bcast_y_to_x


@register_op("mul")
def mul_op(ctx, ins, attrs):
    """reference operators/mul_op.cc — flatten-to-2D matmul (the fc core)."""
    x, y = first(ins, "X"), first(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xn]) if xn else 1, -1)
    y2 = y.reshape(-1, math.prod(ys[yn:]) if yn < len(ys) else 1)
    o = torch.matmul(x2, y2)
    return out(Out=o.reshape(xs[:xn] + ys[yn:]))


@register_op("elementwise_add")
def elementwise_add_op(ctx, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    return out(Out=x + bcast_y_to_x(x, y, attrs.get("axis", -1)))


@register_op("sum")
def sum_op(ctx, ins, attrs):
    """reference operators/sum_op.cc — add N tensors (grad accumulation)."""
    xs = many(ins, "X")
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return out(Out=acc)


@register_op("scale")
def scale_op(ctx, ins, attrs):
    x = first(ins, "X")
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    o = x * s + b if attrs.get("bias_after_scale", True) else (x + b) * s
    return out(Out=o.to(x.dtype))


@register_op("mean")
def mean_op(ctx, ins, attrs):
    # fluid has no 0-d tensors: mean_op.cc infers Out as {1}
    return out(Out=first(ins, "X").mean().reshape(1))
