"""Tensor creation + initializer ops.

Reference parity: operators/{cast,fill_constant,gaussian_random,
uniform_random,assign}_op.cc. Random ops draw from the step's
torch.Generator (ctx.generator), or from a generator seeded by the op's
own `seed` attr when it is non-zero; every allocation lands on ctx.device.
"""

import torch

from ..core import dtypes
from ..core.registry import register_op
from .util import first, out, astype


@register_op("cast")
def cast_op(ctx, ins, attrs):
    return out(Out=astype(first(ins, "X"), attrs["out_dtype"]))


@register_op("fill_constant")
def fill_constant_op(ctx, ins, attrs):
    dtype = dtypes.to_torch(attrs.get("dtype", "float32"))
    return out(Out=torch.full(tuple(attrs["shape"]), attrs["value"],
                              dtype=dtype, device=ctx.device))


def _generator(ctx, attrs):
    seed = attrs.get("seed", 0)
    if not seed:
        return ctx.generator
    return torch.Generator(device=ctx.device).manual_seed(int(seed))


@register_op("gaussian_random")
def gaussian_random_op(ctx, ins, attrs):
    z = torch.randn(tuple(attrs["shape"]), generator=_generator(ctx, attrs),
                    dtype=torch.float32, device=ctx.device)
    o = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return out(Out=astype(o, attrs.get("dtype", "float32")))


@register_op("uniform_random")
def uniform_random_op(ctx, ins, attrs):
    o = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                    device=ctx.device)
    o.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
               generator=_generator(ctx, attrs))
    return out(Out=astype(o, attrs.get("dtype", "float32")))


@register_op("assign", lod_aware=True)
def assign_op(ctx, ins, attrs):
    return out(Out=first(ins, "X"))
