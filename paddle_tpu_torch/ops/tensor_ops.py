"""Tensor creation + initializer ops.

Reference parity: operators/{cast,fill_constant,gaussian_random,
uniform_random,assign}_op.cc. Random ops draw from the program's random
stream (ctx.rng, executor_core.RandomStream), or, when the op's own `seed`
attr is non-zero, take the numbers that seed alone fixes, the same at
every step (RandomStream.fixed); every allocation lands on ctx.device.
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


def random_draw(ctx, attrs, key, draw):
    """draw(generator) from the program's stream, or, for a non-zero
    `seed` attr, the numbers that seed fixes (held under `key`)."""
    seed = attrs.get("seed", 0)
    if not seed:
        return draw(ctx.rng.generator)
    return ctx.rng.fixed(key, seed, draw)


@register_op("gaussian_random")
def gaussian_random_op(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    z = random_draw(ctx, attrs, ("gaussian_random", shape),
                    lambda g: torch.randn(shape, generator=g,
                                          dtype=torch.float32,
                                          device=ctx.device))
    o = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return out(Out=astype(o, attrs.get("dtype", "float32")))


@register_op("uniform_random")
def uniform_random_op(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    o = random_draw(ctx, attrs, ("uniform_random", shape, lo, hi),
                    lambda g: torch.empty(shape, dtype=torch.float32,
                                          device=ctx.device).uniform_(
                                              lo, hi, generator=g))
    return out(Out=astype(o, attrs.get("dtype", "float32")))


@register_op("assign", lod_aware=True)
def assign_op(ctx, ins, attrs):
    return out(Out=first(ins, "X"))
