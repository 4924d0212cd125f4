"""Tensor creation, manipulation and embedding ops.

Reference parity: operators/{cast,concat,reshape,fill_constant,
gaussian_random,uniform_random,assign,lookup_table}_op.cc. Random ops draw
from the program's random stream (ctx.rng, executor_core.RandomStream),
or, when the op's own `seed` attr is non-zero, take the numbers that seed
alone fixes, the same at every step (RandomStream.fixed); every allocation
lands on ctx.device.
"""

import torch

from ..core import dtypes
from ..core.registry import SeqTensor, register_op
from .util import first, many, out, astype


@register_op("cast")
def cast_op(ctx, ins, attrs):
    return out(Out=astype(first(ins, "X"), attrs["out_dtype"]))


@register_op("concat")
def concat_op(ctx, ins, attrs):
    return out(Out=torch.cat(many(ins, "X"), dim=attrs.get("axis", 0)))


@register_op("reshape")
def reshape_op(ctx, ins, attrs):
    """A 0 in `shape` copies the input's dim (reference reshape_op.cc). The
    result is a view of the input where torch can make one."""
    x = first(ins, "X")
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return out(Out=x.reshape(shape))


@register_op("lookup_table", lod_aware=True)
def lookup_table_op(ctx, ins, attrs):
    """reference operators/lookup_table_op.cc (embedding): rows of W at
    Ids, zero where an id is `padding_idx`. Ids may be a SeqTensor of
    [N, 1] token ids, int32 or int64; the output keeps its lengths. The
    grad is the explicit lookup_table_grad (sparse_ops.py)."""
    w, ids = first(ins, "W"), first(ins, "Ids")
    lengths = ids.lengths if isinstance(ids, SeqTensor) else None
    idx = ids.data if lengths is not None else ids
    idx = idx.reshape(idx.shape[:-1]) if idx.shape[-1] == 1 else idx
    o = w[idx.long()]
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None and padding_idx >= 0:
        o = torch.where((idx == padding_idx)[..., None], 0.0, o)
    if lengths is not None:
        return out(Out=SeqTensor(o, lengths))
    return out(Out=o)


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
