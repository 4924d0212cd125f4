"""Tensor creation, manipulation and embedding ops.

Reference parity: operators/{cast,concat,split,reshape,transpose,pad,crop,
gather,scatter,one_hot,fill_constant,fill_constant_batch_size_like,
fill_zeros_like,gaussian_random,uniform_random,assign,assign_value,shape,
increment,expand,label_smooth,reverse,arg_min_max,argsort,is_empty,isfinite,
lookup_table,truncated_gaussian_random,multiplex,lod_reset}_op.cc, each as
the JAX package's paddle_tpu/ops/tensor_ops.py computes it. Random ops
draw from the program's random stream (ctx.rng,
executor_core.RandomStream), or, when the op's own `seed` attr is
non-zero, take the numbers that seed alone
fixes, the same at every step (RandomStream.fixed); every allocation lands
on ctx.device. A value made on the host (`shape`, `assign_value`) is
copied to the device once and held (RandomStream.held): a captured step
copies it on the device. Integer outputs are int64 where the JAX package,
which runs with 64-bit types off, has int32.
"""

import math

import numpy as np
import torch

from ..core import dtypes
from ..core.registry import SeqTensor, register_op, seq_data
from .util import first, many, out, astype


@register_op("cast")
def cast_op(ctx, ins, attrs):
    return out(Out=astype(first(ins, "X"), attrs["out_dtype"]))


@register_op("concat")
def concat_op(ctx, ins, attrs):
    return out(Out=torch.cat(many(ins, "X"), dim=attrs.get("axis", 0)))


@register_op("split")
def split_op(ctx, ins, attrs):
    """`num` equal parts along `axis`, or parts cut at the running sums
    of `sections` (the last section takes the rest, as the JAX package's
    jnp.split at those indices does). The parts are views of X."""
    x = first(ins, "X")
    axis = attrs.get("axis", -1)
    num = attrs.get("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {x.shape[axis]} of axis {axis} "
                             f"does not divide into {num} equal parts")
        parts = torch.tensor_split(x, num, dim=axis)
    else:
        cuts = np.cumsum(attrs.get("sections", []))[:-1].tolist()
        parts = torch.tensor_split(x, cuts, dim=axis)
    return out(Out=list(parts))


@register_op("split_byref")
def split_byref_op(ctx, ins, attrs):
    """reference operators/split_byref_op.cc: X cut along axis 0 into parts
    of `sections` rows, each a view of X (no copy). The parameter
    server's trainer program splits a gradient with it into the blocks
    it sends; the JAX package's transpiler emits it but registers no
    kernel for it (ROADMAP §3)."""
    x = first(ins, "X")
    if attrs.get("axis", 0) != 0:
        raise ValueError("split_byref splits along axis 0 only")
    sections = [int(n) for n in attrs["sections"]]
    if sum(sections) != x.shape[0]:
        raise ValueError(f"split_byref: sections {sections} do not add up "
                         f"to {x.shape[0]} rows")
    return out(Out=list(torch.split(x, sections, dim=0)))


@register_op("reshape")
def reshape_op(ctx, ins, attrs):
    """A 0 in `shape` copies the input's dim (reference reshape_op.cc). The
    result is a view of the input where torch can make one."""
    x = first(ins, "X")
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return out(Out=x.reshape(shape))


@register_op("transpose")
def transpose_op(ctx, ins, attrs):
    return out(Out=first(ins, "X").permute(list(attrs["axis"])))


@register_op("pad")
def pad_op(ctx, ins, attrs):
    """`paddings` holds (before, after) for each dim in order."""
    x = first(ins, "X")
    p = attrs["paddings"]
    pairs = []
    for i in reversed(range(x.ndim)):  # F.pad takes the last dim first
        pairs += [p[2 * i], p[2 * i + 1]]
    return out(Out=torch.nn.functional.pad(
        x, pairs, value=attrs.get("pad_value", 0.0)))


@register_op("crop")
def crop_op(ctx, ins, attrs):
    x = first(ins, "X")
    return out(Out=x[tuple(slice(o, o + n) for o, n in zip(
        attrs.get("offsets"), attrs.get("shape")))])


def _wrap(idx, n):
    """Indices into a dim of `n` (int64), negative ones counted from the
    end, and the mask of those inside it."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


@register_op("gather")
def gather_op(ctx, ins, attrs):
    """Rows of X at Index. As jnp.take: negative indices count from the
    end, and a row out of range is NaN (a float X) — no device assert."""
    x, idx = first(ins, "X"), first(ins, "Index")
    idx, ok = _wrap(idx, x.shape[0])
    o = x[torch.where(ok, idx, 0)]
    if x.dtype.is_floating_point:
        o = torch.where(ok.reshape(ok.shape + (1,) * (x.ndim - 1)), o,
                        float("nan"))
    return out(Out=o)


@register_op("scatter")
def scatter_op(ctx, ins, attrs):
    """X with row Ids[i] set to Updates[i]. A row named more than once
    takes its LAST update, as the JAX package's .at[].set does on the
    CPU, and on the card too: the winner of each row is the largest
    position naming it (a max, so independent of the order of writes),
    and every row of the result is gathered, not written. Negative ids
    count from the end; ids out of range are dropped."""
    x, ids, upd = first(ins, "X"), first(ins, "Ids"), first(ins, "Updates")
    rows = x.shape[0]
    idx, ok = _wrap(ids.reshape(-1), rows)
    if idx.shape[0] == 0:
        return out(Out=x.clone())
    upd = upd.reshape((idx.shape[0],) + tuple(x.shape[1:]))
    pos = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((rows + 1,), -1, dtype=torch.long, device=idx.device)
    winner = winner.scatter_reduce(0, torch.where(ok, idx, rows), pos,
                                   reduce="amax")[:rows]
    hit = (winner >= 0).reshape((rows,) + (1,) * (x.ndim - 1))
    return out(Out=torch.where(hit, upd[winner.clamp_min(0)].to(x.dtype), x))


@register_op("one_hot")
def one_hot_op(ctx, ins, attrs):
    """[N, depth] float32 rows of X's flattened ids; an id outside
    [0, depth) gives a row of zeros (jax.nn.one_hot)."""
    flat = first(ins, "X").reshape(-1).long()
    depth = attrs["depth"]
    classes = torch.arange(depth, device=flat.device)
    return out(Out=(flat[:, None] == classes).to(torch.float32))


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like_op(ctx, ins, attrs):
    ref = first(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    dtype = dtypes.to_torch(attrs.get("dtype", "float32"))
    return out(Out=torch.full(tuple(shape), attrs["value"], dtype=dtype,
                              device=ctx.device))


@register_op("fill_zeros_like")
def fill_zeros_like_op(ctx, ins, attrs):
    return out(Out=torch.zeros_like(first(ins, "X")))


def _held_constant(ctx, key, array, dtype):
    """`array` (numpy) as a `dtype` tensor on ctx.device, copied from the
    host once and held (RandomStream.held)."""
    return ctx.rng.held(key, lambda: torch.from_numpy(
        np.ascontiguousarray(array)).to(device=ctx.device, dtype=dtype))


@register_op("shape")
def shape_op(ctx, ins, attrs):
    shape = tuple(first(ins, "X").shape)
    return out(Out=_held_constant(ctx, ("shape", shape),
                                  np.asarray(shape, np.int64), torch.int64))


@register_op("increment")
def increment_op(ctx, ins, attrs):
    """X + step in X's dtype; X is Out for the step counter, a
    persistable that a captured step advances on the device."""
    x = first(ins, "X")
    step = attrs.get("step", 1.0)
    return out(Out=x + (step if x.dtype.is_floating_point else int(step)))


@register_op("expand")
def expand_op(ctx, ins, attrs):
    return out(Out=torch.tile(first(ins, "X"), tuple(attrs["expand_times"])))


@register_op("label_smooth")
def label_smooth_op(ctx, ins, attrs):
    x = first(ins, "X")
    eps = attrs.get("epsilon", 0.0)
    dist = first(ins, "PriorDist")
    if dist is not None:
        return out(Out=(1 - eps) * x + eps * dist)
    return out(Out=(1 - eps) * x + eps / x.shape[-1])


@register_op("reverse")
def reverse_op(ctx, ins, attrs):
    axis = attrs["axis"]
    axis = [axis] if isinstance(axis, int) else list(axis)
    return out(Out=torch.flip(first(ins, "X"), axis))


@register_op("assign_value")
def assign_value_op(ctx, ins, attrs):
    """The constant `values` of `shape` and `dtype` (NumpyArrayInitializer,
    layers.assign of an array)."""
    dtype = attrs.get("dtype", "float32")
    arr = np.asarray(attrs["values"]).reshape(attrs["shape"])
    key = ("assign_value", dtype, arr.shape, arr.dtype.str, arr.tobytes())
    return out(Out=_held_constant(ctx, key, arr, dtypes.to_torch(dtype)))


def _arg(fn):
    def kernel(ctx, ins, attrs):
        """The first extreme's int64 index along `axis` (default -1); a
        rank-1 X gives {1} (fluid has no 0-d tensors)."""
        o = fn(first(ins, "X"), dim=attrs.get("axis", -1))
        return out(Out=o.reshape(1) if o.ndim == 0 else o)

    return kernel


register_op("arg_max")(_arg(torch.argmax))
register_op("arg_min")(_arg(torch.argmin))


@register_op("argsort")
def argsort_op(ctx, ins, attrs):
    """Ascending and stable along `axis`, as jnp.argsort: ties keep their
    order. Out is X sorted, Indices int64."""
    x = first(ins, "X")
    axis = attrs.get("axis", -1)
    idx = torch.argsort(x, dim=axis, stable=True)
    return out(Out=torch.take_along_dim(x, idx, dim=axis), Indices=idx)


@register_op("is_empty")
def is_empty_op(ctx, ins, attrs):
    """One 0-d bool on the device: whether X has no element (its shape
    decides; a fill, so a captured step holds it)."""
    x = first(ins, "X")
    return out(Out=torch.full((), x.numel() == 0, dtype=torch.bool,
                              device=x.device))


@register_op("isfinite")
def isfinite_op(ctx, ins, attrs):
    """One 0-d bool on the device, as the JAX package's jnp.all: whether
    every element of X is finite. Nothing reads it on the host."""
    return out(Out=torch.all(torch.isfinite(first(ins, "X"))))


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


# the standard normal's CDF at the truncation bounds -2 and 2
_TRUNC_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_TRUNC_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


@register_op("truncated_gaussian_random")
def truncated_gaussian_random_op(ctx, ins, attrs):
    """mean + std * z, z standard normal truncated to [-2, 2] (the JAX
    package's jax.random.truncated_normal(-2, 2)): the inverse CDF of a
    uniform draw between the bounds' CDF values, clipped to the bounds."""
    shape = tuple(attrs["shape"])

    def draw(g):
        u = torch.empty(shape, dtype=torch.float32, device=ctx.device)
        u.uniform_(_TRUNC_LO, _TRUNC_HI, generator=g)
        return torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0),
                           -2.0, 2.0)

    z = random_draw(ctx, attrs, ("truncated_gaussian_random", shape), draw)
    o = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return out(Out=astype(o, attrs.get("dtype", "float32")))


@register_op("multiplex")
def multiplex_op(ctx, ins, attrs):
    """Row i of Out is row i of the Ids[i]-th input."""
    idx = first(ins, "Ids").reshape(-1).long()
    xs = torch.stack(many(ins, "X"), dim=0)  # [K, B, ...]
    rows = torch.arange(idx.shape[0], device=idx.device)
    return out(Out=xs[idx, rows])


@register_op("lod_reset", lod_aware=True)
def lod_reset_op(ctx, ins, attrs):
    """X's rows with new sequence lengths: Y's lengths (Y a SeqTensor) or
    Y's values (a dense Y), or the differences of the `target_lod` attr's
    offsets, copied to the device once and held."""
    data, y = seq_data(first(ins, "X")), first(ins, "Y")
    if y is not None:
        lengths = y.lengths if isinstance(y, SeqTensor) \
            else y.reshape(-1).to(torch.int32)
        return out(Out=SeqTensor(data, lengths))
    target = attrs.get("target_lod")
    lengths = _held_constant(ctx, ("lod_reset", tuple(target)),
                             np.diff(np.asarray(target)), torch.int32)
    return out(Out=SeqTensor(data, lengths))
