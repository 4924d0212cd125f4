"""Collective ops over the step's data-parallel group.

Reference parity: operators/nccl/nccl_op.cu.cc (AllReduce/Reduce/Bcast) and
framework/details/nccl_all_reduce_op_handle.cc. The JAX package lowers
these to jax.lax collectives inside a mapped axis and makes them
identities outside one. In the port a step runs on one rank of a
torch.distributed group, which ParallelExecutor hands the step as
`OpContext.dp` (a parallel.mesh.Mesh; None for a plain Executor, or
without a group): with no group every op here is an identity (zero1's:
the single-device reshape, as the JAX package's off-mesh lowering), and
inside a group of any size, one included, each calls the collective —
NCCL on a card, gloo on the host.

Gradients take the convention of a value summed over ranks (psum's
transpose is psum): a rank's cotangent of a collective's output is its
part of the gradient of the one global loss, so the backward of a sum
all-reduces the cotangents, of an all_gather reduce-scatters them, and so
on. `psum_replicated` is the other case, a sum whose cotangent is the same
whole gradient on every rank (the `mean` op's loss); its backward
communicates nothing. Every collective any of these issues is counted on
`launch.launches` (replays of a captured step included).

collective_permute and pipeline_send/recv wait for the pipeline and ring
slice (ROADMAP queue 1 item 10).
"""

import torch
import torch.distributed as dist

from .. import cuda_build
from ..analysis.dataflow import COLLECTIVE_RW  # noqa: F401  (re-exported)
from ..core.registry import register_op
from .util import first, out

__all__ = ["COLLECTIVE_RW", "launch", "psum", "psum_replicated",
           "all_gather", "reduce_scatter", "broadcast", "reset_launch_counts"]

REDUCTIONS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
              "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

# torch 2.13 renames the two single-tensor collectives; older releases
# (the card's) have only the first names
_all_gather_tensor = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def launch(call, *args, **kwargs):
    """Issue one collective `call` over the default group (which every
    parallel.mesh.Mesh spans), synchronously on the current stream, and
    count it."""
    call(*args, **kwargs)
    launch.launches += 1


cuda_build.count_launches(launch, "launches")


def reset_launch_counts():
    launch.launches = 0


# ---------------------------------------------------------------------------
# the collectives on tensors (fresh outputs; no autograd)
# ---------------------------------------------------------------------------
def _reduced(x, dp, op=dist.ReduceOp.SUM):
    y = torch.clone(x, memory_format=torch.contiguous_format)
    launch(dist.all_reduce, y, op=op)
    return y


def _gathered(x, dp):
    """[size, *x.shape]: every rank's x, in rank order."""
    flat = x.contiguous().reshape(-1)
    y = flat.new_empty((dp.size * flat.shape[0],))
    launch(_all_gather_tensor, y, flat)
    return y.reshape((dp.size,) + tuple(x.shape))


def _scattered(x, dp):
    """Rows [rank*k, (rank+1)*k) of the sum over ranks of x [size*k, ...].
    gloo has no reduce-scatter: there it is the all-reduce and the rank's
    slice, the same sum."""
    n = x.shape[0]
    if n % dp.size:
        raise ValueError(f"reduce_scatter: dim 0 ({n}) not divisible by the "
                         f"{dp.size} ranks")
    k = n // dp.size
    if dp.backend == "nccl":
        y = x.new_empty((k,) + tuple(x.shape[1:]))
        launch(_reduce_scatter_tensor, y, x.contiguous())
        return y
    return _reduced(x, dp)[dp.rank * k:(dp.rank + 1) * k]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return _reduced(x, dp)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.dp), None


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        return _reduced(x, dp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return _gathered(x, dp)

    @staticmethod
    def backward(ctx, g):
        return _scattered(g, ctx.dp).reshape(g.shape[1:]), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return _scattered(x, dp)

    @staticmethod
    def backward(ctx, g):
        gathered = _gathered(g, ctx.dp)
        return gathered.reshape((-1,) + tuple(g.shape[1:])), None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp, root):
        ctx.dp, ctx.root = dp, root
        y = torch.clone(x, memory_format=torch.contiguous_format)
        launch(dist.broadcast, y, root)
        return y

    @staticmethod
    def backward(ctx, g):
        s = _reduced(g, ctx.dp)
        return (s if ctx.dp.rank == ctx.root else torch.zeros_like(s)), \
            None, None


class _Extremum(torch.autograd.Function):
    """all_reduce max/min: forward only."""

    @staticmethod
    def forward(ctx, x, dp, op):
        return _reduced(x, dp, op)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "all_reduce with reduction max/min has no gradient")


def psum(x, dp):
    """Sum of x over the ranks of `dp`; its gradient is the sum of the
    ranks' cotangents (each a part of the global loss's)."""
    return _Psum.apply(x, dp)


def psum_replicated(x, dp):
    """Sum of x over the ranks of `dp`, for an output whose cotangent is
    the whole gradient on every rank: the backward passes it through."""
    return _PsumReplicated.apply(x, dp)


def all_gather(x, dp):
    return _AllGather.apply(x, dp)


def reduce_scatter(x, dp):
    return _ReduceScatter.apply(x, dp)


def broadcast(x, dp, root=0):
    return _Broadcast.apply(x, dp, root)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
@register_op("all_reduce")
def all_reduce_op(ctx, ins, attrs):
    x = first(ins, "X")
    red = attrs.get("reduction", "sum")
    if red not in REDUCTIONS:
        raise ValueError(f"unknown reduction {red}")
    dp = ctx.dp
    if dp is None:
        return out(Out=x)
    if red in ("sum", "mean"):
        y = psum(x, dp)
        if red == "mean":
            y = (y / dp.size).to(x.dtype)
        return out(Out=y)
    return out(Out=_Extremum.apply(x, dp, REDUCTIONS[red]))


@register_op("all_gather")
def all_gather_op(ctx, ins, attrs):
    """[size, *X.shape]: every rank's X stacked in rank order (the JAX
    package's untiled all_gather)."""
    x = first(ins, "X")
    return out(Out=x if ctx.dp is None else all_gather(x, ctx.dp))


@register_op("reduce_scatter")
def reduce_scatter_op(ctx, ins, attrs):
    """This rank's rows of the sum over ranks of X (tiled on dim 0)."""
    x = first(ins, "X")
    return out(Out=x if ctx.dp is None else reduce_scatter(x, ctx.dp))


@register_op("broadcast")
def broadcast_op(ctx, ins, attrs):
    """NCCL bcast parity: every rank takes the root's X."""
    x = first(ins, "X")
    if ctx.dp is None:
        return out(Out=x)
    return out(Out=broadcast(x, ctx.dp, int(attrs.get("root", 0))))


def _padded_flat(x, parts):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % parts
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def _zero1_group(ctx, parts, op_type):
    dp = ctx.dp
    if dp is not None and dp.size != parts:
        raise ValueError(f"{op_type}: the program is laid out for {parts} "
                         f"ranks, the step runs on {dp.size}")
    return dp


@register_op("zero1_scatter")
def zero1_scatter_op(ctx, ins, attrs):
    """ZeRO-1 shard layout: X flattened and zero-padded to a multiple of
    `parts` is [parts, shard]; this rank keeps its row, [1, shard]. With
    `reduce` (a gradient, each rank holding its part) the rows are summed
    over the ranks first — the reduce-scatter — and the optional `scale`
    (GradientScaleStrategy) multiplies the shard after it. Without a group
    the op is the JAX package's off-mesh reshape to [parts, shard]."""
    x = first(ins, "X")
    parts = int(attrs["parts"])
    scale = attrs.get("scale", 1.0)
    flat = _padded_flat(x, parts)
    dp = _zero1_group(ctx, parts, "zero1_scatter")
    if dp is None:
        shard = flat.reshape(parts, -1)
    elif attrs.get("reduce", False):
        shard = _scattered(flat, dp).reshape(1, -1)
    else:
        k = flat.shape[0] // parts
        shard = flat[dp.rank * k:(dp.rank + 1) * k].reshape(1, k).clone()
    if scale != 1.0:
        shard = shard * float(scale)
    return out(Out=shard)


@register_op("zero1_gather")
def zero1_gather_op(ctx, ins, attrs):
    """ZeRO-1 param regather: every rank's updated [1, shard] row (the
    all-gather), the padding dropped, in the param's shape. Without a
    group X is the whole [parts, shard] layout and only reshapes."""
    x = first(ins, "X")
    numel = int(attrs["numel"])
    shape = tuple(attrs.get("shape", (numel,)))
    dp = ctx.dp
    if dp is not None:
        x = _gathered(x.reshape(-1), dp)
    return out(Out=x.reshape(-1)[:numel].reshape(shape))
