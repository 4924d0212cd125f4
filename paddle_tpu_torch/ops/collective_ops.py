"""Collective ops over the step's mesh: the data-parallel collectives over
its dp axis, and the point-to-point permutes over its sp and pp axes.

Reference parity: operators/nccl/nccl_op.cu.cc (AllReduce/Reduce/Bcast) and
framework/details/nccl_all_reduce_op_handle.cc. The JAX package lowers
these to jax.lax collectives inside a mapped axis and makes them
identities outside one. In the port a step runs on one rank of a
torch.distributed group, which ParallelExecutor hands the step as
`OpContext.dp` (a parallel.mesh.Mesh; None for a plain Executor, or
without a group): with no group every op here is an identity (zero1's:
the single-device reshape, as the JAX package's off-mesh lowering), and
inside a group of any size, one included, each calls the collective —
NCCL on a card, gloo on the host — over the dp axis's group
(`Mesh.group`; the default group when dp spans it). A dp axis of one rank
in a larger group (a mesh whose other axes hold the ranks: `Mesh.solo`)
makes them identities: a collective over it would reach the other axes'
ranks.

Gradients take the convention of a value summed over ranks (psum's
transpose is psum): a rank's cotangent of a collective's output is its
part of the gradient of the one global loss, so the backward of a sum
all-reduces the cotangents, of an all_gather reduce-scatters them, and so
on. `psum_replicated` is the other case, a sum whose cotangent is the same
whole gradient on every rank (the `mean` op's loss); its backward
communicates nothing. Every collective any of these issues is counted on
`launch.launches` (replays of a captured step included).

`collective_permute` and the pipeline pair mirror the JAX package's
ppermute lowerings: each is an identity where its axis is not in the
step's mesh (or has one rank), which is how the host-driven
PipelineRunner runs them, and otherwise a permutation of the ranks'
values along the axis (`permute`: P2P send/recv over the axis's group,
`dist.batch_isend_irecv`). gloo moves host memory only, so under a gloo
group a card tensor travels through pinned host buffers: that is the
wire of such a group (ranks sharing one card, which NCCL refuses),
counted on `permute.host_staged_bytes`, and the copies are explicit. The
data-parallel collectives take the same wire there: a card tensor is
copied into a pinned host buffer, reduced or gathered by gloo and copied
back (`launch.host_staged_bytes` counts both copies, `launch.host_wire_s`
the host seconds from the first copy to the last, after the card's queued
work finished).
"""

import time

import torch
import torch.distributed as dist

from .. import cuda_build
from ..analysis.dataflow import COLLECTIVE_RW  # noqa: F401  (re-exported)
from ..core.registry import register_op
from .util import first, out

__all__ = ["COLLECTIVE_RW", "launch", "psum", "psum_replicated",
           "all_gather", "reduce_scatter", "broadcast", "permute",
           "gather_dim", "slice_dim", "masked_rows", "scatter_rows",
           "reset_launch_counts"]

REDUCTIONS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
              "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

# torch 2.13 renames the two single-tensor collectives; older releases
# (the card's) have only the first names
_all_gather_tensor = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def launch(call, *args, **kwargs):
    """Issue one collective `call` (over the group its `group` keyword
    names; the default group without one), synchronously on the current
    stream, and count it. With `async_op=True` it returns the call's
    Work, whose wait() makes the current stream wait for it."""
    work = call(*args, **kwargs)
    launch.launches += 1
    return work


cuda_build.count_launches(launch, "launches")


def reset_launch_counts():
    launch.launches = 0
    launch.host_staged_bytes = 0
    launch.host_wire_s = 0.0
    permute.host_staged_bytes = 0


launch.host_staged_bytes = 0
launch.host_wire_s = 0.0


def _staged(call, dst, src, dp, **kwargs):
    """`call(dst, src, **kwargs)` over gloo for card tensors: `src` through
    a pinned host buffer into a pinned host `dst`, then back into `dst`'s
    card tensor (`dst is src` for the in-place collectives). The card's
    queued work is waited for first, so `launch.host_wire_s` holds the
    wire's time alone."""
    torch.cuda.current_stream(src.device).synchronize()
    t0 = time.perf_counter()
    h_src = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    h_src.copy_(src)
    h_dst = h_src if dst is src else torch.empty(
        dst.shape, dtype=dst.dtype, pin_memory=True)
    if dst is src:
        launch(call, h_src, group=dp.group, **kwargs)
    else:
        launch(call, h_dst, h_src, group=dp.group, **kwargs)
    dst.copy_(h_dst)
    launch.host_staged_bytes += src.numel() * src.element_size() \
        + dst.numel() * dst.element_size()
    launch.host_wire_s += time.perf_counter() - t0
    return dst


def _solo(dp):
    """Whether `dp` (a Mesh or a MeshAxis) has one rank in a larger group:
    its collectives are identities (parallel/mesh.py)."""
    return getattr(dp, "solo", False)


def _host_wire(dp, x):
    """Whether a collective of `x` over `dp` takes the pinned host wire:
    a card tensor in a gloo group (ranks sharing one card)."""
    return dp.backend == "gloo" and x.is_cuda


# ---------------------------------------------------------------------------
# the collectives on tensors (fresh outputs; no autograd)
# ---------------------------------------------------------------------------
def _reduced(x, dp, op=dist.ReduceOp.SUM):
    y = torch.clone(x, memory_format=torch.contiguous_format)
    if _solo(dp):
        return y
    if _host_wire(dp, y):
        return _staged(dist.all_reduce, y, y, dp, op=op)
    launch(dist.all_reduce, y, op=op, group=dp.group)
    return y


def _gathered(x, dp):
    """[size, *x.shape]: every rank's x, in rank order."""
    flat = x.contiguous().reshape(-1)
    if _solo(dp):
        return flat.clone().reshape((1,) + tuple(x.shape))
    y = flat.new_empty((dp.size * flat.shape[0],))
    if _host_wire(dp, flat):
        _staged(_all_gather_tensor, y, flat, dp)
    else:
        launch(_all_gather_tensor, y, flat, group=dp.group)
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
    if dp.backend == "nccl" and not _solo(dp):
        y = x.new_empty((k,) + tuple(x.shape[1:]))
        launch(_reduce_scatter_tensor, y, x.contiguous(), group=dp.group)
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
        if _solo(dp):
            return y
        src = root if dp.group is None else dist.get_global_rank(dp.group,
                                                                 root)
        if _host_wire(dp, y):
            return _staged(dist.broadcast, y, y, dp, src=src)
        launch(dist.broadcast, y, src, group=dp.group)
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


def _p2p(ops):
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def _permuted(x, axis, perm):
    """This rank's value after the permutation `perm` of (source,
    destination) positions on `axis` (a parallel.mesh.MeshAxis): its x
    goes to every destination it is the source of, and it takes the value
    of its source, or zeros where no pair names it a destination (the
    ppermute contract). One batch of sends and receives over the axis's
    group, counted once on `launch.launches`."""
    me = axis.rank
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"permute: position {me} on {axis.name!r} is the "
                         f"destination of {srcs}")
    x = x.contiguous()
    staged = axis.backend == "gloo" and x.is_cuda
    if staged:  # gloo takes host memory: the pinned host wire
        wire = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        wire.copy_(x)
        permute.host_staged_bytes += x.numel() * x.element_size() \
            * len([d for d in dsts if d != me])
    else:
        wire = x
    recv = None
    ops = []
    for d in dsts:
        if d != me:
            ops.append(dist.P2POp(dist.isend, wire, axis.global_rank(d),
                                  group=axis.group))
    if srcs and srcs[0] != me:
        recv = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=staged)
        ops.append(dist.P2POp(dist.irecv, recv, axis.global_rank(srcs[0]),
                              group=axis.group))
    if ops:
        launch(_p2p, ops)
    if not srcs:
        return torch.zeros_like(x)
    if srcs[0] == me:
        return x.clone()
    if staged:
        permute.host_staged_bytes += recv.numel() * recv.element_size()
        return recv.to(x.device)
    return recv


class _Permute(torch.autograd.Function):
    """ppermute and its transpose: the cotangent goes back along the
    inverse permutation (what makes ring attention differentiable)."""

    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _permuted(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permuted(g, ctx.axis, inverse), None, None


def permute(x, axis, perm):
    """x permuted over the ranks of `axis` (a parallel.mesh.MeshAxis, or
    None: the identity) by `perm`, a list of (source, destination)
    positions; differentiable."""
    if axis is None:
        return x
    return _Permute.apply(x, axis, [tuple(int(v) for v in p) for p in perm])


permute.host_staged_bytes = 0


def _mesh_axis(ctx, name):
    return ctx.dp.axis(name) if ctx.dp is not None else None


def _group_of(ctx, attrs):
    """What a collective op communicates over: the step's mesh (its dp
    axis) for axis_name "dp", the default; the mesh's MeshAxis for
    another axis; None (the op is an identity) without a mesh, or where
    the axis has one rank or is not in the mesh."""
    name = attrs.get("axis_name", "dp")
    if ctx.dp is None:
        return None
    return ctx.dp if name == "dp" else ctx.dp.axis(name)


def gather_dim(x, axis, dim):
    """Every rank's x along `axis` (a MeshAxis), concatenated in position
    order on `dim`: the tiled all-gather of a value sharded there."""
    if axis is None:
        return x
    return torch.cat(_gathered(x, axis).unbind(0), dim=dim)


def slice_dim(x, axis, dim):
    """This rank's block of x along `dim` (x whole over `axis`)."""
    if axis is None:
        return x
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} is not "
                         f"divisible by the {axis.size} ranks of "
                         f"{axis.name!r}")
    k = n // axis.size
    return x.narrow(dim, axis.rank * k, k).clone(
        memory_format=torch.contiguous_format)


def _local_ids(ids, axis, rows):
    """(the ids as rows of this rank's block of a row-sharded table of
    `rows` rows a rank, whether each falls in the block)."""
    local = ids.long() - axis.rank * rows
    return local, (local >= 0) & (local < rows)


def masked_rows(shard, ids, axis, padding_idx=None):
    """The rows of a table sharded on its rows over `axis` (this rank's
    `shard`) at global `ids`, zero where an id falls outside the rank's
    block (or is `padding_idx`): the rank's part of the lookup, which a
    sum over the axis completes."""
    local, ok = _local_ids(ids, axis, shard.shape[0])
    if padding_idx is not None and padding_idx >= 0:
        ok = ok & (ids != padding_idx)
    rows = shard[local.clamp(0, shard.shape[0] - 1)]
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


def scatter_rows(g, ids, axis, rows, padding_idx=None, acc_dtype=None):
    """The gradient of this rank's shard of `rows` rows from the
    cotangent `g` [..., D] of a lookup at `ids`, the same on every rank:
    the masked local scatter-add, no collective, summed in `acc_dtype`
    (default g's) and returned in g's dtype. index_put_ with accumulate
    adds each id's rows in order (the same bits every run)."""
    local, ok = _local_ids(ids, axis, rows)
    if padding_idx is not None and padding_idx >= 0:
        ok = ok & (ids != padding_idx)
    acc = acc_dtype or g.dtype
    flat = g.reshape(-1, g.shape[-1])
    keep = ok.reshape(-1)
    out = torch.zeros((rows, g.shape[-1]), dtype=acc, device=g.device)
    out.index_put_((local.reshape(-1)[keep],), flat[keep].to(acc),
                   accumulate=True)
    return out.to(g.dtype)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
@register_op("all_reduce")
def all_reduce_op(ctx, ins, attrs):
    x = first(ins, "X")
    red = attrs.get("reduction", "sum")
    if red not in REDUCTIONS:
        raise ValueError(f"unknown reduction {red}")
    dp = _group_of(ctx, attrs)
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
    dp = _group_of(ctx, attrs)
    return out(Out=x if dp is None else all_gather(x, dp))


@register_op("reduce_scatter")
def reduce_scatter_op(ctx, ins, attrs):
    """This rank's rows of the sum over ranks of X (tiled on dim 0)."""
    x = first(ins, "X")
    dp = _group_of(ctx, attrs)
    return out(Out=x if dp is None else reduce_scatter(x, dp))


@register_op("broadcast")
def broadcast_op(ctx, ins, attrs):
    """NCCL bcast parity: every rank takes the root's X."""
    x = first(ins, "X")
    dp = _group_of(ctx, attrs)
    if dp is None:
        return out(Out=x)
    return out(Out=broadcast(x, dp, int(attrs.get("root", 0))))


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
    elif attrs.get("reduce", False) and attrs.get("overlap_async") \
            and dp.backend == "nccl" and not _solo(dp):
        return out(Out=_scattered_async(ctx, flat, dp, scale))
    elif attrs.get("reduce", False):
        shard = _scattered(flat, dp).reshape(1, -1)
    else:
        k = flat.shape[0] // parts
        shard = flat[dp.rank * k:(dp.rank + 1) * k].reshape(1, k).clone()
    if scale != 1.0:
        shard = shard * float(scale)
    return out(Out=shard)


def _scattered_async(ctx, flat, dp, scale):
    """A scatter the overlap schedule hoisted (analysis/schedule.py), over
    NCCL: the reduce-scatter issued with async_op=True, so the backward
    ops after it run beside it, and its wait (with the scale after it)
    deferred to the first op that reads or writes its output
    (OpContext.defer). In a captured graph the collective is then a
    branch off the step's stream, joined where its shard is read. The
    sum is the same NCCL reduce-scatter as the synchronous path's."""
    k = flat.shape[0] // dp.size
    y = flat.new_empty((k,))
    work = launch(_reduce_scatter_tensor, y, flat.contiguous(),
                  group=dp.group, async_op=True)
    shard = y.reshape(1, k)

    def finish():
        work.wait()
        if scale != 1.0:
            shard.mul_(float(scale))

    ctx.defer(ctx.current_op.outputs["Out"][0], finish)
    return shard


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


@register_op("collective_permute")
def collective_permute_op(ctx, ins, attrs):
    """ppermute over `axis_name`: this rank's X goes to the positions
    `perm` maps it to; an identity where the axis is not in the step's
    mesh."""
    axis = _mesh_axis(ctx, attrs.get("axis_name", "dp"))
    return out(Out=permute(first(ins, "X"), axis, attrs["perm"]))


def _pp_shift(ctx, x, attrs):
    """The pipeline boundary pair's lowering: a permute `peer` hops along
    the pp axis where it is in the step's mesh, the identity otherwise
    (the host-driven runner moves the value between stage programs
    itself, so there the ops mark the boundary for the analyses)."""
    axis = _mesh_axis(ctx, attrs.get("axis_name", "pp"))
    if axis is None:
        return x
    hop = int(attrs.get("peer", 1))
    return permute(x, axis, [(i, (i + hop) % axis.size)
                             for i in range(axis.size)])


@register_op("pipeline_send")
def pipeline_send_op(ctx, ins, attrs):
    return out(Out=_pp_shift(ctx, first(ins, "X"), attrs))


@register_op("pipeline_recv")
def pipeline_recv_op(ctx, ins, attrs):
    # the shift happened on the send side; recv materializes the arrival
    return out(Out=first(ins, "X"))


# ---------------------------------------------------------------------------
# the tensor-parallel lowering's ops (parallel/autoshard/lower.py): each an
# identity where its axis is not in the step's mesh or has one rank
# ---------------------------------------------------------------------------
@register_op("shard_gather")
def shard_gather_op(ctx, ins, attrs):
    """X sharded on `dim` over `axis_name`, whole: every rank's block
    concatenated in position order (the tiled all-gather)."""
    axis = _mesh_axis(ctx, attrs["axis_name"])
    return out(Out=gather_dim(first(ins, "X"), axis, int(attrs["dim"])))


@register_op("shard_slice")
def shard_slice_op(ctx, ins, attrs):
    """This rank's block on `dim` of X, whole over `axis_name`."""
    axis = _mesh_axis(ctx, attrs["axis_name"])
    return out(Out=slice_dim(first(ins, "X"), axis, int(attrs["dim"])))


def _lookup_ids(ids):
    return ids.reshape(ids.shape[:-1]) if ids.shape[-1] == 1 else ids


@register_op("shard_lookup_table")
def shard_lookup_table_op(ctx, ins, attrs):
    """lookup_table on W sharded on its rows over `axis_name`: the masked
    local gather of this rank's rows, then their sum over the axis (an
    all_reduce), which is the whole lookup on every rank."""
    axis = _mesh_axis(ctx, attrs["axis_name"])
    if axis is None:
        from .tensor_ops import lookup_table_op

        return lookup_table_op(ctx, ins, attrs)
    w, ids = first(ins, "W"), _lookup_ids(first(ins, "Ids"))
    return out(Out=_reduced(masked_rows(w, ids, axis,
                                        attrs.get("padding_idx", None)),
                            axis))


@register_op("shard_lookup_table_grad")
def shard_lookup_table_grad_op(ctx, ins, attrs):
    """W@GRAD of shard_lookup_table: the masked local scatter-add of the
    cotangent, which every rank holds whole; no collective."""
    axis = _mesh_axis(ctx, attrs["axis_name"])
    if axis is None:
        from .sparse_ops import lookup_table_grad_op

        return lookup_table_grad_op(ctx, ins, attrs)
    w, ids = first(ins, "W"), _lookup_ids(first(ins, "Ids"))
    g = first(ins, "Out@GRAD")
    dense = scatter_rows(g, ids, axis, w.shape[0],
                         attrs.get("padding_idx", None))
    return out(**{"W@GRAD": dense.to(w.dtype)})
