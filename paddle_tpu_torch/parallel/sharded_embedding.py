"""Mesh-sharded embedding: the collective counterpart of the pserver
distributed lookup table (the JAX package's parallel/sharded_embedding.py).

Reference contrast: the reference's only sharded-embedding path is the
pserver prefetch RPC (distribute_transpiler.py:624, operators/prefetch_op.cc)
— host round-trips per lookup. Here the table stays row-sharded over the
mesh's `mp` axis on the cards, and a lookup is one sum over the axis:
every rank gathers the ids that fall in its row range (a masked local
gather) and the all-reduce assembles full rows everywhere. The gradient
is the transpose: the masked local scatter-add of the cotangent, which
every rank holds whole, with no collective — what the JAX package's
`jax.grad` derives through its shard_map.

The JAX package's functions take a jax Mesh; these take the port's
parallel.mesh.Mesh, whose `mp` axis (Mesh.axis) names this rank's
position and the torch.distributed group of its row shards. Without an
mp axis of more than one rank the table is whole and the lookup plain.
"""

import torch

from ..ops.collective_ops import _reduced, masked_rows, scatter_rows

__all__ = ["shard_table", "sharded_embedding_lookup"]


def _axis(mesh, axis):
    return mesh.axis(axis) if mesh is not None else None


def shard_table(table, mesh, axis="mp"):
    """This rank's rows of a [V, D] table row-sharded over mesh axis
    `axis` (V must divide evenly; pad the vocab up like every TP
    implementation does)."""
    ax = _axis(mesh, axis)
    nshards = mesh.shape.get(axis, 1) if mesh is not None else 1
    if table.shape[0] % nshards:
        raise ValueError(f"vocab {table.shape[0]} not divisible by "
                         f"{nshards} shards; pad it")
    if ax is None:
        return table
    rows = table.shape[0] // nshards
    return table[ax.rank * rows:(ax.rank + 1) * rows].clone()


class _ShardedLookup(torch.autograd.Function):
    """rows = sum over the axis of each rank's masked local gather;
    d(shard) = the masked local scatter-add of the replicated cotangent,
    summed in f32 as torch's dense embedding gradient sums a bf16 or
    f16 one."""

    @staticmethod
    def forward(ctx, shard, ids, axis):
        ctx.save_for_backward(ids)
        ctx.axis, ctx.rows = axis, shard.shape[0]
        return _reduced(masked_rows(shard, ids, axis), axis)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return scatter_rows(g, ids, ctx.axis, ctx.rows,
                            acc_dtype=torch.float32), None, None


def sharded_embedding_lookup(table, ids, mesh, axis="mp"):
    """ids [...] int -> rows [..., D]; `table` this rank's [V/n, D] rows of
    a table sharded on its rows over `axis` (see shard_table). Equal to
    the lookup in the unsharded table, bitwise (each row is one rank's,
    the others add zeros); differentiable through the table operand."""
    ax = _axis(mesh, axis)
    if ax is None:
        return table[ids.long()]
    return _ShardedLookup.apply(table, ids, ax)
