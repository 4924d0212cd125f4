"""The embedding gradient and the distributed-lookup-table ops.

Reference parity (the JAX package's paddle_tpu/ops/sparse_ops.py):
  - operators/lookup_table_op.cc grad (dense, or a SelectedRows gradient
    with is_sparse; without W for a distributed table)
  - operators/split_ids_op.cc (mod-shard ids / SelectedRows rows)
  - operators/merge_ids_op.cc (reassemble prefetched rows in id order)
  - operators/prefetch_op.cc (RPC row fetch from pservers)
  - operators/lookup_sparse_table_op.cc (auto-grown pserver table gather)
  - the startup op creating a pserver's SparseTable (init_sparse_table)
The sum, scale and sgd paths on SelectedRows live in math_ops.py and
optimizer_ops.py.

The trainer's sparse gradient is a SelectedRows of two device tensors of
static shape (ids, grad rows), so it stays inside a captured step. The
shard, RPC and table ops are host ops (core/executor_core.py HOST_OPS,
HOST_SYNC_OPS): they work on numpy, and the pserver's table is a
SparseTable on the host.
"""

import numpy as np
import torch

from ..core.registry import SeqTensor, register_grad_maker, register_op
from ..core.dtypes import to_host
from ..core.selected_rows import SelectedRows, SparseTable
from .util import first, many, out


def _flat_ids(ids):
    """Ids (maybe a SeqTensor, maybe [N, 1]) -> flat ids [N]."""
    idx = ids.data if isinstance(ids, SeqTensor) else ids
    if idx.ndim >= 2 and idx.shape[-1] == 1:
        idx = idx.reshape(idx.shape[:-1])
    return idx


@register_op("lookup_table_grad", lod_aware=True)
def lookup_table_grad_op(ctx, ins, attrs):
    """W@GRAD: with is_sparse a SelectedRows (rows = the ids, values = the
    rows of Out@GRAD), else the dense [height, dim] sum of those rows into
    the rows of their ids; rows of `padding_idx` add nothing. A
    distributed table's grad op has no W (the transpiler pruned it from
    the trainer) and carries the vocab size as its `height` attr. The
    dense sum goes through index_put_ with accumulate=True, which sorts
    the ids and adds each id's rows in their order on a CUDA device (and
    in order on the CPU): the same bits at every run, where index_add_
    would add with atomics in whatever order the threads reach them."""
    w = first(ins, "W")
    idx = _flat_ids(first(ins, "Ids"))
    g = first(ins, "Out@GRAD")
    gd = g.data if isinstance(g, SeqTensor) else g
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None and padding_idx >= 0:
        gd = torch.where((idx == padding_idx)[..., None], 0.0, gd)
    if w is None:
        if not attrs.get("is_sparse", False):
            raise ValueError("lookup_table_grad without W requires is_sparse")
        height = int(attrs["height"])
    else:
        height = w.height if isinstance(w, SparseTable) else w.shape[0]
    rows = gd.reshape((-1,) + tuple(gd.shape[idx.ndim:]))
    if attrs.get("is_sparse", False):
        return out(**{"W@GRAD": SelectedRows(idx.reshape(-1), rows, height)})
    dense = torch.zeros(w.shape, dtype=gd.dtype, device=gd.device)
    dense.index_put_((idx.reshape(-1).long(),), rows, accumulate=True)
    return out(**{"W@GRAD": dense.to(w.dtype)})


@register_op("split_ids", lod_aware=True)
def split_ids_op(ctx, ins, attrs):
    """reference operators/split_ids_op.cc: mod-shard ids (deduped, sorted,
    numpy int64) or a SelectedRows gradient's rows across the N outputs
    (shard s takes the rows r with r % N == s, in their order)."""
    x = first(ins, "Ids")
    if x is None:
        x = first(ins, "X")
    n = len(ctx.current_op.output("Out"))
    if isinstance(x, SelectedRows):
        rows = x.rows.reshape(-1)
        shard = rows % n
        return out(Out=[SelectedRows(rows[shard == s], x.values[shard == s],
                                     x.height) for s in range(n)])
    idx = np.unique(to_host(_flat_ids(x)).reshape(-1))
    return out(Out=[idx[(idx % n) == s].astype(np.int64) for s in range(n)])


@register_op("merge_ids", lod_aware=True)
def merge_ids_op(ctx, ins, attrs):
    """reference operators/merge_ids_op.cc: given the original Ids, the
    shards' id lists and the shards' fetched rows, emit the rows in the
    original id order, on the step's device."""
    ids = first(ins, "Ids")
    idx = to_host(_flat_ids(ids))
    row_of = {}
    for sid, srow in zip(many(ins, "X"), many(ins, "Rows")):
        for i, r in zip(to_host(sid).reshape(-1), to_host(srow)):
            row_of[int(i)] = r
    o = np.stack([row_of[int(i)] for i in idx.reshape(-1)])
    o = torch.from_numpy(o.reshape(tuple(idx.shape) + o.shape[1:])).to(
        ctx.device)
    if isinstance(ids, SeqTensor):
        return out(Out=SeqTensor(o, ids.lengths, ids.host_lengths))
    return out(Out=o)


@register_op("prefetch", lod_aware=True)
def prefetch_op(ctx, ins, attrs):
    """reference operators/prefetch_op.cc: send each shard's ids to its
    pserver and receive their embedding rows (served by the pserver's
    prefetch block); numpy on the host."""
    from . import rpc_ops

    epmap = attrs["epmap"]
    table_names = attrs.get("table_names") or [attrs["table_name"]] * len(
        epmap)
    rows = []
    with rpc_ops._timed("prefetch"):
        for ids, ep, tname in zip(many(ins, "X"), epmap, table_names):
            ids = to_host(ids).reshape(-1)
            if ids.size == 0:
                rows.append(np.zeros((0, int(attrs["emb_dim"])),
                                     np.dtype(attrs.get("dtype", "float32"))))
                continue
            rows.append(rpc_ops._client(ep).prefetch(tname, ids))
            rpc_ops.stats["prefetch_rows"] += ids.size
    return out(Out=rows)


@register_op("lookup_sparse_table", lod_aware=True)
def lookup_sparse_table_op(ctx, ins, attrs):
    """reference operators/lookup_sparse_table_op.cc: gather from an
    auto-grown SparseTable (numpy rows); unseen ids are initialized on
    first touch."""
    w = first(ins, "W")
    if not isinstance(w, SparseTable):
        raise TypeError(f"lookup_sparse_table expects a SparseTable param, "
                        f"got {type(w)}")
    idx = _flat_ids(first(ins, "Ids"))
    return out(Out=w.gather(idx,
                            auto_grow=attrs.get("auto_grown_table", True)))


@register_op("init_sparse_table")
def init_sparse_table_op(ctx, ins, attrs):
    """Startup-program op: create the pserver's SparseTable (the reference
    startup creates a SELECTED_ROWS var and a uniform initializer; here a
    row is initialized on first touch, from its id)."""
    return out(Out=SparseTable(
        value_dim=attrs["value_dim"],
        height=attrs.get("height"),
        dtype=attrs.get("dtype", "float32"),
        init_low=attrs.get("min", -0.05),
        init_high=attrs.get("max", 0.05),
        seed=attrs.get("seed", 0),
    ))


@register_grad_maker("lookup_table")
def lookup_table_grad_maker(op, gout, gin):
    """The JAX package's desc: Ids, W and Out@GRAD in, W@GRAD out; Ids
    never gets a gradient."""
    return [dict(
        type="lookup_table_grad",
        inputs={"Ids": op.input("Ids"), "W": op.input("W"),
                "Out@GRAD": [x or "" for x in gout.get("Out", [])]},
        outputs={"W@GRAD": gin.get("W", [])},
        attrs=dict(op.attrs),
    )]
