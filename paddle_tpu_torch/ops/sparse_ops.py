"""The embedding gradient.

Reference parity: operators/lookup_table_op.cc LookupTableGradKernel, the
dense branch. The JAX package's sparse_ops.py also carries the
`is_sparse` branch (a SelectedRows gradient) and the distributed-table
ops (split_ids, merge_ids, prefetch, lookup_sparse_table); they come with
the port's distributed stack (ROADMAP queue 1 item 10).
"""

import torch

from ..core.registry import SeqTensor, register_grad_maker, register_op
from .util import first, out


def _flat_ids(ids):
    """Ids (maybe a SeqTensor, maybe [N, 1]) -> flat ids [N]."""
    idx = ids.data if isinstance(ids, SeqTensor) else ids
    if idx.ndim >= 2 and idx.shape[-1] == 1:
        idx = idx.reshape(idx.shape[:-1])
    return idx


@register_op("lookup_table_grad", lod_aware=True)
def lookup_table_grad_op(ctx, ins, attrs):
    """W@GRAD [height, dim]: the rows of Out@GRAD summed into the rows of
    their ids; rows of `padding_idx` add nothing. The sum goes through
    index_put_ with accumulate=True, which sorts the ids and adds each
    id's rows in their order on a CUDA device (and in order on the CPU):
    the same bits at every run, where index_add_ would add with atomics
    in whatever order the threads reach them."""
    if attrs.get("is_sparse", False) or first(ins, "W") is None:
        raise NotImplementedError(
            "lookup_table_grad with is_sparse (a SelectedRows gradient) or "
            "a distributed table waits for the port's distributed stack "
            "(ROADMAP queue 1 item 10); the port computes the dense "
            "gradient")
    w = first(ins, "W")
    idx = _flat_ids(first(ins, "Ids"))
    g = first(ins, "Out@GRAD")
    gd = g.data if isinstance(g, SeqTensor) else g
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None and padding_idx >= 0:
        gd = torch.where((idx == padding_idx)[..., None], 0.0, gd)
    rows = gd.reshape((-1,) + tuple(gd.shape[idx.ndim:]))
    dense = torch.zeros(w.shape, dtype=gd.dtype, device=gd.device)
    dense.index_put_((idx.reshape(-1).long(),), rows, accumulate=True)
    return out(**{"W@GRAD": dense.to(w.dtype)})


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
