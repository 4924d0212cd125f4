"""Sequence ops over ragged SeqTensors (the LoD machinery).

Reference parity: operators/sequence_{pool,softmax,expand,concat,conv,
reshape,slice,erase,pad,unpad}_op.cc, operators/math/sequence2batch.h; the
JAX package's paddle_tpu/ops/sequence_ops.py, whose expressions each
kernel here repeats. The reference walks LoD offsets with dynamic loops;
here every op is a static-shape segment computation over the token axis,
so a step with sequence ops runs without a host sync and can be captured.

Segment sums go through index_put_ with accumulate=True, and gathers
through tensor indexing, whose derived backward is the same index_put_:
on a CUDA device it sorts the indices and adds each row's contributions in
their order, so a step gives the same bits at every run, where
index_add_ and scatter_add_ add with atomics.
"""

import torch

from ..core.registry import SeqTensor, register_op
from .util import first, many, out


def _as_seq(x):
    if isinstance(x, SeqTensor):
        return x
    # a dense [B, ...] tensor: each row is a length-1 sequence
    return SeqTensor(x, torch.ones((x.shape[0],), dtype=torch.int32,
                                   device=x.device))


def _rows(mask, ndim):
    """A [N] mask shaped to broadcast over [N, ...] rows."""
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def _lowest(dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def segment_sum(data, seg, num):
    """[num, ...] sums of the rows of `data` by segment id."""
    o = torch.zeros((num,) + tuple(data.shape[1:]), dtype=data.dtype,
                    device=data.device)
    return o.index_put((seg.long(),), data, accumulate=True)


def segment_max(data, seg, num):
    """[num, ...] maxima of the rows of `data` by segment id; an empty
    segment holds -inf (an int dtype's lowest value), as
    jax.ops.segment_max."""
    idx = _rows(seg.long(), data.ndim).expand(data.shape)
    empty = (-torch.inf if data.dtype.is_floating_point
             else torch.iinfo(data.dtype).min)
    init = torch.full((num,) + tuple(data.shape[1:]), empty,
                      dtype=data.dtype, device=data.device)
    return init.scatter_reduce(0, idx, data, "amax", include_self=False)


@register_op("sequence_pool", lod_aware=True)
def sequence_pool_op(ctx, ins, attrs):
    x = _as_seq(first(ins, "X"))
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    seg = x.segment_ids()
    B = x.batch
    num = B + 1  # an extra segment for the padding rows, dropped below
    data = x.data
    if ptype in ("AVERAGE", "SUM", "SQRT"):
        s = segment_sum(data, seg, num)[:B]
        n = torch.clamp_min(x.lengths, 1).to(s.dtype)[:, None]
        o = s / n if ptype == "AVERAGE" else (
            s / torch.sqrt(n) if ptype == "SQRT" else s)
    elif ptype == "MAX":
        masked = torch.where(x.token_mask()[:, None], data,
                             _lowest(data.dtype))
        o = segment_max(masked, seg, num)[:B]
    elif ptype in ("FIRST", "LAST"):
        offsets = x.offsets()
        idx = (offsets[:-1] if ptype == "FIRST"
               else torch.clamp_min(offsets[1:] - 1, 0))
        o = data[torch.clamp(idx, 0, data.shape[0] - 1).long()]
        o = torch.where((x.lengths > 0)[:, None], o, 0)
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return out(Out=o)


@register_op("sequence_softmax", lod_aware=True)
def sequence_softmax_op(ctx, ins, attrs):
    x = _as_seq(first(ins, "X"))
    data = x.data.reshape(x.ntokens)  # [N] (reference: X is [N, 1])
    seg = x.segment_ids()
    B = x.batch
    mask = x.token_mask()
    neg = torch.finfo(data.dtype).min
    masked = torch.where(mask, data, neg)
    mx = segment_max(masked, seg, B + 1)
    segl = seg.long()
    shifted = torch.where(mask, data - mx[segl], neg)
    e = torch.where(mask, torch.exp(shifted), 0.0)
    denom = segment_sum(e, seg, B + 1)
    o = e / torch.clamp_min(denom[segl], 1e-20)
    return out(Out=SeqTensor(o.reshape(x.data.shape), x.lengths))


@register_op("sequence_expand", lod_aware=True)
def sequence_expand_op(ctx, ins, attrs):
    """reference sequence_expand_op.cc: row i of x repeated for each token
    of y's sequence i (the x-lengths == 1 case)."""
    x, y = first(ins, "X"), _as_seq(first(ins, "Y"))
    x_data = x.data if isinstance(x, SeqTensor) else x
    seg_y = y.segment_ids()
    o = x_data[torch.clamp(seg_y, 0, x_data.shape[0] - 1).long()]
    o = torch.where(_rows(y.token_mask(), o.ndim), o, 0)
    return out(Out=SeqTensor(o, y.lengths))


def _merge_two(a, b):
    """Sequence i of the result is a's sequence i followed by b's."""
    data = torch.cat([a.data, b.data], dim=0)
    total, n0, B = data.shape[0], a.data.shape[0], a.batch
    new_lengths = a.lengths + b.lengths
    cum = torch.cumsum(new_lengths, 0, dtype=torch.int32)
    new_off = torch.cat([cum.new_zeros(1), cum])
    pos = torch.arange(total, dtype=torch.int32, device=data.device)
    seq_id = torch.clamp(torch.searchsorted(cum, pos, right=True,
                                            out_int32=True), 0, B - 1).long()
    local = pos - new_off[seq_id]
    len0 = a.lengths[seq_id]
    in_first = local < len0
    idx0 = a.offsets()[seq_id] + local
    idx1 = n0 + b.offsets()[seq_id] + (local - len0)
    gather = torch.where(in_first, idx0, torch.clamp(idx1, 0, total - 1))
    o = data[torch.clamp(gather, 0, total - 1).long()]
    return SeqTensor(o, new_lengths)


@register_op("sequence_concat", lod_aware=True)
def sequence_concat_op(ctx, ins, attrs):
    """axis=1: the features of equal-lod sequences side by side; axis=0:
    the sequences of each input appended in turn (a left fold of the
    pairwise merge)."""
    xs = [_as_seq(v) for v in many(ins, "X")]
    if attrs.get("axis", 1) == 1:
        return out(Out=SeqTensor(torch.cat([s.data for s in xs], dim=-1),
                                 xs[0].lengths))
    acc = xs[0]
    for nxt in xs[1:]:
        acc = _merge_two(acc, nxt)
    return out(Out=acc)


@register_op("sequence_conv", lod_aware=True)
def sequence_conv_op(ctx, ins, attrs):
    """reference sequence_conv_op.cc: the context window's rows, zero past
    either end of the token's own sequence, side by side, then one
    [N, ctx*D] x [ctx*D, M] product (math/context_project.h's im2col)."""
    x = _as_seq(first(ins, "X"))
    w = first(ins, "Filter")  # [ctx*D, M]
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -1)
    data, seg = x.data, x.segment_ids()
    n = data.shape[0]
    pos = torch.arange(n, device=data.device)
    cols = []
    for j in range(ctx_len):
        idx = pos + (ctx_start + j)
        valid = (idx >= 0) & (idx < n)
        idx_c = torch.clamp(idx, 0, n - 1)
        m = (valid & (seg[idx_c] == seg))[:, None]
        cols.append(torch.where(m, data[idx_c], 0.0))
    col = torch.cat(cols, dim=1)
    o = torch.matmul(col, w.to(col.dtype))
    return out(Out=SeqTensor(o.to(data.dtype), x.lengths))


@register_op("sequence_reshape", lod_aware=True)
def sequence_reshape_op(ctx, ins, attrs):
    x = _as_seq(first(ins, "X"))
    new_dim = attrs["new_dim"]
    d = x.data.shape[1]
    new_lengths = (x.lengths.to(torch.int64) * d // new_dim).to(torch.int32)
    return out(Out=SeqTensor(x.data.reshape(-1, new_dim), new_lengths))


@register_op("sequence_slice", lod_aware=True)
def sequence_slice_op(ctx, ins, attrs):
    """Sequence i keeps Length[i] tokens from its Offset[i]-th on."""
    x = _as_seq(first(ins, "X"))
    offset = first(ins, "Offset").reshape(-1).to(torch.int32)
    length = first(ins, "Length").reshape(-1).to(torch.int32)
    offs = x.offsets()
    n, B = x.ntokens, x.batch
    cum = torch.cumsum(length, 0, dtype=torch.int32)
    new_off = torch.cat([cum.new_zeros(1), cum])
    pos = torch.arange(n, dtype=torch.int32, device=x.data.device)
    seq_id = torch.clamp(torch.searchsorted(cum, pos, right=True,
                                            out_int32=True), 0, B - 1).long()
    local = pos - new_off[seq_id]
    src = offs[seq_id] + offset[seq_id] + local
    valid = pos < new_off[-1]
    o = x.data[torch.clamp(src, 0, n - 1).long()]
    o = torch.where(_rows(valid, o.ndim), o, 0)
    return out(Out=SeqTensor(o, length))


@register_op("sequence_erase", lod_aware=True)
def sequence_erase_op(ctx, ins, attrs):
    """Remove the tokens of attr `tokens`, compacting each sequence: the
    token capacity stays, the removed slots become padding at the tail and
    the lengths shrink."""
    x = _as_seq(first(ins, "X"))
    data = x.data
    flat = data.reshape(data.shape[0], -1)[:, 0].to(torch.int32)
    tokens = torch.tensor(attrs.get("tokens", []), dtype=torch.int32,
                          device=data.device)
    keep = x.token_mask()
    if tokens.numel():
        keep = keep & ~torch.isin(flat, tokens)
    seg = x.segment_ids()
    n, B = data.shape[0], x.batch
    keep_i = keep.to(torch.int32)
    new_lengths = segment_sum(keep_i, seg, B + 1)[:B]
    # sequences are contiguous, so a kept token's destination is the count
    # of kept tokens before it; a removed one goes to a scratch row
    dest = torch.cumsum(keep_i, 0, dtype=torch.int32) - keep_i
    o = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    o = o.index_put((torch.where(keep, dest, n).long(),), data)[:n]
    return out(Out=SeqTensor(o, new_lengths))


@register_op("sequence_pad", lod_aware=True)
def sequence_pad_op(ctx, ins, attrs):
    """SeqTensor -> dense [B, T, D] padded batch and its lengths (the
    bridge between the ragged layout and per-time-step loops, cf.
    math/sequence2batch.h)."""
    x = _as_seq(first(ins, "X"))
    T = attrs.get("padded_length", -1)
    if T is None or T < 0:
        T = int(x.ntokens)
    return out(Out=seq_to_padded(x, T), Length=x.lengths)


def seq_to_padded(x, T):
    """[N, D] ragged -> [B, T, D] padded (zero fill). Tokens past T in their
    sequence, and the padding rows, are written to one scratch row past
    the end, which is sliced off: they reach no sequence."""
    data, seg = x.data, x.segment_ids()
    B = x.batch
    segc = torch.clamp(seg, 0, B - 1).long()
    pos_in_seq = torch.arange(x.ntokens, dtype=torch.int32,
                              device=data.device) - x.offsets()[segc]
    flat_dest = segc * T + torch.clamp(pos_in_seq, 0, T - 1)
    ok = (seg < B) & (pos_in_seq < T)
    padded = data.new_zeros((B * T + 1,) + tuple(data.shape[1:]))
    padded = padded.index_put((torch.where(ok, flat_dest, B * T),), data)
    return padded[:B * T].reshape((B, T) + tuple(data.shape[1:]))


def padded_to_seq(padded, lengths, ntokens):
    """[B, T, D] -> [N, D] ragged with the given static token capacity;
    rows past sum(lengths) are zero."""
    B, T = padded.shape[:2]
    lengths = lengths.to(torch.int32)
    cum = torch.cumsum(lengths, 0, dtype=torch.int32)
    offs = torch.cat([cum.new_zeros(1), cum])
    pos = torch.arange(ntokens, dtype=torch.int32, device=padded.device)
    seq_id = torch.clamp(torch.searchsorted(cum, pos, right=True,
                                            out_int32=True), 0, B - 1).long()
    local = pos - offs[seq_id]
    ok = pos < offs[-1]
    src = seq_id * T + torch.clamp(local, 0, T - 1)
    flat = padded.reshape((B * T,) + tuple(padded.shape[2:]))
    o = flat[src]
    return SeqTensor(torch.where(_rows(ok, o.ndim), o, 0), lengths)


@register_op("sequence_unpad", lod_aware=True)
def sequence_unpad_op(ctx, ins, attrs):
    padded = first(ins, "X")
    lengths = first(ins, "Length")
    if isinstance(lengths, SeqTensor):
        lengths = lengths.lengths
    ntokens = attrs.get("ntokens", int(padded.shape[0] * padded.shape[1]))
    return out(Out=padded_to_seq(padded, lengths, ntokens))
