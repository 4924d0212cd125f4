"""Beam search: the per-step selection and the final backtrack decode
(reference operators/beam_search_op.cc and beam_search_decode_op.cc; the
JAX package's paddle_tpu/ops/beam_search_ops.py).

The reference tracks beams with a 2-level LoD (source, beam) and variable
beam widths; the JAX package, and the port with it, keep every source at
exactly `beam_size` slots ([B*K] rows, source-major). A finished beam
(pre_id == end_id) carries one candidate, (end_id, pre_score), and an
inactive slot (pre_id < 0, which seeds step 0 with one live beam) none.
Parent pointers are an explicit output, which beam_search_decode
backtracks over the step arrays.

Ties: finished and inactive slots fill the candidate rows with NEG_INF in
bulk, and the JAX package's `lax.top_k` puts the lower index first among
equal scores. `torch.topk` promises no order among ties, so the selection
is a stable descending sort of each source's K*C candidates, whose first
K keep `lax.top_k`'s order.
"""

import torch

from ..core.registry import SeqTensor, register_op, set_stop_gradient_outputs
from .util import first, out

NEG_INF = -1e9


def _flat(v):
    return v.data if isinstance(v, SeqTensor) else v


@register_op("beam_search", lod_aware=True)
def beam_search_op(ctx, ins, attrs):
    """One step: the top beam_size of each source's K*C candidates.

    pre_ids [B*K, 1]; ids [B*K, C] (optional: the column index, the
    whole-vocabulary case); scores [B*K, C] (accumulated candidate
    scores); optional pre_scores [B*K, 1]. Outputs selected_ids,
    selected_scores and parent_idx, each [B*K, 1]; parent_idx is the flat
    row of each selection's source beam."""
    pre_ids = _flat(first(ins, "pre_ids"))
    scores = _flat(first(ins, "scores")).to(torch.float32)
    ids = _flat(first(ins, "ids"))
    if ids is None:
        ids = torch.arange(scores.shape[1], dtype=torch.int32,
                           device=scores.device).expand(scores.shape)
    pre_scores = _flat(first(ins, "pre_scores"))
    K = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    BK, C = scores.shape
    if BK % K:
        raise ValueError(f"beam_search: rows {BK} not a multiple of "
                         f"beam_size {K}")
    B = BK // K
    pre_id = pre_ids.reshape(BK).to(torch.int32)
    finished = (pre_id == end_id)[:, None]
    inactive = (pre_id < 0)[:, None]
    pre_sc = scores[:, 0] if pre_scores is None \
        else pre_scores.reshape(BK).to(torch.float32)

    # a finished beam: only candidate 0 = (end_id, unchanged score)
    col = torch.arange(C, device=scores.device)[None, :]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=scores.device)
    cand_scores = torch.where(
        finished, torch.where(col == 0, pre_sc[:, None], neg), scores)
    cand_scores = torch.where(inactive, neg, cand_scores)
    cand_ids = torch.where(finished, torch.full_like(ids, end_id),
                           ids).to(torch.int32)

    flat_scores = cand_scores.reshape(B, K * C)
    sorted_sc, order = torch.sort(flat_scores, dim=1, descending=True,
                                  stable=True)
    top_sc, top_ix = sorted_sc[:, :K], order[:, :K]          # [B, K]
    parent = top_ix // C + torch.arange(B, device=scores.device)[:, None] * K
    sel_ids = torch.gather(cand_ids.reshape(B, K * C), 1, top_ix)
    return out(selected_ids=sel_ids.reshape(BK, 1),
               selected_scores=top_sc.reshape(BK, 1),
               parent_idx=parent.reshape(BK, 1))


set_stop_gradient_outputs(
    "beam_search", ["selected_ids", "selected_scores", "parent_idx"])


@register_op("beam_search_decode", lod_aware=True)
def beam_search_decode_op(ctx, ins, attrs):
    """Backtrack the parent pointers over the per-step arrays into
    sentences.

    Ids/Scores/Parents: TensorArrays, or stacked [T, B*K, 1] tensors,
    written once per decode step. SentenceIds/SentenceScores: SeqTensors
    of B*K sentences (source-major, beam-minor: the reference's 2-level
    LoD flattened), each cut after its first end_id. The backtrack is a
    loop over T on the device."""
    from .control_flow_ops import TensorArray
    from .sequence_ops import padded_to_seq

    def stacked(v):
        if isinstance(v, TensorArray):
            return torch.stack([_flat(x).reshape(-1) for x in v.items])
        v = _flat(v)
        return v.reshape(v.shape[0], -1)

    ids = stacked(first(ins, "Ids")).to(torch.int32)          # [T, BK]
    scores = stacked(first(ins, "Scores")).to(torch.float32)
    T, BK = ids.shape
    parents_in = first(ins, "Parents")
    parents = None if parents_in is None \
        else stacked(parents_in).to(torch.int64)
    end_id = int(attrs.get("end_id", -1))

    # walk each final slot back through the parent chain
    idx = torch.arange(BK, device=ids.device)
    toks, scs = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = ids[t][idx]
        scs[t] = scores[t][idx]
        if parents is not None:
            idx = parents[t][idx]
    toks = torch.stack(toks, 1)                               # [BK, T]
    scs = torch.stack(scs, 1)

    if end_id >= 0:
        is_end = toks == end_id
        first_end = torch.argmax(is_end.to(torch.int32), dim=1)
        lengths = torch.where(is_end.any(dim=1), first_end + 1,
                              T).to(torch.int32)
    else:
        lengths = torch.full((BK,), T, dtype=torch.int32, device=ids.device)
    return out(SentenceIds=padded_to_seq(toks[:, :, None], lengths, BK * T),
               SentenceScores=padded_to_seq(scs[:, :, None], lengths,
                                            BK * T))


set_stop_gradient_outputs(
    "beam_search_decode", ["SentenceIds", "SentenceScores"])
