"""Structured-prediction losses: CTC, CRF, NCE, hierarchical sigmoid.

Reference parity: operators/{warpctc,ctc_align,linear_chain_crf,
crf_decoding,nce,hierarchical_sigmoid}_op.cc, each as the JAX package's
paddle_tpu/ops/loss_ops.py computes it. Every recurrence (the CTC and CRF
forward algorithms, Viterbi) is a Python loop over the padded time axis in
log space, as ops/rnn_ops.py loops where the JAX package runs one
lax.scan: under a captured step the loop's launches become one CUDA graph.
A ragged input is padded to T = its token capacity (the JAX package's trip
count), so the loop runs one step per token of the batch.

Gradients are derived (registry.make_vjp_kernel: the forward again under
autograd), except nce's, whose negatives must be the forward's: nce_grad
replays the SampleLabels the forward drew. Every gather that may repeat
an index is tensor indexing, whose backward is index_put_ with
accumulate=True (deterministic on the card, see ops/sequence_ops.py); the
CTC emission scores are a one-hot product, as in optax.ctc_loss, not a
gather. Integer outputs are int64 where the JAX package has int32.
"""

import math

import torch

from ..core.registry import (SeqTensor, register_grad_maker, register_op,
                             seq_data, set_stop_gradient_outputs)
from .sequence_ops import padded_to_seq, segment_sum, seq_to_padded
from .util import at_least_f32, first, out


def _as_seq(x):
    """A SeqTensor as it is; a dense tensor as one sequence over its rows
    (the JAX package's degenerate case)."""
    if isinstance(x, SeqTensor):
        return x
    return SeqTensor(x, torch.full((1,), x.shape[0], dtype=torch.int32,
                                   device=x.device))


def _softplus(x):
    """log(1 + exp(x)), as jax.nn.softplus (torch's has a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _steps_mask(lengths, T):
    """[B, T] bool: step t lies inside sequence b."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------
def ctc_loss(logits, logit_pad, labels, label_pad, blank, log_eps=-1e5):
    """optax.ctc_loss, step for step: logits [B, T, K], labels [B, N]
    (int64), the paddings [B, T] and [B, N] (1.0 on a padded position)
    -> the negative log-likelihood of each sequence, [B]. The blank and
    label alphas run in log space; log_eps stands for log(0)."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_pad.sum(1).to(torch.int64)
    repeat = torch.nn.functional.pad(
        (labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype), (0, 1))
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)  # [T, B, 1]
    one_hot = torch.nn.functional.one_hot(labels, K).to(logprobs.dtype)
    lp_emit = torch.einsum("btk,bnk->btn", logprobs, one_hot).transpose(0, 1)
    phi = torch.cat([logits.new_zeros((B, 1)),
                     logits.new_full((B, N), log_eps)], dim=1)
    emit = logits.new_full((B, N), log_eps)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], -1)

    pads = logit_pad.transpose(0, 1).unbind(0)  # T x [B]
    for t in range(T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        next_phi = prev_phi + lp_phi[t]
        next_phi = update_phi(next_phi,
                              emit + lp_phi[t] + log_eps * (1.0 - repeat))
        pad = pads[t].reshape(B, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    at_len = torch.nn.functional.one_hot(labellens, N + 1).to(phi_last.dtype)
    return -(phi_last * at_len).sum(1)


@register_op("warpctc", lod_aware=True)
def warpctc_op(ctx, ins, attrs):
    """CTC loss (reference operators/warpctc_op.cc) of ragged Logits
    [sum_T, C] (before the softmax) against ragged Label [sum_L, 1]:
    Loss [B, 1] and WarpCTCGrad, dLoss/dLogits as a SeqTensor shaped like
    Logits, which the reference makes in the forward. Both packages take
    it by autograd of the loss's own loop (jax.vjp there), not from
    torch's ctc_loss, whose CUDA backward adds with atomics: a captured
    step must give the interpreter's bits."""
    logits, label = _as_seq(first(ins, "Logits")), _as_seq(first(ins, "Label"))
    blank = int(attrs.get("blank", 0))
    norm_by_times = attrs.get("norm_by_times", False)
    B, T, L = logits.batch, int(logits.ntokens), int(label.ntokens)
    lab = seq_to_padded(label, L).reshape(B, L).long()
    t_pad = (~_steps_mask(logits.lengths, T)).to(torch.float32)
    l_pad = (~_steps_mask(label.lengths, L)).to(torch.float32)
    with torch.enable_grad():
        lp = at_least_f32(seq_to_padded(logits, T))  # [B, T, C]
        traced = lp.requires_grad  # inside a derived grad's forward
        src = lp if traced else lp.detach().requires_grad_(True)
        per_seq = ctc_loss(src, t_pad, lab, l_pad, blank)
        if norm_by_times:
            per_seq = per_seq / torch.clamp_min(
                logits.lengths.to(torch.float32), 1.0)
        (dlogits,) = torch.autograd.grad(per_seq, src,
                                         torch.ones_like(per_seq),
                                         retain_graph=traced)
    if not traced:
        per_seq = per_seq.detach()
    grad = padded_to_seq(dlogits.to(logits.data.dtype), logits.lengths, T)
    return out(Loss=per_seq[:, None], WarpCTCGrad=grad)


set_stop_gradient_outputs("warpctc", ["WarpCTCGrad"])


@register_op("ctc_align", lod_aware=True)
def ctc_align_op(ctx, ins, attrs):
    """Merge repeated tokens, then drop blanks, in each sequence
    (reference operators/ctc_align_op.cc). The output keeps the input's
    static token capacity, its kept tokens packed to the front of each
    sequence's new extent and its new lengths made on the device (a
    cumulative sum of the keep mask), so nothing waits for the device."""
    x = _as_seq(first(ins, "Input"))
    blank = int(attrs.get("blank", 0))
    B, n = x.batch, int(x.ntokens)
    data = x.data.reshape(n)
    seg = x.segment_ids().long()
    segc = torch.clamp(seg, 0, B - 1)
    offs = x.offsets().long()
    idx = torch.arange(n, device=data.device)
    is_seq_start = idx == offs[segc]
    prev = torch.cat([data[:1], data[:-1]])
    keep = data != blank
    if attrs.get("merge_repeated", True):
        keep &= is_seq_start | (data != prev)
    keep &= seg < B  # padding rows are never kept
    k = keep.to(torch.int64)
    exc = torch.cumsum(k, 0) - k
    seg_start_exc = exc[torch.clamp(offs[segc], 0, n - 1)]
    pos_new = exc - seg_start_exc
    new_lengths = segment_sum(k, seg, B + 1)[:B].to(torch.int32)
    new_offs = torch.cat([new_lengths.new_zeros(1),
                          torch.cumsum(new_lengths, 0)]).long()
    dest = new_offs[segc] + pos_new
    o = data.new_zeros(n + 1).index_put(
        (torch.where(keep, dest, n),), data)[:n]
    return out(Output=SeqTensor(o[:, None], new_lengths))


# ---------------------------------------------------------------------------
# Linear-chain CRF
# ---------------------------------------------------------------------------
def _crf_unpack(transition):
    """Transition [C+2, C]: row 0 start, row 1 stop, rows 2.. pairwise
    (reference linear_chain_crf_op.h layout)."""
    return transition[0], transition[1], transition[2:]


def _crf_padded(emission, label=None):
    """(SeqTensor, emissions [B, T, C] f32, lengths [B], labels [B, T]
    int64 or None, B, T), T the token capacity."""
    e = _as_seq(emission)
    B, T = e.batch, int(e.ntokens)
    ep = at_least_f32(seq_to_padded(e, T))
    lab = None
    if label is not None:
        lab = seq_to_padded(_as_seq(label), T).reshape(B, T).long()
    return e, ep, e.lengths.long(), lab, B, T


@register_op("linear_chain_crf", lod_aware=True)
def linear_chain_crf_op(ctx, ins, attrs):
    """Negative log-likelihood of a linear-chain CRF (reference
    operators/linear_chain_crf_op.cc): the forward algorithm in log space
    over the padded time axis (a sequence's alpha is held past its end),
    minus the gold path's score. Alpha (the log-space alphas),
    EmissionExps and TransitionExps are the reference's intermediates."""
    e, ep, lens, lab, B, T = _crf_padded(first(ins, "Emission"),
                                         first(ins, "Label"))
    start_w, stop_w, trans = _crf_unpack(
        at_least_f32(first(ins, "Transition")))
    active = _steps_mask(lens, T)
    a = start_w[None, :] + ep[:, 0]  # [B, C]
    alphas = [a]
    for t in range(1, T):
        nxt = torch.logsumexp(a[:, :, None] + trans[None, :, :], dim=1) \
            + ep[:, t]
        a = torch.where(active[:, t:t + 1], nxt, a)
        alphas.append(a)
    log_z = torch.logsumexp(a + stop_w[None, :], dim=1)  # [B]

    tok_mask = active.to(torch.float32)
    em_score = torch.sum(torch.gather(ep, 2, lab[:, :, None])[..., 0]
                         * tok_mask, dim=1)
    pair = trans[lab[:, :-1], lab[:, 1:]]  # [B, T-1]
    tr_score = torch.sum(pair * tok_mask[:, 1:], dim=1)
    last = torch.gather(lab, 1, torch.clamp_min(lens - 1, 0)[:, None])[:, 0]
    score = em_score + tr_score + start_w[lab[:, 0]] + stop_w[last]
    nll = (log_z - score)[:, None]  # [B, 1]

    e_max = torch.amax(ep, dim=-1, keepdim=True)
    em_exps = padded_to_seq(torch.exp(ep - e_max), lens, e.ntokens)
    alpha_seq = padded_to_seq(torch.stack(alphas, 1), lens, e.ntokens)
    return out(LogLikelihood=nll.to(e.data.dtype), Alpha=alpha_seq,
               EmissionExps=em_exps,
               TransitionExps=torch.exp(first(ins, "Transition")))


set_stop_gradient_outputs(
    "linear_chain_crf", ["Alpha", "EmissionExps", "TransitionExps"])


@register_op("crf_decoding", lod_aware=True)
def crf_decoding_op(ctx, ins, attrs):
    """Viterbi decode (reference operators/crf_decoding_op.cc): a
    max-product forward loop keeping the argmax back-pointers, then a
    backward loop that follows them. With Label given, the output is the
    per-token correctness mask (1 where the best path's tag is the
    label's), the reference contract ChunkEvaluator reads."""
    label_in = first(ins, "Label")
    e, ep, lens, lab, B, T = _crf_padded(first(ins, "Emission"), label_in)
    start_w, stop_w, trans = _crf_unpack(
        at_least_f32(first(ins, "Transition")))
    active = _steps_mask(lens, T)
    d = start_w[None, :] + ep[:, 0]
    bps = []
    for t in range(1, T):
        cand = d[:, :, None] + trans[None, :, :]  # [B, C_prev, C]
        best, best_prev = torch.max(cand, dim=1)
        on = active[:, t:t + 1]
        d = torch.where(on, best + ep[:, t], d)
        bps.append(torch.where(on, best_prev, -1))
    tag = torch.argmax(d + stop_w[None, :], dim=1)  # [B]
    path = [None] * T
    path[T - 1] = tag
    for t in range(T - 2, -1, -1):
        prev = torch.gather(bps[t], 1, tag[:, None])[:, 0]
        tag = torch.where(active[:, t + 1], prev, tag)
        path[t] = tag
    path = torch.stack(path, 1)  # [B, T]
    if lab is not None:
        path = (path == lab).to(torch.int64)
    return out(ViterbiPath=padded_to_seq(path[:, :, None], lens, e.ntokens))


set_stop_gradient_outputs("crf_decoding", ["ViterbiPath"])


# ---------------------------------------------------------------------------
# NCE
# ---------------------------------------------------------------------------
def _nce_cost(x, w, b, label, samples, num_total_classes):
    """NCE cost given the sampled negative classes: x [B, D], w [C, D],
    b [C, 1], label [B, Tt], samples [B, K] (both int64). Uniform noise
    q = 1/C (the reference nce_op.h's uniform sampler)."""
    num_true = label.shape[1]
    K = samples.shape[1]
    all_cls = torch.cat([label, samples], dim=1)  # [B, Tt+K]
    logits = torch.einsum("bd,bkd->bk", x, w[all_cls]) + b[all_cls, 0]
    log_kq = math.log(K / num_total_classes)
    adj = at_least_f32(logits) - log_kq
    pos = _softplus(-adj[:, :num_true]).sum(dim=1)
    neg = _softplus(adj[:, num_true:]).sum(dim=1)
    return (pos + neg)[:, None], logits, all_cls


def _nce_inputs(ins):
    x, label = seq_data(first(ins, "Input")), seq_data(first(ins, "Label"))
    return (x, label.reshape(x.shape[0], -1).long(), first(ins, "Weight"),
            first(ins, "Bias"))


@register_op("nce", lod_aware=True)
def nce_op(ctx, ins, attrs):
    """reference operators/nce_op.cc: `num_neg_samples` negatives a row,
    uniform over the classes, drawn from the program's random stream
    (new at every step; the JAX package draws other numbers), or the
    `custom_neg_classes` attr's fixed list for every row. SampleLabels
    (the true classes, then the negatives) is an output, so that nce_grad
    uses the forward's negatives."""
    x, label, w, b = _nce_inputs(ins)
    C = int(attrs["num_total_classes"])
    K = int(attrs.get("num_neg_samples", 10))
    custom = attrs.get("custom_neg_classes")
    if custom:  # copied to the device once and held (a capture cannot)
        fixed = ctx.rng.held(("nce", tuple(custom)), lambda: torch.tensor(
            custom, dtype=torch.int64).to(ctx.device))
        samples = fixed[None, :].expand(x.shape[0], len(custom))
    else:
        samples = torch.randint(0, C, (x.shape[0], K),
                                generator=ctx.rng.generator,
                                device=ctx.device)
    cost, logits, all_cls = _nce_cost(x, w, b, label, samples, C)
    return out(Cost=cost.to(x.dtype), SampleLogits=logits,
               SampleLabels=all_cls)


set_stop_gradient_outputs("nce", ["SampleLogits", "SampleLabels"])


@register_op("nce_grad", lod_aware=True)
def nce_grad_op(ctx, ins, attrs):
    """The grads of Input, Weight and Bias through the cost at the
    forward's SampleLabels."""
    x, label, w, b = _nce_inputs(ins)
    samples = first(ins, "SampleLabels")[:, label.shape[1]:].long()
    g = seq_data(first(ins, "Cost@GRAD"))
    C = int(attrs["num_total_classes"])
    with torch.enable_grad():
        leaves = [v.detach().requires_grad_(True) for v in (x, w, b)]
        cost = _nce_cost(*leaves[:2], leaves[2], label, samples, C)[0]
        dx, dw, db = torch.autograd.grad(
            cost, leaves, g.reshape(x.shape[0], 1).to(cost.dtype))
    return {"Input@GRAD": [dx], "Weight@GRAD": [dw], "Bias@GRAD": [db]}


@register_grad_maker("nce")
def nce_grad_maker(op, gout, gin):
    return [dict(
        type="nce_grad",
        inputs={
            "Input": op.input("Input"),
            "Label": op.input("Label"),
            "Weight": op.input("Weight"),
            "Bias": op.input("Bias"),
            "SampleLabels": op.output("SampleLabels"),
            "Cost@GRAD": gout["Cost"],
        },
        outputs={
            "Input@GRAD": gin["Input"],
            "Weight@GRAD": gin["Weight"],
            "Bias@GRAD": gin["Bias"],
        },
        attrs=dict(op.attrs),
    )]


# ---------------------------------------------------------------------------
# Hierarchical sigmoid
# ---------------------------------------------------------------------------
@register_op("hierarchical_sigmoid", lod_aware=True)
def hierarchical_sigmoid_op(ctx, ins, attrs):
    """reference operators/hierarchical_sigmoid_op.cc: the implicit
    complete binary tree over num_classes leaves (the reference
    MatrixBitCode; leaf c is heap node c + num_classes, the root is node
    1 and W row 0). Every ancestor of the label's leaf is a decision;
    the path walk is one static depth, vectorized over the batch."""
    x, label = seq_data(first(ins, "X")), seq_data(first(ins, "Label"))
    w, b = first(ins, "W"), first(ins, "Bias")
    nc = int(attrs["num_classes"])
    B = x.shape[0]
    code = label.reshape(B).long() + nc
    depth = int(math.ceil(math.log2(nc))) + 1
    ds = torch.arange(1, depth + 1, device=x.device)
    nodes = code[:, None] >> ds[None, :]  # [B, depth] ancestors
    bits = (code[:, None] >> (ds[None, :] - 1)) & 1  # child direction
    valid = nodes >= 1
    w_idx = torch.clamp(nodes - 1, 0, nc - 2)
    zv = torch.einsum("bd,bkd->bk", at_least_f32(x), at_least_f32(w[w_idx]))
    if b is not None:
        zv = zv + at_least_f32(b[w_idx, 0])
    sgn = 1.0 - 2.0 * bits.to(torch.float32)
    terms = _softplus(-sgn * zv) * valid.to(torch.float32)
    return out(Out=terms.sum(dim=1)[:, None].to(x.dtype),
               PreOut=zv.to(x.dtype))


set_stop_gradient_outputs("hierarchical_sigmoid", ["PreOut"])
