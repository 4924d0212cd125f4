"""Metric ops (reference operators/{accuracy,auc,precision_recall,
edit_distance,chunk_eval}_op.cc; the JAX package's
paddle_tpu/ops/metric_ops.py, whose expressions each kernel repeats).
Histograms and per-class counts are segment sums (index_put_ with
accumulate=True, deterministic on the card). auc's StatPosOut/StatNegOut
name its StatPos/StatNeg persistables: the step writes them back into the
scope's tensors, as batch norm's running statistics. chunk_eval reads its
inputs on the host (executor_core.HOST_SYNC_OPS): a program holding it runs
through the interpreter, as an evaluation program does."""

import numpy as np
import torch

from ..core.registry import SeqTensor, register_op, set_stop_gradient_outputs
from .collective_ops import psum
from .sequence_ops import segment_sum, seq_to_padded
from .util import first, out


@register_op("accuracy")
def accuracy_op(ctx, ins, attrs):
    """Share of rows whose top-k Indices hold their Label. The outputs are
    shaped [1], as accuracy_op.cc and the shape contract declare them (the
    JAX package returns 0-d values). Total is made on the device from the
    static batch size: a tensor built from a host value would be a
    host-to-device copy, which a CUDA graph capture refuses. Under
    ParallelExecutor (ctx.dp) Correct and Total are the global batch's,
    summed over the ranks."""
    indices = first(ins, "Indices")
    label = first(ins, "Label")
    label = label.reshape(label.shape[0], 1)
    correct = torch.any(indices == label, dim=1)
    num_correct = torch.sum(correct.to(torch.int32),
                            dtype=torch.int32).reshape(1)
    total = torch.full((1,), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    if ctx.dp is not None:  # the global batch's counts
        counts = psum(torch.cat([num_correct, total]), ctx.dp)
        num_correct, total = counts[:1], counts[1:]
    acc = num_correct.to(torch.float32) / total.to(torch.float32)
    return out(Accuracy=acc, Correct=num_correct, Total=total)


set_stop_gradient_outputs("accuracy", ["Accuracy", "Correct", "Total"])


@register_op("auc")
def auc_op(ctx, ins, attrs):
    """Streaming ROC AUC over `num_thresholds` + 1 histogram buckets of
    the positive class's probability (Predict [B, 2] column 1, or Predict
    itself): this batch's histograms added to StatPos/StatNeg, then the
    trapezoid under (fpr, tpr) swept from the highest bucket down."""
    predict = first(ins, "Predict")
    label = first(ins, "Label").reshape(-1)
    stat_pos, stat_neg = first(ins, "StatPos"), first(ins, "StatNeg")
    nt = attrs.get("num_thresholds", 200)
    pos_prob = predict[:, 1] if predict.ndim == 2 and predict.shape[1] == 2 \
        else predict.reshape(-1)
    bucket = torch.clamp((pos_prob * nt).to(torch.int32), 0, nt)
    is_pos = (label > 0).to(torch.float32)
    new_pos = stat_pos + segment_sum(is_pos, bucket, nt + 1)
    new_neg = stat_neg + segment_sum(1.0 - is_pos, bucket, nt + 1)
    tp = torch.cumsum(new_pos.flip(0), 0)
    fp = torch.cumsum(new_neg.flip(0), 0)
    tpr = tp / torch.clamp_min(tp[-1], 1.0)
    fpr = fp / torch.clamp_min(fp[-1], 1.0)
    auc = torch.trapezoid(tpr, fpr)
    return out(AUC=auc, StatPosOut=new_pos, StatNegOut=new_neg)


set_stop_gradient_outputs("auc", ["AUC", "StatPosOut", "StatNegOut"])


@register_op("precision_recall")
def precision_recall_op(ctx, ins, attrs):
    """Per-class TP/FP/TN/FN of the top-1 Indices against Labels
    (weighted by Weights), added to StatesInfo: BatchMetrics and
    AccumMetrics are the macro-averaged [precision, recall, F1] of the
    batch's and the accumulated states."""
    indices = first(ins, "Indices").reshape(-1).long()
    labels = first(ins, "Labels").reshape(-1).long()
    weights, states = first(ins, "Weights"), first(ins, "StatesInfo")
    cls_num = attrs["class_number"]
    w = weights.reshape(-1) if weights is not None \
        else torch.ones(labels.shape, dtype=torch.float32,
                        device=labels.device)
    wrong = w * (indices != labels).to(torch.float32)
    tp = segment_sum((indices == labels).to(torch.float32) * w, labels,
                     cls_num)
    fp = segment_sum(wrong, indices, cls_num)
    fn = segment_sum(wrong, labels, cls_num)
    tn_total = torch.sum(w) - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn_total, fn], dim=1)
    acc_states = batch_states if states is None else states + batch_states

    def metrics(st):
        tp_, fp_, fn_ = st[:, 0], st[:, 1], st[:, 3]
        prec = torch.where(tp_ + fp_ > 0,
                           tp_ / torch.clamp_min(tp_ + fp_, 1e-12), 0.0)
        rec = torch.where(tp_ + fn_ > 0,
                          tp_ / torch.clamp_min(tp_ + fn_, 1e-12), 0.0)
        f1 = torch.where(prec + rec > 0, 2 * prec * rec
                         / torch.clamp_min(prec + rec, 1e-12), 0.0)
        return torch.stack([prec.mean(), rec.mean(), f1.mean()])

    return out(BatchMetrics=metrics(batch_states),
               AccumMetrics=metrics(acc_states), AccumStatesInfo=acc_states)


def _edit_padded(x):
    """([B, T] tokens, lengths [B]) of a SeqTensor (padded to its token
    capacity) or of dense [B, T] rows."""
    if isinstance(x, SeqTensor):
        T = int(x.ntokens)
        return seq_to_padded(x, T).reshape(x.batch, T, -1)[:, :, 0], \
            x.lengths
    x = x.reshape(x.shape[0], -1)
    return x, torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)


@register_op("edit_distance", lod_aware=True)
def edit_distance_op(ctx, ins, attrs):
    """Levenshtein distance of each Hyps sequence to its Refs sequence
    (divided by the reference's length when `normalized`). The
    dynamic-programming table is built one hyp token a step over the
    padded hyp axis, each row for the whole batch at once: a row's
    left-to-right recurrence row[j+1] = min(row[j] + 1, c[j]) is the
    running minimum of c[k] + (j - k), one cummin. Exact in f32: every
    entry is a small integer. Under ParallelExecutor (ctx.dp)
    SequenceNum is the global batch's, summed over the ranks."""
    h, hlen = _edit_padded(first(ins, "Hyps"))
    r, rlen = _edit_padded(first(ins, "Refs"))
    B, Th = h.shape
    Tr = r.shape[1]
    ar = torch.arange(Tr + 1, dtype=torch.float32, device=h.device)
    dp = ar.expand(B, Tr + 1)
    for i in range(Th):
        sub = dp[:, :-1] + (h[:, i:i + 1] != r).to(torch.float32)
        c = torch.minimum(dp[:, 1:] + 1.0, sub)
        c = torch.cat([torch.full((B, 1), i + 1.0, device=h.device), c], 1)
        row = torch.cummin(c - ar, dim=1).values + ar
        dp = torch.where((i < hlen)[:, None], row, dp)
    dist = torch.gather(dp, 1, rlen.long()[:, None])
    if attrs.get("normalized", True):
        dist = dist / torch.clamp_min(rlen.to(torch.float32), 1.0)[:, None]
    num = torch.full((), B, dtype=torch.int64, device=h.device)
    if ctx.dp is not None:
        num = psum(num.reshape(1), ctx.dp).reshape(())
    return out(Out=dist.reshape(B, 1), SequenceNum=num)


set_stop_gradient_outputs("edit_distance", ["Out", "SequenceNum"])


def _iob_chunks(tags, lengths, num_chunk_types, scheme, excluded):
    """{(first token, last token, chunk type)} of the IOB-tagged flat
    `tags` (numpy) cut into sequences of `lengths`: tag 2t begins a chunk
    of type t, 2t + 1 continues one; any other tag ends it."""
    tags = np.asarray(tags).reshape(-1)
    chunks, pos = [], 0
    for length in np.asarray(lengths):
        start = ctype = None
        for i, t in enumerate(tags[pos:pos + length]):
            t = int(t)
            if scheme == "IOB" and t < 2 * num_chunk_types:
                tag_type, is_begin, is_inside = t // 2, t % 2 == 0, t % 2 == 1
            else:
                tag_type, is_begin, is_inside = -1, False, False
            if is_begin:
                if start is not None:
                    chunks.append((pos + start, pos + i - 1, ctype))
                start, ctype = i, tag_type
            elif not (is_inside and start is not None and tag_type == ctype):
                if start is not None:
                    chunks.append((pos + start, pos + i - 1, ctype))
                start = ctype = None
        if start is not None:
            chunks.append((pos + start, pos + length - 1, ctype))
        pos += length
    return {c for c in chunks if c[2] not in excluded}


@register_op("chunk_eval", lod_aware=True)
def chunk_eval_op(ctx, ins, attrs):
    """reference chunk_eval_op.cc: chunk precision, recall and F1 of the
    Inference tags against the Label tags (IOB). It runs on the host, as
    in the JAX package: evaluation only, never inside a captured step
    (executor_core.HOST_SYNC_OPS). Under ParallelExecutor (ctx.dp) the
    three chunk counts are the global batch's, summed over the ranks (a
    chunk never spans two sequences), and the ratios are taken of them."""
    inference, label = first(ins, "Inference"), first(ins, "Label")
    if isinstance(inference, SeqTensor):
        inf = inference.data.cpu().numpy()
        lens = inference.lengths.cpu().numpy()
    else:
        inf = inference.cpu().numpy()
        lens = [inf.shape[0]]
    lab = (label.data if isinstance(label, SeqTensor) else label).cpu().numpy()
    args = (lens, attrs["num_chunk_types"], attrs.get("chunk_scheme", "IOB"),
            set(attrs.get("excluded_chunk_types", [])))
    inf_chunks, lab_chunks = _iob_chunks(inf, *args), _iob_chunks(lab, *args)
    n_inf, n_lab = len(inf_chunks), len(lab_chunks)
    correct = len(inf_chunks & lab_chunks)
    if ctx.dp is not None:
        counts = psum(torch.tensor([n_inf, n_lab, correct],
                                   dtype=torch.int64, device=ctx.device),
                      ctx.dp)
        n_inf, n_lab, correct = (int(c) for c in counts.cpu())
    p = correct / max(n_inf, 1)
    r = correct / max(n_lab, 1)
    f1 = 2 * p * r / max(p + r, 1e-12)

    def value(v, dtype):
        return torch.tensor(v, dtype=dtype).to(ctx.device)

    return out(Precision=value(p, torch.float32),
               Recall=value(r, torch.float32),
               F1_Score=value(f1, torch.float32),
               NumInferChunks=value(n_inf, torch.int64),
               NumLabelChunks=value(n_lab, torch.int64),
               NumCorrectChunks=value(correct, torch.int64))
