"""Detection ops: SSD's prior boxes, box coding, matching, target
assignment, hard-negative mining, multiclass NMS, VOC mAP, and roi_pool.

Reference parity: operators/detection/{prior_box,bipartite_match,
target_assign,mine_hard_examples,multiclass_nms,box_coder,iou_similarity}
_op.cc, operators/detection_map_op.{cc,h} and operators/roi_pool_op.cc,
each as the JAX package's paddle_tpu/ops/detection_ops.py computes it.

prior_box, box_coder, iou_similarity and roi_pool are torch on the op's
device. The matching, mining, NMS and mAP family is data-dependent
(greedy loops, counts known only after the loop) and runs on the host, as
in the reference (CPU-only kernels) and the JAX package (no_trace ops):
each reads its inputs into numpy, runs the JAX package's numpy code, and
puts its outputs on the op's device. multiclass_nms selects on the op's
device first (every image's and class's IoUs and greedy walk at once,
_nms_keep) and makes its rows on the host. They are
executor_core.HOST_SYNC_OPS, so a program holding one runs through the
interpreter. `host_stats` holds each host op's calls, its host seconds
(the copies both ways and the numpy work) and its seconds spent waiting
for the card's earlier work; reset_host_stats() zeroes them.
"""

import collections
import time

import numpy as np
import torch

from ..core.registry import SeqTensor, register_op, set_stop_gradient_outputs
from .util import first, out

# op type -> [calls, host seconds, seconds waiting for the card]
host_stats = collections.defaultdict(lambda: [0, 0.0, 0.0])


def reset_host_stats():
    host_stats.clear()


def _host_op(type):
    """Register `fn` as the lod-aware host kernel of `type`, timed into
    host_stats. On a card the wait for the stream's earlier work comes
    first, so the host seconds hold only this op's copies and numpy."""

    def deco(fn):
        def kernel(ctx, ins, attrs):
            t0 = time.perf_counter()
            if ctx.device.type == "cuda":
                torch.cuda.current_stream(ctx.device).synchronize()
            t1 = time.perf_counter()
            outs = fn(ctx, ins, attrs)
            stat = host_stats[type]
            stat[0] += 1
            stat[1] += time.perf_counter() - t1
            stat[2] += t1 - t0
            return outs

        kernel.__name__ = kernel.__qualname__ = fn.__name__
        kernel.__doc__ = fn.__doc__
        register_op(type, lod_aware=True)(kernel)
        return fn

    return deco


def _np(v):
    """A numpy copy of a tensor (a SeqTensor's data) on the host; bf16
    widens to f32, which keeps every order and tie."""
    if isinstance(v, SeqTensor):
        v = v.data
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _host_lengths(seq):
    if seq.host_lengths is not None:
        return np.asarray(seq.host_lengths)
    return seq.lengths.cpu().numpy()


def _split(v):
    """(data, lengths) on the host: a SeqTensor's, or one sequence."""
    if isinstance(v, SeqTensor):
        return _np(v.data), _host_lengths(v)
    data = _np(v)
    return data, np.asarray([data.shape[0]])


def _dev(ctx, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)


def _seq(ctx, data, lengths):
    lens = np.asarray(lengths, np.int32)
    return SeqTensor(_dev(ctx, data), _dev(ctx, lens), host_lengths=lens)


# ---------------------------------------------------------------------------
# roi_pool
# ---------------------------------------------------------------------------
# the elements of one [R, C, H, pw, W] chunk of the row maxima, at most
_ROI_CHUNK_ELEMS = 1 << 26


def _roi_bins(rois, scale, ph, pw, H, W):
    """Each ROI's image (int64 [R]) and its bins as masks over the map:
    rows [R, ph, H], columns [R, pw, W]; the JAX package's integer forms
    (jnp.round rounds half to even, as torch.round does)."""
    if rois.shape[-1] == 5:
        bidx = rois[:, 0].to(torch.int32).to(torch.int64)
        boxes = rois[:, 1:]
    else:
        bidx = torch.zeros((rois.shape[0],), dtype=torch.int64,
                           device=rois.device)
        boxes = rois
    c = torch.round(boxes * scale).to(torch.int32)

    def mask(lo, hi, n, size):
        length = torch.clamp_min(hi - lo + 1, 1)[:, None]
        p = torch.arange(n, dtype=torch.int32, device=rois.device)[None]
        start = lo[:, None] + torch.div(p * length, n, rounding_mode="floor")
        end = lo[:, None] + torch.div((p + 1) * length + n - 1, n,
                                      rounding_mode="floor")
        end = torch.maximum(end, start + 1)
        at = torch.arange(size, dtype=torch.int32, device=rois.device)
        return (at >= start[..., None]) & (at < end[..., None])

    return (bidx, mask(c[:, 1], c[:, 3], ph, H),
            mask(c[:, 0], c[:, 2], pw, W))


def _row_max(xr, wmask, neg):
    """[Rc, C, H, pw]: each row's max over each column bin."""
    return torch.where(wmask[:, None, None], xr[:, :, :, None, :],
                       neg).amax(-1)


class _RoiPool(torch.autograd.Function):
    """Max over each ROI's bins, chunked over the ROIs, so no tensor holds
    every bin's masked copy of the map: a row's max over each column bin
    ([Rc, C, H, pw]), then the max of those rows over each row bin.

    The backward splits a bin's cotangent equally among its tied maxima,
    as the JAX package's max does (ReLU'd maps tie at 0): an element gets
    g / count from each bin whose max it equals. Its sums are elementwise
    adds in a fixed order (row bins, then column bins, then ROIs one at a
    time), so the card and the host give the same bits."""

    @staticmethod
    def forward(ctx, x, bidx, hmask, wmask):
        R, ph, pw = bidx.shape[0], hmask.shape[1], wmask.shape[1]
        _, C, H, W = x.shape
        neg = torch.finfo(x.dtype).min
        step = max(1, _ROI_CHUNK_ELEMS // max(1, C * H * pw * W))
        outs = []
        for s in range(0, R, step):
            xr = x.index_select(0, bidx[s:s + step])
            rows = _row_max(xr, wmask[s:s + step], neg)     # [Rc, C, H, pw]
            outs.append(torch.where(
                hmask[s:s + step, None, :, None, :],
                rows.transpose(2, 3)[:, :, None], neg).amax(-1))
        o = torch.cat(outs) if outs else x.new_empty((0, C, ph, pw))
        ctx.save_for_backward(x, bidx, hmask, wmask, o)
        return o

    @staticmethod
    def backward(ctx, g):
        x, bidx, hmask, wmask, o = ctx.saved_tensors
        R, ph, pw = bidx.shape[0], hmask.shape[1], wmask.shape[1]
        _, C, H, W = x.shape
        neg = torch.finfo(x.dtype).min
        gx = torch.zeros_like(x)
        step = max(1, _ROI_CHUNK_ELEMS // max(1, C * H * pw * W))
        for s in range(0, R, step):
            xr = x.index_select(0, bidx[s:s + step])        # [Rc, C, H, W]
            wm = wmask[s:s + step]
            rows = _row_max(xr, wm, neg)                    # [Rc, C, H, pw]
            # per row and column bin: how many of its elements hold the max
            row_hits = (wm[:, None, None] & (
                xr[:, :, :, None, :] == rows[..., None])).sum(
                    -1, dtype=torch.int32)
            rows_t = rows.transpose(2, 3)                   # [Rc, C, pw, H]
            oc = o[s:s + step]
            # tie[r, c, i, j, y]: row y of bin (i, j) holds the bin's max
            tie = hmask[s:s + step, None, :, None, :] & (
                rows_t[:, :, None] == oc[..., None])
            count = (tie * row_hits.transpose(2, 3)[:, :, None]).sum(
                -1, dtype=torch.int32)
            q = torch.where(count > 0, g[s:s + step] / count.to(g.dtype),
                            torch.zeros((), dtype=g.dtype, device=g.device))
            per_row = torch.zeros_like(rows_t)              # [Rc, C, pw, H]
            for i in range(ph):
                per_row = per_row + torch.where(
                    tie[:, :, i], q[:, :, i, :, None], 0.0)
            contrib = torch.zeros_like(xr)
            for j in range(pw):
                hit = wm[:, j, None, None, :] & (xr == rows[..., j, None])
                contrib = contrib + torch.where(
                    hit, per_row[:, :, j, :, None], 0.0)
            for k in range(contrib.shape[0]):
                gx.index_add_(0, bidx[s + k:s + k + 1], contrib[k:k + 1])
        return gx, None, None, None


@register_op("roi_pool")
def roi_pool_op(ctx, ins, attrs):
    """reference operators/roi_pool_op.cc: max pool over each ROI's
    pooled_height x pooled_width grid. X [N, C, H, W]; ROIs [R, 5]
    (image, x1, y1, x2, y2) or [R, 4] (image 0), scaled by spatial_scale
    and rounded. A bin wholly outside the map gives finfo(dtype).min, as in
    the JAX package; Argmax is zeros, as there."""
    x = first(ins, "X")
    rois = first(ins, "ROIs")
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    bidx, hmask, wmask = _roi_bins(rois, scale, ph, pw, x.shape[2],
                                   x.shape[3])
    o = _RoiPool.apply(x, bidx, hmask, wmask)
    return out(Out=o, Argmax=torch.zeros(o.shape, dtype=torch.int64,
                                         device=o.device))


set_stop_gradient_outputs("roi_pool", ["Argmax"])


# ---------------------------------------------------------------------------
# boxes on the device
# ---------------------------------------------------------------------------
@register_op("iou_similarity")
def iou_similarity_op(ctx, ins, attrs):
    """[N, 4] x [M, 4] -> [N, M] IoU. X may be a SeqTensor (ground truth
    per image): the registry gives Out X's lengths, which bipartite_match
    reads."""
    a, b = first(ins, "X"), first(ins, "Y")

    def area(t):
        return torch.clamp_min(t[:, 2] - t[:, 0], 0) * \
            torch.clamp_min(t[:, 3] - t[:, 1], 0)

    ix1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return out(Out=inter / torch.clamp_min(union, 1e-10))


def _correctly_rounded(fn, x):
    """fn(x) in f64, rounded to x's dtype: the correctly rounded value on
    the card and the host alike. CUDA's expf and logf and the CPU's
    vectorized exp and log may differ in the last bit, which the decode's
    cancellation near 0 (cx - w / 2) turns into large relative errors."""
    return fn(x.double()).to(x.dtype)


@register_op("box_coder")
def box_coder_op(ctx, ins, attrs):
    """encode_center_size ([N, 4] targets against [M, 4] priors ->
    [N, M, 4]; elementwise: [..., M, 4] paired 1:1 with the priors, SSD's
    loc targets) or decode_center_size ([..., M, 4] offsets -> boxes).
    The log and exp are correctly rounded (_correctly_rounded)."""
    prior = first(ins, "PriorBox")
    prior_var = first(ins, "PriorBoxVar")
    target = first(ins, "TargetBox")
    code_type = attrs.get("code_type", "encode_center_size")
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    var = prior_var if prior_var is not None else torch.ones_like(prior)
    if code_type.startswith("encode"):
        tw = target[..., 2] - target[..., 0]
        th = target[..., 3] - target[..., 1]
        tcx = target[..., 0] + 0.5 * tw
        tcy = target[..., 1] + 0.5 * th
        if not attrs.get("elementwise", False):
            tw, th, tcx, tcy = (t[:, None] for t in (tw, th, tcx, tcy))
        o = torch.stack([
            (tcx - pcx) / pw / var[:, 0],
            (tcy - pcy) / ph / var[:, 1],
            _correctly_rounded(torch.log, torch.clamp_min(tw / pw, 1e-10))
            / var[:, 2],
            _correctly_rounded(torch.log, torch.clamp_min(th / ph, 1e-10))
            / var[:, 3],
        ], dim=-1)
        return out(OutputBox=o)
    t = target.reshape(-1, prior.shape[0], 4)
    ocx = pcx + t[..., 0] * var[:, 0] * pw
    ocy = pcy + t[..., 1] * var[:, 1] * ph
    ow = _correctly_rounded(torch.exp, t[..., 2] * var[:, 2]) * pw
    oh = _correctly_rounded(torch.exp, t[..., 3] * var[:, 3]) * ph
    return out(OutputBox=torch.stack(
        [ocx - 0.5 * ow, ocy - 0.5 * oh, ocx + 0.5 * ow, ocy + 0.5 * oh],
        dim=-1))


def _expand_aspect_ratios(ratios, flip):
    """reference prior_box_op.h ExpandAspectRatios:25."""
    outp = [1.0]
    for ar in ratios:
        if any(abs(ar - e) < 1e-6 for e in outp):
            continue
        outp.append(float(ar))
        if flip:
            outp.append(1.0 / float(ar))
    return outp


def _prior_half_sizes(attrs):
    """[P, 2] f32 half widths and heights of one position's priors, in the
    reference's order: for each min_size every aspect ratio, then that
    min_size's sqrt(min * max) square."""
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = _expand_aspect_ratios(attrs.get("aspect_ratios", [1.0]),
                                attrs.get("flip", False))
    half = []
    for s, ms in enumerate(min_sizes):
        for ar in ars:
            half.append((ms * np.sqrt(ar) / 2.0, ms / np.sqrt(ar) / 2.0))
        if max_sizes:
            side = np.sqrt(ms * max_sizes[s]) / 2.0
            half.append((side, side))
    return np.asarray(half, np.float32)


@register_op("prior_box")
def prior_box_op(ctx, ins, attrs):
    """reference operators/detection/prior_box_op.h:56: SSD's prior grid
    for one feature map. Boxes and Variances [H, W, P, 4], normalized to
    the image. The sizes come from the attrs on the host, copied to the
    device once and held (RandomStream.held), so a capture copies none."""
    feat, image = first(ins, "Input"), first(ins, "Image")
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    offset = attrs.get("offset", 0.5)
    H, W = int(feat.shape[2]), int(feat.shape[3])
    IH, IW = int(image.shape[2]), int(image.shape[3])
    step_w = attrs.get("step_w", 0.0) or IW / W
    step_h = attrs.get("step_h", 0.0) or IH / H
    dev = ctx.device
    key = ("prior_box", tuple(attrs["min_sizes"]),
           tuple(attrs.get("max_sizes", [])),
           tuple(attrs.get("aspect_ratios", [1.0])),
           bool(attrs.get("flip", False)), tuple(variances))
    half = ctx.rng.held(key + ("half",), lambda: torch.from_numpy(
        _prior_half_sizes(attrs)).to(dev))
    var = ctx.rng.held(key + ("var",), lambda: torch.tensor(
        variances, dtype=torch.float32).to(dev))
    P = half.shape[0]
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cxg = cx[None, :, None].expand(H, W, P)
    cyg = cy[:, None, None].expand(H, W, P)
    hw = half[None, None, :, 0].expand(H, W, P)
    hh = half[None, None, :, 1].expand(H, W, P)
    boxes = torch.stack([(cxg - hw) / IW, (cyg - hh) / IH,
                         (cxg + hw) / IW, (cyg + hh) / IH], dim=-1)
    if attrs.get("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return out(Boxes=boxes, Variances=var.expand(H, W, P, 4).contiguous())


set_stop_gradient_outputs("prior_box", ["Boxes", "Variances"])


# ---------------------------------------------------------------------------
# SSD's matching and mining, on the host
# ---------------------------------------------------------------------------
def _bipartite_match_one(dist):
    """reference bipartite_match_op.cc:59: greedy global-max matching.
    dist: [rows(gt), cols(priors)] -> (col_to_row [C], col_dist [C]).
    G rounds of a masked argmax, which takes the first maximum in
    row-major order (tied IoUs of symmetric priors)."""
    rows, cols = dist.shape
    match = np.full(cols, -1, np.int64)
    mdist = np.zeros(cols, np.float32)
    d = np.where(dist >= 1e-6, dist.astype(np.float32), -1.0)
    row_free = np.ones(rows, bool)
    col_free = np.ones(cols, bool)
    for _ in range(min(rows, cols)):
        sub = np.where(row_free[:, None] & col_free[None, :], d, -1.0)
        flat = int(np.argmax(sub))
        m, j = divmod(flat, cols)
        if sub[m, j] < 0:
            break
        match[j] = m
        mdist[j] = dist[m, j]
        row_free[m] = False
        col_free[j] = False
    return match, mdist


@_host_op("bipartite_match")
def bipartite_match_op(ctx, ins, attrs):
    """DistMat: SeqTensor [sum_gt, P] (rows per image) or dense [G, P] ->
    ColToRowMatchIndices [B, P] (gt row per prior, local to its image, -1
    unmatched) and ColToRowMatchDist [B, P]."""
    data, lengths = _split(first(ins, "DistMat"))
    match_type = attrs.get("match_type", "bipartite")
    thresh = float(attrs.get("dist_threshold", 0.5))
    P = data.shape[1]
    B = len(lengths)
    match = np.full((B, P), -1, np.int64)
    mdist = np.zeros((B, P), np.float32)
    off = 0
    for b, L in enumerate(lengths):
        sub = data[off:off + L]
        if L > 0:
            m, d = _bipartite_match_one(sub)
            if match_type == "per_prediction":
                # reference ArgMaxMatch: unmatched priors take their argmax
                # gt when the overlap passes the threshold
                am = sub.argmax(axis=0)
                amd = sub.max(axis=0)
                extra = (m == -1) & (amd > thresh)
                m[extra] = am[extra]
                d[extra] = amd[extra]
            match[b], mdist[b] = m, d
        off += L
    return out(ColToRowMatchIndices=_dev(ctx, match),
               ColToRowMatchDist=_dev(ctx, mdist))


@_host_op("target_assign")
def target_assign_op(ctx, ins, attrs):
    """reference operators/detection/target_assign_op.cc: each prior gets
    its matched gt row of the image's X slice, weight 1; an unmatched
    prior gets mismatch_value, weight 0. NegIndices (mined negatives, per
    image) get weight 1 with the mismatch value (the background class)."""
    data, lengths = _split(first(ins, "X"))
    match = _np(first(ins, "MatchIndices"))
    neg = first(ins, "NegIndices")
    mismatch = attrs.get("mismatch_value", 0)
    data = data.reshape(data.shape[0], -1)
    B, P = match.shape
    D = data.shape[1]
    outv = np.full((B, P, D), mismatch, data.dtype)
    w = np.zeros((B, P, 1), np.float32)
    off = 0
    for b in range(B):
        L = int(lengths[b]) if b < len(lengths) else 0
        sel = match[b] >= 0
        outv[b, sel] = data[off + match[b, sel]]
        w[b, sel, 0] = 1.0
        off += L
    if neg is not None:
        nrows, nlens = _split(neg)
        nrows = nrows.reshape(-1)
        off = 0
        for b in range(B):
            for i in nrows[off:off + int(nlens[b])]:
                w[b, int(i)] = 1.0
            off += int(nlens[b])
    return out(Out=_dev(ctx, outv), OutWeight=_dev(ctx, w))


@_host_op("mine_hard_examples")
def mine_hard_examples_op(ctx, ins, attrs):
    """reference operators/detection/mine_hard_examples_op.cc
    (max_negative): each image's highest-loss negatives, up to
    neg_pos_ratio x its positives (and sample_size, when given, as in the
    JAX package); a negative whose MatchDist reaches neg_dist_threshold is
    left out. The ranking is a stable sort of -loss. -> NegIndices
    (SeqTensor [sum_neg, 1]) and UpdatedMatchIndices (MatchIndices)."""
    mining_type = attrs.get("mining_type", "max_negative")
    if mining_type != "max_negative":
        raise NotImplementedError(
            f"mine_hard_examples: mining_type={mining_type!r} unsupported "
            f"(only 'max_negative')")
    match = _np(first(ins, "MatchIndices"))
    cls_loss = _np(first(ins, "ClsLoss")).reshape(match.shape)
    mdist = first(ins, "MatchDist")
    mdist = _np(mdist) if mdist is not None else None
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    neg_thresh = float(attrs.get("neg_dist_threshold", 0.5))
    sample_size = attrs.get("sample_size")
    B, P = match.shape
    neg_rows = []
    lengths = []
    for b in range(B):
        pos = match[b] >= 0
        num_neg = int(min(P - pos.sum(), np.ceil(ratio * pos.sum())))
        if sample_size is not None:
            num_neg = min(num_neg, int(sample_size))
        cand = np.where(~pos if mdist is None
                        else (~pos) & (mdist[b] < neg_thresh))[0]
        order = cand[np.argsort(-cls_loss[b, cand], kind="stable")]
        chosen = np.sort(order[:num_neg])
        neg_rows.extend(chosen.tolist())
        lengths.append(len(chosen))
    neg = _seq(ctx, np.asarray(neg_rows, np.int64).reshape(-1, 1), lengths)
    return out(NegIndices=neg, UpdatedMatchIndices=_dev(ctx, match))


# ---------------------------------------------------------------------------
# multiclass NMS: the selection on the op's device, the rows on the host
# ---------------------------------------------------------------------------
def _nms_keep(boxes, scores, score_threshold, nms_threshold, top_k, eta):
    """reference multiclass_nms_op.cc NMSFast:134 for every (image, class)
    at once, selecting what the JAX package's double loop selects.

    boxes [N, M, 4], scores [N, C, M] -> (order [N, C, k]: the candidates
    in a stable descending score order, the first top_k; their scores
    [N, C, k]; kept [N, C, k] bool). A candidate is one above the score
    threshold. Each is kept unless its IoU with a kept one passes the
    threshold, which eta < 1 lowers after each keep while it is above 0.5.
    The IoUs are one [N, C, k, k] f32 tensor in the JAX package's order,
    inter / max(a + bA - inter, 1e-10); the comparisons are in f32, as
    numpy compares an f32 with a Python float. The walk over the k
    positions runs every (image, class) in step. Each op is exact or one
    IEEE f32 operation, so the card and the host select the same boxes."""
    N, C, M = scores.shape
    k = M if top_k < 0 else min(top_k, M)
    neg, order = torch.sort(-scores, dim=-1, stable=True)
    order, top = order[..., :k], -neg[..., :k]
    valid = top > score_threshold
    cand = torch.gather(boxes[:, None].expand(N, C, M, 4), 2,
                        order[..., None].expand(N, C, k, 4))
    x1, y1, x2, y2 = cand.unbind(-1)
    iw = torch.clamp_min(torch.minimum(x2[..., :, None], x2[..., None, :])
                         - torch.maximum(x1[..., :, None], x1[..., None, :]),
                         0.0)
    ih = torch.clamp_min(torch.minimum(y2[..., :, None], y2[..., None, :])
                         - torch.maximum(y1[..., :, None], y1[..., None, :]),
                         0.0)
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    over = inter / torch.clamp_min(
        area[..., :, None] + area[..., None, :] - inter, 1e-10)
    kept = torch.zeros_like(valid)
    adaptive = eta < 1.0 and nms_threshold > 0.5
    thr = torch.full((N, C), nms_threshold, dtype=torch.float64,
                     device=scores.device)
    for pos in range(k):
        bound = thr.to(torch.float32)[..., None] if adaptive \
            else nms_threshold
        hit = ((over[..., pos, :] > bound) & kept).any(-1)
        keep = valid[..., pos] & ~hit
        kept[..., pos] = keep
        if adaptive:
            thr = torch.where(keep & (thr > 0.5), thr * eta, thr)
    return order, top, kept


@_host_op("multiclass_nms")
def multiclass_nms_op(ctx, ins, attrs):
    """reference operators/detection/multiclass_nms_op.cc: NMS per class
    (_nms_keep, on the op's device), then keep_top_k over the image, on
    the host. Scores [N, C, M], BBoxes [N, M, 4] -> Out SeqTensor [total,
    6] rows (label, score, x1, y1, x2, y2), each image's classes in
    ascending order; an image with no detection gives one (-1, 0, 0, 0,
    0, 0) row, as the reference."""
    boxes = first(ins, "BBoxes")
    scores = first(ins, "Scores")
    bg = int(attrs.get("background_label", 0))
    N, C, M = scores.shape
    classes = [c for c in range(C) if c != bg]
    order, top, kept = _nms_keep(
        boxes.float(), scores.float()[:, classes],
        float(attrs.get("score_threshold", 0.0)),
        float(attrs.get("nms_threshold", 0.3)),
        int(attrs.get("nms_top_k", -1)), float(attrs.get("nms_eta", 1.0)))
    keep_top_k = int(attrs.get("keep_top_k", -1))
    order, top, kept = _np(order), _np(top), _np(kept)
    boxes = _np(boxes)
    rows = []
    lengths = []
    for n in range(N):
        dets = [(float(top[n, j, pos]), c, int(order[n, j, pos]))
                for j, c in enumerate(classes)
                for pos in np.flatnonzero(kept[n, j])]
        if keep_top_k > -1 and len(dets) > keep_top_k:
            dets.sort(key=lambda t: -t[0])
            dets = dets[:keep_top_k]
        if not dets:
            rows.append([-1.0, 0.0, 0.0, 0.0, 0.0, 0.0])
            lengths.append(1)
            continue
        for s, c, i in dets:
            rows.append([float(c), s] + boxes[n, i].tolist())
        lengths.append(len(dets))
    return out(Out=_seq(ctx, np.asarray(rows, np.float32), lengths))


# ---------------------------------------------------------------------------
# detection_map: VOC mean average precision with cross-batch accumulation
# (reference operators/detection_map_op.{cc,h}), on the host
# ---------------------------------------------------------------------------
def _dmap_iou(b1, b2):
    """Jaccard overlap of two [xmin, ymin, xmax, ymax] boxes
    (detection_map_op.h JaccardOverlap: 0 on no overlap, no +1 edge)."""
    if b2[0] > b1[2] or b2[2] < b1[0] or b2[1] > b1[3] or b2[3] < b1[1]:
        return 0.0
    ixmin, iymin = max(b1[0], b2[0]), max(b1[1], b2[1])
    ixmax, iymax = min(b1[2], b2[2]), min(b1[3], b2[3])
    inter = (ixmax - ixmin) * (iymax - iymin)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    denom = a1 + a2 - inter
    return float(inter / denom) if denom > 0 else 0.0


def _dmap_average_precision(tp_pairs, fp_pairs, num_pos, ap_type):
    """One class's AP from its accumulated (score, flag) lists
    (detection_map_op.h GetAccumulation + CalcMAP)."""
    order = sorted(range(len(tp_pairs)), key=lambda i: -tp_pairs[i][0])
    tp_sum, fp_sum = [], []
    t = f = 0
    for i in order:
        t += tp_pairs[i][1]
        f += fp_pairs[i][1]
        tp_sum.append(t)
        fp_sum.append(f)
    precision = [ts / (ts + fs) if ts + fs else 0.0
                 for ts, fs in zip(tp_sum, fp_sum)]
    recall = [ts / num_pos for ts in tp_sum]
    n = len(tp_sum)
    if ap_type == "11point":
        max_precisions = [0.0] * 11
        start_idx = n - 1
        for j in range(10, -1, -1):
            for i in range(start_idx, -1, -1):
                if recall[i] < j / 10.0:
                    start_idx = i
                    if j > 0:
                        max_precisions[j - 1] = max_precisions[j]
                    break
                if max_precisions[j] < precision[i]:
                    max_precisions[j] = precision[i]
        return sum(max_precisions) / 11.0
    if ap_type == "integral":
        ap = 0.0
        prev_recall = 0.0
        for i in range(n):
            if abs(recall[i] - prev_recall) > 1e-6:
                ap += precision[i] * abs(recall[i] - prev_recall)
            prev_recall = recall[i]
        return ap
    raise ValueError(f"detection_map: unknown ap_type {ap_type!r} "
                     "(want 'integral' or '11point')")


def _dmap_split(seq):
    """A SeqTensor's (or a plain array's: one image) host data and each
    image's row range."""
    data, lens = _split(seq)
    offs = np.zeros(len(lens) + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    return data, [(int(offs[i]), int(offs[i + 1])) for i in range(len(lens))]


@_host_op("detection_map")
def detection_map_op(ctx, ins, attrs):
    """VOC mAP over a batch, chained through accumulator state when
    HasState != 0 (the JAX package's kernel, its documented divergence
    from the reference's CalcMAP included: a class with no positives and
    the background class are skipped). The state seeds only the classes
    that hold a pair, as the reference's do, so the mAP accumulated over
    batches is the mAP of the batches taken at once (ROADMAP §3 item 26).

    DetectRes: LoD [M, 6] rows (label, score, box). Label: LoD [N, 6] rows
    (label, difficult, box) or [N, 5] (label, box). State: PosCount int32
    [C, 1]; TruePos / FalsePos LoD [K, 2] of (score, flag), one sequence
    per class."""
    class_num = int(attrs["class_num"])
    background_label = int(attrs.get("background_label", 0))
    overlap_threshold = float(attrs.get("overlap_threshold", 0.3))
    evaluate_difficult = bool(attrs.get("evaluate_difficult", True))
    ap_type = str(attrs.get("ap_type", "integral"))

    det_data, det_ranges = _dmap_split(first(ins, "DetectRes"))
    lab_data, lab_ranges = _dmap_split(first(ins, "Label"))
    if len(det_ranges) != len(lab_ranges):
        raise ValueError(
            f"detection_map: DetectRes batch {len(det_ranges)} != "
            f"Label batch {len(lab_ranges)}")
    with_difficult = lab_data.shape[1] == 6

    gt_boxes, det_boxes = [], []
    for s, e in lab_ranges:
        boxes = {}
        for r in lab_data[s:e]:
            cls = int(r[0])
            if with_difficult:
                boxes.setdefault(cls, []).append(
                    (r[2:6].tolist(), bool(abs(float(r[1])) >= 1e-6)))
            else:
                boxes.setdefault(cls, []).append((r[1:5].tolist(), False))
        gt_boxes.append(boxes)
    for s, e in det_ranges:
        boxes = {}
        for r in det_data[s:e]:
            boxes.setdefault(int(r[0]), []).append(
                (float(r[1]), r[2:6].tolist()))
        det_boxes.append(boxes)

    label_pos_count, true_pos, false_pos = {}, {}, {}
    has_state = first(ins, "HasState")
    state = int(_np(has_state).reshape(-1)[0]) if has_state is not None \
        else 0
    pos_count_in = first(ins, "PosCount")
    if pos_count_in is not None and state:
        pc = _np(pos_count_in).reshape(-1)
        for c in range(class_num):
            label_pos_count[c] = int(pc[c])
        for slot, dest in (("TruePos", true_pos), ("FalsePos", false_pos)):
            data, ranges = _dmap_split(first(ins, slot))
            # a class gets a list only when it holds a pair, as the
            # reference's GetInputPos pushes them (detection_map_op.h); the
            # JAX package gives every class one, so a class with positives
            # and no detection counts as AP 0 once chained (ROADMAP §3
            # item 26), and the accumulated mAP is not the one-shot one
            for c, (s, e) in enumerate(ranges):
                if e > s:
                    dest[c] = [(float(data[j, 0]), int(data[j, 1]))
                               for j in range(s, e)]

    # CalcTrueAndFalsePositive (detection_map_op.h:310-409)
    for boxes in gt_boxes:
        for cls, blist in boxes.items():
            count = len(blist) if evaluate_difficult else \
                sum(1 for _b, diff in blist if not diff)
            if count:
                label_pos_count[cls] = label_pos_count.get(cls, 0) + count
    for img_gt, img_det in zip(gt_boxes, det_boxes):
        for cls, preds in img_det.items():
            if cls not in img_gt:
                for score, _box in preds:
                    true_pos.setdefault(cls, []).append((score, 0))
                    false_pos.setdefault(cls, []).append((score, 1))
                continue
            gts = img_gt[cls]
            visited = [False] * len(gts)
            for score, box in sorted(preds, key=lambda p: -p[0]):
                clipped = [min(max(v, 0.0), 1.0) for v in box]
                best, best_j = -1.0, 0
                for j, (gbox, _diff) in enumerate(gts):
                    ov = _dmap_iou(clipped, gbox)
                    if ov > best:
                        best, best_j = ov, j
                if best > overlap_threshold:
                    if evaluate_difficult or not gts[best_j][1]:
                        if not visited[best_j]:
                            true_pos.setdefault(cls, []).append((score, 1))
                            false_pos.setdefault(cls, []).append((score, 0))
                            visited[best_j] = True
                        else:
                            true_pos.setdefault(cls, []).append((score, 0))
                            false_pos.setdefault(cls, []).append((score, 1))
                else:
                    true_pos.setdefault(cls, []).append((score, 0))
                    false_pos.setdefault(cls, []).append((score, 1))

    # CalcMAP
    m_ap, counted = 0.0, 0
    for cls, num_pos in label_pos_count.items():
        if num_pos == 0 or cls == background_label or cls not in true_pos:
            continue
        m_ap += _dmap_average_precision(
            true_pos[cls], false_pos[cls], num_pos, ap_type)
        counted += 1
    m_ap = m_ap / counted if counted else 0.0

    # the accumulators (GetOutputPos): one sequence per class
    pos_out = np.zeros((class_num, 1), np.int32)
    for c, n in label_pos_count.items():
        if 0 <= c < class_num:
            pos_out[c, 0] = n

    def pack(d):
        rows, lens = [], []
        for c in range(class_num):
            pairs = d.get(c, [])
            lens.append(len(pairs))
            rows.extend(pairs)
        data = np.asarray(rows, np.float32).reshape(len(rows), 2) \
            if rows else np.zeros((0, 2), np.float32)
        return _seq(ctx, data, lens)

    return out(
        MAP=_dev(ctx, np.asarray([m_ap], np.float32)),
        AccumPosCount=_dev(ctx, pos_out),
        AccumTruePos=pack(true_pos),
        AccumFalsePos=pack(false_pos),
    )


set_stop_gradient_outputs(
    "detection_map",
    ["MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos"])
