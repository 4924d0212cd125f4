"""NN compute ops: the convolutions (2-d, depthwise, 3-d, transposed),
pooling, batch and layer norm, lrn, softmax, cross_entropy, the dense
losses, dropout, random_crop, prelu, bilinear_interp, row_conv,
im2sequence, spp and unpool.

Reference parity: operators/{conv,conv_transpose,pool,batch_norm,
layer_norm,lrn,softmax,cross_entropy,softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits,squared_l2_norm,squared_l2_distance,
smooth_l1_loss,huber_loss,hinge_loss,rank_loss,margin_rank_loss,log_loss,
dropout,random_crop,prelu,bilinear_interp,row_conv,im2sequence,spp,
unpool}_op.cc (with square_error_cost, a layer there), each as the JAX
package's paddle_tpu/ops/nn_ops.py computes it. Both activation layouts are supported; filters stay OIHW in
every layout, so parameters (and checkpoints) are layout-independent. In
NHWC the activation is viewed as NCHW around torch's conv/pool calls
without a copy (a channels-last NCHW view), which cuDNN takes natively on
the card.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..backward import _default_grad_maker
from ..core.registry import (SeqTensor, register_grad_maker, register_op,
                             set_stop_gradient_outputs)
from .collective_ops import psum
from .tensor_ops import random_draw
from .util import at_least_f32, first, out


def _to_nchw(x, nhwc):
    return x.permute(0, 3, 1, 2) if nhwc else x


def _from_nchw(x, nhwc):
    return x.permute(0, 2, 3, 1) if nhwc else x


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------
@register_op("conv2d")
def conv2d_op(ctx, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Filter")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    o = F.conv2d(_to_nchw(x, nhwc), w.to(x.dtype),
                 stride=tuple(attrs.get("strides", [1, 1])),
                 padding=tuple(attrs.get("paddings", [0, 0])),
                 dilation=tuple(attrs.get("dilations", [1, 1])),
                 groups=attrs.get("groups", 1))
    return out(Output=_from_nchw(o, nhwc))


@register_op("depthwise_conv2d")
def depthwise_conv2d_op(ctx, ins, attrs):
    """conv2d with one group per input channel."""
    x = first(ins, "Input")
    a = dict(attrs)
    a["groups"] = x.shape[-1 if a.get("data_format", "NCHW") == "NHWC"
                          else 1]
    return conv2d_op(ctx, ins, a)


@register_op("conv3d")
def conv3d_op(ctx, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Filter")
    return out(Output=F.conv3d(
        x, w.to(x.dtype), stride=tuple(attrs.get("strides", [1, 1, 1])),
        padding=tuple(attrs.get("paddings", [0, 0, 0])),
        dilation=tuple(attrs.get("dilations", [1, 1, 1])),
        groups=attrs.get("groups", 1)))


@register_op("conv2d_transpose")
def conv2d_transpose_op(ctx, ins, attrs):
    """reference operators/conv_transpose_op.cc: NCHW, filter [C_in,
    C_out / groups, kh, kw] (IOHW); out = (in - 1) * stride - 2 * padding
    + dilation * (k - 1) + 1, the JAX package's conv over the
    stride-dilated input with the flipped filter. The layer turns an
    `output_size` into the filter size, so the op never reads it."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    return out(Output=F.conv_transpose2d(
        x, w.to(x.dtype), stride=tuple(attrs.get("strides", [1, 1])),
        padding=tuple(attrs.get("paddings", [0, 0])),
        dilation=tuple(attrs.get("dilations", [1, 1])),
        groups=attrs.get("groups", 1)))


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------
def _ceil_extra(size, k, s, p):
    """Extra right/bottom padding so the window count rounds up."""
    n = math.ceil((size + 2 * p - k) / s) + 1
    return max(0, (n - 1) * s + k - size - 2 * p)


@register_op("pool2d")
def pool2d_op(ctx, ins, attrs):
    """Windows over explicitly padded input: padding is applied by hand
    (-inf for max, 0 for avg) so `ceil_mode` keeps the reference's
    semantics — extra right/bottom padding, no dropped windows — which
    torch's own ceil_mode does not."""
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    x = _to_nchw(first(ins, "X"), nhwc)
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", [1, 1]))
    paddings = list(attrs.get("paddings", [0, 0]))
    h, w = x.shape[2], x.shape[3]
    if attrs.get("global_pooling", False):
        ksize, paddings, strides = [h, w], [0, 0], [1, 1]
    ph, pw = paddings
    eh = ew = 0
    if attrs.get("ceil_mode", False):
        eh = _ceil_extra(h, ksize[0], strides[0], ph)
        ew = _ceil_extra(w, ksize[1], strides[1], pw)
    pad = (pw, pw + ew, ph, ph + eh)  # F.pad order: W left/right, H top/bottom
    if ptype == "max":
        xp = F.pad(x, pad, value=-math.inf) if any(pad) else x
        o = F.max_pool2d(xp, ksize, strides)
    else:
        xp = F.pad(x, pad) if any(pad) else x
        s = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
        if attrs.get("exclusive", True) and any(pad):
            ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype,
                                    device=x.device), pad)
            o = s / F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        else:
            o = s / (ksize[0] * ksize[1])
    return out(Out=_from_nchw(o, nhwc))


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------
@register_op("batch_norm")
def batch_norm_op(ctx, ins, attrs):
    """reference operators/batch_norm_op.cc, with the JAX package's
    formulas written out (torch's batch_norm differs on each): one-pass
    statistics v = max(E[x^2] - E[x]^2, 0); running stats
    mean*momentum + m*(1-momentum) with the BIASED batch variance;
    SavedVariance = rsqrt(v + eps). Training grads flow through the batch
    statistics. Mean/Variance may be absent in training mode (the
    batch_norm_grad op below does not carry them): MeanOut/VarianceOut
    are then not produced. Under ParallelExecutor (ctx.dp) the batch
    statistics are the global batch's (`_global_moments`), as the JAX
    package computes them over the dp-sharded batch."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    mean, var = first(ins, "Mean"), first(ins, "Variance")
    momentum = attrs.get("momentum", 0.9)
    eps = attrs.get("epsilon", 1e-5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != c_axis)
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    xf = x.to(torch.float32)
    if is_test:
        m, v = mean, var
        mean_out, var_out = mean, var
        saved_mean = mean
    else:
        m = xf.mean(dim=axes)
        msq = (xf * xf).mean(dim=axes)
        if ctx.dp is not None:
            m, msq = _global_moments(m, msq, ctx.dp)
        v = torch.clamp_min(msq - m * m, 0.0)
        mean_out = None if mean is None else mean * momentum + m * (1 - momentum)
        var_out = None if var is None else var * momentum + v * (1 - momentum)
        saved_mean = m
    inv = torch.rsqrt(v.to(torch.float32) + eps)
    y = (xf - m.reshape(shape)) * inv.reshape(shape)
    y = y * scale.reshape(shape) + bias.reshape(shape)
    return out(Y=y.to(x.dtype), MeanOut=mean_out, VarianceOut=var_out,
               SavedMean=saved_mean, SavedVariance=inv.detach())


def _global_moments(m, msq, dp):
    """E[x] and E[x^2] of the global batch from each rank's: the ranks hold
    equal shares of it, so the global moments are the means of the ranks'
    (at one rank, exactly the local ones). One f32 all-reduce of both; it
    is differentiable (collective_ops.psum), so the derived grad's
    backward all-reduces the moments' cotangents, which each rank holds
    only its part of — the sums of dy and dy*x_hat over the global batch
    that dx needs — while Scale@GRAD and Bias@GRAD stay this rank's part,
    for ParallelExecutor's gradient all-reduce to add up."""
    both = psum(torch.stack([m, msq]), dp) / dp.size
    return both[0], both[1]


set_stop_gradient_outputs(
    "batch_norm", ["MeanOut", "VarianceOut", "SavedMean", "SavedVariance"])


@register_grad_maker("batch_norm")
def batch_norm_grad_maker(op, gout, gin):
    """The default grad op, minus the running Mean/Variance inputs in
    training mode. The training branch normalises with batch statistics,
    so the running stats do not reach any differentiated output; and
    since the forward op updates them in place (Mean -> MeanOut), a grad
    op that read them would read the UPDATED value — which the dataflow
    check flags as a WAR hazard (PTA031) and which makes the fusion pass
    refuse every training program with batch norm."""
    descs = _default_grad_maker(op, gout, gin)
    if not op.attrs.get("is_test", False):
        for d in descs:
            d["inputs"].pop("Mean", None)
            d["inputs"].pop("Variance", None)
    return descs


@register_op("layer_norm")
def layer_norm_op(ctx, ins, attrs):
    """Normalise over the dims from `begin_norm_axis` on (the reference's
    flattening to [N, D] at that axis), then the optional Scale and Bias
    of D elements. The statistics are f32 whatever X's dtype (so under
    AMP Mean and Variance are f32 and Y has X's dtype); Variance is the
    biased one. Mean and Variance drop every size-1 dim, as the JAX
    package's squeeze does."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    xf = at_least_f32(x)
    m = xf.mean(dim=axes, keepdim=True)
    v = torch.square(xf - m).mean(dim=axes, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    feat_shape = [1] * begin + list(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(feat_shape)
    if bias is not None:
        y = y + bias.reshape(feat_shape)
    return out(Y=y.to(x.dtype), Mean=m.squeeze(), Variance=v.squeeze())


set_stop_gradient_outputs("layer_norm", ["Mean", "Variance"])


@register_op("lrn")
def lrn_op(ctx, ins, attrs):
    """Local response norm across channels (NCHW): Out = X / MidOut^beta,
    MidOut = k + alpha * (the sum of X^2 over the n channels centred on
    each), alpha not divided by n (the reference's and the JAX
    package's convention)."""
    x = first(ins, "X")
    n = attrs.get("n", 5)
    k, alpha = attrs.get("k", 2.0), attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    padded = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = sum(padded[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * acc
    return out(Out=x / torch.pow(mid, beta), MidOut=mid)


set_stop_gradient_outputs("lrn", ["MidOut"])


# ---------------------------------------------------------------------------
# Softmax + loss
# ---------------------------------------------------------------------------
@register_op("softmax")
def softmax_op(ctx, ins, attrs):
    return out(Out=torch.softmax(first(ins, "X"), dim=-1))


@register_op("cross_entropy")
def cross_entropy_op(ctx, ins, attrs):
    """reference operators/cross_entropy_op.cc: X holds probabilities
    (after a softmax), not logits."""
    x, label = first(ins, "X"), first(ins, "Label")
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, 1e-20)),
                          dim=-1, keepdim=True)
    else:
        idx = label.reshape(label.shape[0], -1)[:, 0].to(torch.int64)
        p = torch.gather(x, -1, idx[:, None])
        loss = -torch.log(torch.clamp_min(p, 1e-20))
    return out(Y=loss)


def _relu0(x):
    """max(0, x) with the JAX package's gradient: torch.maximum, like
    jnp.maximum, splits the gradient of a tie in half."""
    return torch.maximum(x.new_zeros(()), x)


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy_op(ctx, ins, attrs):
    """The loss of Logits against hard int labels (the first column of
    Label) or soft ones, over a log-softmax; Softmax is its exp."""
    logits, label = first(ins, "Logits"), first(ins, "Label")
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        idx = label.reshape(label.shape[0], -1)[:, 0].to(torch.int64)
        loss = -torch.gather(logp, -1, idx[:, None])
    return out(Softmax=torch.exp(logp), Loss=loss)


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_ce_op(ctx, ins, attrs):
    x, label = first(ins, "X"), first(ins, "Label")
    loss = _relu0(x) - x * label + torch.log1p(torch.exp(-torch.abs(x)))
    return out(Out=loss)


@register_op("square_error_cost")
def square_error_cost_op(ctx, ins, attrs):
    return out(Out=torch.square(first(ins, "X") - first(ins, "Y")))


@register_op("squared_l2_norm")
def squared_l2_norm_op(ctx, ins, attrs):
    return out(Out=torch.sum(torch.square(first(ins, "X"))).reshape(1))


@register_op("squared_l2_distance")
def squared_l2_distance_op(ctx, ins, attrs):
    sub = first(ins, "X") - first(ins, "Y")
    return out(sub_result=sub,
               Out=torch.sum(torch.square(sub), dim=-1, keepdim=True))


@register_op("smooth_l1_loss")
def smooth_l1_loss_op(ctx, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    iw, ow = first(ins, "InsideWeight"), first(ins, "OutsideWeight")
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = x - y
    if iw is not None:
        diff = diff * iw
    ad = torch.abs(diff)
    val = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ow is not None:
        val = val * ow
    return out(Diff=diff, Out=torch.sum(val.reshape(val.shape[0], -1), dim=1,
                                        keepdim=True))


@register_op("huber_loss")
def huber_loss_op(ctx, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return out(Residual=r, Out=loss)


@register_op("hinge_loss")
def hinge_loss_op(ctx, ins, attrs):
    logits, label = first(ins, "Logits"), first(ins, "Labels")
    return out(Loss=_relu0(1.0 - (2.0 * label - 1.0) * logits))


@register_op("rank_loss")
def rank_loss_op(ctx, ins, attrs):
    label = first(ins, "Label")
    d = first(ins, "Left") - first(ins, "Right")
    return out(Out=torch.log1p(torch.exp(d)) - label * d)


@register_op("margin_rank_loss")
def margin_rank_loss_op(ctx, ins, attrs):
    label = first(ins, "Label")
    x1, x2 = first(ins, "X1"), first(ins, "X2")
    o = _relu0(-label * (x1 - x2) + attrs.get("margin", 0.0))
    return out(Out=o, Activated=(o > 0).to(x1.dtype))


set_stop_gradient_outputs("margin_rank_loss", ["Activated"])


@register_op("log_loss")
def log_loss_op(ctx, ins, attrs):
    p, label = first(ins, "Predicted"), first(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return out(Loss=-label * torch.log(p + eps)
               - (1 - label) * torch.log(1 - p + eps))


# ---------------------------------------------------------------------------
# Dropout (explicit grad: it must reuse the forward's mask)
# ---------------------------------------------------------------------------
@register_op("dropout")
def dropout_op(ctx, ins, attrs):
    """Out = X * Mask, where Mask keeps an element (1) with probability
    1 - dropout_prob and is 0 elsewhere; Out is not rescaled. In test mode
    Out = X * (1 - dropout_prob) and Mask is all ones (Fluid's
    downgrade-in-infer). The uniform numbers behind Mask come from the
    program's random stream, new at every step, or, for a non-zero `seed`
    attr, are the same at every step (tensor_ops.random_draw). Under
    ParallelExecutor (ctx.dp) every rank draws the global batch's numbers
    and keeps its rows, so W ranks drop what one Executor does on the
    whole batch."""
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False) or ctx.is_test:
        return out(Out=x * (1.0 - p), Mask=torch.ones_like(x))
    shape = tuple(x.shape)
    dp = ctx.dp
    if dp is not None:  # the global batch's draw, of which this rank's rows
        shape = (shape[0] * dp.size,) + shape[1:]
    u = random_draw(ctx, attrs, ("dropout", shape),
                    lambda g: torch.rand(shape, generator=g,
                                         dtype=torch.float32,
                                         device=ctx.device))
    if dp is not None:
        u = u[dp.rank * x.shape[0]:(dp.rank + 1) * x.shape[0]]
    mask = (u < 1.0 - p).to(x.dtype)
    return out(Out=x * mask, Mask=mask)


set_stop_gradient_outputs("dropout", ["Mask"])


@register_op("dropout_grad")
def dropout_grad_op(ctx, ins, attrs):
    """X@GRAD = Out@GRAD * Mask, the forward's own mask: a grad derived
    from the forward kernel (registry.make_vjp_kernel) would run it again
    and draw a new one."""
    g, mask = first(ins, "Out@GRAD"), first(ins, "Mask")
    return {"X@GRAD": [g * mask]}


@register_grad_maker("dropout")
def dropout_grad_maker(op, gout, gin):
    return [
        dict(
            type="dropout_grad",
            inputs={"Out@GRAD": gout["Out"], "Mask": op.output("Mask")},
            outputs={"X@GRAD": gin["X"]},
            attrs=dict(op.attrs),
        )
    ]


@register_op("random_crop")
def random_crop_op(ctx, ins, attrs):
    """Crop each instance's trailing dims to attrs["shape"] at an offset
    drawn uniformly for every instance and dim (the JAX package's
    per-instance random crop). The offsets come from the program's random
    stream at every step, a non-zero `seed` attr included: the JAX package
    folds that seed into its stream, so its crops vary step to step too
    (a torch.Generator has no fold_in; the two packages draw different
    numbers)."""
    x = first(ins, "X")
    crop = tuple(int(c) for c in attrs["shape"])
    k = len(crop)
    if not 1 <= k <= x.ndim:
        raise ValueError(f"random_crop: shape {crop} incompatible with "
                         f"input rank {x.ndim}")
    tail = tuple(x.shape[x.ndim - k:])
    for c, d in zip(crop, tail):
        if c > d:
            raise ValueError(f"random_crop: crop dim {c} exceeds input dim "
                             f"{d}")
    batch_shape = tuple(x.shape[:x.ndim - k])
    n = int(np.prod(batch_shape)) if batch_shape else 1
    y = x.reshape((n,) + tail)
    u = torch.rand((n, k), generator=ctx.rng.generator, device=ctx.device)
    for i, (c, d) in enumerate(zip(crop, tail)):
        off = torch.clamp((u[:, i] * (d - c + 1)).long(), max=d - c)
        idx = off[:, None] + torch.arange(c, device=ctx.device)  # [n, c]
        view = [n] + [1] * k
        view[1 + i] = c
        shape = list(y.shape)
        shape[1 + i] = c
        y = torch.gather(y, 1 + i, idx.reshape(view).expand(shape))
    return out(Out=y.reshape(batch_shape + crop))


# ---------------------------------------------------------------------------
# Misc nn
# ---------------------------------------------------------------------------
@register_op("prelu")
def prelu_op(ctx, ins, attrs):
    """Out = X where X > 0, else Alpha * X, Alpha broadcast against X as
    numpy broadcasts (a [1] alpha for the whole tensor, one of X's
    trailing shape for each element)."""
    x, alpha = first(ins, "X"), first(ins, "Alpha")
    return out(Out=torch.where(x > 0, x, alpha * x))


def _linear_resize_weights(n_in, n_out):
    """[n_in, n_out] f32 weights of jax.image.resize's linear kernel along
    one dim (jax/_src/image/scale.py compute_weight_mat): half-pixel
    centres, the triangle widened by the scale when shrinking
    (antialiasing), each output's weights normalised to sum 1, and an
    output whose sample falls outside the input zero."""
    inv = np.float32(n_in / n_out)
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - dist / kscale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


@register_op("bilinear_interp")
def bilinear_interp_op(ctx, ins, attrs):
    """Resize NCHW X to [out_h, out_w] as jax.image.resize(method=
    "bilinear") does, which the JAX package calls: half-pixel centres
    (align_corners off), edge samples renormalised, antialiased when
    shrinking. Each resized dim is one product with its weight matrix,
    made on the host from the static sizes and held on the device
    (RandomStream.held). OutSize is read on the host when the attrs leave
    the size unset: an eager step only, as under the JAX package's jit."""
    x = first(ins, "X")
    h, w = attrs.get("out_h"), attrs.get("out_w")
    out_size = first(ins, "OutSize")
    if out_size is not None and (h is None or w is None):
        h, w = (int(v) for v in out_size.reshape(-1)[:2].tolist())
    o = x
    for dim, (n_in, n_out) in ((2, (x.shape[2], h)), (3, (x.shape[3], w))):
        if n_in == n_out:
            continue
        wm = ctx.rng.held(("bilinear_interp", n_in, n_out),
                          lambda: torch.from_numpy(_linear_resize_weights(
                              n_in, n_out)).to(ctx.device))
        o = torch.movedim(torch.matmul(torch.movedim(o, dim, -1),
                                       wm.to(o.dtype)), -1, dim)
    return out(Out=o)


@register_op("row_conv", lod_aware=True)
def row_conv_op(ctx, ins, attrs):
    """Lookahead convolution (reference operators/row_conv_op.cc): token
    t's output sums Filter[i] * X[t + i] over the `future_context_size` + 1
    rows, within its own sequence (a SeqTensor), or over the padded rows
    of a dense X."""
    x, w = first(ins, "X"), first(ins, "Filter")
    future = w.shape[0]
    data = x.data if isinstance(x, SeqTensor) else x
    n = data.shape[0]
    if isinstance(x, SeqTensor):
        seg = x.segment_ids()
        o = torch.zeros_like(data)
        for i in range(future):
            shifted_seg = torch.cat([seg[i:], seg.new_full((i,), -1)])
            m = (shifted_seg == seg)[:, None].to(data.dtype)
            shifted = F.pad(data[i:], (0, 0, 0, i))
            o = o + shifted * w[i][None, :] * m
        return out(Out=SeqTensor(o, x.lengths))
    padded = F.pad(data, (0, 0, 0, future - 1))
    return out(Out=sum(padded[i:i + n] * w[i][None, :]
                       for i in range(future)))


@register_op("im2sequence", lod_aware=True)
def im2sequence_op(ctx, ins, attrs):
    """reference operators/im2sequence_op.cc: each NCHW image becomes one
    sequence of its flattened [C, kh, kw] patches, row-major over the
    output positions."""
    x = first(ins, "X")
    kh, kw = attrs.get("kernels", [1, 1])
    sh, sw = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0, 0, 0])
    n, c = x.shape[:2]
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))  # [N, C*kh*kw, L]
    seq = patches.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)
    return out(Out=SeqTensor(seq, torch.full((n,), oh * ow,
                                             dtype=torch.int32,
                                             device=x.device)))


@register_op("spp")
def spp_op(ctx, ins, attrs):
    """Spatial pyramid pooling (reference operators/spp_op.{cc,h}): level
    p pools X [N, C, H, W] onto a 2^p x 2^p grid with ksize = ceil(dim /
    bins) and the reference's centring padding (an average counts only
    the real elements of its window); the flattened levels are
    concatenated to [N, C * (4^P - 1) / 3]."""
    x = first(ins, "X")
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape
    levels = []
    for p in range(int(attrs.get("pyramid_height", 1))):
        bins = 2 ** p
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pad = (pw, kw * bins - w - pw, ph, kh * bins - h - ph)
        if ptype == "max":
            lvl = F.max_pool2d(F.pad(x, pad, value=-math.inf), (kh, kw))
        else:
            s = F.avg_pool2d(F.pad(x, pad), (kh, kw), divisor_override=1)
            ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype,
                                    device=x.device), pad)
            lvl = s / F.avg_pool2d(ones, (kh, kw), divisor_override=1)
        levels.append(lvl.reshape(n, c * bins * bins))
    return out(Out=torch.cat(levels, dim=1))


@register_op("unpool")
def unpool_op(ctx, ins, attrs):
    """Max-unpool 2-d (reference operators/unpool_op.{cc,h}): each pooled
    value goes to the position its flat index names in the unpooled
    H * W plane, zeros elsewhere; one scatter. Indices are expected
    distinct within a plane (max pooling's), as in the JAX package, where
    a repeated one keeps an unspecified value."""
    x, idx = first(ins, "X"), first(ins, "Indices")
    n, c, h, w = x.shape
    ksize = attrs["ksize"]
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0])
    ho = (h - 1) * strides[0] - 2 * pads[0] + ksize[0]
    wo = (w - 1) * strides[1] - 2 * pads[1] + ksize[1]
    o = x.new_zeros((n, c, ho * wo)).scatter(
        2, idx.reshape(n, c, h * w).long(), x.reshape(n, c, h * w))
    return out(Out=o.reshape(n, c, ho, wo))
