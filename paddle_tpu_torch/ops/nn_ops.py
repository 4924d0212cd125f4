"""NN compute ops: conv2d, pool2d, batch_norm, softmax, cross_entropy,
the dense losses, dropout.

Reference parity: operators/{conv,pool,batch_norm,softmax,cross_entropy,
softmax_with_cross_entropy,sigmoid_cross_entropy_with_logits,
squared_l2_norm,squared_l2_distance,smooth_l1_loss,huber_loss,hinge_loss,
rank_loss,margin_rank_loss,log_loss,dropout}_op.cc (with
square_error_cost, a layer there), each loss as the JAX package's
paddle_tpu/ops/nn_ops.py computes it. Both activation layouts are supported; filters stay OIHW in
every layout, so parameters (and checkpoints) are layout-independent. In
NHWC the activation is viewed as NCHW around torch's conv/pool calls
without a copy (a channels-last NCHW view), which cuDNN takes natively on
the card.
"""

import math

import torch
import torch.nn.functional as F

from ..backward import _default_grad_maker
from ..core.registry import (register_grad_maker, register_op,
                             set_stop_gradient_outputs)
from .collective_ops import psum
from .tensor_ops import random_draw
from .util import first, out


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
