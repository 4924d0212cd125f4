"""NN compute ops: conv2d, pool2d, batch_norm, softmax, cross_entropy,
dropout.

Reference parity: operators/{conv,pool,batch_norm,softmax,cross_entropy,
dropout}_op.cc. Both activation layouts are supported; filters stay OIHW in
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
    are then not produced."""
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
        v = torch.clamp_min(msq - m * m, 0.0)
        mean_out = None if mean is None else mean * momentum + m * (1 - momentum)
        var_out = None if var is None else var * momentum + v * (1 - momentum)
        saved_mean = m
    inv = torch.rsqrt(v.to(torch.float32) + eps)
    y = (xf - m.reshape(shape)) * inv.reshape(shape)
    y = y * scale.reshape(shape) + bias.reshape(shape)
    return out(Y=y.to(x.dtype), MeanOut=mean_out, VarianceOut=var_out,
               SavedMean=saved_mean, SavedVariance=inv.detach())


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
    attr, are the same at every step (tensor_ops.random_draw)."""
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False) or ctx.is_test:
        return out(Out=x * (1.0 - p), Mask=torch.ones_like(x))
    shape = tuple(x.shape)
    u = random_draw(ctx, attrs, ("dropout", shape),
                    lambda g: torch.rand(shape, generator=g,
                                         dtype=torch.float32,
                                         device=ctx.device))
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
