"""Optimizer ops — parameter updates expressed as IR ops, exactly like the
reference (operators/{sgd,momentum,adam,adamax,adagrad,decayed_adagrad,
adadelta,rmsprop,ftrl,proximal_gd,proximal_adagrad}_op.cc). Each keeps the JAX
package's expression tree operation for operation (operand order, cast
positions, python-float constants), so the fused bucket kernels can be
held bitwise against them.
"""

import torch

from ..core.registry import register_op
from .util import first, out


@register_op("sgd")
def sgd_op(ctx, ins, attrs):
    p, g, lr = first(ins, "Param"), first(ins, "Grad"), first(ins, "LearningRate")
    return out(ParamOut=p - lr.reshape(()).to(p.dtype) * g.to(p.dtype))


@register_op("momentum")
def momentum_op(ctx, ins, attrs):
    p, g, v = first(ins, "Param"), first(ins, "Grad"), first(ins, "Velocity")
    lr = first(ins, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs["mu"]
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return out(ParamOut=p_out, VelocityOut=v_out)


@register_op("adam")
def adam_op(ctx, ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = first(ins, "LearningRate").reshape(()).to(torch.float32)
    m1, m2 = first(ins, "Moment1"), first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(()).to(torch.float32)
    b2p = first(ins, "Beta2Pow").reshape(()).to(torch.float32)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = g.to(torch.float32)
    m1o = b1 * m1 + (1 - b1) * gf
    m2o = b2 * m2 + (1 - b2) * (gf * gf)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p.to(torch.float32) - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return out(ParamOut=p_out.to(p.dtype), Moment1Out=m1o, Moment2Out=m2o)


def _lr(ins):
    return first(ins, "LearningRate").reshape(()).to(torch.float32)


@register_op("adamax")
def adamax_op(ctx, ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = _lr(ins)
    m, inf = first(ins, "Moment"), first(ins, "InfNorm")
    b1p = first(ins, "Beta1Pow").reshape(()).to(torch.float32)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = g.to(torch.float32)
    m_out = b1 * m + (1 - b1) * gf
    inf_out = torch.maximum(b2 * inf, torch.abs(gf))
    p_out = p.to(torch.float32) - (lr / (1 - b1p)) * (m_out / (inf_out + eps))
    return out(ParamOut=p_out.to(p.dtype), MomentOut=m_out,
               InfNormOut=inf_out)


@register_op("adagrad")
def adagrad_op(ctx, ins, attrs):
    p, g, mom = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    lr = _lr(ins)
    eps = attrs.get("epsilon", 1e-6)
    gf = g.to(torch.float32)
    mom_out = mom + torch.square(gf)
    p_out = p.to(torch.float32) - lr * gf / (torch.sqrt(mom_out) + eps)
    return out(ParamOut=p_out.to(p.dtype), MomentOut=mom_out)


@register_op("decayed_adagrad")
def decayed_adagrad_op(ctx, ins, attrs):
    p, g, mom = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    lr = _lr(ins)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    gf = g.to(torch.float32)
    mom_out = decay * mom + (1 - decay) * torch.square(gf)
    p_out = p.to(torch.float32) - lr * gf / (torch.sqrt(mom_out) + eps)
    return out(ParamOut=p_out.to(p.dtype), MomentOut=mom_out)


@register_op("adadelta")
def adadelta_op(ctx, ins, attrs):
    """No learning rate: the step is sqrt((E[dx²] + eps) / (E[g²] + eps))
    times the gradient."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    asg, asu = first(ins, "AvgSquaredGrad"), first(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    gf = g.to(torch.float32)
    asg_out = rho * asg + (1 - rho) * torch.square(gf)
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * gf
    asu_out = rho * asu + (1 - rho) * torch.square(update)
    return out(ParamOut=(p.to(torch.float32) + update).to(p.dtype),
               AvgSquaredGradOut=asg_out, AvgSquaredUpdateOut=asu_out)


@register_op("rmsprop")
def rmsprop_op(ctx, ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    ms, mom = first(ins, "MeanSquare"), first(ins, "Moment")
    lr = _lr(ins)
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    momentum = attrs.get("momentum", 0.0)
    gf = g.to(torch.float32)
    ms_out = decay * ms + (1 - decay) * torch.square(gf)
    mom_out = momentum * mom + lr * gf / torch.sqrt(ms_out + eps)
    return out(ParamOut=(p.to(torch.float32) - mom_out).to(p.dtype),
               MeanSquareOut=ms_out, MomentOut=mom_out)


@register_op("ftrl")
def ftrl_op(ctx, ins, attrs):
    """FTRL-proximal; `lr_power` is negative (default -0.5), so the
    accumulators are raised to -lr_power."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    sq, lin = first(ins, "SquaredAccumulator"), first(ins, "LinearAccumulator")
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    gf = g.to(torch.float32)
    new_sq = sq + torch.square(gf)
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    lin_out = lin + gf - sigma * p.to(torch.float32)
    x = torch.clamp(lin_out, -l1, l1) - lin_out
    y = torch.pow(new_sq, -power) / lr + 2 * l2
    return out(ParamOut=(x / y).to(p.dtype), SquaredAccumOut=new_sq,
               LinearAccumOut=lin_out)


def _soft_threshold(prox, lr, l1, l2):
    """The proximal operator of l1/l2 regularization (reference
    proximal_gd_op.h:49-58): soft-threshold by lr*l1, shrink by 1+lr*l2."""
    if l1 > 0:
        return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1,
                                                   0.0)
                / (1.0 + lr * l2))
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd")
def proximal_gd_op(ctx, ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = _lr(ins)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    prox = p.to(torch.float32) - lr * g.to(torch.float32)
    return out(ParamOut=_soft_threshold(prox, lr, l1, l2).to(p.dtype))


@register_op("proximal_adagrad")
def proximal_adagrad_op(ctx, ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    lr = _lr(ins)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    gf = g.to(torch.float32)
    m_out = m + gf * gf
    prox = p.to(torch.float32) - lr * gf / torch.sqrt(m_out)
    return out(ParamOut=_soft_threshold(prox, lr, l1, l2).to(p.dtype),
               MomentOut=m_out)
