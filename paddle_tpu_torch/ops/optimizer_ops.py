"""Optimizer ops — parameter updates expressed as IR ops, exactly like the
reference (operators/{sgd,momentum,adam}_op.cc). Each keeps the JAX
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
