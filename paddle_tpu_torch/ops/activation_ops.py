"""Activation ops (reference operators/activation_op.cc), the JAX
package's family of paddle_tpu/ops/activation_ops.py with the same
expression for each. Gradients come from the registry's derived-grad
fallback, as they do there. softmax lives in nn_ops."""

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .util import first, out


def _act(name, fn):
    @register_op(name)
    def _kernel(ctx, ins, attrs, _fn=fn):
        return out(Out=_fn(first(ins, "X"), attrs))


_act("sigmoid", lambda x, a: torch.sigmoid(x))
_act("logsigmoid", lambda x, a: F.logsigmoid(x))
_act("exp", lambda x, a: torch.exp(x))
_act("relu", lambda x, a: torch.relu(x))
_act("tanh", lambda x, a: torch.tanh(x))
_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_act("softshrink", lambda x, a: torch.sign(x) * torch.clamp_min(
    torch.abs(x) - a.get("lambda", 0.5), 0.0))
_act("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, 0.0))
_act("sqrt", lambda x, a: torch.sqrt(x))
_act("abs", lambda x, a: torch.abs(x))
_act("ceil", lambda x, a: torch.ceil(x))
_act("floor", lambda x, a: torch.floor(x))
_act("round", lambda x, a: torch.round(x))
_act("cos", lambda x, a: torch.cos(x))
_act("sin", lambda x, a: torch.sin(x))
_act("reciprocal", lambda x, a: 1.0 / x)
_act("log", lambda x, a: torch.log(x))
_act("square", lambda x, a: torch.square(x))
# jax.nn.softplus is logaddexp(x, 0)
_act("softplus", lambda x, a: torch.logaddexp(x, torch.zeros_like(x)))
_act("softsign", lambda x, a: x / (1 + torch.abs(x)))
_act("brelu", lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                       a.get("t_max", 24.0)))
_act("leaky_relu", lambda x, a: torch.where(x >= 0, x,
                                            x * a.get("alpha", 0.02)))
_act("soft_relu", lambda x, a: torch.log1p(torch.exp(torch.clamp(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_act("elu", lambda x, a: torch.where(
    x >= 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1)))
_act("relu6", lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)))
_act("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_act("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 2.0 / 3.0) * x))
_act("hard_sigmoid", lambda x, a: torch.clamp(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_act("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, 0.0))
_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
# jax.nn.gelu defaults to the tanh approximation
_act("gelu", lambda x, a: F.gelu(x, approximate="tanh"))
