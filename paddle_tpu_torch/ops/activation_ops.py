"""Activation ops (reference operators/activation_op.cc). Gradients come
from the registry's derived-grad fallback. The port carries the
activations its training slice reaches; softmax lives in nn_ops."""

import torch

from ..core.registry import register_op
from .util import first, out


@register_op("relu")
def relu_op(ctx, ins, attrs):
    return out(Out=torch.relu(first(ins, "X")))
