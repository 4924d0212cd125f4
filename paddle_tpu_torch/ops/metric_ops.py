"""Metric ops (reference operators/accuracy_op.cc; the JAX package's
paddle_tpu/ops/metric_ops.py). The port carries `accuracy`, which the
image-classification models call; auc, precision_recall, edit_distance
and chunk_eval come with the slices that use them."""

import torch

from ..core.registry import register_op, set_stop_gradient_outputs
from .collective_ops import psum
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
