"""Automatic mixed precision: bf16 compute with fp32 master state.

Reference parity: paddle/contrib/float16/float16_transpiler.py:1 — a program
rewrite that inserts cast ops around float16-capable ops and converts
parameters. The port applies the same dtype policy as the JAX package
(paddle_tpu/amp.py): the executor casts an op's inputs right before its
kernel runs (core/registry.py::run_kernel), so one program runs fp32 or
bf16 without cloning, and on the card the casts are captured into the step's
CUDA graph with everything else.

Recipe:
  * white-list ops (matmul/conv/pool/activations — where the tensor-core
    FLOPs are) cast float32 inputs down to the compute dtype; their outputs
    stay bf16 so whole residual chains flow at half the memory traffic;
  * black-list ops (losses, softmax, reductions, optimizer updates,
    metrics) cast bf16 inputs up to float32 — parameters and optimizer
    accumulators therefore remain fp32 "master weights" and every state
    update happens in fp32;
  * batch_norm/layer_norm are dtype-preserving but compute their
    statistics in fp32 internally (ops/nn_ops.py), so they stay neutral;
  * bf16 shares float32's exponent range, so no loss scaling is required
    (`scale_loss` exists for float16 experiments).

Gradient ops inherit the classification of their forward op (`mul_grad`
follows `mul`), so the backward pass mirrors the forward dtype flow and
parameter gradients are upcast exactly once, at the optimizer/sum boundary.
The fused bucket updates (ops/fused_ops.py) are in neither list, as in the
JAX package: momentum and sgd cast their packed gradient to the
parameters' dtype, adam widens each bf16 gradient as it reads it.
"""

import contextlib

import torch

from .core import dtypes

__all__ = ["auto_cast", "enable", "disable", "is_enabled", "fingerprint",
           "WHITE_LIST", "BLACK_LIST", "scale_loss"]

# Ops whose float inputs are cast DOWN to the compute dtype: tensor-core
# compute, memory-bound activations, and the elementwise glue between them.
# Pure data-movement ops (reshape/transpose/concat/...) are deliberately
# absent — they preserve whatever dtype arrives, so the bf16 flow rides
# through them without risking a downcast of unrelated fp32 tensors (LR
# schedules etc.).
WHITE_LIST = frozenset({
    "mul", "matmul", "fc",
    "conv2d", "conv3d", "conv2d_transpose", "depthwise_conv2d",
    "pool2d", "maxout",
    "relu", "relu6", "leaky_relu", "brelu", "prelu", "tanh", "sigmoid",
    "elu", "soft_relu",
    "dropout",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "lstm", "gru", "lstm_unit", "gru_unit", "sequence_conv", "row_conv",
    "attention_lstm_decoder", "im2sequence",
})

# Ops whose bf16 inputs are cast UP to float32 (numerics-sensitive math,
# gradient accumulation, every optimizer/state update, metrics).
BLACK_LIST = frozenset({
    "softmax", "sequence_softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "huber_loss", "hinge_loss",
    "smooth_l1_loss", "log_loss", "rank_loss", "margin_rank_loss",
    "square_error_cost", "squared_l2_distance", "squared_l2_norm",
    "cos_sim", "cumsum",
    "mean",
    # NOTE: "sum" (elementwise multi-input add — residual-junction grad
    # accumulation) is deliberately NEUTRAL: upcasting every activation-grad
    # merge to fp32 doubles memory traffic on the backward pass, and a
    # 2-term bf16 add loses nothing. Param-grad sums still end in a black
    # optimizer op, so master updates stay fp32.
    "norm", "lrn",
    "clip_by_norm", "isfinite",
    "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
    "decayed_adagrad", "rmsprop", "ftrl",
    "accuracy", "auc", "precision_recall", "edit_distance", "chunk_eval",
    "exp", "log", "sqrt", "reciprocal", "pow", "softplus",
})

_state = {
    "enabled": False,
    "dtype": "bfloat16",
    "white": WHITE_LIST,
    "black": BLACK_LIST,
}


def enable(dtype="bfloat16", custom_white_list=None, custom_black_list=None):
    """Turn the mixed-precision policy on for subsequent executor runs.

    custom_white_list / custom_black_list EXTEND the defaults (an op may be
    moved between lists by naming it in the other one — explicit custom
    entries win over the defaults)."""
    white = set(WHITE_LIST)
    black = set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    _state.update(enabled=True, dtype=dtype,
                  white=frozenset(white), black=frozenset(black))


def disable():
    _state["enabled"] = False


def is_enabled():
    return _state["enabled"]


def fingerprint():
    """Hashable policy signature — part of every executor cache key (a
    step prepared or captured for fp32 must not serve a bf16 run). Sorted
    tuples, not hash(frozenset), so the signature is the same in every
    process."""
    if not _state["enabled"]:
        return ("amp-off",)
    return ("amp", _state["dtype"],
            tuple(sorted(_state["white"])), tuple(sorted(_state["black"])))


@contextlib.contextmanager
def auto_cast(enabled=True, dtype="bfloat16",
              custom_white_list=None, custom_black_list=None):
    """Context manager; the policy is read when each op runs, so wrap the
    exe.run calls (reference fluid.amp.auto_cast)."""
    prev = dict(_state)
    try:
        if enabled:
            enable(dtype, custom_white_list, custom_black_list)
        else:
            disable()
        yield
    finally:
        _state.update(prev)


# ---------------------------------------------------------------------------
# Cast application (called from core.registry.run_kernel)
# ---------------------------------------------------------------------------
def _base_type(op_type):
    return op_type[:-5] if op_type.endswith("_grad") else op_type


def _cast_value(v, target, only_from=None):
    """Cast a float tensor (or SeqTensor data) to `target`; ints/bools and
    None pass through. `only_from` restricts which source dtypes convert.
    A SelectedRows casts its values (the JAX package's branch)."""
    from .core.registry import SeqTensor
    from .core.selected_rows import SelectedRows

    if v is None:
        return v
    if isinstance(v, SeqTensor):
        d = _cast_value(v.data, target, only_from)
        return v if d is v.data else SeqTensor(d, v.lengths)
    if isinstance(v, SelectedRows):
        d = _cast_value(v.values, target, only_from)
        return v if d is v.values else SelectedRows(v.rows, d, v.height)
    if not isinstance(v, torch.Tensor) or not v.dtype.is_floating_point:
        return v
    name = dtypes.canonicalize(v.dtype)
    if only_from is not None and name not in only_from:
        return v
    if name == target:
        return v
    return v.to(dtypes.to_torch(target))


def apply_policy(op_type, ins):
    """Return `ins` with the dtype policy applied for op `op_type`."""
    if not _state["enabled"]:
        return ins
    base = _base_type(op_type)
    if base in _state["white"]:
        target, only_from = _state["dtype"], ("float32", "float64")
    elif base in _state["black"]:
        target, only_from = "float32", ("bfloat16", "float16")
    else:
        return ins
    changed = False
    new_ins = {}
    for slot, vals in ins.items():
        nv = [_cast_value(v, target, only_from) for v in vals]
        changed = changed or any(a is not b for a, b in zip(nv, vals))
        new_ins[slot] = nv
    return new_ins if changed else ins


@contextlib.contextmanager
def scale_loss(loss_scaling=1.0):
    """Loss-scaling hook for float16 experiments (reference float16 needs
    it; bf16 does not — kept for API parity). Yields the scale to multiply
    the loss by; divide gradients by the same factor before applying."""
    yield float(loss_scaling)
