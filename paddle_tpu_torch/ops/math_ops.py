"""Math ops: the fc core and matmul, the elementwise family, scale, mean,
grad summation, the reductions, clipping, cos_sim, cumsum, norm, top_k and
maxout.

Reference parity: operators/mul_op.cc, matmul_op.cc, elementwise_*_op.cc,
scale_op.cc, mean_op.cc, sum_op.cc, reduce_op.cc, clip_op.cc,
clip_by_norm_op.cc, cos_sim_op.cc, cumsum_op.cc, norm_op.cc, topk_op.cc,
maxout_op.cc.
Matrix products go to torch.matmul (cuBLAS on the card), as the JAX
package leaves them to XLA. Each op keeps the JAX package's expression
(paddle_tpu/ops/math_ops.py), its defaults and its output shapes; an
integer result keeps its input's dtype where the JAX package's does.
"""

import math

import torch

from ..core.registry import SeqTensor, register_op
from .collective_ops import psum_replicated
from .util import first, many, out, bcast_y_to_x


def _matmul(a, b):
    """The JAX package's product: operands promoted to one dtype; a bf16
    or f16 product accumulates in f32 (cuBLAS does) and comes back in
    a's dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    o = torch.matmul(a.to(dt), b.to(dt))
    if a.dtype in (torch.bfloat16, torch.float16):
        o = o.to(a.dtype)
    return o


@register_op("mul")
def mul_op(ctx, ins, attrs):
    """reference operators/mul_op.cc — flatten-to-2D matmul (the fc core)."""
    x, y = first(ins, "X"), first(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xn]) if xn else 1, -1)
    y2 = y.reshape(-1, math.prod(ys[yn:]) if yn < len(ys) else 1)
    o = torch.matmul(x2, y2)
    return out(Out=o.reshape(xs[:xn] + ys[yn:]))


@register_op("matmul")
def matmul_op(ctx, ins, attrs):
    """reference operators/matmul_op.cc: batched, with transpose flags and
    `alpha`; a rank-1 operand is a row (X) or a column (Y) that the result
    drops again, and a scalar result is {1} (fluid has no 0-d tensors)."""
    x, y = first(ins, "X"), first(ins, "Y")
    squeeze_x, squeeze_y = x.ndim == 1, y.ndim == 1
    if squeeze_x:
        x = x[None, :]
    if squeeze_y:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    o = _matmul(x, y)
    if squeeze_x:
        o = o.squeeze(-2)
    if squeeze_y:
        o = o.squeeze(-1)
    if o.ndim == 0:
        o = o.reshape(1)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        o = o * alpha
    return out(Out=o)


def _ew(fn):
    def kernel(ctx, ins, attrs):
        x, y = first(ins, "X"), first(ins, "Y")
        yb = bcast_y_to_x(x, y, attrs.get("axis", -1))
        return out(Out=fn(x, yb))

    return kernel


for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum),
    ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
]:
    register_op(_name)(_ew(_fn))


@register_op("sum")
def sum_op(ctx, ins, attrs):
    """reference operators/sum_op.cc — add N tensors (grad accumulation).
    Tensor arrays (the grads of two reads of one array) merge slot by
    slot; a slot only one of them holds rides through. SelectedRows
    (sparse gradients) follow the reference's SelectedRowsAddTo: all
    sparse stays sparse (rows and values concatenated, duplicates left
    for the consumer to merge); a mix with dense tensors densifies."""
    xs = many(ins, "X")
    from ..core.selected_rows import SelectedRows
    from .control_flow_ops import TensorArray

    if any(isinstance(x, TensorArray) for x in xs):
        merged = TensorArray()
        for x in xs:
            if not isinstance(x, TensorArray):
                raise TypeError(
                    "sum: cannot mix tensor arrays with dense tensors")
            for idx, item in enumerate(x.items):
                if item is not None:
                    prev = merged.items[idx] if idx < len(merged) else None
                    merged.write(idx, item if prev is None else prev + item)
        return out(Out=merged)
    if any(isinstance(x, SelectedRows) for x in xs):
        if all(isinstance(x, SelectedRows) for x in xs):
            return out(Out=SelectedRows(
                torch.cat([x.rows.reshape(-1) for x in xs]),
                torch.cat([x.values for x in xs]), xs[0].height))
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x
              for x in xs]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return out(Out=acc)


@register_op("scale")
def scale_op(ctx, ins, attrs):
    x = first(ins, "X")
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    from ..core.selected_rows import SelectedRows

    if isinstance(x, SelectedRows):  # a sparse grad's scaling (pserver)
        if b != 0.0:
            raise ValueError("scale with a bias is undefined on SelectedRows")
        v = x.values
        return out(Out=SelectedRows(x.rows, (v * s).to(v.dtype), x.height))
    o = x * s + b if attrs.get("bias_after_scale", True) else (x + b) * s
    return out(Out=o.to(x.dtype))


@register_op("mean", lod_aware=True)
def mean_op(ctx, ins, attrs):
    """fluid has no 0-d tensors: mean_op.cc infers Out as {1}. Over a
    SeqTensor the mean is over its real tokens only: a bucket-padded one
    (create_bucketed_seq_tensor) carries tail rows past sum(lengths) that
    do not count. Without padding the mask is all true and this is the
    plain mean. Under ParallelExecutor (ctx.dp) it is the global batch's
    mean; over a SeqTensor that is the sum over the ranks' real tokens
    over their count, both summed over the ranks (their token counts
    differ, so it is not the mean of the ranks' means), and each real
    token's cotangent is 1 / the global count, with no collective."""
    x = first(ins, "X")
    if isinstance(x, SeqTensor):
        data = x.data
        m = x.token_mask().reshape((-1,) + (1,) * (data.ndim - 1))
        total = torch.sum(torch.where(m, data.to(torch.float32), 0.0))
        denom = torch.sum(m).to(torch.float32) * float(
            math.prod(data.shape[1:]) or 1)
        if ctx.dp is not None:
            both = psum_replicated(torch.stack([total, denom]), ctx.dp)
            total, denom = both[0], both[1]
        return out(Out=(total / torch.clamp_min(denom, 1.0))
                   .to(data.dtype).reshape(1))
    m = x.mean().reshape(1)
    if ctx.dp is not None:
        # the global batch's mean: every rank holds an equal share of the
        # batch (ParallelExecutor splits it evenly) and a replicated tensor
        # is the same everywhere, so it is the mean of the ranks' means —
        # at one rank exactly the plain Executor's value. The loss's
        # cotangent is the same on every rank: each local element takes
        # 1/(n*size) with no collective, and a parameter's gradient is its
        # rank's part of the sum that ParallelExecutor's all-reduce adds up
        m = psum_replicated(m, ctx.dp) / ctx.dp.size
    return out(Out=m)


def _int_result(x):
    """The dtype an integer reduction or scan keeps: the input's (torch
    would widen to int64); bool counts as the default integer."""
    return torch.int64 if x.dtype == torch.bool else x.dtype


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _mean(x, dim, keepdim):
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _reduce(fn, keeps_int):
    def kernel(ctx, ins, attrs):
        """reference operators/reduce_op.cc: over `dim` (default {0}), or
        every dim with reduce_all; a full reduce is {1}."""
        x = first(ins, "X")
        if attrs.get("reduce_all", False):
            axis = tuple(range(x.ndim))
        else:
            dim = attrs.get("dim", 0)
            axis = tuple(sorted({d % x.ndim for d in (
                dim if isinstance(dim, (list, tuple)) else [dim])}))
        if not axis:
            o = x.clone()
        else:
            o = fn(x, axis, attrs.get("keep_dim", False))
            if keeps_int and not x.dtype.is_floating_point:
                o = o.to(_int_result(x))
        return out(Out=o.reshape(1) if o.ndim == 0 else o)

    return kernel


for _name, _fn, _keeps_int in [
    ("reduce_sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k), True),
    ("reduce_mean", _mean, False),
    ("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k), False),
    ("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k), False),
    ("reduce_prod", _prod, True),
]:
    register_op(_name)(_reduce(_fn, _keeps_int))


@register_op("clip")
def clip_op(ctx, ins, attrs):
    return out(Out=torch.clamp(first(ins, "X"), attrs["min"], attrs["max"]))


@register_op("clip_by_norm")
def clip_by_norm_op(ctx, ins, attrs):
    """X scaled down to an L2 norm of `max_norm` when its norm is larger;
    the norm stays on the device (no host read)."""
    x = first(ins, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return out(Out=x * scale.to(x.dtype))


@register_op("cos_sim")
def cos_sim_op(ctx, ins, attrs):
    """reference operators/cos_sim_op.cc; Y may be one row, broadcast."""
    x, y = first(ins, "X"), first(ins, "Y")
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    num = torch.sum(x * y, dim=-1, keepdim=True)
    o = num / torch.clamp_min(xn * yn, 1e-12)
    return out(Out=o, XNorm=xn, YNorm=yn)


@register_op("cumsum")
def cumsum_op(ctx, ins, attrs):
    x = first(ins, "X")
    axis = attrs.get("axis", -1)
    exclusive = attrs.get("exclusive", False)
    reverse = attrs.get("reverse", False)
    if reverse:
        x = torch.flip(x, (axis,))
    dt = None if x.dtype.is_floating_point else _int_result(x)
    o = torch.cumsum(x, dim=axis, dtype=dt)
    if exclusive:
        o = o - x
    if reverse:
        o = torch.flip(o, (axis,))
    return out(Out=o)


@register_op("maxout")
def maxout_op(ctx, ins, attrs):
    """NCHW X's channels in `groups`-sized runs, each run's maximum."""
    x = first(ins, "X")
    g = attrs["groups"]
    n, c, h, w = x.shape
    return out(Out=torch.amax(x.reshape(n, c // g, g, h, w), dim=2))


@register_op("norm")
def norm_op(ctx, ins, attrs):
    """reference operators/norm_op.cc: X over its L2 norm along `axis`
    (default 1), with `epsilon` under the root."""
    x = first(ins, "X")
    axis = attrs.get("axis", 1)
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                      + eps)
    return out(Out=x / norm, Norm=norm)


@register_op("top_k")
def top_k_op(ctx, ins, attrs):
    """The k largest values along the last axis, in descending order, and
    their int64 indices (the JAX package narrows them to int32: x64 is off
    there)."""
    vals, idx = torch.topk(first(ins, "X"), attrs["k"], dim=-1)
    return out(Out=vals, Indices=idx)
