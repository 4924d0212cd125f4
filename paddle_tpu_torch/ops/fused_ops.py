"""Fused ops emitted by the cost-guided fusion pass (paddle_tpu_torch.fusion).

Reference parity: the reference fuses at the graph level too —
framework/ir/fuse_elewise_add_act_pass and
framework/details/fuse_optimizer_op_pass (fuse_adam_op_pass,
fuse_momentum_op_pass, fuse_sgd_op_pass) rewrite the SSAGraph so one
kernel covers a chain or a whole bucket of parameter updates.

Two families:

* `fused_elementwise` — one op replaying a recorded single-consumer chain
  of elementwise ops through the REAL registered kernels, so the fused
  result is bitwise-identical to the unfused chain by construction.

* `fused_<opt>_update` (sgd / momentum / adam) — ONE update over a bucket
  of same-family parameters. sgd and momentum concatenate their variadic
  slots into a contiguous lane, update it with the exact expression tree
  of the scalar op, and slice it back. Elementwise arithmetic is
  per-element, so the packed update is bitwise-equal to the N separate
  updates.

  attr `shard_rows > 0` marks a zero1 bucket: every member is a
  (parts, shard) shard-layout tensor and the bucket concatenates the
  SHARD lanes on axis 1.

  A momentum bucket goes to fusion.kernels.momentum_bucket: the
  hand-written CUDA kernel when the bucket lives on a CUDA device (no
  fallback: the kernel runs or the step raises — it takes f32 only), its
  plain torch twin when it lives on the CPU. The fused updates are in
  neither amp list, so under bf16 AMP a bucket's gradients arrive in bf16
  (conv and mul grads) or as a bf16/f32 mix that torch.cat promotes; the
  packed gradient is cast to the parameters' dtype first. bf16 -> f32 is
  exact, so this is the JAX package's promoted `mu * v + g` arithmetic.

  An adam bucket is not packed: fusion.kernels.adam_bucket_ updates the
  members IN PLACE (one kernel launch on a CUDA device, the plain twin on
  the CPU), reading each gradient in its own dtype (bf16 widened exactly),
  and the op returns the member tensors themselves as ParamOut /
  Moment1Out / Moment2Out. A zero1 bucket's (parts, shard) members are
  contiguous tensors too, updated the same way. The captured step then
  has nothing to copy back, and the interpreter's write-back rebinds each
  name to the tensor it already holds.
"""

import torch

from ..core import registry
from ..core.registry import register_op
from ..fusion import kernels as fk
from .util import first, many, out


def _pack(vals, rows):
    """Concatenate bucket members into one contiguous lane: shard-layout
    members (rows > 0) join along the shard axis (axis 1), full-shape
    members ravel and join along axis 0."""
    if rows:
        return vals[0] if len(vals) == 1 else torch.cat(vals, dim=1)
    if len(vals) == 1:
        return vals[0].reshape(-1)
    return torch.cat([v.reshape(-1) for v in vals], dim=0)


def _unpack(buf, likes, rows):
    """Slice the packed lane back into per-member tensors shaped like
    `likes` — the exact inverse of _pack."""
    outs, off = [], 0
    for t in likes:
        if rows:
            w = int(t.shape[1])
            outs.append(buf[:, off:off + w])
        else:
            w = t.numel()
            outs.append(buf[off:off + w].reshape(t.shape))
        off += w
    return outs


@register_op("fused_elementwise")
def fused_elementwise_op(ctx, ins, attrs):
    x = first(ins, "X")
    for t, a in zip(attrs["sub_types"], attrs["sub_attrs"]):
        od = registry.lookup(t)
        x = first(registry.run_kernel(od, ctx, {"X": [x]}, dict(a)), "Out")
    return out(Out=x)


@register_op("fused_sgd_update")
def fused_sgd_update_op(ctx, ins, attrs):
    ps, gs = many(ins, "Param"), many(ins, "Grad")
    rows = int(attrs.get("shard_rows", 0))
    p, g = _pack(ps, rows), _pack(gs, rows)
    lr = first(ins, "LearningRate").reshape(()).to(p.dtype)
    p_out = p - lr * g.to(p.dtype)
    return out(ParamOut=_unpack(p_out, ps, rows))


@register_op("fused_momentum_update")
def fused_momentum_update_op(ctx, ins, attrs):
    ps, gs, vs = many(ins, "Param"), many(ins, "Grad"), many(ins, "Velocity")
    rows = int(attrs.get("shard_rows", 0))
    p, v = _pack(ps, rows), _pack(vs, rows)
    g = _pack(gs, rows).to(p.dtype)
    lr = first(ins, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs["mu"]
    nesterov = bool(attrs.get("use_nesterov", False))
    po, vo = fk.momentum_bucket(p.reshape(-1), g.reshape(-1), v.reshape(-1),
                                lr, mu, nesterov)
    p_out, v_out = po.reshape(p.shape), vo.reshape(v.shape)
    return out(ParamOut=_unpack(p_out, ps, rows),
               VelocityOut=_unpack(v_out, vs, rows))


@register_op("fused_adam_update")
def fused_adam_update_op(ctx, ins, attrs):
    ps, gs = many(ins, "Param"), many(ins, "Grad")
    m1s, m2s = many(ins, "Moment1"), many(ins, "Moment2")
    lr = first(ins, "LearningRate").reshape(()).to(torch.float32)
    b1p = first(ins, "Beta1Pow").reshape(()).to(torch.float32)
    b2p = first(ins, "Beta2Pow").reshape(()).to(torch.float32)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    fk.adam_bucket_(ps, [g.contiguous() for g in gs], m1s, m2s, lr_t, b1, b2,
                    eps)
    return out(ParamOut=ps, Moment1Out=m1s, Moment2Out=m2s)
