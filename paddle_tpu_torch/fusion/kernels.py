"""Hand-written CUDA kernels for the horizontal fused weight update, each
with its plain torch twin.

`momentum_bucket` and `adam_bucket` replace the JAX package's Pallas TPU
kernels (paddle_tpu/fusion/kernels.py::momentum_bucket and ::adam_bucket),
which view one flat f32 lane holding every member back to back as
zero-padded (8, 128) VMEM blocks. The CUDA kernels (csrc/fused_update.cu,
bound to PyTorch by csrc/kernels_binding.cpp) are bound by bytes: 20 B
per element for momentum, 28 B for adam (26 B with a bf16 gradient).

- `momentum_bucket(p, g, v, ...)` and `adam_bucket(p, g, m1, m2, ...)`
  take flat f32 lanes and return fresh ones (the TPU kernels' signature).
- `adam_bucket_(params, grads, m1s, m2s, ...)` updates a bucket's member
  tensors in place and returns nothing: the adam kernel walks a table of
  the members where they lie, grads f32 or bf16, so the fused op needs no
  pack before it and no copy back after. `plan_adam_bucket` states what
  it takes and refuses the rest with a ValueError on either device.

Dispatch: a bucket on a CUDA device launches the kernel (and counts each
launch on `momentum_bucket.launches` / `adam_bucket.launches`); a bucket
on the CPU takes the plain twin. `*_cuda` are the kernel entry points
proper: they raise on anything the kernel does not take — a CPU tensor
included, before anything is built — instead of computing.
The twins repeat the scalar ops' torch expressions (ops/optimizer_ops.py),
so on the card the kernel is held bitwise against them.
"""

import torch

from .. import cuda_build

__all__ = ["momentum_bucket", "adam_bucket", "adam_bucket_",
           "momentum_bucket_plain", "adam_bucket_plain", "adam_bucket_plain_",
           "momentum_bucket_cuda", "adam_bucket_cuda", "adam_bucket_cuda_",
           "plan_adam_bucket"]

def _check(name, lanes, scalar):
    """Refuse operands off one CUDA device before anything is built; the
    binding checks dtype, shape and contiguity. Returns the lane length."""
    dev = lanes[0].device
    for t in list(lanes) + [scalar]:
        if not t.is_cuda or t.device != dev:
            raise ValueError(
                f"{name}: every operand must be on {dev} (CUDA), got "
                f"{t.device}")
    return lanes[0].numel()


# ---------------------------------------------------------------------------
# momentum
# ---------------------------------------------------------------------------
def momentum_bucket_plain(p, g, v, lr, mu, nesterov):
    """v' = mu*v + g; p' = p - lr*v' (Nesterov: p - (g + mu*v')*lr)."""
    v_out = mu * v + g
    if nesterov:
        return p - (g + mu * v_out) * lr, v_out
    return p - lr * v_out, v_out


def momentum_bucket_cuda(p, g, v, lr, mu, nesterov):
    n = _check("momentum_bucket", (p, g, v), lr)
    p_out, v_out = cuda_build.kernels().momentum_bucket(p, g, v, lr, mu,
                                                        bool(nesterov))
    if n:
        momentum_bucket.launches += 1
    return p_out, v_out


def momentum_bucket(p, g, v, lr, mu, nesterov):
    """Fused momentum over one flat f32 bucket. p/g/v: [n] f32; lr: f32
    one-element tensor; mu: python float; nesterov: bool. Returns
    (param_out[n], velocity_out[n])."""
    if p.is_cuda:
        return momentum_bucket_cuda(p, g, v, lr, mu, nesterov)
    return momentum_bucket_plain(p, g, v, lr, mu, nesterov)


cuda_build.count_launches(momentum_bucket, "launches")


# ---------------------------------------------------------------------------
# adam
# ---------------------------------------------------------------------------
def adam_bucket_plain(p, g, m1, m2, lr_t, b1, b2, eps):
    """m1' = b1*m1 + (1-b1)*g; m2' = b2*m2 + (1-b2)*g*g;
    p' = p - lr_t*m1'/(sqrt(m2') + eps)."""
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * (g * g)
    return p - lr_t * m1o / (torch.sqrt(m2o) + eps), m1o, m2o


def adam_bucket_cuda(p, g, m1, m2, lr_t, b1, b2, eps):
    n = _check("adam_bucket", (p, g, m1, m2), lr_t)
    # (1 - b1) and (1 - b2) in python doubles, then f32 — where the scalar
    # op's torch expression evaluates them
    outs = cuda_build.kernels().adam_bucket(p, g, m1, m2, lr_t, b1, 1 - b1,
                                            b2, 1 - b2, eps)
    if n:
        adam_bucket.launches += 1
    return tuple(outs)


def adam_bucket(p, g, m1, m2, lr_t, b1, b2, eps):
    """Fused adam over one flat f32 bucket. p/g/m1/m2: [n] f32; lr_t: f32
    one-element tensor (bias-corrected step size, computed by the caller
    with the scalar op's expression); b1/b2/eps: python floats. Returns
    (param_out[n], m1_out[n], m2_out[n])."""
    if p.is_cuda:
        return adam_bucket_cuda(p, g, m1, m2, lr_t, b1, b2, eps)
    return adam_bucket_plain(p, g, m1, m2, lr_t, b1, b2, eps)


cuda_build.count_launches(adam_bucket, "launches")


def plan_adam_bucket(params, grads, m1s, m2s, lr_t):
    """Check one bucket for the in-place update and return its device.
    Every member's p, m1 and m2 are f32 and its g f32 or bf16, the four of
    one shape, contiguous and on the device of the first p; lr_t is one
    f32 element there; and no two operands of the bucket share a byte of
    memory — an update in place would otherwise depend on the order of
    the writes. Raises ValueError on anything else."""
    if not params or not len(params) == len(grads) == len(m1s) == len(m2s):
        raise ValueError(
            f"adam_bucket_: one p, g, m1 and m2 for every member, got "
            f"{len(params)}, {len(grads)}, {len(m1s)} and {len(m2s)}")
    dev = params[0].device
    spans = []
    for k, member in enumerate(zip(params, grads, m1s, m2s)):
        for name, t in zip(("p", "g", "m1", "m2"), member):
            if t.device != dev:
                raise ValueError(f"adam_bucket_: member {k}'s {name} is on "
                                 f"{t.device}, the bucket on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"adam_bucket_: member {k}'s {name} is not "
                                 f"contiguous")
            if t.shape != member[0].shape:
                raise ValueError(
                    f"adam_bucket_: member {k}'s {name} is "
                    f"{tuple(t.shape)}, its p {tuple(member[0].shape)}")
            ok = ((torch.float32, torch.bfloat16) if name == "g"
                  else (torch.float32,))
            if t.dtype not in ok:
                raise ValueError(f"adam_bucket_: member {k}'s {name} is "
                                 f"{t.dtype}, not one of {ok}")
            if t.numel():  # its bytes [start, end)
                start = t.data_ptr()
                spans.append((start, start + t.numel() * t.element_size(),
                              k, name))
    spans.sort()
    for (_, end, k, a), (start, _, j, b) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError(f"adam_bucket_: member {k}'s {a} and member "
                             f"{j}'s {b} share memory")
    if (lr_t.device != dev or lr_t.dtype != torch.float32
            or lr_t.numel() != 1):
        raise ValueError(f"adam_bucket_: lr_t must be one f32 element on "
                         f"{dev}, got {lr_t.dtype}{tuple(lr_t.shape)} on "
                         f"{lr_t.device}")
    return dev


def adam_bucket_plain_(params, grads, m1s, m2s, lr_t, b1, b2, eps):
    """adam_bucket_'s plain twin: adam_bucket_plain over the members packed
    into flat lanes (grads widened to f32, which is exact), the results
    copied back into the members."""
    plan_adam_bucket(params, grads, m1s, m2s, lr_t)

    def lane(ts):
        return torch.cat([t.reshape(-1).float() for t in ts])

    outs = adam_bucket_plain(lane(params), lane(grads), lane(m1s), lane(m2s),
                             lr_t, b1, b2, eps)
    off = 0
    for p, m1, m2 in zip(params, m1s, m2s):
        n = p.numel()
        for dst, src in zip((p, m1, m2), outs):
            dst.copy_(src[off:off + n].view(dst.shape))
        off += n


def adam_bucket_cuda_(params, grads, m1s, m2s, lr_t, b1, b2, eps):
    if plan_adam_bucket(params, grads, m1s, m2s, lr_t).type != "cuda":
        raise ValueError(f"adam_bucket_: the kernel takes a bucket on a CUDA "
                         f"device, got {params[0].device}")
    adam_bucket.launches += cuda_build.kernels().adam_bucket_(
        list(params), list(grads), list(m1s), list(m2s), lr_t, b1, 1 - b1,
        b2, 1 - b2, eps)


def adam_bucket_(params, grads, m1s, m2s, lr_t, b1, b2, eps):
    """Fused adam over a bucket's member tensors, in place: params[k],
    m1s[k] and m2s[k] (f32) take their new values from grads[k] (f32 or
    bf16) as adam_bucket would compute them over the packed lanes.
    lr_t: f32 one-element tensor; b1/b2/eps: python floats. On a CUDA
    device one kernel launch covers the bucket (several only past the
    kernel's table of members, each counted on adam_bucket.launches)."""
    if params and params[0].is_cuda:
        return adam_bucket_cuda_(params, grads, m1s, m2s, lr_t, b1, b2, eps)
    return adam_bucket_plain_(params, grads, m1s, m2s, lr_t, b1, b2, eps)


def reset_launch_counts():
    momentum_bucket.launches = 0
    adam_bucket.launches = 0
