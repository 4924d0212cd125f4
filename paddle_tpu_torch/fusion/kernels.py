"""Hand-written CUDA kernels for the horizontal fused weight update, each
with its plain torch twin.

One bucket = one flat f32 lane holding every member parameter back to
back. `momentum_bucket` and `adam_bucket` replace the JAX package's
Pallas TPU kernels (paddle_tpu/fusion/kernels.py::momentum_bucket and
::adam_bucket), which view the lane as zero-padded (8, 128) VMEM blocks.
The CUDA kernels (csrc/fused_update.cu, bound to PyTorch by
csrc/kernels_binding.cpp) make one grid-stride pass over the unpadded
lane. Both are bound by bytes: 20 B per element for momentum, 28 B for
adam.

Dispatch: a bucket on a CUDA device launches the kernel (and counts the
launch on the wrapper's `launches`); a bucket on the CPU takes the plain
twin. `*_cuda` are the kernel entry points proper: they raise on anything
the kernel does not take — a CPU tensor included, before anything is
built — instead of computing.
The twins repeat the scalar ops' torch expressions (ops/optimizer_ops.py),
so on the card the kernel is held bitwise against them.
"""

import torch

from .. import cuda_build

__all__ = ["momentum_bucket", "adam_bucket", "momentum_bucket_plain",
           "adam_bucket_plain", "momentum_bucket_cuda", "adam_bucket_cuda"]

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


def reset_launch_counts():
    momentum_bucket.launches = 0
    adam_bucket.launches = 0
