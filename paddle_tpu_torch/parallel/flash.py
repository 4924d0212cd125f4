"""Flash attention: exact attention whose forward is a hand-written CUDA
kernel, differentiable through a blockwise plain-torch backward.

The counterpart of paddle_tpu/parallel/flash.py. Layout [B, H, S, D]. The
forward, `flash_fwd`, replaces the JAX package's padding wrapper
(`_fwd_padded`) and its Pallas TPU kernel (`_flash_fwd`) together: CUDA
tensors go to a kernel through `flash_fwd_cuda`, which counts its launches
on `flash_fwd.launches`, and CPU tensors to the plain torch version
`flash_fwd_plain`. Both kernels run on the tensor cores, wgmma fed by TMA:
- bf16: csrc/flash_attention_sm90.cu (also counted on
  `flash_fwd.sm90_launches`). A bf16 operand that TMA cannot read in place
  is copied with its head dim zero-padded to a multiple of 8
  (`_tma_operand`).
- f32: csrc/flash_attention_f32_sm90.cu (also counted on
  `flash_fwd.tf32_launches`), in 3xTF32 split products. Its prologue
  `split_tf32` (a second kernel, counted on `split_tf32.launches`; plain
  twin `split_tf32_plain`) rounds k and a transposed v into tf32 big and
  small parts; q is read in place and split in registers.
The kernels mask the ragged sequence edge themselves, so the sequence is
never padded. Both return (out, lse) with lse the f32 logsumexp of each
query row's scores, the pair ring attention combines per hop.

Causal masking is aligned top-left, as in the JAX package: query i sees
keys 0..i, whatever Sq and Sk are.

`flash_attention` is the differentiable entry point, a
torch.autograd.Function. Its backward ports the JAX package's
`_flash_vjp_bwd`: plain torch in f32, a loop over key blocks that
recomputes each block's probabilities from the saved lse, never holding
more than an [Sq, block_k] slice of scores per head.
"""

import torch

from .. import cuda_build

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_cuda",
           "flash_fwd_plain", "normalize_blocks", "reset_launch_counts",
           "split_tf32", "split_tf32_plain"]

# TMA reads a tensor in place only from a 16-byte aligned base with every
# stride but the last a multiple of 16 bytes and the last stride 1
_TMA_ALIGN = 16


def flash_fwd_plain(q, k, v, scale, causal):
    """Dense reference of `flash_fwd`, one (b, h) head at a time so that a
    full-width [Sq, Sk] score matrix exists for one head only.

    Scores are q·kᵀ in f32 times `scale`, -inf where a causal mask hides a
    key; p = exp(s - max s), summed unrounded into l and rounded to v's
    dtype before p·V (as the kernels do); out = p·V / max(l, 1e-30) in q's
    dtype, lse = max s + log(l) in f32 (-inf for a row with no visible
    key)."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    hidden = None
    if causal:
        hidden = (torch.arange(Sk, device=q.device)[None, :]
                  > torch.arange(Sq, device=q.device)[:, None])
    outs, lses = [], []
    for b in range(B):
        for h in range(H):
            s = (q[b, h].float() @ k[b, h].float().T) * scale
            if hidden is not None:
                s = s.masked_fill(hidden, float("-inf"))
            # the max only shifts exp's argument: out and lse do not depend
            # on it, so no gradient flows through it. With no key at all it
            # is -inf (torch's amax refuses an empty row).
            m = (s.detach().amax(-1, keepdim=True) if Sk else
                 torch.full((Sq, 1), float("-inf"), device=q.device))
            m_safe = torch.where(torch.isneginf(m), 0.0, m)
            p = torch.exp(s - m_safe)
            l = p.sum(-1, keepdim=True).clamp_min(1e-30)
            outs.append((p.to(v.dtype).float() @ v[b, h].float()) / l)
            lses.append(torch.where(torch.isneginf(m), m, m + torch.log(l)))
    out = torch.stack(outs).reshape(B, H, Sq, v.shape[-1]).to(q.dtype)
    return out, torch.stack(lses).reshape(B, H, Sq)


def _tf32_round(x):
    """f32 `x` rounded to tf32 (the low 13 mantissa bits zero), to nearest
    with ties away from zero: PTX's cvt.rna.tf32.f32 on finite values.
    Adding half a tf32 ulp to the bit pattern rounds the magnitude up
    whatever the sign, a carry moving into the exponent."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_parts(x):
    big = _tf32_round(x)
    return big, _tf32_round(x - big)  # x - big is exact in f32


def _key_order(n, device):
    """Which key each of n (a multiple of 8) columns of Vᵀ holds: column p
    of a group of 8 holds key [0, 2, 4, 6, 1, 3, 5, 7][p], the order in
    which the f32 kernel's P accumulator registers are its A fragment."""
    p = torch.arange(n, device=device)
    return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1)


def split_tf32_plain(k, v):
    """The plain version of the f32 forward's prologue: k and v
    [B, H, Sk, D] f32 into (k_big, k_small) [B, H, Sk, Dk] and
    (vt_big, vt_small) [B, H, D, Sk8], where Dk is D and Sk8 is Sk rounded
    up to multiples of 4 and 8, the extra columns and keys zero, and Vᵀ's
    keys come in `_key_order`. big + small is x to 22 bits."""
    B, H, Sk, D = k.shape
    k_pad = k.new_zeros(B, H, Sk, -(-D // 4) * 4)
    k_pad[..., :D] = k
    Sk8 = -(-Sk // 8) * 8
    vt = v.new_zeros(B, H, D, Sk8)
    vt[..., :Sk] = v.transpose(-1, -2)
    vt = vt[..., _key_order(Sk8, v.device)]
    return (*_tf32_parts(k_pad), *_tf32_parts(vt))


def split_tf32(k, v):
    """`split_tf32_plain`'s parts: the prologue kernel for CUDA tensors
    (counted on `split_tf32.launches`), the plain version for CPU
    tensors."""
    if not k.is_cuda:
        return split_tf32_plain(k, v)
    parts = cuda_build.kernels().split_tf32(k, v)
    if k.numel():
        split_tf32.launches += 1
    return parts


cuda_build.count_launches(split_tf32, "launches")


def _check(q, k, v):
    """Refuse operands off one CUDA device before anything is built; the
    binding checks dtype, rank and shapes."""
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_fwd: q, k and v must be on {q.device} "
                             f"(CUDA), got {t.device}")


def _tma_operand(t):
    """`t` itself where TMA can read it in place (a 16-byte aligned base,
    a contiguous last dim whose width is a multiple of 16 bytes, every
    other stride of a dim longer than 1 a multiple of 16 bytes: a
    [B, S, H, D] tensor viewed as [B, H, S, D] qualifies); otherwise a
    fresh contiguous copy with the last dim zero-padded to the next
    multiple of 16 bytes. The zero columns add nothing to q·kᵀ and give
    zero output columns, which the kernel does not store."""
    size = t.element_size()
    width = t.shape[-1]
    aligned = (t.stride(-1) == 1 and width * size % _TMA_ALIGN == 0
               and t.data_ptr() % _TMA_ALIGN == 0
               and all(n == 1 or st * size % _TMA_ALIGN == 0
                       for n, st in zip(t.shape[:-1], t.stride()[:-1])))
    if aligned:
        return t
    per = _TMA_ALIGN // size
    padded = t.new_zeros(*t.shape[:-1], -(-width // per) * per)
    padded[..., :width] = t
    return padded


def flash_fwd_cuda(q, k, v, scale, causal):
    """The kernel: (out [B, H, Sq, D], lse [B, H, Sq] f32) on the card.
    f32 or bf16, one head dim D <= 128 for q, k and v; raises on anything
    else, a CPU tensor included."""
    _check(q, k, v)
    D = q.shape[-1]
    f32 = q.dtype == torch.float32
    if f32:
        out, lse = cuda_build.kernels().flash_fwd_tf32(
            q, *split_tf32(k, v), float(scale), bool(causal))
    else:
        if k.shape[-1] == D and v.shape[-1] == D:
            q, k, v = (_tma_operand(t) for t in (q, k, v))
        out, lse = cuda_build.kernels().flash_fwd(q, k, v, float(scale),
                                                 bool(causal), D)
    if out.numel():
        flash_fwd.launches += 1
        flash_fwd.tf32_launches += int(f32)
        flash_fwd.sm90_launches += int(not f32)
    return out, lse


def flash_fwd(q, k, v, scale, causal):
    """(out, lse) of softmax(q·kᵀ·scale)·v for q [B, H, Sq, D] and k, v
    [B, H, Sk, D]: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, scale, causal)
    return flash_fwd_plain(q, k, v, scale, causal)


# every kernel launch; of which the bf16 kernel's; and the f32 (3xTF32)
# kernel's
cuda_build.count_launches(flash_fwd, "launches", "sm90_launches",
                          "tf32_launches")


def reset_launch_counts():
    flash_fwd.launches = 0
    flash_fwd.sm90_launches = 0
    flash_fwd.tf32_launches = 0
    split_tf32.launches = 0


def normalize_blocks(block_q, block_k, Sq, Sk):
    """A block at least as long as its (8-rounded) sequence shrinks to it;
    any other block is kept as given. The JAX package also rounds blocks up
    to 128 for the TPU's tiling, which no kernel here needs."""

    def _pick(block, S):
        S8 = -(-max(S, 1) // 8) * 8
        block = int(block)
        return S8 if block >= S8 else block

    return _pick(block_q, Sq), _pick(block_k, Sk)


def _flash_bwd(q, k, v, out, lse, do, scale, causal, block_k):
    """dq, dk, dv of flash attention from the saved lse, in f32, one
    key block at a time (the JAX package's _flash_vjp_bwd)."""
    Sq, Sk = q.shape[2], k.shape[2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * out.float()).sum(-1, keepdim=True)  # [B, H, Sq, 1]
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    rows = torch.arange(Sq, device=q.device)[:, None]
    for k0 in range(0, Sk, block_k):
        k1 = min(Sk, k0 + block_k)
        kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = (qf @ kb.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            visible = torch.arange(k0, k1, device=q.device)[None, :] <= rows
            p = torch.where(visible, p, 0.0)
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ dof
        ds = p * (dof @ vb.transpose(-1, -2) - delta) * scale
        dq += ds @ kb
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_k):
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.block_k = scale, causal, block_k
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, ctx.scale, ctx.causal,
                                ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=256,
                    block_k=256):
    """Exact attention [B, H, S, D] -> [B, H, S, D]; differentiable.

    scale defaults to 1/sqrt(D). block_q and block_k keep the JAX package's
    signature and auto-shrink for short sequences (`normalize_blocks`):
    block_k sets the width of the key blocks the backward walks, and
    neither shapes the CUDA kernels' tiles, which are fixed (128 query rows
    by 64 keys in f32, 128 by 128 in bf16)."""
    _, block_k = normalize_blocks(block_q, block_k, q.shape[2], k.shape[2])
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(block_k))
