"""Ring attention: exact attention over sequences sharded across the mesh.

The counterpart of paddle_tpu/parallel/ring.py. Each rank of the mesh's
sequence axis (sp) holds one sequence shard of Q, K and V. K/V blocks
rotate around the ring, rank i sending to rank i + 1
(`ops.collective_ops.permute`: P2P send/recv over the axis's group); each
hop every rank accumulates its Q block's attention against the visiting
K/V block, so the result is exact full attention with O(S/n) memory a
rank. The last hop does not rotate; one rank is one hop.

Two forms, as in the JAX package:
  * `ring_attention(_sharded)`: the plain streaming softmax (running max
    m and normalizer l) in f32, differentiable: the permute's backward
    sends the cotangent back along the inverse permutation.
  * `ring_flash_attention(_sharded)`: the forward only. Each hop calls
    `parallel.flash.flash_fwd` (the hand-written kernel on CUDA tensors,
    its plain version on CPU tensors) and the hops' (out, lse) pairs merge
    in log space. Causal hops follow the JAX cases: a block from an
    earlier shard is attended in full, the rank's own block causally, and
    a block from a later shard is skipped (no launch: zeros, lse -inf).

A torch rank holds only its own shard, so every entry takes [B, H, S, D]
tensors already cut to this rank's sequence shard (the JAX full-tensor
entries take the global array and shard it) and returns this rank's
shard of the output. The rank's position and the ring's size come from
the mesh's `axis_name` axis: `ring_attention(q, k, v, mesh)` for a
parallel.mesh.Mesh, the `_sharded` forms from the ambient mesh
(`parallel.mesh.mesh_scope`). With no mesh, or an axis of one rank, the
ring is one hop. Causal masking uses global positions (shard index times
S_local plus the local position), top-left aligned.
"""

import time

import torch

from ..ops.collective_ops import permute
from . import mesh as _mesh
from .flash import flash_fwd

__all__ = ["ring_attention_sharded", "ring_attention",
           "ring_flash_attention_sharded", "ring_flash_attention"]


def _block_attn(q, k, v, bias, m_prev, l_prev, o_prev, scale):
    """One streaming-softmax accumulation step.
    q: [B,H,Sq,D]; k,v: [B,H,Sk,D]; bias: [Sq,Sk] additive (-inf mask) or
    None. Returns the updated (m, l, o). The running max only shifts exp's
    argument, so it carries no gradient."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m_cur = s.detach().amax(-1)                         # [B,H,Sq]
    m_new = torch.maximum(m_prev, m_cur)
    # guard fully-masked rows (all -inf)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])                # [B,H,Sq,Sk]
    p = torch.where(torch.isfinite(s), p, 0.0)
    l_cur = p.sum(-1)                                   # [B,H,Sq]
    alpha = torch.where(torch.isfinite(m_prev),
                        torch.exp(m_prev - m_safe), 0.0)
    l_new = alpha * l_prev + l_cur
    o_new = alpha[..., None] * o_prev + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def _ring(axis_name):
    """(axis, idx, n): the ambient mesh's `axis_name` axis (None off the
    mesh), this rank's position on it and the ring's size."""
    mesh = _mesh.current_mesh()
    axis = mesh.axis(axis_name) if mesh is not None else None
    if axis is None:
        return None, 0, 1
    return axis, axis.rank, axis.size


def _rotation(n):
    return [(i, (i + 1) % n) for i in range(n)]


def ring_attention_sharded(q, k, v, axis_name="sp", causal=False,
                           scale=None):
    """Per-shard body over the ambient mesh's `axis_name` axis.

    q, k, v: [B, H, S_local, D], this rank's sequence shard. Returns its
    [B, H, S_local, D] exact attention output, in q's dtype;
    differentiable (every rank of the ring must run the backward)."""
    axis, idx, n = _ring(axis_name)
    B, H, S, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / D ** 0.5
    dev = q.device
    qf = q.float()
    m = torch.full((B, H, S), float("-inf"), device=dev)
    l = torch.zeros((B, H, S), device=dev)
    o = torch.zeros((B, H, S, D), device=dev)
    perm = _rotation(n)
    pos = torch.arange(S, device=dev)

    def accumulate(hop_idx, k_blk, v_blk, m, l, o):
        # global block index the visiting K/V block came from
        src = (idx - hop_idx) % n
        bias = None
        if causal:
            visible = (idx * S + pos)[:, None] >= (src * S + pos)[None, :]
            bias = torch.where(visible, 0.0, float("-inf"))
        return _block_attn(qf, k_blk.float(), v_blk.float(), bias, m, l, o,
                           scale)

    k_blk, v_blk = k, v
    for hop_idx in range(n):
        m, l, o = accumulate(hop_idx, k_blk, v_blk, m, l, o)
        if hop_idx < n - 1:  # the last hop accumulates only
            k_blk = permute(k_blk, axis, perm)
            v_blk = permute(v_blk, axis, perm)
    return (o / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False, scale=None):
    """Ring attention over `mesh`'s `axis_name` axis for this rank's
    sequence shard q, k, v [B, H, S_local, D] (see the module docstring);
    returns this rank's shard of the output."""
    with _mesh.mesh_scope(mesh):
        return ring_attention_sharded(q, k, v, axis_name=axis_name,
                                      causal=causal, scale=scale)


def _merge(o_p, lse_p, o_h, lse_h):
    """Log-space merge of two (out, lse) partial attentions, in f32."""
    lse_new = torch.logaddexp(lse_p, lse_h)
    safe = torch.where(torch.isneginf(lse_new), 0.0, lse_new)
    w_p = torch.where(torch.isneginf(lse_p), 0.0, torch.exp(lse_p - safe))
    w_h = torch.where(torch.isneginf(lse_h), 0.0, torch.exp(lse_h - safe))
    o_new = w_p[..., None] * o_p + w_h[..., None] * o_h.float()
    return o_new, lse_new


FULL, DIAGONAL, SKIP = "full", "diagonal", "skip"


def _case(src, idx, causal):
    if not causal or src < idx:
        return FULL
    return DIAGONAL if src == idx else SKIP


class _Clock:
    """Marks on the device's timeline: CUDA events on a card (read after
    one synchronize), the host clock on the CPU."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def seconds(self, a, b):
        if self.cuda:
            return a.elapsed_time(b) / 1e3
        return b - a


def ring_flash_attention_sharded(q, k, v, axis_name="sp", causal=False,
                                 scale=None, block_q=256, block_k=256,
                                 timings=None):
    """Ring attention with `flash_fwd` as each hop's block compute: the
    forward only (the kernel's backward does not run through the log-space
    merge; train with ring_attention). q, k, v: [B, H, S_local, D], this
    rank's shard over the ambient mesh's `axis_name` axis. block_q and
    block_k keep the JAX package's signature; the kernels' tiles are
    fixed. `timings`, a list, gets one dict a hop: its case, the kernel's
    ms and the rotation's ms (CUDA events on a card, synchronized at the
    end)."""
    axis, idx, n = _ring(axis_name)
    D = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / D ** 0.5
    perm = _rotation(n)
    clock = _Clock(q.device) if timings is not None else None
    marks = []
    o = lse = None
    k_blk, v_blk = k, v
    for hop_idx in range(n):
        src = (idx - hop_idx) % n
        case = _case(src, idx, causal)
        t0 = clock.mark() if clock else None
        if case != SKIP:  # a skipped block adds zeros at lse -inf: nothing
            o_h, lse_h = flash_fwd(q, k_blk, v_blk, scale, case == DIAGONAL)
            if o is None:  # the first hop: the merge with nothing is exact
                o, lse = o_h.float(), lse_h
            else:
                o, lse = _merge(o, lse, o_h, lse_h)
        t1 = clock.mark() if clock else None
        if hop_idx < n - 1:
            k_blk = permute(k_blk, axis, perm)
            v_blk = permute(v_blk, axis, perm)
        t2 = clock.mark() if clock else None
        if clock:
            marks.append((hop_idx, src, case, t0, t1, t2))
    if clock:
        clock.sync()
        for hop_idx, src, case, t0, t1, t2 in marks:
            timings.append({"hop": hop_idx, "src": src, "case": case,
                            "kernel_ms": clock.seconds(t0, t1) * 1e3,
                            "permute_ms": (clock.seconds(t1, t2) * 1e3
                                           if hop_idx < n - 1 else 0.0)})
    return o.to(q.dtype)


def ring_flash_attention(q, k, v, mesh, axis_name="sp", causal=False,
                         scale=None, block_q=256, block_k=256,
                         timings=None):
    """ring_flash_attention_sharded over `mesh` for this rank's sequence
    shard q, k, v [B, H, S_local, D] (see its docstring; the forward
    only). block_q and block_k are accepted for the JAX package's
    signature only: the kernels' tiles are fixed."""
    with _mesh.mesh_scope(mesh):
        return ring_flash_attention_sharded(
            q, k, v, axis_name=axis_name, causal=causal, scale=scale,
            block_q=block_q, block_k=block_k, timings=timings)
