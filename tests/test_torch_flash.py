"""Flash attention in the port (paddle_tpu_torch/parallel/flash.py) against
the JAX package's (paddle_tpu/parallel/flash.py, its Pallas kernel run in
interpret mode on the CPU), on the same numpy inputs.

On the CPU the port's forward is the plain torch version; the CUDA kernels
(csrc/flash_attention_f32_sm90.cu in f32, csrc/flash_attention_sm90.cu in
bf16) are held against that same plain version on a card by the tests
marked `cuda`, which skip elsewhere (the f32 kernel's 3xTF32 arithmetic
and its split prologue: tests/test_torch_flash_tf32.py). The CPU tests
also cover `_tma_operand`, which decides whether the bf16 kernel reads an
operand in place. Against JAX the
tolerances are those of the JAX package's own oracle
(tests/test_flash_attention.py): forward atol 2e-5 / rtol 1e-4 in f32
(products summed in another order), grads atol 5e-5 / rtol 1e-3, bf16
atol 3e-2 / rtol 5e-2 (an ulp of bf16 near 1 is 2^-8, and p is rounded to
bf16 at other running maxima). The kernel is held to chip_smoke.py's
tighter card limits, which a skipped key tile exceeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.parallel import flash as jflash

import chip_smoke
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.parallel import flash as tflash

F32 = {"atol": 2e-5, "rtol": 1e-4}
GRAD = {"atol": 5e-5, "rtol": 1e-3}
BF16 = {"atol": 3e-2, "rtol": 5e-2}
# the kernel against its plain version on a card
CARD = {torch.float32: chip_smoke.FLASH_TOL[torch.float32],
        torch.bfloat16: chip_smoke.FLASH_TOL[torch.bfloat16]}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tscope.reset_global_scope()
    tfluid.unique_name.switch()
    tflash.reset_launch_counts()
    yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel runs only there")
    return torch.device("cuda", 0)


def _inputs(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _both(arrays, dtype="float32"):
    """The same arrays as jax and torch tensors of `dtype`."""
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def test_parallel_package_exports():
    from paddle_tpu import parallel as jparallel
    from paddle_tpu_torch import parallel

    # flash and, since the data-parallel slice, the mesh, the bootstrap,
    # zero1 and the sharding annotations; since the ring and pipeline
    # slice, the RPC runtime, ring attention and the pipeline; since the
    # control plane, the elastic controller: names of the JAX package's
    # parallel package, which has more (autoshard, the sharded embedding)
    assert sorted(parallel.__all__) == sorted([
        "mesh", "distributed", "api", "flash", "zero1", "rpc", "ring",
        "pipeline", "elastic", "make_mesh", "data_parallel_mesh",
        "mesh_scope", "mesh_geometry", "MeshSpec", "set_sharding",
        "get_sharding", "sharding_scope", "flash_attention",
        "ring_attention", "ring_attention_sharded", "ring_flash_attention",
        "ring_flash_attention_sharded", "ElasticController",
        "ElasticConfig", "ElasticError", "Resized", "RescalePolicy",
        "LinearRescale", "ConstantRescale"])
    assert set(parallel.__all__) <= set(jparallel.__all__)
    assert tfluid.parallel.flash_attention is tflash.flash_attention


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 100])  # 100: not a block multiple
def test_forward_matches_jax(causal, S):
    B, H, D = 2, 3, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(0, *[(B, H, S, D)] * 3))
    want = jflash.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                                  block_k=32)
    got = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                                 block_k=32)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 100])
def test_lse_matches_jax_fwd_padded(causal, S):
    B, H, D = 2, 3, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, *[(B, H, S, D)] * 3))
    scale = 1.0 / np.sqrt(D)
    bq, bk = jflash.normalize_blocks(32, 32, S, S)
    jout, jlse = jflash._fwd_padded(jq, jk, jv, scale, causal, bq, bk)
    out, lse = tflash.flash_fwd(tq, tk, tv, scale, causal)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(causal):
    B, H, S, D = 1, 2, 96, 16
    arrays = _inputs(2, *[(B, H, S, D)] * 4)
    (jq, jk, jv, jcot), (tq, tk, tv, tcot) = _both(arrays)

    def loss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, causal=causal,
                                              block_q=32, block_k=32) * jcot)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    out = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                                 block_k=32)
    (out * tcot).sum().backward()
    for t, w, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax_and_stays_bf16(causal):
    B, H, S, D = 1, 2, 64, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(3, *[(B, H, S, D)] * 3),
                                       "bfloat16")
    want = jflash.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                                  block_k=32)
    got = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                                 block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def test_bf16_gradients_keep_input_dtypes():
    _, (tq, tk, tv) = _both(_inputs(4, *[(1, 2, 24, 8)] * 3), "bfloat16")
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    tflash.flash_attention(tq, tk, tv, causal=True).float().sum().backward()
    assert [t.grad.dtype for t in (tq, tk, tv)] == [torch.bfloat16] * 3
    assert all(torch.isfinite(t.grad.float()).all() for t in (tq, tk, tv))


@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_lengths_match_jax(causal):
    """Sq != Sk (decoder cross-attention), the causal mask top-left."""
    q, k, v = _inputs(5, (1, 2, 40, 16), (1, 2, 72, 16), (1, 2, 72, 16))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v])
    want = jflash.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                                  block_k=32)
    got = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                                 block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_small_sequences_autoshrink_match_jax():
    (q,) = _inputs(6, (1, 1, 5, 8))
    (jq,), (tq,) = _both([q])
    want = jflash.flash_attention(jq, jq, jq)  # default 256 blocks shrink
    got = tflash.flash_attention(tq, tq, tq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("blocks,S", [((256, 256), (5, 5)),
                                      ((32, 32), (100, 100)),
                                      ((32, 64), (40, 72)),
                                      ((100, 24), (96, 17)),
                                      ((64, 256), (4096, 4096))])
def test_normalize_blocks_matches_jax_off_tpu(blocks, S):
    # off a TPU the JAX package does not round to 128, so the two agree
    assert tflash.normalize_blocks(*blocks, *S) == jflash.normalize_blocks(
        *blocks, *S)


@pytest.mark.parametrize("block_k", [8, 32, 200])
def test_backward_block_width_does_not_change_gradients(block_k):
    arrays = _inputs(7, *[(1, 2, 50, 8)] * 4)
    grads = []
    for bk in (block_k, 256):
        q, k, v, cot = (torch.from_numpy(a).requires_grad_(i < 3)
                        for i, a in enumerate(arrays))
        (tflash.flash_attention(q, k, v, causal=True, block_k=bk) * cot).sum(
        ).backward()
        grads.append([t.grad for t in (q, k, v)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_no_keys_gives_zero_out_and_neg_inf_lse():
    q = torch.randn(1, 2, 3, 8)
    k = v = torch.zeros(1, 2, 0, 8)
    out, lse = tflash.flash_fwd(q, k, v, 0.5, False)
    assert torch.equal(out, torch.zeros(1, 2, 3, 8))
    assert torch.isneginf(lse).all()


def test_cuda_entry_point_refuses_cpu_tensors_before_building():
    x = torch.ones(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_fwd_cuda(x, x, x, 0.5, False)
    assert tflash.flash_fwd.launches == 0


@pytest.mark.parametrize("skipped", [64, 128])  # the f32 / bf16 key tile
@pytest.mark.parametrize("causal", [False, True])
def test_card_bf16_limit_rejects_a_skipped_key_tile(causal, skipped):
    """At full width (S=4096, D=128; one head here) the bf16 limit that
    chip_smoke.py holds the kernels to fails a kernel that skips the last
    key tile of 64 or 128 keys (causal: stops one tile short of the
    diagonal)."""
    S, D = 4096, 128
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(10, *[(1, 1, S, D)] * 3))
    want, _ = tflash.flash_fwd_plain(q, k, v, D ** -0.5, causal)
    got, _ = tflash.flash_fwd_plain(q, k[:, :, :-skipped],
                                    v[:, :, :-skipped], D ** -0.5, causal)
    tol = CARD[torch.bfloat16]
    want, got = want.float(), got.float()
    over = (got - want).abs() - (tol["atol"] + tol["rtol"] * want.abs())
    assert over.max().item() > 0


def test_cpu_calls_count_no_launch():
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    tflash.flash_attention(q, q, q, causal=True).sum().backward()
    tflash.flash_fwd(q, q, q, 0.3, False)
    assert tflash.flash_fwd.launches == 0
    assert tflash.flash_fwd.sm90_launches == 0
    assert tflash.flash_fwd.tf32_launches == 0
    assert tflash.split_tf32.launches == 0


def _bf16(seed, shape):
    return torch.from_numpy(_inputs(seed, shape)[0]).to(torch.bfloat16)


@pytest.mark.parametrize("layout",
                         ["contiguous", "bshd_view", "d8", "single_row"])
def test_tma_operand_reads_aligned_operands_in_place(layout):
    """A 16-byte aligned bf16 operand with 16-byte strides and D % 8 == 0
    goes to the kernel as it is, a [B, S, H, D] tensor viewed as
    [B, H, S, D] included: no copy. A dimension of extent 1 is never
    stepped, so one query row cut from rows of 88 bytes stays in place."""
    if layout == "bshd_view":
        t = _bf16(11, (2, 77, 3, 32)).transpose(1, 2)
    elif layout == "single_row":
        t = _bf16(11, (1, 1, 4, 44))[:, :, 2:3, :32]
        assert t.stride(2) * t.element_size() == 88
    else:
        t = _bf16(11, (1, 2, 16, 8 if layout == "d8" else 32))
    assert tflash._tma_operand(t) is t


def test_tma_operand_pads_d12_to_16():
    t = _bf16(12, (1, 2, 33, 12))
    got = tflash._tma_operand(t)
    assert got.shape == (1, 2, 33, 16) and got.is_contiguous()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[..., :12], t)
    assert not got[..., 12:].any()


@pytest.mark.parametrize("fault", ["base", "stride", "last_dim"])
def test_tma_operand_copies_what_tma_cannot_read(fault):
    """An 8-byte offset base, a row stride of 72 bytes and a strided last
    dim each give a fresh contiguous copy with the same values."""
    if fault == "base":
        t = _bf16(13, (1, 2, 16, 40))[..., 4:36]
    elif fault == "stride":
        t = _bf16(13, (1, 2, 16, 36))[..., :32]
    else:
        t = _bf16(13, (1, 2, 32, 16)).transpose(2, 3)
    got = tflash._tma_operand(t)
    assert got is not t and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, t)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_on_padded_operands_gives_the_unpadded_answer(causal):
    """Zero columns of q, k and v change neither q·kᵀ nor the first D
    columns of the output: the padded operands give the caller's out (in
    its first 12 columns, zeros after) and lse, at the same scale."""
    q, k, v = (_bf16(14 + i, (1, 2, 33 if i == 0 else 47, 12))
               for i in range(3))
    scale = 12 ** -0.5
    want, want_lse = tflash.flash_fwd_plain(q, k, v, scale, causal)
    got, lse = tflash.flash_fwd_plain(
        *(tflash._tma_operand(t) for t in (q, k, v)), scale, causal)
    assert got.shape == (1, 2, 33, 16)
    assert not got[..., 12:].any()
    torch.testing.assert_close(got[..., :12], want,
                               **CARD[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# on a CUDA card: the kernel against the plain version
# ---------------------------------------------------------------------------
CARD_SHAPES = [(2, 3, 64, 64, 32), (2, 3, 100, 100, 32), (1, 2, 96, 96, 16),
               (1, 2, 40, 72, 16), (1, 1, 5, 5, 8), (1, 4, 1000, 1500, 64),
               (1, 2, 130, 70, 128), (1, 2, 129, 257, 128),
               (1, 2, 33, 47, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_the_card(cuda_device, shape, causal,
                                          dtype):
    B, H, Sq, Sk, D = shape
    q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
               for a in _inputs(8, (B, H, Sq, D), (B, H, Sk, D),
                                (B, H, Sk, D)))
    scale = D ** -0.5
    out, lse = tflash.flash_fwd(q, k, v, scale, causal)
    want, want_lse = tflash.flash_fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert tflash.flash_fwd.launches == 1
    assert tflash.flash_fwd.sm90_launches == (dtype == "bfloat16")
    assert tflash.flash_fwd.tf32_launches == (dtype == "float32")
    assert tflash.split_tf32.launches == (dtype == "float32")
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(out.cpu()), _f32(want.cpu()),
                               **CARD[q.dtype])
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_reads_strided_heads_in_place(cuda_device):
    """[B, S, H, D] viewed as [B, H, S, D] gives the contiguous answer."""
    (x,) = _inputs(9, (2, 77, 3, 32))
    bshd = torch.from_numpy(x).to(cuda_device)
    view = bshd.transpose(1, 2)
    got = tflash.flash_fwd(view, view, view, 0.2, True)
    want = tflash.flash_fwd(view.contiguous(), view.contiguous(),
                            view.contiguous(), 0.2, True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_bf16_no_keys(cuda_device, causal):
    q = torch.randn(1, 2, 7, 8, device=cuda_device).to(torch.bfloat16)
    k = torch.zeros(1, 2, 0, 8, device=cuda_device, dtype=torch.bfloat16)
    out, lse = tflash.flash_fwd(q, k, k, 0.5, causal)
    torch.cuda.synchronize()
    assert tflash.flash_fwd.sm90_launches == 1
    assert out.dtype == torch.bfloat16 and not out.any()
    assert torch.isneginf(lse).all()


@pytest.mark.cuda
def test_kernel_bf16_unaligned_operand_gives_the_contiguous_answer(
        cuda_device):
    """x[..., 4:36] of a 40-wide bf16 tensor starts 8 bytes past a
    16-byte boundary: it is copied for TMA, and the answer is the one of
    its contiguous copy."""
    (x,) = _inputs(15, (1, 2, 150, 40))
    wide = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    t = wide[..., 4:36]
    assert t.data_ptr() % 16 == 8
    got = tflash.flash_fwd(t, t, t, 0.2, True)
    dense = t.contiguous()
    want = tflash.flash_fwd(dense, dense, dense, 0.2, True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "dv", "d0", "d129", "d160"])
def test_kernel_refuses_what_it_does_not_take(cuda_device, bad):
    D = int(bad[1:]) if bad[1:].isdigit() else 32
    q = torch.ones(1, 1, 8, D, device=cuda_device,
                   dtype=torch.float16 if bad == "float16" else torch.float32)
    v = q[..., :16] if bad == "dv" else q
    # the head-dim refusal formats D into its message
    match = f"got {D}" if bad[1:].isdigit() else None
    with pytest.raises(RuntimeError, match=match):
        tflash.flash_fwd(q, q, v, 0.1, False)
    assert tflash.flash_fwd.launches == 0


@pytest.mark.cuda
def test_refused_launch_raises(cuda_device):
    """More than 65535 f32 q-tiles of 128 rows exceed the grid's y
    dimension: the card refuses the launch and the binding raises instead of
    returning unwritten memory."""
    q = torch.zeros(1, 1, 65535 * 128 + 1, 8, device=cuda_device)
    k = torch.zeros(1, 1, 1, 8, device=cuda_device)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tflash.flash_fwd(q, k, k, 0.5, False)
    assert tflash.flash_fwd.launches == 0
