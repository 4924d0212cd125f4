"""The f32 flash-attention forward's 3xTF32 arithmetic in the port
(paddle_tpu_torch/parallel/flash.py, csrc/flash_attention_f32_sm90.cu).

On the CPU: the split prologue's plain twin `split_tf32_plain` (tf32
rounding, the parts' error bound, the Vᵀ key order the kernel's P fragments
rely on, zero padding), and a plain torch emulation of the kernel's
products. Three TF32 products per product meet the f32 card limit
(chip_smoke.FLASH_TOL, atol 2e-5 / rtol 1e-4) against `flash_fwd_plain` and
against the JAX package's flash attention (its Pallas kernel in interpret
mode); one TF32 product misses it, which is why the kernel splits. On a
card (tests marked `cuda`, skipped elsewhere): the prologue kernel bitwise
against its twin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.parallel import flash as jflash

import chip_smoke
from paddle_tpu_torch.parallel import flash as tflash

CARD_F32 = chip_smoke.FLASH_TOL[torch.float32]
# the CPU tests' shapes (tests/test_torch_flash.py) and a longer one at the
# full-width head dim
SHAPES = [(2, 3, 64, 64, 32), (2, 3, 100, 100, 32), (1, 2, 96, 96, 16),
          (1, 2, 40, 72, 16), (1, 1, 5, 5, 8), (1, 2, 1024, 1024, 128)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


@pytest.fixture(autouse=True)
def _fresh_counts():
    tflash.reset_launch_counts()
    yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split kernel runs only there")
    return torch.device("cuda", 0)


def _inputs(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _qkv(seed, shape):
    B, H, Sq, Sk, D = shape
    return _inputs(seed, (B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _parts(x):
    big = tflash._tf32_round(x)
    return big, tflash._tf32_round(x - big)


def _emulate(q, k, v, scale, causal, terms):
    """The kernel's arithmetic in plain torch: q·kᵀ and p·v each the sum of
    `terms` TF32 products in f32 (3: small·big + big·small + big·big, the
    small terms first; 1: big·big alone), the softmax as in
    `flash_fwd_plain`."""
    (qb, qs), (kb, ks), (vb, vs) = _parts(q), _parts(k), _parts(v)
    kb, ks = kb.transpose(-1, -2), ks.transpose(-1, -2)
    s = qs @ kb + qb @ ks + qb @ kb if terms == 3 else qb @ kb
    s = s * scale
    Sq, Sk = q.shape[2], k.shape[2]
    if causal:
        s = s.masked_fill(torch.arange(Sk)[None, :] > torch.arange(Sq)[:, None],
                          float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pb, ps = _parts(p)
    o = ps @ vb + pb @ vs + pb @ vb if terms == 3 else pb @ vb
    return o / l


def _limit_used(got, want):
    """The largest share of the f32 card limit any element uses."""
    lim = CARD_F32["atol"] + CARD_F32["rtol"] * np.abs(want)
    return float((np.abs(got - want) / lim).max())


@pytest.mark.parametrize("x,want", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),          # halfway: away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # below halfway: down
    (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),       # halfway, odd: away
    (2.0 - 2.0 ** -23, 2.0),                   # carries into the exponent
    (0.0, 0.0)])
def test_tf32_round_to_nearest_ties_away(x, want):
    got = tflash._tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("shape", [(2, 3, 100, 32), (1, 2, 47, 12)])
def test_split_parts_are_tf32_and_sum_to_x(shape):
    """big and small keep 10 mantissa bits (the low 13 zero), x - big is
    exact, and small is x - big to 2^-11 of itself: big + small is x to 22
    bits."""
    (x,) = _inputs(20, shape)
    x = torch.from_numpy(x * np.float32(3.7))
    big, small = _parts(x)
    assert not (_bits(big) & 0x1FFF).any()
    assert not (_bits(small) & 0x1FFF).any()
    rest = (x - big).double()
    assert ((x.double() - big.double()) == rest).all()  # exact in f32
    assert ((rest - small.double()).abs()
            <= 2.0 ** -11 * rest.abs()).all()
    assert (rest.abs() <= 2.0 ** -11 * x.double().abs()).all()


def test_key_order_makes_p_accumulator_the_a_fragment():
    """In tf32 wgmma m64k8 the A fragment of quad thread c holds A-columns
    c and c + 4 (CuTe's ALayout_64x8); the f32 accumulator of an 8-key
    slice holds keys 2c and 2c + 1 there (CLayout_64xN). Vᵀ's column p of
    each group of 8 holds key order[p], so A-column p is key order[p]."""
    order = tflash._key_order(16, "cpu").tolist()
    assert order == [0, 2, 4, 6, 1, 3, 5, 7, 8, 10, 12, 14, 9, 11, 13, 15]
    for c in range(4):
        assert (order[c], order[c + 4]) == (2 * c, 2 * c + 1)


@pytest.mark.parametrize("B,H,Sk,D", [(1, 2, 47, 12), (2, 3, 64, 32),
                                       (1, 1, 5, 10), (1, 2, 0, 8)])
def test_split_tf32_plain_layout_and_padding(B, H, Sk, D):
    """k's parts are [B, H, Sk, Dk] with zero columns past D; Vᵀ's are
    [B, H, D, Sk8] with zero keys past Sk, and undoing the key order gives
    back v's own parts."""
    k, v = (torch.from_numpy(a) for a in _inputs(21, *[(B, H, Sk, D)] * 2))
    kb, ks, vtb, vts = tflash.split_tf32_plain(k, v)
    Dk, Sk8 = -(-D // 4) * 4, -(-Sk // 8) * 8
    assert kb.shape == ks.shape == (B, H, Sk, Dk)
    assert vtb.shape == vts.shape == (B, H, D, Sk8)
    for got, want in zip((kb, ks), _parts(k)):
        assert torch.equal(got[..., :D], want)
        assert not got[..., D:].any()
    back = torch.argsort(tflash._key_order(Sk8, "cpu"))
    for got, want in zip((vtb, vts), _parts(v.transpose(-1, -2))):
        assert torch.equal(got[..., back][..., :Sk], want)
        assert not got[..., back][..., Sk:].any()


def test_split_tf32_on_cpu_is_the_plain_version():
    k, v = (torch.from_numpy(a) for a in _inputs(22, *[(1, 2, 9, 8)] * 2))
    for got, want in zip(tflash.split_tf32(k, v),
                         tflash.split_tf32_plain(k, v)):
        assert torch.equal(got, want)
    assert tflash.split_tf32.launches == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_three_tf32_products_meet_the_f32_card_limit(shape, causal):
    """The kernel's 3-term arithmetic is within the f32 card limit of the
    plain version and of the JAX package's flash attention."""
    arrays = _qkv(23, shape)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    scale = shape[-1] ** -0.5
    got = _emulate(q, k, v, scale, causal, terms=3).numpy()
    want, _ = tflash.flash_fwd_plain(q, k, v, scale, causal)
    np.testing.assert_allclose(got, want.numpy(), **CARD_F32)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    jwant = np.asarray(jflash.flash_attention(jq, jk, jv, causal=causal,
                                              scale=scale))
    np.testing.assert_allclose(got, jwant, **CARD_F32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_one_tf32_product_misses_the_f32_card_limit(shape, causal):
    """Plain TF32 (q, k, p and v rounded to 11 bits, one product each)
    leaves several times the f32 limit at every shape here."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(23, shape))
    scale = shape[-1] ** -0.5
    want, _ = tflash.flash_fwd_plain(q, k, v, scale, causal)
    got = _emulate(q, k, v, scale, causal, terms=1)
    assert _limit_used(got.numpy(), want.numpy()) > 2


# ---------------------------------------------------------------------------
# on a CUDA card: the prologue kernel against its plain twin
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "bshd_view"])
@pytest.mark.parametrize("B,H,Sk,D", [(1, 2, 47, 12), (2, 3, 100, 32),
                                       (1, 4, 1500, 64), (1, 2, 257, 128)])
def test_split_kernel_matches_plain_bitwise_on_the_card(cuda_device, B, H,
                                                        Sk, D, layout):
    shape = (B, Sk, H, D) if layout == "bshd_view" else (B, H, Sk, D)
    k, v = (torch.from_numpy(a).to(cuda_device)
            for a in _inputs(24, shape, shape))
    if layout == "bshd_view":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    got = tflash.split_tf32(k, v)
    want = tflash.split_tf32_plain(k, v)
    torch.cuda.synchronize()
    assert tflash.split_tf32.launches == 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)
