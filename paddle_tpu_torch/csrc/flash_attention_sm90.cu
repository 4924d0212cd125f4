// Flash-attention forward in bf16 for sm_90a on the tensor cores: exact
// softmax(q·kᵀ·scale)·v over [B, H, S, D] with D <= 128, streamed over key
// tiles so the [Sq, Sk] score matrix never reaches device memory. Built by
// torch.utils.cpp_extension.load (paddle_tpu_torch/cuda_build.py) together
// with kernels_binding.cpp, which binds flash_fwd_sm90_launch below to
// PyTorch; this file keeps a plain C interface and includes no PyTorch
// header. The f32 forward is flash_attention_f32_sm90.cu (3xTF32 products
// on wgmma); sm90_common.cuh holds the mbarrier, TMA and wgmma helpers
// both kernels use.
//
// Replaces paddle_tpu/parallel/flash.py:81 _flash_fwd (Pallas kernel
// _kernel) for bf16, which runs a (B·H, q-block, k-block) grid whose k axis
// is sequential on one TPU core and carries m, l and acc in VMEM scratch.
//
// Bound: operations. At full width (B=1, H=32, S=4096, D=128) the forward
// does 275 GFLOP (137 causal) against 135 MB of operands: 0.278 ms
// (0.139 ms causal) at the card's 989 TFLOP/s, two orders of magnitude
// above its 0.040 ms of bytes. What the design does about it: both
// products run on wgmma, and nothing on the path to the tensor cores
// waits on device memory.
//   - One block per (128-row q-tile, b·h), 3 warpgroups. Warpgroups 0 and 1
//     are consumers, each owning 64 query rows; warpgroup 2 is the
//     producer, whose one elected thread issues TMA loads. setmaxnreg moves
//     registers from the producer (24) to the consumers (240).
//   - Shared memory (226 KB, one block per SM): Q [128 × 128] loaded once,
//     and a 3-stage ring of K and V tiles [128 keys × 128], each tile two
//     64-column TMA boxes in the 128-byte swizzle. Each stage has a `full`
//     mbarrier for K, one for V (TMA completes them by bytes) and an
//     `empty` one the 8 consumer warps arrive on once p·V has read it.
//     At full width, in two timed comparisons on one card (PERF.md),
//     three stages ran no slower than two and one stage 20–24% slower.
//   - S = Q·Kᵀ: wgmma m64n128k16 ×8 over D, A (Q) and B (K) both K-major in
//     shared memory, f32 accumulator in 64 registers a thread.
//   - The online softmax runs in registers: in the accumulator layout one
//     row lives in a quad of 4 threads, reduced with two xor-shuffles.
//   - O += P·V: p rounded to bf16 and packed in registers is the register-A
//     operand of wgmma m64n128k16 ×8 over the 128 keys (the f32
//     accumulator layout of a 64×16 slice is the A-fragment layout); B is
//     the V tile as it lies, [keys, D], read MN-major (transpose bit set).
//   - The tensor maps are rank 4 ({D, S, H, B}), so rows past the end of a
//     head come back as zeros, never as the next head's data: ragged Sq and
//     Sk need no padding, and columns past D (D < 128) are zeros too.
//
// What it computes, per row (the JAX kernel's arithmetic, flash.py:44-62):
//   s    = (q·kᵀ accumulated in f32) * scale; -inf where masked
//   m'   = max(m, max s); m_safe = m' == -inf ? 0 : m'
//   p    = exp(s - m_safe)            (0 where s is -inf)
//   corr = m == -inf ? 0 : exp(m - m_safe)
//   l'   = corr * l + Σ p;  acc' = corr * acc + bf16(p) · V
// with exp(x - y) taken as exp2f(x·log2(e) - y·log2(e)), one __fmaf_rn.
// At the end out = acc / max(l, 1e-30) in bf16 and
// lse = m == -inf ? -inf : m + log(max(l, 1e-30)) in f32.
//
// Operands: bf16, a 16-byte aligned base, every stride but the last a
// multiple of 16 bytes, the last dimension contiguous and its width Dp a
// multiple of 8 (TMA's rules). parallel/flash.py::_tma_operand hands over
// a zero-padded copy of any operand that breaks them; D <= Dp is the
// caller's head width, the width of out.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 128;       // query rows of a block, 64 per consumer
constexpr int kBK = 128;       // keys of a tile
constexpr int kD = 128;        // head width every D <= 128 runs at
constexpr int kBox = 64;       // columns of one TMA box: 128 bytes
constexpr int kStages = 3;     // K/V tiles in flight
constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr uint32_t kBoxBytes = kBK * kBox * 2;     // 16 KB
constexpr uint32_t kTileBytes = 2 * kBoxBytes;     // 32 KB: 128 rows × 128
constexpr uint32_t kStageBytes = 2 * kTileBytes;   // K and V
constexpr uint32_t kBarOffset = kTileBytes + kStages * kStageBytes;
// barriers: q_full, then k_full, v_full and empty of every stage
constexpr uint32_t kSmemBytes = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == 128 && kBK == 128 && kD == 2 * kBox, "tile shapes");

// ---- wgmma in bf16 -------------------------------------------------------

// d (64 × 128 f32) = (accumulate ? d : 0) + A (64 × 16) · B (16 × 128),
// A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : SM90_ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 × 128 f32) += A (64 × 16 bf16, four registers a thread) · B
// (16 × 128), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : SM90_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the kernel ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int BH, int H, int Sq,
                          int Sk, int D, int nq, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned shared addresses
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t q_smem = base;
  const uint32_t bars = base + kBarOffset;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto k_smem = [&](int s) { return base + kTileBytes + s * kStageBytes; };

  // heaviest causal tiles (the last q-tiles) of every head first
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBQ;
  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, qt + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load(q_smem, &q_map, q_full, 0, q0, h, b);
      tma_load(q_smem + kBoxBytes, &q_map, q_full, kBox, q0, h, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        // the stage's previous tile, kt - kStages, must be consumed
        if (kt >= kStages) mbar_wait(empty(s), (kt / kStages - 1) & 1);
        const int k0 = kt * kBK;
        const uint32_t ks = k_smem(s), vs = ks + kTileBytes;
        mbar_expect_tx(k_full(s), kTileBytes);
        tma_load(ks, &k_map, k_full(s), 0, k0, h, b);
        tma_load(ks + kBoxBytes, &k_map, k_full(s), kBox, k0, h, b);
        mbar_expect_tx(v_full(s), kTileBytes);
        tma_load(vs, &v_map, v_full(s), 0, k0, h, b);
        tma_load(vs + kBoxBytes, &v_map, v_full(s), kBox, k0, h, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // accumulator layout: register i of a thread holds row
    // r0 + 8·((i / 2) % 2), column 8·(i / 4) + c + i % 2
    const int r0 = 16 * warp + lane / 4;
    const int c = (lane % 4) * 2;
    const int row_min = q0 + 64 * wg;  // this warpgroup's first row
    const int row0 = row_min + r0;     // rows row0 and row0 + 8
    const uint32_t qa = q_smem + 64 * wg * 128;  // 64 rows of 128 bytes

    float o[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const int k0 = kt * kBK;
      const uint32_t ks = k_smem(s), vs = ks + kTileBytes;

      // S = Q·Kᵀ: 8 steps of 16 over D, 4 in each 64-column box
      float sc[64];
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss(sc, smem_desc(qa + off, 16, 1024),
                 smem_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale, mask and the streaming softmax update; p overwrites s.
      // Keys >= Sk are zero rows and score 0, so they are masked here.
      const bool edge =
          k0 + kBK > Sk || (causal && k0 + kBK - 1 > row_min);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hr + e;
            float x = __fmul_rn(sc[i], scale);
            if (edge) {
              const int col = k0 + 8 * j + c + e;
              if (col >= Sk || (causal && col > row)) x = -INFINITY;
            }
            sc[i] = x;
            mt = fmaxf(mt, x);
          }
        const float m_new = fmaxf(m[hr], quad_max(mt));
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float ms = __fmul_rn(m_safe, kLog2e);
        const float corr =
            m[hr] == -INFINITY ? 0.f : exp2f(__fmaf_rn(m[hr], kLog2e, -ms));
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hr + e;
            const float p = exp2f(__fmaf_rn(sc[i], kLog2e, -ms));  // -inf: 0
            rs = __fadd_rn(rs, p);
            sc[i] = p;
            o[i] = __fmul_rn(o[i], corr);
          }
        l[hr] = __fadd_rn(__fmul_rn(corr, l[hr]), quad_sum(rs));
        m[hr] = m_new;
      }

      // p in bf16 as the A fragments of the 8 steps of 16 keys
      uint32_t pa[32];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[4 * kk + r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P·V: V's 16-key slices lie 16 rows of 128 bytes apart
      mbar_wait(v_full(s), parity);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs(o, pa + 4 * kk,
                 smem_desc(vs + kk * 16 * 128, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // out = O / max(l, 1e-30) in bf16, lse in f32, rows < Sq, columns < D
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= Sq) continue;
      const float li = fmaxf(l[hr], 1e-30f);
      __nv_bfloat16* orow = out + (static_cast<int64_t>(bh) * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + c;
        if (col >= D) continue;
        const float a = __fdiv_rn(o[4 * j + 2 * hr], li);
        const float z = __fdiv_rn(o[4 * j + 2 * hr + 1], li);
        if ((D & 1) == 0) {  // col + 1 < D, 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(a, z);
        } else {
          orow[col] = __float2bfloat16(a);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(z);
        }
      }
      if ((lane & 3) == 0)
        lse[static_cast<int64_t>(bh) * Sq + row] =
            m[hr] == -INFINITY ? -INFINITY : __fadd_rn(m[hr], logf(li));
    }
  }
}

// ---- host side -----------------------------------------------------------

// A rank-4 {Dp, S, H, B} map of boxes {64, 128, 1, 1} over a bf16 tensor
// with element strides {b, h, s} and a contiguous last dimension
bool make_bf16_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
                   int Dp, const int64_t* st) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, B, H, S, Dp,
                  st, kBox, kBK);
}

}  // namespace

extern "C" {

// q [B, H, Sq, Dp], k and v [B, H, Sk, Dp] in bf16 with element strides
// {batch, head, sequence} in *_strides, meeting TMA's rules (see the top of
// this file); out [B, H, Sq, D] bf16 contiguous, lse [B, H, Sq] f32
// contiguous; 1 <= D <= Dp <= 128, Dp % 8 == 0, B·H >= 1, Sq >= 1, Sk >= 0.
// Enqueues on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for operands it does not take or a tensor map the
// driver refuses: a refused launch never runs.
int flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int H, int Sq, int Sk,
                          int Dp, int D, float scale, int causal,
                          const int64_t* q_strides, const int64_t* k_strides,
                          const int64_t* v_strides, void* stream) {
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int64_t nq = (static_cast<int64_t>(Sq) + kBQ - 1) / kBQ;
  if (D < 1 || D > Dp || Dp > kD || Dp % 8 != 0 || BH < 1 || Sq < 1 ||
      Sk < 0 || BH * nq > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!make_bf16_map(&qm, q, B, H, Sq, Dp, q_strides))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sk == 0) {
    km = vm = qm;  // never read: there is no key tile
  } else if (!make_bf16_map(&km, k, B, H, Sk, Dp, k_strides) ||
             !make_bf16_map(&vm, v, B, H, Sk, Dp, v_strides)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_sm90_kernel<<<static_cast<unsigned>(BH * nq), kThreads,
                          kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), lse,
      static_cast<int>(BH), H, Sq, Sk, D, static_cast<int>(nq), scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
