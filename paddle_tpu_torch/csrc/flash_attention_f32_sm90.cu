// Flash-attention forward in f32 for sm_90a on the tensor cores: exact
// softmax(q·kᵀ·scale)·v over [B, H, S, D] with D <= 128, streamed over key
// tiles so the [Sq, Sk] score matrix never reaches device memory. Built by
// torch.utils.cpp_extension.load (paddle_tpu_torch/cuda_build.py) together
// with kernels_binding.cpp, which binds split_tf32_launch and
// flash_fwd_tf32_launch below to PyTorch; this file keeps a plain C
// interface and includes no PyTorch header. The bf16 forward is
// flash_attention_sm90.cu; sm90_common.cuh holds the mbarrier, TMA and
// wgmma helpers both use.
//
// Replaces paddle_tpu/parallel/flash.py:81 _flash_fwd (Pallas kernel
// _kernel) for f32, which runs a (B·H, q-block, k-block) grid whose k axis
// is sequential on one TPU core and carries m, l and acc in VMEM scratch.
//
// Bound: operations. At full width (B=1, H=32, S=4096, D=128) the forward
// does 275 GFLOP (137 causal) against 269 MB of operands. f32 has no
// tensor-core type of its own, so both products run as 3xTF32: each
// operand x splits into big = tf32(x) and small = tf32(x - big) (x - big
// is exact in f32), and a·b is taken as a_s·b_b + a_b·b_s + a_b·b_b, the
// small terms first, on wgmma's TF32 path. That is 3 × 275 GFLOP at 495
// TFLOP/s: 1.666 ms (0.833 causal), far above the 0.080 ms of bytes. A
// single TF32 product keeps 11 bits of each operand and misses the f32
// limit this forward is held to (atol 2e-5, rtol 1e-4).
//
// Two kernels:
//   - split_tf32_kernel, the prologue: K into K_big and K_small [B, H, Sk,
//     Dk] (Dk = D rounded up to 4, zero columns past D) and V into Vᵀ_big
//     and Vᵀ_small [B, H, D, Sk8] (Sk8 = Sk rounded up to 8, zero keys past
//     Sk), each rounded explicitly with cvt.rna.tf32.f32. tf32 wgmma reads
//     both operands K-major only (no transpose bit for 32-bit types), so
//     P·V needs V with its keys contiguous: the prologue writes it so,
//     through a 32×32 shared-memory transpose, once per call instead of
//     once per q-tile. Within every group of 8 keys, column p of Vᵀ holds
//     key π(p) = [0, 2, 4, 6, 1, 3, 5, 7][p] (see P·V below). It moves 2×
//     the operands' K and V bytes out for 1× in: at full width 134 MB in,
//     268 MB out.
//   - flash_fwd_tf32_kernel: one block per (128-row q-tile, b·h), q-tiles
//     on gridDim.y with the heaviest (last, under causal masking) first, 3
//     warpgroups. Warpgroups 0 and 1 are consumers, each owning 64 query
//     rows; warpgroup 2 is the producer, whose one elected thread issues
//     TMA loads. setmaxnreg moves registers from the producer (24) to the
//     consumers (240).
//   - Shared memory (193 KB, one block per SM): a ring of 3 slots of 64 KB.
//     A step of 64 keys takes two slots in turn: its K tile (big and small,
//     [64 keys × 128] each, four 32-column TMA boxes) and then its Vᵀ tile
//     (big and small, [128 × 64 keys] each, two 32-key boxes), all in the
//     128-byte swizzle. Each slot has a `full` mbarrier that TMA completes
//     by bytes and an `empty` one the 8 consumer warps arrive on once they
//     have read it, so the producer runs up to 3 tiles ahead and the two
//     consumers may drift a tile apart. A 64-key step needs 128 KB of
//     tiles: 3 slots of 64 KB hold 1.5 steps where whole K+V stages would
//     hold one.
//   - Q stays out of shared memory: each consumer thread loads its 64 raw
//     f32 values of Q once, in the register-A fragment layout of tf32
//     wgmma m64k8 (CuTe's ALayout_64x8: thread t holds rows r, r+8 and
//     columns c, c+4 of each 8-column slice, r = 16·warp + lane/4,
//     c = lane % 4), and splits each slice when it is issued. The splits
//     do not change from step to step, so the compiler hoists them out of
//     the key loop: 128 live registers, some of which ptxas spills to
//     local memory and reloads every step (chip_smoke.py phase 2 prints
//     the kernel's stack). Redoing the splits in every step instead
//     spills nothing but puts 64 splits a thread back into every step.
//   - S = Q·Kᵀ: wgmma m64n64k8, 16 slices of 8 over D, 3 products each, A
//     from registers, B (K) K-major in shared memory; f32 accumulator in 32
//     registers. A register operand is read asynchronously, so a split
//     slice must live until its product completes: slices go in chunks of
//     2 (6 products a commit group) and a chunk's registers are reused two
//     chunks later, after wgmma.wait_group 1.
//   - The online softmax runs in registers: in the accumulator layout one
//     row lives in a quad of 4 threads, reduced with two xor-shuffles.
//   - O += P·V: wgmma m64n128k8, 8 slices of 8 keys, 3 products each, P's
//     parts from registers, B (Vᵀ) K-major in shared memory; O in 64
//     registers. The accumulator of an 8-key slice holds keys 2c and 2c+1
//     in thread c of a quad, while the A fragment wants A-columns c and
//     c+4 there: A-column p is key π(p), which the prologue's column order
//     of Vᵀ matches, so P goes from accumulator to A fragment unmoved.
//   - The tensor maps are rank 4 ({W, S, H, B}); rows past a head's keys and
//     columns past Dk or Sk8 come back zero: keys >= Sk score 0 and are
//     masked here, and their Vᵀ columns are zero.
//
// What it computes, per row (the JAX kernel's arithmetic, flash.py:44-62):
//   s    = (q·kᵀ accumulated in f32) * scale; -inf where masked
//   m'   = max(m, max s); m_safe = m' == -inf ? 0 : m'
//   p    = exp(s - m_safe)            (0 where s is -inf)
//   corr = m == -inf ? 0 : exp(m - m_safe)
//   l'   = corr * l + Σ p;  acc' = corr * acc + p · V
// with exp(x - y) taken as exp2f(x·log2(e) - y·log2(e)), one __fmaf_rn (the
// build passes -fmad=false). At the end out = acc / max(l, 1e-30) and
// lse = m == -inf ? -inf : m + log(max(l, 1e-30)), both f32.
//
// Operands: q f32 with any element strides and a contiguous last dimension,
// read in place; the prologue reads k and v the same way and hands the
// forward fresh, packed, 16-byte aligned parts, so no operand is copied for
// TMA.

#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 128;       // query rows of a block, 64 per consumer
constexpr int kBK = 64;        // keys of a step
constexpr int kD = 128;        // head width every D <= 128 runs at
constexpr int kBoxW = 32;      // f32 columns of one TMA box: 128 bytes
constexpr int kSlots = 3;      // K or Vᵀ tiles in flight
constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr uint32_t kKBoxBytes = kBK * kBoxW * 4;   // 8 KB: 64 keys × 32
constexpr uint32_t kVBoxBytes = kD * kBoxW * 4;    // 16 KB: 128 × 32 keys
constexpr uint32_t kPartBytes = kBK * kD * 4;      // 32 KB: big or small
constexpr uint32_t kTileBytes = 2 * kPartBytes;    // big, then small
constexpr uint32_t kBarOffset = kSlots * kTileBytes;
// barriers: full and empty of every slot
constexpr uint32_t kSmemBytes = kBarOffset + 8 * 2 * kSlots + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
static_assert(4 * kKBoxBytes == kPartBytes && 2 * kVBoxBytes == kPartBytes,
              "tile shapes");
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSplitKeys = 32;  // keys of one prologue block
constexpr int kSplitThreads = 256;

// x rounded to tf32 (10 mantissa bits, the low 13 zero), to nearest with
// ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_store(float x, float* big,
                                            float* small) {
  const float b = __uint_as_float(to_tf32(x));
  *big = b;
  *small = __uint_as_float(to_tf32(__fsub_rn(x, b)));
}

// ---- wgmma in tf32 -------------------------------------------------------

// d (64 × 64 f32) = (accumulate ? d : 0) + A (64 × 8 tf32, four registers
// a thread) · B (8 × 64), B K-major in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : SM90_ACC32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d (64 × 128 f32) += A (64 × 8 tf32, four registers a thread) · B
// (8 × 128), B K-major in shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SM90_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
      : SM90_ACC64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// ---- the prologue --------------------------------------------------------

// One block per (32 keys, b·h), blocks flattened on gridDim.x: the K rows
// split in place, then the Vᵀ columns through a 32×32 shared transpose.
__global__ void __launch_bounds__(kSplitThreads)
    split_tf32_kernel(const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ kb,
                      float* __restrict__ ks, float* __restrict__ vtb,
                      float* __restrict__ vts, int H, int Sk, int D, int Dk,
                      int Sk8, int n_chunks, int64_t kst_b, int64_t kst_h,
                      int64_t kst_s, int64_t vst_b, int64_t vst_h,
                      int64_t vst_s) {
  __shared__ float tile[kSplitKeys][kSplitKeys + 1];
  const int bh = static_cast<int>(blockIdx.x) / n_chunks;
  const int s0 = static_cast<int>(blockIdx.x) % n_chunks * kSplitKeys;
  const int b = bh / H, h = bh % H;
  const float* kh = k + b * kst_b + h * kst_h;
  const float* vh = v + b * vst_b + h * vst_h;

  // K: rows s0.. of width Dk, zero columns past D
  const int rows = min(kSplitKeys, Sk - s0);
  for (int e = threadIdx.x; e < rows * Dk; e += kSplitThreads) {
    const int s = s0 + e / Dk, d = e % Dk;
    const float x = d < D ? kh[s * kst_s + d] : 0.f;
    const int64_t o = (static_cast<int64_t>(bh) * Sk + s) * Dk + d;
    split_store(x, kb + o, ks + o);
  }

  // Vᵀ: column pos of a row holds key π(pos) of its group of 8; keys past
  // Sk are staged as zeros
  const int tx = threadIdx.x % kSplitKeys, ty = threadIdx.x / kSplitKeys;
  const int pos = s0 + tx;
  const int key = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);  // local
  for (int d0 = 0; d0 < D; d0 += kSplitKeys) {
    for (int i = ty; i < kSplitKeys; i += kSplitThreads / kSplitKeys) {
      const int s = s0 + i, d = d0 + tx;
      tile[i][tx] = s < Sk && d < D ? vh[s * vst_s + d] : 0.f;
    }
    __syncthreads();
    if (pos < Sk8) {
      for (int i = ty; i < kSplitKeys; i += kSplitThreads / kSplitKeys) {
        const int d = d0 + i;
        if (d >= D) break;
        const int64_t o = (static_cast<int64_t>(bh) * D + d) * Sk8 + pos;
        split_store(tile[key][i], vtb + o, vts + o);
      }
    }
    __syncthreads();
  }
}

// ---- the forward ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap kb_map,
                          const __grid_constant__ CUtensorMap ks_map,
                          const __grid_constant__ CUtensorMap vb_map,
                          const __grid_constant__ CUtensorMap vs_map,
                          const float* __restrict__ q,
                          float* __restrict__ out, float* __restrict__ lse,
                          int H, int Sq, int Sk, int D, float scale,
                          int causal, int64_t qst_b, int64_t qst_h,
                          int64_t qst_s) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned shared addresses
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t bars = base + kBarOffset;
  auto slot = [&](int t) { return base + (t % kSlots) * kTileBytes; };
  auto full = [&](int t) { return bars + 8 * (t % kSlots); };
  auto empty = [&](int t) { return bars + 8 * (kSlots + t % kSlots); };
  // the phase of tile t's slot that tile t fills
  auto phase = [](int t) { return static_cast<uint32_t>(t / kSlots) & 1; };

  const int bh = static_cast<int>(blockIdx.x);
  const int b = bh / H, h = bh % H;
  const int q0 = (static_cast<int>(gridDim.y - 1 - blockIdx.y)) * kBQ;
  const int nk_all = (Sk + kBK - 1) / kBK;
  // steps of 64 keys each warpgroup needs, the producer serving the larger
  auto steps = [&](int row_min) {
    return causal ? min(nk_all, row_min / kBK + 1) : nk_all;
  };
  const int nk = steps(q0 + kBQ / 2);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
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
      for (int t = 0; t < 2 * nk; ++t) {
        // the slot's previous tile, t - kSlots, must be consumed
        if (t >= kSlots) mbar_wait(empty(t), phase(t) ^ 1);
        const int k0 = t / 2 * kBK;
        const uint32_t dst = slot(t);
        mbar_expect_tx(full(t), kTileBytes);
        if (t % 2 == 0) {  // K: four 32-column boxes of 64 keys per part
          for (int x = 0; x < 4; ++x) {
            tma_load(dst + x * kKBoxBytes, &kb_map, full(t), x * kBoxW, k0,
                     h, b);
            tma_load(dst + kPartBytes + x * kKBoxBytes, &ks_map, full(t),
                     x * kBoxW, k0, h, b);
          }
        } else {  // Vᵀ: two 32-key boxes of 128 rows per part
          for (int x = 0; x < 2; ++x) {
            tma_load(dst + x * kVBoxBytes, &vb_map, full(t), k0 + x * kBoxW,
                     0, h, b);
            tma_load(dst + kPartBytes + x * kVBoxBytes, &vs_map, full(t),
                     k0 + x * kBoxW, 0, h, b);
          }
        }
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
    const int my_nk = steps(row_min);

    // Q in the A-fragment layout: qr[4·kk + j] is row row0 + 8·(j % 2),
    // column 8·kk + lane % 4 + 4·(j / 2)
    float qr[64];
    const float* qh = q + b * qst_b + h * qst_h;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row0 + 8 * (j % 2);
        const int col = 8 * kk + lane % 4 + 4 * (j / 2);
        qr[4 * kk + j] =
            row < Sq && col < D ? qh[row * qst_s + col] : 0.f;
      }

    float o[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;

    for (int kt = 0; kt < my_nk; ++kt) {
      const int tk = 2 * kt, tv = tk + 1;  // the step's K and Vᵀ tiles
      const int k0 = kt * kBK;
      const uint32_t ks = slot(tk), vs = slot(tv);

      // S = Q·Kᵀ: 16 slices of 8 over D, 4 in each 32-column box; the
      // split parts of a chunk of 2 slices are a[8·s + j] (big) and
      // a[8·s + 4 + j] (small)
      float sc[32];
      mbar_wait(full(tk), phase(tk));
#pragma unroll
      for (int ch = 0; ch < kD / 16; ++ch) {
        if (ch >= 2) wgmma_wait<1>();  // chunk ch - 2 is done with its parts
        uint32_t a[16];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = qr[4 * (2 * ch + s) + j];
            a[8 * s + j] = to_tf32(x);
            a[8 * s + 4 + j] =
                to_tf32(__fsub_rn(x, __uint_as_float(a[8 * s + j])));
          }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int kk = 2 * ch + s;
          const uint32_t off = (kk / 4) * kKBoxBytes + (kk % 4) * 32;
          const uint64_t kbig = smem_desc(ks + off, 16, 1024);
          const uint64_t ksmall = smem_desc(ks + kPartBytes + off, 16, 1024);
          const uint32_t* ab = a + 8 * s;
          const uint32_t* as = ab + 4;
          wgmma_n64(sc, as[0], as[1], as[2], as[3], kbig, kk > 0);
          wgmma_n64(sc, ab[0], ab[1], ab[2], ab[3], ksmall, 1);
          wgmma_n64(sc, ab[0], ab[1], ab[2], ab[3], kbig, 1);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty(tk));

      // scale, mask and the streaming softmax update; p overwrites s.
      // Keys >= Sk are zero rows and score 0, so they are masked here.
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > row_min);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
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
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hr + e;
            const float p = exp2f(__fmaf_rn(sc[i], kLog2e, -ms));  // -inf: 0
            rs = __fadd_rn(rs, p);
            sc[i] = p;
          }
#pragma unroll
        for (int j = 0; j < kD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[4 * j + 2 * hr + e] = __fmul_rn(o[4 * j + 2 * hr + e], corr);
        l[hr] = __fadd_rn(__fmul_rn(corr, l[hr]), quad_sum(rs));
        m[hr] = m_new;
      }

      // p's parts: A-columns (c/2, c/2 + 4) of slice j are keys (c, c + 1),
      // accumulator registers 4·j + {0, 1} (row r) and 4·j + {2, 3} (row
      // r + 8), so the fragment of slice j is {4j, 4j+2, 4j+1, 4j+3}
      uint32_t pb[32], ps[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        pb[i] = to_tf32(sc[i]);
        ps[i] = to_tf32(__fsub_rn(sc[i], __uint_as_float(pb[i])));
      }

      // O += P·V: Vᵀ's 8-key slices lie 32 bytes apart in a 32-key box
      mbar_wait(full(tv), phase(tv));
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint32_t off = (j / 4) * kVBoxBytes + (j % 4) * 32;
        const uint64_t vbig = smem_desc(vs + off, 16, 1024);
        const uint64_t vsmall = smem_desc(vs + kPartBytes + off, 16, 1024);
        wgmma_n128(o, ps[4 * j], ps[4 * j + 2], ps[4 * j + 1], ps[4 * j + 3],
                   vbig);
        wgmma_n128(o, pb[4 * j], pb[4 * j + 2], pb[4 * j + 1], pb[4 * j + 3],
                   vsmall);
        wgmma_n128(o, pb[4 * j], pb[4 * j + 2], pb[4 * j + 1], pb[4 * j + 3],
                   vbig);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(tv));
    }

    // out = O / max(l, 1e-30) and lse, rows < Sq, columns < D
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= Sq) continue;
      const float li = fmaxf(l[hr], 1e-30f);
      float* orow = out + (static_cast<int64_t>(bh) * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int col = 8 * j + c;
        if (col >= D) continue;
        const float x = __fdiv_rn(o[4 * j + 2 * hr], li);
        const float y = __fdiv_rn(o[4 * j + 2 * hr + 1], li);
        if ((D & 1) == 0) {  // col + 1 < D, 8-byte aligned
          *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
        } else {
          orow[col] = x;
          if (col + 1 < D) orow[col + 1] = y;
        }
      }
      if ((lane & 3) == 0)
        lse[static_cast<int64_t>(bh) * Sq + row] =
            m[hr] == -INFINITY ? -INFINITY : __fadd_rn(m[hr], logf(li));
    }
  }
}

// ---- host side -----------------------------------------------------------

int round_up(int x, int to) { return (x + to - 1) / to * to; }

// a rank-4 map over one packed part: K parts {Dk, Sk, H, B} in boxes of
// 32 columns × 64 keys, Vᵀ parts {Sk8, D, H, B} in boxes of 32 keys × 128
bool make_part_map(CUtensorMap* map, const float* part, int B, int H,
                   int rows, int width, int box_rows) {
  const int64_t st[3] = {static_cast<int64_t>(H) * rows * width,
                         static_cast<int64_t>(rows) * width, width};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, part, B, H, rows,
                  width, st, kBoxW, box_rows);
}

}  // namespace

extern "C" {

// k and v [B, H, Sk, D] f32 with element strides {batch, head, sequence}
// in *_strides and a contiguous last dimension; kb, ks [B, H, Sk, Dk] and
// vtb, vts [B, H, D, Sk8] f32 contiguous (Dk = D rounded up to 4, Sk8 = Sk
// rounded up to 8); 1 <= D <= 128, B·H >= 1, Sk >= 1. Enqueues on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for operands it
// does not take: a refused launch never runs.
int split_tf32_launch(const float* k, const float* v, float* kb, float* ks,
                      float* vtb, float* vts, int B, int H, int Sk, int D,
                      const int64_t* k_strides, const int64_t* v_strides,
                      void* stream) {
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int Sk8 = round_up(Sk, 8);
  const int64_t n_chunks = (Sk8 + kSplitKeys - 1) / kSplitKeys;
  if (D < 1 || D > kD || BH < 1 || Sk < 1 || Sk > INT32_MAX - 8 ||
      BH * n_chunks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  split_tf32_kernel<<<static_cast<unsigned>(BH * n_chunks), kSplitThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      k, v, kb, ks, vtb, vts, H, Sk, D, round_up(D, 4), Sk8,
      static_cast<int>(n_chunks), k_strides[0], k_strides[1], k_strides[2],
      v_strides[0], v_strides[1], v_strides[2]);
  return static_cast<int>(cudaGetLastError());
}

// q [B, H, Sq, D] f32 with element strides {batch, head, sequence} in
// q_strides and a contiguous last dimension; kb, ks, vtb, vts the parts
// split_tf32_launch wrote for Sk keys; out [B, H, Sq, D] f32 contiguous,
// lse [B, H, Sq] f32 contiguous; 1 <= D <= 128, B·H >= 1, Sq >= 1,
// Sk >= 0. Enqueues on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for operands it does not take or a tensor map the
// driver refuses: a refused launch never runs (more than 65535 q-tiles of
// 128 rows exceed the grid's y dimension).
int flash_fwd_tf32_launch(const float* q, const float* kb, const float* ks,
                          const float* vtb, const float* vts, float* out,
                          float* lse, int B, int H, int Sq, int Sk, int D,
                          float scale, int causal, const int64_t* q_strides,
                          void* stream) {
  const int64_t BH = static_cast<int64_t>(B) * H;
  if (D < 1 || D > kD || BH < 1 || BH > INT32_MAX || Sq < 1 || Sk < 0 ||
      Sk > INT32_MAX - 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kbm{}, ksm{}, vbm{}, vsm{};  // never read when Sk == 0
  if (Sk > 0) {
    const int Dk = round_up(D, 4), Sk8 = round_up(Sk, 8);
    if (!make_part_map(&kbm, kb, B, H, Sk, Dk, kBK) ||
        !make_part_map(&ksm, ks, B, H, Sk, Dk, kBK) ||
        !make_part_map(&vbm, vtb, B, H, D, Sk8, kD) ||
        !make_part_map(&vsm, vts, B, H, D, Sk8, kD))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((static_cast<int64_t>(Sq) + kBQ - 1) /
                                        kBQ));
  flash_fwd_tf32_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      kbm, ksm, vbm, vsm, q, out, lse, H, Sq, Sk, D, scale, causal,
      q_strides[0], q_strides[1], q_strides[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
