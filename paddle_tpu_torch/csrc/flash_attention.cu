// Flash-attention forward for sm_90a in f32 on the CUDA cores: exact
// softmax(q·kᵀ·scale)·v over [B, H, S, D], streamed over key tiles so the
// [Sq, Sk] score matrix never reaches device memory. The bf16 forward runs
// on the tensor cores in flash_attention_sm90.cu. Built by
// torch.utils.cpp_extension.load (paddle_tpu_torch/cuda_build.py) together
// with kernels_binding.cpp, which binds flash_fwd_launch below to PyTorch;
// this file keeps a plain C interface and includes no PyTorch header.
//
// Replaces paddle_tpu/parallel/flash.py:81 _flash_fwd (Pallas kernel
// _kernel), which runs a (B·H, q-block, k-block) grid whose k axis is
// sequential on one TPU core and carries the running max m, normaliser l and
// accumulator acc in VMEM scratch. Here one thread block owns one
// (q-tile, b·h) pair and loops over the k-tiles itself, keeping m, l and acc
// in registers; under causal masking the loop stops at the tile that holds
// the diagonal. The ragged edges are masked in the kernel: key positions
// >= Sk score -inf (their K and V rows are staged as zeros), and query rows
// >= Sq are computed on zeros and never written. The JAX wrapper's padding
// and bias channel are not needed.
//
// What it computes, per row (the JAX kernel's arithmetic, flash.py:44-62):
//   s    = (q·kᵀ accumulated in f32) * scale; -inf where masked
//   m'   = max(m, max s); m_safe = m' == -inf ? 0 : m'
//   p    = s == -inf ? 0 : exp(s - m_safe)
//   corr = m == -inf ? 0 : exp(m - m_safe)
//   l'   = corr * l + Σ p;  acc' = corr * acc + p_v · V
// where p_v is p in the value dtype (f32 here: no rounding) and Σ p sums
// the unrounded p. At the end out = acc / max(l, 1e-30) and
// lse = m == -inf ? -inf : m + log(max(l, 1e-30)) in f32.
//
// Bound: operations. At the full width this is built for (S = 4096,
// D = 128) attention does 4·D = 512 flops per (query, key) pair against
// 4·D·elem_size bytes per query or key row, hundreds of flops per byte, far
// above the card's balance. This kernel runs on the CUDA cores: each of the
// 256 threads of a block owns a 4×4 patch of the 64×64 score tile and a
// 4-row slice of the output, and every inner step is two 16-byte shared
// loads feeding 16 (scores) or 32 (output) FMAs. Tensor-core products in
// f32 (3xTF32 split products), TMA staging and warp specialisation are
// later work.
//
// Numerics: the build passes -fmad=false for the bitwise update kernels, so
// every multiply-add here is an explicit __fmaf_rn; exp and log are the
// accurate expf/logf. The result matches the plain torch version to a
// tolerance, not bitwise: products are summed in another order.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows of a tile
constexpr int kBK = 64;          // keys of a tile
constexpr int kThreads = 256;    // 16 × 16 threads
constexpr int kRows = 4;         // query rows each thread owns
constexpr int kCols = 4;         // score columns each thread owns
constexpr int kStride = kBQ + 4; // row stride of the transposed Q, K and P
                                 // tiles: 16-byte aligned, fewer conflicts
static_assert(kBQ == 16 * kRows && kBK == 16 * kCols, "16×16 threads");

// Every head width D <= kD runs one instantiation: columns d >= D are
// staged as zeros, so they add nothing to the scores, and are never stored.
constexpr int kD = 128;
// output columns of thread tx: (j * 16 + tx) * 4 + w for j < 2, w < 4, so a
// half-warp reads 16-byte vectors of one V row side by side
constexpr int kNJ = kD / 64;
constexpr int kN = 4 * kNJ;
// f32 words of dynamic shared memory: the Q, K (transposed), V and P tiles
constexpr int kSmemFloats = 2 * kD * kStride + kBK * kD + kBK * kStride;

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

struct Strides {
  int64_t b, h, s;  // elements; the last dimension is contiguous
};

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk, int D,
                     float scale, int causal, Strides qs_, Strides ks_,
                     Strides vs_) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                  // [kD][kStride]  Q tile, transposed
  float* k_t = q_t + kD * kStride;    // [kD][kStride]  K tile, transposed
  float* v_s = k_t + kD * kStride;    // [kBK][kD]      V tile
  float* p_t = v_s + kBK * kD;        // [kBK][kStride] P tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx*4.., output columns above
  const int ty = tid / 16;  // rows ty*4..ty*4+3; one half-warp shares them
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // heaviest causal tiles (last q-tiles) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;

  for (int e = tid; e < kBQ * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    q_t[d * kStride + r] = (q0 + r < Sq && d < D)
                               ? qb[(q0 + r) * qs_.s + d]
                               : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kN];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kN; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's reads of k_t, v_s and p_t are done
    for (int e = tid; e < kBK * kD; e += kThreads) {
      const int c = e / kD, d = e % kD;
      const bool in = k0 + c < Sk && d < D;
      k_t[d * kStride + c] = in ? kb[(k0 + c) * ks_.s + d] : 0.f;
      v_s[c * kD + d] = in ? vb[(k0 + c) * vs_.s + d] : 0.f;
    }
    __syncthreads();

    // s = q·kᵀ for rows ty*4+i, keys tx*4+j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qa[kRows], ka[kCols];
      load4(q_t + d * kStride + ty * kRows, qa);
      load4(k_t + d * kStride + tx * kCols, ka);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          s[i][j] = __fmaf_rn(qa[i], ka[j], s[i][j]);
    }

    // scale, mask and the streaming softmax update; p overwrites s
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx * kCols + j;
        float x = __fmul_rn(s[i][j], scale);
        if (col >= Sk || (causal && row < col)) x = -INFINITY;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p =
            s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        rs = __fadd_rn(rs, p);
        s[i][j] = p;  // p_v = p: f32 needs no rounding
      }
      l[i] = __fadd_rn(__fmul_rn(corr, l[i]), half_warp_sum(rs));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kN; ++c)
        acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      *reinterpret_cast<float4*>(p_t + (tx * kCols + j) * kStride +
                                 ty * kRows) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p_v · V
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pa[kRows];
      load4(p_t + c * kStride + ty * kRows, pa);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        float va[4];
        load4(v_s + c * kD + (jj * 16 + tx) * 4, va);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            acc[i][jj * 4 + w] = __fmaf_rn(pa[i], va[w], acc[i][jj * 4 + w]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* o = out + (static_cast<int64_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int col = (jj * 16 + tx) * 4 + w;
        if (col < D) o[col] = __fdiv_rn(acc[i][jj * 4 + w], li);
      }
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * Sq + row] =
          m[i] == -INFINITY ? -INFINITY : __fadd_rn(m[i], logf(li));
  }
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int Sq, int Sk, int D, float scale, int causal,
           const int64_t* qst, const int64_t* kst, const int64_t* vst,
           cudaStream_t stream) {
  const int bytes = kSmemFloats * static_cast<int>(sizeof(float));
  // above 48 KB a block's shared memory must be asked for, or the launch
  // is refused
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, Sq, Sk, D,
      scale, causal, Strides{qst[0], qst[1], qst[2]},
      Strides{kst[0], kst[1], kst[2]}, Strides{vst[0], vst[1], vst[2]});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, H, Sq, D], k and v [B, H, Sk, D] with element strides
// {batch, head, sequence} in *_strides and a contiguous last dimension;
// out [B, H, Sq, D] contiguous, lse [B, H, Sq] f32 contiguous, all f32
// (bf16 goes to flash_fwd_sm90_launch); 1 <= D <= 128; B·H >= 1 and
// Sq >= 1 (Sk may be 0).
// Enqueues on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and a later synchronize would not report it.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int H, int Sq, int Sk,
                     int D, float scale, int causal, const int64_t* q_strides,
                     const int64_t* k_strides, const int64_t* v_strides,
                     void* stream) {
  if (D < 1 || D > kD || B * H < 1 || Sq < 1 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, out, lse, B, H, Sq, Sk, D, scale, causal, q_strides,
                k_strides, v_strides, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
