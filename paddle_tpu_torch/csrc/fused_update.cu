// Fused bucket weight updates for sm_90a: momentum over one flat f32
// bucket, adam over a bucket's member tensors where they lie. Built by
// torch.utils.cpp_extension.load (paddle_tpu_torch/cuda_build.py) together
// with kernels_binding.cpp, which binds the launchers below to PyTorch;
// this file keeps a plain C interface (fused_update.h) and includes no
// PyTorch header.
//
// Replaces paddle_tpu/fusion/kernels.py::momentum_bucket (_momentum_kernel)
// and ::adam_bucket (_adam_kernel), Pallas TPU kernels that walk one flat
// bucket as zero-padded (8, 128) VMEM blocks.
//
// Bound: bytes. Momentum moves 20 B per element (p, g, v in; p', v' out)
// for 4 flops; adam 28 B (26 B with a bf16 gradient) for about 11. Both
// sit far below the card's flop-per-byte balance, so the design goal is
// one pass at full memory rate.
//
// momentum_kernel: one grid-stride pass with a tail guard over the packed
// lane, scalar coalesced loads.
//
// adam_kernel: the TPU needed the flat lane; this kernel does not, so the
// op hands it the bucket's own tensors and it updates them in place
// (fusion/kernels.py::adam_bucket_), with no pack before it and no copy
// back after. What the design does about the bytes:
//   - One launch over a table of members (pointers, length, grad type)
//     passed in the kernel's parameters: nothing is copied to the device
//     first, and a captured graph holds the table.
//   - One block per 1024-element chunk of one member, one 16-byte vector
//     a thread (8 bytes of a bf16 gradient), where all of a member's
//     operands are aligned to their vectors; a misaligned member and each
//     member's ragged tail take scalar accesses. Chunks are numbered across
//     the table, and a block finds its member by a binary search over the
//     members' first chunks. At 32 registers a thread, eight blocks (2048
//     threads, an SM's most) fit an SM, and the block scheduler hands each
//     free slot the next chunk, so a 64-element bias and a 2.4M-element
//     weight in one table both keep every SM busy, and a launch's tail is
//     one chunk. Measured on the card, this beat a grid sized to what the
//     card holds at once (occupancy x SMs) striding over 1024- to
//     4096-element chunks with up to four vectors of each operand in
//     flight a thread: at VGG-16's buckets, and at the MLP's and the MNIST
//     conv net's, whose few chunks the larger ones left on a few SMs.
//   - Streaming cache hints (ld/st.global.cs, evict first): every byte is
//     touched once. p, m1 and m2 are written by this kernel, so nothing is
//     read through the non-coherent (.nc) path.
//   - A bf16 gradient is read as it lies and widened in registers
//     (exactly), so AMP's bf16 grads move 2 B an element, not a cast copy.
//
// Numerics: every operation is written as a separately rounded intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn) in the order
// of the scalar op's torch expression (ops/optimizer_ops.py), and the build
// passes -fmad=false, so nvcc contracts no multiply-add into an FMA. PyTorch's
// eager kernels round after every operation, so the kernels match the
// unfused ops bit for bit. The learning rate is read from device memory so a
// step never syncs to the host.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_update.h"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 132 SMs, enough blocks in flight

__global__ void momentum_kernel(const float* __restrict__ p,
                                const float* __restrict__ g,
                                const float* __restrict__ v,
                                const float* __restrict__ lr_ptr, float mu,
                                int nesterov, float* __restrict__ p_out,
                                float* __restrict__ v_out, int64_t n) {
  const float lr = *lr_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    // v' = mu * v + g
    const float vn = __fadd_rn(__fmul_rn(mu, v[i]), gi);
    v_out[i] = vn;
    if (nesterov) {
      // p' = p - (g + mu * v') * lr
      p_out[i] = __fsub_rn(p[i], __fmul_rn(__fadd_rn(gi, __fmul_rn(mu, vn)), lr));
    } else {
      // p' = p - lr * v'
      p_out[i] = __fsub_rn(p[i], __fmul_rn(lr, vn));
    }
  }
}

int blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

// ---------------------------------------------------------------------------
// adam
// ---------------------------------------------------------------------------
constexpr int kAdamThreads = 256;
// elements a block takes: one 4-element vector for each thread
constexpr int64_t kChunk = int64_t{kAdamThreads} * 4;

// The kernel parameter space: 32,764 bytes from CUDA 12.1 on (sm_70 and
// later), 4,096 before.
#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;
#else
constexpr int kParamBytes = 4096;
#endif

// As many members as the parameter space holds beside the table's count
// and the kernel's other parameters (a pointer and five floats).
constexpr int kTableCap = static_cast<int>(
    (kParamBytes - 64) / (sizeof(AdamMember) + sizeof(int64_t)));

struct AdamTable {
  AdamMember m[kTableCap];
  // the number of each member's first chunk; chunks are numbered across
  // the members from 0, one block each. Apart from the members, so that
  // the search reads few cache lines of the parameter space.
  int64_t first[kTableCap];
  int count;
};
static_assert(sizeof(AdamTable) + sizeof(float*) + 5 * sizeof(float) <=
                  kParamBytes,
              "the adam table must fit the kernel parameter space");

struct AdamCoef {
  float lr_t, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_elem(const AdamCoef& c, float g,
                                          float& p, float& m1, float& m2) {
  // m1' = b1 * m1 + (1 - b1) * g
  m1 = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.omb1, g));
  // m2' = b2 * m2 + (1 - b2) * (g * g)
  m2 = __fadd_rn(__fmul_rn(c.b2, m2), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  // p' = p - lr_t * m1' / (sqrt(m2') + eps)
  p = __fsub_rn(
      p, __fdiv_rn(__fmul_rn(c.lr_t, m1), __fadd_rn(__fsqrt_rn(m2), c.eps)));
}

// bf16 -> f32 is exact
__device__ __forceinline__ float widen(unsigned int bits) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

template <bool kBf16>
__device__ __forceinline__ float load_g(const void* g, int64_t i) {
  if constexpr (kBf16) {
    return widen(__ldcs(static_cast<const unsigned short*>(g) + i));
  } else {
    return __ldcs(static_cast<const float*>(g) + i);
  }
}

// vector v: elements 4v .. 4v + 3 (in a bf16 lane, 8 bytes)
template <bool kBf16>
__device__ __forceinline__ float4 load_g4(const void* g, int64_t v) {
  if constexpr (kBf16) {
    const uint2 u = __ldcs(static_cast<const uint2*>(g) + v);
    return make_float4(widen(u.x & 0xffffu), widen(u.x >> 16),
                       widen(u.y & 0xffffu), widen(u.y >> 16));
  } else {
    return __ldcs(static_cast<const float4*>(g) + v);
  }
}

template <bool kBf16>
__device__ __forceinline__ void adam_one(const AdamMember& e, const AdamCoef& c,
                                         int64_t i) {
  float p = __ldcs(e.p + i), m1 = __ldcs(e.m1 + i), m2 = __ldcs(e.m2 + i);
  adam_elem(c, load_g<kBf16>(e.g, i), p, m1, m2);
  __stcs(e.m1_out + i, m1);
  __stcs(e.m2_out + i, m2);
  __stcs(e.p_out + i, p);
}

template <bool kBf16>
__device__ __forceinline__ void adam_vec(const AdamMember& e, const AdamCoef& c,
                                         int64_t v) {
  float4 p = __ldcs(reinterpret_cast<const float4*>(e.p) + v);
  float4 m1 = __ldcs(reinterpret_cast<const float4*>(e.m1) + v);
  float4 m2 = __ldcs(reinterpret_cast<const float4*>(e.m2) + v);
  const float4 g = load_g4<kBf16>(e.g, v);
  adam_elem(c, g.x, p.x, m1.x, m2.x);
  adam_elem(c, g.y, p.y, m1.y, m2.y);
  adam_elem(c, g.z, p.z, m1.z, m2.z);
  adam_elem(c, g.w, p.w, m1.w, m2.w);
  __stcs(reinterpret_cast<float4*>(e.m1_out) + v, m1);
  __stcs(reinterpret_cast<float4*>(e.m2_out) + v, m2);
  __stcs(reinterpret_cast<float4*>(e.p_out) + v, p);
}

// Elements [begin, end) of member e; begin is a multiple of kChunk.
template <bool kBf16>
__device__ __forceinline__ void adam_chunk(const AdamMember& e,
                                           const AdamCoef& c, int64_t begin,
                                           int64_t end) {
  const int t = threadIdx.x;
  // 16-byte accesses need every operand aligned to its vector (8 bytes
  // for a bf16 gradient)
  const uintptr_t f32s = reinterpret_cast<uintptr_t>(e.p) |
                         reinterpret_cast<uintptr_t>(e.m1) |
                         reinterpret_cast<uintptr_t>(e.m2) |
                         reinterpret_cast<uintptr_t>(e.p_out) |
                         reinterpret_cast<uintptr_t>(e.m1_out) |
                         reinterpret_cast<uintptr_t>(e.m2_out);
  const bool vec = f32s % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e.g) % (kBf16 ? 8 : 16) == 0;
  if (vec) {
    // one vector a thread, then the member's ragged tail (< 4 elements)
    const int64_t v = begin / 4 + t;
    if (v < end / 4) adam_vec<kBf16>(e, c, v);
    const int64_t i = end / 4 * 4 + t;
    if (i < end) adam_one<kBf16>(e, c, i);
  } else {
    for (int64_t i = begin + t; i < end; i += kAdamThreads) {
      adam_one<kBf16>(e, c, i);
    }
  }
}

// One block per chunk: the card's block scheduler hands the next chunk to
// whichever SM frees a slot first, so the tail of a launch is one chunk.
__global__ void __launch_bounds__(kAdamThreads)
    adam_kernel(const __grid_constant__ AdamTable table,
                const float* lr_t_ptr, float b1, float omb1, float b2,
                float omb2, float eps) {
  const int64_t ch = blockIdx.x;
  // the member holding chunk ch: the last whose first chunk is <= ch
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.first[mid] <= ch) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const AdamMember e = table.m[lo];
  const AdamCoef c{*lr_t_ptr, b1, omb1, b2, omb2, eps};
  const int64_t begin = (ch - table.first[lo]) * kChunk;
  const int64_t end = begin + kChunk < e.n ? begin + kChunk : e.n;
  if (e.g_bf16) {
    adam_chunk<true>(e, c, begin, end);
  } else {
    adam_chunk<false>(e, c, begin, end);
  }
}

}  // namespace

extern "C" {

int momentum_bucket_launch(const float* p, const float* g, const float* v,
                           const float* lr, float mu, int nesterov,
                           float* p_out, float* v_out, int64_t n,
                           void* stream) {
  momentum_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      p, g, v, lr, mu, nesterov, p_out, v_out, n);
  return static_cast<int>(cudaGetLastError());
}

int adam_bucket_launch(const AdamMember* members, int count,
                       const float* lr_t, float b1, float omb1, float b2,
                       float omb2, float eps, void* stream, int* launches) {
  *launches = 0;
  AdamTable table{};
  int64_t chunks = 0;
  cudaError_t err = cudaSuccess;
  auto launch = [&]() {
    if (table.count == 0) return cudaSuccess;
    adam_kernel<<<static_cast<unsigned int>(chunks), kAdamThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        table, lr_t, b1, omb1, b2, omb2, eps);
    ++*launches;
    table.count = 0;
    chunks = 0;
    return cudaGetLastError();
  };
  for (int k = 0; k < count && err == cudaSuccess; ++k) {
    const AdamMember& m = members[k];
    if (m.n == 0) continue;
    table.m[table.count] = m;
    table.first[table.count++] = chunks;
    chunks += (m.n + kChunk - 1) / kChunk;
    if (table.count == kTableCap) err = launch();
  }
  if (err == cudaSuccess) err = launch();
  return static_cast<int>(err);
}

}  // extern "C"
