// Fused bucket weight updates for sm_90a: momentum and adam over one flat
// f32 bucket. Built by torch.utils.cpp_extension.load
// (paddle_tpu_torch/cuda_build.py) together with kernels_binding.cpp, which
// binds the launchers below to PyTorch; this file keeps a plain C interface
// and includes no PyTorch header.
//
// Replaces paddle_tpu/fusion/kernels.py::momentum_bucket (_momentum_kernel)
// and ::adam_bucket (_adam_kernel), Pallas TPU kernels that walk the bucket
// as zero-padded (8, 128) VMEM blocks. Here there is no padding: one
// grid-stride pass with a tail guard, each thread reading its elements once
// and writing each output once.
//
// Bound: bytes. Momentum moves 20 B per element (p, g, v in; p', v' out)
// for 4 flops, adam 28 B for about 11: both sit far below the card's
// flop-per-byte balance, so the design goal is one pass at full memory
// rate. Loads are scalar and coalesced; vector loads come later.
//
// Numerics: every operation is written as a separately rounded intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn) in the order
// of the scalar op's torch expression (ops/optimizer_ops.py), and the build
// passes -fmad=false, so nvcc contracts no multiply-add into an FMA. PyTorch's
// eager kernels round after every operation, so the kernel matches the
// unfused ops bit for bit. The learning rate is read from device memory so a
// step never syncs to the host.

#include <cstdint>

#include <cuda_runtime.h>

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

__global__ void adam_kernel(const float* __restrict__ p,
                            const float* __restrict__ g,
                            const float* __restrict__ m1,
                            const float* __restrict__ m2,
                            const float* __restrict__ lr_t_ptr, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float* __restrict__ p_out,
                            float* __restrict__ m1_out,
                            float* __restrict__ m2_out, int64_t n) {
  const float lr_t = *lr_t_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    // m1' = b1 * m1 + (1 - b1) * g
    const float m1n = __fadd_rn(__fmul_rn(b1, m1[i]), __fmul_rn(omb1, gi));
    // m2' = b2 * m2 + (1 - b2) * (g * g)
    const float m2n =
        __fadd_rn(__fmul_rn(b2, m2[i]), __fmul_rn(omb2, __fmul_rn(gi, gi)));
    m1_out[i] = m1n;
    m2_out[i] = m2n;
    // p' = p - lr_t * m1' / (sqrt(m2') + eps)
    p_out[i] = __fsub_rn(
        p[i], __fdiv_rn(__fmul_rn(lr_t, m1n), __fadd_rn(__fsqrt_rn(m2n), eps)));
  }
}

int blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronize would not report it.
int momentum_bucket_launch(const float* p, const float* g, const float* v,
                           const float* lr, float mu, int nesterov,
                           float* p_out, float* v_out, int64_t n,
                           void* stream) {
  momentum_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      p, g, v, lr, mu, nesterov, p_out, v_out, n);
  return static_cast<int>(cudaGetLastError());
}

int adam_bucket_launch(const float* p, const float* g, const float* m1,
                       const float* m2, const float* lr_t, float b1,
                       float omb1, float b2, float omb2, float eps,
                       float* p_out, float* m1_out, float* m2_out, int64_t n,
                       void* stream) {
  adam_kernel<<<blocks_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      p, g, m1, m2, lr_t, b1, omb1, b2, omb2, eps, p_out, m1_out, m2_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
