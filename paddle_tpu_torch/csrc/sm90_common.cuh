// What the port's two sm_90a flash-attention kernels share
// (flash_attention_sm90.cu in bf16, flash_attention_f32_sm90.cu in f32):
// mbarriers, TMA loads and their rank-4 tensor maps, wgmma shared-memory
// descriptors and the fence / commit / wait of asynchronous products, in
// PTX. Includes no PyTorch header; every definition has internal linkage,
// so each kernel file compiles its own copy.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace {

// ---- mbarrier and TMA ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a rank-4 {W, S, H, B} map into shared memory at `dst`,
// completing `bar` by its bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int w, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(w), "r"(s),
      "r"(h), "r"(b)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major tiles
// (rows of 128 bytes along the reduction) take sbo = 1024, the stride of
// 8-row groups, and an unused lbo; an MN-major tile takes lbo = the stride
// between its 128-byte column boxes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most `kPending` committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// operand lists of a 32- or 64-register accumulator d[] in inline PTX
#define SM90_ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_ACC32 SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
#define SM90_ACC64                                                         \
  SM90_ACC32, SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
#define SM90_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_REGS64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// ---- the online softmax: one accumulator row lives in a quad -------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---- host side -----------------------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// extension does not link libcuda itself
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A rank-4 {W, S, H, B} map of boxes {box_w, box_s, 1, 1} in the 128-byte
// swizzle (box_w · elem_bytes must be 128) over a tensor with element
// strides {b, h, s} in `st` and a contiguous last dimension of width W.
// Boxes reaching past W or S come back zero-filled. A dimension of extent
// 1 is never stepped, so its stride is replaced by a packed one (TMA wants
// multiples of 16 bytes even there); S = 0 is encoded as 1, since a map
// has no empty dimension.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* ptr, int B, int H, int S, int W, const int64_t* st,
              int box_w, int box_s) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const uint64_t s_ext = S > 0 ? S : 1;
  uint64_t s_str = st[2] * elem_bytes, h_str = st[1] * elem_bytes,
           b_str = st[0] * elem_bytes;
  if (s_ext == 1) s_str = static_cast<uint64_t>(W) * elem_bytes;
  if (H == 1) h_str = s_str * s_ext;
  if (B == 1) b_str = h_str * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), s_ext,
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {s_str, h_str, b_str};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_s), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
