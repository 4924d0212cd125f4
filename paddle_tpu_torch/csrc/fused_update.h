// Plain C interface of fused_update.cu, shared with kernels_binding.cpp.

#pragma once

#include <cstdint>

// One member of an adam bucket: where its four operands are read and its
// three results written (an output may be its own input: the update is
// elementwise, and each element is read before the thread that owns it
// writes it), its length, and its gradient's type (f32, or bf16 when
// g_bf16 is 1). Every operand is contiguous on one CUDA device.
struct AdamMember {
  const float* p;
  const void* g;
  const float* m1;
  const float* m2;
  float* p_out;
  float* m1_out;
  float* m2_out;
  int64_t n;
  int g_bf16;
};

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronize would not report it.
int momentum_bucket_launch(const float* p, const float* g, const float* v,
                           const float* lr, float mu, int nesterov,
                           float* p_out, float* v_out, int64_t n,
                           void* stream);

// Updates `count` members in as few launches as the kernel's parameter
// table allows (one for any bucket of the fusion plans); the number of
// launches goes to *launches (0 when every member is empty).
int adam_bucket_launch(const AdamMember* members, int count,
                       const float* lr_t, float b1, float omb1, float b2,
                       float omb2, float eps, void* stream, int* launches);

}  // extern "C"
