// PyTorch binding of every kernel of the port: the fused bucket updates in
// fused_update.cu and the flash-attention forward in flash_attention.cu
// (f32) and flash_attention_sm90.cu (bf16), built together with them into one extension by
// torch.utils.cpp_extension.load (paddle_tpu_torch/cuda_build.py). This is
// the one translation unit that includes PyTorch's headers; the kernels'
// own files keep a plain C interface, so nvcc compiles them without them.
//
// Each function checks what the kernel relies on, allocates fresh outputs,
// launches on PyTorch's current stream of the operands' device and raises
// if the launch was refused. It does not synchronise.

#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <cuda_runtime.h>

extern "C" {
int momentum_bucket_launch(const float* p, const float* g, const float* v,
                           const float* lr, float mu, int nesterov,
                           float* p_out, float* v_out, int64_t n,
                           void* stream);
int adam_bucket_launch(const float* p, const float* g, const float* m1,
                       const float* m2, const float* lr_t, float b1,
                       float omb1, float b2, float omb2, float eps,
                       float* p_out, float* m1_out, float* m2_out, int64_t n,
                       void* stream);
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int H, int Sq, int Sk,
                     int D, float scale, int causal, const int64_t* q_strides,
                     const int64_t* k_strides, const int64_t* v_strides,
                     void* stream);
int flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int H, int Sq, int Sk,
                          int Dp, int D, float scale, int causal,
                          const int64_t* q_strides, const int64_t* k_strides,
                          const int64_t* v_strides, void* stream);
}

namespace {

// Lanes: contiguous 1-D f32 of one length on one CUDA device; the scalar
// (lr or lr_t): one f32 element on the same device.
void check(const std::vector<torch::Tensor>& lanes,
           const torch::Tensor& scalar) {
  const auto& first = lanes.front();
  for (const auto& t : lanes) {
    TORCH_CHECK(t.is_cuda() && t.device() == first.device(),
                "every lane must be on one CUDA device");
    TORCH_CHECK(t.scalar_type() == torch::kFloat32, "float32 lanes only");
    TORCH_CHECK(t.dim() == 1 && t.is_contiguous() &&
                    t.numel() == first.numel(),
                "lanes must be contiguous 1-D of one length");
  }
  TORCH_CHECK(scalar.device() == first.device() &&
                  scalar.scalar_type() == torch::kFloat32 &&
                  scalar.numel() == 1,
              "the scalar operand must be one f32 element on the lanes' "
              "device");
}

void check_launch(int err) {
  TORCH_CHECK(err == cudaSuccess, "kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

}  // namespace

std::vector<torch::Tensor> momentum_bucket(torch::Tensor p, torch::Tensor g,
                                           torch::Tensor v, torch::Tensor lr,
                                           double mu, bool nesterov) {
  check({p, g, v}, lr);
  const c10::cuda::CUDAGuard guard(p.device());
  auto p_out = torch::empty_like(p);
  auto v_out = torch::empty_like(v);
  if (p.numel() > 0) {
    check_launch(momentum_bucket_launch(
        p.data_ptr<float>(), g.data_ptr<float>(), v.data_ptr<float>(),
        lr.data_ptr<float>(), static_cast<float>(mu), nesterov ? 1 : 0,
        p_out.data_ptr<float>(), v_out.data_ptr<float>(), p.numel(),
        c10::cuda::getCurrentCUDAStream().stream()));
  }
  return {p_out, v_out};
}

// b1, b2, eps and the complements omb1 = 1 - b1, omb2 = 1 - b2 arrive as
// python doubles (the complements taken there, as the scalar op takes
// them) and are rounded to f32 here, as torch rounds a python scalar for
// an f32 tensor.
std::vector<torch::Tensor> adam_bucket(torch::Tensor p, torch::Tensor g,
                                       torch::Tensor m1, torch::Tensor m2,
                                       torch::Tensor lr_t, double b1,
                                       double omb1, double b2, double omb2,
                                       double eps) {
  check({p, g, m1, m2}, lr_t);
  const c10::cuda::CUDAGuard guard(p.device());
  auto p_out = torch::empty_like(p);
  auto m1_out = torch::empty_like(m1);
  auto m2_out = torch::empty_like(m2);
  if (p.numel() > 0) {
    check_launch(adam_bucket_launch(
        p.data_ptr<float>(), g.data_ptr<float>(), m1.data_ptr<float>(),
        m2.data_ptr<float>(), lr_t.data_ptr<float>(), static_cast<float>(b1),
        static_cast<float>(omb1), static_cast<float>(b2),
        static_cast<float>(omb2), static_cast<float>(eps),
        p_out.data_ptr<float>(), m1_out.data_ptr<float>(),
        m2_out.data_ptr<float>(), p.numel(),
        c10::cuda::getCurrentCUDAStream().stream()));
  }
  return {p_out, m1_out, m2_out};
}

// q [B, H, Sq, Dp], k and v [B, H, Sk, Dp], one dtype (f32 or bf16) on one
// CUDA device; head_dim D is the width of the result, 1 <= D <= 128.
// f32 goes to the CUDA-core kernel with Dp == D; strided operands are read
// in place as long as their last dimension is contiguous, any other layout
// is copied by .contiguous() first. bf16 goes to the wgmma kernel, whose
// TMA loads need Dp % 8 == 0 (columns D..Dp zero), a 16-byte aligned base
// and strides of 16-byte multiples; parallel/flash.py::_tma_operand makes
// such operands, and anything else is refused here. Returns out [B, H, Sq,
// D] in the input dtype and lse [B, H, Sq] f32, both fresh and contiguous.
std::vector<torch::Tensor> flash_fwd(torch::Tensor q, torch::Tensor k,
                                     torch::Tensor v, double scale,
                                     bool causal, int64_t head_dim) {
  for (const auto* t : {&q, &k, &v}) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device(),
                "q, k and v must be on one CUDA device");
    TORCH_CHECK(t->dim() == 4, "q, k and v must be [B, H, S, D]");
    TORCH_CHECK(t->scalar_type() == q.scalar_type(),
                "q, k and v must share one dtype");
  }
  TORCH_CHECK(q.scalar_type() == torch::kFloat32 ||
                  q.scalar_type() == torch::kBFloat16,
              "flash_fwd takes float32 or bfloat16");
  const int64_t B = q.size(0), H = q.size(1), Sq = q.size(2);
  const int64_t Dp = q.size(3), Sk = k.size(2), D = head_dim;
  const bool bf16 = q.scalar_type() == torch::kBFloat16;
  TORCH_CHECK(k.size(0) == B && k.size(1) == H && v.size(0) == B &&
                  v.size(1) == H && v.size(2) == Sk,
              "k and v must be [B, H, Sk, D] beside q [B, H, Sq, D]");
  TORCH_CHECK(k.size(3) == Dp && v.size(3) == Dp,
              "q, k and v must share one head dim (Dv != Dq is not taken)");
  TORCH_CHECK(D >= 1 && D <= 128, "flash_fwd: head dim must be in [1, 128], "
              "got ", D);
  TORCH_CHECK(bf16 ? D <= Dp && Dp <= 128 : D == Dp,
              "flash_fwd: head_dim must be q's last dim (bf16: at most it, "
              "its zero padding)");
  if (bf16) {
    for (const auto* t : {&q, &k, &v}) {
      bool aligned = t->stride(3) == 1 && Dp % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0;
      for (int d = 0; d < 3; ++d)
        aligned = aligned && (t->size(d) == 1 || t->stride(d) % 8 == 0);
      TORCH_CHECK(aligned || t->numel() == 0,
                  "flash_fwd: bf16 operands must meet TMA's alignment "
                  "(parallel/flash.py::_tma_operand copies those that do "
                  "not)");
    }
  }
  // f32: Sq above 65535 q-tiles of 64 rows exceeds the grid's y dimension:
  // the launch is refused and check_launch raises
  TORCH_CHECK(B * H <= INT32_MAX && Sq <= INT32_MAX && Sk <= INT32_MAX,
              "flash_fwd: B*H, Sq and Sk must fit in int32");
  if (q.stride(3) != 1) q = q.contiguous();  // f32 only: bf16 is checked
  if (k.stride(3) != 1) k = k.contiguous();
  if (v.stride(3) != 1) v = v.contiguous();
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty({B, H, Sq, D}, q.options());
  auto lse = torch::empty({B, H, Sq}, q.options().dtype(torch::kFloat32));
  if (B * H > 0 && Sq > 0) {
    const int64_t qst[3] = {q.stride(0), q.stride(1), q.stride(2)};
    const int64_t kst[3] = {k.stride(0), k.stride(1), k.stride(2)};
    const int64_t vst[3] = {v.stride(0), v.stride(1), v.stride(2)};
    const auto stream = c10::cuda::getCurrentCUDAStream().stream();
    if (bf16) {
      check_launch(flash_fwd_sm90_launch(
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr<float>(), static_cast<int>(B), static_cast<int>(H),
          static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(Dp),
          static_cast<int>(D), static_cast<float>(scale), causal ? 1 : 0,
          qst, kst, vst, stream));
    } else {
      check_launch(flash_fwd_launch(
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr<float>(), static_cast<int>(B),
          static_cast<int>(H), static_cast<int>(Sq), static_cast<int>(Sk),
          static_cast<int>(D), static_cast<float>(scale), causal ? 1 : 0,
          qst, kst, vst, stream));
    }
  }
  return {out, lse};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("momentum_bucket", &momentum_bucket,
        "v' = mu*v + g; p' = p - lr*v' (Nesterov: p - (g + mu*v')*lr)");
  m.def("adam_bucket", &adam_bucket,
        "m1' = b1*m1 + (1-b1)*g; m2' = b2*m2 + (1-b2)*g*g; "
        "p' = p - lr_t*m1'/(sqrt(m2') + eps)");
  m.def("flash_fwd", &flash_fwd,
        "(out, lse) of softmax(q k^T * scale) v, causal top-left aligned");
}
