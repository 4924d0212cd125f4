// PyTorch binding of every kernel of the port: the fused bucket updates in
// fused_update.cu and the flash-attention forward in flash_attention_sm90.cu
// (bf16) and flash_attention_f32_sm90.cu (f32: its split prologue and its
// forward), built together with them into one extension by
// torch.utils.cpp_extension.load (paddle_tpu_torch/cuda_build.py). This is
// the one translation unit that includes PyTorch's headers; the kernels'
// own files keep a plain C interface, so nvcc compiles them without them.
//
// Each function checks what the kernel relies on, allocates fresh outputs
// (adam_bucket_ updates its operands in place instead), launches on
// PyTorch's current stream of the operands' device and raises if the
// launch was refused. It does not synchronise.

#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <cuda_runtime.h>

#include "fused_update.h"

extern "C" {
int flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int H, int Sq, int Sk,
                          int Dp, int D, float scale, int causal,
                          const int64_t* q_strides, const int64_t* k_strides,
                          const int64_t* v_strides, void* stream);
int split_tf32_launch(const float* k, const float* v, float* kb, float* ks,
                      float* vtb, float* vts, int B, int H, int Sk, int D,
                      const int64_t* k_strides, const int64_t* v_strides,
                      void* stream);
int flash_fwd_tf32_launch(const float* q, const float* kb, const float* ks,
                          const float* vtb, const float* vts, float* out,
                          float* lse, int B, int H, int Sq, int Sk, int D,
                          float scale, int causal, const int64_t* q_strides,
                          void* stream);
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

int run_adam(const std::vector<AdamMember>& members,
             const torch::Tensor& lr_t, double b1, double omb1, double b2,
             double omb2, double eps) {
  int launches = 0;
  check_launch(adam_bucket_launch(
      members.data(), static_cast<int>(members.size()),
      lr_t.data_ptr<float>(), static_cast<float>(b1),
      static_cast<float>(omb1), static_cast<float>(b2),
      static_cast<float>(omb2), static_cast<float>(eps),
      c10::cuda::getCurrentCUDAStream().stream(), &launches));
  return launches;
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
//
// adam_bucket: one flat f32 bucket, results in fresh lanes (the TPU
// kernel's signature; one member of the kernel's table).
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
  run_adam({AdamMember{p.data_ptr<float>(), g.data_ptr<float>(),
                       m1.data_ptr<float>(), m2.data_ptr<float>(),
                       p_out.data_ptr<float>(), m1_out.data_ptr<float>(),
                       m2_out.data_ptr<float>(), p.numel(), 0}},
           lr_t, b1, omb1, b2, omb2, eps);
  return {p_out, m1_out, m2_out};
}

// adam_bucket_: a bucket's members updated in place, each p, m1 and m2
// f32 and g f32 or bf16, all contiguous on one CUDA device, the four of a
// member of one length. fusion/kernels.py::plan_adam_bucket checks this and
// that no two operands share memory before anything reaches here. Returns
// the number of launches: one unless the bucket has more members than the
// kernel's parameter table holds.
int64_t adam_bucket_inplace(std::vector<torch::Tensor> ps,
                            std::vector<torch::Tensor> gs,
                            std::vector<torch::Tensor> m1s,
                            std::vector<torch::Tensor> m2s,
                            torch::Tensor lr_t, double b1, double omb1,
                            double b2, double omb2, double eps) {
  TORCH_CHECK(!ps.empty() && gs.size() == ps.size() &&
                  m1s.size() == ps.size() && m2s.size() == ps.size(),
              "adam_bucket_: one p, g, m1 and m2 for every member");
  const auto device = ps.front().device();
  TORCH_CHECK(device.is_cuda(), "adam_bucket_: the bucket must be on a CUDA "
              "device");
  TORCH_CHECK(lr_t.device() == device &&
                  lr_t.scalar_type() == torch::kFloat32 && lr_t.numel() == 1,
              "adam_bucket_: lr_t must be one f32 element on the bucket's "
              "device");
  std::vector<AdamMember> members;
  members.reserve(ps.size());
  for (size_t k = 0; k < ps.size(); ++k) {
    const auto n = ps[k].numel();
    for (const auto* t : {&ps[k], &gs[k], &m1s[k], &m2s[k]}) {
      TORCH_CHECK(t->device() == device && t->is_contiguous() &&
                      t->numel() == n,
                  "adam_bucket_: a member's operands must be contiguous, of "
                  "one length, on the bucket's device");
    }
    for (const auto* t : {&ps[k], &m1s[k], &m2s[k]}) {
      TORCH_CHECK(t->scalar_type() == torch::kFloat32,
                  "adam_bucket_: p, m1 and m2 must be float32");
    }
    const bool bf16 = gs[k].scalar_type() == torch::kBFloat16;
    TORCH_CHECK(bf16 || gs[k].scalar_type() == torch::kFloat32,
                "adam_bucket_: g must be float32 or bfloat16");
    float* p = ps[k].data_ptr<float>();
    float* m1 = m1s[k].data_ptr<float>();
    float* m2 = m2s[k].data_ptr<float>();
    members.push_back(
        AdamMember{p, gs[k].data_ptr(), m1, m2, p, m1, m2, n, bf16 ? 1 : 0});
  }
  const c10::cuda::CUDAGuard guard(device);
  return run_adam(members, lr_t, b1, omb1, b2, omb2, eps);
}

// q [B, H, Sq, Dp], k and v [B, H, Sk, Dp] in bf16 on one CUDA device;
// head_dim D is the width of the result, 1 <= D <= Dp <= 128. The wgmma
// kernel's TMA loads need Dp % 8 == 0 (columns D..Dp zero), a 16-byte
// aligned base and strides of 16-byte multiples;
// parallel/flash.py::_tma_operand makes such operands, and anything else is
// refused here. f32 goes through split_tf32 and flash_fwd_tf32 instead.
// Returns out [B, H, Sq, D] bf16 and lse [B, H, Sq] f32, both fresh and
// contiguous.
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
  TORCH_CHECK(q.scalar_type() == torch::kBFloat16,
              "flash_fwd takes bfloat16 (float32 goes through split_tf32 "
              "and flash_fwd_tf32)");
  const int64_t B = q.size(0), H = q.size(1), Sq = q.size(2);
  const int64_t Dp = q.size(3), Sk = k.size(2), D = head_dim;
  TORCH_CHECK(k.size(0) == B && k.size(1) == H && v.size(0) == B &&
                  v.size(1) == H && v.size(2) == Sk,
              "k and v must be [B, H, Sk, D] beside q [B, H, Sq, D]");
  TORCH_CHECK(k.size(3) == Dp && v.size(3) == Dp,
              "q, k and v must share one head dim (Dv != Dq is not taken)");
  TORCH_CHECK(D >= 1 && D <= 128, "flash_fwd: head dim must be in [1, 128], "
              "got ", D);
  TORCH_CHECK(D <= Dp && Dp <= 128,
              "flash_fwd: head_dim must be at most q's last dim, its zero "
              "padding");
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
  TORCH_CHECK(B * H <= INT32_MAX && Sq <= INT32_MAX && Sk <= INT32_MAX,
              "flash_fwd: B*H, Sq and Sk must fit in int32");
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty({B, H, Sq, D}, q.options());
  auto lse = torch::empty({B, H, Sq}, q.options().dtype(torch::kFloat32));
  if (B * H > 0 && Sq > 0) {
    const int64_t qst[3] = {q.stride(0), q.stride(1), q.stride(2)};
    const int64_t kst[3] = {k.stride(0), k.stride(1), k.stride(2)};
    const int64_t vst[3] = {v.stride(0), v.stride(1), v.stride(2)};
    check_launch(flash_fwd_sm90_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr<float>(), static_cast<int>(B), static_cast<int>(H),
        static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(Dp),
        static_cast<int>(D), static_cast<float>(scale), causal ? 1 : 0, qst,
        kst, vst, c10::cuda::getCurrentCUDAStream().stream()));
  }
  return {out, lse};
}

// The f32 forward's prologue: k and v [B, H, Sk, D] f32 on one CUDA
// device, 1 <= D <= 128, read in place with any strides once their last
// dim is contiguous (otherwise copied by .contiguous() first). Returns the
// tf32 parts {k_big, k_small} [B, H, Sk, Dk] and {vt_big, vt_small}
// [B, H, D, Sk8] (Dk = D rounded up to 4, Sk8 = Sk rounded up to 8; within
// each group of 8 keys Vᵀ's column p holds key [0,2,4,6,1,3,5,7][p]),
// fresh and contiguous; parallel/flash.py::split_tf32_plain is its twin.
std::vector<torch::Tensor> split_tf32(torch::Tensor k, torch::Tensor v) {
  TORCH_CHECK(k.is_cuda() && v.device() == k.device(),
              "k and v must be on one CUDA device");
  TORCH_CHECK(k.scalar_type() == torch::kFloat32 &&
                  v.scalar_type() == torch::kFloat32,
              "split_tf32 takes float32");
  TORCH_CHECK(k.dim() == 4 && v.sizes() == k.sizes(),
              "k and v must both be [B, H, Sk, D] (Dv != Dk is not taken)");
  const int64_t B = k.size(0), H = k.size(1), Sk = k.size(2), D = k.size(3);
  TORCH_CHECK(D >= 1 && D <= 128, "flash_fwd: head dim must be in [1, 128], "
              "got ", D);
  TORCH_CHECK(B * H <= INT32_MAX && Sk <= INT32_MAX - 8,
              "split_tf32: B*H and Sk must fit in int32");
  if (k.stride(3) != 1) k = k.contiguous();
  if (v.stride(3) != 1) v = v.contiguous();
  const c10::cuda::CUDAGuard guard(k.device());
  const int64_t Dk = (D + 3) / 4 * 4, Sk8 = (Sk + 7) / 8 * 8;
  auto kb = torch::empty({B, H, Sk, Dk}, k.options());
  auto ks = torch::empty_like(kb);
  auto vtb = torch::empty({B, H, D, Sk8}, k.options());
  auto vts = torch::empty_like(vtb);
  if (B * H > 0 && Sk > 0) {
    const int64_t kst[3] = {k.stride(0), k.stride(1), k.stride(2)};
    const int64_t vst[3] = {v.stride(0), v.stride(1), v.stride(2)};
    check_launch(split_tf32_launch(
        k.data_ptr<float>(), v.data_ptr<float>(), kb.data_ptr<float>(),
        ks.data_ptr<float>(), vtb.data_ptr<float>(), vts.data_ptr<float>(),
        static_cast<int>(B), static_cast<int>(H), static_cast<int>(Sk),
        static_cast<int>(D), kst, vst,
        c10::cuda::getCurrentCUDAStream().stream()));
  }
  return {kb, ks, vtb, vts};
}

// The f32 forward: q [B, H, Sq, D] f32 (any strides once its last dim is
// contiguous, read in place) and the four parts split_tf32 made of k and v
// on q's device. Returns out [B, H, Sq, D] f32 and lse [B, H, Sq] f32,
// both fresh and contiguous.
std::vector<torch::Tensor> flash_fwd_tf32(torch::Tensor q, torch::Tensor kb,
                                          torch::Tensor ks, torch::Tensor vtb,
                                          torch::Tensor vts, double scale,
                                          bool causal) {
  TORCH_CHECK(q.is_cuda() && q.scalar_type() == torch::kFloat32 &&
                  q.dim() == 4,
              "flash_fwd_tf32: q must be [B, H, Sq, D] float32 on a CUDA "
              "device");
  const int64_t B = q.size(0), H = q.size(1), Sq = q.size(2), D = q.size(3);
  TORCH_CHECK(D >= 1 && D <= 128, "flash_fwd: head dim must be in [1, 128], "
              "got ", D);
  const int64_t Sk = kb.dim() == 4 ? kb.size(2) : -1;
  const int64_t Dk = (D + 3) / 4 * 4, Sk8 = (Sk + 7) / 8 * 8;
  for (const auto* t : {&kb, &ks, &vtb, &vts}) {
    TORCH_CHECK(t->device() == q.device() &&
                    t->scalar_type() == torch::kFloat32 && t->is_contiguous(),
                "flash_fwd_tf32: the parts must be contiguous float32 on q's "
                "device");
  }
  TORCH_CHECK(Sk >= 0 && kb.sizes() == torch::IntArrayRef({B, H, Sk, Dk}) &&
                  ks.sizes() == kb.sizes() &&
                  vtb.sizes() == torch::IntArrayRef({B, H, D, Sk8}) &&
                  vts.sizes() == vtb.sizes(),
              "flash_fwd_tf32: the parts must be split_tf32's of k and v "
              "[B, H, Sk, D] beside q [B, H, Sq, D]");
  TORCH_CHECK(B * H <= INT32_MAX && Sq <= INT32_MAX && Sk <= INT32_MAX - 8,
              "flash_fwd: B*H, Sq and Sk must fit in int32");
  if (q.stride(3) != 1) q = q.contiguous();
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty({B, H, Sq, D}, q.options());
  auto lse = torch::empty({B, H, Sq}, q.options());
  if (B * H > 0 && Sq > 0) {
    const int64_t qst[3] = {q.stride(0), q.stride(1), q.stride(2)};
    check_launch(flash_fwd_tf32_launch(
        q.data_ptr<float>(), kb.data_ptr<float>(), ks.data_ptr<float>(),
        vtb.data_ptr<float>(), vts.data_ptr<float>(), out.data_ptr<float>(),
        lse.data_ptr<float>(), static_cast<int>(B), static_cast<int>(H),
        static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(D),
        static_cast<float>(scale), causal ? 1 : 0, qst,
        c10::cuda::getCurrentCUDAStream().stream()));
  }
  return {out, lse};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("momentum_bucket", &momentum_bucket,
        "v' = mu*v + g; p' = p - lr*v' (Nesterov: p - (g + mu*v')*lr)");
  m.def("adam_bucket", &adam_bucket,
        "m1' = b1*m1 + (1-b1)*g; m2' = b2*m2 + (1-b2)*g*g; "
        "p' = p - lr_t*m1'/(sqrt(m2') + eps)");
  m.def("adam_bucket_", &adam_bucket_inplace,
        "adam_bucket over a bucket's member lists, in place; returns the "
        "number of launches");
  m.def("flash_fwd", &flash_fwd,
        "bf16 (out, lse) of softmax(q k^T * scale) v, causal top-left "
        "aligned");
  m.def("split_tf32", &split_tf32,
        "tf32 big and small parts of k [B,H,Sk,D] and of v transposed "
        "[B,H,D,Sk8]");
  m.def("flash_fwd_tf32", &flash_fwd_tf32,
        "f32 (out, lse) of softmax(q k^T * scale) v from split_tf32's "
        "parts, 3xTF32 products");
}
