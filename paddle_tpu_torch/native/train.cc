// Native training demo runtime: load a saved TRAIN program (forward +
// backward + optimizer ops, JSON IR) and run real training steps C++-only —
// no Python anywhere in the loop.
//
// Reference parity: paddle/fluid/train/demo/demo_trainer.cc — it loads a
// ProgramDesc, runs the startup program to initialize parameters, then
// executes the train program step by step with an SGD update. Same shape
// here: ptt_create parses __train__ (startup + main programs),
// ptt_init runs the startup ops (uniform/gaussian/constant initializers),
// ptt_step feeds a batch, runs forward+backward+sgd, and returns the loss.
//
// The forward kernels come from the shared runtime (runtime.h run_op); this
// file adds what training needs on top: initializer kernels, the gradient
// kernels the IR-level backward emits for the mlp AND cnn families
// (mean/square_error_cost/elementwise_add/mul/relu plus conv2d/pool2d/
// training-mode batch_norm with their backwards), and the sgd/momentum
// updates applied in place on the persistent scope.
//
// Build: paddle_tpu_torch/native/build.py train_lib() -> libpttrain.so
// ABI (0 on success, -1 on error; ptt_last_error()):
//   void*  ptt_create(const char* model_dir);
//   int    ptt_init(void*);                       // run startup program
//   int    ptt_step(void*, int n, const char** names, const int* dtypes,
//                   const int* ndims, const int64_t* dims_concat,
//                   const void** datas, float* loss_out);
//   int    ptt_get_var(void*, const char* name, int* dtype, int* ndim,
//                      const int64_t** dims, const void** data);
//   void   ptt_destroy(void*);

#include "runtime.h"

#include <limits>
#include <random>

namespace {

using namespace ptnative;

struct Trainer {
  std::vector<OpDesc> startup_ops, main_ops;
  std::vector<std::string> feed_names;
  std::string loss_name;
  Scope scope;  // persistent: parameters + optimizer state
  std::mt19937 rng{7};
  Tensor fetched;
};

std::vector<int64_t> attr_shape(const OpDesc& op) {
  return op.attr_ints("shape");
}

Tensor make_f32(const std::vector<int64_t>& dims) {
  Tensor t;
  t.dtype = F32;
  t.dims = dims;
  t.alloc();
  return t;
}

// gradient of the elementwise broadcast: fold dOut back onto y's shape
// (sum over the pre/post extents the forward broadcast expanded)
Tensor reduce_to_like(const Tensor& dout, const Tensor& y, int axis) {
  if (y.dims == dout.dims) return to_f32(dout);
  int xr = (int)dout.dims.size(), yr = (int)y.dims.size();
  while (yr > 1 && y.dims[yr - 1] == 1) --yr;
  if (axis < 0) axis = xr - yr;
  int64_t pre = 1, mid = 1, post = 1;
  for (int i = 0; i < axis; ++i) pre *= dout.dims[i];
  for (int i = 0; i < yr; ++i) mid *= dout.dims[axis + i];
  for (int i = axis + yr; i < xr; ++i) post *= dout.dims[i];
  Tensor d_s;
  const Tensor& d = as_f32(dout, d_s);
  Tensor o = make_f32(y.dims);
  std::fill(o.f(), o.f() + o.numel(), 0.f);
  for (int64_t a = 0; a < pre; ++a)
    for (int64_t b = 0; b < mid; ++b)
      for (int64_t c = 0; c < post; ++c)
        o.f()[b] += d.f()[(a * mid + b) * post + c];
  return o;
}

// per-channel batch statistics over [N, C, inner] (biased variance) —
// the ONE definition shared by training-mode batch_norm and its grad
void compute_batch_stats(const Tensor& x, int64_t N, int64_t C,
                         int64_t inner, std::vector<float>& m,
                         std::vector<float>& v) {
  int64_t cnt = N * inner;
  m.assign(C, 0.f);
  v.assign(C, 0.f);
  for (int64_t n = 0; n < N; ++n)
    for (int64_t c = 0; c < C; ++c) {
      const float* xi = x.f() + (n * C + c) * inner;
      for (int64_t i = 0; i < inner; ++i) m[c] += xi[i];
    }
  for (int64_t c = 0; c < C; ++c) m[c] /= (float)cnt;
  for (int64_t n = 0; n < N; ++n)
    for (int64_t c = 0; c < C; ++c) {
      const float* xi = x.f() + (n * C + c) * inner;
      for (int64_t i = 0; i < inner; ++i) {
        float d = xi[i] - m[c];
        v[c] += d * d;
      }
    }
  for (int64_t c = 0; c < C; ++c) v[c] /= (float)cnt;
}

// returns true when handled; false -> fall through to the inference run_op
bool run_train_op(Trainer& tr, const OpDesc& op, Env& env) {
  const std::string& t = op.type;

  if (t == "fill_constant") {
    Tensor o = make_f32(attr_shape(op));
    float v = (float)op.attr_num("value", 0.0);
    std::fill(o.f(), o.f() + o.numel(), v);
    const std::string& name = op.out("Out");
    if (env.params == nullptr)  // startup: write the persistent scope
      tr.scope[name] = std::move(o);
    else
      env.local[name] = std::move(o);
    return true;
  }
  if (t == "uniform_random" || t == "gaussian_random") {
    Tensor o = make_f32(attr_shape(op));
    if (t == "uniform_random") {
      float lo = (float)op.attr_num("min", -1.0);
      float hi = (float)op.attr_num("max", 1.0);
      std::uniform_real_distribution<float> dist(lo, hi);
      for (int64_t i = 0; i < o.numel(); ++i) o.f()[i] = dist(tr.rng);
    } else {
      float mean = (float)op.attr_num("mean", 0.0);
      float std_ = (float)op.attr_num("std", 1.0);
      std::normal_distribution<float> dist(mean, std_);
      for (int64_t i = 0; i < o.numel(); ++i) o.f()[i] = dist(tr.rng);
    }
    const std::string& name = op.out("Out");
    if (env.params == nullptr)
      tr.scope[name] = std::move(o);
    else
      env.local[name] = std::move(o);
    return true;
  }

  if (t == "square_error_cost") {
    Tensor x_s, y_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& y = as_f32(need(env, op.in("Y")), y_s);
    Tensor o = make_f32(x.dims);
    for (int64_t i = 0; i < x.numel(); ++i) {
      float d = x.f()[i] - y.f()[i];
      o.f()[i] = d * d;
    }
    env.local[op.out("Out")] = std::move(o);
    return true;
  }

  if (t == "mean_grad") {
    const Tensor& x = need(env, op.in("X"));
    Tensor d_s;
    const Tensor& dout = as_f32(need(env, op.in("Out@GRAD")), d_s);
    Tensor o = make_f32(x.dims);
    float g = dout.f()[0] / (float)x.numel();
    std::fill(o.f(), o.f() + o.numel(), g);
    env.local[op.out("X@GRAD")] = std::move(o);
    return true;
  }
  if (t == "square_error_cost_grad") {
    Tensor x_s, y_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& y = as_f32(need(env, op.in("Y")), y_s);
    const Tensor& dout = as_f32(need(env, op.in("Out@GRAD")), d_s);
    if (!op.out("X@GRAD").empty()) {
      Tensor o = make_f32(x.dims);
      for (int64_t i = 0; i < x.numel(); ++i)
        o.f()[i] = 2.f * (x.f()[i] - y.f()[i]) * dout.f()[i];
      env.local[op.out("X@GRAD")] = std::move(o);
    }
    if (!op.out("Y@GRAD").empty()) {
      Tensor o = make_f32(y.dims);
      for (int64_t i = 0; i < y.numel(); ++i)
        o.f()[i] = -2.f * (x.f()[i] - y.f()[i]) * dout.f()[i];
      env.local[op.out("Y@GRAD")] = std::move(o);
    }
    return true;
  }
  if (t == "elementwise_add_grad") {
    const Tensor& y = need(env, op.in("Y"));
    Tensor d_s;
    const Tensor& dout = as_f32(need(env, op.in("Out@GRAD")), d_s);
    if (!op.out("X@GRAD").empty())
      env.local[op.out("X@GRAD")] = to_f32(dout);
    if (!op.out("Y@GRAD").empty())
      env.local[op.out("Y@GRAD")] =
          reduce_to_like(dout, y, (int)op.attr_num("axis", -1));
    return true;
  }
  if (t == "relu_grad") {
    Tensor x_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& dout = as_f32(need(env, op.in("Out@GRAD")), d_s);
    Tensor o = make_f32(x.dims);
    for (int64_t i = 0; i < x.numel(); ++i)
      o.f()[i] = x.f()[i] > 0.f ? dout.f()[i] : 0.f;
    env.local[op.out("X@GRAD")] = std::move(o);
    return true;
  }
  if (t == "mul_grad") {
    Tensor x_s, y_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& y = as_f32(need(env, op.in("Y")), y_s);
    const Tensor& dout = as_f32(need(env, op.in("Out@GRAD")), d_s);
    int xn = (int)op.attr_num("x_num_col_dims", 1);
    int yn = (int)op.attr_num("y_num_col_dims", 1);
    int64_t m = 1, k = 1, n = 1;
    for (int i = 0; i < xn; ++i) m *= x.dims[i];
    for (size_t i = xn; i < x.dims.size(); ++i) k *= x.dims[i];
    for (size_t i = yn; i < y.dims.size(); ++i) n *= y.dims[i];
    if (!op.out("X@GRAD").empty()) {  // dX = dOut @ Y^T   [m,k]
      Tensor o = make_f32(x.dims);
      for (int64_t i = 0; i < m; ++i)
        for (int64_t kk = 0; kk < k; ++kk) {
          float acc = 0.f;
          for (int64_t j = 0; j < n; ++j)
            acc += dout.f()[i * n + j] * y.f()[kk * n + j];
          o.f()[i * k + kk] = acc;
        }
      env.local[op.out("X@GRAD")] = std::move(o);
    }
    if (!op.out("Y@GRAD").empty()) {  // dY = X^T @ dOut   [k,n]
      Tensor o = make_f32(y.dims);
      for (int64_t kk = 0; kk < k; ++kk)
        for (int64_t j = 0; j < n; ++j) {
          float acc = 0.f;
          for (int64_t i = 0; i < m; ++i)
            acc += x.f()[i * k + kk] * dout.f()[i * n + j];
          o.f()[kk * n + j] = acc;
        }
      env.local[op.out("Y@GRAD")] = std::move(o);
    }
    return true;
  }

  // ---- classifier head (hard labels; reference cross_entropy_op.cc) ----

  if (t == "cross_entropy") {
    if (op.attr_bool("soft_label", false))
      throw std::runtime_error("native cross_entropy: soft_label "
                               "unsupported (serve via the Executor)");
    Tensor x_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& lab = need(env, op.in("Label"));
    int64_t N = x.dims[0], C = x.dims[1];
    Tensor o = make_f32({N, 1});
    for (int64_t n = 0; n < N; ++n) {
      int64_t c = lab.as_i64(n);
      if (c < 0 || c >= C)
        throw std::runtime_error("cross_entropy: label out of range");
      float p = x.f()[n * C + c];
      o.f()[n] = -std::log(std::max(p, 1e-20f));
    }
    env.local[op.out("Y")] = std::move(o);
    return true;
  }
  if (t == "cross_entropy_grad") {
    Tensor x_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& lab = need(env, op.in("Label"));
    const Tensor& dy = as_f32(need(env, op.in("Y@GRAD")), d_s);
    int64_t N = x.dims[0], C = x.dims[1];
    Tensor g = make_f32(x.dims);
    std::fill(g.f(), g.f() + g.numel(), 0.f);
    for (int64_t n = 0; n < N; ++n) {
      int64_t c = lab.as_i64(n);
      float p = std::max(x.f()[n * C + c], 1e-20f);
      g.f()[n * C + c] = -dy.f()[n] / p;
    }
    env.local[op.out("X@GRAD")] = std::move(g);
    return true;
  }
  if (t == "softmax_grad") {
    // recompute y = softmax(x) like the vjp replay, then
    // dX = y * (dy - sum(dy * y, last axis))
    Tensor x_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& dy = as_f32(need(env, op.in("Out@GRAD")), d_s);
    int64_t C = x.dims.back();
    int64_t rows = x.numel() / C;
    Tensor g = make_f32(x.dims);
    std::vector<float> y(C);
    for (int64_t r = 0; r < rows; ++r) {
      const float* xi = x.f() + r * C;
      const float* di = dy.f() + r * C;
      float mx = xi[0];
      for (int64_t c = 1; c < C; ++c) mx = std::max(mx, xi[c]);
      float z = 0.f;
      for (int64_t c = 0; c < C; ++c) {
        y[c] = std::exp(xi[c] - mx);
        z += y[c];
      }
      float dot = 0.f;
      for (int64_t c = 0; c < C; ++c) {
        y[c] /= z;
        dot += di[c] * y[c];
      }
      float* gi = g.f() + r * C;
      for (int64_t c = 0; c < C; ++c) gi[c] = y[c] * (di[c] - dot);
    }
    env.local[op.out("X@GRAD")] = std::move(g);
    return true;
  }

  // ---- CNN training kernels (r5: extends the native trainer beyond the
  // mlp family; reference demo_trainer.cc executes any ProgramDesc) ----

  if (t == "batch_norm" && !op.attr_bool("is_test", false)) {
    // TRAINING semantics: normalize by batch statistics and fold them
    // into the running stats in the persistent scope (the shared
    // runtime.h kernel is inference-only: running stats, no update)
    Tensor x_s, sc_s, bi_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& sc = as_f32(need(env, op.in("Scale")), sc_s);
    const Tensor& bi = as_f32(need(env, op.in("Bias")), bi_s);
    float eps = (float)op.attr_num("epsilon", 1e-5);
    float mom = (float)op.attr_num("momentum", 0.9);
    int64_t N = x.dims[0], C = x.dims.size() > 1 ? x.dims[1] : 1;
    int64_t inner = 1;
    for (size_t i = 2; i < x.dims.size(); ++i) inner *= x.dims[i];
    std::vector<float> m, v;
    compute_batch_stats(x, N, C, inner, m, v);
    Tensor o = make_f32(x.dims);
    for (int64_t n = 0; n < N; ++n)
      for (int64_t c = 0; c < C; ++c) {
        float inv = 1.f / std::sqrt(v[c] + eps);
        float a = sc.f()[c] * inv;
        float b = bi.f()[c] - m[c] * a;
        const float* xi = x.f() + (n * C + c) * inner;
        float* oi = o.f() + (n * C + c) * inner;
        for (int64_t i = 0; i < inner; ++i) oi[i] = xi[i] * a + b;
      }
    env.local[op.out("Y")] = std::move(o);
    // running-stat EMA update, in place on the persistent scope
    // (MeanOut/VarianceOut alias Mean/Variance like the reference)
    auto upd = [&](const std::string& name, const std::vector<float>& s) {
      auto it = tr.scope.find(name);
      if (it == tr.scope.end()) return;
      Tensor& r = it->second;
      if (r.dtype != F32) r = to_f32(r);
      for (int64_t c = 0; c < C && c < r.numel(); ++c)
        r.f()[c] = r.f()[c] * mom + s[c] * (1.f - mom);
    };
    upd(op.in("Mean"), m);
    upd(op.in("Variance"), v);
    if (!op.out("SavedMean").empty()) {
      Tensor sm = make_f32({C});
      std::copy(m.begin(), m.end(), sm.f());
      env.local[op.out("SavedMean")] = std::move(sm);
    }
    if (!op.out("SavedVariance").empty()) {
      Tensor sv = make_f32({C});
      for (int64_t c = 0; c < C; ++c)
        sv.f()[c] = 1.f / std::sqrt(v[c] + eps);
      env.local[op.out("SavedVariance")] = std::move(sv);
    }
    return true;
  }

  if (t == "batch_norm_grad") {
    // d(batch-normalized y)/d{x, scale, bias} using BATCH statistics
    // recomputed from X (the default vjp maker forwards X/Scale/Bias)
    Tensor x_s, sc_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& sc = as_f32(need(env, op.in("Scale")), sc_s);
    const Tensor& dy = as_f32(need(env, op.in("Y@GRAD")), d_s);
    float eps = (float)op.attr_num("epsilon", 1e-5);
    int64_t N = x.dims[0], C = x.dims.size() > 1 ? x.dims[1] : 1;
    int64_t inner = 1;
    for (size_t i = 2; i < x.dims.size(); ++i) inner *= x.dims[i];
    int64_t cnt = N * inner;
    std::vector<float> m, v, dys(C, 0.f), dyx(C, 0.f);
    compute_batch_stats(x, N, C, inner, m, v);
    // per-channel sums of dy and dy*xhat
    for (int64_t n = 0; n < N; ++n)
      for (int64_t c = 0; c < C; ++c) {
        float inv = 1.f / std::sqrt(v[c] + eps);
        const float* xi = x.f() + (n * C + c) * inner;
        const float* di = dy.f() + (n * C + c) * inner;
        for (int64_t i = 0; i < inner; ++i) {
          dys[c] += di[i];
          dyx[c] += di[i] * (xi[i] - m[c]) * inv;
        }
      }
    if (!op.out("Scale@GRAD").empty()) {
      Tensor g = make_f32({C});
      std::copy(dyx.begin(), dyx.end(), g.f());
      env.local[op.out("Scale@GRAD")] = std::move(g);
    }
    if (!op.out("Bias@GRAD").empty()) {
      Tensor g = make_f32({C});
      std::copy(dys.begin(), dys.end(), g.f());
      env.local[op.out("Bias@GRAD")] = std::move(g);
    }
    if (!op.out("X@GRAD").empty()) {
      Tensor g = make_f32(x.dims);
      for (int64_t n = 0; n < N; ++n)
        for (int64_t c = 0; c < C; ++c) {
          float inv = 1.f / std::sqrt(v[c] + eps);
          float a = sc.f()[c] * inv;
          const float* xi = x.f() + (n * C + c) * inner;
          const float* di = dy.f() + (n * C + c) * inner;
          float* gi = g.f() + (n * C + c) * inner;
          for (int64_t i = 0; i < inner; ++i) {
            float xhat = (xi[i] - m[c]) * inv;
            gi[i] = a * (di[i] - dys[c] / (float)cnt -
                         xhat * dyx[c] / (float)cnt);
          }
        }
      env.local[op.out("X@GRAD")] = std::move(g);
    }
    return true;
  }

  if (t == "conv2d_grad" || t == "depthwise_conv2d_grad") {
    Tensor x_s, w_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("Input")), x_s);
    const Tensor& w = as_f32(need(env, op.in("Filter")), w_s);
    const Tensor& dout = as_f32(need(env, op.in("Output@GRAD")), d_s);
    auto strides = op.attr_ints("strides");
    auto pads = op.attr_ints("paddings");
    auto dil = op.attr_ints("dilations");
    if (strides.empty()) strides = {1, 1};
    if (pads.empty()) pads = {0, 0};
    if (dil.empty()) dil = {1, 1};
    int64_t groups = (int64_t)op.attr_num("groups", 1);
    if (t == "depthwise_conv2d_grad") groups = x.dims[1];
    int64_t N = x.dims[0], C = x.dims[1], H = x.dims[2], W = x.dims[3];
    int64_t O = w.dims[0], KC = w.dims[1], KH = w.dims[2], KW = w.dims[3];
    int64_t OH = dout.dims[2], OW = dout.dims[3];
    int64_t cpg = C / groups, opg = O / groups;
    (void)KC;
    bool want_dx = !op.out("Input@GRAD").empty();
    bool want_dw = !op.out("Filter@GRAD").empty();
    Tensor dx, dw;
    if (want_dx) {
      dx = make_f32(x.dims);
      std::fill(dx.f(), dx.f() + dx.numel(), 0.f);
    }
    if (want_dw) {
      dw = make_f32(w.dims);
      std::fill(dw.f(), dw.f() + dw.numel(), 0.f);
    }
    for (int64_t n = 0; n < N; ++n)
      for (int64_t oc = 0; oc < O; ++oc) {
        int64_t g = oc / opg;
        for (int64_t oh = 0; oh < OH; ++oh)
          for (int64_t ow = 0; ow < OW; ++ow) {
            float go = dout.f()[((n * O + oc) * OH + oh) * OW + ow];
            if (go == 0.f) continue;
            for (int64_t ic = 0; ic < cpg; ++ic)
              for (int64_t kh = 0; kh < KH; ++kh) {
                int64_t ih = oh * strides[0] - pads[0] + kh * dil[0];
                if (ih < 0 || ih >= H) continue;
                for (int64_t kw = 0; kw < KW; ++kw) {
                  int64_t iw = ow * strides[1] - pads[1] + kw * dil[1];
                  if (iw < 0 || iw >= W) continue;
                  int64_t xo = ((n * C + g * cpg + ic) * H + ih) * W + iw;
                  int64_t wo = ((oc * cpg + ic) * KH + kh) * KW + kw;
                  if (want_dx) dx.f()[xo] += go * w.f()[wo];
                  if (want_dw) dw.f()[wo] += go * x.f()[xo];
                }
              }
          }
      }
    if (want_dx) env.local[op.out("Input@GRAD")] = std::move(dx);
    if (want_dw) env.local[op.out("Filter@GRAD")] = std::move(dw);
    return true;
  }

  if (t == "pool2d_grad") {
    Tensor x_s, d_s;
    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    const Tensor& dout = as_f32(need(env, op.in("Out@GRAD")), d_s);
    std::string ptype = "max";
    if (op.attrs->at("pooling_type")->kind == JValue::STR)
      ptype = op.attrs->at("pooling_type")->s;
    auto ksize = op.attr_ints("ksize");
    auto strides = op.attr_ints("strides");
    auto pads = op.attr_ints("paddings");
    if (ksize.empty()) ksize = {2, 2};
    if (strides.empty()) strides = {1, 1};
    if (pads.empty()) pads = {0, 0};
    int64_t N = x.dims[0], C = x.dims[1], H = x.dims[2], W = x.dims[3];
    if (op.attr_bool("global_pooling", false)) {
      ksize = {H, W};
      strides = {1, 1};
      pads = {0, 0};
    }
    int64_t OH = dout.dims[2], OW = dout.dims[3];
    bool exclusive = op.attr_bool("exclusive", true);
    Tensor dx = make_f32(x.dims);
    std::fill(dx.f(), dx.f() + dx.numel(), 0.f);
    for (int64_t n = 0; n < N; ++n)
      for (int64_t c = 0; c < C; ++c)
        for (int64_t oh = 0; oh < OH; ++oh)
          for (int64_t ow = 0; ow < OW; ++ow) {
            float go = dout.f()[((n * C + c) * OH + oh) * OW + ow];
            int64_t h0 = oh * strides[0] - pads[0];
            int64_t w0 = ow * strides[1] - pads[1];
            if (ptype == "max") {
              // route to the window's argmax (recomputed from X, same
              // first-wins tie-break as a forward scan)
              int64_t bh = -1, bw = -1;
              float best = -std::numeric_limits<float>::infinity();
              for (int64_t kh = 0; kh < ksize[0]; ++kh) {
                int64_t ih = h0 + kh;
                if (ih < 0 || ih >= H) continue;
                for (int64_t kw = 0; kw < ksize[1]; ++kw) {
                  int64_t iw = w0 + kw;
                  if (iw < 0 || iw >= W) continue;
                  float xv = x.f()[((n * C + c) * H + ih) * W + iw];
                  if (xv > best) {
                    best = xv;
                    bh = ih;
                    bw = iw;
                  }
                }
              }
              if (bh >= 0)
                dx.f()[((n * C + c) * H + bh) * W + bw] += go;
            } else {  // avg
              int64_t cnt = 0;
              for (int64_t kh = 0; kh < ksize[0]; ++kh) {
                int64_t ih = h0 + kh;
                if (ih >= 0 && ih < H)
                  for (int64_t kw = 0; kw < ksize[1]; ++kw) {
                    int64_t iw = w0 + kw;
                    if (iw >= 0 && iw < W) ++cnt;
                  }
              }
              int64_t denom = exclusive ? cnt : ksize[0] * ksize[1];
              if (denom == 0) continue;
              float share = go / (float)denom;
              for (int64_t kh = 0; kh < ksize[0]; ++kh) {
                int64_t ih = h0 + kh;
                if (ih < 0 || ih >= H) continue;
                for (int64_t kw = 0; kw < ksize[1]; ++kw) {
                  int64_t iw = w0 + kw;
                  if (iw < 0 || iw >= W) continue;
                  dx.f()[((n * C + c) * H + ih) * W + iw] += share;
                }
              }
            }
          }
    env.local[op.out("X@GRAD")] = std::move(dx);
    return true;
  }

  if (t == "momentum") {
    auto pit = tr.scope.find(op.in("Param"));
    auto vit = tr.scope.find(op.in("Velocity"));
    if (pit == tr.scope.end() || vit == tr.scope.end())
      throw std::runtime_error("momentum: param/velocity not in scope: " +
                               op.in("Param"));
    Tensor& p = pit->second;
    Tensor& vel = vit->second;
    Tensor g_s, lr_s;
    const Tensor& g = as_f32(need(env, op.in("Grad")), g_s);
    const Tensor& lr = as_f32(need(env, op.in("LearningRate")), lr_s);
    float mu = (float)op.attr_num("mu", 0.9);
    bool nesterov = op.attr_bool("use_nesterov", false);
    if (p.dtype != F32) p = to_f32(p);
    if (vel.dtype != F32) vel = to_f32(vel);
    for (int64_t i = 0; i < p.numel(); ++i) {
      float nv = mu * vel.f()[i] + g.f()[i];
      vel.f()[i] = nv;
      p.f()[i] -= lr.f()[0] * (nesterov ? g.f()[i] + mu * nv : nv);
    }
    return true;  // ParamOut/VelocityOut alias inputs: updated in place
  }

  if (t == "sgd") {
    auto pit = tr.scope.find(op.in("Param"));
    if (pit == tr.scope.end())
      throw std::runtime_error("sgd: param not in scope: " + op.in("Param"));
    Tensor& p = pit->second;
    Tensor g_s, lr_s;
    const Tensor& g = as_f32(need(env, op.in("Grad")), g_s);
    const Tensor& lr = as_f32(need(env, op.in("LearningRate")), lr_s);
    if (p.dtype != F32) p = to_f32(p);
    for (int64_t i = 0; i < p.numel(); ++i)
      p.f()[i] -= lr.f()[0] * g.f()[i];
    return true;  // ParamOut aliases Param: updated in place
  }

  return false;
}

Trainer* create(const std::string& dir) {
  std::ifstream in(dir + "/__train__");
  if (!in) throw std::runtime_error("cannot open " + dir + "/__train__");
  std::stringstream ss;
  ss << in.rdbuf();
  std::string text = ss.str();
  JParser parser(text);
  JPtr root = parser.parse();

  auto tr = std::make_unique<Trainer>();
  for (auto& v : root->at("feed_var_names")->arr)
    tr->feed_names.push_back(v->s);
  tr->loss_name = root->at("loss_name")->s;
  tr->startup_ops =
      parse_block_ops(root->at("startup_program")->at("blocks")->arr.at(0));
  tr->main_ops = parse_block_ops(root->at("main_program")->at("blocks")->arr.at(0));
  return tr.release();
}

thread_local std::string g_err;

}  // namespace

extern "C" {

const char* ptt_last_error() { return g_err.c_str(); }

void* ptt_create(const char* model_dir) {
  try {
    return create(model_dir);
  } catch (const std::exception& e) {
    g_err = e.what();
    return nullptr;
  }
}

int ptt_init(void* pv) {
  try {
    auto* tr = (Trainer*)pv;
    Env env;  // params == nullptr marks "startup mode" for initializers
    for (auto& op : tr->startup_ops)
      if (!run_train_op(*tr, op, env)) run_op(op, env);
    // anything a startup op left in env.local is persistent state too
    for (auto& [n, t] : env.local) tr->scope[n] = std::move(t);
    return 0;
  } catch (const std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

int ptt_step(void* pv, int n, const char** names, const int* dtypes,
             const int* ndims, const int64_t* dims_concat, const void** datas,
             float* loss_out) {
  try {
    auto* tr = (Trainer*)pv;
    Env env;
    env.params = &tr->scope;
    int64_t doff = 0;
    for (int i = 0; i < n; ++i) {
      Tensor t;
      t.dtype = (DType)dtypes[i];
      for (int d = 0; d < ndims[i]; ++d)
        t.dims.push_back(dims_concat[doff + d]);
      doff += ndims[i];
      t.alloc();
      std::memcpy(t.buf.data(), datas[i], t.buf.size());
      env.local[names[i]] = std::move(t);
    }
    for (auto& op : tr->main_ops)
      if (!run_train_op(*tr, op, env)) run_op(op, env);
    Tensor l_s;
    const Tensor& loss = as_f32(need(env, tr->loss_name), l_s);
    if (loss_out) *loss_out = loss.f()[0];
    return 0;
  } catch (const std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

int ptt_get_var(void* pv, const char* name, int* dtype, int* ndim,
                const int64_t** dims, const void** data) {
  auto* tr = (Trainer*)pv;
  auto it = tr->scope.find(name);
  if (it == tr->scope.end()) {
    g_err = std::string("no such variable in scope: ") + name;
    return -1;
  }
  Tensor& t = it->second;
  *dtype = (int)t.dtype;
  *ndim = (int)t.dims.size();
  *dims = t.dims.data();
  *data = t.buf.data();
  return 0;
}

void ptt_destroy(void* p) { delete (Trainer*)p; }

}  // extern "C"
