// Shared native runtime: JSON program parser, Tensor, OpDesc/Env, the CPU
// kernel library (run_op), and .npy parameter loading. Used by BOTH the
// inference predictor (infer.cc -> libptinfer.so) and the training demo
// runtime (train.cc -> libpttrain.so) — the reference's analogous split is
// fluid/inference/io.cc (Load) vs fluid/train/demo/demo_trainer.cc, both on
// the same framework core.
//
// Everything lives in namespace ptnative so each .so can add its own
// kernels on top (train.cc layers grad + optimizer + init kernels over
// run_op's forward set).
#pragma once

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace ptnative {

// ---------------------------------------------------------------- JSON ----
struct JValue;
using JPtr = std::shared_ptr<JValue>;
struct JValue {
  enum Kind { NUL, BOOL, INT, DBL, STR, ARR, OBJ } kind = NUL;
  bool b = false;
  long long i = 0;
  double d = 0;
  std::string s;
  std::vector<JPtr> arr;
  std::map<std::string, JPtr> obj;

  double num() const { return kind == INT ? (double)i : d; }
  const JPtr& at(const std::string& k) const {
    static JPtr nul = std::make_shared<JValue>();
    auto it = obj.find(k);
    return it == obj.end() ? nul : it->second;
  }
};

struct JParser {
  const char* p;
  const char* end;
  explicit JParser(const std::string& text)
      : p(text.data()), end(text.data() + text.size()) {}

  [[noreturn]] void fail(const std::string& why) {
    throw std::runtime_error("json parse error: " + why);
  }
  void ws() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
      ++p;
  }
  bool lit(const char* s) {
    size_t n = std::strlen(s);
    if ((size_t)(end - p) >= n && std::strncmp(p, s, n) == 0) {
      p += n;
      return true;
    }
    return false;
  }
  JPtr parse() {
    ws();
    JPtr v = value();
    ws();
    return v;
  }
  JPtr value() {
    ws();
    if (p >= end) fail("eof");
    char c = *p;
    if (c == '{') return object();
    if (c == '[') return array();
    if (c == '"') {
      auto v = std::make_shared<JValue>();
      v->kind = JValue::STR;
      v->s = string();
      return v;
    }
    auto v = std::make_shared<JValue>();
    if (lit("true")) { v->kind = JValue::BOOL; v->b = true; return v; }
    if (lit("false")) { v->kind = JValue::BOOL; v->b = false; return v; }
    if (lit("null")) { v->kind = JValue::NUL; return v; }
    if (lit("NaN")) { v->kind = JValue::DBL; v->d = NAN; return v; }
    if (lit("Infinity")) { v->kind = JValue::DBL; v->d = INFINITY; return v; }
    if (lit("-Infinity")) { v->kind = JValue::DBL; v->d = -INFINITY; return v; }
    return number();
  }
  std::string string() {
    if (*p != '"') fail("expected string");
    ++p;
    std::string out;
    while (p < end && *p != '"') {
      if (*p == '\\') {
        ++p;
        if (p >= end) fail("bad escape");
        switch (*p) {
          case 'n': out += '\n'; break;
          case 't': out += '\t'; break;
          case 'r': out += '\r'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'u': {  // keep it simple: decode latin-1 range only
            if (end - p < 5) fail("bad \\u");
            int code = std::stoi(std::string(p + 1, p + 5), nullptr, 16);
            if (code < 0x80) out += (char)code;
            else { out += (char)(0xC0 | (code >> 6)); out += (char)(0x80 | (code & 0x3F)); }
            p += 4;
            break;
          }
          default: out += *p;
        }
        ++p;
      } else {
        out += *p++;
      }
    }
    if (p >= end) fail("unterminated string");
    ++p;
    return out;
  }
  JPtr number() {
    const char* start = p;
    if (*p == '-') ++p;
    bool is_float = false;
    while (p < end && (std::isdigit((unsigned char)*p) || *p == '.' ||
                       *p == 'e' || *p == 'E' || *p == '+' || *p == '-')) {
      if (*p == '.' || *p == 'e' || *p == 'E') is_float = true;
      ++p;
    }
    if (p == start) fail("expected number");
    std::string tok(start, p);
    auto v = std::make_shared<JValue>();
    if (is_float) { v->kind = JValue::DBL; v->d = std::stod(tok); }
    else { v->kind = JValue::INT; v->i = std::stoll(tok); }
    return v;
  }
  JPtr array() {
    ++p;  // [
    auto v = std::make_shared<JValue>();
    v->kind = JValue::ARR;
    ws();
    if (p < end && *p == ']') { ++p; return v; }
    while (true) {
      v->arr.push_back(value());
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == ']') { ++p; break; }
      fail("bad array");
    }
    return v;
  }
  JPtr object() {
    ++p;  // {
    auto v = std::make_shared<JValue>();
    v->kind = JValue::OBJ;
    ws();
    if (p < end && *p == '}') { ++p; return v; }
    while (true) {
      ws();
      std::string key = string();
      ws();
      if (p >= end || *p != ':') fail("expected :");
      ++p;
      v->obj[key] = value();
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == '}') { ++p; break; }
      fail("bad object");
    }
    return v;
  }
};

// -------------------------------------------------------------- Tensor ----
enum DType { F32 = 0, F64 = 1, I32 = 2, I64 = 3 };

inline size_t dtype_size(DType t) {
  switch (t) {
    case F32: case I32: return 4;
    default: return 8;
  }
}

struct Tensor {
  DType dtype = F32;
  std::vector<int64_t> dims;
  std::vector<char> buf;

  int64_t numel() const {
    int64_t n = 1;
    for (auto d : dims) n *= d;
    return n;
  }
  float* f() { return reinterpret_cast<float*>(buf.data()); }
  const float* f() const { return reinterpret_cast<const float*>(buf.data()); }
  void alloc() { buf.assign((size_t)numel() * dtype_size(dtype), 0); }
  int64_t as_i64(int64_t idx) const {
    switch (dtype) {
      case I64: return reinterpret_cast<const int64_t*>(buf.data())[idx];
      case I32: return reinterpret_cast<const int32_t*>(buf.data())[idx];
      case F32: return (int64_t)f()[idx];
      default: return (int64_t)reinterpret_cast<const double*>(buf.data())[idx];
    }
  }
};

// Copy-free alias when already F32 (the common case: weights are loaded as
// F32 once and must not be memcpy'd per request); converts into `scratch`
// otherwise.
inline const Tensor& as_f32(const Tensor& t, Tensor& scratch);

inline Tensor to_f32(const Tensor& t) {
  if (t.dtype == F32) return t;
  Tensor o;
  o.dtype = F32;
  o.dims = t.dims;
  o.alloc();
  for (int64_t i = 0; i < t.numel(); ++i) {
    switch (t.dtype) {
      case F64: o.f()[i] = (float)reinterpret_cast<const double*>(t.buf.data())[i]; break;
      case I32: o.f()[i] = (float)reinterpret_cast<const int32_t*>(t.buf.data())[i]; break;
      case I64: o.f()[i] = (float)reinterpret_cast<const int64_t*>(t.buf.data())[i]; break;
      default: break;
    }
  }
  return o;
}

inline const Tensor& as_f32(const Tensor& t, Tensor& scratch) {
  if (t.dtype == F32) return t;
  scratch = to_f32(t);
  return scratch;
}

// ----------------------------------------------------------- NPY loader ---
inline Tensor load_npy(const std::string& path) {
  std::ifstream in(path, std::ios::binary);
  if (!in) throw std::runtime_error("cannot open " + path);
  char magic[6];
  in.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0)
    throw std::runtime_error("bad npy magic in " + path);
  unsigned char ver[2];
  in.read(reinterpret_cast<char*>(ver), 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    unsigned char b[2];
    in.read(reinterpret_cast<char*>(b), 2);
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    in.read(reinterpret_cast<char*>(b), 4);
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  }
  std::string header(hlen, '\0');
  in.read(header.data(), hlen);

  auto find_field = [&](const std::string& key) -> std::string {
    auto pos = header.find("'" + key + "'");
    if (pos == std::string::npos)
      throw std::runtime_error("npy header missing " + key);
    pos = header.find(':', pos);
    auto endpos = pos + 1;
    int depth = 0;
    while (endpos < header.size()) {
      char c = header[endpos];
      if (c == '(' || c == '[') ++depth;
      if (c == ')' || c == ']') --depth;
      if ((c == ',' && depth == 0) || (c == '}' && depth <= 0)) break;
      ++endpos;
    }
    return header.substr(pos + 1, endpos - pos - 1);
  };

  std::string descr = find_field("descr");
  std::string order = find_field("fortran_order");
  std::string shape = find_field("shape");
  if (order.find("True") != std::string::npos)
    throw std::runtime_error("fortran-order npy unsupported: " + path);

  Tensor t;
  if (descr.find("f4") != std::string::npos) t.dtype = F32;
  else if (descr.find("f8") != std::string::npos) t.dtype = F64;
  else if (descr.find("i4") != std::string::npos) t.dtype = I32;
  else if (descr.find("i8") != std::string::npos) t.dtype = I64;
  else throw std::runtime_error("unsupported npy dtype " + descr + " in " + path);

  for (size_t i = 0; i < shape.size();) {
    if (std::isdigit((unsigned char)shape[i])) {
      size_t j = i;
      while (j < shape.size() && std::isdigit((unsigned char)shape[j])) ++j;
      t.dims.push_back(std::stoll(shape.substr(i, j - i)));
      i = j;
    } else {
      ++i;
    }
  }
  t.alloc();
  in.read(t.buf.data(), t.buf.size());
  if (!in) throw std::runtime_error("truncated npy " + path);
  return t;
}

// ---------------------------------------------------------------- Ops -----
struct OpDesc {
  std::string type;
  std::map<std::string, std::vector<std::string>> inputs, outputs;
  JPtr attrs;

  const std::string& in(const std::string& slot, int i = 0) const {
    static std::string empty;
    auto it = inputs.find(slot);
    if (it == inputs.end() || (int)it->second.size() <= i) return empty;
    return it->second[i];
  }
  const std::string& out(const std::string& slot, int i = 0) const {
    static std::string empty;
    auto it = outputs.find(slot);
    if (it == outputs.end() || (int)it->second.size() <= i) return empty;
    return it->second[i];
  }
  double attr_num(const std::string& k, double dflt) const {
    const JPtr& v = attrs->at(k);
    return v->kind == JValue::NUL ? dflt : v->num();
  }
  bool attr_bool(const std::string& k, bool dflt) const {
    const JPtr& v = attrs->at(k);
    return v->kind == JValue::NUL ? dflt : v->b;
  }
  std::vector<int64_t> attr_ints(const std::string& k) const {
    std::vector<int64_t> out;
    const JPtr& v = attrs->at(k);
    if (v->kind == JValue::ARR)
      for (auto& e : v->arr) out.push_back((int64_t)e->num());
    return out;
  }
};


// parse one block's op list out of the JSON IR (shared by the inference
// predictor and the trainer; rejects control-flow sub-blocks)
inline std::vector<OpDesc> parse_block_ops(const JPtr& block) {
  std::vector<OpDesc> ops;
  for (auto& od : block->at("ops")->arr) {
    OpDesc op;
    op.type = od->at("type")->s;
    for (auto& [slot, names] : od->at("inputs")->obj)
      for (auto& n : names->arr) op.inputs[slot].push_back(n->s);
    for (auto& [slot, names] : od->at("outputs")->obj)
      for (auto& n : names->arr) op.outputs[slot].push_back(n->s);
    op.attrs = od->at("attrs");
    for (auto& [k, v] : op.attrs->obj)
      if (v->kind == JValue::OBJ && v->obj.count("__block__"))
        throw std::runtime_error("control-flow blocks unsupported natively");
    ops.push_back(std::move(op));
  }
  return ops;
}

using Scope = std::map<std::string, Tensor>;

// run-local values over the pristine (never-copied) parameter scope: ops
// only ever create new output tensors, so params need no per-run deep copy
struct Env {
  Scope local;
  const Scope* params = nullptr;
};

inline const Tensor& need(Env& s, const std::string& n) {
  auto it = s.local.find(n);
  if (it != s.local.end()) return it->second;
  if (s.params) {
    auto pit = s.params->find(n);
    if (pit != s.params->end()) return pit->second;
  }
  throw std::runtime_error("missing variable " + n);
}

// broadcast y onto x per the reference elementwise axis rule
// (operators/elementwise_op_function.h: y matches x dims starting at axis)
inline Tensor broadcast_like(const Tensor& x, const Tensor& y, int axis) {
  if (y.dims == x.dims) return to_f32(y);
  int xr = (int)x.dims.size(), yr = (int)y.dims.size();
  // reference trims trailing size-1 dims of Y before aligning
  // (elementwise_op_function.h get_mid_dims / trim_trailing_singular_dims)
  while (yr > 1 && y.dims[yr - 1] == 1) --yr;
  if (axis < 0) axis = xr - yr;
  if (axis < 0 || axis + yr > xr)
    throw std::runtime_error(
        "elementwise broadcast: axis " + std::to_string(axis) +
        " with Y rank " + std::to_string(yr) + " out of range for X rank " +
        std::to_string(xr));
  Tensor yf_s;

  const Tensor& yf = as_f32(y, yf_s);
  Tensor o;
  o.dtype = F32;
  o.dims = x.dims;
  o.alloc();
  // pre/mid/post decomposition: x = [pre, mid(=y), post]
  int64_t pre = 1, mid = 1, post = 1;
  for (int i = 0; i < axis; ++i) pre *= x.dims[i];
  for (int i = 0; i < yr; ++i) mid *= x.dims[axis + i];
  for (int i = axis + yr; i < xr; ++i) post *= x.dims[i];
  if (mid != yf.numel())
    throw std::runtime_error("elementwise broadcast shape mismatch");
  for (int64_t a = 0; a < pre; ++a)
    for (int64_t b = 0; b < mid; ++b)
      for (int64_t c = 0; c < post; ++c)
        o.f()[(a * mid + b) * post + c] = yf.f()[b];
  return o;
}

inline void matmul2d(const float* a, const float* b, float* c, int64_t m, int64_t k,
              int64_t n) {
  for (int64_t i = 0; i < m; ++i) {
    for (int64_t j = 0; j < n; ++j) c[i * n + j] = 0.f;
    for (int64_t kk = 0; kk < k; ++kk) {
      float av = a[i * k + kk];
      if (av == 0.f) continue;
      const float* brow = b + kk * n;
      float* crow = c + i * n;
      for (int64_t j = 0; j < n; ++j) crow[j] += av * brow[j];
    }
  }
}

inline void run_op(const OpDesc& op, Env& env) {
  const std::string& t = op.type;

  if (t == "feed" || t == "fetch") return;

  if (t == "mul") {
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    Tensor y_s;
    const Tensor& y = as_f32(need(env, op.in("Y")), y_s);
    int xn = (int)op.attr_num("x_num_col_dims", 1);
    int yn = (int)op.attr_num("y_num_col_dims", 1);
    int64_t m = 1, k = 1, k2 = 1, n = 1;
    for (int i = 0; i < xn; ++i) m *= x.dims[i];
    for (size_t i = xn; i < x.dims.size(); ++i) k *= x.dims[i];
    for (int i = 0; i < yn; ++i) k2 *= y.dims[i];
    for (size_t i = yn; i < y.dims.size(); ++i) n *= y.dims[i];
    if (k != k2) throw std::runtime_error("mul: inner dims mismatch");
    Tensor o;
    o.dtype = F32;
    for (int i = 0; i < xn; ++i) o.dims.push_back(x.dims[i]);
    for (size_t i = yn; i < y.dims.size(); ++i) o.dims.push_back(y.dims[i]);
    o.alloc();
    matmul2d(x.f(), y.f(), o.f(), m, k, n);
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "elementwise_add" || t == "elementwise_sub" ||
      t == "elementwise_mul" || t == "elementwise_div") {
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    Tensor yb = broadcast_like(x, need(env, op.in("Y")),
                               (int)op.attr_num("axis", -1));
    Tensor o;
    o.dtype = F32;
    o.dims = x.dims;
    o.alloc();
    for (int64_t i = 0; i < x.numel(); ++i) {
      float a = x.f()[i], b = yb.f()[i];
      o.f()[i] = t == "elementwise_add" ? a + b
                 : t == "elementwise_sub" ? a - b
                 : t == "elementwise_mul" ? a * b
                                          : a / b;
    }
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "relu" || t == "sigmoid" || t == "tanh" || t == "sqrt" ||
      t == "exp" || t == "abs") {
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    Tensor o;
    o.dtype = F32;
    o.dims = x.dims;
    o.alloc();
    for (int64_t i = 0; i < x.numel(); ++i) {
      float v = x.f()[i];
      o.f()[i] = t == "relu"    ? (v > 0 ? v : 0)
                 : t == "sigmoid" ? 1.f / (1.f + std::exp(-v))
                 : t == "tanh"    ? std::tanh(v)
                 : t == "sqrt"    ? std::sqrt(v)
                 : t == "exp"     ? std::exp(v)
                                  : std::fabs(v);
    }
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "softmax" || t == "log_softmax") {
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    Tensor o;
    o.dtype = F32;
    o.dims = x.dims;
    o.alloc();
    int64_t last = x.dims.back(), rows = x.numel() / last;
    for (int64_t r = 0; r < rows; ++r) {
      const float* xi = x.f() + r * last;
      float* oi = o.f() + r * last;
      float mx = xi[0];
      for (int64_t j = 1; j < last; ++j) mx = std::max(mx, xi[j]);
      float sum = 0;
      for (int64_t j = 0; j < last; ++j) { oi[j] = std::exp(xi[j] - mx); sum += oi[j]; }
      for (int64_t j = 0; j < last; ++j)
        oi[j] = (t == "softmax") ? oi[j] / sum
                                 : (xi[j] - mx) - std::log(sum);
    }
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "scale") {
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    float s = (float)op.attr_num("scale", 1.0);
    float b = (float)op.attr_num("bias", 0.0);
    bool after = op.attr_bool("bias_after_scale", true);
    Tensor o;
    o.dtype = F32;
    o.dims = x.dims;
    o.alloc();
    for (int64_t i = 0; i < x.numel(); ++i)
      o.f()[i] = after ? x.f()[i] * s + b : (x.f()[i] + b) * s;
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "dropout") {  // inference: downgrade_in_infer (out = x*(1-p))
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    float keep = 1.f - (float)op.attr_num("dropout_prob", 0.5);
    Tensor o;
    o.dtype = F32;
    o.dims = x.dims;
    o.alloc();
    for (int64_t i = 0; i < x.numel(); ++i) o.f()[i] = x.f()[i] * keep;
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "batch_norm") {  // is_test semantics: running stats
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    Tensor sc_s;
    const Tensor& sc = as_f32(need(env, op.in("Scale")), sc_s);
    Tensor bi_s;
    const Tensor& bi = as_f32(need(env, op.in("Bias")), bi_s);
    Tensor mu_s;
    const Tensor& mu = as_f32(need(env, op.in("Mean")), mu_s);
    Tensor va_s;
    const Tensor& va = as_f32(need(env, op.in("Variance")), va_s);
    float eps = (float)op.attr_num("epsilon", 1e-5);
    int64_t C = x.dims.size() > 1 ? x.dims[1] : x.dims[0];
    int64_t inner = 1;
    for (size_t i = 2; i < x.dims.size(); ++i) inner *= x.dims[i];
    int64_t N = x.dims.size() > 1 ? x.dims[0] : 1;
    Tensor o;
    o.dtype = F32;
    o.dims = x.dims;
    o.alloc();
    for (int64_t n = 0; n < N; ++n)
      for (int64_t c = 0; c < C; ++c) {
        float inv = 1.f / std::sqrt(va.f()[c] + eps);
        float a = sc.f()[c] * inv;
        float b = bi.f()[c] - mu.f()[c] * a;
        const float* xi = x.f() + (n * C + c) * inner;
        float* oi = o.f() + (n * C + c) * inner;
        for (int64_t i = 0; i < inner; ++i) oi[i] = xi[i] * a + b;
      }
    env.local[op.out("Y")] = std::move(o);
    return;
  }

  if (t == "conv2d" || t == "depthwise_conv2d") {  // NCHW, OIHW
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("Input")), x_s);
    Tensor w_s;
    const Tensor& w = as_f32(need(env, op.in("Filter")), w_s);
    auto strides = op.attr_ints("strides");
    auto pads = op.attr_ints("paddings");
    auto dil = op.attr_ints("dilations");
    if (strides.empty()) strides = {1, 1};
    if (pads.empty()) pads = {0, 0};
    if (dil.empty()) dil = {1, 1};
    int64_t groups = (int64_t)op.attr_num("groups", 1);
    if (t == "depthwise_conv2d") groups = x.dims[1];
    int64_t N = x.dims[0], C = x.dims[1], H = x.dims[2], W = x.dims[3];
    int64_t O = w.dims[0], KC = w.dims[1], KH = w.dims[2], KW = w.dims[3];
    int64_t OH = (H + 2 * pads[0] - (dil[0] * (KH - 1) + 1)) / strides[0] + 1;
    int64_t OW = (W + 2 * pads[1] - (dil[1] * (KW - 1) + 1)) / strides[1] + 1;
    int64_t cpg = C / groups, opg = O / groups;
    if (KC != cpg) throw std::runtime_error("conv2d: filter/group mismatch");
    Tensor o;
    o.dtype = F32;
    o.dims = {N, O, OH, OW};
    o.alloc();
    for (int64_t n = 0; n < N; ++n)
      for (int64_t oc = 0; oc < O; ++oc) {
        int64_t g = oc / opg;
        for (int64_t oh = 0; oh < OH; ++oh)
          for (int64_t ow = 0; ow < OW; ++ow) {
            float acc = 0;
            for (int64_t ic = 0; ic < cpg; ++ic)
              for (int64_t kh = 0; kh < KH; ++kh) {
                int64_t ih = oh * strides[0] - pads[0] + kh * dil[0];
                if (ih < 0 || ih >= H) continue;
                for (int64_t kw = 0; kw < KW; ++kw) {
                  int64_t iw = ow * strides[1] - pads[1] + kw * dil[1];
                  if (iw < 0 || iw >= W) continue;
                  acc += x.f()[((n * C + g * cpg + ic) * H + ih) * W + iw] *
                         w.f()[((oc * KC + ic) * KH + kh) * KW + kw];
                }
              }
            o.f()[((n * O + oc) * OH + oh) * OW + ow] = acc;
          }
      }
    env.local[op.out("Output")] = std::move(o);
    return;
  }

  if (t == "pool2d") {
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
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
    bool exclusive = op.attr_bool("exclusive", true);
    int64_t OH = (H + 2 * pads[0] - ksize[0]) / strides[0] + 1;
    int64_t OW = (W + 2 * pads[1] - ksize[1]) / strides[1] + 1;
    Tensor o;
    o.dtype = F32;
    o.dims = {N, C, OH, OW};
    o.alloc();
    for (int64_t n = 0; n < N; ++n)
      for (int64_t c = 0; c < C; ++c)
        for (int64_t oh = 0; oh < OH; ++oh)
          for (int64_t ow = 0; ow < OW; ++ow) {
            float best = -INFINITY, sum = 0;
            int64_t cnt = 0;
            for (int64_t kh = 0; kh < ksize[0]; ++kh) {
              int64_t ih = oh * strides[0] - pads[0] + kh;
              if (ih < 0 || ih >= H) continue;
              for (int64_t kw = 0; kw < ksize[1]; ++kw) {
                int64_t iw = ow * strides[1] - pads[1] + kw;
                if (iw < 0 || iw >= W) continue;
                float v = x.f()[((n * C + c) * H + ih) * W + iw];
                best = std::max(best, v);
                sum += v;
                ++cnt;
              }
            }
            int64_t denom = exclusive ? cnt : ksize[0] * ksize[1];
            o.f()[((n * C + c) * OH + oh) * OW + ow] =
                ptype == "max" ? best : sum / (float)denom;
          }
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "lookup_table") {
    const Tensor& w = need(env, op.in("W"));
    const Tensor& ids = need(env, op.in("Ids"));
    Tensor wf_s;

    const Tensor& wf = as_f32(w, wf_s);
    int64_t D = w.dims[1];
    int64_t n = ids.numel();
    int64_t pad = (int64_t)op.attr_num("padding_idx", -1);
    Tensor o;
    o.dtype = F32;
    o.dims = ids.dims;
    if (!o.dims.empty() && o.dims.back() == 1) o.dims.pop_back();
    o.dims.push_back(D);
    o.alloc();
    for (int64_t i = 0; i < n; ++i) {
      int64_t id = ids.as_i64(i);
      if (id < 0 || id >= w.dims[0])
        throw std::runtime_error("lookup_table: id out of range");
      for (int64_t j = 0; j < D; ++j)
        o.f()[i * D + j] = (pad >= 0 && id == pad) ? 0.f : wf.f()[id * D + j];
    }
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "concat") {
    auto it = op.inputs.find("X");
    if (it == op.inputs.end()) throw std::runtime_error("concat: no X");
    std::vector<const Tensor*> xs;
    for (auto& n : it->second) xs.push_back(&need(env, n));
    int axis = (int)op.attr_num("axis", 0);
    if (axis < 0) axis += (int)xs[0]->dims.size();
    Tensor o;
    o.dtype = F32;
    o.dims = xs[0]->dims;
    int64_t total = 0;
    for (auto* x : xs) total += x->dims[axis];
    o.dims[axis] = total;
    o.alloc();
    int64_t outer = 1, inner = 1;
    for (int i = 0; i < axis; ++i) outer *= o.dims[i];
    for (size_t i = axis + 1; i < o.dims.size(); ++i) inner *= o.dims[i];
    std::vector<Tensor> xf;
    for (auto* x : xs) xf.push_back(to_f32(*x));
    for (int64_t a = 0; a < outer; ++a) {
      int64_t off = 0;
      for (size_t xi = 0; xi < xf.size(); ++xi) {
        int64_t rows = xf[xi].dims[axis];
        std::memcpy(o.f() + (a * total + off) * inner,
                    xf[xi].f() + a * rows * inner,
                    (size_t)rows * inner * sizeof(float));
        off += rows;
      }
    }
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  if (t == "reshape") {
    Tensor x = need(env, op.in("X"));
    auto shape = op.attr_ints("shape");
    int64_t known = 1, infer = -1;
    for (size_t i = 0; i < shape.size(); ++i) {
      if (shape[i] == 0) shape[i] = x.dims[i];
      if (shape[i] == -1) infer = (int64_t)i;
      else known *= shape[i];
    }
    if (infer >= 0) shape[infer] = x.numel() / known;
    x.dims.assign(shape.begin(), shape.end());
    env.local[op.out("Out")] = std::move(x);
    return;
  }

  if (t == "mean") {
    Tensor x_s;

    const Tensor& x = as_f32(need(env, op.in("X")), x_s);
    Tensor o;
    o.dtype = F32;
    o.dims = {};
    o.alloc();
    double s = 0;
    for (int64_t i = 0; i < x.numel(); ++i) s += x.f()[i];
    o.f()[0] = (float)(s / (double)x.numel());
    env.local[op.out("Out")] = std::move(o);
    return;
  }

  throw std::runtime_error("native predictor: unsupported op '" + t +
                           "' (serve this model via the Executor)");
}

// ------------------------------------------------------------ Predictor ---
}  // namespace ptnative
