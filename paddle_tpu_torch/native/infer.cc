// Native inference predictor: load a save_inference_model directory
// (__model__ JSON program + per-variable .npy params) and serve predictions
// through a C ABI — no Python in the serving path.
//
// Reference parity: paddle/contrib/inference/paddle_inference_api.h:1
// (PaddlePredictor::Run) and paddle/fluid/inference/io.cc:1
// (Load/LoadPersistables). The reference's native predictor sits on its full
// C++ kernel library; this runtime implements the CPU inference subset the
// framework's layer front-end emits (fc = mul+elementwise_add+act, conv/pool/
// batch_norm, embeddings, softmax, concat/reshape/scale/dropout), which
// covers the model zoo's saved inference programs. Serving on the card rides
// the Executor; this library is the no-Python CPU deployment surface.
//
// Build: paddle_tpu_torch/native/build.py infer_lib() -> libptinfer.so
// ABI (all functions return 0 on success, -1 on error; pt_last_error()):
//   void*       pt_create(const char* model_dir);
//   int         pt_feed_count(void*); const char* pt_feed_name(void*, int);
//   int         pt_fetch_count(void*); const char* pt_fetch_name(void*, int);
//   int         pt_run(void*, int n, const char** names, const int* dtypes,
//                      const int* ndims, const int64_t* dims_concat,
//                      const void** datas);
//   int         pt_output(void*, int i, int* dtype, int* ndim,
//                         const int64_t** dims, const void** data);
//   void        pt_destroy(void*);
// dtype codes: 0=float32 1=float64 2=int32 3=int64

#include "runtime.h"

namespace {

using namespace ptnative;

struct Predictor {
  std::vector<OpDesc> ops;
  Scope params;
  std::vector<std::string> feed_names, fetch_names;
  std::vector<Tensor> outputs;
};

thread_local std::string g_err;

Predictor* create(const std::string& dir) {
  std::ifstream in(dir + "/__model__");
  if (!in) throw std::runtime_error("cannot open " + dir + "/__model__");
  std::stringstream ss;
  ss << in.rdbuf();
  std::string text = ss.str();
  JParser parser(text);
  JPtr root = parser.parse();

  auto pred = std::make_unique<Predictor>();
  for (auto& v : root->at("feed_var_names")->arr) pred->feed_names.push_back(v->s);
  for (auto& v : root->at("fetch_var_names")->arr) pred->fetch_names.push_back(v->s);

  const JPtr& prog = root->at("program");
  const JPtr& block0 = prog->at("blocks")->arr.at(0);
  for (auto& [name, vd] : block0->at("vars")->obj) {
    if (vd->at("persistable")->kind == JValue::BOOL && vd->at("persistable")->b)
      pred->params[name] = load_npy(dir + "/" + name + ".npy");
  }
  pred->ops = parse_block_ops(block0);
  return pred.release();
}

}  // namespace

extern "C" {

const char* pt_last_error() { return g_err.c_str(); }

void* pt_create(const char* model_dir) {
  try {
    return create(model_dir);
  } catch (const std::exception& e) {
    g_err = e.what();
    return nullptr;
  }
}

int pt_feed_count(void* p) { return (int)((Predictor*)p)->feed_names.size(); }
const char* pt_feed_name(void* p, int i) {
  return ((Predictor*)p)->feed_names[i].c_str();
}
int pt_fetch_count(void* p) { return (int)((Predictor*)p)->fetch_names.size(); }
const char* pt_fetch_name(void* p, int i) {
  return ((Predictor*)p)->fetch_names[i].c_str();
}

int pt_run(void* pv, int n, const char** names, const int* dtypes,
           const int* ndims, const int64_t* dims_concat, const void** datas) {
  try {
    auto* pred = (Predictor*)pv;
    Env env;
    env.params = &pred->params;  // referenced, never copied per run
    int64_t doff = 0;
    for (int i = 0; i < n; ++i) {
      Tensor t;
      t.dtype = (DType)dtypes[i];
      for (int d = 0; d < ndims[i]; ++d) t.dims.push_back(dims_concat[doff + d]);
      doff += ndims[i];
      t.alloc();
      std::memcpy(t.buf.data(), datas[i], t.buf.size());
      env.local[names[i]] = std::move(t);
    }
    for (auto& op : pred->ops) run_op(op, env);
    pred->outputs.clear();
    for (auto& fn : pred->fetch_names) pred->outputs.push_back(need(env, fn));
    return 0;
  } catch (const std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

int pt_output(void* pv, int i, int* dtype, int* ndim, const int64_t** dims,
              const void** data) {
  auto* pred = (Predictor*)pv;
  if (i < 0 || i >= (int)pred->outputs.size()) {
    g_err = "output index out of range";
    return -1;
  }
  Tensor& t = pred->outputs[i];
  *dtype = (int)t.dtype;
  *ndim = (int)t.dims.size();
  *dims = t.dims.data();
  *data = t.buf.data();
  return 0;
}

void pt_destroy(void* p) { delete (Predictor*)p; }

}  // extern "C"
