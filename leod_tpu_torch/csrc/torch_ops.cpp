// The custom ops `leod_tpu_torch::*`: their schemas, their CPU
// implementations (the plain versions over ATen), their Meta
// implementations (the output's shape and dtype, for `torch.export` and
// fake tensors) and, built with LEOD_WITH_CUDA, their CUDA
// implementations, which check what the kernels take, launch through the
// plain C entry points of csrc/maxvit.cu and csrc/nms.cu on the current
// stream, and count their launches.
//
// This file is the only owner of the ops: `ops/_build.py` compiles it
// into one library (with the kernels' objects on a machine with nvcc),
// the kernel wrappers load that library, and a serving artifact carries
// it (`artifact.py`), so the program runs in a process that has torch and
// nothing else. Only PyTorch's library and ATen headers are included
// (not <torch/extension.h>, not pybind), which keeps the build short.
//
// The build defines LEOD_BUILD_ID (a hash of the sources, flags, torch
// version and variant), LEOD_VARIANT ("cuda-sm_90a" or "cpu") and
// LEOD_TORCH_VERSION; `leod_ops_info` carries them as a string a loader
// can read from the file's bytes without loading it.

#include <ATen/ATen.h>
#include <torch/library.h>
#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cmath>
#include <mutex>
#include <optional>
#include <sstream>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

#ifdef LEOD_WITH_CUDA
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

extern "C" {
int leod_block_attention(const void* x, void* o, const void* ln_w,
                         const void* ln_b, const void* qkv_w,
                         const void* qkv_b, int B, int H, int W, int C,
                         int dim_head, int heads, int ph, int pw,
                         int grid_kind, float eps, int cluster, int num_sms,
                         int* plan, void* stream);
int leod_block_mlp(const void* x, const void* o, void* out,
                   const void* proj_w, const void* proj_b, const void* ls1,
                   const void* ln_w, const void* ln_b, const void* in_w,
                   const void* in_b, const void* out_w, const void* out_b,
                   const void* ls2, int R, int C, int inner, int gated,
                   int act, float eps, int cluster, int num_sms, int* plan,
                   void* stream);
int leod_block_mlp_tp(const void* x, const void* a, void* x1, void* part,
                      const void* proj_b, const void* ls1, const void* ln_w,
                      const void* ln_b, const void* in_w, const void* in_b,
                      const void* out_w, int R, int C, int inner, int gated,
                      int act, float eps, int cluster, int num_sms, int* plan,
                      void* stream);
int leod_block_residual(const void* x1, const void* p, const void* out_b,
                        const void* ls2, void* out, int R, int C,
                        void* stream);
int leod_lstm_update(const void* x, const void* h, const void* c,
                     const void* w, const void* b, void* h_out, void* c_out,
                     int R, int C, int c_f32, int cluster, int num_sms,
                     int* plan, void* stream);
int leod_nms_mask(const void* boxes, const void* valid, const void* cls,
                  float thr, int B, int K, void* mask, void* keep,
                  void* stream);
}
#endif

#ifndef LEOD_BUILD_ID
#define LEOD_BUILD_ID "unversioned"
#endif
#ifndef LEOD_VARIANT
#define LEOD_VARIANT "cpu"
#endif
#ifndef LEOD_TORCH_VERSION
#define LEOD_TORCH_VERSION "unknown"
#endif
#define LEOD_INFO                                                        \
  "{\"build\": \"" LEOD_BUILD_ID "\", \"variant\": \"" LEOD_VARIANT      \
  "\", \"torch\": \"" LEOD_TORCH_VERSION "\"}"

extern "C" __attribute__((used, visibility("default")))
const char leod_ops_info[] = "LEOD_OPS_INFO" LEOD_INFO;

namespace {

using at::Tensor;
using OptTensor = std::optional<Tensor>;

// ---------------------------------------------------------------------------
// Launch counters and the last launch's plan of each op
// ---------------------------------------------------------------------------

const char* const kOps[] = {"block_attention", "block_mlp", "block_mlp_tp",
                            "block_residual", "lstm_update", "nms_mask"};
constexpr int kNumOps = 6;
enum Op { kAttention, kMlp, kMlpTp, kResidual, kLstm, kNms };

std::atomic<int64_t> g_launches[kNumOps];
std::mutex g_plan_mu;
std::vector<int64_t> g_plans[kNumOps];

int op_index(c10::string_view name) {
  for (int i = 0; i < kNumOps; ++i)
    if (name == kOps[i]) return i;
  TORCH_CHECK_VALUE(false, "no op ", std::string(name), " counts launches");
  return -1;
}

std::string build_info() {
  Dl_info dl{};
  std::string path;
  if (dladdr(reinterpret_cast<const void*>(&leod_ops_info), &dl) &&
      dl.dli_fname)
    path = dl.dli_fname;
  std::string info = LEOD_INFO;
  std::ostringstream out;
  out << info.substr(0, info.size() - 1) << ", \"path\": \"" << path
      << "\"}";
  return out.str();
}

std::string launch_counts() {
  std::ostringstream out;
  out << "{";
  for (int i = 0; i < kNumOps; ++i)
    out << (i ? ", " : "") << "\"" << kOps[i] << "\": " << g_launches[i].load();
  out << "}";
  return out.str();
}

void set_launch_count(c10::string_view op, int64_t count) {
  g_launches[op_index(op)] = count;
}

std::vector<int64_t> last_plan(c10::string_view op) {
  const int i = op_index(op);
  std::lock_guard<std::mutex> lock(g_plan_mu);
  return g_plans[i];
}

// ---------------------------------------------------------------------------
// Plain versions (CPU), the Python ones of ops/maxvit_cuda.py and
// ops/nms.py op for op
// ---------------------------------------------------------------------------

Tensor act_fn(const Tensor& x, c10::string_view act) {
  if (act == "gelu") return at::gelu(x, "tanh");
  if (act == "silu" || act == "swish") return at::silu(x);
  if (act == "relu") return at::relu(x);
  if (act == "lrelu") return at::leaky_relu(x, 0.1);
  if (act == "sigmoid") return at::sigmoid(x);
  if (act == "tanh") return at::tanh(x);
  TORCH_CHECK_VALUE(false, "unknown activation ", std::string(act));
  return x;
}

Tensor layer_norm(const Tensor& x, const OptTensor& w, const OptTensor& b,
                  double eps) {
  return at::layer_norm(x, {x.size(-1)}, w, b, eps);
}

Tensor mlp_hidden(const Tensor& x, const Tensor& in_w, const OptTensor& in_b,
                  c10::string_view act, bool gated) {
  Tensor h = at::linear(x, in_w, in_b);
  if (gated) {
    auto parts = h.chunk(2, -1);
    return parts[0] * act_fn(parts[1], act);
  }
  return act_fn(h, act);
}

Tensor with_scale(const Tensor& y, const OptTensor& ls) {
  return ls.has_value() ? y * *ls : y;
}

Tensor window_partition(const Tensor& x, int64_t wh, int64_t ww) {
  const int64_t b = x.size(0), h = x.size(1), w = x.size(2), c = x.size(3);
  return x.reshape({b, h / wh, wh, w / ww, ww, c})
      .permute({0, 1, 3, 2, 4, 5})
      .reshape({-1, wh * ww, c});
}

Tensor window_reverse(const Tensor& x, int64_t wh, int64_t ww, int64_t h,
                      int64_t w) {
  const int64_t c = x.size(-1);
  return x.reshape({-1, h / wh, w / ww, wh, ww, c})
      .permute({0, 1, 3, 2, 4, 5})
      .reshape({-1, h, w, c});
}

Tensor grid_partition(const Tensor& x, int64_t gh, int64_t gw) {
  const int64_t b = x.size(0), h = x.size(1), w = x.size(2), c = x.size(3);
  return x.reshape({b, gh, h / gh, gw, w / gw, c})
      .permute({0, 2, 4, 1, 3, 5})
      .reshape({-1, gh * gw, c});
}

Tensor grid_reverse(const Tensor& x, int64_t gh, int64_t gw, int64_t h,
                    int64_t w) {
  const int64_t c = x.size(-1);
  return x.reshape({-1, h / gh, w / gw, gh, gw, c})
      .permute({0, 3, 1, 4, 2, 5})
      .reshape({-1, h, w, c});
}

// layers.attention_core: heads of dim_head over tokens [N, T, C], up to
// the output projection
Tensor attention_core(const Tensor& x, const Tensor& qkv_w,
                      const OptTensor& qkv_b, int64_t dim_head) {
  const int64_t n = x.size(0), t = x.size(1);
  const int64_t heads = qkv_w.size(0) / (3 * dim_head);
  Tensor qkv = at::linear(x, qkv_w, qkv_b).reshape({n, t, heads, 3 * dim_head});
  auto qkv_parts = qkv.split(dim_head, -1);
  Tensor q = qkv_parts[0].transpose(1, 2);
  Tensor k = qkv_parts[1].transpose(1, 2);
  Tensor v = qkv_parts[2].transpose(1, 2);
  Tensor attn = at::matmul(q, k.transpose(-1, -2)) *
                std::pow(static_cast<double>(dim_head), -0.5);
  attn = at::softmax(attn.to(at::kFloat), -1).to(q.scalar_type());
  return at::matmul(attn, v).transpose(1, 2).reshape({n, t, heads * dim_head});
}

Tensor attention_cpu(const Tensor& x, const OptTensor& norm_w,
                     const OptTensor& norm_b, const Tensor& qkv_w,
                     const OptTensor& qkv_b, int64_t dim_head, int64_t ph,
                     int64_t pw, bool grid_kind, double eps,
                     int64_t /*cluster*/) {
  TORCH_CHECK_VALUE(x.dim() == 4, "block_attention: x [B, H, W, C], got ",
                    x.sizes());
  const int64_t h = x.size(1), w = x.size(2);
  Tensor y = grid_kind ? grid_partition(x, ph, pw)
                       : window_partition(x, ph, pw);
  if (norm_w.has_value()) y = layer_norm(y, norm_w, norm_b, eps);
  y = attention_core(y, qkv_w, qkv_b, dim_head);
  return grid_kind ? grid_reverse(y, ph, pw, h, w)
                   : window_reverse(y, ph, pw, h, w);
}

Tensor mlp_cpu(const Tensor& x, const Tensor& o, const Tensor& proj_w,
               const OptTensor& proj_b, const OptTensor& ls1,
               const Tensor& norm_w, const Tensor& norm_b, const Tensor& in_w,
               const OptTensor& in_b, const Tensor& out_w,
               const OptTensor& out_b, const OptTensor& ls2,
               c10::string_view act, bool gated, double eps,
               int64_t /*cluster*/) {
  Tensor x1 = x + with_scale(at::linear(o, proj_w, proj_b), ls1);
  Tensor y = at::linear(mlp_hidden(layer_norm(x1, norm_w, norm_b, eps), in_w,
                                   in_b, act, gated),
                        out_w, out_b);
  return x1 + with_scale(y, ls2);
}

std::tuple<Tensor, Tensor> mlp_tp_cpu(
    const Tensor& x, const Tensor& a, const OptTensor& proj_b,
    const OptTensor& ls1, const Tensor& norm_w, const Tensor& norm_b,
    const Tensor& in_w, const OptTensor& in_b, const Tensor& out_w,
    c10::string_view act, bool gated, double eps, int64_t /*cluster*/) {
  Tensor y = (proj_b.has_value() ? a + proj_b->to(at::kFloat) : a)
                 .to(x.scalar_type());
  Tensor x1 = x + with_scale(y, ls1);
  Tensor h = mlp_hidden(layer_norm(x1, norm_w, norm_b, eps), in_w, in_b, act,
                        gated);
  return {x1, at::linear(h.to(at::kFloat), out_w.to(at::kFloat))};
}

Tensor residual_cpu(const Tensor& x1, const Tensor& p, const OptTensor& out_b,
                    const OptTensor& ls2) {
  Tensor y = (out_b.has_value() ? p + out_b->to(at::kFloat) : p)
                 .to(x1.scalar_type());
  return x1 + with_scale(y, ls2);
}

std::tuple<Tensor, Tensor> lstm_cpu(const Tensor& x, const Tensor& h_prev,
                                    const Tensor& c_prev, const Tensor& weight,
                                    const Tensor& bias, int64_t /*cluster*/) {
  using at::indexing::Slice;
  const int64_t d = x.size(-1);
  Tensor k = weight.reshape({weight.size(0), -1}).to(at::kFloat);
  Tensor mix = at::linear(x.to(at::kFloat), k.index({Slice(), Slice(0, d)})) +
               at::linear(h_prev.to(x.scalar_type()).to(at::kFloat),
                          k.index({Slice(), Slice(d, at::indexing::None)})) +
               bias.to(at::kFloat);
  auto gates = at::sigmoid(mix.index({"...", Slice(0, 3 * d)})).chunk(3, -1);
  Tensor c = gates[0] * c_prev.to(at::kFloat) +
             gates[1] * at::tanh(mix.index({"...", Slice(3 * d,
                                                          at::indexing::None)}));
  return {(gates[2] * at::tanh(c)).to(x.scalar_type()),
          c.to(c_prev.scalar_type())};
}

// boxes.pairwise_iou: each product and sum rounded on its own, in the
// same order as the kernel's `iou_exceeds`
Tensor pairwise_iou(const Tensor& a) {
  using at::indexing::Slice;
  const auto lo = Slice(0, 2), hi = Slice(2, 4);
  Tensor tl = at::maximum(a.index({"...", Slice(), at::indexing::None, lo}),
                          a.index({"...", at::indexing::None, Slice(), lo}));
  Tensor br = at::minimum(a.index({"...", Slice(), at::indexing::None, hi}),
                          a.index({"...", at::indexing::None, Slice(), hi}));
  Tensor wh = br - tl;
  Tensor overlap = (tl < br).all(-1);
  Tensor inter = wh.select(-1, 0) * wh.select(-1, 1) * overlap;
  Tensor area = (a.select(-1, 2) - a.select(-1, 0)) *
                (a.select(-1, 3) - a.select(-1, 1));
  Tensor uni = area.unsqueeze(-1) + area.unsqueeze(-2) - inter;
  return inter / at::maximum(uni, at::scalar_tensor(1e-16, uni.options()));
}

Tensor nms_cpu(const Tensor& boxes, double iou_threshold, const Tensor& valid,
               const OptTensor& class_ids) {
  const int64_t k = boxes.size(-2);
  Tensor suppress = pairwise_iou(boxes) > iou_threshold;
  if (class_ids.has_value())
    suppress = suppress.logical_and(class_ids->unsqueeze(-2) ==
                                    class_ids->unsqueeze(-1));
  suppress = suppress.reshape({-1, k, k}).contiguous();
  Tensor keep = valid.to(at::kBool).reshape({-1, k}).clone();
  const int64_t n = keep.size(0);
  const bool* s = suppress.data_ptr<bool>();
  bool* kp = keep.data_ptr<bool>();
  // greedy: a kept box i suppresses every later j it overlaps
  for (int64_t b = 0; b < n; ++b)
    for (int64_t i = 0; i < k; ++i) {
      if (!kp[b * k + i]) continue;
      const bool* row = s + (b * k + i) * k;
      for (int64_t j = i + 1; j < k; ++j)
        if (row[j]) kp[b * k + j] = false;
    }
  return keep.reshape(valid.sizes());
}

// ---------------------------------------------------------------------------
// Meta implementations: the outputs' shapes and dtypes
// ---------------------------------------------------------------------------

Tensor attention_meta(const Tensor& x, const OptTensor&, const OptTensor&,
                      const Tensor& qkv_w, const OptTensor&, int64_t, int64_t,
                      int64_t, bool, double, int64_t) {
  std::vector<c10::SymInt> shape(x.sym_sizes().begin(), x.sym_sizes().end());
  shape.back() = qkv_w.sym_size(0) / 3;
  return x.new_empty_symint(shape);
}

Tensor mlp_meta(const Tensor& x, const Tensor&, const Tensor&,
                const OptTensor&, const OptTensor&, const Tensor&,
                const Tensor&, const Tensor&, const OptTensor&, const Tensor&,
                const OptTensor&, const OptTensor&, c10::string_view, bool,
                double, int64_t) {
  return at::empty_like(x);
}

std::tuple<Tensor, Tensor> mlp_tp_meta(
    const Tensor& x, const Tensor& a, const OptTensor&, const OptTensor&,
    const Tensor&, const Tensor&, const Tensor&, const OptTensor&,
    const Tensor&, c10::string_view, bool, double, int64_t) {
  return {at::empty_like(x), at::empty_like(a)};
}

Tensor residual_meta(const Tensor& x1, const Tensor&, const OptTensor&,
                     const OptTensor&) {
  return at::empty_like(x1);
}

std::tuple<Tensor, Tensor> lstm_meta(const Tensor& x, const Tensor&,
                                     const Tensor& c_prev, const Tensor&,
                                     const Tensor&, int64_t) {
  return {at::empty_like(x), at::empty_like(c_prev)};
}

Tensor nms_meta(const Tensor&, double, const Tensor& valid,
                const OptTensor&) {
  return at::empty_symint(valid.sym_sizes(), valid.options().dtype(at::kBool));
}

#ifdef LEOD_WITH_CUDA
// ---------------------------------------------------------------------------
// CUDA implementations: the kernels' checks, then one launch each
// ---------------------------------------------------------------------------

// (C, dim_head) pairs block_attention's kernel is built for: the stage
// widths of RVT-T and RVT-B (heads of 32) and of RVT-S (heads of 24).
// These lists alone decide what the kernels take; the widths C of the MLP
// and ConvLSTM kernels are kKernelDims.
const std::pair<int64_t, int64_t> kAttnShapes[] = {
    {32, 32}, {48, 24}, {64, 32}, {96, 24}, {128, 32},
    {192, 24}, {256, 32}, {384, 24}, {512, 32}};
const int64_t kKernelDims[] = {32, 48, 64, 96, 128, 192, 256, 384, 512};
constexpr int64_t kMaxTokens = 80;
constexpr int64_t kMaxK = 1024;

bool attn_shape_ok(int64_t c, int64_t dh) {
  for (const auto& s : kAttnShapes)
    if (s.first == c && s.second == dh) return true;
  return false;
}

// (C, heads) pairs the attention kernel takes: every head of a width, or
// a model rank's shard of them (parallel/tensor.py): at heads of 32 a
// power of two below the width's heads, at heads of 24 half of them
bool attn_heads_ok(int64_t c, int64_t heads) {
  for (const auto& s : kAttnShapes) {
    if (s.first != c) continue;
    const int64_t all = c / s.second;
    if (heads == all) return true;
    if (s.second == 32)
      for (int64_t h : {1, 2, 4, 8})
        if (heads == h && h < all) return true;
    if (s.second == 24 && heads == all / 2) return true;
  }
  return false;
}

std::string attn_shapes_str() {
  std::ostringstream out;
  out << "[";
  bool first = true;
  for (const auto& s : kAttnShapes) {
    out << (first ? "" : ", ") << "(" << s.first << ", " << s.second << ")";
    first = false;
  }
  out << "]";
  return out.str();
}

std::string attn_heads_str() {
  std::vector<std::pair<int64_t, int64_t>> pairs;
  for (const auto& s : kAttnShapes)
    for (int64_t h = 1; h <= s.first / s.second; ++h)
      if (attn_heads_ok(s.first, h)) pairs.emplace_back(s.first, h);
  std::sort(pairs.begin(), pairs.end());
  std::ostringstream out;
  out << "[";
  for (size_t i = 0; i < pairs.size(); ++i)
    out << (i ? ", " : "") << "(" << pairs[i].first << ", " << pairs[i].second
        << ")";
  out << "]";
  return out.str();
}

bool kernel_dim_ok(int64_t c) {
  for (int64_t d : kKernelDims)
    if (d == c) return true;
  return false;
}

std::string kernel_dims_str() {
  std::ostringstream out;
  out << "(";
  for (size_t i = 0; i < sizeof(kKernelDims) / sizeof(kKernelDims[0]); ++i)
    out << (i ? ", " : "") << kKernelDims[i];
  out << ")";
  return out.str();
}

std::string shape_str(const Tensor& t) {
  std::ostringstream out;
  out << "(";
  for (int64_t i = 0; i < t.dim(); ++i)
    out << (i ? ", " : "") << t.size(i);
  out << (t.dim() == 1 ? ",)" : ")");
  return out.str();
}

const char* dtype_str(const Tensor& t) {
  switch (t.scalar_type()) {
    case at::kBFloat16: return "torch.bfloat16";
    case at::kFloat: return "torch.float32";
    case at::kHalf: return "torch.float16";
    case at::kDouble: return "torch.float64";
    default: return c10::toString(t.scalar_type());
  }
}

int act_code(c10::string_view act) {
  if (act == "gelu") return 0;
  if (act == "silu") return 1;
  if (act == "relu") return 2;
  TORCH_CHECK_VALUE(false, "the CUDA block takes act in ['gelu', 'relu', "
                    "'silu']");
  return -1;
}

// The kernels take contiguous bf16 CUDA tensors, 32-byte aligned for the
// tensor-core tile loads; anything else raises.
void require_cuda(const char* fn, const Tensor& x,
                  std::initializer_list<const Tensor*> weights) {
  TORCH_CHECK_VALUE(x.is_cuda(), fn, ": tensor on ", x.device(),
                    "; the kernel runs on CUDA and the plain version on the "
                    "CPU");
  auto check = [&](const Tensor& t) {
    TORCH_CHECK_VALUE(t.device() == x.device() &&
                          t.scalar_type() == at::kBFloat16,
                      fn, ": the CUDA kernel takes bf16 tensors on ",
                      x.device(), ", got ", dtype_str(t), " on ", t.device());
    TORCH_CHECK_VALUE(t.is_contiguous() &&
                          reinterpret_cast<uintptr_t>(t.data_ptr()) % 32 == 0,
                      fn, ": tensors must be contiguous and 32-byte aligned");
  };
  check(x);
  for (const Tensor* t : weights)
    if (t != nullptr) check(*t);
}

const Tensor* opt(const OptTensor& t) { return t.has_value() ? &*t : nullptr; }
const void* ptr(const OptTensor& t) {
  return t.has_value() ? t->data_ptr() : nullptr;
}

int num_sms(const Tensor& x) {
  static std::atomic<int> cache[64];
  const int dev = x.get_device();
  int n = dev < 64 ? cache[dev].load() : 0;
  if (n == 0) {
    TORCH_CHECK(cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                       dev) == cudaSuccess,
                "cudaDeviceGetAttribute failed");
    if (dev < 64) cache[dev] = n;
  }
  return n;
}

void* stream(const Tensor& x) {
  return c10::cuda::getCurrentCUDAStream(x.get_device()).stream();
}

// `_build.check`: an entry point's CUDA error becomes an error here
void check(const char* fn, int rc) {
  TORCH_CHECK(rc == 0, fn, ": CUDA error ", rc, " (cudaError_t); the kernel "
              "was not launched or failed to launch");
}

void record(Op op, std::vector<int64_t> plan) {
  {
    std::lock_guard<std::mutex> lock(g_plan_mu);
    g_plans[op] = std::move(plan);
  }
  ++g_launches[op];
}

Tensor attention_cuda(const Tensor& x, const OptTensor& norm_w,
                      const OptTensor& norm_b, const Tensor& qkv_w,
                      const OptTensor& qkv_b, int64_t dim_head, int64_t ph,
                      int64_t pw, bool grid_kind, double eps,
                      int64_t cluster) {
  require_cuda("block_attention", x, {&qkv_w, opt(qkv_b), opt(norm_w),
                                      opt(norm_b)});
  int64_t b = 0, h = 0, w = 0, c = 0;
  if (x.dim() == 4) b = x.size(0), h = x.size(1), w = x.size(2), c = x.size(3);
  const int64_t heads = qkv_w.size(0) / (3 * dim_head);
  TORCH_CHECK_VALUE(
      attn_shape_ok(c, dim_head) && attn_heads_ok(c, heads) &&
          qkv_w.dim() == 2 && qkv_w.size(0) == 3 * heads * dim_head &&
          qkv_w.size(1) == c && h % ph == 0 && w % pw == 0 &&
          ph * pw <= kMaxTokens && b != 0,
      "block_attention: x [B, H, W, C] with (C, dim_head) in ",
      attn_shapes_str(), ", qkv [3 heads dim_head, C] with (C, heads) in ",
      attn_heads_str(), ", H and W multiples of the partition, ph * pw <= ",
      kMaxTokens, "; got ", shape_str(x), ", qkv ", shape_str(qkv_w),
      ", dim_head ", dim_head, ", partition (", ph, ", ", pw, ")");
  Tensor o = x.new_empty({b, h, w, heads * dim_head});
  int plan[2] = {0, 0};
  check("leod_block_attention",
        leod_block_attention(x.data_ptr(), o.data_ptr(), ptr(norm_w),
                             ptr(norm_b), qkv_w.data_ptr(), ptr(qkv_b), b, h,
                             w, c, dim_head, heads, ph, pw, grid_kind, eps,
                             cluster, num_sms(x), plan, stream(x)));
  record(kAttention, {plan[0], plan[1]});
  return o;
}

Tensor mlp_cuda(const Tensor& x, const Tensor& o, const Tensor& proj_w,
                const OptTensor& proj_b, const OptTensor& ls1,
                const Tensor& norm_w, const Tensor& norm_b,
                const Tensor& in_w, const OptTensor& in_b,
                const Tensor& out_w, const OptTensor& out_b,
                const OptTensor& ls2, c10::string_view act, bool gated,
                double eps, int64_t cluster) {
  const int act_id = act_code(act);
  require_cuda("block_mlp", x, {&o, &proj_w, opt(proj_b), opt(ls1), &norm_w,
                                &norm_b, &in_w, opt(in_b), &out_w, opt(out_b),
                                opt(ls2)});
  const int64_t c = x.size(-1);
  TORCH_CHECK_VALUE(o.sizes() == x.sizes() && kernel_dim_ok(c) &&
                        x.numel() != 0,
                    "block_mlp: x and o [..., C] of one shape, C in ",
                    kernel_dims_str(), "; got ", shape_str(x), ", ",
                    shape_str(o));
  const int64_t rows = x.numel() / c, inner = out_w.size(1);
  Tensor out = at::empty_like(x);
  // the plan: the cluster size, the row tiles, the tiles a cluster split
  // (too few to fill the card: a cluster of CTAs shares each unit's
  // projection columns and hidden chunks), the CTAs
  int plan[4] = {0, 0, 0, 0};
  check("leod_block_mlp",
        leod_block_mlp(x.data_ptr(), o.data_ptr(), out.data_ptr(),
                       proj_w.data_ptr(), ptr(proj_b), ptr(ls1),
                       norm_w.data_ptr(), norm_b.data_ptr(), in_w.data_ptr(),
                       ptr(in_b), out_w.data_ptr(), ptr(out_b), ptr(ls2),
                       rows, c, inner, gated, act_id, eps, cluster,
                       num_sms(x), plan, stream(x)));
  record(kMlp, {plan[0], plan[1], plan[2], plan[3]});
  return out;
}

std::tuple<Tensor, Tensor> mlp_tp_cuda(
    const Tensor& x, const Tensor& a, const OptTensor& proj_b,
    const OptTensor& ls1, const Tensor& norm_w, const Tensor& norm_b,
    const Tensor& in_w, const OptTensor& in_b, const Tensor& out_w,
    c10::string_view act, bool gated, double eps, int64_t cluster) {
  const int act_id = act_code(act);
  require_cuda("block_mlp_tp", x, {opt(proj_b), opt(ls1), &norm_w, &norm_b,
                                   &in_w, opt(in_b), &out_w});
  const int64_t c = x.size(-1), inner = out_w.size(1);
  TORCH_CHECK_VALUE(
      a.sizes() == x.sizes() && a.scalar_type() == at::kFloat &&
          a.is_cuda() && a.is_contiguous() && kernel_dim_ok(c) &&
          x.numel() != 0 && out_w.dim() == 2 && out_w.size(0) == c &&
          in_w.size(0) == inner * (gated ? 2 : 1) && inner % 32 == 0,
      "block_mlp_tp: x [..., C] bf16 and a [..., C] fp32 of one shape, C in ",
      kernel_dims_str(), ", this rank's inner units a multiple of 32; got ",
      shape_str(x), ", ", shape_str(a), " ", dtype_str(a), ", proj_out ",
      shape_str(out_w));
  const int64_t rows = x.numel() / c;
  Tensor x1 = at::empty_like(x);
  Tensor p = at::empty_like(a);
  int plan[4] = {0, 0, 0, 0};   // as block_mlp's
  check("leod_block_mlp_tp",
        leod_block_mlp_tp(x.data_ptr(), a.data_ptr(), x1.data_ptr(),
                          p.data_ptr(), ptr(proj_b), ptr(ls1),
                          norm_w.data_ptr(), norm_b.data_ptr(),
                          in_w.data_ptr(), ptr(in_b), out_w.data_ptr(), rows,
                          c, inner, gated, act_id, eps, cluster, num_sms(x),
                          plan, stream(x)));
  record(kMlpTp, {plan[0], plan[1], plan[2], plan[3]});
  return {x1, p};
}

Tensor residual_cuda(const Tensor& x1, const Tensor& p,
                     const OptTensor& out_b, const OptTensor& ls2) {
  require_cuda("block_residual", x1, {opt(out_b), opt(ls2)});
  const int64_t c = x1.size(-1);
  TORCH_CHECK_VALUE(p.sizes() == x1.sizes() && p.scalar_type() == at::kFloat &&
                        p.is_cuda() && p.is_contiguous() && c % 8 == 0 &&
                        x1.numel() != 0,
                    "block_residual: x1 [..., C] bf16 and p [..., C] fp32 of "
                    "one shape, C a multiple of 8; got ", shape_str(x1), ", ",
                    shape_str(p), " ", dtype_str(p));
  Tensor out = at::empty_like(x1);
  check("leod_block_residual",
        leod_block_residual(x1.data_ptr(), p.data_ptr(), ptr(out_b), ptr(ls2),
                            out.data_ptr(), x1.numel() / c, c, stream(x1)));
  record(kResidual, {});
  return out;
}

std::tuple<Tensor, Tensor> lstm_cuda(const Tensor& x, const Tensor& h_prev_in,
                                     const Tensor& c_prev,
                                     const Tensor& weight, const Tensor& bias,
                                     int64_t cluster) {
  Tensor h_prev = h_prev_in.to(x.scalar_type()).contiguous();
  Tensor w = weight.view({weight.size(0), -1});                // [4C, 2C]
  require_cuda("lstm_update", x, {&h_prev, &w, &bias});
  TORCH_CHECK_VALUE((c_prev.scalar_type() == at::kBFloat16 ||
                     c_prev.scalar_type() == at::kFloat) &&
                        c_prev.is_contiguous() &&
                        c_prev.device() == x.device(),
                    "lstm_update: c_prev must be a contiguous bf16 or fp32 "
                    "tensor on x's device");
  TORCH_CHECK_VALUE(c_prev.sizes() == x.sizes() && h_prev.sizes() == x.sizes(),
                    "lstm_update: x, h_prev and c_prev must share a shape");
  const int64_t c = x.size(-1);
  TORCH_CHECK_VALUE(kernel_dim_ok(c) && x.numel() != 0,
                    "lstm_update: x [..., C] with C in ", kernel_dims_str(),
                    "; got ", shape_str(x));
  Tensor h_out = at::empty_like(x);
  Tensor c_out = at::empty_like(c_prev);
  int plan[3] = {0, 0, 0};
  check("leod_lstm_update",
        leod_lstm_update(x.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
                         w.data_ptr(), bias.data_ptr(), h_out.data_ptr(),
                         c_out.data_ptr(), x.numel() / c, c,
                         c_prev.scalar_type() == at::kFloat, cluster,
                         num_sms(x), plan, stream(x)));
  record(kLstm, {plan[0], plan[1], plan[2]});
  return {h_out, c_out};
}

Tensor nms_cuda(const Tensor& boxes_in, double iou_threshold,
                const Tensor& valid_in, const OptTensor& ids_in) {
  const bool squeeze = boxes_in.dim() == 2;
  Tensor boxes_xyxy = squeeze ? boxes_in.unsqueeze(0) : boxes_in;
  Tensor valid = squeeze ? valid_in.unsqueeze(0) : valid_in;
  OptTensor class_ids = ids_in;
  if (squeeze && class_ids.has_value()) class_ids = class_ids->unsqueeze(0);
  TORCH_CHECK_VALUE(boxes_xyxy.dim() == 3 && boxes_xyxy.size(2) == 4,
                    "nms_mask: boxes [B, K, 4] or [K, 4], got ",
                    shape_str(boxes_in));
  TORCH_CHECK_VALUE(boxes_xyxy.is_cuda(), "nms_mask: boxes on ",
                    boxes_xyxy.device(), "; the kernel runs on CUDA and the "
                    "plain version on the CPU");
  const int64_t bsz = boxes_xyxy.size(0), k = boxes_xyxy.size(1);
  TORCH_CHECK_VALUE(1 <= k && k <= kMaxK, "nms_mask: the CUDA kernel takes 1..",
                    kMaxK, " boxes an image, got ", k);
  Tensor boxes = boxes_xyxy.to(at::kFloat).contiguous();
  if (reinterpret_cast<uintptr_t>(boxes.data_ptr()) % 16)
    boxes = boxes.clone();       // the kernel reads a box as one float4
  Tensor valid_u8 = valid.to(at::kByte).contiguous();
  OptTensor ids;
  if (class_ids.has_value()) ids = class_ids->to(at::kFloat).contiguous();
  for (const Tensor* t : std::initializer_list<const Tensor*>{&valid_u8,
                                                            opt(ids)})
    TORCH_CHECK_VALUE(t == nullptr ||
                          (t->device() == boxes.device() && t->dim() == 2 &&
                           t->size(0) == bsz && t->size(1) == k),
                      "nms_mask: valid/class_ids must be [B, K] on the boxes' "
                      "device");
  Tensor keep = at::empty({bsz, k}, boxes.options().dtype(at::kByte));
  // the kernels' scratch: the suppression bitmask, ceil(K/32) words a row
  // in rows of 32 (the sweep's bulk copies move whole rows), written and
  // read only on and above the diagonal
  Tensor mask = at::empty({bsz, k, 32}, boxes.options().dtype(at::kInt));
  check("leod_nms_mask",
        leod_nms_mask(boxes.data_ptr(), valid_u8.data_ptr(), ptr(ids),
                      static_cast<float>(iou_threshold), bsz, k,
                      mask.data_ptr(), keep.data_ptr(), stream(boxes)));
  record(kNms, {});
  Tensor out = keep.to(at::kBool);
  return squeeze ? out.squeeze(0) : out;
}
#endif  // LEOD_WITH_CUDA

}  // namespace

TORCH_LIBRARY(leod_tpu_torch, m) {
  // the schemas exported graphs name, letter for letter
  m.def("block_attention(Tensor x, Tensor? norm_weight, Tensor? norm_bias, "
        "Tensor qkv_weight, Tensor? qkv_bias, int dim_head, int ph, int pw, "
        "bool grid_kind, float eps, int cluster) -> Tensor");
  m.def("block_mlp(Tensor x, Tensor o, Tensor proj_weight, Tensor? proj_bias, "
        "Tensor? ls1, Tensor norm_weight, Tensor norm_bias, Tensor in_weight, "
        "Tensor? in_bias, Tensor out_weight, Tensor? out_bias, Tensor? ls2, "
        "str act, bool gated, float eps, int cluster) -> Tensor");
  m.def("block_mlp_tp(Tensor x, Tensor a, Tensor? proj_bias, Tensor? ls1, "
        "Tensor norm_weight, Tensor norm_bias, Tensor in_weight, "
        "Tensor? in_bias, Tensor out_weight, str act, bool gated, float eps, "
        "int cluster) -> (Tensor, Tensor)");
  m.def("block_residual(Tensor x1, Tensor p, Tensor? out_bias, Tensor? ls2) "
        "-> Tensor");
  m.def("lstm_update(Tensor x, Tensor h_prev, Tensor c_prev, Tensor weight, "
        "Tensor bias, int cluster) -> (Tensor, Tensor)");
  m.def("nms_mask(Tensor boxes, float iou_threshold, Tensor valid, "
        "Tensor? class_ids) -> Tensor");
  // the library's identity and its counters
  m.def("build_info() -> str", &build_info);
  m.def("launch_counts() -> str", &launch_counts);
  m.def("set_launch_count(str op, int count) -> ()", &set_launch_count);
  m.def("last_plan(str op) -> int[]", &last_plan);
}

TORCH_LIBRARY_IMPL(leod_tpu_torch, CPU, m) {
  m.impl("block_attention", &attention_cpu);
  m.impl("block_mlp", &mlp_cpu);
  m.impl("block_mlp_tp", &mlp_tp_cpu);
  m.impl("block_residual", &residual_cpu);
  m.impl("lstm_update", &lstm_cpu);
  m.impl("nms_mask", &nms_cpu);
}

TORCH_LIBRARY_IMPL(leod_tpu_torch, Meta, m) {
  m.impl("block_attention", &attention_meta);
  m.impl("block_mlp", &mlp_meta);
  m.impl("block_mlp_tp", &mlp_tp_meta);
  m.impl("block_residual", &residual_meta);
  m.impl("lstm_update", &lstm_meta);
  m.impl("nms_mask", &nms_meta);
}

#ifdef LEOD_WITH_CUDA
TORCH_LIBRARY_IMPL(leod_tpu_torch, CUDA, m) {
  m.impl("block_attention", &attention_cuda);
  m.impl("block_mlp", &mlp_cuda);
  m.impl("block_mlp_tp", &mlp_tp_cuda);
  m.impl("block_residual", &residual_cuda);
  m.impl("lstm_update", &lstm_cuda);
  m.impl("nms_mask", &nms_cuda);
}
#endif
