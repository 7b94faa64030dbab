// PyTorch binding of the hand-written CUDA kernels. The only source that
// includes PyTorch's headers: the kernels in *.cu keep a plain C
// interface so that nvcc never parses the torch headers.

#include <torch/extension.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <cuda_runtime.h>

extern "C" cudaError_t hvd_flash_fwd(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int bh, int sq, int sk, int d,
                                     int dtype, int variant, int causal,
                                     float scale2, cudaStream_t stream);
extern "C" cudaError_t hvd_flash_fwd_sm90(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int bh, int sq, int sk, int d,
                                          int variant, int causal,
                                          float scale2, int cta_rows,
                                          cudaStream_t stream);
extern "C" cudaError_t hvd_flash_fwd_sm90_dyn(const void* q, const void* k,
                                              const void* v, void* o,
                                              float* lse, int bh, int sq,
                                              int sk, int d, int variant,
                                              int causal, float scale2,
                                              int cta_rows,
                                              cudaStream_t stream);
extern "C" cudaError_t hvd_flash_bwd_dq(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dq, int bh, int sq, int sk,
                                        int d, int dtype, int causal,
                                        float scale2, float scale,
                                        cudaStream_t stream);
extern "C" cudaError_t hvd_flash_bwd_dkv(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse, const float* delta,
                                         void* dk, void* dv, int bh, int sq,
                                         int sk, int d, int dtype, int causal,
                                         float scale2, float scale,
                                         cudaStream_t stream);
extern "C" cudaError_t hvd_flash_bwd_sm90_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
    int d, int causal, float scale2, float scale, int cta_rows,
    cudaStream_t stream);
extern "C" cudaError_t hvd_flash_bwd_sm90_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int bh, int sq,
    int sk, int d, int causal, float scale2, float scale,
    cudaStream_t stream);
extern "C" cudaError_t hvd_flash_fwd_dyn(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         float* ws, int bh, int sq, int sk,
                                         int d, int dtype, int variant,
                                         int causal, float scale2,
                                         cudaStream_t stream);
extern "C" cudaError_t hvd_flash_bwd_dyn_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, float* ws, int bh,
    int sq, int sk, int d, int dtype, int causal, float scale2, float scale,
    cudaStream_t stream);
extern "C" cudaError_t hvd_flash_bwd_dyn_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, float* ws,
    int bh, int sq, int sk, int d, int dtype, int causal, float scale2,
    float scale, cudaStream_t stream);
extern "C" long long hvd_bn_moments_scratch(long long rows, int c);
extern "C" cudaError_t hvd_bn_moments(const void* a, const void* b,
                                      float* out0, float* out1, float* part,
                                      long long rows, int c, int dtype,
                                      int two, cudaStream_t stream);
extern "C" cudaError_t hvd_segment_stats(const void* x, int dtype,
                                         const long long* chunk_starts,
                                         int n_chunks, const int* slice_first,
                                         int n_slices, double* part,
                                         float* out, cudaStream_t stream);

namespace {

int kernel_dtype(const torch::Tensor& t, const char* what) {
  if (t.scalar_type() == torch::kFloat32) return 0;
  if (t.scalar_type() == torch::kBFloat16) return 1;
  TORCH_CHECK(false, what, ": dtype must be float32 or bfloat16");
  return -1;
}

}  // namespace

void check_launch(const char* which, cudaError_t err) {
  TORCH_CHECK(err == cudaSuccess, which, ": kernel configuration failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

cudaStream_t stream_of(const torch::Tensor& t) {
  return at::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

// q/k/v [b*h, s, d] contiguous, out like q, lse [b*h, sq] fp32; the Python
// wrapper (ops/flash_attention.py) allocates the outputs and checks
// shapes, dtypes and alignment before calling.
void check_fwd(const char* which, const torch::Tensor& q,
               const torch::Tensor& k, const torch::Tensor& v,
               const torch::Tensor& out, const torch::Tensor& lse) {
  for (const auto& t : {q, k, v, out, lse}) {
    TORCH_CHECK(t.is_cuda() && t.is_contiguous(), which,
                ": every tensor must be contiguous on a CUDA device");
    TORCH_CHECK(t.device() == q.device(), which,
                ": every tensor must be on q's device");
  }
  TORCH_CHECK(q.dim() == 3 && k.sizes() == v.sizes() && q.sizes() == out.sizes(),
              which, ": q/k/v/out must be [b*h, s, d] with k and v alike");
  TORCH_CHECK(lse.scalar_type() == torch::kFloat32, which,
              ": lse must be fp32");
}

// The fp32 forward (variant 0 online, 1 lazy, 2 twopass) on the CUDA cores
// (flash_fwd.cu) at every compiled head dim; bf16 runs on flash_fwd_sm90.
void flash_fwd(const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& v, torch::Tensor& out, torch::Tensor& lse,
               int64_t variant, bool causal, double scale2) {
  check_fwd("flash_fwd", q, k, v, out, lse);
  for (const auto& t : {q, k, v, out})
    TORCH_CHECK(t.scalar_type() == torch::kFloat32,
                "flash_fwd: q, k, v and out must be float32");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_fwd", hvd_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      lse.data_ptr<float>(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), 0, static_cast<int>(variant),
      causal ? 1 : 0, static_cast<float>(scale2), stream_of(q)));
}

// The bf16 forward (variant 0 online, 1 lazy, 2 twopass) on wgmma and TMA
// (flash_fwd_sm90.cu) at d 16-256, with cta_rows (64 or 128) query rows per
// CTA.
void flash_fwd_sm90(const torch::Tensor& q, const torch::Tensor& k,
                    const torch::Tensor& v, torch::Tensor& out,
                    torch::Tensor& lse, int64_t variant, bool causal,
                    double scale2, int64_t cta_rows) {
  check_fwd("flash_fwd_sm90", q, k, v, out, lse);
  for (const auto& t : {q, k, v, out})
    TORCH_CHECK(t.scalar_type() == torch::kBFloat16,
                "flash_fwd_sm90: q, k, v and out must be bfloat16");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_fwd_sm90", hvd_flash_fwd_sm90(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      lse.data_ptr<float>(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), static_cast<int>(variant),
      causal ? 1 : 0, static_cast<float>(scale2),
      static_cast<int>(cta_rows), stream_of(q)));
}

// The bf16 forward (variant 0 online, 1 lazy, 2 twopass) on wgmma and TMA
// at a run-time head dim above 256 (flash_fwd_sm90_dyn.cu: d <= 1024, a
// multiple of 8), with cta_rows (64 or 128) query rows per CTA.
void flash_fwd_sm90_dyn(const torch::Tensor& q, const torch::Tensor& k,
                        const torch::Tensor& v, torch::Tensor& out,
                        torch::Tensor& lse, int64_t variant, bool causal,
                        double scale2, int64_t cta_rows) {
  check_fwd("flash_fwd_sm90_dyn", q, k, v, out, lse);
  for (const auto& t : {q, k, v, out})
    TORCH_CHECK(t.scalar_type() == torch::kBFloat16,
                "flash_fwd_sm90_dyn: q, k, v and out must be bfloat16");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_fwd_sm90_dyn", hvd_flash_fwd_sm90_dyn(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      lse.data_ptr<float>(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), static_cast<int>(variant),
      causal ? 1 : 0, static_cast<float>(scale2),
      static_cast<int>(cta_rows), stream_of(q)));
}

// The backward of one attention: q, k, v, dO [b*h, s, d] contiguous in
// one dtype; lse and delta = rowsum(dO * O) fp32 [b*h, sq]; the gradients
// are allocated like their inputs by the Python wrapper, which also checks
// shapes and alignment. `which` names the entry point in errors.
void check_bwd(const char* which, std::initializer_list<torch::Tensor> ts,
               const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& lse, const torch::Tensor& delta) {
  for (const auto& t : ts) {
    TORCH_CHECK(t.is_cuda() && t.is_contiguous(), which,
                ": every tensor must be contiguous on a CUDA device");
    TORCH_CHECK(t.device() == q.device(), which,
                ": every tensor must be on q's device");
  }
  TORCH_CHECK(q.dim() == 3 && k.dim() == 3 && q.size(0) == k.size(0) &&
                  q.size(2) == k.size(2),
              which, ": q and k must be [b*h, s, d] alike");
  TORCH_CHECK(lse.scalar_type() == torch::kFloat32 &&
                  delta.scalar_type() == torch::kFloat32,
              which, ": lse and delta must be fp32");
  TORCH_CHECK(lse.dim() == 2 && lse.size(0) == q.size(0) &&
                  lse.size(1) == q.size(1) && delta.sizes() == lse.sizes(),
              which, ": lse and delta must be [b*h, sq]");
}

// Every backward operand in one dtype: fp32 for the CUDA-core kernels
// (flash_bwd.cu), bf16 for the wgmma/TMA ones (flash_bwd_sm90.cu).
void check_dtype(const char* which, std::initializer_list<torch::Tensor> ts,
                 torch::ScalarType dtype) {
  for (const auto& t : ts)
    TORCH_CHECK(t.scalar_type() == dtype, which,
                ": q, k, v, dout and the gradients must be ", dtype);
}

void check_dq(const char* which, const torch::Tensor& q,
              const torch::Tensor& k, const torch::Tensor& v,
              const torch::Tensor& dout, const torch::Tensor& lse,
              const torch::Tensor& delta, const torch::Tensor& dq,
              torch::ScalarType dtype) {
  check_bwd(which, {q, k, v, dout, lse, delta, dq}, q, k, lse, delta);
  TORCH_CHECK(v.sizes() == k.sizes() && dout.sizes() == q.sizes() &&
                  dq.sizes() == q.sizes(),
              which, ": v like k, dout and dq like q");
  check_dtype(which, {q, k, v, dout, dq}, dtype);
}

void check_dkv(const char* which, const torch::Tensor& q,
               const torch::Tensor& k, const torch::Tensor& v,
               const torch::Tensor& dout, const torch::Tensor& lse,
               const torch::Tensor& delta, const torch::Tensor& dk,
               const torch::Tensor& dv, torch::ScalarType dtype) {
  check_bwd(which, {q, k, v, dout, lse, delta, dk, dv}, q, k, lse, delta);
  TORCH_CHECK(v.sizes() == k.sizes() && dout.sizes() == q.sizes() &&
                  dk.sizes() == k.sizes() && dv.sizes() == k.sizes(),
              which, ": v, dk and dv like k, dout like q");
  check_dtype(which, {q, k, v, dout, dk, dv}, dtype);
}

// dq on the CUDA cores: fp32 at every compiled head dim (bf16 runs on
// flash_bwd_sm90)
void flash_bwd_dq(const torch::Tensor& q, const torch::Tensor& k,
                  const torch::Tensor& v, const torch::Tensor& dout,
                  const torch::Tensor& lse, const torch::Tensor& delta,
                  torch::Tensor& dq, bool causal, double scale2,
                  double scale) {
  check_dq("flash_bwd_dq", q, k, v, dout, lse, delta, dq, torch::kFloat32);
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_bwd_dq", hvd_flash_bwd_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)), 0,
      causal ? 1 : 0, static_cast<float>(scale2), static_cast<float>(scale),
      stream_of(q)));
}

// dk and dv on the CUDA cores: fp32 at every compiled head dim (bf16 runs
// on flash_bwd_sm90)
void flash_bwd_dkv(const torch::Tensor& q, const torch::Tensor& k,
                   const torch::Tensor& v, const torch::Tensor& dout,
                   const torch::Tensor& lse, const torch::Tensor& delta,
                   torch::Tensor& dk, torch::Tensor& dv, bool causal,
                   double scale2, double scale) {
  check_dkv("flash_bwd_dkv", q, k, v, dout, lse, delta, dk, dv,
            torch::kFloat32);
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_bwd_dkv", hvd_flash_bwd_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(),
      dv.data_ptr(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), 0, causal ? 1 : 0,
      static_cast<float>(scale2), static_cast<float>(scale), stream_of(q)));
}

// bf16 dq on wgmma and TMA, with cta_rows (64 or 128) query rows per CTA
void flash_bwd_sm90_dq(const torch::Tensor& q, const torch::Tensor& k,
                       const torch::Tensor& v, const torch::Tensor& dout,
                       const torch::Tensor& lse, const torch::Tensor& delta,
                       torch::Tensor& dq, bool causal, double scale2,
                       double scale, int64_t cta_rows) {
  check_dq("flash_bwd_sm90_dq", q, k, v, dout, lse, delta, dq,
           torch::kBFloat16);
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_bwd_sm90_dq", hvd_flash_bwd_sm90_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)),
      causal ? 1 : 0, static_cast<float>(scale2), static_cast<float>(scale),
      static_cast<int>(cta_rows), stream_of(q)));
}

// bf16 dk and dv on wgmma and TMA
void flash_bwd_sm90_dkv(const torch::Tensor& q, const torch::Tensor& k,
                        const torch::Tensor& v, const torch::Tensor& dout,
                        const torch::Tensor& lse, const torch::Tensor& delta,
                        torch::Tensor& dk, torch::Tensor& dv, bool causal,
                        double scale2, double scale) {
  check_dkv("flash_bwd_sm90_dkv", q, k, v, dout, lse, delta, dk, dv,
            torch::kBFloat16);
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_bwd_sm90_dkv", hvd_flash_bwd_sm90_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(),
      dv.data_ptr(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), causal ? 1 : 0,
      static_cast<float>(scale2), static_cast<float>(scale), stream_of(q)));
}

// The fp32 workspace of a run-time-d kernel (flash_dyn.cu): null when it
// is empty (the accumulators then live in shared memory); the Python
// wrapper sizes it.
float* workspace_of(const char* which, const torch::Tensor& ws,
                    const torch::Tensor& q) {
  if (ws.numel() == 0) return nullptr;
  TORCH_CHECK(ws.is_cuda() && ws.is_contiguous() &&
                  ws.scalar_type() == torch::kFloat32 &&
                  ws.device() == q.device(),
              which, ": the workspace must be contiguous fp32 on q's device");
  return ws.data_ptr<float>();
}

// The forward (variant 0 online, 1 lazy, 2 twopass) at a run-time head dim
// (flash_dyn.cu: d > 256): fp32, and bf16 above 1024 (flash_fwd_sm90_dyn.cu
// takes bf16 up to 1024).
void flash_fwd_dyn(const torch::Tensor& q, const torch::Tensor& k,
                   const torch::Tensor& v, torch::Tensor& out,
                   torch::Tensor& lse, const torch::Tensor& ws,
                   int64_t variant, bool causal, double scale2) {
  check_fwd("flash_fwd_dyn", q, k, v, out, lse);
  int dtype = kernel_dtype(q, "flash_fwd_dyn");
  for (const auto& t : {k, v, out})
    TORCH_CHECK(t.scalar_type() == q.scalar_type(),
                "flash_fwd_dyn: q, k, v and out must share a dtype");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_fwd_dyn", hvd_flash_fwd_dyn(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      lse.data_ptr<float>(), workspace_of("flash_fwd_dyn", ws, q),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)), dtype,
      static_cast<int>(variant), causal ? 1 : 0, static_cast<float>(scale2),
      stream_of(q)));
}

// dq at a run-time head dim (flash_dyn.cu), fp32 or bf16
void flash_bwd_dyn_dq(const torch::Tensor& q, const torch::Tensor& k,
                      const torch::Tensor& v, const torch::Tensor& dout,
                      const torch::Tensor& lse, const torch::Tensor& delta,
                      torch::Tensor& dq, const torch::Tensor& ws, bool causal,
                      double scale2, double scale) {
  int dtype = kernel_dtype(q, "flash_bwd_dyn_dq");
  check_dq("flash_bwd_dyn_dq", q, k, v, dout, lse, delta, dq,
           q.scalar_type());
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_bwd_dyn_dq", hvd_flash_bwd_dyn_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
      workspace_of("flash_bwd_dyn_dq", ws, q), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), dtype, causal ? 1 : 0,
      static_cast<float>(scale2), static_cast<float>(scale), stream_of(q)));
}

// dk and dv at a run-time head dim (flash_dyn.cu), fp32 or bf16
void flash_bwd_dyn_dkv(const torch::Tensor& q, const torch::Tensor& k,
                       const torch::Tensor& v, const torch::Tensor& dout,
                       const torch::Tensor& lse, const torch::Tensor& delta,
                       torch::Tensor& dk, torch::Tensor& dv,
                       const torch::Tensor& ws, bool causal, double scale2,
                       double scale) {
  int dtype = kernel_dtype(q, "flash_bwd_dyn_dkv");
  check_dkv("flash_bwd_dyn_dkv", q, k, v, dout, lse, delta, dk, dv,
            q.scalar_type());
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch("flash_bwd_dyn_dkv", hvd_flash_bwd_dyn_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(),
      dv.data_ptr(), workspace_of("flash_bwd_dyn_dkv", ws, q),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)), dtype,
      causal ? 1 : 0, static_cast<float>(scale2), static_cast<float>(scale),
      stream_of(q)));
}

// BatchNorm statistics of row-major [rows, C] inputs in one dtype: out0 =
// sum a and out1 = sum a*a (two = false, b ignored) or sum a*b (two =
// true), fp32 [C], allocated by the Python wrapper (ops/batch_norm.py),
// which also checks shapes and contiguity; the partials' scratch is
// allocated here.
void bn_moments(const torch::Tensor& a, const torch::Tensor& b,
                torch::Tensor& out0, torch::Tensor& out1, bool two) {
  for (const auto& t : {a, b, out0, out1}) {
    TORCH_CHECK(t.is_cuda() && t.is_contiguous(),
                "bn_moments: every tensor must be contiguous on a CUDA device");
    TORCH_CHECK(t.device() == a.device(),
                "bn_moments: every tensor must be on a's device");
  }
  TORCH_CHECK(a.dim() == 2 && b.sizes() == a.sizes() &&
                  b.scalar_type() == a.scalar_type(),
              "bn_moments: a and b must be [rows, C] alike");
  const int64_t rows = a.size(0), c = a.size(1);
  TORCH_CHECK(c >= 1 && c <= INT32_MAX, "bn_moments: C out of range");
  for (const auto& t : {out0, out1})
    TORCH_CHECK(t.scalar_type() == torch::kFloat32 && t.dim() == 1 &&
                    t.size(0) == c,
                "bn_moments: outputs must be fp32 [C]");
  int dtype = kernel_dtype(a, "bn_moments");
  const c10::cuda::CUDAGuard guard(a.device());
  torch::Tensor part = torch::empty(
      {static_cast<int64_t>(
          hvd_bn_moments_scratch(rows, static_cast<int>(c)))},
      a.options().dtype(torch::kFloat32));
  cudaError_t err = hvd_bn_moments(
      a.data_ptr(), b.data_ptr(), out0.data_ptr<float>(),
      out1.data_ptr<float>(), part.data_ptr<float>(), rows,
      static_cast<int>(c), dtype, two ? 1 : 0,
      at::cuda::getCurrentCUDAStream(a.device().index()).stream());
  TORCH_CHECK(err == cudaSuccess, "bn_moments: kernel launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Per-slice gradient-health statistics of a fused buffer (segment_stats.cu):
// x contiguous fp32, bf16 or fp16; chunk_starts int64 [n_chunks + 1] and
// slice_first int32 [n_slices + 1], the cached layout; part float64
// [n_chunks * 5] scratch and out float32 [n_slices, 5], allocated by the
// Python wrapper (utils/numerics.py).
void segment_stats(const torch::Tensor& x, const torch::Tensor& chunk_starts,
                   const torch::Tensor& slice_first, torch::Tensor& part,
                   torch::Tensor& out) {
  for (const auto& t : {x, chunk_starts, slice_first, part, out}) {
    TORCH_CHECK(t.is_cuda() && t.is_contiguous(),
                "segment_stats: every tensor must be contiguous on a CUDA "
                "device");
    TORCH_CHECK(t.device() == x.device(),
                "segment_stats: every tensor must be on x's device");
  }
  int dtype = -1;
  if (x.scalar_type() == torch::kFloat32) dtype = 0;
  if (x.scalar_type() == torch::kBFloat16) dtype = 1;
  if (x.scalar_type() == torch::kFloat16) dtype = 2;
  TORCH_CHECK(dtype >= 0, "segment_stats: x must be fp32, bf16 or fp16");
  TORCH_CHECK(chunk_starts.scalar_type() == torch::kInt64 &&
                  slice_first.scalar_type() == torch::kInt32,
              "segment_stats: the layout is int64 chunk starts and int32 "
              "slice firsts");
  const int64_t n_chunks = chunk_starts.numel() - 1;
  const int64_t n_slices = slice_first.numel() - 1;
  TORCH_CHECK(n_chunks >= 0 && n_chunks <= INT32_MAX && n_slices >= 1 &&
                  n_slices <= INT32_MAX,
              "segment_stats: layout out of range");
  TORCH_CHECK(part.scalar_type() == torch::kFloat64 &&
                  part.numel() == n_chunks * 5,
              "segment_stats: part must be float64 [n_chunks * 5]");
  TORCH_CHECK(out.scalar_type() == torch::kFloat32 &&
                  out.numel() == n_slices * 5,
              "segment_stats: out must be float32 [n_slices, 5]");
  const c10::cuda::CUDAGuard guard(x.device());
  cudaError_t err = hvd_segment_stats(
      x.data_ptr(), dtype,
      reinterpret_cast<const long long*>(chunk_starts.data_ptr<int64_t>()),
      static_cast<int>(n_chunks), slice_first.data_ptr<int32_t>(),
      static_cast<int>(n_slices), part.data_ptr<double>(),
      out.data_ptr<float>(), stream_of(x));
  TORCH_CHECK(err == cudaSuccess, "segment_stats: kernel launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd,
        "Flash-attention forward, online/lazy/twopass, on the CUDA cores "
        "(fp32)");
  m.def("flash_fwd_sm90", &flash_fwd_sm90,
        "Flash-attention forward, bf16 online/lazy/twopass up to head dim "
        "256, on wgmma and TMA");
  m.def("flash_fwd_sm90_dyn", &flash_fwd_sm90_dyn,
        "Flash-attention forward, bf16 online/lazy/twopass at a run-time "
        "head dim above 256 (up to 1024), on wgmma and TMA");
  m.def("flash_bwd_dq", &flash_bwd_dq,
        "Flash-attention backward, dq, on the CUDA cores (fp32)");
  m.def("flash_bwd_dkv", &flash_bwd_dkv,
        "Flash-attention backward, dk and dv, on the CUDA cores (fp32)");
  m.def("flash_bwd_sm90_dq", &flash_bwd_sm90_dq,
        "Flash-attention backward, dq, bf16 up to head dim 256, on wgmma "
        "and TMA");
  m.def("flash_bwd_sm90_dkv", &flash_bwd_sm90_dkv,
        "Flash-attention backward, dk and dv, bf16 up to head dim 256, on "
        "wgmma and TMA");
  m.def("flash_fwd_dyn", &flash_fwd_dyn,
        "Flash-attention forward, online/lazy/twopass, at a run-time head "
        "dim (d > 256) on the CUDA cores: fp32, and bf16 above 1024");
  m.def("flash_bwd_dyn_dq", &flash_bwd_dyn_dq,
        "Flash-attention backward, dq, at a run-time head dim");
  m.def("flash_bwd_dyn_dkv", &flash_bwd_dyn_dkv,
        "Flash-attention backward, dk and dv, at a run-time head dim");
  m.def("segment_stats", &segment_stats,
        "Per-slice gradient-health statistics of a fused buffer, one pass "
        "and a reduction of its partials, for sm_90a");
  m.def("bn_moments", &bn_moments,
        "BatchNorm statistics (sum, sum of squares or of products) for "
        "sm_90a");
}
