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
                                     int bh, int sq, int sk, int d, int dtype,
                                     int variant, int causal, float scale2,
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

namespace {

int kernel_dtype(const torch::Tensor& t, const char* what) {
  if (t.scalar_type() == torch::kFloat32) return 0;
  if (t.scalar_type() == torch::kBFloat16) return 1;
  TORCH_CHECK(false, what, ": dtype must be float32 or bfloat16");
  return -1;
}

}  // namespace

// q/k/v [b*h, s, d] contiguous, out like q, lse [b*h, sq] fp32; the Python
// wrapper (ops/flash_attention.py) allocates the outputs and checks
// shapes, dtypes and alignment before calling.
void flash_fwd(const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& v, torch::Tensor& out, torch::Tensor& lse,
               int64_t variant, bool causal, double scale2) {
  TORCH_CHECK(q.is_cuda() && k.is_cuda() && v.is_cuda() && out.is_cuda() &&
                  lse.is_cuda(),
              "flash_fwd: every tensor must be on a CUDA device");
  TORCH_CHECK(q.is_contiguous() && k.is_contiguous() && v.is_contiguous() &&
                  out.is_contiguous() && lse.is_contiguous(),
              "flash_fwd: tensors must be contiguous");
  TORCH_CHECK(q.dim() == 3 && k.sizes() == v.sizes() && q.sizes() == out.sizes(),
              "flash_fwd: q/k/v/out must be [b*h, s, d] with k and v alike");
  TORCH_CHECK(lse.scalar_type() == torch::kFloat32, "flash_fwd: lse must be fp32");
  int dtype = kernel_dtype(q, "flash_fwd");
  const c10::cuda::CUDAGuard guard(q.device());
  cudaError_t err = hvd_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      lse.data_ptr<float>(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), dtype, static_cast<int>(variant),
      causal ? 1 : 0, static_cast<float>(scale2),
      at::cuda::getCurrentCUDAStream(q.device().index()).stream());
  TORCH_CHECK(err == cudaSuccess, "flash_fwd: kernel configuration failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
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

void flash_bwd_dq(const torch::Tensor& q, const torch::Tensor& k,
                  const torch::Tensor& v, const torch::Tensor& dout,
                  const torch::Tensor& lse, const torch::Tensor& delta,
                  torch::Tensor& dq, bool causal, double scale2,
                  double scale) {
  check_bwd("flash_bwd_dq", {q, k, v, dout, lse, delta, dq}, q, k, lse,
            delta);
  TORCH_CHECK(v.sizes() == k.sizes() && dout.sizes() == q.sizes() &&
                  dq.sizes() == q.sizes(),
              "flash_bwd_dq: v like k, dout and dq like q");
  int dtype = kernel_dtype(q, "flash_bwd_dq");
  for (const auto& t : {k, v, dout, dq})
    TORCH_CHECK(t.scalar_type() == q.scalar_type(),
                "flash_bwd_dq: q, k, v, dout and dq must share a dtype");
  const c10::cuda::CUDAGuard guard(q.device());
  cudaError_t err = hvd_flash_bwd_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)), dtype,
      causal ? 1 : 0, static_cast<float>(scale2), static_cast<float>(scale),
      at::cuda::getCurrentCUDAStream(q.device().index()).stream());
  TORCH_CHECK(err == cudaSuccess,
              "flash_bwd_dq: kernel configuration failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_bwd_dkv(const torch::Tensor& q, const torch::Tensor& k,
                   const torch::Tensor& v, const torch::Tensor& dout,
                   const torch::Tensor& lse, const torch::Tensor& delta,
                   torch::Tensor& dk, torch::Tensor& dv, bool causal,
                   double scale2, double scale) {
  check_bwd("flash_bwd_dkv", {q, k, v, dout, lse, delta, dk, dv}, q, k, lse,
            delta);
  TORCH_CHECK(v.sizes() == k.sizes() && dout.sizes() == q.sizes() &&
                  dk.sizes() == k.sizes() && dv.sizes() == k.sizes(),
              "flash_bwd_dkv: v, dk and dv like k, dout like q");
  int dtype = kernel_dtype(q, "flash_bwd_dkv");
  for (const auto& t : {k, v, dout, dk, dv})
    TORCH_CHECK(t.scalar_type() == q.scalar_type(),
                "flash_bwd_dkv: q, k, v, dout, dk and dv must share a dtype");
  const c10::cuda::CUDAGuard guard(q.device());
  cudaError_t err = hvd_flash_bwd_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(),
      dv.data_ptr(), static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), dtype, causal ? 1 : 0,
      static_cast<float>(scale2), static_cast<float>(scale),
      at::cuda::getCurrentCUDAStream(q.device().index()).stream());
  TORCH_CHECK(err == cudaSuccess,
              "flash_bwd_dkv: kernel configuration failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd,
        "Flash-attention forward (online/lazy/twopass) for sm_90a");
  m.def("flash_bwd_dq", &flash_bwd_dq,
        "Flash-attention backward, dq, for sm_90a");
  m.def("flash_bwd_dkv", &flash_bwd_dkv,
        "Flash-attention backward, dk and dv, for sm_90a");
}
