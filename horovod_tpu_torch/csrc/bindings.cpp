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
  int dtype;
  if (q.scalar_type() == torch::kFloat32) {
    dtype = 0;
  } else if (q.scalar_type() == torch::kBFloat16) {
    dtype = 1;
  } else {
    TORCH_CHECK(false, "flash_fwd: dtype must be float32 or bfloat16");
  }
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

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd,
        "Flash-attention forward (online/lazy/twopass) for sm_90a");
}
