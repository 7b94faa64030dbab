// Helpers shared by the flash-attention kernels: the CUDA-core kernels
// (flash_fwd.cu, flash_bwd.cu) take the tile shape, the conversions of
// their fp32 or bf16 inputs and the tile loads; the wgmma kernels (through flash_sm90.cuh) take the
// constants, bf16 packing and the quad reductions over an accumulator row
// (the four threads 4g .. 4g+3 that hold one row's columns); both take the
// once-per-device dynamic shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBlock = 64;      // rows per q tile and per k tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// two fp32 rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// value conversions of the CUDA-core kernels' input types (fp32 or bf16;
// the intrinsics, since the build forbids implicit bf16 conversions)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T (nearest even) and widened back: what an operand cast to
// the input dtype before a product holds
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// fp32 tiles in shared memory: rows padded by one float
template <int D>
struct F32Tile {
  static constexpr int kStride = D + 1;
  static constexpr int kElems = kBlock * kStride;
};

// ROWS rows of a [rows, D] T matrix from row0 into an fp32 tile, by NT
// threads; rows past the end are zero-filled
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int tid) {
  constexpr int kStride = D + 1;
  for (int i = tid; i < ROWS * D; i += NT) {
    int r = i / D;
    int c = i % D;
    int gr = row0 + r;
    dst[r * kStride + c] =
        gr < rows ? to_f32(src[static_cast<size_t>(gr) * D + c]) : 0.f;
  }
}

// The dynamic shared-memory opt-in is a property of the function on each
// device: it is set at the first launch on a device and not again, so a
// launch costs no extra driver call. One flag word per kernel
// instantiation, a bit per device ordinal.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int smem,
                        std::atomic<uint32_t>& opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (!(opted_in.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace
