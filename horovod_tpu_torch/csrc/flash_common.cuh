// Helpers shared by the flash-attention kernels: the fp32 CUDA-core
// kernels (flash_fwd.cu, flash_bwd.cu) take the tile shape and the fp32
// tile loads; the wgmma kernels (through flash_sm90.cuh) take the
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
constexpr int kThreads = 128;   // 4 warps
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

// fp32 tiles: rows padded by one float
template <int D>
struct F32Tile {
  static constexpr int kStride = D + 1;
  static constexpr int kElems = kBlock * kStride;
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int rows, int tid) {
  constexpr int kStride = F32Tile<D>::kStride;
  for (int i = tid; i < kBlock * D; i += kThreads) {
    int r = i / D;
    int c = i % D;
    int gr = row0 + r;
    dst[r * kStride + c] = gr < rows ? src[static_cast<size_t>(gr) * D + c] : 0.f;
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
