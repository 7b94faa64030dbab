// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu and, for the constants, bf16 packing, quad reductions and
// the shared-memory opt-in, the wgmma kernels through flash_sm90.cuh): the
// tile shape, cp.async copies into shared memory, mma.sync m16n8k16 bf16
// fragments, quad reductions over a fragment row, and the once-per-device
// dynamic shared-memory opt-in.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4*g + t):
//   A 16x16 row-major: a0 = A[g][2t,2t+1]   a1 = A[g+8][2t,2t+1]
//                      a2 = A[g][2t+8,+9]   a3 = A[g+8][2t+8,+9]
//   B 16x8 (k x n):    b0 = B[2t,2t+1][g]   b1 = B[2t+8,+9][g]
//   C 16x8:            c0,c1 = C[g][2t,2t+1]   c2,c3 = C[g+8][2t,2t+1]
// so the accumulators of two neighbouring n-tiles of a product are, once
// rounded to bf16, the A fragment of the next product along those 16
// columns: the logits never leave registers.

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from shared memory, the first in the low half
__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// two fp32 rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D[16x8] += A[16x16] * B[16x8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// bf16 tiles in shared memory: kBlock rows of D values, rows padded by 8
// bf16 so that the 8 rows a fragment load touches fall in 8 distinct
// bank groups
template <int D>
struct Bf16Tile {
  static constexpr int kStride = D + 8;
  static constexpr int kElems = kBlock * kStride;
};

// rows [row0, row0 + kBlock) of a row-major [rows, D] bf16 matrix into a
// padded tile; rows past the end are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int rows, int tid) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int kStride = Bf16Tile<D>::kStride;
  for (int c = tid; c < kBlock * kChunks; c += kThreads) {
    int r = c / kChunks;
    int col = (c % kChunks) * 8;
    int gr = row0 + r;
    bool ok = gr < rows;
    cp_async16(dst + r * kStride + col,
               src + static_cast<size_t>(ok ? gr : 0) * D + col, ok);
  }
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
