// Hopper (sm_90a) building blocks shared by the wgmma/TMA flash-attention
// kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu): mbarriers, TMA loads of
// 3-D [b*h, s, d] bf16 tensor maps, setmaxnreg, shared-memory matrix
// descriptors, and the two wgmma shapes the kernels use:
//   WgmmaSS<N>: D[64 x N] (+)= A[64 x 16] B[N x 16]^T, A and B K-major in
//               shared memory (Q K^T, dO V^T, K Q^T, V dO^T);
//   WgmmaRS<N>: D[64 x N] += A[64 x 16] B[16 x N], A in registers (the
//               mma.sync A fragment of each warp's 16 rows: accumulators of
//               an earlier product rounded to bf16), B in shared memory with
//               N contiguous, hence the B-transpose bit (P V, dS K, P^T dO,
//               dS^T Q).
//
// Accumulator layout of wgmma.m64nN (f32), thread lane = 4g + t of warp w
// in its warpgroup: d[4j + e] = D[16w + g + 8(e >> 1)][8j + 2t + (e & 1)],
// the mma.sync C layout per 8 columns, so the accumulators of columns
// 16kk..16kk+15 are, rounded to bf16, the A fragment of k-step kk of a
// WgmmaRS product along those columns.
//
// Shared-memory tiles are stored as TMA writes them: a row of D bf16 is
// kHalves boxes of kBoxCols columns, one swizzle span (kSwBytes) each, so
// a tile of R rows is [kHalves][R][kSwBytes] bytes (128 B swizzle for
// D >= 64, d = 128 as two boxes; 64 B at D = 32; 32 B at D = 16).

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached
                    // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

// swizzle span, box and descriptor layout of a bf16 tile with head dim D
template <int D>
struct Swz {
  static constexpr int kSwBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kBoxCols = kSwBytes / 2;
  static constexpr int kHalves = D * 2 / kSwBytes;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr int kLayout = kSwBytes == 128 ? 1 : kSwBytes == 64 ? 2 : 3;
  static constexpr int kStepsPerBox = kSwBytes / 32;   // 16-column k-steps
  static constexpr uint32_t kSbo = 8 * kSwBytes;       // next 8 rows
};

// ---------------------------------------------------------------------------
// barriers, TMA, register allocation

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// box at (c0 = column, c1 = row, c2 = b*h) of a 3-D tensor map into shared
// memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// rows [row, row + R) of head bh of a tile map, every box of D columns,
// into a [kHalves][R][kSwBytes] tile
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int bh) {
  using S = Swz<D>;
#pragma unroll
  for (int h = 0; h < S::kHalves; ++h)
    tma_load(dst + h * R * S::kSwBytes, map, bar, h * S::kBoxCols, row, bh);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 2^x on the SFU, subnormal results flushed to 0 (exp2f adds a range
// fix-up around the same instruction)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type; base offset 0, as
// every tile starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// K-major operand (D contiguous) of a [kHalves][R][kSwBytes] tile: rows
// from `row0` on, k-step kk (16 columns) 32 bytes into its box
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  using S = Swz<D>;
  return gmma_desc(tile + (kk / S::kStepsPerBox) * R * S::kSwBytes +
                       row0 * S::kSwBytes + (kk % S::kStepsPerBox) * 32,
                   16, S::kSbo, S::kLayout);
}

// MN-major operand (D contiguous, rows along K) of the same tile: k-step
// kk is 16 rows down; the next box of D columns is the leading byte
// offset away
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using S = Swz<D>;
  return gmma_desc(tile + kk * 16 * S::kSwBytes, R * S::kSwBytes, S::kSbo,
                   S::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from touching a wgmma operand register between the
// asynchronous instruction and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define HVD_R0_7 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HVD_R0_15 HVD_R0_7 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HVD_R0_31 \
  HVD_R0_15 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
            "%24, %25, %26, %27, %28, %29, %30, %31"
#define HVD_R0_63 \
  HVD_R0_31 ", %32, %33, %34, %35, %36, %37, %38, %39, " \
            "%40, %41, %42, %43, %44, %45, %46, %47, " \
            "%48, %49, %50, %51, %52, %53, %54, %55, " \
            "%56, %57, %58, %59, %60, %61, %62, %63"
#define HVD_F8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x N] (+)= A[64 x 16] B[N x 16]^T, both K-major in shared memory;
// accumulate = 0 overwrites D
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" HVD_R0_63 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HVD_F8(d, 0), HVD_F8(d, 8), HVD_F8(d, 16), HVD_F8(d, 24),
          HVD_F8(d, 32), HVD_F8(d, 40), HVD_F8(d, 48), HVD_F8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" HVD_R0_31 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HVD_F8(d, 0), HVD_F8(d, 8), HVD_F8(d, 16), HVD_F8(d, 24)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// D[64 x N] += A[64 x 16] B[16 x N]: A in registers, B MN-major in shared
// memory (the B-transpose bit)
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" HVD_R0_63 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HVD_F8(d, 0), HVD_F8(d, 8), HVD_F8(d, 16), HVD_F8(d, 24),
          HVD_F8(d, 32), HVD_F8(d, 40), HVD_F8(d, 48), HVD_F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" HVD_R0_31 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HVD_F8(d, 0), HVD_F8(d, 8), HVD_F8(d, 16), HVD_F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" HVD_R0_15 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : HVD_F8(d, 0), HVD_F8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{" HVD_R0_7 "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : HVD_F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// the A fragments of a WgmmaRS product from the accumulators of an
// m64nN product (N / 16 k-steps), rounded to bf16
template <int KS>
__device__ __forceinline__ void acc_to_frags(uint32_t (&a)[KS][4],
                                             const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_f2(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_f2(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_f2(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_f2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// 3-D map over a contiguous bf16 [bh, s, D]: boxes of kBoxCols x box_rows
// of one head, rows past s zero-filled
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int s, int bh,
                     int box_rows) {
  using S = Swz<D>;
  EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(S::kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      S::kSwBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : S::kSwBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
