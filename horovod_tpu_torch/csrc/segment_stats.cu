// Per-slice gradient-health statistics of a fused buffer for Hopper
// (sm_90a): the numerics plane's one pass over an allreduce bucket.
//
// Replaces no Pallas kernel: the JAX package's segment_stats
// (horovod_tpu/utils/numerics.py:228) is one compiled XLA pass per slice
// layout, and this kernel is the port's counterpart of that one pass. Its
// plain version is segment_stats_plain in horovod_tpu_torch/utils/
// numerics.py, which the CPU runs and the tests and chip_smoke.py hold it
// against.
//
// Contract: x is a contiguous buffer of fp32, bf16 or fp16, read in its
// own dtype; the slices of the layout lie end to end in it. For each slice
// the output row (float32, the S_* columns of numerics.py) is
//   0  L2 norm of the finite values
//   1  max |value| over the finite values (0 for an empty slice)
//   2  count of NaN and +-inf values
//   3  count of exact zeros (either sign) times 1/size (size 1 when empty)
//   4  sum of the finite values
// The layout comes from the host once per (sizes, element size), cached on
// the card: chunk_starts[c] is the first element of chunk c and
// chunk_starts[n_chunks] the buffer's end, so chunk c is [chunk_starts[c],
// chunk_starts[c + 1]); every chunk lies inside one slice, a slice of n
// elements being ceil(n / chunk) chunks of `chunk` elements, its last one
// shorter; slice_first[i] .. slice_first[i + 1] are slice i's chunks (none
// for an empty slice).
//
// Design. Two launches and no atomics:
//   1. seg_partial_kernel: one CTA of 256 threads per chunk (64 KB of the
//      buffer), each thread reading 16-byte vectors of neighbouring
//      elements (a scalar head and tail where the chunk's ends are not
//      16-byte aligned) and keeping the sums in float64, the max in float32
//      and the counts in integers; the CTA reduces its threads in a fixed
//      tree and writes the chunk's five float64 partials.
//   2. seg_final_kernel: one warp per slice sums its chunks' partials,
//      lane by lane in chunk order and then in a fixed butterfly, and
//      writes the slice's row.
// The order of every sum depends on the layout only, so two ranks that
// hold the same bytes get the same rows bit for bit, which the digest's
// 6-digit rounding (numerics.py _round) needs; float64 accumulation keeps
// the sums within float32 rounding of the exact ones at any slice size.
//
// What bounds it: the buffer read once (4 or 2 bytes an element) against
// a few operations an element: memory bound. The flagship's 607.6 MB of
// fp32 gradients take at least 0.181 ms at 3.35 TB/s. Scratch is the
// partials alone: 40 bytes per 64 KB chunk (0.37 MB for 607.6 MB).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStats = 5;

// element loads in the buffer's own dtype, widened to fp32 (by the bit
// patterns: the build forbids the implicit half and bf16 conversions)
struct F32 {
  using T = float;
  static __device__ __forceinline__ float get(const T* p, long long i) {
    return p[i];
  }
  // the four fp32 values of one 16-byte vector
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

struct BF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float get(const T* p, long long i) {
    return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
  }
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

struct F16 {
  using T = uint16_t;
  static __device__ __forceinline__ float get(const T* p, long long i) {
    return __half2float(__ushort_as_half(p[i]));
  }
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[j] & 0xffffu)));
      f[2 * j + 1] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[j] >> 16)));
    }
  }
};

// one thread's running statistics
struct Acc {
  double sum = 0.0;
  double sumsq = 0.0;
  float max_abs = 0.f;
  int nonfinite = 0;
  int zeros = 0;

  __device__ __forceinline__ void add(float f) {
    const bool finite = isfinite(f);
    const float g = finite ? f : 0.f;
    const double d = static_cast<double>(g);
    sum += d;
    sumsq = fma(d, d, sumsq);
    max_abs = fmaxf(max_abs, fabsf(g));
    nonfinite += finite ? 0 : 1;
    zeros += f == 0.f ? 1 : 0;
  }

  // the warp's statistics in every lane, by a fixed butterfly
  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
      max_abs = fmaxf(max_abs, __shfl_xor_sync(0xffffffffu, max_abs, o));
      nonfinite += __shfl_xor_sync(0xffffffffu, nonfinite, o);
      zeros += __shfl_xor_sync(0xffffffffu, zeros, o);
    }
  }
};

template <typename E>
__global__ void __launch_bounds__(kThreads)
seg_partial_kernel(const typename E::T* __restrict__ x,
                   const long long* __restrict__ chunk_starts,
                   double* __restrict__ part) {
  const int c = blockIdx.x;
  const long long s = chunk_starts[c];
  const long long e = chunk_starts[c + 1];
  const int tid = threadIdx.x;
  Acc acc;
  // the scalar head up to the first 16-byte boundary, the vectors, the
  // scalar tail
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x + s);
  long long head = static_cast<long long>((16u - (addr & 15u)) & 15u) /
                   static_cast<long long>(sizeof(typename E::T));
  if (head > e - s) head = e - s;
  const long long v0 = s + head;
  const long long n_vec = (e - v0) / E::kVec;
  const long long tail0 = v0 + n_vec * E::kVec;
  if (tid < head) acc.add(E::get(x, s + tid));
  if (tid < e - tail0) acc.add(E::get(x, tail0 + tid));
  const uint4* vec = reinterpret_cast<const uint4*>(x + v0);
#pragma unroll 4
  for (long long i = tid; i < n_vec; i += kThreads) {
    const uint4 u = __ldg(vec + i);
    float f[8];
    E::unpack(u, f);
#pragma unroll
    for (int j = 0; j < E::kVec; ++j) acc.add(f[j]);
  }
  acc.warp_reduce();
  __shared__ double s_sum[kWarps], s_sumsq[kWarps];
  __shared__ float s_max[kWarps];
  __shared__ int s_nonfinite[kWarps], s_zeros[kWarps];
  const int warp = tid / 32;
  if (tid % 32 == 0) {
    s_sum[warp] = acc.sum;
    s_sumsq[warp] = acc.sumsq;
    s_max[warp] = acc.max_abs;
    s_nonfinite[warp] = acc.nonfinite;
    s_zeros[warp] = acc.zeros;
  }
  __syncthreads();
  if (tid == 0) {
    Acc t;
    for (int w = 0; w < kWarps; ++w) {
      t.sum += s_sum[w];
      t.sumsq += s_sumsq[w];
      t.max_abs = fmaxf(t.max_abs, s_max[w]);
      t.nonfinite += s_nonfinite[w];
      t.zeros += s_zeros[w];
    }
    double* out = part + static_cast<long long>(c) * kStats;
    out[0] = t.sumsq;
    out[1] = t.max_abs;
    out[2] = t.nonfinite;
    out[3] = t.zeros;
    out[4] = t.sum;
  }
}

__global__ void __launch_bounds__(kThreads)
seg_final_kernel(const long long* __restrict__ chunk_starts,
                 const int* __restrict__ slice_first,
                 const double* __restrict__ part, int n_slices,
                 float* __restrict__ out) {
  const int slice = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slice >= n_slices) return;
  const int c0 = slice_first[slice];
  const int c1 = slice_first[slice + 1];
  double sumsq = 0.0, max_abs = 0.0, nonfinite = 0.0, zeros = 0.0,
         sum = 0.0;
  for (int c = c0 + lane; c < c1; c += 32) {
    const double* p = part + static_cast<long long>(c) * kStats;
    sumsq += p[0];
    max_abs = fmax(max_abs, p[1]);
    nonfinite += p[2];
    zeros += p[3];
    sum += p[4];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
    max_abs = fmax(max_abs, __shfl_xor_sync(0xffffffffu, max_abs, o));
    nonfinite += __shfl_xor_sync(0xffffffffu, nonfinite, o);
    zeros += __shfl_xor_sync(0xffffffffu, zeros, o);
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  }
  if (lane == 0) {
    const long long size = c1 > c0 ? chunk_starts[c1] - chunk_starts[c0] : 0;
    // the plain version's zero fraction: the count times the float32
    // reciprocal of the size
    const float inv = static_cast<float>(
        1.0 / static_cast<double>(size > 0 ? size : 1));
    float* row = out + static_cast<long long>(slice) * kStats;
    row[0] = static_cast<float>(sqrt(sumsq));
    row[1] = static_cast<float>(max_abs);
    row[2] = static_cast<float>(nonfinite);
    row[3] = static_cast<float>(zeros) * inv;
    row[4] = static_cast<float>(sum);
  }
}

}  // namespace

// Plain C entry point (no PyTorch headers here: they stay in bindings.cpp).
// dtype: 0 fp32, 1 bf16, 2 fp16. x is the buffer; chunk_starts
// [n_chunks + 1] int64 and slice_first [n_slices + 1] int32 the cached
// layout; part [n_chunks * 5] float64 scratch and out [n_slices * 5]
// float32, allocated by the caller. Returns the first launch error.
extern "C" cudaError_t hvd_segment_stats(const void* x, int dtype,
                                         const long long* chunk_starts,
                                         int n_chunks, const int* slice_first,
                                         int n_slices, double* part,
                                         float* out, cudaStream_t stream) {
  if (n_chunks < 0 || n_slices <= 0 || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  if (n_chunks > 0) {
    if (dtype == 0)
      seg_partial_kernel<F32><<<n_chunks, kThreads, 0, stream>>>(
          static_cast<const float*>(x), chunk_starts, part);
    else if (dtype == 1)
      seg_partial_kernel<BF16><<<n_chunks, kThreads, 0, stream>>>(
          static_cast<const uint16_t*>(x), chunk_starts, part);
    else
      seg_partial_kernel<F16><<<n_chunks, kThreads, 0, stream>>>(
          static_cast<const uint16_t*>(x), chunk_starts, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  seg_final_kernel<<<(n_slices + kWarps - 1) / kWarps, kThreads, 0,
                     stream>>>(chunk_starts, slice_first, part, n_slices,
                               out);
  return cudaGetLastError();
}
