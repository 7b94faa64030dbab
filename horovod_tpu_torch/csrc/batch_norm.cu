// BatchNorm statistics for Hopper (sm_90a): the two per-channel column
// reductions of horovod_tpu/ops/batch_norm.py, written for the card.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/batch_norm.py:
//   moments  -> _moments1_kernel   (sum x, sum x*x; the BN forward)
//   moments2 -> _moments2_kernel   (sum a, sum a*b with a = dy, b = x; the
//                                   BN backward)
//
// Contract (same as the TPU kernels): the input is a row-major [rows, C]
// matrix, the NHWC activations flattened over every leading axis; x (and
// a, b, which share one dtype) is fp32 or bf16; both outputs are fp32 [C],
// accumulated in fp32. Any rows >= 0 and any C >= 1 work; rows = 0 gives
// zeros.
//
// Design. The TPU kernel walks row blocks in sequence on one core and
// accumulates into one VMEM-resident [1, C] output. On the card blocks run
// in parallel in no order, so the reduction takes two passes:
//   1. bn_partial_kernel: a 2-D grid of CTAs of 256 threads. blockIdx.x
//      picks a tile of channels, blockIdx.y a chunk of rows. The threads of
//      a CTA form tx_count lanes along C (each lane VEC neighbouring
//      channels, read as one 16-byte load where C and the pointers allow)
//      by 256 / tx_count rows; a warp thus reads whole contiguous row
//      segments. Each thread sums its rows of the chunk in fp32 registers,
//      four loads in flight, then the CTA sums its rows' partials through
//      shared memory in a fixed order and writes one [C] slice of the fp32
//      partials [2, n_chunks, C].
//   2. bn_finalize_kernel: one CTA per 8 channels sums the n_chunks
//      partials of each channel, 32 groups of chunks per channel and then
//      the groups in a fixed order.
// No atomics anywhere: the order of every sum depends on the shape only,
// so results are deterministic, as the flash kernels' are.
//
// What bounds it: reading the input once (2 or 4 bytes per element, one
// or two inputs) against one or two additions and one product per
// element: ~0.5-1.5 operations per byte, far below the H100's ridge, so
// HBM bandwidth (3.35 TB/s) is the bound. The largest call of a
// ResNet-50 step at batch 32 (bn_init, 401408 x 64 bf16, 51.4 MB) takes
// at least 15.3 us. The chunk count targets about four CTAs per SM so that
// enough 16-byte loads are in flight to cover HBM latency; the partials
// are a few hundred KB at most, read back from L2 by the second kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;               // 16 bytes of bf16
constexpr int kTargetCtas = 132 * 4;     // about four CTAs per SM
constexpr long long kMinRowsPerChunk = 256;
constexpr int kMaxChunks = 1024;
constexpr int kFinLanes = 8;             // channels per finalize CTA
constexpr int kFinGroups = kThreads / kFinLanes;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// NIN = 1: acc0 += x, acc1 += x*x (moments). NIN = 2: acc0 += a,
// acc1 += a*b (moments2). Partials go to part[which][blockIdx.y][c].
template <typename T, int VEC, int NIN>
__global__ void __launch_bounds__(kThreads)
bn_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ part, long long rows, int C,
                  int tx_count, long long rows_per_chunk) {
  __shared__ float smem[2 * kThreads * kMaxVec];
  const int tid = threadIdx.x;
  const int tx = tid % tx_count;
  const int ty = tid / tx_count;
  const int ty_count = kThreads / tx_count;
  const int width = tx_count * VEC;  // channels of this CTA's tile
  const int c0 = blockIdx.x * width + tx * VEC;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r_end =
      r_begin + rows_per_chunk < rows ? r_begin + rows_per_chunk : rows;

  float acc0[VEC], acc1[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc0[v] = acc1[v] = 0.f;

  // C is a multiple of VEC, so a lane's VEC channels are all in range or
  // all out of it
  if (c0 < C) {
    const long long step = ty_count;
    long long r = r_begin + ty;
    for (; r + 3 * step < r_end; r += 4 * step) {
      Pack<T, VEC> pa[4], pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t off = static_cast<size_t>(r + u * step) * C + c0;
        pa[u] = load_pack<T, VEC>(a + off);
        if (NIN == 2) pb[u] = load_pack<T, VEC>(b + off);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float x = to_f32(pa[u].v[v]);
          const float y = NIN == 2 ? to_f32(pb[u].v[v]) : x;
          acc0[v] += x;
          acc1[v] += x * y;
        }
      }
    }
    for (; r < r_end; r += step) {
      const size_t off = static_cast<size_t>(r) * C + c0;
      const Pack<T, VEC> pa = load_pack<T, VEC>(a + off);
      Pack<T, VEC> pb;
      if (NIN == 2) pb = load_pack<T, VEC>(b + off);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float x = to_f32(pa.v[v]);
        const float y = NIN == 2 ? to_f32(pb.v[v]) : x;
        acc0[v] += x;
        acc1[v] += x * y;
      }
    }
  }

  // the CTA's rows, summed per channel in the order ty = 0, 1, ...
  float* s0 = smem;
  float* s1 = smem + ty_count * width;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s0[ty * width + tx * VEC + v] = acc0[v];
    s1[ty * width + tx * VEC + v] = acc1[v];
  }
  __syncthreads();
  for (int j = tid; j < 2 * width; j += kThreads) {
    const int which = j / width;
    const int col = j - which * width;
    const int c = blockIdx.x * width + col;
    if (c >= C) continue;
    const float* src = which ? s1 : s0;
    float sum = 0.f;
    for (int y = 0; y < ty_count; ++y) sum += src[y * width + col];
    part[(static_cast<size_t>(which) * gridDim.y + blockIdx.y) * C + c] = sum;
  }
}

// out0[c] = sum_k part[0][k][c], out1[c] = sum_k part[1][k][c]: 32 groups
// of chunks per channel (k = g, g + 32, ...), then the groups in order.
__global__ void __launch_bounds__(kThreads)
bn_finalize_kernel(const float* __restrict__ part, float* __restrict__ out0,
                   float* __restrict__ out1, int n_chunks, int C) {
  __shared__ float sm[2][kFinGroups][kFinLanes];
  const int tid = threadIdx.x;
  const int lane = tid % kFinLanes;
  const int g = tid / kFinLanes;
  const int c = blockIdx.x * kFinLanes + lane;
  float a0 = 0.f, a1 = 0.f;
  if (c < C) {
    for (int k = g; k < n_chunks; k += kFinGroups) {
      a0 += part[static_cast<size_t>(k) * C + c];
      a1 += part[static_cast<size_t>(n_chunks + k) * C + c];
    }
  }
  sm[0][g][lane] = a0;
  sm[1][g][lane] = a1;
  __syncthreads();
  if (tid < 2 * kFinLanes) {
    const int which = tid / kFinLanes;
    const int l = tid % kFinLanes;
    const int cc = blockIdx.x * kFinLanes + l;
    if (cc < C) {
      float sum = 0.f;
      for (int gg = 0; gg < kFinGroups; ++gg) sum += sm[which][gg][l];
      (which ? out1 : out0)[cc] = sum;
    }
  }
}

int chunks_for(long long rows, int C) {
  // a grid of about kTargetCtas CTAs, counting 256-channel tiles, with at
  // least kMinRowsPerChunk rows per chunk
  const long long tiles = (C + 255) / 256;
  long long n = (kTargetCtas + tiles - 1) / tiles;
  const long long cap = (rows + kMinRowsPerChunk - 1) / kMinRowsPerChunk;
  if (n > cap) n = cap;
  if (n > kMaxChunks) n = kMaxChunks;
  return n < 1 ? 1 : static_cast<int>(n);
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* a, const void* b, float* out0, float* out1,
                       float* part, long long rows, int C, bool two,
                       cudaStream_t stream) {
  int lanes = (C + VEC - 1) / VEC;
  int tx_count = 1;
  while (tx_count < lanes && tx_count < 32) tx_count *= 2;
  const int width = tx_count * VEC;
  const int n_chunks = chunks_for(rows, C);
  const long long rows_per_chunk = (rows + n_chunks - 1) / n_chunks;
  dim3 grid((C + width - 1) / width, n_chunks);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (two)
    bn_partial_kernel<T, VEC, 2><<<grid, kThreads, 0, stream>>>(
        ta, tb, part, rows, C, tx_count, rows_per_chunk);
  else
    bn_partial_kernel<T, VEC, 1><<<grid, kThreads, 0, stream>>>(
        ta, ta, part, rows, C, tx_count, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finalize_kernel<<<(C + kFinLanes - 1) / kFinLanes, kThreads, 0,
                       stream>>>(part, out0, out1, n_chunks, C);
  return cudaGetLastError();
}

// the widest load (16 bytes at most) that C and both pointers allow
int pick_vec(const void* a, const void* b, int C, int elem) {
  int vec = 16 / elem;
  while (vec > 1 &&
         (C % vec || reinterpret_cast<uintptr_t>(a) % (vec * elem) ||
          reinterpret_cast<uintptr_t>(b) % (vec * elem)))
    vec /= 2;
  return vec;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, float* out0, float* out1,
                   float* part, long long rows, int C, bool two,
                   cudaStream_t stream) {
  const int vec = pick_vec(a, b, C, sizeof(T));
  if constexpr (sizeof(T) == 2) {
    if (vec == 8)
      return launch_vec<T, 8>(a, b, out0, out1, part, rows, C, two, stream);
  }
  if (vec == 4)
    return launch_vec<T, 4>(a, b, out0, out1, part, rows, C, two, stream);
  if (vec == 2)
    return launch_vec<T, 2>(a, b, out0, out1, part, rows, C, two, stream);
  return launch_vec<T, 1>(a, b, out0, out1, part, rows, C, two, stream);
}

}  // namespace

// Floats of scratch the partials of a [rows, C] reduction need.
extern "C" long long hvd_bn_moments_scratch(long long rows, int c) {
  return 2LL * chunks_for(rows, c) * c;
}

// moments (two = 0: out0 = sum a, out1 = sum a*a) or moments2 (two = 1:
// out0 = sum a, out1 = sum a*b) of row-major [rows, c] inputs; dtype 0 is
// fp32, 1 bf16; `part` holds hvd_bn_moments_scratch(rows, c) floats. The
// launches are checked here; a fault during the run surfaces at the next
// synchronisation.
extern "C" cudaError_t hvd_bn_moments(const void* a, const void* b,
                                      float* out0, float* out1, float* part,
                                      long long rows, int c, int dtype,
                                      int two, cudaStream_t stream) {
  if (rows < 0 || c <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (!two) b = a;
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, out0, out1, part, rows, c, two != 0,
                                 stream);
  return launch<float>(a, b, out0, out1, part, rows, c, two != 0, stream);
}
