// Flash-attention backward for Hopper (sm_90a), fp32: the two backward
// kernels of horovod_tpu/ops/flash_attention.py on the CUDA cores. bf16
// runs on wgmma and TMA in flash_bwd_sm90.cu.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_bwd), in fp32:
//   dq  -> _dq_kernel    (one CTA per q tile, K/V streamed)
//   dkv -> _dkv_kernel   (one CTA per k tile, Q/dO/lse/delta streamed)
//
// Contract (same as the TPU kernels): q/k/v/dO are [b*h, s, d]
// contiguous; lse is the forward's natural-log row log-sum-exp and delta
// = rowsum(dO * O), both fp32 [b*h, sq] (one row per query, not the
// TPU's 8-sublane replicated layout). Each probability is rebuilt from
// lse as p = exp2(s * scale2 - lse * log2(e)) with the masked logits at
// the finite sentinel -1e30, which makes p exactly 0 there; then
//   ds = p * (dP - delta),  dP = dO V^T
//   dq = scale * sum_k ds K          (dq kernel)
//   dv = sum_q p^T dO,  dk = scale * sum_q ds^T Q   (dkv kernel)
// with the softmax scale applied once after the loop, to dq and dk and
// never to dv. The two-kernel split of the TPU is kept: no atomics, every
// gradient is written once, and the result is deterministic.
//
// Design. 4 warps per CTA over 64-row tiles, in full fp32 (no TF32),
// through p/ds rows in shared memory.
//   dq:  one CTA per (b*h, q tile); Q and dO stay in shared memory; K/V
//        tiles stream, and the causal k loop stops at the diagonal tile.
//   dkv: one CTA per (b*h, k tile); K and V stay in shared memory; Q, dO,
//        lse and delta stream, from the diagonal q tile on for causal
//        attention.
//
// What bounds it: 6*d operations per visible (q, k) pair in dq (three
// products) and 8*d in dkv (four), against q, k, v, dO and lse/delta read
// once and the gradients written once: at 67 TFLOP/s of fp32 the CUDA
// cores are the bound at every shape the port runs.

#include "flash_common.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int sq;
  int sk;
  float scale2;   // softmax scale * log2(e)
  float scale;    // softmax scale, applied to dq and dk after the loop
  int causal;
};

// whether key k_row is visible from query q_row (both in range, and not
// in the future for causal attention)
__device__ __forceinline__ bool visible(const BwdParams& p, int q_row,
                                        int k_row) {
  return q_row < p.sq && k_row < p.sk && (!p.causal || k_row <= q_row);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32. Each pair of threads owns one row of the
// tile the CTA holds (a query row in dq, a key row in dkv): thread `half`
// computes the pair products of the streamed rows half, half+2, ... and
// accumulates the gradient columns [half*D/2, (half+1)*D/2).

constexpr int kPStride = kBlock + 1;

// dq: Q, dO, K, V tiles + the ds tile
template <int D>
struct DqF32Layout {
  static constexpr int kStride = F32Tile<D>::kStride;
  static constexpr int kTile = F32Tile<D>::kElems;
  static constexpr int kSmemBytes = (4 * kTile + kBlock * kPStride) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(BwdParams p) {
  using L = DqF32Layout<D>;
  constexpr int kStride = L::kStride;
  constexpr int kHalfD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + L::kTile;
  float* sK = sDO + L::kTile;
  float* sV = sK + L::kTile;
  float* sS = sV + L::kTile;

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * p.sq * D;
  const size_t k_off = static_cast<size_t>(bh) * p.sk * D;
  const float* k = static_cast<const float*>(p.k) + k_off;
  const float* v = static_cast<const float*>(p.v) + k_off;
  const int row = qi * kBlock + r;
  const size_t stat = static_cast<size_t>(bh) * p.sq + row;
  const float lse2 = row < p.sq ? p.lse[stat] * kLog2e : 0.f;
  const float dlt = row < p.sq ? p.delta[stat] : 0.f;

  load_tile_f32<D>(sQ, static_cast<const float*>(p.q) + q_off, qi * kBlock,
                   p.sq, tid);
  load_tile_f32<D>(sDO, static_cast<const float*>(p.dout) + q_off,
                   qi * kBlock, p.sq, tid);

  float acc[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) acc[i] = 0.f;
  const int nk_total = (p.sk + kBlock - 1) / kBlock;
  const int nk = p.causal ? min(qi + 1, nk_total) : nk_total;
  const float* qrow = sQ + r * kStride;
  const float* dorow = sDO + r * kStride;
  float* srow = sS + r * kPStride;

  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();
    load_tile_f32<D>(sK, k, kb * kBlock, p.sk, tid);
    load_tile_f32<D>(sV, v, kb * kBlock, p.sk, tid);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kBlock / 2; ++c) {
      int j = 2 * c + half;
      const float* krow = sK + j * kStride;
      const float* vrow = sV + j * kStride;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qrow[d], krow[d], s);
        dp = fmaf(dorow[d], vrow[d], dp);
      }
      float sv = visible(p, row, kb * kBlock + j) ? s * p.scale2 : kNegInf;
      srow[j] = exp2f(sv - lse2) * (dp - dlt);
    }
    __syncwarp();
    const float* kcol = sK + half * kHalfD;
    for (int j = 0; j < kBlock; ++j) {
      float ds = srow[j];
      const float* kr = kcol + j * kStride;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }

  if (row < p.sq) {
    float* dq = static_cast<float*>(p.dq) + q_off +
                static_cast<size_t>(row) * D + half * kHalfD;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) dq[i] = acc[i] * p.scale;
  }
}

// dkv: K, V, Q, dO tiles + the p and ds tiles + the lse*log2(e) and
// delta rows
template <int D>
struct DkvF32Layout {
  static constexpr int kStride = F32Tile<D>::kStride;
  static constexpr int kTile = F32Tile<D>::kElems;
  static constexpr int kSmemBytes =
      (4 * kTile + 2 * kBlock * kPStride + 2 * kBlock) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(BwdParams p) {
  using L = DkvF32Layout<D>;
  constexpr int kStride = L::kStride;
  constexpr int kHalfD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + L::kTile;
  float* sQ = sV + L::kTile;
  float* sDO = sQ + L::kTile;
  float* sP = sDO + L::kTile;
  float* sS = sP + kBlock * kPStride;
  float* sL = sS + kBlock * kPStride;
  float* sD = sL + kBlock;

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int ki = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * p.sq * D;
  const size_t k_off = static_cast<size_t>(bh) * p.sk * D;
  const float* q = static_cast<const float*>(p.q) + q_off;
  const float* dout = static_cast<const float*>(p.dout) + q_off;
  const float* lse = p.lse + static_cast<size_t>(bh) * p.sq;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.sq;
  const int krow = ki * kBlock + r;

  load_tile_f32<D>(sK, static_cast<const float*>(p.k) + k_off, ki * kBlock,
                   p.sk, tid);
  load_tile_f32<D>(sV, static_cast<const float*>(p.v) + k_off, ki * kBlock,
                   p.sk, tid);

  float dk[kHalfD], dv[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) dk[i] = dv[i] = 0.f;
  const int nq = (p.sq + kBlock - 1) / kBlock;
  const int qb_start = p.causal ? ki : 0;
  const float* kr = sK + r * kStride;
  const float* vr = sV + r * kStride;
  float* prow = sP + r * kPStride;
  float* srow = sS + r * kPStride;

  for (int qb = qb_start; qb < nq; ++qb) {
    __syncthreads();
    load_tile_f32<D>(sQ, q, qb * kBlock, p.sq, tid);
    load_tile_f32<D>(sDO, dout, qb * kBlock, p.sq, tid);
    {
      int i = tid & (kBlock - 1);
      int row = qb * kBlock + i;
      if (tid < kBlock)
        sL[i] = row < p.sq ? lse[row] * kLog2e : 0.f;
      else
        sD[i] = row < p.sq ? delta[row] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kBlock / 2; ++c) {
      int j = 2 * c + half;
      const float* qr = sQ + j * kStride;
      const float* dr = sDO + j * kStride;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(kr[d], qr[d], s);
        dp = fmaf(vr[d], dr[d], dp);
      }
      float sv = visible(p, qb * kBlock + j, krow) ? s * p.scale2 : kNegInf;
      float pv = exp2f(sv - sL[j]);
      prow[j] = pv;
      srow[j] = pv * (dp - sD[j]);
    }
    __syncwarp();
    for (int j = 0; j < kBlock; ++j) {
      float pj = prow[j];
      float dsj = srow[j];
      const float* dr = sDO + j * kStride + half * kHalfD;
      const float* qr = sQ + j * kStride + half * kHalfD;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) {
        dv[i] = fmaf(pj, dr[i], dv[i]);
        dk[i] = fmaf(dsj, qr[i], dk[i]);
      }
    }
  }

  if (krow < p.sk) {
    size_t i0 = k_off + static_cast<size_t>(krow) * D + half * kHalfD;
    float* gk = static_cast<float*>(p.dk) + i0;
    float* gv = static_cast<float*>(p.dv) + i0;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) {
      gk[i] = dk[i] * p.scale;
      gv[i] = dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch

enum Kind { kDq = 0, kDkv = 1 };

template <int Kd, int D>
cudaError_t launch(int bh, const BwdParams& p, cudaStream_t stream) {
  constexpr int smem =
      Kd == kDq ? DqF32Layout<D>::kSmemBytes : DkvF32Layout<D>::kSmemBytes;
  void (*kernel)(BwdParams) =
      Kd == kDq ? flash_bwd_dq_f32_kernel<D> : flash_bwd_dkv_f32_kernel<D>;
  static std::atomic<uint32_t> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  int rows = Kd == kDq ? p.sq : p.sk;
  dim3 grid((rows + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int Kd>
cudaError_t dispatch(const BwdParams& p, int bh, int d, cudaStream_t stream) {
  if (bh <= 0 || p.sq <= 0 || p.sk <= 0 || bh > 65535)
    return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch<Kd, 16>(bh, p, stream);
    case 32: return launch<Kd, 32>(bh, p, stream);
    case 64: return launch<Kd, 64>(bh, p, stream);
    case 128: return launch<Kd, 128>(bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (no PyTorch headers here: they stay in
// bindings.cpp). fp32 only, for q, k, v, dO, lse, delta and the gradients
// alike (bf16 runs on flash_bwd_sm90.cu). scale2 is the softmax scale
// times log2(e), rounded once by the caller. Each returns a configuration
// error; the launch itself is checked by the caller with cudaGetLastError.
extern "C" cudaError_t hvd_flash_bwd_dq(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        const float* lse, const float* delta,
                                        float* dq, int bh, int sq, int sk,
                                        int d, int causal, float scale2,
                                        float scale, cudaStream_t stream) {
  BwdParams p{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
              sq, sk, scale2, scale, causal};
  return dispatch<kDq>(p, bh, d, stream);
}

extern "C" cudaError_t hvd_flash_bwd_dkv(const float* q, const float* k,
                                         const float* v, const float* dout,
                                         const float* lse, const float* delta,
                                         float* dk, float* dv, int bh, int sq,
                                         int sk, int d, int causal,
                                         float scale2, float scale,
                                         cudaStream_t stream) {
  BwdParams p{q, k, v, dout, lse, delta, nullptr, dk, dv,
              sq, sk, scale2, scale, causal};
  return dispatch<kDkv>(p, bh, d, stream);
}
