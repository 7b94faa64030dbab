// Flash-attention backward for Hopper (sm_90a) on the CUDA cores: the
// two backward kernels of horovod_tpu/ops/flash_attention.py for every
// fp32 call. bf16 up to d 256 runs on wgmma and TMA in flash_bwd_sm90.cu.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_bwd):
//   dq  -> _dq_kernel    (one CTA per q tile, K/V streamed)
//   dkv -> _dkv_kernel   (one CTA per k tile, Q/dO/lse/delta streamed)
//
// Contract (same as the TPU kernels): q/k/v/dO are [b*h, s, d] contiguous
// fp32, the gradients in their dtype; lse is the forward's
// natural-log row log-sum-exp and delta = rowsum(dO * O), both fp32
// [b*h, sq] (one row per query, not the TPU's 8-sublane replicated
// layout). Each probability is rebuilt from lse as
// p = exp2(s * scale2 - lse * log2(e)) with the masked logits at the
// finite sentinel -1e30, which makes p exactly 0 there, as it does for a
// row whose caller-supplied lse is +1e30 (a ring's future pair); then
//   ds = p * (dP - delta),  dP = dO V^T
//   dq = scale * sum_k ds K          (dq kernel)
//   dv = sum_q p^T dO,  dk = scale * sum_q ds^T Q   (dkv kernel)
// with fp32 accumulation (the bf16 kernels round ds and p before their
// products; in fp32 that is a no-op), and the softmax scale applied once
// after the loop, to dq and dk and never to dv. The
// two-kernel split of the TPU is kept: no atomics, every gradient is
// written once, and the result is deterministic.
//
// Design. Full fp32 products (no TF32) on operands held as fp32 in shared
// memory, through p/ds rows in shared memory; TPR threads own one row of
// the tile the CTA holds (a query row in dq, a key row in dkv).
//   dq:  one CTA per (b*h, 64-row q tile); Q and dO stay in shared memory;
//        K/V tiles of KB rows stream, and the causal k loop stops at the
//        diagonal.
//   dkv: one CTA per (b*h, KB-row k tile); K and V stay in shared memory;
//        64-row Q, dO, lse and delta tiles stream, from the first one that
//        can see the k tile on for causal attention.
// KB is 64 up to d 128 and 32 at d 256, where four 64-row fp32 tiles would
// take 263 KB of the 227 KB a block may use: the dq kernel then holds
// 201 KB and the dk/dv kernel 210 KB.
//
// What bounds it: 6*d operations per visible (q, k) pair in dq (three
// products) and 8*d in dkv (four), against q, k, v, dO and lse/delta read
// once and the gradients written once: at 67 TFLOP/s of fp32 the CUDA
// cores are the bound at every shape the port runs. These kernels are on
// no main path: a simple kernel that is right.

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

// keys per k tile, and threads per owned row
template <int D>
constexpr int bwd_kb() { return D > 128 ? 32 : 64; }
template <int D>
constexpr int bwd_tpr() { return D > 128 ? 4 : 2; }

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dq: Q, dO (64 rows), K, V (KB rows) + the ds tile [64, KB]
template <int D, int KB>
struct DqLayout {
  static constexpr int kStride = D + 1;
  static constexpr int kQTile = kBlock * kStride;
  static constexpr int kKTile = KB * kStride;
  static constexpr int kSStride = KB + 1;
  static constexpr int kSmemBytes =
      (2 * kQTile + 2 * kKTile + kBlock * kSStride) * 4;
};

// TPR threads own one query row: thread `part` computes the pair products
// of keys part, part+TPR, ... and accumulates the dq columns
// [part*D/TPR, (part+1)*D/TPR).
template <int D, int KB, int TPR>
__global__ void __launch_bounds__(kBlock * TPR)
flash_bwd_dq_cc_kernel(BwdParams p) {
  using L = DqLayout<D, KB>;
  constexpr int kNT = kBlock * TPR;
  constexpr int kStride = L::kStride;
  constexpr int kCols = D / TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + L::kQTile;
  float* sK = sDO + L::kQTile;
  float* sV = sK + L::kKTile;
  float* sS = sV + L::kKTile;

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int part = tid % TPR;
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

  load_tile<float, D, kBlock, kNT>(
      sQ, static_cast<const float*>(p.q) + q_off, qi * kBlock, p.sq, tid);
  load_tile<float, D, kBlock, kNT>(
      sDO, static_cast<const float*>(p.dout) + q_off, qi * kBlock, p.sq, tid);

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  const int nk_total = (p.sk + KB - 1) / KB;
  // the last k tile holding a key the q tile's last row can see
  const int nk = p.causal ? min(((qi + 1) * kBlock + KB - 1) / KB, nk_total)
                          : nk_total;
  const float* qrow = sQ + r * kStride;
  const float* dorow = sDO + r * kStride;
  float* srow = sS + r * L::kSStride;

  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();
    load_tile<float, D, KB, kNT>(sK, k, kb * KB, p.sk, tid);
    load_tile<float, D, KB, kNT>(sV, v, kb * KB, p.sk, tid);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < KB / TPR; ++c) {
      int j = TPR * c + part;
      const float* krow = sK + j * kStride;
      const float* vrow = sV + j * kStride;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qrow[d], krow[d], s);
        dp = fmaf(dorow[d], vrow[d], dp);
      }
      float sv = visible(p, row, kb * KB + j) ? s * p.scale2 : kNegInf;
      srow[j] = exp2f(sv - lse2) * (dp - dlt);
    }
    __syncwarp();
    const float* kcol = sK + part * kCols;
    for (int j = 0; j < KB; ++j) {
      float ds = srow[j];
      const float* kr = kcol + j * kStride;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
    __syncwarp();
  }

  if (row < p.sq) {
    float* dq = static_cast<float*>(p.dq) + q_off +
                static_cast<size_t>(row) * D + part * kCols;
#pragma unroll
    for (int i = 0; i < kCols; ++i) dq[i] = acc[i] * p.scale;
  }
}

// dkv: K, V (KB rows), Q, dO (64 rows) + the p and ds tiles [KB, 64] + the
// lse*log2(e) and delta rows
template <int D, int KB>
struct DkvLayout {
  static constexpr int kStride = D + 1;
  static constexpr int kQTile = kBlock * kStride;
  static constexpr int kKTile = KB * kStride;
  static constexpr int kPStride = kBlock + 1;
  static constexpr int kSmemBytes =
      (2 * kKTile + 2 * kQTile + 2 * KB * kPStride + 2 * kBlock) * 4;
};

// TPR threads own one key row: thread `part` computes the pair products
// of queries part, part+TPR, ... and accumulates the dk and dv columns
// [part*D/TPR, (part+1)*D/TPR).
template <int D, int KB, int TPR>
__global__ void __launch_bounds__(KB * TPR)
flash_bwd_dkv_cc_kernel(BwdParams p) {
  using L = DkvLayout<D, KB>;
  constexpr int kNT = KB * TPR;
  constexpr int kStride = L::kStride;
  constexpr int kCols = D / TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + L::kKTile;
  float* sQ = sV + L::kKTile;
  float* sDO = sQ + L::kQTile;
  float* sP = sDO + L::kQTile;
  float* sS = sP + KB * L::kPStride;
  float* sL = sS + KB * L::kPStride;
  float* sD = sL + kBlock;

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int part = tid % TPR;
  const int ki = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * p.sq * D;
  const size_t k_off = static_cast<size_t>(bh) * p.sk * D;
  const float* q = static_cast<const float*>(p.q) + q_off;
  const float* dout = static_cast<const float*>(p.dout) + q_off;
  const float* lse = p.lse + static_cast<size_t>(bh) * p.sq;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.sq;
  const int krow = ki * KB + r;

  load_tile<float, D, KB, kNT>(
      sK, static_cast<const float*>(p.k) + k_off, ki * KB, p.sk, tid);
  load_tile<float, D, KB, kNT>(
      sV, static_cast<const float*>(p.v) + k_off, ki * KB, p.sk, tid);

  float dk[kCols], dv[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dk[i] = dv[i] = 0.f;
  const int nq = (p.sq + kBlock - 1) / kBlock;
  // the first q tile whose last row can see this k tile's first key
  const int qb_start = p.causal ? (ki * KB) / kBlock : 0;
  const float* kr = sK + r * kStride;
  const float* vr = sV + r * kStride;
  float* prow = sP + r * L::kPStride;
  float* srow = sS + r * L::kPStride;

  for (int qb = qb_start; qb < nq; ++qb) {
    __syncthreads();
    load_tile<float, D, kBlock, kNT>(sQ, q, qb * kBlock, p.sq, tid);
    load_tile<float, D, kBlock, kNT>(sDO, dout, qb * kBlock, p.sq, tid);
    for (int i = tid; i < 2 * kBlock; i += kNT) {
      int row = qb * kBlock + (i % kBlock);
      if (i < kBlock)
        sL[i] = row < p.sq ? lse[row] * kLog2e : 0.f;
      else
        sD[i - kBlock] = row < p.sq ? delta[row] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kBlock / TPR; ++c) {
      int j = TPR * c + part;
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
      const float* dr = sDO + j * kStride + part * kCols;
      const float* qr = sQ + j * kStride + part * kCols;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        dv[i] = fmaf(pj, dr[i], dv[i]);
        dk[i] = fmaf(dsj, qr[i], dk[i]);
      }
    }
  }

  if (krow < p.sk) {
    size_t i0 = k_off + static_cast<size_t>(krow) * D + part * kCols;
    float* gk = static_cast<float*>(p.dk) + i0;
    float* gv = static_cast<float*>(p.dv) + i0;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
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
  constexpr int kb = bwd_kb<D>();
  constexpr int tpr = bwd_tpr<D>();
  constexpr int smem = Kd == kDq ? DqLayout<D, kb>::kSmemBytes
                                 : DkvLayout<D, kb>::kSmemBytes;
  void (*kernel)(BwdParams) = Kd == kDq
      ? flash_bwd_dq_cc_kernel<D, kb, tpr>
      : flash_bwd_dkv_cc_kernel<D, kb, tpr>;
  static std::atomic<uint32_t> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const int rows = Kd == kDq ? p.sq : p.sk;
  const int tile = Kd == kDq ? kBlock : kb;
  dim3 grid((rows + tile - 1) / tile, bh);
  kernel<<<grid, tile * tpr, smem, stream>>>(p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int Kd>
cudaError_t dispatch(const BwdParams& p, int bh, int d, int dtype,
                     cudaStream_t stream) {
  if (bh <= 0 || p.sq <= 0 || p.sk <= 0 || bh > 65535 || dtype != 0)
    return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch<Kd, 16>(bh, p, stream);
    case 32: return launch<Kd, 32>(bh, p, stream);
    case 64: return launch<Kd, 64>(bh, p, stream);
    case 128: return launch<Kd, 128>(bh, p, stream);
    case 256: return launch<Kd, 256>(bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (no PyTorch headers here: they stay in
// bindings.cpp). dtype 0: fp32 q, k, v, dO and gradients at d
// 16/32/64/128/256 (bf16 runs on flash_bwd_sm90.cu, any other dtype is
// refused); lse and delta are fp32. scale2 is the
// softmax scale times log2(e), rounded once by the caller. Each returns a
// configuration error; the launch itself is checked by the caller with
// cudaGetLastError.
extern "C" cudaError_t hvd_flash_bwd_dq(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dq, int bh, int sq, int sk,
                                        int d, int dtype, int causal,
                                        float scale2, float scale,
                                        cudaStream_t stream) {
  BwdParams p{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
              sq, sk, scale2, scale, causal};
  return dispatch<kDq>(p, bh, d, dtype, stream);
}

extern "C" cudaError_t hvd_flash_bwd_dkv(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse, const float* delta,
                                         void* dk, void* dv, int bh, int sq,
                                         int sk, int d, int dtype, int causal,
                                         float scale2, float scale,
                                         cudaStream_t stream) {
  BwdParams p{q, k, v, dout, lse, delta, nullptr, dk, dv,
              sq, sk, scale2, scale, causal};
  return dispatch<kDkv>(p, bh, d, dtype, stream);
}
