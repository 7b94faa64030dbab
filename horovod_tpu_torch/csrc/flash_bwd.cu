// Flash-attention backward for Hopper (sm_90a): the two backward kernels
// of horovod_tpu/ops/flash_attention.py, written for the card.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_bwd):
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
// Design. 4 warps per CTA, 64-row tiles double-buffered through shared
// memory with cp.async (zero-filled past the sequence end, and masked).
//   dq:  one CTA per (b*h, q tile); each warp owns 16 query rows. Q and
//        dO stay in shared memory; K/V tiles stream, and the causal k
//        loop stops at the diagonal tile.
//   dkv: one CTA per (b*h, k tile); each warp owns 16 key rows. K and V
//        stay in shared memory; Q, dO, lse and delta stream, from the
//        diagonal q tile on for causal attention. The kernel computes the
//        transposed products directly (S^T = K Q^T, dP^T = V dO^T): their
//        accumulators are then, rounded to bf16, the A fragments of
//        p^T dO and ds^T Q, so nothing is transposed through memory.
// bf16 runs every product on the tensor cores with mma.sync m16n8k16 and
// fp32 accumulation; ds is rounded to the input dtype before ds K and
// ds^T Q, and p to dO's dtype before p^T dO, as the TPU kernels do. fp32
// runs on the CUDA cores in full fp32 (no TF32), through p/ds rows in
// shared memory.
//
// What bounds it: 6*d operations per visible (q, k) pair in dq (three
// products) and 8*d in dkv (four), against q, k, v, dO and lse/delta read
// once and the gradients written once. At the training shape (b*h = 96,
// d = 128, causal s = 1024) that is far above the H100's ridge (~295
// operations per byte): the tensor cores are the bound. This first
// version is far from it: mma.sync with fragments loaded from shared
// memory (no ldmatrix, no wgmma/TMA), and one tile of each walk in
// flight at a time.

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

// A fragment (16 rows x 16 columns at column c0) of a padded bf16 tile,
// rows r0..r0+15
template <int kStride>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int c0, int g, int t) {
  const __nv_bfloat16* b = tile + r0 * kStride + c0 + 2 * t;
  a[0] = ld32(b + g * kStride);
  a[1] = ld32(b + (g + 8) * kStride);
  a[2] = ld32(b + g * kStride + 8);
  a[3] = ld32(b + (g + 8) * kStride + 8);
}

// the A fragment of a 16x16 product input from the accumulators of two
// neighbouring 16x8 n-tiles, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* lo,
                                         const float* hi) {
  a[0] = pack_f2(lo[0], lo[1]);
  a[1] = pack_f2(lo[2], lo[3]);
  a[2] = pack_f2(hi[0], hi[1]);
  a[3] = pack_f2(hi[2], hi[3]);
}

// B fragment of rows r0..r0+15 (the k axis) and columns c0..c0+7 (the n
// axis) of a padded row-major bf16 tile: two 16-bit loads per register
template <int kStride>
__device__ __forceinline__ void b_frag_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile,
                                            int r0, int c0, int g, int t) {
  const __nv_bfloat16* b = tile + (r0 + 2 * t) * kStride + c0 + g;
  b0 = pack2(b, b + kStride);
  b1 = pack2(b + 8 * kStride, b + 9 * kStride);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

// dq: Q and dO tiles + two K tiles + two V tiles
template <int D>
struct DqBf16Layout {
  static constexpr int kStride = Bf16Tile<D>::kStride;
  static constexpr int kTile = Bf16Tile<D>::kElems;
  static constexpr int kSmemBytes = 6 * kTile * 2;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(BwdParams p) {
  using L = DqBf16Layout<D>;
  constexpr int kStride = L::kStride;
  constexpr int kDSteps = D / 16;   // k-steps over the head dim
  constexpr int kDTiles = D / 8;    // n-tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + L::kTile;
  __nv_bfloat16* sK = sDO + L::kTile;
  __nv_bfloat16* sV = sK + 2 * L::kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // heaviest (latest) causal q tiles first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * p.sq * D;
  const size_t k_off = static_cast<size_t>(bh) * p.sk * D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + q_off;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + q_off;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + k_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + k_off;

  const int nk_total = (p.sk + kBlock - 1) / kBlock;
  const int nk = p.causal ? min(qi + 1, nk_total) : nk_total;

  load_tile_bf16<D>(sQ, q, qi * kBlock, p.sq, tid);
  load_tile_bf16<D>(sDO, dout, qi * kBlock, p.sq, tid);
  cp_async_commit();
  auto issue = [&](int kb) {
    int buf = kb & 1;
    load_tile_bf16<D>(sK + buf * L::kTile, k, kb * kBlock, p.sk, tid);
    load_tile_bf16<D>(sV + buf * L::kTile, v, kb * kBlock, p.sk, tid);
    cp_async_commit();
  };

  const int row0 = qi * kBlock + warp * 16 + g;   // global q rows row0, row0+8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row0 + 8 * r;
    size_t i = static_cast<size_t>(bh) * p.sq + row;
    lse2[r] = row < p.sq ? p.lse[i] * kLog2e : 0.f;
    dlt[r] = row < p.sq ? p.delta[i] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  issue(0);
  for (int kb = 0; kb < nk; ++kb) {
    if (kb + 1 < nk) {
      issue(kb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tk = sK + (kb & 1) * L::kTile;
    const __nv_bfloat16* tv = sV + (kb & 1) * L::kTile;

    // logits s = Q K^T and dP = dO V^T for this warp's 16 rows: 8 n-tiles
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      uint32_t aq[4], ado[4];
      a_frag<kStride>(aq, sQ, warp * 16, ks * 16, g, t);
      a_frag<kStride>(ado, sDO, warp * 16, ks * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* bk = tk + (nt * 8 + g) * kStride + ks * 16 + 2 * t;
        mma_bf16(s[nt], aq, ld32(bk), ld32(bk + 8));
        const __nv_bfloat16* bv = tv + (nt * 8 + g) * kStride + ks * 16 + 2 * t;
        mma_bf16(dp[nt], ado, ld32(bv), ld32(bv + 8));
      }
    }
    // ds = p * (dP - delta), with p rebuilt from lse; into s
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = e >> 1;
        int col = kb * kBlock + nt * 8 + 2 * t + (e & 1);
        float sv = visible(p, row0 + 8 * r, col) ? s[nt][e] * p.scale2
                                                 : kNegInf;
        float pv = exp2f(sv - lse2[r]);
        s[nt][e] = pv * (dp[nt][e] - dlt[r]);
      }
    }
    // dq += ds @ K, ds rounded to bf16; K read along its rows (the k axis)
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // 16 keys per k-step
      uint32_t a[4];
      acc_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        uint32_t b0, b1;
        b_frag_rows<kStride>(b0, b1, tk, 16 * j, dn * 8, g, t);
        mma_bf16(acc[dn], a, b0, b1);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) + q_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row0 + 8 * r;
    if (row < p.sq) {
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        *reinterpret_cast<uint32_t*>(dq + static_cast<size_t>(row) * D + dn * 8 + 2 * t) =
            pack_f2(acc[dn][2 * r] * p.scale, acc[dn][2 * r + 1] * p.scale);
      }
    }
  }
}

// dkv: K and V tiles + two Q tiles + two dO tiles (bf16), then two rows of
// lse*log2(e) and two of delta (fp32)
template <int D>
struct DkvBf16Layout {
  static constexpr int kStride = Bf16Tile<D>::kStride;
  static constexpr int kTile = Bf16Tile<D>::kElems;
  static constexpr int kSmemBytes = 6 * kTile * 2 + 4 * kBlock * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(BwdParams p) {
  using L = DkvBf16Layout<D>;
  constexpr int kStride = L::kStride;
  constexpr int kDSteps = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + L::kTile;
  __nv_bfloat16* sQ = sV + L::kTile;
  __nv_bfloat16* sDO = sQ + 2 * L::kTile;
  float* sL = reinterpret_cast<float*>(sDO + 2 * L::kTile);
  float* sD = sL + 2 * kBlock;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // causal: the first k tiles see the most q tiles, so they go first
  const int ki = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * p.sq * D;
  const size_t k_off = static_cast<size_t>(bh) * p.sk * D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + q_off;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + q_off;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + k_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + k_off;
  const float* lse = p.lse + static_cast<size_t>(bh) * p.sq;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.sq;

  const int nq = (p.sq + kBlock - 1) / kBlock;
  // first q tile whose last row can see this k tile's first row
  const int qb_start = p.causal ? ki : 0;

  load_tile_bf16<D>(sK, k, ki * kBlock, p.sk, tid);
  load_tile_bf16<D>(sV, v, ki * kBlock, p.sk, tid);
  cp_async_commit();
  auto issue = [&](int qb) {
    int buf = (qb - qb_start) & 1;
    load_tile_bf16<D>(sQ + buf * L::kTile, q, qb * kBlock, p.sq, tid);
    load_tile_bf16<D>(sDO + buf * L::kTile, dout, qb * kBlock, p.sq, tid);
    cp_async_commit();
    int r = tid & (kBlock - 1);
    int row = qb * kBlock + r;
    if (tid < kBlock)
      sL[buf * kBlock + r] = row < p.sq ? lse[row] * kLog2e : 0.f;
    else
      sD[buf * kBlock + r] = row < p.sq ? delta[row] : 0.f;
  };

  const int krow0 = ki * kBlock + warp * 16 + g;   // key rows krow0, krow0+8
  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  if (qb_start < nq) issue(qb_start);
  for (int qb = qb_start; qb < nq; ++qb) {
    if (qb + 1 < nq) {
      issue(qb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = (qb - qb_start) & 1;
    const __nv_bfloat16* tq = sQ + buf * L::kTile;
    const __nv_bfloat16* tdo = sDO + buf * L::kTile;
    const float* lrow = sL + buf * kBlock;
    const float* drow = sD + buf * kBlock;

#pragma unroll 1
    for (int j = 0; j < kBlock / 16; ++j) {   // 16 queries at a time
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys: 2 n-tiles
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        uint32_t ak[4], av[4];
        a_frag<kStride>(ak, sK, warp * 16, ks * 16, g, t);
        a_frag<kStride>(av, sV, warp * 16, ks * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          int qr = 16 * j + nt * 8 + g;
          const __nv_bfloat16* bq = tq + qr * kStride + ks * 16 + 2 * t;
          mma_bf16(st[nt], ak, ld32(bq), ld32(bq + 8));
          const __nv_bfloat16* bd = tdo + qr * kStride + ks * 16 + 2 * t;
          mma_bf16(dpt[nt], av, ld32(bd), ld32(bd + 8));
        }
      }
      // p^T rebuilt from lse, ds^T = p^T * (dP^T - delta)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int qc = 16 * j + nt * 8 + 2 * t + (e & 1);   // query in the tile
          int krow = krow0 + (e >> 1) * 8;
          float sv = visible(p, qb * kBlock + qc, krow) ? st[nt][e] * p.scale2
                                                        : kNegInf;
          float pv = exp2f(sv - lrow[qc]);
          st[nt][e] = pv;
          dpt[nt][e] = pv * (dpt[nt][e] - drow[qc]);
        }
      }
      // dv += p^T dO and dk += ds^T Q over these 16 queries (one k-step)
      uint32_t ap[4], ads[4];
      acc_to_a(ap, st[0], st[1]);
      acc_to_a(ads, dpt[0], dpt[1]);
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        uint32_t b0, b1;
        b_frag_rows<kStride>(b0, b1, tdo, 16 * j, dn * 8, g, t);
        mma_bf16(dv[dn], ap, b0, b1);
        b_frag_rows<kStride>(b0, b1, tq, 16 * j, dn * 8, g, t);
        mma_bf16(dk[dn], ads, b0, b1);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(p.dk) + k_off;
  __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(p.dv) + k_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = krow0 + 8 * r;
    if (row < p.sk) {
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        size_t i = static_cast<size_t>(row) * D + dn * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(gk + i) =
            pack_f2(dk[dn][2 * r] * p.scale, dk[dn][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(gv + i) =
            pack_f2(dv[dn][2 * r], dv[dn][2 * r + 1]);
      }
    }
  }
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

template <int Kd, bool Bf16, int D>
cudaError_t launch(int bh, const BwdParams& p, cudaStream_t stream) {
  constexpr int smem =
      Kd == kDq ? (Bf16 ? DqBf16Layout<D>::kSmemBytes : DqF32Layout<D>::kSmemBytes)
                : (Bf16 ? DkvBf16Layout<D>::kSmemBytes : DkvF32Layout<D>::kSmemBytes);
  void (*kernel)(BwdParams) =
      Kd == kDq ? (Bf16 ? flash_bwd_dq_bf16_kernel<D> : flash_bwd_dq_f32_kernel<D>)
                : (Bf16 ? flash_bwd_dkv_bf16_kernel<D> : flash_bwd_dkv_f32_kernel<D>);
  static std::atomic<uint32_t> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  int rows = Kd == kDq ? p.sq : p.sk;
  dim3 grid((rows + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int Kd>
cudaError_t dispatch(const BwdParams& p, int bh, int d, int dtype,
                     cudaStream_t stream) {
  if (bh <= 0 || p.sq <= 0 || p.sk <= 0 || bh > 65535 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  bool bf16 = dtype == 1;
  switch (d) {
    case 16: return bf16 ? launch<Kd, true, 16>(bh, p, stream) : launch<Kd, false, 16>(bh, p, stream);
    case 32: return bf16 ? launch<Kd, true, 32>(bh, p, stream) : launch<Kd, false, 32>(bh, p, stream);
    case 64: return bf16 ? launch<Kd, true, 64>(bh, p, stream) : launch<Kd, false, 64>(bh, p, stream);
    case 128: return bf16 ? launch<Kd, true, 128>(bh, p, stream) : launch<Kd, false, 128>(bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (no PyTorch headers here: they stay in
// bindings.cpp). dtype: 0 = fp32, 1 = bf16, for q, k, v, dO and the
// gradients alike; lse and delta are fp32. scale2 is the softmax scale
// times log2(e), rounded once by the caller. Each returns a configuration
// error; the launch itself is checked by the caller with cudaGetLastError.
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
