// Flash attention at head dims above 256, forward and backward, for
// Hopper (sm_90a) on the CUDA cores, with the head dim d taken at run time.
//
// Replaces, for d > 256, the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py:
//   flash_fwd_dyn_kernel<T, online>   -> _fwd_kernel          (:129)
//   flash_fwd_dyn_kernel<T, lazy>     -> _fwd_kernel_lazy     (:220)
//   flash_fwd_dyn_kernel<T, twopass>  -> _fwd_kernel_twopass  (:312)
//   flash_bwd_dq_dyn_kernel<T>        -> _dq_kernel           (:467)
//   flash_bwd_dkv_dyn_kernel<T>       -> _dkv_kernel          (:531)
// The compile-time-d kernels (flash_fwd.cu, flash_bwd.cu, the wgmma ones)
// keep whole fp32 rows of Q, K and V in shared memory, which stops at
// d 256: one 64-row fp32 Q tile alone is 128 KB at d 512. The bf16
// forward from d 264 to 1024 runs on wgmma and TMA in
// flash_fwd_sm90_dyn.cu; flash_fwd_dyn_kernel takes the fp32 forward at
// every d above 256 and the bf16 one above 1024.
//
// Contract (the other flash kernels'): q/k/v/dO are [b*h, s, d] contiguous
// fp32 or bf16, O and the gradients in their dtype; lse is the natural-log
// row log-sum-exp and delta = rowsum(dO * O), fp32 [b*h, sq]. Logits are
// fp32 products of the input-dtype values in the exp2 domain (log2(e) in
// scale2) with the finite -1e30 mask sentinel; P is rounded to V's dtype
// before P@V while l takes it unrounded, and p and ds are rounded to the
// input dtype before their products in the backward (no-ops in fp32); the
// softmax scale goes on dq and dk once, after the loop. A partial last q
// or k tile is zero-filled on load and masked (col < sk; rows past sq are
// never stored); the causal loops stop at the diagonal; a caller's lse
// (a ring's merged one, +1e30 rows included) is used as given. No
// atomics: every result is written once, by the thread that owns it.
//
// Design. d is walked in chunks of 64 columns. One CTA of 128 threads owns
// 32 rows (query rows in the forward and dq, key rows in dk/dv); 4 threads
// share a row, each computing every 4th pair's product and owning 16
// columns of every chunk. Per streamed 32-row tile:
//   S = sum over chunks of Q_c K_c^T (and dP = dO_c V_c^T), chunk tiles of
//       both operands loaded as fp32 into shared memory, S in registers;
//   then P V_c (ds K_c; p^T dO_c and ds^T Q_c) chunk by chunk into fp32
//       accumulators [32, d] (two in dk/dv).
// The accumulators live in shared memory when they fit the 227 KB a block
// may use (up to d 1653 in the forward and dq, 826 in dk/dv), and otherwise
// in an fp32 workspace in device memory, one private slice per CTA, which
// the wrapper allocates: no d is refused. The row tile is the smallest a
// warp of 4-thread rows fills; nothing in shared memory grows with d but
// the accumulators.
//
// What bounds it: 4*d operations per visible (q, k) pair in the forward,
// 6*d in dq and 8*d in dk/dv, on the CUDA cores from shared memory; the
// Q (and dO) chunks are reloaded for every k tile. A simple kernel that
// is right: no configuration of either package has d > 256.

#include "flash_common.cuh"

namespace {

constexpr int kR = 32;                 // rows a CTA owns; rows per streamed tile
constexpr int kC = 64;                 // head-dim columns per chunk
constexpr int kCS = kC + 1;            // floats per row of a chunk tile
constexpr int kTpr = 4;                // threads per owned row
constexpr int kNT = kR * kTpr;         // threads per CTA
constexpr int kOwn = kC / kTpr;        // columns of a chunk a thread owns
constexpr int kPer = kR / kTpr;        // pairs per thread per tile
constexpr int kChunkTile = kR * kCS;   // floats
constexpr int kSStride = kR + 1;
constexpr int kScoreTile = kR * kSStride;
constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };
enum Variant { kOnline = 0, kLazy = 1, kTwopass = 2 };

// floats of shared memory besides the accumulators, and the accumulator
// tiles [kR, d] of each kernel (mirrored by ops/flash_attention.py)
int fixed_floats(int kind) {
  return kind == kFwd ? 2 * kChunkTile + kScoreTile
       : kind == kDq  ? 4 * kChunkTile + kScoreTile
                      : 4 * kChunkTile + 2 * kScoreTile + 2 * kR;
}
int acc_tiles(int kind) { return kind == kDkv ? 2 : 1; }

struct DynParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;   // backward: the forward's lse
  const float* delta;
  void* o;
  float* lse;            // forward: written
  void* dq;
  void* dk;
  void* dv;
  float* ws;             // accumulators in device memory, or null: shared
  int sq;
  int sk;
  int d;
  float scale2;          // softmax scale * log2(e)
  float scale;
  int causal;
};

// rows [row0, row0 + kR) and columns [col0, col0 + kC) of a [rows, d] T
// matrix into an fp32 chunk tile; outside the matrix, zeros
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int row0,
                                           int rows, int col0, int d,
                                           int tid) {
  for (int i = tid; i < kR * kC; i += kNT) {
    int r = i / kC;
    int c = i % kC;
    int gr = row0 + r;
    int gc = col0 + c;
    dst[r * kCS + c] = gr < rows && gc < d
        ? to_f32(src[static_cast<size_t>(gr) * d + gc]) : 0.f;
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < kTpr; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kTpr; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// this CTA's accumulators: its slice of the workspace, or shared memory
__device__ __forceinline__ float* accumulators(const DynParams& p,
                                               float* smem_acc, int tiles) {
  if (!p.ws) return smem_acc;
  size_t cta = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  return p.ws + cta * tiles * kR * p.d;
}

// the columns of chunk ch a thread of part `part` owns: [c0, c0 + n)
__device__ __forceinline__ int own_cols(int ch, int part, int d, int& c0) {
  c0 = ch * kC + part * kOwn;
  return min(kOwn, d - c0);
}

template <typename T, int V>
__global__ void __launch_bounds__(kNT) flash_fwd_dyn_kernel(DynParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sKV = sQ + kChunkTile;
  float* sP = sKV + kChunkTile;
  const int tid = threadIdx.x;
  const int r = tid / kTpr;
  const int part = tid % kTpr;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int d = p.d;
  const int nc = (d + kC - 1) / kC;
  const T* q = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * p.sq * d;
  const T* k = static_cast<const T*>(p.k) + static_cast<size_t>(bh) * p.sk * d;
  const T* v = static_cast<const T*>(p.v) + static_cast<size_t>(bh) * p.sk * d;
  float* arow = accumulators(p, sP + kScoreTile, 1) +
                static_cast<size_t>(r) * d;
  float* prow = sP + r * kSStride;
  const int row = qi * kR + r;

  for (int ch = 0; ch < nc; ++ch) {
    int c0;
    int n = own_cols(ch, part, d, c0);
    for (int i = 0; i < n; ++i) arow[c0 + i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;   // partial: this thread's keys
  const int nk_total = (p.sk + kR - 1) / kR;
  const int nk = p.causal ? min(qi + 1, nk_total) : nk_total;

  auto logits = [&](int kb, float (&s)[kPer]) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) s[c] = 0.f;
    for (int ch = 0; ch < nc; ++ch) {
      __syncthreads();
      load_chunk<T>(sQ, q, qi * kR, p.sq, ch * kC, d, tid);
      load_chunk<T>(sKV, k, kb * kR, p.sk, ch * kC, d, tid);
      __syncthreads();
      const float* qrow = sQ + r * kCS;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const float* krow = sKV + (kTpr * c + part) * kCS;
        float dot = s[c];
#pragma unroll 16
        for (int e = 0; e < kC; ++e) dot = fmaf(qrow[e], krow[e], dot);
        s[c] = dot;
      }
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      int col = kb * kR + kTpr * c + part;
      bool keep = col < p.sk && (!p.causal || col <= row);
      s[c] = keep ? s[c] * p.scale2 : kNegInf;
    }
  };

  auto tile_max = [&](const float (&s)[kPer]) {
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kPer; ++c) mx = fmaxf(mx, s[c]);
    return row_max(mx);
  };

  // acc = acc * alpha + P V, P = exp2(s - m) rounded to V's dtype; l takes
  // P unrounded (the caller rescaled l by alpha)
  auto accumulate = [&](int kb, const float (&s)[kPer], float alpha) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      float pv = exp2f(s[c] - m);
      l += pv;
      prow[kTpr * c + part] = round_to<T>(pv);
    }
    for (int ch = 0; ch < nc; ++ch) {
      __syncthreads();
      load_chunk<T>(sKV, v, kb * kR, p.sk, ch * kC, d, tid);
      __syncthreads();
      int c0;
      int n = own_cols(ch, part, d, c0);
      float a[kOwn];
#pragma unroll
      for (int i = 0; i < kOwn; ++i) a[i] = i < n ? arow[c0 + i] * alpha : 0.f;
      const float* vcol = sKV + part * kOwn;
      for (int j = 0; j < kR; ++j) {
        float pj = prow[j];
        const float* vr = vcol + j * kCS;
#pragma unroll
        for (int i = 0; i < kOwn; ++i) a[i] = fmaf(pj, vr[i], a[i]);
      }
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
        if (i < n) arow[c0 + i] = a[i];
    }
  };

  float s[kPer];
  if constexpr (V == kOnline) {
    for (int kb = 0; kb < nk; ++kb) {
      logits(kb, s);
      float mx = fmaxf(m, tile_max(s));
      float alpha = exp2f(m - mx);
      l *= alpha;
      m = mx;
      accumulate(kb, s, alpha);
    }
  } else if constexpr (V == kLazy) {
    // diagonal first; m, l and acc are corrected only when some row of
    // the warp raises its max (alpha is exactly 1 for the others)
    for (int it = 0; it < nk; ++it) {
      int kb = nk - 1 - it;
      logits(kb, s);
      float mt = tile_max(s);
      float alpha = 1.f;
      if (__any_sync(0xffffffffu, mt > m)) {
        float mn = fmaxf(m, mt);
        alpha = exp2f(m - mn);
        m = mn;
      }
      l *= alpha;
      accumulate(kb, s, alpha);
    }
  } else {
    for (int kb = 0; kb < nk; ++kb) {
      logits(kb, s);
      m = fmaxf(m, tile_max(s));
    }
    for (int kb = 0; kb < nk; ++kb) {
      logits(kb, s);
      accumulate(kb, s, 1.f);
    }
  }

  float lr = fmaxf(row_sum(l), 1e-30f);
  if (row < p.sq) {
    T* o = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * d +
           static_cast<size_t>(row) * d;
    for (int ch = 0; ch < nc; ++ch) {
      int c0;
      int n = own_cols(ch, part, d, c0);
      for (int i = 0; i < n; ++i) o[c0 + i] = from_f32<T>(arow[c0 + i] / lr);
    }
    if (part == 0)
      p.lse[static_cast<size_t>(bh) * p.sq + row] = (m + log2f(lr)) * kLn2;
  }
}

// dq: one CTA per (b*h, 32-row q tile); K/V tiles of 32 keys stream up to
// the causal diagonal
template <typename T>
__global__ void __launch_bounds__(kNT) flash_bwd_dq_dyn_kernel(DynParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + kChunkTile;
  float* sK = sDO + kChunkTile;
  float* sV = sK + kChunkTile;
  float* sS = sV + kChunkTile;
  const int tid = threadIdx.x;
  const int r = tid / kTpr;
  const int part = tid % kTpr;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int d = p.d;
  const int nc = (d + kC - 1) / kC;
  const size_t q_off = static_cast<size_t>(bh) * p.sq * d;
  const size_t k_off = static_cast<size_t>(bh) * p.sk * d;
  const T* q = static_cast<const T*>(p.q) + q_off;
  const T* dout = static_cast<const T*>(p.dout) + q_off;
  const T* k = static_cast<const T*>(p.k) + k_off;
  const T* v = static_cast<const T*>(p.v) + k_off;
  float* arow = accumulators(p, sS + kScoreTile, 1) +
                static_cast<size_t>(r) * d;
  float* srow = sS + r * kSStride;
  const int row = qi * kR + r;
  const size_t stat = static_cast<size_t>(bh) * p.sq + row;
  const float lse2 = row < p.sq ? p.lse_in[stat] * kLog2e : 0.f;
  const float dlt = row < p.sq ? p.delta[stat] : 0.f;

  for (int ch = 0; ch < nc; ++ch) {
    int c0;
    int n = own_cols(ch, part, d, c0);
    for (int i = 0; i < n; ++i) arow[c0 + i] = 0.f;
  }
  const int nk_total = (p.sk + kR - 1) / kR;
  const int nk = p.causal ? min(qi + 1, nk_total) : nk_total;

  for (int kb = 0; kb < nk; ++kb) {
    float s[kPer], dp[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) s[c] = dp[c] = 0.f;
    for (int ch = 0; ch < nc; ++ch) {
      __syncthreads();
      load_chunk<T>(sQ, q, qi * kR, p.sq, ch * kC, d, tid);
      load_chunk<T>(sDO, dout, qi * kR, p.sq, ch * kC, d, tid);
      load_chunk<T>(sK, k, kb * kR, p.sk, ch * kC, d, tid);
      load_chunk<T>(sV, v, kb * kR, p.sk, ch * kC, d, tid);
      __syncthreads();
      const float* qrow = sQ + r * kCS;
      const float* dorow = sDO + r * kCS;
#pragma unroll 2
      for (int c = 0; c < kPer; ++c) {
        const float* krow = sK + (kTpr * c + part) * kCS;
        const float* vrow = sV + (kTpr * c + part) * kCS;
        float sc = s[c], dc = dp[c];
#pragma unroll 16
        for (int e = 0; e < kC; ++e) {
          sc = fmaf(qrow[e], krow[e], sc);
          dc = fmaf(dorow[e], vrow[e], dc);
        }
        s[c] = sc;
        dp[c] = dc;
      }
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      int j = kTpr * c + part;
      int col = kb * kR + j;
      bool vis = row < p.sq && col < p.sk && (!p.causal || col <= row);
      float sv = vis ? s[c] * p.scale2 : kNegInf;
      srow[j] = round_to<T>(exp2f(sv - lse2) * (dp[c] - dlt));
    }
    // dq += ds K, chunk by chunk
    for (int ch = 0; ch < nc; ++ch) {
      __syncthreads();
      load_chunk<T>(sK, k, kb * kR, p.sk, ch * kC, d, tid);
      __syncthreads();
      int c0;
      int n = own_cols(ch, part, d, c0);
      float a[kOwn];
#pragma unroll
      for (int i = 0; i < kOwn; ++i) a[i] = i < n ? arow[c0 + i] : 0.f;
      const float* kcol = sK + part * kOwn;
      for (int j = 0; j < kR; ++j) {
        float ds = srow[j];
        const float* kr = kcol + j * kCS;
#pragma unroll
        for (int i = 0; i < kOwn; ++i) a[i] = fmaf(ds, kr[i], a[i]);
      }
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
        if (i < n) arow[c0 + i] = a[i];
    }
  }

  if (row < p.sq) {
    T* dq = static_cast<T*>(p.dq) + q_off + static_cast<size_t>(row) * d;
    for (int ch = 0; ch < nc; ++ch) {
      int c0;
      int n = own_cols(ch, part, d, c0);
      for (int i = 0; i < n; ++i)
        dq[c0 + i] = from_f32<T>(arow[c0 + i] * p.scale);
    }
  }
}

// dk/dv: one CTA per (b*h, 32-key k tile); Q, dO, lse and delta tiles of
// 32 queries stream from the first one that can see the k tile
template <typename T>
__global__ void __launch_bounds__(kNT) flash_bwd_dkv_dyn_kernel(DynParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kChunkTile;
  float* sQ = sV + kChunkTile;
  float* sDO = sQ + kChunkTile;
  float* sP = sDO + kChunkTile;
  float* sS = sP + kScoreTile;
  float* sL = sS + kScoreTile;
  float* sD = sL + kR;
  const int tid = threadIdx.x;
  const int r = tid / kTpr;
  const int part = tid % kTpr;
  const int ki = blockIdx.x;
  const int bh = blockIdx.y;
  const int d = p.d;
  const int nc = (d + kC - 1) / kC;
  const size_t q_off = static_cast<size_t>(bh) * p.sq * d;
  const size_t k_off = static_cast<size_t>(bh) * p.sk * d;
  const T* q = static_cast<const T*>(p.q) + q_off;
  const T* dout = static_cast<const T*>(p.dout) + q_off;
  const T* k = static_cast<const T*>(p.k) + k_off;
  const T* v = static_cast<const T*>(p.v) + k_off;
  const float* lse = p.lse_in + static_cast<size_t>(bh) * p.sq;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.sq;
  float* acc = accumulators(p, sD + kR, 2);
  float* dkrow = acc + static_cast<size_t>(r) * d;
  float* dvrow = acc + static_cast<size_t>(kR + r) * d;
  float* prow = sP + r * kSStride;
  float* srow = sS + r * kSStride;
  const int krow = ki * kR + r;

  for (int ch = 0; ch < nc; ++ch) {
    int c0;
    int n = own_cols(ch, part, d, c0);
    for (int i = 0; i < n; ++i) dkrow[c0 + i] = dvrow[c0 + i] = 0.f;
  }
  const int nq = (p.sq + kR - 1) / kR;
  const int qb_start = p.causal ? ki : 0;

  for (int qb = qb_start; qb < nq; ++qb) {
    // the previous tile's readers of sL/sD passed a barrier since
    for (int i = tid; i < 2 * kR; i += kNT) {
      int row = qb * kR + (i % kR);
      if (i < kR)
        sL[i] = row < p.sq ? lse[row] * kLog2e : 0.f;
      else
        sD[i - kR] = row < p.sq ? delta[row] : 0.f;
    }
    float s[kPer], dp[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) s[c] = dp[c] = 0.f;
    for (int ch = 0; ch < nc; ++ch) {
      __syncthreads();
      load_chunk<T>(sK, k, ki * kR, p.sk, ch * kC, d, tid);
      load_chunk<T>(sV, v, ki * kR, p.sk, ch * kC, d, tid);
      load_chunk<T>(sQ, q, qb * kR, p.sq, ch * kC, d, tid);
      load_chunk<T>(sDO, dout, qb * kR, p.sq, ch * kC, d, tid);
      __syncthreads();
      const float* kr = sK + r * kCS;
      const float* vr = sV + r * kCS;
#pragma unroll 2
      for (int c = 0; c < kPer; ++c) {
        const float* qr = sQ + (kTpr * c + part) * kCS;
        const float* dr = sDO + (kTpr * c + part) * kCS;
        float sc = s[c], dc = dp[c];
#pragma unroll 16
        for (int e = 0; e < kC; ++e) {
          sc = fmaf(kr[e], qr[e], sc);
          dc = fmaf(vr[e], dr[e], dc);
        }
        s[c] = sc;
        dp[c] = dc;
      }
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      int j = kTpr * c + part;
      int qrow = qb * kR + j;
      bool vis = qrow < p.sq && krow < p.sk && (!p.causal || krow <= qrow);
      float sv = vis ? s[c] * p.scale2 : kNegInf;
      float pv = exp2f(sv - sL[j]);
      prow[j] = round_to<T>(pv);
      srow[j] = round_to<T>(pv * (dp[c] - sD[j]));
    }
    // dv += p^T dO and dk += ds^T Q, chunk by chunk
    for (int ch = 0; ch < nc; ++ch) {
      __syncthreads();
      load_chunk<T>(sQ, q, qb * kR, p.sq, ch * kC, d, tid);
      load_chunk<T>(sDO, dout, qb * kR, p.sq, ch * kC, d, tid);
      __syncthreads();
      int c0;
      int n = own_cols(ch, part, d, c0);
      float ak[kOwn], av[kOwn];
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        ak[i] = i < n ? dkrow[c0 + i] : 0.f;
        av[i] = i < n ? dvrow[c0 + i] : 0.f;
      }
      for (int j = 0; j < kR; ++j) {
        float pj = prow[j];
        float dsj = srow[j];
        const float* dr = sDO + j * kCS + part * kOwn;
        const float* qr = sQ + j * kCS + part * kOwn;
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          av[i] = fmaf(pj, dr[i], av[i]);
          ak[i] = fmaf(dsj, qr[i], ak[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
        if (i < n) {
          dkrow[c0 + i] = ak[i];
          dvrow[c0 + i] = av[i];
        }
    }
  }

  if (krow < p.sk) {
    size_t i0 = k_off + static_cast<size_t>(krow) * d;
    T* gk = static_cast<T*>(p.dk) + i0;
    T* gv = static_cast<T*>(p.dv) + i0;
    for (int ch = 0; ch < nc; ++ch) {
      int c0;
      int n = own_cols(ch, part, d, c0);
      for (int i = 0; i < n; ++i) {
        gk[c0 + i] = from_f32<T>(dkrow[c0 + i] * p.scale);
        gv[c0 + i] = from_f32<T>(dvrow[c0 + i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch

// the dynamic shared memory of a launch: the accumulators' too unless a
// workspace holds them; 0 where they would not fit and there is none
size_t smem_bytes(int kind, int d, bool has_ws) {
  size_t floats = fixed_floats(kind) +
                  (has_ws ? 0 : static_cast<size_t>(acc_tiles(kind)) * kR * d);
  size_t bytes = floats * sizeof(float);
  return bytes <= static_cast<size_t>(kMaxSmem) ? bytes : 0;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, std::atomic<uint32_t>& opted_in, int kind,
                   int rows, int bh, const DynParams& p,
                   cudaStream_t stream) {
  if (bh <= 0 || p.sq <= 0 || p.sk <= 0 || p.d <= 0 || bh > 65535)
    return cudaErrorInvalidValue;
  size_t smem = smem_bytes(kind, p.d, p.ws != nullptr);
  if (!smem) return cudaErrorInvalidValue;
  // opted in once to the most a block may use: the smem of a launch
  // depends on d
  cudaError_t err = opt_in_smem(kernel, kMaxSmem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + kR - 1) / kR, bh);
  kernel<<<grid, kNT, smem, stream>>>(p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <typename T, int V>
cudaError_t launch_fwd(int bh, const DynParams& p, cudaStream_t stream) {
  static std::atomic<uint32_t> opted_in{0};
  return launch(flash_fwd_dyn_kernel<T, V>, opted_in, kFwd, p.sq, bh, p,
                stream);
}

template <typename T>
cudaError_t dispatch_fwd(int variant, int bh, const DynParams& p,
                         cudaStream_t stream) {
  switch (variant) {
    case kOnline: return launch_fwd<T, kOnline>(bh, p, stream);
    case kLazy: return launch_fwd<T, kLazy>(bh, p, stream);
    case kTwopass: return launch_fwd<T, kTwopass>(bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_bwd(int kind, int bh, const DynParams& p,
                         cudaStream_t stream) {
  if (kind == kDq) {
    static std::atomic<uint32_t> opted_in{0};
    return launch(flash_bwd_dq_dyn_kernel<T>, opted_in, kDq, p.sq, bh, p,
                  stream);
  }
  static std::atomic<uint32_t> opted_in{0};
  return launch(flash_bwd_dkv_dyn_kernel<T>, opted_in, kDkv, p.sk, bh, p,
                stream);
}

cudaError_t bwd(int kind, DynParams p, int bh, int dtype,
                cudaStream_t stream) {
  if (dtype == 0) return dispatch_bwd<float>(kind, bh, p, stream);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(kind, bh, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (no PyTorch headers here: they stay in
// bindings.cpp). dtype 0 fp32, 1 bf16; any d >= 1. ws is null (the
// accumulators in shared memory, which must fit) or an fp32 workspace of
// ceil(rows / 32) * bh * tiles * 32 * d floats, rows sq (forward, dq) or
// sk (dk/dv), tiles 1 (forward, dq) or 2 (dk/dv). variant: 0 online, 1
// lazy, 2 twopass. scale2 is the softmax scale times log2(e), rounded once
// by the caller. Each returns a configuration error; the launch itself is
// checked by the caller with cudaGetLastError.
extern "C" cudaError_t hvd_flash_fwd_dyn(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         float* ws, int bh, int sq, int sk,
                                         int d, int dtype, int variant,
                                         int causal, float scale2,
                                         cudaStream_t stream) {
  DynParams p{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr,
              nullptr, ws, sq, sk, d, scale2, 0.f, causal};
  if (dtype == 0) return dispatch_fwd<float>(variant, bh, p, stream);
  if (dtype == 1) return dispatch_fwd<__nv_bfloat16>(variant, bh, p, stream);
  return cudaErrorInvalidValue;
}

extern "C" cudaError_t hvd_flash_bwd_dyn_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, float* ws, int bh,
    int sq, int sk, int d, int dtype, int causal, float scale2, float scale,
    cudaStream_t stream) {
  DynParams p{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr,
              nullptr, ws, sq, sk, d, scale2, scale, causal};
  return bwd(kDq, p, bh, dtype, stream);
}

extern "C" cudaError_t hvd_flash_bwd_dyn_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, float* ws,
    int bh, int sq, int sk, int d, int dtype, int causal, float scale2,
    float scale, cudaStream_t stream) {
  DynParams p{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
              ws, sq, sk, d, scale2, scale, causal};
  return bwd(kDkv, p, bh, dtype, stream);
}
