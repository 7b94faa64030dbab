// Flash-attention forward for Hopper (sm_90a) on the CUDA cores: every
// fp32 forward, and the bf16 forward at head dims above 128. The bf16
// forward up to d 128 runs on wgmma and TMA in flash_fwd_sm90.cu.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_fwd):
//   online  -> _fwd_kernel           (rescale every k tile)
//   lazy    -> _fwd_kernel_lazy      (rescale only when a tile raises the
//                                     row max; k tiles diagonal-first)
//   twopass -> _fwd_kernel_twopass   (pass 1 row max, pass 2 accumulate)
//
// Contract (same as the TPU kernels): q/k/v are [b*h, s, d] contiguous
// fp32 or bf16; O is in their dtype; lse is the natural-log row
// log-sum-exp, fp32, [b*h, sq] (one row per query, not the TPU's 8-sublane
// replicated layout). Logits are fp32 products of the input-dtype values;
// P is rounded to V's dtype before P@V (a no-op in fp32) while the row sum
// l takes it unrounded; O accumulates in fp32. The softmax runs in the
// exp2 domain with log2(e) folded into the logit scale; masked logits take
// the finite sentinel -1e30, never -inf: a row whose first tile is fully
// masked accumulates exp2(0) = 1 garbage that the next tile's
// alpha = exp2(-1e30 - m) = 0 wipes, where -inf would give NaN. The causal
// k loop stops at the diagonal tile.
//
// Lengths. Any sq and sk: a partial last q tile is zero-filled on load and
// its rows past sq are never stored; a partial last k tile is zero-filled
// and its columns past sk are masked (col < sk), since a zero key's logit
// is 0, not -1e30.
//
// Design. One CTA per (b*h, 64-row q tile), TPR threads per query row
// (2 up to d 128, 4 at d 256: 128 or 256 threads); each thread computes
// the logits of every TPR-th key and owns D/TPR output columns. K/V tiles
// of 64 rows go through shared memory as fp32, and the products run in
// full fp32 (no TF32) through a probabilities tile in shared memory. At
// d 256 the Q, K and V tiles take 197 KB of the 227 KB a block may use.
//
// What bounds it: 4*d operations per visible (q, k) pair against q, k, v
// read once and O written once; at 67 TFLOP/s of fp32 the CUDA cores are
// the bound at every shape the port runs. These kernels are on no main
// path: they are the reference-precision path and the head dims the
// wgmma kernels do not take; a simple kernel that is right.
//
// The lazy predicate is taken per warp (32/TPR rows) where the TPU kernel
// takes it per 64-row block: a row whose max did not rise gets
// alpha = exp2(m - m) = 1 exactly either way, so the two are bit-identical
// and the narrower predicate skips more work.

#include "flash_common.cuh"

namespace {

enum Variant { kOnline = 0, kLazy = 1, kTwopass = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int sq;
  int sk;
  float scale2;   // softmax scale * log2(e)
  int causal;
};

// number of k tiles this q tile visits: the causal loop stops at the
// diagonal tile (q and k tiles are both kBlock rows)
__device__ __forceinline__ int k_tiles(const Params& p, int qi) {
  int nk = (p.sk + kBlock - 1) / kBlock;
  return p.causal ? min(qi + 1, nk) : nk;
}

// threads per query row: more at d 256, so that a thread holds D/TPR
// accumulators
template <int D>
constexpr int fwd_tpr() { return D > 128 ? 4 : 2; }

// Q, K, V tiles + the probabilities tile, fp32
template <int D>
struct FwdLayout {
  static constexpr int kStride = F32Tile<D>::kStride;   // floats per row
  static constexpr int kTile = F32Tile<D>::kElems;
  static constexpr int kPStride = kBlock + 1;
  static constexpr int kSmemBytes = (3 * kTile + kBlock * kPStride) * 4;
};

// TPR threads own one query row: thread `part` computes the logits of
// keys part, part+TPR, ... and the output columns
// [part*D/TPR, (part+1)*D/TPR). Row statistics are shared among them.
template <typename T, int D, int V, int TPR>
__global__ void __launch_bounds__(kBlock * TPR)
flash_fwd_cc_kernel(Params p) {
  using L = FwdLayout<D>;
  constexpr int kNT = kBlock * TPR;
  constexpr int kStride = L::kStride;
  constexpr int kCols = D / TPR;
  constexpr int kKeys = kBlock / TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + L::kTile;
  float* sV = sK + L::kTile;
  float* sP = sV + L::kTile;

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int part = tid % TPR;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const T* q = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * p.sq * D;
  const T* k = static_cast<const T*>(p.k) + static_cast<size_t>(bh) * p.sk * D;
  const T* v = static_cast<const T*>(p.v) + static_cast<size_t>(bh) * p.sk * D;
  const int row = qi * kBlock + r;

  load_tile<T, D, kBlock, kNT>(sQ, q, qi * kBlock, p.sq, tid);

  float m = kNegInf;
  float l = 0.f;      // partial: this thread's keys
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  const int nk = k_tiles(p, qi);
  const float* qrow = sQ + r * kStride;
  float* prow = sP + r * L::kPStride;

  // the TPR threads of a row are adjacent lanes: reduce over them
  auto row_reduce_max = [&](float x) {
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
  };

  auto load = [&](int kb, bool with_v) {
    __syncthreads();
    load_tile<T, D, kBlock, kNT>(sK, k, kb * kBlock, p.sk, tid);
    if (with_v) load_tile<T, D, kBlock, kNT>(sV, v, kb * kBlock, p.sk, tid);
    __syncthreads();
  };

  auto logits = [&](int kb, float (&s)[kKeys]) {
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      int j = TPR * c + part;
      const float* krow = sK + j * kStride;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
      int col = kb * kBlock + j;
      bool keep = col < p.sk && (!p.causal || col <= row);
      s[c] = keep ? dot * p.scale2 : kNegInf;
    }
  };

  auto row_max = [&](const float (&s)[kKeys]) {
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) mx = fmaxf(mx, s[c]);
    return row_reduce_max(mx);
  };

  auto rescale = [&](float alpha) {
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
  };

  // p = exp2(s - m): l takes it as computed, the shared probabilities row
  // (the P@V operand) rounded to V's dtype
  auto accumulate = [&](const float (&s)[kKeys]) {
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      float pv = exp2f(s[c] - m);
      l += pv;
      prow[TPR * c + part] = round_to<T>(pv);
    }
    __syncwarp();
    const float* vcol = sV + part * kCols;
    for (int j = 0; j < kBlock; ++j) {
      float pj = prow[j];
      const float* vrow = vcol + j * kStride;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(pj, vrow[i], acc[i]);
    }
    __syncwarp();
  };

  if constexpr (V == kOnline) {
    for (int kb = 0; kb < nk; ++kb) {
      load(kb, true);
      float s[kKeys];
      logits(kb, s);
      float mx = fmaxf(m, row_max(s));
      rescale(exp2f(m - mx));
      m = mx;
      accumulate(s);
    }
  } else if constexpr (V == kLazy) {
    for (int it = 0; it < nk; ++it) {
      int kb = nk - 1 - it;
      load(kb, true);
      float s[kKeys];
      logits(kb, s);
      float mt = row_max(s);
      if (__any_sync(0xffffffffu, mt > m)) {
        float mn = fmaxf(m, mt);
        rescale(exp2f(m - mn));
        m = mn;
      }
      accumulate(s);
    }
  } else {
    for (int kb = 0; kb < nk; ++kb) {
      load(kb, false);
      float s[kKeys];
      logits(kb, s);
      m = fmaxf(m, row_max(s));
    }
    for (int kb = 0; kb < nk; ++kb) {
      load(kb, true);
      float s[kKeys];
      logits(kb, s);
      accumulate(s);
    }
  }

  float lsum = l;
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  float lr = fmaxf(lsum, 1e-30f);
  if (row < p.sq) {
    T* o = static_cast<T*>(p.o) + static_cast<size_t>(bh) * p.sq * D +
           static_cast<size_t>(row) * D + part * kCols;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[i] = from_f32<T>(acc[i] / lr);
    if (part == 0)
      p.lse[static_cast<size_t>(bh) * p.sq + row] = (m + log2f(lr)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// dispatch

template <typename T, int D, int V>
cudaError_t launch(int bh, const Params& p, cudaStream_t stream) {
  constexpr int kTpr = fwd_tpr<D>();
  auto kernel = flash_fwd_cc_kernel<T, D, V, kTpr>;
  constexpr int smem = FwdLayout<D>::kSmemBytes;
  static std::atomic<uint32_t> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kBlock * kTpr, smem, stream>>>(p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <typename T, int D>
cudaError_t dispatch(int variant, int bh, const Params& p,
                     cudaStream_t stream) {
  switch (variant) {
    case kOnline: return launch<T, D, kOnline>(bh, p, stream);
    case kLazy: return launch<T, D, kLazy>(bh, p, stream);
    case kTwopass: return launch<T, D, kTwopass>(bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (no PyTorch headers here: they stay in bindings.cpp).
// dtype 0: fp32 at d 16/32/64/128/256; dtype 1: bf16 at d 256 (bf16 up to
// d 128 runs on hvd_flash_fwd_sm90). variant: 0 online, 1 lazy, 2 twopass.
// scale2 is the softmax scale times log2(e), rounded once by the caller.
// Returns a configuration error; the launch itself is checked by the
// caller with cudaGetLastError.
extern "C" cudaError_t hvd_flash_fwd(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int bh, int sq, int sk, int d,
                                     int dtype, int variant, int causal,
                                     float scale2, cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, sq, sk, scale2, causal};
  if (dtype == 1)
    return d == 256 ? dispatch<__nv_bfloat16, 256>(variant, bh, p, stream)
                    : cudaErrorInvalidValue;
  switch (d) {
    case 16: return dispatch<float, 16>(variant, bh, p, stream);
    case 32: return dispatch<float, 32>(variant, bh, p, stream);
    case 64: return dispatch<float, 64>(variant, bh, p, stream);
    case 128: return dispatch<float, 128>(variant, bh, p, stream);
    case 256: return dispatch<float, 256>(variant, bh, p, stream);
  }
  return cudaErrorInvalidValue;
}
