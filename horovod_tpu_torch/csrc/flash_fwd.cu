// Flash-attention forward for Hopper (sm_90a) in fp32, on the CUDA cores:
// the fp32 variants of horovod_tpu/ops/flash_attention.py. Every bf16
// forward runs on wgmma and TMA in flash_fwd_sm90.cu.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_fwd), in fp32:
//   online  -> _fwd_kernel           (rescale every k tile)
//   lazy    -> _fwd_kernel_lazy      (rescale only when a tile raises the
//                                     row max; k tiles diagonal-first)
//   twopass -> _fwd_kernel_twopass   (pass 1 row max, pass 2 accumulate)
//
// Contract (same as the TPU kernels): q/k/v are [b*h, s, d] contiguous
// fp32; O is fp32; lse is the natural-log row log-sum-exp, fp32, [b*h, sq]
// (one row per query, not the TPU's 8-sublane replicated layout). The
// softmax runs in the exp2 domain with log2(e) folded into the logit
// scale; masked logits take the finite sentinel -1e30, never -inf: a row
// whose first tile is fully masked accumulates exp2(0) = 1 garbage that
// the next tile's alpha = exp2(-1e30 - m) = 0 wipes, where -inf would give
// NaN. The causal k loop stops at the diagonal tile.
//
// Lengths. Any sq and sk: a partial last q tile is zero-filled on load and
// its rows past sq are never stored; a partial last k tile is zero-filled
// and its columns past sk are masked (col < sk), since a zero key's logit
// is 0, not -1e30.
//
// Design. One CTA of 4 warps per (b*h, 64-row q tile); each pair of
// threads owns one query row. K/V tiles of 64 rows go through shared
// memory, and the products run in full fp32 (no TF32) through a
// probabilities tile in shared memory.
//
// What bounds it: 4*d operations per visible (q, k) pair against q, k, v
// read once and O written once; at 67 TFLOP/s of fp32 the CUDA cores are
// the bound at every shape the port runs. The fp32 variants are on no
// main path: they are the reference-precision path.
//
// The lazy predicate is taken per warp (16 rows) where the TPU kernel
// takes it per 64-row block: a row whose max did not rise gets
// alpha = exp2(m - m) = 1 exactly either way, so the two are bit-identical
// and the narrower predicate skips more work.

#include "flash_common.cuh"

namespace {

enum Variant { kOnline = 0, kLazy = 1, kTwopass = 2 };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
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

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32

// Q, K, V tiles + the probabilities tile
template <int D>
struct F32Layout {
  static constexpr int kStride = F32Tile<D>::kStride;   // floats per row
  static constexpr int kTile = F32Tile<D>::kElems;
  static constexpr int kPStride = kBlock + 1;
  static constexpr int kSmemBytes = (3 * kTile + kBlock * kPStride) * 4;
};

// Each pair of threads owns one query row: thread `half` computes the
// logits of keys half, half+2, ... and the output columns
// [half*D/2, (half+1)*D/2). Row statistics are shared within the pair.
template <int D, int V>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(Params p) {
  using L = F32Layout<D>;
  constexpr int kStride = L::kStride;
  constexpr int kHalfD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + L::kTile;
  float* sV = sK + L::kTile;
  float* sP = sV + L::kTile;

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float* q = p.q + static_cast<size_t>(bh) * p.sq * D;
  const float* k = p.k + static_cast<size_t>(bh) * p.sk * D;
  const float* v = p.v + static_cast<size_t>(bh) * p.sk * D;
  const int row = qi * kBlock + r;

  load_tile_f32<D>(sQ, q, qi * kBlock, p.sq, tid);

  float m = kNegInf;
  float l = 0.f;      // partial: this thread's keys
  float acc[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) acc[i] = 0.f;
  const int nk = k_tiles(p, qi);
  const float* qrow = sQ + r * kStride;
  float* prow = sP + r * L::kPStride;

  auto load = [&](int kb, bool with_v) {
    __syncthreads();
    load_tile_f32<D>(sK, k, kb * kBlock, p.sk, tid);
    if (with_v) load_tile_f32<D>(sV, v, kb * kBlock, p.sk, tid);
    __syncthreads();
  };

  auto logits = [&](int kb, float (&s)[kBlock / 2]) {
#pragma unroll 4
    for (int c = 0; c < kBlock / 2; ++c) {
      int j = 2 * c + half;
      const float* krow = sK + j * kStride;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
      int col = kb * kBlock + j;
      bool keep = col < p.sk && (!p.causal || col <= row);
      s[c] = keep ? dot * p.scale2 : kNegInf;
    }
  };

  auto row_max = [&](const float (&s)[kBlock / 2]) {
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kBlock / 2; ++c) mx = fmaxf(mx, s[c]);
    return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  };

  auto rescale = [&](float alpha) {
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) acc[i] *= alpha;
  };

  // p = exp2(s - m) into the shared probabilities row, then l and P@V
  auto accumulate = [&](const float (&s)[kBlock / 2]) {
#pragma unroll
    for (int c = 0; c < kBlock / 2; ++c) {
      float pv = exp2f(s[c] - m);
      l += pv;
      prow[2 * c + half] = pv;
    }
    __syncwarp();
    const float* vcol = sV + half * kHalfD;
    for (int j = 0; j < kBlock; ++j) {
      float pj = prow[j];
      const float* vrow = vcol + j * kStride;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(pj, vrow[i], acc[i]);
    }
  };

  if constexpr (V == kOnline) {
    for (int kb = 0; kb < nk; ++kb) {
      load(kb, true);
      float s[kBlock / 2];
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
      float s[kBlock / 2];
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
      float s[kBlock / 2];
      logits(kb, s);
      m = fmaxf(m, row_max(s));
    }
    for (int kb = 0; kb < nk; ++kb) {
      load(kb, true);
      float s[kBlock / 2];
      logits(kb, s);
      accumulate(s);
    }
  }

  float lr = fmaxf(l + __shfl_xor_sync(0xffffffffu, l, 1), 1e-30f);
  if (row < p.sq) {
    float* o = p.o + static_cast<size_t>(bh) * p.sq * D +
               static_cast<size_t>(row) * D + half * kHalfD;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) o[i] = acc[i] / lr;
    if (half == 0)
      p.lse[static_cast<size_t>(bh) * p.sq + row] = (m + log2f(lr)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// dispatch

template <int D, int V>
cudaError_t launch(int bh, const Params& p, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D, V>;
  constexpr int smem = F32Layout<D>::kSmemBytes;
  static std::atomic<uint32_t> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int D>
cudaError_t dispatch(int variant, int bh, const Params& p,
                     cudaStream_t stream) {
  switch (variant) {
    case kOnline: return launch<D, kOnline>(bh, p, stream);
    case kLazy: return launch<D, kLazy>(bh, p, stream);
    case kTwopass: return launch<D, kTwopass>(bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (no PyTorch headers here: they stay in bindings.cpp).
// fp32 only (bf16 runs on hvd_flash_fwd_sm90). variant: 0 online, 1 lazy,
// 2 twopass. scale2 is the softmax scale times log2(e), rounded once by the
// caller. Returns a configuration error; the launch itself is checked by
// the caller with cudaGetLastError.
extern "C" cudaError_t hvd_flash_fwd(const float* q, const float* k,
                                     const float* v, float* o, float* lse,
                                     int bh, int sq, int sk, int d,
                                     int variant, int causal, float scale2,
                                     cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, sq, sk, scale2, causal};
  switch (d) {
    case 16: return dispatch<16>(variant, bh, p, stream);
    case 32: return dispatch<32>(variant, bh, p, stream);
    case 64: return dispatch<64>(variant, bh, p, stream);
    case 128: return dispatch<128>(variant, bh, p, stream);
  }
  return cudaErrorInvalidValue;
}
