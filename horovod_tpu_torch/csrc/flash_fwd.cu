// Flash-attention forward for Hopper (sm_90a): the variants of
// horovod_tpu/ops/flash_attention.py that do not run on wgmma.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_fwd):
//   online  -> _fwd_kernel           (rescale every k tile), bf16 and fp32
//   lazy    -> _fwd_kernel_lazy      (rescale only when a tile raises the
//                                     row max; k tiles diagonal-first), fp32
//   twopass -> _fwd_kernel_twopass   (pass 1 row max, pass 2 accumulate),
//                                     fp32
// bf16 lazy and twopass run on wgmma and TMA in flash_fwd_sm90.cu.
//
// Contract (same as the TPU kernels): q/k/v are [b*h, s, d] contiguous;
// O has q's dtype; lse is the natural-log row log-sum-exp, fp32, [b*h, sq]
// (one row per query, not the TPU's 8-sublane replicated layout). The
// softmax runs in the exp2 domain with log2(e) folded into the logit
// scale; masked logits take the finite sentinel -1e30, never -inf: a row
// whose first tile is fully masked accumulates exp2(0) = 1 garbage that
// the next tile's alpha = exp2(-1e30 - m) = 0 wipes, where -inf would give
// NaN. The causal k loop stops at the diagonal tile.
//
// Design. One CTA of 4 warps per (b*h, 64-row q tile); each warp owns 16
// query rows. K/V tiles of 64 rows stream through double-buffered shared
// memory with cp.async (zero-filled past the sequence end). bf16 runs both
// products on the tensor cores with mma.sync m16n8k16 and fp32
// accumulation; the logits never leave registers, and P is rounded to
// V's dtype (bf16) before P@V, as the TPU kernel does. fp32 runs on the
// CUDA cores in full fp32 (no TF32), through a logits tile in shared
// memory.
//
// What bounds it: 4*d operations per visible (q, k) pair against q, k, v
// read once and O written once. The online walk runs where the k loop has
// one tile (prompts of 64 tokens or fewer in serving), where the time is
// a launch and one tile's latency; the fp32 variants are on no main path.
// Neither uses wgmma/TMA or ldmatrix.
//
// The lazy predicate is taken per warp (16 rows) where the TPU kernel
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

// ---------------------------------------------------------------------------
// bf16: tensor cores

// Q tile + two K tiles + two V tiles
template <int D>
struct Bf16Layout {
  static constexpr int kStride = Bf16Tile<D>::kStride;
  static constexpr int kTile = Bf16Tile<D>::kElems;
  static constexpr int kSmemBytes = 5 * kTile * 2;
};

// the online walk (the bf16 lazy and twopass walks are flash_fwd_sm90.cu's)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(Params p) {
  using L = Bf16Layout<D>;
  constexpr int kStride = L::kStride;
  constexpr int kDSteps = D / 16;   // k-steps of Q K^T
  constexpr int kDTiles = D / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + L::kTile;
  __nv_bfloat16* sV = sK + 2 * L::kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  // heaviest (latest) causal q tiles first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + static_cast<size_t>(bh) * p.sq * D;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + static_cast<size_t>(bh) * p.sk * D;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + static_cast<size_t>(bh) * p.sk * D;

  load_tile_bf16<D>(sQ, q, qi * kBlock, p.sq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, kept for every tile
  uint32_t qf[kDSteps][4];
  {
    const __nv_bfloat16* base = sQ + (warp * 16) * kStride;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      const __nv_bfloat16* b = base + ks * 16 + 2 * t;
      qf[ks][0] = ld32(b + g * kStride);
      qf[ks][1] = ld32(b + (g + 8) * kStride);
      qf[ks][2] = ld32(b + g * kStride + 8);
      qf[ks][3] = ld32(b + (g + 8) * kStride + 8);
    }
  }
  const int row0 = qi * kBlock + warp * 16 + g;   // global q rows row0, row0+8

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};           // this thread's partial row sums
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nk = k_tiles(p, qi);

  // logits of k tile kb for this warp's rows, scaled to log2 units and
  // masked: 8 n-tiles of 16x8
  auto logits = [&](const __nv_bfloat16* tk, int kb, float (&s)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* b = tk + (nt * 8 + g) * kStride + ks * 16 + 2 * t;
        mma_bf16(s[nt], qf[ks], ld32(b), ld32(b + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = kb * kBlock + nt * 8 + 2 * t + (e & 1);
        int row = row0 + (e >> 1) * 8;
        bool keep = col < p.sk && (!p.causal || col <= row);
        s[nt][e] = keep ? s[nt][e] * p.scale2 : kNegInf;
      }
    }
  };

  // l += rowsum(p), acc += P@V with P rounded to bf16; s holds p on entry
  auto accumulate = [&](const __nv_bfloat16* tv, float (&s)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      l[0] += s[nt][0] + s[nt][1];
      l[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // 16 keys per k-step
      uint32_t a[4];
      a[0] = pack_f2(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_f2(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_f2(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_f2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        const __nv_bfloat16* b = tv + (16 * j + 2 * t) * kStride + dn * 8 + g;
        mma_bf16(acc[dn], a, pack2(b, b + kStride),
                 pack2(b + 8 * kStride, b + 9 * kStride));
      }
    }
  };

  auto rescale = [&](int r, float alpha) {
    l[r] *= alpha;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      acc[dn][2 * r] *= alpha;
      acc[dn][2 * r + 1] *= alpha;
    }
  };

  // stream k and v tiles through the double buffer in ascending order,
  // rescaling on every tile
  auto issue = [&](int kb) {
    int buf = kb & 1;
    load_tile_bf16<D>(sK + buf * L::kTile, k, kb * kBlock, p.sk, tid);
    load_tile_bf16<D>(sV + buf * L::kTile, v, kb * kBlock, p.sk, tid);
    cp_async_commit();
  };
  issue(0);
  for (int kb = 0; kb < nk; ++kb) {
    if (kb + 1 < nk) {
      issue(kb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int buf = kb & 1;
    float s[8][4];
    logits(sK + buf * L::kTile, kb, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = quad_max(mx);
      rescale(r, exp2f(m[r] - mx));
      m[r] = mx;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - mx);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - mx);
      }
    }
    accumulate(sV + buf * L::kTile, s);
    __syncthreads();
  }

  __nv_bfloat16* o =
      static_cast<__nv_bfloat16*>(p.o) + static_cast<size_t>(bh) * p.sq * D;
  float* lse = p.lse + static_cast<size_t>(bh) * p.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    int row = row0 + 8 * r;
    if (row < p.sq) {
      float inv = 1.f / lr;
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        *reinterpret_cast<uint32_t*>(o + static_cast<size_t>(row) * D + dn * 8 + 2 * t) =
            pack_f2(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
      }
      if (t == 0) lse[row] = (m[r] + log2f(lr)) * kLn2;
    }
  }
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
  const float* q = static_cast<const float*>(p.q) + static_cast<size_t>(bh) * p.sq * D;
  const float* k = static_cast<const float*>(p.k) + static_cast<size_t>(bh) * p.sk * D;
  const float* v = static_cast<const float*>(p.v) + static_cast<size_t>(bh) * p.sk * D;
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
    float* o = static_cast<float*>(p.o) + static_cast<size_t>(bh) * p.sq * D +
               static_cast<size_t>(row) * D + half * kHalfD;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) o[i] = acc[i] / lr;
    if (half == 0)
      p.lse[static_cast<size_t>(bh) * p.sq + row] = (m + log2f(lr)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// dispatch

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, std::atomic<uint32_t>& opted_in,
                   int bh, const Params& p, cudaStream_t stream) {
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int D, int V>
cudaError_t launch_f32(int bh, const Params& p, cudaStream_t stream) {
  static std::atomic<uint32_t> opted_in{0};
  return launch(flash_fwd_f32_kernel<D, V>, F32Layout<D>::kSmemBytes,
                opted_in, bh, p, stream);
}

template <int D>
cudaError_t dispatch(bool bf16, int variant, int bh, const Params& p,
                     cudaStream_t stream) {
  if (bf16) {
    // bf16 lazy and twopass are hvd_flash_fwd_sm90's
    if (variant != kOnline) return cudaErrorInvalidValue;
    static std::atomic<uint32_t> opted_in{0};
    return launch(flash_fwd_bf16_kernel<D>, Bf16Layout<D>::kSmemBytes,
                  opted_in, bh, p, stream);
  }
  switch (variant) {
    case kOnline: return launch_f32<D, kOnline>(bh, p, stream);
    case kLazy: return launch_f32<D, kLazy>(bh, p, stream);
    case kTwopass: return launch_f32<D, kTwopass>(bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (no PyTorch headers here: they stay in bindings.cpp).
// dtype: 0 = fp32, 1 = bf16. variant: 0 online, 1 lazy, 2 twopass; bf16
// takes only online here (hvd_flash_fwd_sm90 takes bf16 lazy and twopass).
// scale2 is the softmax scale times log2(e), rounded once by the caller.
// Returns a configuration error; the launch itself is checked by the caller
// with cudaGetLastError.
extern "C" cudaError_t hvd_flash_fwd(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int bh, int sq, int sk, int d, int dtype,
                                     int variant, int causal, float scale2,
                                     cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, sq, sk, scale2, causal};
  bool bf16 = dtype == 1;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return dispatch<16>(bf16, variant, bh, p, stream);
    case 32: return dispatch<32>(bf16, variant, bh, p, stream);
    case 64: return dispatch<64>(bf16, variant, bh, p, stream);
    case 128: return dispatch<128>(bf16, variant, bh, p, stream);
  }
  return cudaErrorInvalidValue;
}
