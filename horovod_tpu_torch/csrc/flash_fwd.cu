// Flash-attention forward for Hopper (sm_90a) on the CUDA cores: the fp32
// forward at head dims 16-256. The bf16 forward runs on wgmma and TMA in
// flash_fwd_sm90.cu (d <= 256) and flash_fwd_sm90_dyn.cu (d > 256).
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_fwd):
//   online  -> _fwd_kernel           (rescale every k tile)
//   lazy    -> _fwd_kernel_lazy      (rescale only when a tile raises the
//                                     row max; k tiles diagonal-first)
//   twopass -> _fwd_kernel_twopass   (pass 1 row max, pass 2 accumulate)
//
// Contract (same as the TPU kernels): q/k/v are [b*h, s, d] contiguous
// fp32; O is fp32; lse is the natural-log row log-sum-exp, fp32, [b*h, sq]
// (one row per query, not the TPU's 8-sublane replicated layout). The
// products run in fp32 and O accumulates in fp32. The softmax runs in the
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
// What bounds it: 4*d operations per visible (q, k) pair against q, k, v
// read once and O written once; at 67 TFLOP/s of fp32 the CUDA cores are
// the bound at every shape the port runs (b4 h6 s1024 d256 causal: 0.1925
// ms). The products stay full fp32: no TF32, no split-TF32 (the
// reference-precision path is held to 2e-5).
//
// Design: an SGEMM's register blocking on both products. One CTA of 256
// threads per (b*h, 64-row q tile), walking 128-key tiles.
//  1. S = Q K^T for a 64 x 128 tile: thread (ty, tx) of a 16 x 16 grid owns
//     the 4 x 8 logits of rows ty + 16i and keys tx + 16j. Q (resident for
//     the CTA's rows) and K sit in shared memory row-major, rows padded by
//     4 floats (cp.async copies a row's 16-byte runs as they lie; k-major
//     would take the same loads per FMA at this micro-tile); per 4 columns
//     of d a thread reads its 4 Q rows and 8 K rows as float4 and does 128
//     FMAs. The old kernel took two scalar shared loads per FMA. These 12
//     loads take 1.2x the cycles of the 128 FMAs (the K reads, 16 rows a
//     warp, cost as much as 32 distinct float4s; flash_fwd_ab --probe), so
//     this loop is bound by shared memory.
//  2. O += P V the same way, in a layout of its own: P goes to a shared
//     64 x 128 tile, and a thread owns 8 of O's rows and d/32 columns from
//     d 128 on (4 x 4 at d 64, fewer below; float4 loads of V's rows); per
//     4 keys, 8 P and 8 V float4 reads feed 256 FMAs at d 256. The rows'
//     rescale alpha and final sum l reach O's layout through shared
//     memory.
//  3. The loads overlap the math: K and V stream through a 3-stage ring of
//     cp.async chunks (K: 128 keys x 32 columns of d; V: 4096 / d keys x d,
//     so each chunk is 18 KB or less whatever d), two chunks in flight
//     while a third is used, one __syncthreads a chunk. Q is 65 KB at
//     d 256, P 33, the ring 54: 153 KB, one CTA an SM.
//  4. On the causal diagonal the second half of a tile is past every row
//     of the q tile: its logits and its P V are skipped.
//  5. Row statistics are reduced by shuffles over the 16 lanes that share
//     a row of S (xor 1, 2, 4, 8 inside a half-warp).
// The kernel runs at about a third of the CUDA cores' rate (PERF.md
// sections 6-7): neither one CTA an SM or two, 256 threads or 512, warps
// specialised to S and to O, nor a kernel without its copies, changed that
// by more than a fifth; step 1's shared loads are the one limit measured.
//
// The lazy walk (tiles diagonal-first) raises m on every tile and takes
// no predicate: a row whose max did not rise gets alpha = exp2(m - m) = 1
// exactly, so rescaling it changes nothing, and the result is
// bit-identical to the TPU kernel's, which skips the rescale when no row
// of its block rises.

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

// Shared memory of the fp32 forward at head dim D, in floats: Q [64][D+4],
// P [64][132], the rows' alpha and l [64] each, and a ring of kStages
// chunks, each a K chunk [128][kDC+4] (128 keys, kDC columns of d) or a V
// chunk [kKC][D+4] (kKC keys, all of d): 18 KB or less whatever d.
template <int D>
struct CcPlan {
  static constexpr int kThreads = 256;
  static constexpr int kRows = kBlock;          // query rows a CTA
  static constexpr int kKeys = 2 * kBlock;      // keys a k tile
  static constexpr int kHalf = kBlock;          // keys of half a k tile
  // S: a thread owns kSI rows x kSJ keys, rows ty + kTY i, keys tx + kTX j
  static constexpr int kSI = 4;
  static constexpr int kSJ = 8;
  static constexpr int kTX = kKeys / kSJ;
  static constexpr int kTY = kRows / kSI;
  static constexpr int kDC = D < 32 ? D : 32;
  static constexpr int kKC = D >= 32 ? 4096 / D : kKeys;
  static constexpr int kQStride = D + 4;
  static constexpr int kKStride = kDC + 4;
  static constexpr int kVStride = D + 4;
  static constexpr int kPStride = kKeys + 4;
  static constexpr int kKChunks = D / kDC;
  static constexpr int kVChunks = kKeys / kKC;
  static constexpr int kStage = kKeys * kKStride > kKC * kVStride
                                    ? kKeys * kKStride
                                    : kKC * kVStride;
  static constexpr int kStages = 3;
  // O: a thread owns kRO rows x kCO columns, in kRowGroups x kColGroups
  static constexpr int kOPer = kRows * D / kThreads;
  static constexpr int kRO = kOPer >= 32 ? 8 : kOPer >= 8 ? 4 : 2;
  static constexpr int kCO = kOPer / kRO;
  static constexpr int kColGroups = D / kCO;
  static constexpr int kRowGroups = kThreads / kColGroups;
  static constexpr int kSmemBytes =
      4 * (kRows * kQStride + kRows * kPStride + 2 * kRows +
           kStages * kStage);
  static_assert(kRowGroups * kRO == kRows, "O's rows must tile the block");
  static_assert(kTX * kTY == kThreads && kTX <= 32 && kSJ % 4 == 0,
                "S's rows must stay inside a warp");
  static_assert(kKC % 4 == 0 && kDC % 4 == 0 && kKC <= kKeys,
                "chunks are read as float4");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (a row past the end)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the column of O that a thread's c-th accumulator holds: float4 groups
// 4 * kColGroups apart from 4 columns a thread on (neighbouring threads on
// neighbouring 16 bytes), else C adjacent columns
template <int D>
__device__ __forceinline__ int col_of(int cg, int c) {
  using P = CcPlan<D>;
  if constexpr (P::kCO >= 4)
    return 4 * cg + 4 * P::kColGroups * (c >> 2) + (c & 3);
  return P::kCO * cg + c;
}

// a thread's kCO columns of one row of V
template <int D>
__device__ __forceinline__ void load_cols(const float* row, int cg,
                                          float (&x)[CcPlan<D>::kCO]) {
  using P = CcPlan<D>;
  if constexpr (P::kCO >= 4) {
#pragma unroll
    for (int c = 0; c < P::kCO / 4; ++c) {
      const float4 f = *reinterpret_cast<const float4*>(
          row + 4 * cg + 4 * P::kColGroups * c);
      x[4 * c] = f.x;
      x[4 * c + 1] = f.y;
      x[4 * c + 2] = f.z;
      x[4 * c + 3] = f.w;
    }
  } else if constexpr (P::kCO == 2) {
    const float2 f = *reinterpret_cast<const float2*>(row + 2 * cg);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = row[cg];
  }
}

__device__ __forceinline__ float comp(const float4& f, int e) {
  return e == 0 ? f.x : e == 1 ? f.y : e == 2 ? f.z : f.w;
}

// reductions over the N lanes (tx) that share a row of S
template <int N>
__device__ __forceinline__ float row_lanes_max(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int N>
__device__ __forceinline__ float row_lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] += Q[ty + kTY i] . K[tx + kTX j] over one K chunk's kDC
// columns, for the first NJ of the thread's kSJ keys (kSJ / 2: the half of
// the tile that any row can see)
template <int D, int NJ>
__device__ __forceinline__ void logits_chunk(
    const float* kc, const float* qc, int tx, int ty,
    float (&s)[CcPlan<D>::kSI][CcPlan<D>::kSJ]) {
  using P = CcPlan<D>;
#pragma unroll
  for (int e = 0; e < P::kDC; e += 4) {
    float4 kv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      kv[j] = *reinterpret_cast<const float4*>(
          kc + (tx + P::kTX * j) * P::kKStride + e);
#pragma unroll
    for (int i = 0; i < P::kSI; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(
          qc + (ty + P::kTY * i) * P::kQStride + e);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
      }
    }
  }
}

template <int D, int V>
__global__ void __launch_bounds__(CcPlan<D>::kThreads, 1)
flash_fwd_cc_kernel(Params p) {
  using P = CcPlan<D>;
  constexpr int kChunks = P::kKChunks + P::kVChunks;   // of a K+V item
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sP = sQ + P::kRows * P::kQStride;
  float* sAlpha = sP + P::kRows * P::kPStride;
  float* sL = sAlpha + P::kRows;
  float* sRing = sL + P::kRows;

  constexpr int kSI = P::kSI;
  constexpr int kSJ = P::kSJ;
  const int tid = threadIdx.x;
  // S: rows ty + kTY i, keys tx + kTX j
  const int tx = tid % P::kTX;
  const int ty = tid / P::kTX;
  // O: rows rg + kRowGroups * i, columns col_of(cg, c)
  const int cg = tid % P::kColGroups;
  const int rg = tid / P::kColGroups;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float* q = static_cast<const float*>(p.q) +
                   static_cast<size_t>(bh) * p.sq * D;
  const float* k = static_cast<const float*>(p.k) +
                   static_cast<size_t>(bh) * p.sk * D;
  const float* v = static_cast<const float*>(p.v) +
                   static_cast<size_t>(bh) * p.sk * D;
  const int nk_total = (p.sk + P::kKeys - 1) / P::kKeys;
  const int nk = p.causal ? min(((qi + 1) * P::kRows + P::kKeys - 1) /
                                    P::kKeys,
                                nk_total)
                          : nk_total;

  // items of the walk: online visits k tiles 0 .. nk-1 with V, lazy
  // nk-1 .. 0 with V; twopass visits 0 .. nk-1 with K alone, then
  // 0 .. nk-1 with K and V. The ring carries their chunks in that order:
  // an item's K chunks, then (with V) its V chunks.
  auto tile_of = [&](int i) {
    return V == kLazy ? nk - 1 - i : (i < nk ? i : i - nk);
  };
  // whether no row of the q tile sees the second half of item i's keys
  // (past the causal diagonal, or past sk)
  auto half_of = [&](int i) {
    const int key = tile_of(i) * P::kKeys + P::kHalf;
    return (p.causal && key > qi * P::kRows + P::kRows - 1) || key >= p.sk;
  };
  const int k_only = V == kTwopass ? nk * P::kKChunks : 0;
  const int n_chunks = k_only + nk * kChunks;

  // cp.async of chunk n of the walk into its ring stage
  auto issue = [&](int n) {
    int item, c;
    if (n < k_only) {
      item = n / P::kKChunks;
      c = n % P::kKChunks;
    } else {
      item = (V == kTwopass ? nk : 0) + (n - k_only) / kChunks;
      c = (n - k_only) % kChunks;
    }
    const int row0 = tile_of(item) * P::kKeys;
    float* dst = sRing + (n % P::kStages) * P::kStage;
    if (c < P::kKChunks) {
      constexpr int kF = P::kDC / 4;
      for (int e = tid; e < P::kKeys * kF; e += P::kThreads) {
        const int r = e / kF;
        const int f = e % kF;
        const bool ok = row0 + r < p.sk;
        cp_async16(dst + r * P::kKStride + 4 * f,
                   ok ? k + static_cast<size_t>(row0 + r) * D + c * P::kDC +
                            4 * f
                      : k,
                   ok);
      }
    } else {
      constexpr int kF = D / 4;
      const int key0 = row0 + (c - P::kKChunks) * P::kKC;
      for (int e = tid; e < P::kKC * kF; e += P::kThreads) {
        const int r = e / kF;
        const int f = e % kF;
        const bool ok = key0 + r < p.sk;
        cp_async16(dst + r * P::kVStride + 4 * f,
                   ok ? v + static_cast<size_t>(key0 + r) * D + 4 * f : v,
                   ok);
      }
    }
  };

  // Q for the CTA's rows, then the first kStages - 1 chunks, each its own
  // group
  for (int e = tid; e < P::kRows * (D / 4); e += P::kThreads) {
    const int r = e / (D / 4);
    const int f = e % (D / 4);
    const bool ok = qi * P::kRows + r < p.sq;
    cp_async16(sQ + r * P::kQStride + 4 * f,
               ok ? q + static_cast<size_t>(qi * P::kRows + r) * D + 4 * f
                  : q,
               ok);
  }
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < P::kStages - 1; ++st) {
    if (st < n_chunks) issue(st);
    cp_async_commit();
  }
  // the next chunk of the walk, arrived and visible to every thread; the
  // stage it frees (used by the chunk before it) is refilled
  int next_n = 0;
  auto next_chunk = [&]() {
    cp_async_wait<P::kStages - 2>();
    __syncthreads();
    if (next_n + P::kStages - 1 < n_chunks) issue(next_n + P::kStages - 1);
    cp_async_commit();
    const float* buf = sRing + (next_n % P::kStages) * P::kStage;
    ++next_n;
    return buf;
  };

  float m[kSI], l[kSI];   // S's rows; l partial: this thread's keys
  float acc[P::kRO][P::kCO];   // O's rows
#pragma unroll
  for (int i = 0; i < kSI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < P::kRO; ++i)
#pragma unroll
    for (int c = 0; c < P::kCO; ++c) acc[i][c] = 0.f;

  // the masked log2-unit logits of item i
  auto logits = [&](int item, float (&s)[kSI][kSJ]) {
#pragma unroll
    for (int i = 0; i < kSI; ++i)
#pragma unroll
      for (int j = 0; j < kSJ; ++j) s[i][j] = 0.f;
    const bool half = half_of(item);
#pragma unroll 1
    for (int c = 0; c < P::kKChunks; ++c) {
      const float* kc = next_chunk();
      if (half)
        logits_chunk<D, kSJ / 2>(kc, sQ + c * P::kDC, tx, ty, s);
      else
        logits_chunk<D, kSJ>(kc, sQ + c * P::kDC, tx, ty, s);
    }
    const int kb = tile_of(item);
#pragma unroll
    for (int i = 0; i < kSI; ++i) {
      const int row = qi * P::kRows + ty + P::kTY * i;
#pragma unroll
      for (int j = 0; j < kSJ; ++j) {
        const int col = kb * P::kKeys + tx + P::kTX * j;
        const bool keep = col < p.sk && (!p.causal || col <= row);
        s[i][j] = keep ? s[i][j] * p.scale2 : kNegInf;
      }
    }
  };

  auto row_max = [&](const float (&s)[kSI][kSJ], int i) {
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < kSJ; ++j) mx = fmaxf(mx, s[i][j]);
    return row_lanes_max<P::kTX>(mx);
  };

  // p = exp2(s - m) into l and the shared P tile (and alpha for O's
  // rows), then acc = acc * alpha + P V over the item's V chunks
  auto accumulate = [&](int item, const float (&s)[kSI][kSJ],
                        bool rescale) {
#pragma unroll
    for (int i = 0; i < kSI; ++i) {
#pragma unroll
      for (int j = 0; j < kSJ; ++j) {
        const float pv = exp2f(s[i][j] - m[i]);
        l[i] += pv;
        sP[(ty + P::kTY * i) * P::kPStride + tx + P::kTX * j] = pv;
      }
    }
    // P's and alpha's writes are made visible by the barrier in
    // next_chunk; the next item writes them only after its K chunks'
    // barriers, when every thread is past these reads
    const int keys = half_of(item) ? P::kHalf : P::kKeys;
#pragma unroll 1
    for (int c = 0; c < P::kVChunks; ++c) {
      const float* vc = next_chunk();
      if (c == 0 && rescale) {
#pragma unroll
        for (int i = 0; i < P::kRO; ++i) {
          const float a = sAlpha[rg + P::kRowGroups * i];
#pragma unroll
          for (int c2 = 0; c2 < P::kCO; ++c2) acc[i][c2] *= a;
        }
      }
      const int key0 = c * P::kKC;
      const float* pc = sP + key0;
#pragma unroll
      for (int e = 0; e < P::kKC; e += 4) {
        if (key0 + e >= keys) break;   // the half no row sees
        float4 pr[P::kRO];
#pragma unroll
        for (int i = 0; i < P::kRO; ++i)
          pr[i] = *reinterpret_cast<const float4*>(
              pc + (rg + P::kRowGroups * i) * P::kPStride + e);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float x[P::kCO];
          load_cols<D>(vc + (e + jj) * P::kVStride, cg, x);
#pragma unroll
          for (int i = 0; i < P::kRO; ++i) {
            const float pj = comp(pr[i], jj);
#pragma unroll
            for (int c2 = 0; c2 < P::kCO; ++c2)
              acc[i][c2] = fmaf(pj, x[c2], acc[i][c2]);
          }
        }
      }
    }
  };

  // Online and lazy raise m on every tile (the lazy walk's lack of a
  // predicate: see the design notes); O's rows take alpha through shared
  // memory.
  float s[kSI][kSJ];
  if constexpr (V == kOnline || V == kLazy) {
    for (int it = 0; it < nk; ++it) {
      logits(it, s);
#pragma unroll
      for (int i = 0; i < kSI; ++i) {
        const float mx = fmaxf(m[i], row_max(s, i));
        const float alpha = exp2f(m[i] - mx);
        l[i] *= alpha;
        m[i] = mx;
        if (tx == 0) sAlpha[ty + P::kTY * i] = alpha;
      }
      accumulate(it, s, true);
    }
  } else {
    for (int it = 0; it < nk; ++it) {
      logits(it, s);
#pragma unroll
      for (int i = 0; i < kSI; ++i) m[i] = fmaxf(m[i], row_max(s, i));
    }
    for (int it = nk; it < 2 * nk; ++it) {
      logits(it, s);
      accumulate(it, s, false);
    }
  }

#pragma unroll
  for (int i = 0; i < kSI; ++i) {
    const float lr = fmaxf(row_lanes_sum<P::kTX>(l[i]), 1e-30f);
    const int row = qi * P::kRows + ty + P::kTY * i;
    if (tx == 0) {
      sL[ty + P::kTY * i] = lr;
      if (row < p.sq)
        p.lse[static_cast<size_t>(bh) * p.sq + row] =
            (m[i] + log2f(lr)) * kLn2;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < P::kRO; ++i) {
    const int r = rg + P::kRowGroups * i;
    const int row = qi * P::kRows + r;
    if (row < p.sq) {
      const float lr = sL[r];
      float* o = static_cast<float*>(p.o) +
                 (static_cast<size_t>(bh) * p.sq + row) * D;
#pragma unroll
      for (int c = 0; c < P::kCO; ++c) o[col_of<D>(cg, c)] = acc[i][c] / lr;
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch

template <int D, int V>
cudaError_t launch(int bh, const Params& p, cudaStream_t stream) {
  using P = CcPlan<D>;
  auto kernel = flash_fwd_cc_kernel<D, V>;
  static std::atomic<uint32_t> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, P::kSmemBytes, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + P::kRows - 1) / P::kRows, bh);
  kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(p);
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
// fp32 at d 16/32/64/128/256 (bf16 runs on hvd_flash_fwd_sm90 and
// hvd_flash_fwd_sm90_dyn); dtype must be 0. variant: 0 online, 1 lazy,
// 2 twopass.
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
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return dispatch<16>(variant, bh, p, stream);
    case 32: return dispatch<32>(variant, bh, p, stream);
    case 64: return dispatch<64>(variant, bh, p, stream);
    case 128: return dispatch<128>(variant, bh, p, stream);
    case 256: return dispatch<256>(variant, bh, p, stream);
  }
  return cudaErrorInvalidValue;
}

// Keys per k tile of the fp32 forward's walk, the same at every d: the
// plain version walks these tiles (a tool reads it from a built library).
extern "C" int hvd_flash_fwd_block_k() { return CcPlan<256>::kKeys; }
