// Flash-attention forward for Hopper (sm_90a) on wgmma and TMA at head dims
// above 256, with d taken at run time: the bf16 walks from d 264 to 1024.
//
// Replaces, in bf16 at d > 256, the Pallas TPU kernels behind
// pl.pallas_call in horovod_tpu/ops/flash_attention.py (_flash_fwd):
//   online  -> _fwd_kernel           (:129)
//   lazy    -> _fwd_kernel_lazy      (:220)
//   twopass -> _fwd_kernel_twopass   (:312)
// fp32 at every d above 256, and bf16 above 1024 (where Q of one 64-row
// tile no longer fits beside the rings), stay on flash_dyn.cu's
// flash_fwd_dyn_kernel.
//
// Contract (flash_fwd_sm90.cu's): q/k/v are [b*h, s, d] contiguous bf16,
// d a multiple of 8 (the tensor maps' row stride must be a multiple of 16
// bytes; the host zero-pads any other d, the softmax scale of the true d
// in scale2); O is bf16; lse the natural-log row log-sum-exp, fp32,
// [b*h, sq]. Logits in the exp2 domain with log2(e) folded into the
// scale, the finite -1e30 mask sentinel, the causal k loop stopping at the
// diagonal tile, P rounded to bf16 before P@V while l takes it unrounded.
//
// What bounds it. 4*d operations per visible (q, k) pair against q, k, v
// read once and O written once: at b4 h6 s1024 d384 causal, 19.3 G
// operations (0.0196 ms at 989 TFLOP/s) and 75.6 MB (0.0226 ms at 3.35
// TB/s), so the bytes. The slices' recompute of S (design, 2) raises the
// work this kernel does to 6*d, 29.0 G operations (0.0293 ms), above the
// bytes. flash_fwd_dyn_kernel, which this replaces there,
// took 4.3-6.5 ms: scalar dot products on the CUDA cores with both
// operands reloaded into shared memory for every 64-column chunk. This
// kernel: 0.081-0.098 ms online and lazy, 0.133-0.137 twopass, against
// SDPA's forward at 0.20-0.21 (PERF.md section 6; H100 80GB HBM3, 700 W).
// Registers 202 (4-box slices) and 170 (3-box) with one consumer
// warpgroup, 168 at the launch bound with two; no spill (nvcc -Xptxas -v,
// sm_90a; chip_smoke.py phase 1 fails on a spill).
//
// Design (the d-256 kernel's, flash_fwd_sm90.cu, with the output columns
// split over the grid):
//  1. One CTA per (b*h, 64*NWG query rows, slice of V's columns). O of a
//     whole row at d 384 would be 192 fp32 registers a thread; a slice of
//     NB 64-column boxes (NB = 3 or 4: at most 256 columns) keeps O at
//     m64n192 or m64n256, 96 or 128 registers, the register plan that the
//     d-256 kernel compiles at 204-206. d is cut into nbox = ceil(d / 64)
//     boxes and the boxes into slices = ceil(nbox / 4) slices of
//     NB = ceil(nbox / slices): d 288 and 384 in 2 slices of 3 boxes, 512
//     in 2 of 4, 1024 in 4 of 4. The slices of one q tile are adjacent in
//     the grid (blockIdx.x % slices), so they read the same K tiles from
//     L2 at about the same time.
//  2. Every slice computes S = Q K^T over the whole d: 64-key tiles, S
//     m64n64 (32 registers), four k16 steps a box. Q for the CTA's rows
//     stays in shared memory (nbox boxes, TMA, 128 B swizzle); K streams
//     box by box through a ring of 4 boxes, each box its own wgmma group,
//     released once the group after it has been issued and the wait has
//     seen it through (so a ring shorter than a K tile never stalls); V
//     streams the slice's NB boxes a tile through a ring of 2 stages.
//     Every slice runs the same instruction sequence over the same boxes,
//     so m, l, the lazy walk's per-warp vote and the twopass maximum are
//     bit-equal across slices; slice 0 alone writes lse. The cost is S
//     once per slice: 6*d operations per visible pair at d 288-384 instead
//     of 4*d, 8*d at d 512-1024.
//  3. Copy, softmax and products overlap as in the d-256 kernel: one
//     producer thread keeps TMA loads in flight; tile i's Q K^T is issued
//     ahead of tile i-1's P@V and tile i's softmax runs under that P@V;
//     the first tile is peeled so that every wgmma wait is unconditional.
//     Two consumer warpgroups (128 query rows) when the grid of slices
//     fills the SMs and Q for 128 rows fits (d <= 576), else one (64
//     rows); the host picks (ops/flash_attention.py, sm90dyn_cta_rows)
//     and a caller may force either where both fit. The two share every K
//     box and V slice and issue each on its own: they cannot take turns
//     as in the d-256 kernel, since a warpgroup that held the turn through
//     its Q K^T would wait for K boxes that only the other's releases
//     free (the ring holds 4 of a tile's 5-16 boxes).
//
// A partial last box. The tensor maps span the true d (rows of d * 2
// bytes), so TMA zero-fills the columns of the last box past d: they add
// nothing to Q K^T, and O's columns past d are never stored. A slice box
// wholly past d (d 640: 10 boxes in 3 slices of 4) is not loaded; its
// columns of O hold whatever P times stale shared memory gives and are not
// stored either (a column of O mixes with no other).
//
// Shared memory: Q nbox * 64 * NWG rows * 128 B, K 4 x 8 KB, V 2 x NB x
// 8 KB, barriers: at d 1024 with one consumer warpgroup 128 + 32 + 64 KB
// (225 KB of the 227 a block may use), the ceiling of this kernel; two
// consumer warpgroups fit up to d 576 (9 boxes: 144 + 32 + 48 KB).
//
// Masks, the dead tiles of the lazy walk at 128 rows and the -1e30
// sentinel: as flash_fwd_sm90.cu (kDeadTiles there). The lazy predicate is
// taken per warp, bit-identical to the TPU kernel's per-block one.

#include "flash_sm90.cuh"

namespace {

// flash_fwd.cu's variant numbers
enum Walk { kOnlineWalk = 0, kLazyWalk = 1, kTwopassWalk = 2 };

constexpr int kWgRows = 64;         // query rows per consumer warpgroup
constexpr int kKeys = 64;           // keys per k tile
constexpr int kBoxCols = 64;        // columns per TMA box (128 B of bf16)
constexpr int kBoxBytes = kKeys * 128;   // one box of a 64-row tile
constexpr int kKStages = 4;         // K boxes in flight
constexpr int kVStages = 2;         // V slices in flight
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr int kMaxBoxes = 16;       // d <= 1024
constexpr int kBarBytes = 8 * (1 + 2 * kKStages + 2 * kVStages);
static_assert(kBarBytes <= 128, "barriers must fit 128 bytes");

// boxes of d, slices of the boxes, boxes a slice
__host__ __device__ inline int boxes_of(int d) {
  return (d + kBoxCols - 1) / kBoxCols;
}
inline int slices_of(int nbox) { return (nbox + 3) / 4; }
inline int nb_of(int nbox) {
  const int z = slices_of(nbox);
  return (nbox + z - 1) / z;
}

// Q | K ring | V ring | barriers; every tile a multiple of 1024 B, the
// base aligned to 1024 in the kernel (hence the slack)
__host__ __device__ inline int k_off(int nbox, int nwg) {
  return nbox * kWgRows * nwg * 128;
}
__host__ __device__ inline int v_off(int nbox, int nwg) {
  return k_off(nbox, nwg) + kKStages * kBoxBytes;
}
__host__ __device__ inline int bar_off(int nbox, int nb, int nwg) {
  return v_off(nbox, nwg) + kVStages * nb * kBoxBytes;
}
inline int smem_bytes(int nbox, int nb, int nwg) {
  return bar_off(nbox, nb, nwg) + 128 + 1024;
}

struct DynSm90Params {
  void* o;
  float* lse;
  int sq;
  int sk;
  int d;
  int nbox;
  int slices;
  float scale2;   // softmax scale * log2(e)
  int causal;
};

// One CTA per (b*h, q tile of 64*NWG rows, slice of NB boxes of V's
// columns); warpgroup 0 produces (one thread issues every TMA load),
// warpgroups 1..NWG consume. Accumulator layout as flash_fwd_sm90.cu.
template <int NB, int W, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_sm90dyn_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         DynSm90Params p) {
  constexpr int kQRows = kWgRows * NWG;
  constexpr int kN = NB * kBoxCols;     // O columns of the slice
  constexpr int kSN = kKeys / 2;        // S accumulators per thread
  // the upper warpgroup of 128 query rows meets 64-key tiles wholly past
  // its causal diagonal (flash_fwd_sm90.cu's kDeadTiles)
  constexpr bool kDeadTiles = kQRows > kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nbox = p.nbox;
  const uint32_t sQ = base;
  const uint32_t sK = base + k_off(nbox, NWG);
  const uint32_t sV = base + v_off(nbox, NWG);
  const uint32_t bars = base + bar_off(nbox, NB, NWG);
  const uint32_t full_q = bars;
  auto full_k = [&](int st) { return bars + 8u * (1 + st); };
  auto empty_k = [&](int st) { return bars + 8u * (1 + kKStages + st); };
  auto full_v = [&](int st) {
    return bars + 8u * (1 + 2 * kKStages + st);
  };
  auto empty_v = [&](int st) {
    return bars + 8u * (1 + 2 * kKStages + kVStages + st);
  };

  // the slices of one q tile adjacent; heaviest (latest) causal q tiles
  // first
  const int slice = blockIdx.x % p.slices;
  const int qt = gridDim.x / p.slices - 1 - blockIdx.x / p.slices;
  const int bh = blockIdx.y;
  const int nk_total = (p.sk + kKeys - 1) / kKeys;
  const int nk = p.causal
                     ? min(((qt + 1) * kQRows + kKeys - 1) / kKeys, nk_total)
                     : nk_total;
  // items of the walk: online visits k tiles 0 .. nk-1 with V, lazy
  // nk-1 .. 0 with V; twopass visits 0 .. nk-1 with K alone, then
  // 0 .. nk-1 with K and V. Item i's K boxes are boxes i*nbox .. of the
  // K ring's sequence.
  const int n_items = W == kTwopassWalk ? 2 * nk : nk;
  auto tile_of = [&](int i) {
    return W == kLazyWalk ? nk - 1 - i : (i < nk ? i : i - nk);
  };
  auto with_v = [&](int i) { return W != kTwopassWalk || i >= nk; };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kKStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(empty_k(st), 4 * NWG);   // one arrival per consumer warp
    }
    for (int st = 0; st < kVStages; ++st) {
      mbar_init(full_v(st), 1);
      mbar_init(empty_v(st), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, nbox * kQRows * 128);
      for (int b = 0; b < nbox; ++b)
        tma_load(sQ + b * kQRows * 128, &tq, full_q, b * kBoxCols,
                 qt * kQRows, bh);
      // the slice's boxes of V that hold any of d's columns
      const int v_box0 = slice * NB;
      const int v_boxes = min(NB, nbox - v_box0);
      int kc = 0;
      for (int i = 0; i < n_items; ++i) {
        const int row = tile_of(i) * kKeys;
        for (int b = 0; b < nbox; ++b, ++kc) {
          const int st = kc % kKStages;
          mbar_wait(empty_k(st), ((kc / kKStages) & 1) ^ 1);
          mbar_expect_tx(full_k(st), kBoxBytes);
          tma_load(sK + st * kBoxBytes, &tk, full_k(st), b * kBoxCols, row,
                   bh);
        }
        const int vs = i % kVStages;
        mbar_wait(empty_v(vs), ((i / kVStages) & 1) ^ 1);
        if (with_v(i)) {
          mbar_expect_tx(full_v(vs), v_boxes * kBoxBytes);
          for (int h = 0; h < v_boxes; ++h)
            tma_load(sV + (vs * NB + h) * kBoxBytes, &tv, full_v(vs),
                     (v_box0 + h) * kBoxCols, row, bh);
        } else {
          mbar_arrive(full_v(vs));   // keeps the V phases in step
        }
      }
    }
  } else {
    // ---------------- consumers
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;   // consumer warpgroup
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wg_row0 = qt * kQRows + cw * kWgRows;
    const int row0 = wg_row0 + warp * 16 + g;   // this thread's rows: row0, +8

    // Q and K are K-major (d contiguous), V MN-major (keys along K)
    auto q_desc = [&](int b, int kk) {
      return gmma_desc(sQ + b * kQRows * 128 + cw * kWgRows * 128 + kk * 32,
                       16, 1024, 1);
    };
    auto k_desc = [&](int st, int kk) {
      return gmma_desc(sK + st * kBoxBytes + kk * 32, 16, 1024, 1);
    };
    auto v_desc = [&](int vs, int kk) {
      return gmma_desc(sV + vs * NB * kBoxBytes + kk * 16 * 128, kBoxBytes,
                       1024, 1);
    };

    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};   // this thread's partial row sums
    float o[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;

    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the last K box of item i, once the wait after its group has seen it
    // through
    auto release_last_k = [&](int i) {
      arrive(empty_k((i * nbox + nbox - 1) % kKStages));
    };

    // S = Q K^T of item i: box by box, each box one wgmma group; every
    // box but the last is released as soon as the next box's group has
    // been issued and the previous one waited for. The first box is
    // peeled (its first k-step overwrites S, the others accumulate) and S
    // is fenced around every wait: with the accumulate flag taken at run
    // time inside the loop, ptxas serialized every product (C7515).
    auto issue_qk = [&](int i, float (&s)[kSN]) {
      int kc = i * nbox;
      {
        const int st = kc % kKStages;
        mbar_wait(full_k(st), (kc / kKStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<kKeys>::run(s, q_desc(0, kk), k_desc(st, kk), kk > 0);
        wgmma_commit();
      }
      fence_regs(s);
      for (int b = 1; b < nbox; ++b) {
        ++kc;
        const int st = kc % kKStages;
        mbar_wait(full_k(st), (kc / kKStages) & 1);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<kKeys>::run(s, q_desc(b, kk), k_desc(st, kk), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        arrive(empty_k((kc - 1) % kKStages));
      }
    };

    // O += P V of item i over the slice: waits for its V boxes, issues one
    // wgmma group
    uint32_t pa[kKeys / 16][4];   // P of the item whose P@V is next
    auto issue_pv = [&](int i) {
      const int vs = i % kVStages;
      mbar_wait(full_v(vs), (i / kVStages) & 1);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        WgmmaRS<kN>::run(o, pa[kk], v_desc(vs, kk));
      wgmma_commit();
    };

    // item i's S, done, masked (raw units: the scale is folded into the
    // exponent)
    auto mask = [&](int i, float (&s)[kSN]) {
      fence_regs(s);
      const int col0 = tile_of(i) * kKeys;
      const bool masked = (p.causal && col0 + kKeys - 1 > wg_row0) ||
                          col0 + kKeys > p.sk;
      if (masked) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + 8 * j + 2 * t + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            const bool keep = col < p.sk && (!p.causal || col <= row);
            s[4 * j + e] = keep ? s[4 * j + e] : kNegInf;
          }
        }
      }
    };
    // this thread's max of row r of a masked S, in log2 units
    auto row_max = [&](const float (&s)[kSN], int r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      return mx * p.scale2;
    };

    // logits to p = exp2(s - m) in place, after raising m: on every tile
    // in the online walk, after the lazy walk's vote (per warp); returns
    // whether o and l need alpha
    auto probs = [&](int i, float (&s)[kSN], float (&alpha)[2]) {
      mask(i, s);
      bool rescale = false;
      if constexpr (W == kOnlineWalk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(row_max(s, r)));
          alpha[r] = exp2f(m[r] - mn);
          m[r] = mn;
        }
        rescale = true;
      } else if constexpr (W == kLazyWalk) {
        float mt[2];
        bool rises = false;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = quad_max(row_max(s, r));
          rises |= mt[r] > m[r];
        }
        rescale = __any_sync(0xffffffffu, rises);
        if (rescale) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[r], mt[r]);
            alpha[r] = exp2f(m[r] - mn);
            m[r] = mn;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSN; ++j)
        s[j] = fast_exp2(fmaf(s[j], p.scale2, -m[(j >> 1) & 1]));
      if constexpr (kDeadTiles) {
        // a row whose keys so far are all masked: p 0 here, where the
        // plain walk's p = 1 is cleared by the next tile's alpha = 0
        const float dead = 0.5f * kNegInf * p.scale2;
#pragma unroll
        for (int j = 0; j < kSN; ++j)
          s[j] = m[(j >> 1) & 1] > dead ? s[j] : 0.f;
      }
      return rescale;
    };

    // with the previous P@V done: o and l times alpha, l += rowsum(p),
    // p rounded to bf16 as the next P@V's A fragments
    auto fold = [&](const float (&s)[kSN], bool rescale,
                    const float (&alpha)[2]) {
      if (W == kOnlineWalk || rescale) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] *= alpha[r];
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
            o[4 * j + 2 * r] *= alpha[r];
            o[4 * j + 2 * r + 1] *= alpha[r];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSN; ++j) l[(j >> 1) & 1] += s[j];
      acc_to_frags(pa, s);
    };

    // the accumulating walk over items [first, n_items), the first item
    // peeled so that every wait is unconditional
    auto accumulate = [&](int first) {
      float s[kSN];
      float alpha[2] = {1.f, 1.f};
      issue_qk(first, s);
      wgmma_wait<0>();
      release_last_k(first);
      fold(s, probs(first, s, alpha), alpha);
      for (int i = first + 1; i < n_items; ++i) {
        issue_qk(i, s);
        issue_pv(i - 1);
        wgmma_wait<1>();   // S done; the previous P@V runs on
        release_last_k(i);
        const bool rescale = probs(i, s, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        arrive(empty_v((i - 1) % kVStages));
        fold(s, rescale, alpha);
      }
      issue_pv(n_items - 1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      arrive(empty_v((n_items - 1) % kVStages));
    };

    mbar_wait(full_q, 0);
    if constexpr (W != kTwopassWalk) {
      accumulate(0);
    } else {
      // pass 1: row max only, K stream alone
      for (int i = 0; i < nk; ++i) {
        float s[kSN];
        issue_qk(i, s);
        wgmma_wait<0>();
        release_last_k(i);
        mask(i, s);
        m[0] = fmaxf(m[0], row_max(s, 0));
        m[1] = fmaxf(m[1], row_max(s, 1));
        arrive(empty_v(i % kVStages));
      }
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
      // pass 2: accumulate against the final max, no correction
      accumulate(nk);
    }

    const int col0 = slice * kN;
    __nv_bfloat16* o_out = static_cast<__nv_bfloat16*>(p.o) +
                           static_cast<size_t>(bh) * p.sq * p.d;
    float* lse = p.lse + static_cast<size_t>(bh) * p.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
      const int row = row0 + 8 * r;
      if (row < p.sq) {
        const float inv = 1.f / lr;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int col = col0 + 8 * j + 2 * t;
          if (col < p.d)
            *reinterpret_cast<uint32_t*>(
                o_out + static_cast<size_t>(row) * p.d + col) =
                pack_f2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        if (slice == 0 && t == 0) lse[row] = (m[r] + log2f(lr)) * kLn2;
      }
    }
  }
}

template <int NB, int W, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, int bh,
                   const DynSm90Params& p, cudaStream_t stream) {
  constexpr int kQRows = kWgRows * NWG;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map_cols(&tq, q, p.d, p.sq, bh, kBoxCols, kQRows);
  if (err == cudaSuccess)
    err = make_map_cols(&tk, k, p.d, p.sk, bh, kBoxCols, kKeys);
  if (err == cudaSuccess)
    err = make_map_cols(&tv, v, p.d, p.sk, bh, kBoxCols, kKeys);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90dyn_kernel<NB, W, NWG>;
  // opted in once to the most a block may use: a launch's smem depends on d
  static std::atomic<uint32_t> opted_in{0};
  err = opt_in_smem(kernel, kMaxSmem, opted_in);
  if (err != cudaSuccess) return err;
  const int nq = (p.sq + kQRows - 1) / kQRows;
  dim3 grid(nq * p.slices, bh);
  kernel<<<grid, 128 * (NWG + 1), smem_bytes(p.nbox, NB, NWG), stream>>>(
      tq, tk, tv, p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int NB, int NWG>
cudaError_t dispatch_walk(const void* q, const void* k, const void* v,
                          int bh, int walk, const DynSm90Params& p,
                          cudaStream_t stream) {
  if (walk == kOnlineWalk)
    return launch<NB, kOnlineWalk, NWG>(q, k, v, bh, p, stream);
  if (walk == kLazyWalk)
    return launch<NB, kLazyWalk, NWG>(q, k, v, bh, p, stream);
  return launch<NB, kTwopassWalk, NWG>(q, k, v, bh, p, stream);
}

}  // namespace

// Plain C entry point (no PyTorch headers here: they stay in bindings.cpp).
// bf16 only, 256 < d <= 1024 with d a multiple of 8. variant: 0 online,
// 1 lazy, 2 twopass. cta_rows: query rows per CTA, 64 (one consumer
// warpgroup) or 128 (two; d <= 576, where Q for 128 rows fits). q, k, v, o
// contiguous and 16-byte aligned (the caller checks). Returns a
// configuration error; the launch itself is checked by the caller with
// cudaGetLastError.
extern "C" cudaError_t hvd_flash_fwd_sm90_dyn(const void* q, const void* k,
                                              const void* v, void* o,
                                              float* lse, int bh, int sq,
                                              int sk, int d, int variant,
                                              int causal, float scale2,
                                              int cta_rows,
                                              cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535 || d <= 256 ||
      d % 8 || variant < kOnlineWalk || variant > kTwopassWalk ||
      (cta_rows != 64 && cta_rows != 128))
    return cudaErrorInvalidValue;
  const int nbox = boxes_of(d);
  const int nb = nb_of(nbox);
  const int nwg = cta_rows / kWgRows;
  if (nbox > kMaxBoxes || smem_bytes(nbox, nb, nwg) > kMaxSmem)
    return cudaErrorInvalidValue;
  DynSm90Params p{o, lse, sq, sk, d, nbox, slices_of(nbox), scale2, causal};
  if (nb == 3)
    return nwg == 2 ? dispatch_walk<3, 2>(q, k, v, bh, variant, p, stream)
                    : dispatch_walk<3, 1>(q, k, v, bh, variant, p, stream);
  return nwg == 2 ? dispatch_walk<4, 2>(q, k, v, bh, variant, p, stream)
                  : dispatch_walk<4, 1>(q, k, v, bh, variant, p, stream);
}
