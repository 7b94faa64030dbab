// Flash-attention forward for Hopper (sm_90a) on wgmma, TMA and a
// producer/consumer pipeline: every bf16 walk.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_fwd), in bf16:
//   online  -> _fwd_kernel           (:129; k tiles ascending, m, l and O
//                                     rescaled on every tile)
//   lazy    -> _fwd_kernel_lazy      (:220; rescale only when a tile raises
//                                     the row max; k tiles diagonal-first)
//   twopass -> _fwd_kernel_twopass   (:312; pass 1 row max over K alone,
//                                     pass 2 accumulates against it)
// The fp32 variants stay on the CUDA cores in flash_fwd.cu.
//
// Contract (flash_fwd.cu's): q/k/v are [b*h, s, d] contiguous bf16,
// d in {16, 32, 64, 128, 256}; O is bf16; lse is the natural-log row
// log-sum-exp, fp32, [b*h, sq]. The softmax runs in the exp2 domain with
// log2(e) folded into the logit scale; masked logits take the finite
// sentinel -1e30, never -inf. The causal k loop stops at the diagonal
// tile. P is rounded to bf16 before P@V, as the TPU kernel does.
//
// What bounds it. 4*d operations per visible (q, k) pair against q, k, v
// read once and O written once. At the training shape (b16 h6 d128 causal
// s1024) that is 25.8 G operations and 101 MB, 0.0261 ms at 989 TFLOP/s
// and 0.0302 ms at 3.35 TB/s: both within 15 % of each other, so the
// kernel has to be fed at the tensor cores' rate to reach either. At the
// serving shape (b1 h6 s960) the bound is 1.8 us, under a launch: there
// the grid is 90 CTAs or fewer on 132 SMs and the time is the latency of
// one CTA's walk over its k tiles.
//
// Design, against what held the mma.sync kernel back:
//  1. Both products on wgmma. S = Q K^T is wgmma.m64n128k16 with Q and K
//     read from shared memory through descriptors; O += P V is
//     wgmma.m64nDk16 with P in registers (the S accumulators, exp2'd and
//     rounded to bf16, are the A fragments as they stand) and V read from
//     shared memory with the B-transpose bit, so nothing is transposed by
//     hand. Each consumer warpgroup owns 64 query rows.
//  2. No operand passes through the registers on its way to the tensor
//     cores: TMA writes Q, K and V in the swizzled layout the wgmma
//     descriptors name (128 B swizzle for d >= 64, d = 128 as two 64-column
//     boxes; 64 B at d = 32; 32 B at d = 16), where the old kernel spent
//     ~384 scalar shared-memory loads per thread per k tile.
//  3. Copy and softmax overlap the products. One producer thread issues
//     the TMA loads of Q once and of K/V into a ring of three stages ahead
//     of the consumers, with a full barrier per operand and an empty
//     barrier per stage, walking the consumers' order (ascending for
//     online; descending for lazy; K alone, then K and V, for twopass).
//     No __syncthreads after the roles split. Inside a consumer
//     warpgroup, tile i's Q K^T is issued ahead of tile i-1's P@V, so tile
//     i's softmax runs while that P@V is on the tensor cores; the first
//     tile is peeled so that every wgmma wait is unconditional (ptxas
//     serializes the products when the O rescale sits behind a branch it
//     cannot tie to the wait). The online walk's rescale of O by
//     alpha = exp2(m_old - m_new) has no branch at all: it runs on every
//     tile in the slot where lazy's runs after its vote, after tile i-1's
//     P@V has completed and before tile i's is issued. Two consumer
//     warpgroups take turns to issue (named barriers), so one's softmax
//     runs under the other's products. exp2 is one ex2.approx.ftz with the
//     logit scale folded into an FFMA.
//  4. Larger CTAs where the grid allows: 2 consumer warpgroups (128 query
//     rows) when b*h*ceil(sq/128) fills the SMs (the training shape gives
//     768 CTAs), 1 (64 rows) otherwise (serving at b1 h6 s960 gives 90).
//     The host picks (ops/flash_attention.py, sm90_cta_rows) and a caller
//     may force either. K and V are re-read from L2 once per 128 query
//     rows instead of once per 64.
//  5. The thin serving grid is not solved here: a CTA still walks its k
//     tiles in series (split-KV is deferred in ROADMAP.md); what changes is
//     that each tile costs a wgmma pair fed by TMA instead of ~640 shared
//     loads and mma.sync. A serving prompt of 64 tokens or fewer is one
//     partial k tile (the online walk with nk = 1: the peeled first tile
//     and the last P@V, nothing to pipeline) over b*h CTAs of one consumer
//     warpgroup; its time is the launch and one tile's latency.
//
// Tile choice. 128 keys per k tile: S is then m64n128 (64 fp32 registers
// per consumer thread), O is m64nD (64 at d = 128) and P 32 bf16 pairs,
// all live at once while a P@V runs under the next softmax. Shared memory
// at d = 128 is Q (16 KB per warpgroup) plus 3 stages of K + V at 64 KB
// each: 224 KB with two consumer warpgroups, one CTA per SM; the third
// stage covers the later release that the overlap of item 3 brings. With
// two consumer warpgroups the CTA has 384 threads, compiled at 168
// registers (launch bounds); setmaxnreg drops the producer warpgroup to 24
// and raises the consumers to 240 (128 * 24 + 256 * 240 = 64,512 of
// 65,536). With one consumer warpgroup (256 threads) every thread may
// already take 255 registers, and setmaxnreg is not used.
// Registers and spills (nvcc 12.9 -Xptxas -v, sm_90a; chip_smoke.py phase
// 1 prints them and fails on a spill): one consumer warpgroup 190 / 189 /
// 188 registers at d = 128 (online / lazy / twopass), 154-155 at 64,
// 138-139 at 32, 130 at 16; two consumer warpgroups 168 at entry (the
// launch bound), the consumers running at up to 240 after setmaxnreg; 0
// bytes of spill stores and loads and no ptxas warning in all 24
// instantiations.
//
// Head dim 256 (bf16 d 160-256, zero-padded on the host). At the table's
// shape (b4 h6 s1024 causal) the bound is the bytes, 0.01505 ms; the
// CUDA-core kernel took 3.5-6.0 ms there. The shared-memory and register
// budgets set the tile: a 128-key K or V tile would be 64 KB, so a k tile
// is 64 keys (S m64n64, 32 fp32 registers a thread; Q K^T walks d in 16
// k-steps over four 64-column boxes) and P@V is one m64n256k16 per k-step
// into O's 128 registers a thread. Live at once under a P@V: O 128, S 32,
// P 16 (bf16 pairs) registers; one consumer warpgroup compiles at 204-206
// registers, two at the 168 launch bound with the consumers at 240 after
// setmaxnreg, no spill (nvcc 12.9). The ring is 3 stages of K + V at one
// consumer warpgroup (224 KB), 2 at two (192 KB); with 2 stages a K
// stage would wait one P@V more for its release, so at d 256 K and V are
// released on barriers of their own (the producer waits for each before
// refilling it). With two consumer warpgroups (128 query rows) over
// 64-key tiles, the upper warpgroup's last causal tile lies wholly past
// its diagonal: the lazy walk starts on it (kDeadTiles in the kernel).
//
// Masks. TMA zero-fills rows past the end of a head (the tensor maps are
// 3-D, [b*h, s, d], so a partial tile never reads the next head's rows),
// and a zero key gives a logit of 0, not -1e30: the col < sk mask stays.
// Tiles that cross the causal diagonal or the end of the keys take the
// masked path; the others skip it. The predicate is a branch over register
// arithmetic with no wgmma wait inside, so it costs nothing to ptxas's
// scheduling wherever the masked tiles fall in the walk: last in the
// online walk, first in lazy's. Query rows past sq read zeros and are not
// stored, so any sq and sk run unpadded.
//
// The lazy predicate is taken per warp (16 rows) where the TPU kernel
// takes it per block: a row whose max did not rise gets alpha = 1 exactly
// either way, so the two are bit-identical.

#include "flash_sm90.cuh"

namespace {

// flash_fwd.cu's variant numbers
enum Walk { kOnlineWalk = 0, kLazyWalk = 1, kTwopassWalk = 2 };

constexpr int kWgRows = 64;     // query rows per consumer warpgroup
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use

// Shared-memory plan for head dim D and NWG consumer warpgroups; each
// tile in the swizzled layout of flash_sm90.cuh. Up to d = 128: 128 keys
// per k tile and 3 K/V stages. At d = 256 a 128-key K or V tile alone is
// 64 KB, so the tile is 64 keys (32 KB) and the ring as deep as fits: 3
// stages beside one consumer warpgroup's Q (32 + 6 x 32 = 224 KB), 2 beside
// two (64 + 4 x 32 = 192 KB); there K and V are released on barriers of
// their own (kSplitRelease), so a K stage refills as soon as its Q K^T is
// done instead of one P@V later.
template <int D, int NWG>
struct Plan {
  static constexpr int kKeys = D > 128 ? 64 : 128;   // keys per k tile
  static constexpr int kQRows = kWgRows * NWG;
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kQBytes = kQRows * D * 2;
  static constexpr int kKVBytes = kKeys * D * 2;
  static constexpr bool kSplitRelease = D > 128;
  static constexpr int kStages =
      D <= 128 ? 3
      : kQBytes + 6 * kKVBytes + 128 + 1024 <= kMaxSmem ? 3 : 2;
  // Q | K stages | V stages | barriers; every tile a multiple of 1024 B
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOff + 128 + 1024;   // + alignment
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0,
                "tiles must keep the 1024-byte swizzle alignment");
  static_assert(kSmemBytes <= kMaxSmem, "the plan must fit a block");
  static_assert(8 * (1 + 4 * kStages) <= 128, "barriers must fit 128 bytes");
};

struct Sm90Params {
  void* o;
  float* lse;
  int sq;
  int sk;
  float scale2;   // softmax scale * log2(e)
  int causal;
};

// ---------------------------------------------------------------------------
// the kernel

// One CTA per (b*h, q tile of 64*NWG rows). Warpgroup 0 is the producer
// (one thread issues every TMA load); warpgroups 1..NWG are consumers.
//
// Accumulator layout of wgmma.m64nN (f32), thread lane = 4g + t of warp w
// in its warpgroup: d[4j + e] = D[16w + g + 8(e >> 1)][8j + 2t + (e & 1)],
// the mma.sync C layout per 8 columns, so S's accumulators for keys
// 16kk..16kk+15 are, rounded to bf16, the A fragment of P@V's k-step kk.
template <int D, int W, int NWG>
__global__ void __launch_bounds__(Plan<D, NWG>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      Sm90Params p) {
  using P = Plan<D, NWG>;
  constexpr int kKeys = P::kKeys;
  constexpr int kStages = P::kStages;
  constexpr int kSN = kKeys / 2;   // S accumulators per consumer thread
  // a warpgroup may meet k tiles wholly past its causal diagonal (d 256
  // with two consumer warpgroups: 128 query rows over 64-key tiles)
  constexpr bool kDeadTiles = P::kQRows > kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + P::kKOff;
  const uint32_t sV = base + P::kVOff;
  const uint32_t bars = base + P::kBarOff;
  const uint32_t full_q = bars;
  auto full_k = [&](int st) { return bars + 8u * (1 + st); };
  auto full_v = [&](int st) { return bars + 8u * (1 + kStages + st); };
  // the stage's K (and, unless kSplitRelease, its V) released by every
  // consumer warp; with kSplitRelease its V on a barrier of its own
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };
  [[maybe_unused]] auto empty_v = [&](int st) {
    return bars + 8u * (1 + 3 * kStages + st);
  };

  // heaviest (latest) causal q tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int nk_total = (p.sk + kKeys - 1) / kKeys;
  const int nk = p.causal
                     ? min(((qt + 1) * P::kQRows + kKeys - 1) / kKeys, nk_total)
                     : nk_total;
  // items of the walk: online visits k tiles 0 .. nk-1 with V, lazy
  // nk-1 .. 0 with V; twopass visits 0 .. nk-1 with K alone, then
  // 0 .. nk-1 with K and V
  const int n_items = W == kTwopassWalk ? 2 * nk : nk;
  auto tile_of = [&](int i) {
    return W == kLazyWalk ? nk - 1 - i : (i < nk ? i : i - nk);
  };
  auto with_v = [&](int i) { return W != kTwopassWalk || i >= nk; };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 4 * NWG);   // one arrival per consumer warp
      if constexpr (P::kSplitRelease) mbar_init(empty_v(st), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, P::kQBytes);
      tma_tile<D, P::kQRows>(sQ, &tq, full_q, qt * P::kQRows, bh);
      for (int i = 0; i < n_items; ++i) {
        const int st = i % kStages;
        // the stage's previous item has been released by every consumer
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        const int row = tile_of(i) * kKeys;
        mbar_expect_tx(full_k(st), P::kKVBytes);
        tma_tile<D, kKeys>(sK + st * P::kKVBytes, &tk, full_k(st), row, bh);
        if constexpr (P::kSplitRelease)
          mbar_wait(empty_v(st), ((i / kStages) & 1) ^ 1);
        if (with_v(i)) {
          mbar_expect_tx(full_v(st), P::kKVBytes);
          tma_tile<D, kKeys>(sV + st * P::kKVBytes, &tv, full_v(st), row,
                             bh);
        } else {
          mbar_arrive(full_v(st));   // keeps the V phases in step with K's
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
    const int wg_row0 = qt * P::kQRows + cw * kWgRows;
    const int row0 = wg_row0 + warp * 16 + g;   // this thread's rows: row0, +8

    constexpr int kSteps = D / 16;                 // k-steps of Q K^T
    // Q and K are K-major (D contiguous), V MN-major (keys along K)
    auto q_desc = [&](int kk) {
      return kmajor_desc<D, P::kQRows>(sQ, cw * kWgRows, kk);
    };
    auto k_desc = [&](int st, int kk) {
      return kmajor_desc<D, kKeys>(sK + st * P::kKVBytes, 0, kk);
    };
    auto v_desc = [&](int st, int kk) {
      return mnmajor_desc<D, kKeys>(sV + st * P::kKVBytes, kk);
    };

    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};   // this thread's partial row sums
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };
    // kSplitRelease: item i's K once its Q K^T is done, its V once its
    // P@V is (both at once where the item had no V)
    auto release_k = [&](int i) {
      if constexpr (P::kSplitRelease) release(i % kStages);
    };
    auto release_v = [&](int i) {
      if constexpr (P::kSplitRelease) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_v(i % kStages));
      } else {
        release(i % kStages);
      }
    };

    // S = Q K^T of item i: waits for its K tile, issues the k-steps as
    // one wgmma group and does not wait for it
    auto issue_qk = [&](int i, float (&s)[kSN]) {
      const int st = i % kStages;
      mbar_wait(full_k(st), (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        WgmmaSS<kKeys>::run(s, q_desc(kk), k_desc(st, kk), kk > 0);
      wgmma_commit();
    };

    // O += P V of item i: waits for its V tile, issues one wgmma group
    uint32_t pa[kKeys / 16][4];   // P of the item whose P@V is next
    auto issue_pv = [&](int i) {
      const int st = i % kStages;
      mbar_wait(full_v(st), (i / kStages) & 1);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        WgmmaRS<D>::run(o, pa[kk], v_desc(st, kk));
      wgmma_commit();
    };

    // item i's S, done, masked (in raw units: the scale is folded into
    // the exponent, and the max of the rounded scaled logits is the
    // rounded scaled max, scale2 > 0)
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
        // A row whose keys so far are all masked (lazy's diagonal-first
        // walk starts on such a tile for the upper warpgroup) has m =
        // -1e30 * scale2 rounded, and the FMA above leaves that rounding
        // (up to ~1e21), not 0, in the exponent: its p is 0 instead. The
        // plain walk gives those keys p = 1 and the next tile's alpha = 0
        // clears them, so the two agree.
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
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j + 2 * r] *= alpha[r];
            o[4 * j + 2 * r + 1] *= alpha[r];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSN; ++j) l[(j >> 1) & 1] += s[j];
      acc_to_frags(pa, s);
    };

    // Two consumer warpgroups take turns to issue their products (named
    // barrier 1 + cw is this warpgroup's turn; the other one arrives on it
    // after issuing), so one's softmax runs under the other's wgmma.
    // Warpgroup 1 hands the first turn to warpgroup 0 and does not pass
    // on its last, so every barrier phase completes.
    auto my_turn = [&]() {
      if constexpr (NWG == 2)
        asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
    };
    auto pass_turn = [&](bool last) {
      if constexpr (NWG == 2) {
        if (!(last && cw == 1))
          asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
      }
    };
    if constexpr (NWG == 2) {
      if (cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    }

    // The accumulating walk over items [first, n_items): item i's Q K^T
    // is issued ahead of item i-1's P@V, so i's softmax runs while i-1's
    // P@V is on the tensor cores. The first item is peeled so that every
    // wait below is unconditional (a conditional one makes ptxas
    // serialize the products).
    auto accumulate = [&](int first) {
      float s[kSN];
      float alpha[2] = {1.f, 1.f};
      my_turn();
      issue_qk(first, s);
      pass_turn(false);
      wgmma_wait<0>();
      release_k(first);
      fold(s, probs(first, s, alpha), alpha);
      for (int i = first + 1; i < n_items; ++i) {
        my_turn();
        issue_qk(i, s);
        issue_pv(i - 1);
        pass_turn(false);
        wgmma_wait<1>();   // S done; the previous P@V runs on
        release_k(i);
        const bool rescale = probs(i, s, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release_v(i - 1);
        fold(s, rescale, alpha);
      }
      my_turn();
      issue_pv(n_items - 1);
      pass_turn(true);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release_v(n_items - 1);
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
        mask(i, s);
        m[0] = fmaxf(m[0], row_max(s, 0));
        m[1] = fmaxf(m[1], row_max(s, 1));
        release_k(i);
        release_v(i);
      }
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
      // pass 2: accumulate against the final max, no correction
      accumulate(nk);
    }

    __nv_bfloat16* o_out = static_cast<__nv_bfloat16*>(p.o) +
                           static_cast<size_t>(bh) * p.sq * D;
    float* lse = p.lse + static_cast<size_t>(bh) * p.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
      const int row = row0 + 8 * r;
      if (row < p.sq) {
        const float inv = 1.f / lr;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(o_out + static_cast<size_t>(row) * D +
                                       8 * j + 2 * t) =
              pack_f2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        if (t == 0) lse[row] = (m[r] + log2f(lr)) * kLn2;
      }
    }
  }
}

template <int D, int W, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, int bh,
                   const Sm90Params& p, cudaStream_t stream) {
  using P = Plan<D, NWG>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map<D>(&tq, q, p.sq, bh, P::kQRows);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, p.sk, bh, P::kKeys);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, p.sk, bh, P::kKeys);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90_kernel<D, W, NWG>;
  static std::atomic<uint32_t> opted_in{0};
  err = opt_in_smem(kernel, P::kSmemBytes, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + P::kQRows - 1) / P::kQRows, bh);
  kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(tq, tk, tv, p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, int bh,
                     int walk, int nwg, const Sm90Params& p,
                     cudaStream_t stream) {
  if (walk == kOnlineWalk)
    return nwg == 2 ? launch<D, kOnlineWalk, 2>(q, k, v, bh, p, stream)
                    : launch<D, kOnlineWalk, 1>(q, k, v, bh, p, stream);
  if (walk == kLazyWalk)
    return nwg == 2 ? launch<D, kLazyWalk, 2>(q, k, v, bh, p, stream)
                    : launch<D, kLazyWalk, 1>(q, k, v, bh, p, stream);
  return nwg == 2 ? launch<D, kTwopassWalk, 2>(q, k, v, bh, p, stream)
                  : launch<D, kTwopassWalk, 1>(q, k, v, bh, p, stream);
}

bool valid_shape(int d, int walk, int cta_rows) {
  return (d == 16 || d == 32 || d == 64 || d == 128 || d == 256) &&
         (walk == kOnlineWalk || walk == kLazyWalk ||
          walk == kTwopassWalk) &&
         (cta_rows == 64 || cta_rows == 128);
}

}  // namespace

// Plain C entry point (no PyTorch headers here: they stay in bindings.cpp).
// bf16 only. variant: 0 online, 1 lazy, 2 twopass (flash_fwd.cu's
// numbering).
// cta_rows: query rows per CTA, 64 (one consumer warpgroup) or 128 (two).
// q, k, v, o must be contiguous and 16-byte aligned (the tensor maps need
// it; the caller checks). Returns a configuration error; the launch itself
// is checked by the caller with cudaGetLastError.
extern "C" cudaError_t hvd_flash_fwd_sm90(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int bh, int sq, int sk, int d,
                                          int variant, int causal,
                                          float scale2, int cta_rows,
                                          cudaStream_t stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535 ||
      !valid_shape(d, variant, cta_rows))
    return cudaErrorInvalidValue;
  Sm90Params p{o, lse, sq, sk, scale2, causal};
  const int nwg = cta_rows / kWgRows;
  switch (d) {
    case 16: return dispatch<16>(q, k, v, bh, variant, nwg, p, stream);
    case 32: return dispatch<32>(q, k, v, bh, variant, nwg, p, stream);
    case 64: return dispatch<64>(q, k, v, bh, variant, nwg, p, stream);
    case 128: return dispatch<128>(q, k, v, bh, variant, nwg, p, stream);
    default: return dispatch<256>(q, k, v, bh, variant, nwg, p, stream);
  }
}
