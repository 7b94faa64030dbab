// Flash-attention backward for Hopper (sm_90a) on wgmma, TMA and a
// producer/consumer pipeline: the bf16 dq and dk/dv kernels.
//
// Replaces the Pallas TPU kernels behind pl.pallas_call in
// horovod_tpu/ops/flash_attention.py (_flash_bwd), in bf16:
//   dq  -> _dq_kernel    (:467; one CTA per q tile, K/V streamed, the
//                         causal k loop stops at the diagonal)
//   dkv -> _dkv_kernel   (:531; one CTA per k tile, Q/dO/lse/delta
//                         streamed from the diagonal q tile on)
// The fp32 backward stays on the CUDA cores in flash_bwd.cu.
//
// Contract (flash_bwd.cu's): q/k/v/dO are [b*h, s, d] contiguous bf16,
// d in {16, 32, 64, 128}; lse is the forward's natural-log row
// log-sum-exp and delta = rowsum(dO * O), both fp32 [b*h, sq]. Each
// probability is rebuilt as p = exp2(s * scale2 - lse * log2(e)) and is
// exactly 0 where the mask hides the logit; then
//   ds = p * (dP - delta),  dP = dO V^T
//   dq = scale * sum_k ds K,  dv = sum_q p^T dO,  dk = scale * sum_q ds^T Q
// with ds rounded to bf16 before ds K and ds^T Q, p to bf16 before p^T dO,
// and the softmax scale applied once, after the loop, to dq and dk (never
// to dv). Two kernels, no atomics: every gradient is written once and the
// result is deterministic.
//
// What bounds it. dq does 6*d operations per visible (q, k) pair (three
// products), dk/dv 8*d (four), against q, k, v, dO, lse and delta read
// once and the gradients written once. At the training shape (b16 h6 d128
// causal s1024) that is 38.7 G and 51.6 G operations, 0.039 and 0.052 ms
// at 989 TFLOP/s, against 0.012 / 0.015 ms of bytes: the tensor cores are
// the bound.
//
// Design, against what held the first, mma.sync kernels back:
//  1. Every product on wgmma, operands fed by TMA in the swizzled layout
//     the descriptors name (flash_sm90.cuh), none through registers on
//     their way to the tensor cores.
//       dq:  S = Q K^T and dP = dO V^T are m64n128 with Q/dO and K/V
//            K-major; dS, in registers, is the A operand of dQ += dS K
//            with K read MN-major through the transpose bit.
//       dkv: S^T = K Q^T and dP^T = V dO^T are m64n64 with K/V and Q/dO
//            K-major; their accumulators, exp2'd (P^T) or turned into dS^T
//            and rounded to bf16, are the register A operands of
//            dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major
//            through the transpose bit. One Q or dO tile sits in one
//            swizzled layout that both its descriptors address; nothing is
//            transposed through memory.
//  2. One producer warp keeps TMA loads in flight through a ring of stages
//     (full barrier per operand, empty barrier per stage); consumer
//     warpgroups of 64 rows each never wait on each other.
//       dq:  one CTA per (b*h, 64 or 128 query rows: one or two consumer
//            warpgroups, picked by the host from the grid as for the
//            forward); Q and dO resident, K and V in 128-key tiles through
//            2 stages at d = 128, 3 below.
//       dkv: one CTA per (b*h, 128 keys: two consumer warpgroups of 64
//            keys); K and V resident, Q, dO and the tile's lse*log2(e) and
//            delta in 64-query tiles through 3 stages. The producer warp
//            writes lse and delta itself, padded past sq so that p = 0
//            exactly there (TMA's zero fill would give lse = 0, p != 0).
//  3. Inside a warpgroup the first two products go out as two groups, and
//     p is built while dP is still on the tensor cores; dkv then issues
//     dV += P^T dO and dK += dS^T Q as one group once dS is built (issuing
//     dV before building dS, or the next tile's products under this one's,
//     needs more than the 240 registers a consumer thread has at d = 128).
//     dq's two consumer warpgroups take turns to issue their products
//     (named barriers), so one's elementwise work runs under the other's
//     wgmma.
//  4. Masks only where a tile needs them: the last k tile of dq (the
//     causal diagonal or the end of the keys) and the diagonal q tiles of
//     dkv are separate, peeled copies of the tile code, so the others run
//     no compare and every wgmma wait is unconditional. Padded queries in
//     dkv are p = 0 through the padded lse; padded keys in dkv only touch
//     their own, unwritten rows.
//  5. The causal grid starts with its longest CTAs: b*h is the fast grid
//     axis and the tile axis runs from the high q tiles (dq) or the low k
//     tiles (dkv) down.
//  6. exp2 is one ex2.approx.ftz with the logit scale folded into an FFMA.
//
// Registers and spills: chip_smoke.py phase 1 builds this source alone
// with nvcc -Xptxas -v, prints every instantiation's registers and fails
// on a spill. CTAs of 384 threads are compiled at 168 registers (launch
// bounds); setmaxnreg drops the producer warpgroup to 24 and raises the
// consumers to 240.

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kBwdKeys = 128;      // keys per k tile (dq stream, dkv CTA)
constexpr int kDkvQRows = 64;      // queries per streamed q tile of dkv
constexpr int kWgRows = 64;        // rows per consumer warpgroup
constexpr float kPadLse2 = 1e30f;  // lse*log2(e) past sq: p = 0 exactly

struct BwdSm90Params {
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

// dq: Q | dO | K stages | V stages | barriers, every tile 1024-aligned
template <int D, int NWG>
struct DqPlan {
  static constexpr int kRows = kWgRows * NWG;   // query rows per CTA
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kBwdKeys * D * 2;
  static constexpr int kDoOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOff + 128 + 1024;   // + alignment
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0,
                "tiles must keep the 1024-byte swizzle alignment");
};

// dkv: K | V | Q stages | dO stages | lse2 and delta stages | barriers
template <int D>
struct DkvPlan {
  static constexpr int kThreads = 384;   // producer + two consumer WGs
  static constexpr int kStages = 3;
  static constexpr int kKVBytes = kBwdKeys * D * 2;
  static constexpr int kQBytes = kDkvQRows * D * 2;
  static constexpr int kVOff = kKVBytes;
  static constexpr int kQOff = 2 * kKVBytes;
  static constexpr int kDoOff = kQOff + kStages * kQBytes;
  static constexpr int kStatOff = kDoOff + kStages * kQBytes;
  static constexpr int kStatBytes = 2 * kDkvQRows * 4;   // lse2, delta
  static constexpr int kBarOff = kStatOff + kStages * kStatBytes;
  static constexpr int kSmemBytes = kBarOff + 128 + 1024;
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0,
                "tiles must keep the 1024-byte swizzle alignment");
};

template <bool B>
using Masked = std::integral_constant<bool, B>;

// ---------------------------------------------------------------------------
// dq

template <int D, int NWG>
__global__ void __launch_bounds__(DqPlan<D, NWG>::kThreads, 1)
flash_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         BwdSm90Params p) {
  using P = DqPlan<D, NWG>;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sDO = base + P::kDoOff;
  const uint32_t sK = base + P::kKOff;
  const uint32_t sV = base + P::kVOff;
  const uint32_t bars = base + P::kBarOff;
  const uint32_t full_q = bars;
  auto full_k = [&](int st) { return bars + 8u * (1 + st); };
  auto full_v = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int bh = blockIdx.x;
  // heaviest (latest) causal q tiles first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int nk_total = (p.sk + kBwdKeys - 1) / kBwdKeys;
  const int nk =
      p.causal ? min(((qt + 1) * P::kRows + kBwdKeys - 1) / kBwdKeys, nk_total)
               : nk_total;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 4 * NWG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * P::kQBytes);
      tma_tile<D, P::kRows>(sQ, &tq, full_q, qt * P::kRows, bh);
      tma_tile<D, P::kRows>(sDO, &tdo, full_q, qt * P::kRows, bh);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k(st), P::kKVBytes);
        tma_tile<D, kBwdKeys>(sK + st * P::kKVBytes, &tk, full_k(st),
                              j * kBwdKeys, bh);
        mbar_expect_tx(full_v(st), P::kKVBytes);
        tma_tile<D, kBwdKeys>(sV + st * P::kKVBytes, &tv, full_v(st),
                              j * kBwdKeys, bh);
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
    const int row0 = qt * P::kRows + cw * kWgRows + warp * 16 + g;

    // this thread's rows: row0 and row0 + 8
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const size_t i = static_cast<size_t>(bh) * p.sq + row;
      lse2[r] = row < p.sq ? p.lse[i] * kLog2e : 0.f;
      dlt[r] = row < p.sq ? p.delta[i] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };

    // Two consumer warpgroups take turns to issue their products (named
    // barrier 1 + cw is this warpgroup's turn; the other one arrives on it
    // after issuing), so one's elementwise work runs under the other's
    // wgmma. Warpgroup 1 hands the first turn to warpgroup 0 and does not
    // pass on its last, so every barrier phase completes.
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

    // k tile j: S and dP, p and dS in registers, dQ += dS K
    auto tile = [&](int j, auto masked, bool last) {
      constexpr bool kMasked = decltype(masked)::value;
      const int st = j % kStages;
      const int ph = (j / kStages) & 1;
      const uint32_t tk_s = sK + st * P::kKVBytes;
      const uint32_t tv_s = sV + st * P::kKVBytes;
      float s[64], dp[64];
      mbar_wait(full_k(st), ph);
      mbar_wait(full_v(st), ph);
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<kBwdKeys>::run(
            s, kmajor_desc<D, P::kRows>(sQ, cw * kWgRows, kk),
            kmajor_desc<D, kBwdKeys>(tk_s, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<kBwdKeys>::run(
            dp, kmajor_desc<D, P::kRows>(sDO, cw * kWgRows, kk),
            kmajor_desc<D, kBwdKeys>(tv_s, 0, kk), kk > 0);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<1>();
      fence_regs(s);
      const int col0 = j * kBwdKeys;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        float x = fast_exp2(fmaf(s[i], p.scale2, -lse2[r]));
        if constexpr (kMasked) {
          const int col = col0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int row = row0 + 8 * r;
          const bool keep = col < p.sk && (!p.causal || col <= row);
          x = keep ? x : 0.f;
        }
        s[i] = x;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= dp[i] - dlt[(i >> 1) & 1];
      uint32_t ds[kBwdKeys / 16][4];
      acc_to_frags(ds, s);
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdKeys / 16; ++kk)
        WgmmaRS<D>::run(dq, ds[kk], mnmajor_desc<D, kBwdKeys>(tk_s, kk));
      wgmma_commit();
      pass_turn(last);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(ds);
      release(st);
    };

    if constexpr (NWG == 2) {
      if (cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    }
    mbar_wait(full_q, 0);
    // only the last k tile can hold the causal diagonal or the end of the
    // keys: every other one runs unmasked
    for (int j = 0; j < nk - 1; ++j) tile(j, Masked<false>(), false);
    tile(nk - 1, Masked<true>(), true);

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq) +
                         static_cast<size_t>(bh) * p.sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < p.sq) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * D +
                                       8 * j + 2 * t) =
              pack_f2(dq[4 * j + 2 * r] * p.scale,
                      dq[4 * j + 2 * r + 1] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv

template <int D>
__global__ void __launch_bounds__(DkvPlan<D>::kThreads, 1)
flash_bwd_sm90_dkv_kernel(const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          BwdSm90Params p) {
  using P = DkvPlan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + P::kVOff;
  const uint32_t sQ = base + P::kQOff;
  const uint32_t sDO = base + P::kDoOff;
  // per stage: lse2[64] then delta[64]
  float* stats = reinterpret_cast<float*>(smem_raw + (base - raw) + P::kStatOff);
  const uint32_t bars = base + P::kBarOff;
  const uint32_t full_kv = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int bh = blockIdx.x;
  // the first k tiles see the most q tiles, so they go first
  const int kt = blockIdx.y;
  const int nq = (p.sq + kDkvQRows - 1) / kDkvQRows;
  // first q tile whose last row can see this k tile's first row
  const int qb_start = p.causal ? kt * kBwdKeys / kDkvQRows : 0;
  const int n = max(nq - qb_start, 0);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1 + 32);   // the TMA's bytes + the producer warp
      mbar_init(empty(st), 8);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: one warp
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse = p.lse + static_cast<size_t>(bh) * p.sq;
      const float* delta = p.delta + static_cast<size_t>(bh) * p.sq;
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * P::kKVBytes);
        tma_tile<D, kBwdKeys>(sK, &tk, full_kv, kt * kBwdKeys, bh);
        tma_tile<D, kBwdKeys>(sV, &tv, full_kv, kt * kBwdKeys, bh);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const int q0 = (qb_start + i) * kDkvQRows;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(st), 2 * P::kQBytes);
          tma_tile<D, kDkvQRows>(sQ + st * P::kQBytes, &tq, full(st), q0, bh);
          tma_tile<D, kDkvQRows>(sDO + st * P::kQBytes, &tdo, full(st), q0,
                                 bh);
        }
        float* st_stats = stats + st * 2 * kDkvQRows;
        for (int r = lane; r < kDkvQRows; r += 32) {
          const int row = q0 + r;
          const bool ok = row < p.sq;
          st_stats[r] = ok ? lse[row] * kLog2e : kPadLse2;
          st_stats[kDkvQRows + r] = ok ? delta[row] : 0.f;
        }
        mbar_arrive(full(st));   // release: the stats are visible
      }
    }
  } else {
    // ---------------- consumers
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wg_key0 = kt * kBwdKeys + cw * kWgRows;
    const int key0 = wg_key0 + warp * 16 + g;   // this thread's keys: +0, +8

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };

    // q tile i: S^T and dP^T, P^T and dS^T in registers, dV and dK
    auto tile = [&](int i, auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      const int st = i % kStages;
      const uint32_t tq_s = sQ + st * P::kQBytes;
      const uint32_t tdo_s = sDO + st * P::kQBytes;
      const float* lrow = stats + st * 2 * kDkvQRows;
      const float* drow = lrow + kDkvQRows;
      float s[32], dp[32];
      mbar_wait(full(st), (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<kDkvQRows>::run(
            s, kmajor_desc<D, kBwdKeys>(sK, cw * kWgRows, kk),
            kmajor_desc<D, kDkvQRows>(tq_s, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<kDkvQRows>::run(
            dp, kmajor_desc<D, kBwdKeys>(sV, cw * kWgRows, kk),
            kmajor_desc<D, kDkvQRows>(tdo_s, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // p^T: the columns are queries, each with its own lse
      const int q0 = (qb_start + i) * kDkvQRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fast_exp2(fmaf(s[4 * j + e], p.scale2,
                                   -((e & 1) ? l2.y : l2.x)));
          if constexpr (kMasked) {
            const int q = q0 + 8 * j + 2 * t + (e & 1);
            x = key0 + 8 * (e >> 1) <= q ? x : 0.f;
          }
          s[4 * j + e] = x;
        }
      }
      uint32_t pa[kDkvQRows / 16][4];
      acc_to_frags(pa, s);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t da[kDkvQRows / 16][4];
      acc_to_frags(da, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQRows / 16; ++kk)
        WgmmaRS<D>::run(dv, pa[kk], mnmajor_desc<D, kDkvQRows>(tdo_s, kk));
#pragma unroll
      for (int kk = 0; kk < kDkvQRows / 16; ++kk)
        WgmmaRS<D>::run(dk, da[kk], mnmajor_desc<D, kDkvQRows>(tq_s, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      release(st);
    };

    mbar_wait(full_kv, 0);
    int i = 0;
    if (p.causal) {
      auto q0 = [&](int it) { return (qb_start + it) * kDkvQRows; };
      // q tiles wholly before this warpgroup's keys add nothing
      for (; i < n && q0(i) + kDkvQRows - 1 < wg_key0; ++i) {
        mbar_wait(full(i % kStages), (i / kStages) & 1);
        release(i % kStages);
      }
      // the diagonal: some key after some query
      for (; i < n && q0(i) < wg_key0 + kWgRows - 1; ++i)
        tile(i, Masked<true>());
    }
    for (; i < n; ++i) tile(i, Masked<false>());

    const size_t off = static_cast<size_t>(bh) * p.sk * D;
    __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(p.dk) + off;
    __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(p.dv) + off;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < p.sk) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const size_t at = static_cast<size_t>(key) * D + 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(gk + at) =
              pack_f2(dk[4 * j + 2 * r] * p.scale,
                      dk[4 * j + 2 * r + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(gv + at) =
              pack_f2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

template <int D, int NWG>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, int bh, const BwdSm90Params& p,
                      cudaStream_t stream) {
  using P = DqPlan<D, NWG>;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = make_map<D>(&tq, q, p.sq, bh, P::kRows);
  if (err == cudaSuccess) err = make_map<D>(&tdo, dout, p.sq, bh, P::kRows);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, p.sk, bh, kBwdKeys);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, p.sk, bh, kBwdKeys);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_sm90_dq_kernel<D, NWG>;
  static std::atomic<uint32_t> opted_in{0};
  err = opt_in_smem(kernel, P::kSmemBytes, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (p.sq + P::kRows - 1) / P::kRows);
  kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(tq, tdo, tk, tv, p);
  return cudaSuccess;   // launch errors are read by the caller
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, int bh, const BwdSm90Params& p,
                       cudaStream_t stream) {
  using P = DkvPlan<D>;
  CUtensorMap tk, tv, tq, tdo;
  cudaError_t err = make_map<D>(&tk, k, p.sk, bh, kBwdKeys);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, p.sk, bh, kBwdKeys);
  if (err == cudaSuccess) err = make_map<D>(&tq, q, p.sq, bh, kDkvQRows);
  if (err == cudaSuccess) err = make_map<D>(&tdo, dout, p.sq, bh, kDkvQRows);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_sm90_dkv_kernel<D>;
  static std::atomic<uint32_t> opted_in{0};
  err = opt_in_smem(kernel, P::kSmemBytes, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (p.sk + kBwdKeys - 1) / kBwdKeys);
  kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(tk, tv, tq, tdo, p);
  return cudaSuccess;
}

bool valid_shape(int bh, int sq, int sk, int d) {
  return bh > 0 && sq > 0 && sk > 0 &&
         (d == 16 || d == 32 || d == 64 || d == 128) &&
         (sq + kDkvQRows - 1) / kDkvQRows <= 65535 &&
         (sk + kBwdKeys - 1) / kBwdKeys <= 65535;
}

}  // namespace

// Plain C entry points (no PyTorch headers here: they stay in
// bindings.cpp). bf16 only; lse and delta fp32 [bh, sq]. scale2 is the
// softmax scale times log2(e). cta_rows: query rows per dq CTA, 64 (one
// consumer warpgroup) or 128 (two). q, k, v, dout and the gradients must be
// contiguous and 16-byte aligned (the tensor maps need it; the caller
// checks). Each returns a configuration error; the launch itself is
// checked by the caller with cudaGetLastError.
extern "C" cudaError_t hvd_flash_bwd_sm90_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
    int d, int causal, float scale2, float scale, int cta_rows,
    cudaStream_t stream) {
  if (!valid_shape(bh, sq, sk, d) || (cta_rows != 64 && cta_rows != 128))
    return cudaErrorInvalidValue;
  BwdSm90Params p{lse, delta, dq, nullptr, nullptr, sq, sk, scale2, scale,
                  causal};
  const bool two = cta_rows == 128;
  switch (d) {
    case 16: return two ? launch_dq<16, 2>(q, k, v, dout, bh, p, stream)
                        : launch_dq<16, 1>(q, k, v, dout, bh, p, stream);
    case 32: return two ? launch_dq<32, 2>(q, k, v, dout, bh, p, stream)
                        : launch_dq<32, 1>(q, k, v, dout, bh, p, stream);
    case 64: return two ? launch_dq<64, 2>(q, k, v, dout, bh, p, stream)
                        : launch_dq<64, 1>(q, k, v, dout, bh, p, stream);
    default: return two ? launch_dq<128, 2>(q, k, v, dout, bh, p, stream)
                        : launch_dq<128, 1>(q, k, v, dout, bh, p, stream);
  }
}

extern "C" cudaError_t hvd_flash_bwd_sm90_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int bh, int sq,
    int sk, int d, int causal, float scale2, float scale,
    cudaStream_t stream) {
  if (!valid_shape(bh, sq, sk, d)) return cudaErrorInvalidValue;
  BwdSm90Params p{lse, delta, nullptr, dk, dv, sq, sk, scale2, scale, causal};
  switch (d) {
    case 16: return launch_dkv<16>(q, k, v, dout, bh, p, stream);
    case 32: return launch_dkv<32>(q, k, v, dout, bh, p, stream);
    case 64: return launch_dkv<64>(q, k, v, dout, bh, p, stream);
    default: return launch_dkv<128>(q, k, v, dout, bh, p, stream);
  }
}
