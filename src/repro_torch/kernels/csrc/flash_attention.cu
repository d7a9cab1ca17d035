// Flash attention forward (prefill) for Hopper, sm_90a, with a plain C entry
// point for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention ->
// _flash_kernel, the Pallas TPU kernel. Same contract: q (B,Sq,H,Dh),
// k (B,Skv,KH,Dh), v (B,Skv,KH,Dv) -> o (B,Sq,H,Dv); causal, sliding-window or
// bidirectional masking; query head h reads kv head h / (H/KH); Dv may differ
// from Dh; ragged last tiles; fp32 softmax state; fp32 or bf16 in and out.
//
// What bounds it on an H100: at the serving shapes (B=4, S=1024, H=16, KH=8,
// D=128, causal, bf16) the function does ~17 GFLOP against ~50 MB of input
// and output, so the card's tensor-core rate bounds it (~17 us at 989
// TFLOP/s), not memory. gemma-2b's prefill (H=8, KH=1, D=256) does the same
// operations against less memory.
//
// Design, common to both element types:
//   * the TPU kernel's sequential kv grid axis becomes a loop inside the
//     block, and its VMEM scratch (running max m, sum l, accumulator) fp32
//     registers;
//   * kv tiles wholly above the causal diagonal or wholly outside the sliding
//     window are not visited (the TPU kernel's pl.when skip);
//   * q, k and v are read through their strides in the (B,S,H,D) layout, so
//     the caller makes no transposes; only the last dimension must be dense.
// bf16 (the serving and training path) takes Hopper's tensor cores as
// FlashAttention-3 does (flash_fwd_wgmma_kernel below): a persistent block
// per SM walks the query tiles; a producer warp streams K and V tiles by TMA
// through a ring of mbarrier-guarded stages, and two consumer warpgroups of
// 64 query rows each run both products as wgmma, the probabilities passed
// from registers to the second product. Head dims above 128 (padded to 192
// or 256) take the same block with 64-row kv tiles (two stages of K and V
// then fit beside Q in 227 KB; 192 KB at 256). At gemma-2b's prefill (B=4,
// S=1024, H=8, KH=1, D=256, causal) the products take ~17 us at an H100's
// tensor-core rate, but the block took ~50 us there and reached ~58% of that
// rate over one 4096-token sequence (as many query tiles, four times the
// work each): per-item costs, not the tiles, held it back, each of a
// block's ~2 items ending on an output written from registers while no
// product ran. Above 128 dims it now stores the output by TMA from the last
// kv stage (the next item's loads and first products overlap the store) and
// skips the rescale of a warp's rows where none of their maxima rose. Kv
// tiles of 80 rows (256 dims) or 96 and 112 (192) timed 2-7% slower at the
// main path's prefills, and the two warpgroups taking turns at the tensor
// cores, as FlashAttention-3 does up to 128 dims, timed slower too; both are
// left out.
// fp32 takes scalar FMAs (one block per 64-row query tile): 4 threads share a
// query row, each holding a quarter of the row's q and accumulator, reading
// each kv row as 16-byte packs that a warp's 8 rows share (broadcasts, no
// conflicts); above 128 dims the block's kv tiles hold 16 rows, not 32, so
// the two stay within 48 KB of static shared memory.
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kDMax = 256;                       // largest Dh and Dv taken
constexpr int kBlockQ = 64;                      // query rows per block
constexpr int kRowThreads = 4;                   // threads sharing a query row
constexpr int kThreads = kBlockQ * kRowThreads;  // 256
constexpr int kSub = 16;                         // kv columns per softmax update

template <typename T, int kBlockK, int kDCap>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int h, int kh,
                 int dh, int dv, int dp,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
                 int window, float scale) {
  using E = Elem<T>;
  constexpr int kPack = E::kPack;
  constexpr int kChunks = kDCap / (kRowThreads * kPack);  // packs per thread at kDCap
  constexpr int kPer = kChunks * kPack;                   // = kDCap / 4 values per thread

  __shared__ __align__(16) T ks[kBlockK][kDCap];
  __shared__ __align__(16) T vs[kBlockK][kDCap];

  const int qt = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = hi / (h / kh);
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int part = tid % kRowThreads;
  const int q0 = qt * kBlockQ;
  const int qpos = q0 + row;
  const int nchunks = dp / (kRowThreads * kPack);

  // Pack c of this thread covers dims [(c * kRowThreads + part) * kPack, +kPack).
  float qr[kPer];
  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      const int d = (c * kRowThreads + part) * kPack + e;
      float val = 0.f;
      if (c < nchunks && qpos < sq && d < dh) {
        val = E::to_float(q[bi * q_sb + qpos * q_ss + hi * q_sh + d]);
      }
      qr[c * kPack + e] = val;
      acc[c * kPack + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // kv range any row of this tile can see.
  int kv_begin = 0;
  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + kBlockQ);
  if (window > 0) kv_begin = max(0, q0 - window + 1);

  for (int kv0 = (kv_begin / kBlockK) * kBlockK; kv0 < kv_end; kv0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kBlockK * dp; idx += kThreads) {
      const int r = idx / dp;
      const int d = idx - r * dp;
      const int kv = kv0 + r;
      T kval = E::zero();
      T vval = E::zero();
      if (kv < skv) {
        if (d < dh) kval = k[bi * k_sb + kv * k_ss + kvh * k_sh + d];
        if (d < dv) vval = v[bi * v_sb + kv * v_ss + kvh * v_sh + d];
      }
      ks[r][d] = kval;
      vs[r][d] = vval;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kBlockK; j0 += kSub) {
      float s[kSub];
      float smax = kNegInf;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int r = j0 + j;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (c < nchunks) {
            float kf[kPack];
            E::load_pack(&ks[r][(c * kRowThreads + part) * kPack], kf);
#pragma unroll
            for (int e = 0; e < kPack; ++e) dot = fmaf(qr[c * kPack + e], kf[e], dot);
          }
        }
        // The four threads of a row end with the same sum: a + b == b + a.
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kv = kv0 + r;
        const bool live = kv < skv && (!causal || kv <= qpos) && (window <= 0 || kv > qpos - window);
        s[j] = live ? dot * scale : kNegInf;
        smax = fmaxf(smax, s[j]);
      }
      const float m_new = fmaxf(m, smax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        const int r = j0 + j;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (c < nchunks) {
            float vf[kPack];
            E::load_pack(&vs[r][(c * kRowThreads + part) * kPack], vf);
#pragma unroll
            for (int e = 0; e < kPack; ++e) {
              acc[c * kPack + e] = fmaf(p, vf[e], acc[c * kPack + e]);
            }
          }
        }
      }
      m = m_new;
    }
  }

  if (qpos >= sq) return;
  const float denom = fmaxf(l, 1e-30f);
  if (lse != nullptr && part == 0) {
    lse[(static_cast<int64_t>(bi) * h + hi) * sq + qpos] = m + logf(denom);
  }
  T* orow = o + ((static_cast<int64_t>(bi) * sq + qpos) * h + hi) * dv;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      const int d = (c * kRowThreads + part) * kPack + e;
      if (c < nchunks && d < dv) orow[d] = E::from_float(acc[c * kPack + e] / denom);
    }
  }
}

template <typename T, int kBlockK, int kDCap>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
           int skv,
           int h, int kh, int dh, int dv, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int kQuad = kRowThreads * Elem<T>::kPack;
  const int dmax = dh > dv ? dh : dv;
  const int dp = (dmax + kQuad - 1) / kQuad * kQuad;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<T, kBlockK, kDCap><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, skv, h, kh, dh, dv, dp, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed tiles and warpgroup products (FlashAttention-3's shape)
// ---------------------------------------------------------------------------

constexpr int kFaBlockM = 128;    // query rows per block: two consumer warpgroups of 64
constexpr int kFaStages = 2;      // K/V tiles in the ring
constexpr int kFaThreads = 384;   // one producer warpgroup, two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Every sub-tile is rows x 64 bf16 (128-byte rows, the 128-byte swizzle's
// width) and starts 1024-byte aligned, as the wgmma descriptors assume. kBN
// kv rows a tile: 128, or 64 above 128 dims.
template <int kD, int kBN>
struct alignas(1024) FaShared {
  bf16 q[2][kD / 64][64 * 64];            // [warpgroup][d chunk][64 rows x 64]
  bf16 k[kFaStages][kD / 64][kBN * 64];   // [stage][d chunk][kv rows x 64]
  bf16 v[kFaStages][kD / 64][kBN * 64];
  uint64_t q_full;
  uint64_t q_empty;              // both consumers have their last scores of the tile
  uint64_t k_full[kFaStages];
  uint64_t v_full[kFaStages];
  uint64_t k_empty[kFaStages];   // both consumers are done with the K stage
  uint64_t v_empty[kFaStages];
};

// One 128-row query tile of one (head, batch): the kv tiles it visits.
struct FaWork {
  int q0, hi, bi, first, ntiles;
};

// Work item `item` of nqt * h * b: query tiles last (heaviest, when causal)
// first, heads innermost so that blocks at work together share kv heads.
template <int kBN>
__device__ __forceinline__ FaWork fa_work(int item, int nqt, int h, int b, int skv,
                                          int causal, int window) {
  FaWork w;
  w.q0 = (nqt - 1 - item / (h * b)) * kFaBlockM;
  w.hi = item % h;
  w.bi = (item / h) % b;
  int kv_begin = 0;
  int kv_end = skv;
  if (causal) kv_end = min(skv, w.q0 + kFaBlockM);
  if (window > 0) kv_begin = max(0, w.q0 - window + 1);
  w.first = kv_begin / kBN;
  w.ntiles = kv_end > kv_begin ? (kv_end + kBN - 1) / kBN - w.first : 0;
  return w;
}

// The item of round `round` for this block: the rounds snake over the blocks
// (block j takes item j of even rounds and item G - 1 - j of odd ones), so
// the heavy tiles of the first rounds and the light ones of the last even out.
__device__ __forceinline__ int fa_item(int round) {
  const int base = round * gridDim.x;
  return (round & 1) ? base + gridDim.x - 1 - blockIdx.x : base + blockIdx.x;
}

// Persistent: one block per SM walks query tiles (fa_item). Warpgroup 0 is
// the producer: one thread loads each tile's Q once it is free and streams K
// and V tiles through a 2-stage ring by TMA, each stage's K and V guarded by
// full (bytes landed) and empty (both consumers done) mbarriers; the ring and
// its phases run on across tiles, so the next tile's loads overlap this
// tile's last products and its epilogue. Warpgroups 1 and 2 each own 64 query
// rows: S = Q K^T by wgmma from shared memory, the online softmax in fp32
// registers (base 2), then O += P V by wgmma with P from registers and V read
// transposed (MN-major) from shared memory; the scores of one kv tile and P V
// of the one before are in flight together. K and V stages are freed
// separately (K once its scores are in, V once its product is), so the
// producer runs two kv tiles ahead. kD is the head dim padded to 64, 128, 192
// or 256, kBN the kv rows of a tile; TMA zero-fills past Dh, Dv, Sq and Skv,
// and masks are applied only on kv tiles that a diagonal, a window edge or
// the ragged end cuts. Up to 128 dims kBN is 128 and the output is stored
// from registers. Above (kWide), kBN is 64, and:
//   * a warp rescales its rows only where one of its rows' maxima rose (a
//     vote a tile): elsewhere every factor would be exactly 1;
//   * where `tma_out` (the host's choice: Dv a multiple of 8), the output
//     tiles go out by TMA stores (one box per 64-dim chunk) from the K (first
//     warpgroup) and V (second) tiles of the item's last kv stage, which both
//     warpgroups are done with once their last P V is in: the next item's Q
//     and first kv tile load meanwhile, and only its second kv tile, bound
//     for that stage, waits until the stores have read it; else from
//     registers.
template <int kD, int kBN>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, bf16* __restrict__ o,
                       float* __restrict__ lse, int b, int sq, int skv, int h, int kh, int dv,
                       int causal, int window, float scale_log2, int nqt, int tma_store) {
  constexpr bool kWide = kD > 128;
  static_assert(kBN == (kWide ? 64 : 128), "the kv tile widths");
  constexpr int kChunks = kD / 64;
  constexpr int kSteps = kD / 16;                      // k-steps of S = Q K^T
  constexpr uint32_t kQBytes = 2 * kChunks * 64 * 128;
  constexpr uint32_t kKvBytes = kChunks * kBN * 128;
  const bool tma_out = kWide && tma_store;
  extern __shared__ unsigned char smem_raw[];
  FaShared<kD, kBN>& sm = *reinterpret_cast<FaShared<kD, kBN>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int items = nqt * h * b;
  const int group = h / kh;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init(&sm.q_empty, 2 * 128);
    for (int st = 0; st < kFaStages; ++st) {
      hopper::mbar_init(&sm.k_full[st], 1);
      hopper::mbar_init(&sm.v_full[st], 1);
      hopper::mbar_init(&sm.k_empty[st], 2 * 128);
      hopper::mbar_init(&sm.v_empty[st], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      int tile = 0;   // kv tiles loaded so far: the ring's position
      int n = 0;      // query tiles so far
      for (int round = 0; round * static_cast<int>(gridDim.x) < items; ++round) {
        const int item = fa_item(round);
        if (item >= items) continue;
        const FaWork w = fa_work<kBN>(item, nqt, h, b, skv, causal, window);
        const int kvh = w.hi / group;
        hopper::mbar_wait(&sm.q_empty, (n & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
        for (int wg = 0; wg < 2; ++wg) {
          for (int c = 0; c < kChunks; ++c) {
            hopper::tma_load_4d(sm.q[wg][c], &tq, &sm.q_full, c * 64, w.q0 + wg * 64, w.hi,
                                w.bi);
          }
        }
        for (int it = 0; it < w.ntiles; ++it, ++tile) {
          const int st = tile % kFaStages;
          const uint32_t phase = (tile / kFaStages) & 1;
          const int kv0 = (w.first + it) * kBN;
          hopper::mbar_wait(&sm.k_empty[st], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&sm.k_full[st], kKvBytes);
          for (int c = 0; c < kChunks; ++c) {
            hopper::tma_load_4d(sm.k[st][c], &tk, &sm.k_full[st], c * 64, kv0, kvh, w.bi);
          }
          hopper::mbar_wait(&sm.v_empty[st], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&sm.v_full[st], kKvBytes);
          for (int c = 0; c < kChunks; ++c) {
            hopper::tma_load_4d(sm.v[st][c], &tv, &sm.v_full[st], c * 64, kv0, kvh, w.bi);
          }
        }
        ++n;
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    hopper::reg_alloc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int row_in = (t / 32) * 16 + lane / 4;        // this thread's first row of the 64
    float acc[kD / 2];                                  // O: 64 x kD over the warpgroup
    float s[kBN / 2];                                   // S: 64 x kBN over the warpgroup
    uint32_t pa[kBN / 16][4];                           // P of the previous tile, bf16
    float m[2];
    float l[2];    // this thread's share of each row's sum
    float corr[2];
    bool rescale = true;   // corr is not 1: the output takes it before the next P V
    int r0 = 0;    // first query row of this warpgroup in the current tile
    int rows[2] = {0, 0};
    int tile = 0;  // kv tiles consumed before the current query tile
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;

    // S = Q K^T of kv tile `it` into s (issued, not waited for)
    auto issue_scores = [&](int it) {
      const int st = (tile + it) % kFaStages;
      hopper::mbar_wait(&sm.k_full[st], ((tile + it) / kFaStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint64_t da = hopper::sw128_desc(&sm.q[wg][kk / 4][(kk % 4) * 16], 16, 1024);
        const uint64_t db = hopper::sw128_desc(&sm.k[st][kk / 4][(kk % 4) * 16], 16, 1024);
        if constexpr (kBN == 128) {
          hopper::wgmma_ss_m64n128k16(s, da, db, kk > 0);
        } else {
          hopper::wgmma_ss_m64n64k16<0, 0>(s, da, db, kk > 0);
        }
      }
      hopper::wgmma_commit();
    };
    // O += P V of kv tile `it` (issued, not waited for)
    auto issue_pv = [&](int it) {
      const int st = (tile + it) % kFaStages;
      hopper::mbar_wait(&sm.v_full[st], ((tile + it) / kFaStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        // 16 kv rows of V per k-step; the d chunks lie kBN x 128 B apart
        hopper::wgmma_rs_over_d<kD>(acc, pa[kk], [&](int c) {
          return hopper::sw128_desc(&sm.v[st][c][kk * 16 * 64], kBN * 128, 1024);
        });
      }
      hopper::wgmma_commit();
    };
    // The online softmax of the scores of kv tile kv0 in s: s becomes P
    // (fp32), m and l move on where the warp rescales, corr is the factor the
    // output has to take.
    auto softmax = [&](int kv0) {
      // scores in base 2; masks only where this tile cuts them for our rows
      const bool cut = kv0 + kBN > skv || (causal && kv0 + kBN - 1 > r0) ||
                       (window > 0 && kv0 <= r0 + 63 - window);
      float mx[2] = {m[0], m[1]};
      if (cut) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int kv = kv0 + (i >> 2) * 8 + 2 * quad + (i & 1);
          const int qpos = rows[(i >> 1) & 1];
          const bool live = (kv < skv) & (!causal | (kv <= qpos)) &
                            ((window <= 0) | (kv > qpos - window));
          s[i] = live ? s[i] * scale_log2 : kNegInf;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          s[i] *= scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      if constexpr (kWide) {
        rescale = __any_sync(0xffffffffu, (mx[0] > m[0]) | (mx[1] > m[1]));
      }
      if (!kWide || rescale) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          corr[r] = hopper::exp2_approx(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= corr[r];
        }
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        s[i] = hopper::exp2_approx(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = pack2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
      }
    };

    int n = 0;
    for (int round = 0; round * static_cast<int>(gridDim.x) < items; ++round) {
      const int item = fa_item(round);
      if (item >= items) continue;
      const FaWork w = fa_work<kBN>(item, nqt, h, b, skv, causal, window);
      r0 = w.q0 + wg * 64;
      rows[0] = r0 + row_in;
      rows[1] = rows[0] + 8;
      // the last kv stage's K and V tiles take the output tiles (TMA store):
      // its empty barriers wait for the stores
      const bool staged = tma_out && w.ntiles > 0;
      const int last = (tile + w.ntiles - 1) % kFaStages;
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      hopper::mbar_wait(&sm.q_full, n & 1);

      // Pipelined as FlashAttention-3 does inside a warpgroup: the scores of
      // kv tile it and P V of kv tile it - 1 are in flight together, and the
      // softmax of tile it runs while P V finishes.
      if (w.ntiles == 0) hopper::mbar_arrive(&sm.q_empty);
      if (w.ntiles > 0) {
        hopper::fence_regs(s);
        hopper::wgmma_fence();
        issue_scores(0);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (!(staged && w.ntiles == 1)) hopper::mbar_arrive(&sm.k_empty[tile % kFaStages]);
        if (w.ntiles == 1) hopper::mbar_arrive(&sm.q_empty);
        softmax(w.first * kBN);
        pack_p();
      }
      for (int it = 1; it < w.ntiles; ++it) {
        hopper::fence_regs(s);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_scores(it);
        issue_pv(it - 1);
        hopper::wgmma_wait<1>();   // the scores of kv tile it
        hopper::fence_regs(s);
        if (!(staged && it == w.ntiles - 1)) {
          hopper::mbar_arrive(&sm.k_empty[(tile + it) % kFaStages]);
        }
        if (it == w.ntiles - 1) hopper::mbar_arrive(&sm.q_empty);
        softmax((w.first + it) * kBN);
        hopper::wgmma_wait<0>();   // P V of kv tile it - 1
        hopper::fence_regs(acc);
        hopper::keep_regs(pa);
        hopper::mbar_arrive(&sm.v_empty[(tile + it - 1) % kFaStages]);
        if (!kWide || rescale) {
#pragma unroll
          for (int i = 0; i < kD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        }
        pack_p();
      }
      if (w.ntiles > 0) {
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_pv(w.ntiles - 1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::keep_regs(pa);
        if (!staged) hopper::mbar_arrive(&sm.v_empty[last]);
      }

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float denom = fmaxf(l[r], 1e-30f);
        inv[r] = 1.f / denom;
        if (lse != nullptr && quad == 0 && rows[r] < sq) {
          lse[(static_cast<int64_t>(w.bi) * h + w.hi) * sq + rows[r]] = m[r] * kLn2 + logf(denom);
        }
      }
      if (kWide && staged) {
        // both warpgroups are done with the last stage's K and V tiles: the
        // first takes K's chunks, the second V's, each chunk's first 64 rows
        // 128-byte swizzled as the map reads them (the 16-byte unit j % 8 of
        // row r sits at unit (j % 8) ^ (r % 8)); the other warpgroup's share
        // of the stage's empty barrier goes now, this one's once the store
        // has read the tile
        hopper::named_sync(1, 256);
        bf16 (*out)[kBN * 64] = wg == 0 ? sm.k[last] : sm.v[last];
        hopper::mbar_arrive(wg == 0 ? &sm.v_empty[last] : &sm.k_empty[last]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_in + 8 * r;
#pragma unroll
          for (int j = 0; j < kD / 8; ++j) {
            unsigned char* base = reinterpret_cast<unsigned char*>(out[j / 8]);
            *reinterpret_cast<uint32_t*>(base + row * 128 + (((j % 8) ^ (row % 8)) * 16) +
                                         quad * 4) =
                pack2(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
          }
        }
        hopper::fence_proxy_async();
        hopper::named_sync(2 + wg, 128);
        if (t == 0) {
          for (int c = 0; c < kChunks && c * 64 < dv; ++c) {
            hopper::tma_store_4d(&to, out[c], c * 64, r0, w.hi, w.bi);
          }
          hopper::bulk_commit();
          hopper::bulk_wait_read<0>();
          hopper::mbar_arrive_n(wg == 0 ? &sm.k_empty[last] : &sm.v_empty[last], 128);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (rows[r] >= sq) continue;
          bf16* orow = o + ((static_cast<int64_t>(w.bi) * sq + rows[r]) * h + w.hi) * dv;
#pragma unroll
          for (int j = 0; j < kD / 8; ++j) {
            const int d = j * 8 + 2 * quad;
            const float a0 = acc[4 * j + 2 * r] * inv[r];
            const float a1 = acc[4 * j + 2 * r + 1] * inv[r];
            if (d + 1 < dv && dv % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(a0, a1);
            } else {
              if (d < dv) orow[d] = __float2bfloat16(a0);
              if (d + 1 < dv) orow[d + 1] = __float2bfloat16(a1);
            }
          }
        }
      }
      tile += w.ntiles;
      ++n;
    }
    if (tma_out && t == 0) hopper::bulk_wait<0>();
  }
}

// Above 128 dims the output map: the dense (B, Sq, H, Dv) output in 64 x 64
// boxes, where TMA can describe it (Dv a multiple of 8); else the kernel
// stores from registers.
template <int kD, int kBN>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                 int sq, int skv, int h, int kh, int dh, int dv, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, int causal, int window,
                 float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!hopper::encode_bshd(&tq, q, b, sq, h, dh, q_sb, q_ss, q_sh, 64) ||
      !hopper::encode_bshd(&tk, k, b, skv, kh, dh, k_sb, k_ss, k_sh, kBN) ||
      !hopper::encode_bshd(&tv, v, b, skv, kh, dv, v_sb, v_ss, v_sh, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tma_store = kD > 128 && dv % 8 == 0 &&
                        hopper::encode_bshd(&to, o, b, sq, h, dv,
                                            static_cast<long long>(sq) * h * dv,
                                            static_cast<long long>(h) * dv, dv, 64);
  if (!tma_store) to = tv;   // never read: the kernel stores from registers
  constexpr int kSmem = static_cast<int>(sizeof(FaShared<kD, kBN>)) + 1024;
  auto kernel = flash_fwd_wgmma_kernel<kD, kBN>;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  static int sms = 0;   // one kind of card per process
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nqt = (sq + kFaBlockM - 1) / kFaBlockM;
  const int blocks = min(nqt * h * b, sms);   // one block per SM, walking the tiles
  kernel<<<blocks, kFaThreads, kSmem, stream>>>(tq, tk, tv, to, static_cast<bf16*>(o), lse, b,
                                                sq, skv, h, kh, dv, causal, window,
                                                scale * kLog2e, nqt, tma_store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Returns cudaGetLastError() after the launch (0 on success). Strides are in
// elements; the last dimension of q, k and v is dense; o is a dense
// (B,Sq,H,Dv) tensor. bf16 q, k and v must have 16-byte aligned bases and
// strides (TMA describes them; the wrapper pads inputs that are not), else the
// call returns cudaErrorInvalidValue without a launch. lse, when not null, is a dense fp32 (B,H,Sq) tensor that
// receives each row's log-sum-exp of its scaled scores (what the backward
// kernel recomputes the probabilities from); serving passes null. window <= 0
// means no sliding window. The caller guarantees 1 <= Dh, Dv <= 256 and
// H % KH == 0.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, void* lse, int b, int sq, int skv, int h, int kh, int dh,
                                   int dv, long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh, int causal,
                                   int window, float scale, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dv < 1 || dh > kDMax || dv > kDMax || kh < 1 || h % kh != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // fp32: 32 KB of static shared memory per block (2 tiles x 32 x 128 x 4 B,
  // or 2 x 16 x 256 x 4 B above 128 dims).
  // bf16, dynamic shared memory: 80 KB (Dh, Dv <= 64), 160 KB (<= 128), 144 KB
  // (<= 192) or 192 KB (<= 256), the last two with kv tiles of 64 rows.
  const int dmax = dh > dv ? dh : dv;
  if (dtype == kFloat32) {
    auto run = dmax > 128 ? launch<float, 16, 256> : launch<float, 32, 128>;
    return run(q, k, v, o, static_cast<float*>(lse), b, sq, skv, h, kh, dh, dv, q_sb, q_ss,
               q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, scale, st);
  }
  if (dtype == kBFloat16) {
    auto run = dmax > 192   ? launch_wgmma<256, 64>
               : dmax > 128 ? launch_wgmma<192, 64>
               : dmax > 64  ? launch_wgmma<128, 128>
                            : launch_wgmma<64, 128>;
    return run(q, k, v, o, static_cast<float*>(lse), b, sq, skv, h, kh, dh, dv, q_sb, q_ss,
               q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
