// Flash attention backward for Hopper, sm_90a, with a plain C entry point for
// ctypes.
//
// Replaces: nothing in Pallas. The TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) is forward only; the reference trains by
// differentiating the jnp chunked_attention (src/repro/models/layers.py) with
// jax.vjp. This kernel is the backward of flash_attention.cu's forward, over the
// same contract: q (B,Sq,H,Dh), k (B,Skv,KH,Dh), v (B,Skv,KH,Dv), causal,
// sliding-window or bidirectional, query head h reads kv head h / (H/KH), Dv may
// differ from Dh, ragged last tiles, strided inputs with a dense last dimension,
// fp32 or bf16 in and out, fp32 arithmetic throughout.
//
// What bounds it on an H100: at the training shapes (B=2, S=1024, H=16, KH=8,
// D=128, causal) the function does ~21.5 GFLOP (five products of the forward's
// size) against ~25 MB of input and output, so the tensor cores bound it
// (~22 us at 989 TFLOP/s), not memory (~7 us).
//
// Design, common to both element types (FlashAttention-2's backward):
//   * a pre-pass computes D = rowsum(dO * O) per query row (and, for bf16, the
//     forward's log-sum-exp in base 2), into buffers padded to whole tiles;
//   * one block owns a tile of kv rows of one kv head and loops over the query
//     heads of its group and over the query tiles that can see the tile, so dK
//     and dV accumulate in its registers and need no atomics;
//   * per query tile it recomputes P = exp(S - lse) from the forward's saved
//     log-sum-exp and forms dV += P^T dO, dP = dO V^T, dS = P (dP - D),
//     dK += dS^T Q and dQ += dS K; dQ's partials of the kv tiles are summed in
//     an fp32 buffer, and a last pass scales and casts it to the output.
// bf16 (the training path) takes Hopper's tensor cores as FlashAttention-3's
// backward does (flash_bwd_wgmma_kernel): blocks of 128 kv rows, longest work
// first under the causal mask; a producer warp loads K and V once by TMA and
// streams 64-row Q and dO tiles (with their lse and D) through a ring of
// mbarrier-guarded stages; two consumer warpgroups of 64 kv rows each run all
// five products as wgmma, kv-major so that no operand needs a transpose in
// registers: S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and dS^T
// in registers as the A operands of dV += P^T dO and dK += dS^T Q (dO and Q
// read MN-major), and dS^T through shared memory as the MN-major A operand of
// dQ = dS K, each warpgroup taking 64 of dQ's columns. dQ's partial goes to
// the fp32 buffer as one bulk reduce-add of 16 KB per warpgroup and tile (TMA
// unit, atomic per element, so the summation order varies between runs).
// Head dims above 128 (padded to 192 or 256) do not fit that shape: dK and
// dV of 64 kv rows over 256 dims are 256 fp32 registers a thread, and K, V
// and two stages of Q and dO take 256 KB at 128 kv rows. There
// (flash_bwd_wide_kernel) a block owns 64 kv rows and the two consumer
// warpgroups split the products, so that each is formed once: the first
// forms S^T and P^T, the second dP^T and dS^T = P^T (dP^T - D) from P^T read
// back as bf16, and each passes its bf16 result to the other through shared
// memory; each keeps dK and dV for half the 64-wide d chunks (128 values a
// thread at 256) and forms dQ for the same chunks. One kv head (MQA) leaves
// too few kv tiles to fill the card, so a work item takes a share of its
// group's query heads (the wrapper's bwd_plan: at gemma-2b's training shape,
// 8 items of one head each for every kv tile), and where the group is split,
// the items add their dK and dV partials to fp32 buffers that a cast pass
// scales and casts. Nothing goes out by per-element atomics: dQ's partials
// (and dK and dV's) are staged in the warpgroup's own chunks of the Q and dO
// stage, which its products no longer read (beside 208 KB of tiles there is
// room for one of the tile's four 16 KB chunks, not for all), and added by
// bulk reduce-adds of 4 KB a warp.
// fp32 takes scalar FMAs (one block per 32-row kv tile, tiles held in shared
// memory, dQ by atomicAdd); only fp32 training runs it.
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kDMax = 256;            // largest Dh and Dv taken
constexpr int kTileQ = 64;            // rows per query tile; the padding of lse and D
constexpr float kLog2e = 1.4426950408889634f;

// D[b,h,s] = sum_d dO[b,s,h,d] O[b,s,h,d], one warp per (b, h, s) row of a
// buffer padded to sq_pad rows a head (pad rows 0); with lse2, also the
// forward's log-sum-exp times log2(e) there.
template <typename T>
__global__ void bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ dsum,
                               float* __restrict__ lse2, int b, int sq, int sq_pad, int h,
                               int dv, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t d_sb,
                               int64_t d_ss, int64_t d_sh) {
  using E = Elem<T>;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(b) * h * sq_pad) return;
  const int s = static_cast<int>(row % sq_pad);
  const int64_t bh = row / sq_pad;
  if (s >= sq) {
    if (lane == 0) {
      dsum[row] = 0.f;
      if (lse2 != nullptr) lse2[row] = 0.f;
    }
    return;
  }
  const int hh = static_cast<int>(bh % h);
  const int bb = static_cast<int>(bh / h);
  const T* orow = o + bb * o_sb + s * o_ss + hh * o_sh;
  const T* drow = dout + bb * d_sb + s * d_ss + hh * d_sh;
  float acc = 0.f;
  for (int d = lane; d < dv; d += 32) acc += E::to_float(orow[d]) * E::to_float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    dsum[row] = acc;
    if (lse2 != nullptr) lse2[row] = lse[bh * sq + s] * kLog2e;
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kBq = 32;               // query rows per tile
constexpr int kBk = 32;               // kv rows per block
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kBq;  // 8 threads share a row
constexpr int kPLd = kBk + 1;           // fp32 smem row stride of P and dS

// Shared bytes at head-dim capacity kDCap (128 or 256): 73 KB or 137 KB.
template <int kDCap>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * kBk * (kDCap + 1) + 2 * kBq * (kDCap + 1) + 2 * kBq * kPLd + 2 * kBq);
}

template <int kDCap>
__global__ void __launch_bounds__(kThreads)
bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               float* __restrict__ dq_acc, float* __restrict__ dk, float* __restrict__ dvo,
               int sq, int sq_pad, int skv, int h, int kh, int dh, int dv, int dp, int64_t q_sb,
               int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t d_sb, int64_t d_ss,
               int64_t d_sh, int causal, int window, float scale) {
  constexpr int kPer = kDCap / kLanes;    // head dims per thread
  constexpr int kLd = kDCap + 1;          // fp32 smem row stride of q/k/v/dO tiles
  extern __shared__ float smem[];
  float* ks = smem;                 // [kBk][kLd]
  float* vs = ks + kBk * kLd;       // [kBk][kLd]
  float* qs = vs + kBk * kLd;       // [kBq][kLd]
  float* dos = qs + kBq * kLd;      // [kBq][kLd]
  float* ps = dos + kBq * kLd;      // [kBq][kPLd]
  float* dss = ps + kBq * kPLd;     // [kBq][kPLd]
  float* lses = dss + kBq * kPLd;   // [kBq]
  float* dsums = lses + kBq;        // [kBq]

  const int kv0 = blockIdx.x * kBk;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = h / kh;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;

  for (int idx = tid; idx < kBk * dp; idx += kThreads) {
    const int r = idx / dp;
    const int d = idx - r * dp;
    const int kv = kv0 + r;
    float kval = 0.f;
    float vval = 0.f;
    if (kv < skv) {
      if (d < dh) kval = k[bi * k_sb + kv * k_ss + kvh * k_sh + d];
      if (d < dv) vval = v[bi * v_sb + kv * v_ss + kvh * v_sh + d];
    }
    ks[r * kLd + d] = kval;
    vs[r * kLd + d] = vval;
  }

  float dk_acc[kPer];
  float dv_acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  // query rows that can see a kv row of this tile
  int q_begin = 0;
  int q_end = sq;
  if (causal) q_begin = (kv0 / kBq) * kBq;
  if (window > 0) q_end = min(sq, kv0 + kBk - 1 + window);

  for (int hq = kvh * group; hq < (kvh + 1) * group; ++hq) {
    for (int q0 = q_begin; q0 < q_end; q0 += kBq) {
      __syncthreads();  // every thread is done with the previous tile
      for (int idx = tid; idx < kBq * dp; idx += kThreads) {
        const int r = idx / dp;
        const int d = idx - r * dp;
        const int qp = q0 + r;
        float qval = 0.f;
        float dval = 0.f;
        if (qp < sq) {
          if (d < dh) qval = q[bi * q_sb + qp * q_ss + hq * q_sh + d];
          if (d < dv) dval = dout[bi * d_sb + qp * d_ss + hq * d_sh + d];
        }
        qs[r * kLd + d] = qval;
        dos[r * kLd + d] = dval;
      }
      if (tid < kBq) {
        const int qp = q0 + tid;
        const int64_t bh = static_cast<int64_t>(bi) * h + hq;
        lses[tid] = qp < sq ? lse[bh * sq + qp] : 0.f;
        dsums[tid] = qp < sq ? dsum[bh * sq_pad + qp] : 0.f;
      }
      __syncthreads();

      // P and dS for query row `row`, kv columns lane + 8 m
      {
        float sacc[kBk / kLanes];
        float pacc[kBk / kLanes];
#pragma unroll
        for (int m = 0; m < kBk / kLanes; ++m) {
          sacc[m] = 0.f;
          pacc[m] = 0.f;
        }
        for (int d = 0; d < dh; ++d) {
          const float qv = qs[row * kLd + d];
#pragma unroll
          for (int m = 0; m < kBk / kLanes; ++m) {
            sacc[m] = fmaf(qv, ks[(lane + kLanes * m) * kLd + d], sacc[m]);
          }
        }
        for (int d = 0; d < dv; ++d) {
          const float dov = dos[row * kLd + d];
#pragma unroll
          for (int m = 0; m < kBk / kLanes; ++m) {
            pacc[m] = fmaf(dov, vs[(lane + kLanes * m) * kLd + d], pacc[m]);
          }
        }
        const int qpos = q0 + row;
#pragma unroll
        for (int m = 0; m < kBk / kLanes; ++m) {
          const int j = lane + kLanes * m;
          const int kv = kv0 + j;
          const bool live = qpos < sq && kv < skv && (!causal || kv <= qpos) &&
                            (window <= 0 || kv > qpos - window);
          const float p = live ? expf(sacc[m] * scale - lses[row]) : 0.f;
          ps[row * kPLd + j] = p;
          dss[row * kPLd + j] = p * (pacc[m] - dsums[row]);
        }
      }
      __syncthreads();

      // dV and dK of kv row `row`
      for (int i = 0; i < kBq; ++i) {
        const float p = ps[i * kPLd + row];
        const float ds = dss[i * kPLd + row];
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const int d = lane + kLanes * c;
          dv_acc[c] = fmaf(p, dos[i * kLd + d], dv_acc[c]);
          dk_acc[c] = fmaf(ds, qs[i * kLd + d], dk_acc[c]);
        }
      }

      // dQ of query row `row`, added to the fp32 buffer
      const int qpos = q0 + row;
      if (qpos < sq) {
        float dq[kPer];
#pragma unroll
        for (int c = 0; c < kPer; ++c) dq[c] = 0.f;
        for (int j = 0; j < kBk; ++j) {
          const float ds = dss[row * kPLd + j];
#pragma unroll
          for (int c = 0; c < kPer; ++c) dq[c] = fmaf(ds, ks[j * kLd + lane + kLanes * c], dq[c]);
        }
        float* dqrow = dq_acc + ((static_cast<int64_t>(bi) * sq + qpos) * h + hq) * dh;
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const int d = lane + kLanes * c;
          if (d < dh) atomicAdd(dqrow + d, dq[c] * scale);
        }
      }
    }
  }

  const int kv = kv0 + row;
  if (kv >= skv) return;
  float* dkrow = dk + ((static_cast<int64_t>(bi) * skv + kv) * kh + kvh) * dh;
  float* dvrow = dvo + ((static_cast<int64_t>(bi) * skv + kv) * kh + kvh) * dv;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int d = lane + kLanes * c;
    if (d < dh) dkrow[d] = dk_acc[c] * scale;
    if (d < dv) dvrow[d] = dv_acc[c];
  }
}

__global__ void cast_f32_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed tiles and warpgroup products (FlashAttention-3's backward)
// ---------------------------------------------------------------------------

constexpr int kBwStages = 2;     // Q/dO tiles in the ring
constexpr int kBwThreads = 384;  // one producer warpgroup, two consumer warpgroups

// kv rows of a block at padded head dim kD: two warpgroups of 64 up to 128
// dims; above, one set of 64 that the two warpgroups share.
template <int kD>
__host__ __device__ constexpr int bw_rows() {
  return kD > 128 ? 64 : 128;
}

// Every bf16 sub-tile is rows x 64 (128-byte rows, the 128-byte swizzle's
// width) and starts 1024-byte aligned, as the wgmma descriptors assume.
template <int kD>
struct alignas(1024) BwShared {
  static_assert(kD <= 128, "head dims above 128 take BwWideShared");
  static constexpr int kBN = bw_rows<kD>();
  bf16 k[kD / 64][kBN * 64];                      // [d chunk][kv rows x 64]
  bf16 v[kD / 64][kBN * 64];
  bf16 q[kBwStages][kD / 64][kTileQ * 64];        // [stage][d chunk][q rows x 64]
  bf16 dout[kBwStages][kD / 64][kTileQ * 64];
  bf16 ds[2][kBN * kTileQ];                       // dS^T [kv][q], swizzled, double-buffered
  float dq[2][kTileQ * 64];                       // [warpgroup] dQ partial, swizzled
  float lse[kBwStages][kTileQ];                   // log2(e) * lse of the tile's rows
  float dsum[kBwStages][kTileQ];
  uint64_t kv_full;
  uint64_t full[kBwStages];
  uint64_t empty[kBwStages];   // both consumers are done with the stage
};

// Elements d and d + 1 of a bf16 row of n, those that lie in it.
__device__ __forceinline__ void store2(bf16* row, int d, int n, float a0, float a1) {
  if (d + 1 < n && n % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(a0, a1);
  } else {
    if (d < n) row[d] = __float2bfloat16(a0);
    if (d + 1 < n) row[d + 1] = __float2bfloat16(a1);
  }
}

// One kBN-row kv tile of one (kv head, batch), and the query tiles that see it.
struct BwWork {
  int kv0, kvh, bi, qt0, nq;
};

// Work item `item`: kv tiles first in the causal order (tile 0 sees every
// query tile, so the longest items start first), kv heads innermost.
template <int kBN>
__device__ __forceinline__ BwWork bw_work(int item, int kh, int b, int sq, int causal,
                                          int window) {
  BwWork w;
  w.kv0 = (item / (kh * b)) * kBN;
  w.kvh = item % kh;
  w.bi = (item / kh) % b;
  const int q_begin = causal ? w.kv0 : 0;
  int q_end = sq;
  if (window > 0) q_end = min(sq, w.kv0 + kBN - 1 + window);
  w.qt0 = q_begin / kTileQ;
  w.nq = q_end > q_begin ? (q_end + kTileQ - 1) / kTileQ - w.qt0 : 0;
  return w;
}

// One block per work item (bw_work). Warpgroup 0 is the producer: one thread
// loads the item's K and V tiles once and streams the Q and dO tiles of each
// (query head, query tile) with their lse and D through a 2-stage ring, each
// stage guarded by a full (bytes landed) and an empty (both consumers done)
// mbarrier. Warpgroups 1 and 2 each own 64 kv rows and keep dK and dV in
// fp32 registers over the whole item. kD is the head dim padded to 64 or
// 128; TMA zero-fills past Dh, Dv, Sq and Skv, and masks are applied only on
// tiles that a diagonal, a window edge or a ragged end cuts. At kD = 64 the
// first warpgroup alone computes dQ (64 columns).
template <int kD>
__global__ void __launch_bounds__(kBwThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse2, const float* __restrict__ dsum,
                       float* __restrict__ dq_acc, bf16* __restrict__ dk,
                       bf16* __restrict__ dvo, int b, int sq, int sq_pad, int skv, int h,
                       int kh, int dh, int dv, int causal, int window, float scale,
                       float scale_log2) {
  constexpr int kChunks = kD / 64;
  constexpr int kBN = bw_rows<kD>();
  constexpr uint32_t kKvBytes = 2 * kChunks * kBN * 128;
  constexpr uint32_t kStageBytes = 2 * kChunks * kTileQ * 128 + 2 * kTileQ * 4;
  extern __shared__ unsigned char smem_raw[];
  BwShared<kD>& sm = *reinterpret_cast<BwShared<kD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int group = h / kh;
  const BwWork w = bw_work<kBN>(blockIdx.x, kh, b, sq, causal, window);
  const int iters = group * w.nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int st = 0; st < kBwStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0 && iters > 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::tma_prefetch_map(&tdo);
      hopper::mbar_arrive_expect_tx(&sm.kv_full, kKvBytes);
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(sm.k[c], &tk, &sm.kv_full, c * 64, w.kv0, w.kvh, w.bi);
        hopper::tma_load_4d(sm.v[c], &tv, &sm.kv_full, c * 64, w.kv0, w.kvh, w.bi);
      }
      for (int it = 0; it < iters; ++it) {
        const int st = it % kBwStages;
        const int hq = w.kvh * group + it / w.nq;
        const int q0 = (w.qt0 + it % w.nq) * kTileQ;
        hopper::mbar_wait(&sm.empty[st], ((it / kBwStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(sm.q[st][c], &tq, &sm.full[st], c * 64, q0, hq, w.bi);
          hopper::tma_load_4d(sm.dout[st][c], &tdo, &sm.full[st], c * 64, q0, hq, w.bi);
        }
        const int64_t row = (static_cast<int64_t>(w.bi) * h + hq) * sq_pad + q0;
        hopper::bulk_load(sm.lse[st], lse2 + row, kTileQ * 4, &sm.full[st]);
        hopper::bulk_load(sm.dsum[st], dsum + row, kTileQ * 4, &sm.full[st]);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    hopper::reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int rl = (t / 32) * 16 + lane / 4;   // this thread's first row of 64
    const int kw = 64 * wg;                    // first kv row of this warpgroup in the block
    const int kw0 = w.kv0 + kw;
    const bool with_dq = kD == 128 || wg == 0;
    const int dq_chunk = kD == 128 ? wg : 0;   // dQ's 64 columns of this warpgroup
    float dkacc[kD / 2];                       // dK: 64 x kD over the warpgroup
    float dvacc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
    if (iters > 0) hopper::mbar_wait(&sm.kv_full, 0);

    for (int it = 0; it < iters; ++it) {
      const int st = it % kBwStages;
      const int hq = w.kvh * group + it / w.nq;
      const int q0 = (w.qt0 + it % w.nq) * kTileQ;
      hopper::mbar_wait(&sm.full[st], (it / kBwStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, both operands K-major in shared memory.
      // The accumulators live for one tile only (the first k-step overwrites
      // them), so S, dP and dQ never hold registers beside each other.
      float s[32];    // S^T, then P^T: 64 kv x 64 q
      float dp[32];   // dP^T, then dS^T
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint64_t da =
            hopper::sw128_desc(&sm.k[kk / 4][64 * kw + (kk % 4) * 16], 16, 1024);
        const uint64_t db = hopper::sw128_desc(&sm.q[st][kk / 4][(kk % 4) * 16], 16, 1024);
        hopper::wgmma_ss_m64n64k16<0, 0>(s, da, db, kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint64_t da =
            hopper::sw128_desc(&sm.v[kk / 4][64 * kw + (kk % 4) * 16], 16, 1024);
        const uint64_t db = hopper::sw128_desc(&sm.dout[st][kk / 4][(kk % 4) * 16], 16, 1024);
        hopper::wgmma_ss_m64n64k16<0, 0>(dp, da, db, kk > 0);
      }
      hopper::wgmma_commit();

      // Value i of a 64 x 64 fragment sits at row rl + 8 ((i >> 1) & 1), column
      // 8 (i >> 2) + 2 quad + (i & 1).
      const bool cut = q0 + kTileQ > sq || kw0 + 64 > skv || (causal && q0 < kw0 + 63) ||
                       (window > 0 && kw0 <= q0 + kTileQ - 1 - window);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * j + 2 * quad]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = hopper::exp2_approx(s[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
          if (cut) {
            const int kv = kw0 + rl + 8 * (e >> 1);
            const int qp = q0 + 8 * j + 2 * quad + (e & 1);
            const bool live = (kv < skv) & (qp < sq) & (!causal | (kv <= qp)) &
                              ((window <= 0) | (kv > qp - window));
            p = live ? p : 0.f;
          }
          s[i] = p;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(&sm.dsum[st][8 * j + 2 * quad]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = s[i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // P^T and dS^T as bf16 A fragments: k-step kk covers q columns 16 kk + [0, 16)
      uint32_t pa[4][4];
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = pack2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
          da[kk][j] = pack2(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q: B read MN-major (q rows of d values)
      hopper::fence_regs(dvacc);
      hopper::fence_regs(dkacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // chunk c of the stage's dO, rows 16 kk on; the chunks lie kTileQ x 128 B apart
        hopper::wgmma_rs_over_d<kD>(dvacc, pa[kk], [&](int c) {
          return hopper::sw128_desc(&sm.dout[st][c][kk * 16 * 64], kTileQ * 128, 1024);
        });
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_rs_over_d<kD>(dkacc, da[kk], [&](int c) {
          return hopper::sw128_desc(&sm.q[st][c][kk * 16 * 64], kTileQ * 128, 1024);
        });
      }
      hopper::wgmma_commit();

      // dS^T to shared memory, [kv][q] rows of 128 bytes in the 128-byte
      // swizzle (16-byte chunk c of row r at c ^ (r % 8)), for both warpgroups'
      // dQ; the buffer alternates, so one barrier a tile keeps it safe.
      unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.ds[it & 1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = kw + rl + 8 * r;
          *reinterpret_cast<uint32_t*>(dsb + row * 128 + ((j ^ (row & 7)) << 4) + quad * 4) =
              da[j >> 1][((j & 1) << 1) | r];
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1, 256);

      // dQ (64 q x 64 d) = dS K over the tile's 128 kv rows: dS^T read as an
      // MN-major A, K as an MN-major B
      float dqa[32];  // dQ: 64 q x 64 d
      if (with_dq) {
        hopper::fence_regs(dqa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint64_t a = hopper::sw128_desc(dsb + kk * 16 * 128, kBN * 128, 1024);
          const uint64_t bk =
              hopper::sw128_desc(&sm.k[dq_chunk][kk * 16 * 64], kBN * 128, 1024);
          hopper::wgmma_ss_m64n64k16<1, 1>(dqa, a, bk, kk > 0);
        }
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dvacc);
      hopper::fence_regs(dkacc);
      hopper::fence_regs(dqa);
      hopper::keep_regs(pa);
      hopper::keep_regs(da);
      hopper::mbar_arrive(&sm.empty[st]);

      // dQ's partial to the fp32 buffer (B, H, kD/64, sq_pad, 64), rows
      // swizzled as in shared memory, by one bulk reduce-add
      if (with_dq) {
        float* dqs = sm.dq[wg];
        if (t == 0) hopper::bulk_wait_read<0>();
        hopper::named_sync(2 + wg, 128);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = rl + 8 * r;
            *reinterpret_cast<float2*>(&dqs[row * 64 + ((j ^ (row & 7)) << 3) + 2 * quad]) =
                make_float2(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
          }
        }
        hopper::fence_proxy_async();
        hopper::named_sync(2 + wg, 128);
        if (t == 0) {
          const int64_t row0 =
              ((static_cast<int64_t>(w.bi) * h + hq) * kChunks + dq_chunk) * sq_pad + q0;
          float* dst = dq_acc + row0 * 64;
          hopper::bulk_reduce_add(dst, dqs, kTileQ * 64 * 4);
          hopper::bulk_commit();
        }
      }
    }
    if (with_dq && t == 0) hopper::bulk_wait<0>();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kv = kw0 + rl + 8 * r;
      if (kv >= skv) continue;
      const int64_t at = (static_cast<int64_t>(w.bi) * skv + kv) * kh + w.kvh;
      bf16* dkrow = dk + at * dh;
      bf16* dvrow = dvo + at * dv;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int d = j * 8 + 2 * quad;
        store2(dkrow, d, dh, dkacc[4 * j + 2 * r] * scale, dkacc[4 * j + 2 * r + 1] * scale);
        store2(dvrow, d, dv, dvacc[4 * j + 2 * r], dvacc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 above 128 head dims (padded to 192 or 256)
// ---------------------------------------------------------------------------

constexpr int kWideRows = bw_rows<256>();   // kv rows of a wide block: 64
constexpr int kBarP = 4;    // named barriers of the wide kernel (2 and 3: each
constexpr int kBarDs = 5;   // warpgroup's own): P^T written, dS^T written

template <int kD>
struct alignas(1024) BwWideShared {
  bf16 k[kD / 64][kWideRows * 64];                // [d chunk][kv rows x 64]
  bf16 v[kD / 64][kWideRows * 64];
  bf16 q[kBwStages][kD / 64][kTileQ * 64];        // [stage][d chunk][q rows x 64]
  bf16 dout[kBwStages][kD / 64][kTileQ * 64];
  bf16 pt[kWideRows * kTileQ];                    // P^T [kv][q], swizzled
  bf16 ds[kWideRows * kTileQ];                    // dS^T [kv][q], swizzled
  float lse[kBwStages][kTileQ];                   // log2(e) * lse of the tile's rows
  float dsum[kBwStages][kTileQ];
  uint64_t kv_full;
  uint64_t full[kBwStages];
  uint64_t empty[kBwStages];   // every consumer warp is done with the stage
};

// A warpgroup's 64 x 64 fp32 fragment as bf16 wgmma A operands: k-step kk
// covers columns 16 kk + [0, 16).
__device__ __forceinline__ void pack_frag(uint32_t (&f)[4][4], const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[kk][j] = pack2(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
  }
}

// Such A operands to or from a [row][col] tile of 128-byte rows in the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ void frag_store(unsigned char* tile, const uint32_t (&f)[4][4],
                                           int rl, int quad) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      *reinterpret_cast<uint32_t*>(tile + row * 128 + ((j ^ (row & 7)) << 4) + quad * 4) =
          f[j >> 1][((j & 1) << 1) | r];
    }
  }
}

__device__ __forceinline__ void frag_load(const unsigned char* tile, uint32_t (&f)[4][4],
                                          int rl, int quad) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      f[j >> 1][((j & 1) << 1) | r] = *reinterpret_cast<const uint32_t*>(
          tile + row * 128 + ((j ^ (row & 7)) << 4) + quad * 4);
    }
  }
}

// A warp's 16 rows of the 64 x 64 fp32 fragment at values [32 c, 32 c + 32)
// of acc into a 4 KB piece of 16 rows of 64, in the layout of the fp32
// buffers the cast reads (32-byte block j of row r at j ^ (r % 8)).
template <int N>
__device__ __forceinline__ void piece_store(float* piece, const float (&acc)[N], int c,
                                            int lane) {
  const int quad = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lane / 4 + 8 * r;
      *reinterpret_cast<float2*>(&piece[row * 64 + ((j ^ (row & 7)) << 3) + 2 * quad]) =
          make_float2(acc[32 * c + 4 * j + 2 * r], acc[32 * c + 4 * j + 2 * r + 1]);
    }
  }
}

// One block per work item: 64 kv rows of one (kv head, batch) and `heads`
// query heads of its group (the last item of a group takes the rest), items
// of a kv tile adjacent and the longest (causal) first. The producer
// warpgroup streams Q and dO as in flash_bwd_wgmma_kernel. Each product is
// formed once a tile: warpgroup 0 forms S^T = K Q^T and P^T, warpgroup 1
// dP^T = V dO^T and, from P^T read back as bf16, dS^T = P^T (dP^T - D);
// each passes its bf16 result to the other through shared memory (named
// barriers kBarP and kBarDs). Warpgroup wg keeps dK and dV for the d chunks
// [2 wg, 2 wg + 2) (at 192 the second keeps one) and forms dQ = dS K for the
// same chunks. dQ goes to its fp32 buffer by bulk reduce-adds staged in this
// warpgroup's own chunks of the tile's Q and dO stage, which its products no
// longer read; the stage returns to the producer once those adds have read
// it. When the group is split (heads < H / KH), dK and dV go to fp32 buffers
// the same way, staged in the warpgroup's chunks of both stages, and a cast
// pass scales dK and casts both; else they are stored directly.
template <int kD>
__global__ void __launch_bounds__(kBwThreads, 1)
flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse2, const float* __restrict__ dsum,
                      float* __restrict__ dq_acc, float* __restrict__ dk_acc,
                      float* __restrict__ dv_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dvo, int b, int sq, int sq_pad, int skv, int skv_pad,
                      int h, int kh, int dh, int dv, int heads, int causal, int window,
                      float scale, float scale_log2) {
  static_assert(kD == 192 || kD == 256, "the wide instances");
  constexpr int kChunks = kD / 64;
  constexpr int kOwn = 2;                         // d chunks a warpgroup keeps
  constexpr uint32_t kKvBytes = 2 * kChunks * kWideRows * 128;
  constexpr uint32_t kStageBytes = 2 * kChunks * kTileQ * 128 + 2 * kTileQ * 4;
  constexpr uint32_t kPieceBytes = 16 * 64 * 4;   // a warp's 16 fp32 rows of a chunk
  extern __shared__ unsigned char smem_raw[];
  BwWideShared<kD>& sm = *reinterpret_cast<BwWideShared<kD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int group = h / kh;
  const int splits = (group + heads - 1) / heads;
  const BwWork w = bw_work<kWideRows>(blockIdx.x / splits, kh, b, sq, causal, window);
  const int g0 = (blockIdx.x % splits) * heads;   // the item's first head in the group
  const int hq0 = w.kvh * group + g0;
  const int iters = min(heads, group - g0) * w.nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int st = 0; st < kBwStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], 2 * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0 && iters > 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::tma_prefetch_map(&tdo);
      hopper::mbar_arrive_expect_tx(&sm.kv_full, kKvBytes);
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(sm.k[c], &tk, &sm.kv_full, c * 64, w.kv0, w.kvh, w.bi);
        hopper::tma_load_4d(sm.v[c], &tv, &sm.kv_full, c * 64, w.kv0, w.kvh, w.bi);
      }
      for (int it = 0; it < iters; ++it) {
        const int st = it % kBwStages;
        const int hq = hq0 + it / w.nq;
        const int q0 = (w.qt0 + it % w.nq) * kTileQ;
        hopper::mbar_wait(&sm.empty[st], ((it / kBwStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(sm.q[st][c], &tq, &sm.full[st], c * 64, q0, hq, w.bi);
          hopper::tma_load_4d(sm.dout[st][c], &tdo, &sm.full[st], c * 64, q0, hq, w.bi);
        }
        const int64_t row = (static_cast<int64_t>(w.bi) * h + hq) * sq_pad + q0;
        hopper::bulk_load(sm.lse[st], lse2 + row, kTileQ * 4, &sm.full[st]);
        hopper::bulk_load(sm.dsum[st], dsum + row, kTileQ * 4, &sm.full[st]);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    hopper::reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int rl = warp * 16 + lane / 4;       // this thread's first row of 64
    const int c0 = wg * kOwn;                  // first d chunk kept here
    const int nown = min(kOwn, kChunks - c0);  // d chunks kept here: 2, or 1 at 192
    unsigned char* ptb = reinterpret_cast<unsigned char*>(sm.pt);
    unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.ds);
    float dkacc[kOwn * 32];                    // dK: 64 kv x 64 nown d over the warpgroup
    float dvacc[kOwn * 32];
#pragma unroll
    for (int i = 0; i < kOwn * 32; ++i) dkacc[i] = dvacc[i] = 0.f;
    // d (64 kv x 64 nown d) += a (64 kv x 64 q, bf16 A fragments) * this
    // warpgroup's d chunks of a stage's Q or dO tile (q rows, read MN-major),
    // committed as one group
    const auto rs_own = [&](float(&d)[kOwn * 32], const uint32_t(&a)[4][4],
                            bf16(*tile)[kTileQ * 64]) {
      hopper::fence_regs(d);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const auto chunk = [&](int c) {   // the chunks lie kTileQ x 128 B apart
          return hopper::sw128_desc(&tile[c0 + c][kk * 16 * 64], kTileQ * 128, 1024);
        };
        if (nown == kOwn) {
          hopper::wgmma_rs_over_d<64 * kOwn>(d, a[kk], chunk);
        } else {
          hopper::wgmma_rs_m64n64k16<0>(d, a[kk], chunk(0));
        }
      }
      hopper::wgmma_commit();
    };
    if (iters > 0) hopper::mbar_wait(&sm.kv_full, 0);

    for (int it = 0; it < iters; ++it) {
      const int st = it % kBwStages;
      const int hq = hq0 + it / w.nq;
      const int q0 = (w.qt0 + it % w.nq) * kTileQ;
      hopper::mbar_wait(&sm.full[st], (it / kBwStages) & 1);

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), 64 kv x 64
      // q over kD, both operands K-major in shared memory
      float acc[32];
      {
        const bf16(*ta)[kWideRows * 64] = wg == 0 ? sm.k : sm.v;
        const bf16(*tb)[kTileQ * 64] = wg == 0 ? sm.q[st] : sm.dout[st];
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const uint64_t da = hopper::sw128_desc(&ta[kk / 4][(kk % 4) * 16], 16, 1024);
          const uint64_t db = hopper::sw128_desc(&tb[kk / 4][(kk % 4) * 16], 16, 1024);
          hopper::wgmma_ss_m64n64k16<0, 0>(acc, da, db, kk > 0);
        }
        hopper::wgmma_commit();
      }
      // the previous tile's stage goes back to the producer once the bulk
      // reduce-adds have read the dQ this warp staged in it
      if (it > 0 && lane == 0) {
        hopper::bulk_wait_read<0>();
        hopper::mbar_arrive(&sm.empty[(it - 1) % kBwStages]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);

      // Value i of a 64 x 64 fragment sits at row rl + 8 ((i >> 1) & 1), column
      // 8 (i >> 2) + 2 quad + (i & 1). P^T and dS^T as bf16 A fragments:
      uint32_t pa[4][4];
      uint32_t da[4][4];
      if (wg == 0) {
        const bool cut = q0 + kTileQ > sq || w.kv0 + 64 > skv ||
                         (causal && q0 < w.kv0 + 63) ||
                         (window > 0 && w.kv0 <= q0 + kTileQ - 1 - window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * j + 2 * quad]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = hopper::exp2_approx(acc[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
            if (cut) {
              const int kv = w.kv0 + rl + 8 * (e >> 1);
              const int qp = q0 + 8 * j + 2 * quad + (e & 1);
              const bool live = (kv < skv) & (qp < sq) & (!causal | (kv <= qp)) &
                                ((window <= 0) | (kv > qp - window));
              p = live ? p : 0.f;
            }
            acc[i] = p;
          }
        }
        pack_frag(pa, acc);
        frag_store(ptb, pa, rl, quad);   // read by warpgroup 1's threads only
        hopper::named_arrive(kBarP, 256);

        rs_own(dvacc, pa, sm.dout[st]);   // dV += P^T dO, while warpgroup 1 forms dS^T
        hopper::named_sync(kBarDs, 256);
        frag_load(dsb, da, rl, quad);
      } else {
        hopper::named_sync(kBarP, 256);
        frag_load(ptb, pa, rl, quad);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(&sm.dsum[st][8 * j + 2 * quad]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const uint32_t u = pa[i >> 3][(i >> 1) & 3];
            const float p = __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
            acc[i] = p * (acc[i] - ((e & 1) ? d2.y : d2.x));
          }
        }
        pack_frag(da, acc);
        frag_store(dsb, da, rl, quad);   // and read by both warpgroups' dQ products
        hopper::fence_proxy_async();
        hopper::named_arrive(kBarDs, 256);

        rs_own(dvacc, pa, sm.dout[st]);   // dV += P^T dO
      }

      rs_own(dkacc, da, sm.q[st]);   // dK += dS^T Q
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dvacc);
      hopper::fence_regs(dkacc);
      hopper::keep_regs(pa);
      hopper::keep_regs(da);

      // Every product of this warpgroup is done with its chunks of the stage
      // (the other warpgroup's S^T or dP^T were done before its handshake), so
      // they take dQ: warp w's 16 rows of chunk c0 + c in the 4 KB at row 16
      // (w % 2) of the stage's Q (warps 0-1) or dO (2-3) sub-tile c0 + c, added
      // to the buffer (B, H, kD/64, sq_pad, 64) by one bulk reduce-add each.
      hopper::named_sync(2 + wg, 128);
      bf16(*stage)[kTileQ * 64] = warp < 2 ? sm.q[st] : sm.dout[st];
#pragma unroll
      for (int c = 0; c < kOwn; ++c) {
        if (c >= nown) break;
        // dQ (64 q x 64 d) = dS K over the block's 64 kv rows, one d chunk at
        // a time: dS^T read as an MN-major A, K as an MN-major B
        float dqa[32];
        hopper::fence_regs(dqa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWideRows / 16; ++kk) {
          const uint64_t a = hopper::sw128_desc(dsb + kk * 16 * 128, kWideRows * 128, 1024);
          const uint64_t bk =
              hopper::sw128_desc(&sm.k[c0 + c][kk * 16 * 64], kWideRows * 128, 1024);
          hopper::wgmma_ss_m64n64k16<1, 1>(dqa, a, bk, kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dqa);
        piece_store(reinterpret_cast<float*>(stage[c0 + c]) + (warp & 1) * 1024, dqa, 0, lane);
      }
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        for (int c = 0; c < nown; ++c) {
          const int64_t row0 =
              ((static_cast<int64_t>(w.bi) * h + hq) * kChunks + c0 + c) * sq_pad + q0 +
              16 * warp;
          hopper::bulk_reduce_add(
              dq_acc + row0 * 64,
              reinterpret_cast<const float*>(stage[c0 + c]) + (warp & 1) * 1024, kPieceBytes);
        }
        hopper::bulk_commit();
      }
    }
    if (lane == 0) hopper::bulk_wait_read<0>();

    if (heads >= group) {
      // the item saw the whole group: dK and dV go out directly
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kv = w.kv0 + rl + 8 * r;
        if (kv >= skv) continue;
        const int64_t at = (static_cast<int64_t>(w.bi) * skv + kv) * kh + w.kvh;
        bf16* dkrow = dk + at * dh;
        bf16* dvrow = dvo + at * dv;
#pragma unroll
        for (int j = 0; j < kOwn * 8; ++j) {
          if (j >= nown * 8) break;
          const int d = c0 * 64 + j * 8 + 2 * quad;
          store2(dkrow, d, dh, dkacc[4 * j + 2 * r] * scale, dkacc[4 * j + 2 * r + 1] * scale);
          store2(dvrow, d, dv, dvacc[4 * j + 2 * r], dvacc[4 * j + 2 * r + 1]);
        }
      }
    } else if (iters > 0) {
      // the item's partials of dK and dV to the fp32 buffers (B, KH, kD/64,
      // skv_pad, 64), staged in this warpgroup's chunks of both stages (warp
      // w: stage w / 2, rows 16 (w % 2) on), once every warp's dQ is read
      hopper::named_sync(2 + wg, 128);
#pragma unroll
      for (int c = 0; c < kOwn; ++c) {
        if (c >= nown) break;
        piece_store(reinterpret_cast<float*>(sm.q[warp >> 1][c0 + c]) + (warp & 1) * 1024,
                    dkacc, c, lane);
        piece_store(reinterpret_cast<float*>(sm.dout[warp >> 1][c0 + c]) + (warp & 1) * 1024,
                    dvacc, c, lane);
      }
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        for (int c = 0; c < nown; ++c) {
          const int64_t row0 =
              ((static_cast<int64_t>(w.bi) * kh + w.kvh) * kChunks + c0 + c) * skv_pad + w.kv0 +
              16 * warp;
          hopper::bulk_reduce_add(
              dk_acc + row0 * 64,
              reinterpret_cast<const float*>(sm.q[warp >> 1][c0 + c]) + (warp & 1) * 1024,
              kPieceBytes);
          hopper::bulk_reduce_add(
              dv_acc + row0 * 64,
              reinterpret_cast<const float*>(sm.dout[warp >> 1][c0 + c]) + (warp & 1) * 1024,
              kPieceBytes);
        }
        hopper::bulk_commit();
      }
    }
    if (lane == 0) hopper::bulk_wait<0>();
  }
}

// dq (B,Sq,H,Dh) bf16 = scale * the (B, H, kD/64, sq_pad, 64) fp32 buffer,
// un-swizzling each row: a thread takes 8 consecutive d of one row, one
// 32-byte piece of the buffer (two 16-byte loads) and one 16-byte store. The
// wide kernel's split dK and dV buffers, (B, KH, kD/64, skv_pad, 64), are
// cast by the same kernel.
__global__ void cast_dq_kernel(const float* __restrict__ src, bf16* __restrict__ dq, int sq,
                               int sq_pad, int h, int dh, int chunks, float scale, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int groups = (dh + 7) / 8;
  const int d0 = static_cast<int>(i % groups) * 8;
  const int64_t r = i / groups;   // row (b, s, head) of dq
  const int hh = static_cast<int>(r % h);
  const int s = static_cast<int>((r / h) % sq);
  const int64_t bb = r / (static_cast<int64_t>(h) * sq);
  const int col = d0 % 64;
  const float4* p = reinterpret_cast<const float4*>(
      src + (((bb * h + hh) * chunks + d0 / 64) * sq_pad + s) * 64 + (((col >> 3) ^ (s & 7)) << 3));
  const float4 a = p[0];
  const float4 c = p[1];
  const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  bf16* out = dq + r * dh + d0;
  if (dh % 8 == 0) {
    uint4 u;
    u.x = pack2(v[0] * scale, v[1] * scale);
    u.y = pack2(v[2] * scale, v[3] * scale);
    u.z = pack2(v[4] * scale, v[5] * scale);
    u.w = pack2(v[6] * scale, v[7] * scale);
    *reinterpret_cast<uint4*>(out) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (d0 + e < dh) out[e] = __float2bfloat16(v[e] * scale);
    }
  }
}

template <int kD>
int launch_wgmma(const long long* st, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse2, const float* dsum, float* dq_acc,
                 void* dq, void* dk, void* dv_out, int b, int sq, int sq_pad, int skv, int h,
                 int kh, int dh, int dv, int causal, int window, float scale,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::encode_bshd(&tq, q, b, sq, h, dh, st[0], st[1], st[2], kTileQ) ||
      !hopper::encode_bshd(&tk, k, b, skv, kh, dh, st[3], st[4], st[5], bw_rows<kD>()) ||
      !hopper::encode_bshd(&tv, v, b, skv, kh, dv, st[6], st[7], st[8], bw_rows<kD>()) ||
      !hopper::encode_bshd(&tdo, dout, b, sq, h, dv, st[12], st[13], st[14], kTileQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = static_cast<int>(sizeof(BwShared<kD>)) + 1024;
  auto kernel = flash_bwd_wgmma_kernel<kD>;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int items = (skv + bw_rows<kD>() - 1) / bw_rows<kD>() * kh * b;
  kernel<<<items, kBwThreads, kSmem, stream>>>(
      tq, tk, tv, tdo, lse2, dsum, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv_out),
      b, sq, sq_pad, skv, h, kh, dh, dv, causal, window, scale, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(b) * sq * h * ((dh + 7) / 8);
  cast_dq_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<bf16*>(dq), sq, sq_pad, h, dh, kD / 64, scale, n);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_wide(const long long* st, const void* q, const void* k, const void* v,
                const void* dout, const float* lse2, const float* dsum, float* dq_acc,
                float* dkv_acc, void* dq, void* dk, void* dv_out, int b, int sq, int sq_pad,
                int skv, int h, int kh, int dh, int dv, int heads, int causal, int window,
                float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::encode_bshd(&tq, q, b, sq, h, dh, st[0], st[1], st[2], kTileQ) ||
      !hopper::encode_bshd(&tk, k, b, skv, kh, dh, st[3], st[4], st[5], kWideRows) ||
      !hopper::encode_bshd(&tv, v, b, skv, kh, dv, st[6], st[7], st[8], kWideRows) ||
      !hopper::encode_bshd(&tdo, dout, b, sq, h, dv, st[12], st[13], st[14], kTileQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = static_cast<int>(sizeof(BwWideShared<kD>)) + 1024;
  auto kernel = flash_bwd_wide_kernel<kD>;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int group = h / kh;
  const int splits = (group + heads - 1) / heads;
  const int skv_pad = (skv + kWideRows - 1) / kWideRows * kWideRows;
  const int items = skv_pad / kWideRows * kh * b * splits;
  float* dk_acc = splits > 1 ? dkv_acc : nullptr;
  float* dv_acc = splits > 1 ? dkv_acc + static_cast<int64_t>(b) * kh * skv_pad * kD : nullptr;
  kernel<<<items, kBwThreads, kSmem, stream>>>(
      tq, tk, tv, tdo, lse2, dsum, dq_acc, dk_acc, dv_acc, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv_out), b, sq, sq_pad, skv, skv_pad, h, kh, dh, dv, heads, causal,
      window, scale, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(b) * sq * h * ((dh + 7) / 8);
  cast_dq_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<bf16*>(dq), sq, sq_pad, h, dh, kD / 64, scale, n);
  if (splits > 1) {   // dK and dV from their fp32 buffers, as dQ from its
    const int64_t nk = static_cast<int64_t>(b) * skv * kh * ((dh + 7) / 8);
    cast_dq_kernel<<<static_cast<unsigned>((nk + 255) / 256), 256, 0, stream>>>(
        dk_acc, static_cast<bf16*>(dk), skv, skv_pad, kh, dh, kD / 64, scale, nk);
    const int64_t nv = static_cast<int64_t>(b) * skv * kh * ((dv + 7) / 8);
    cast_dq_kernel<<<static_cast<unsigned>((nv + 255) / 256), 256, 0, stream>>>(
        dv_acc, static_cast<bf16*>(dv_out), skv, skv_pad, kh, dv, kD / 64, 1.f, nv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kDCap>
int launch_f32(const long long* st, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dsum, float* dq_acc, void* dq,
               void* dk, void* dv_out, int b, int sq, int sq_pad, int skv, int h, int kh,
               int dh, int dv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t kSmemBytes = f32_smem_bytes<kDCap>();
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(bwd_f32_kernel<kDCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int dp = dh > dv ? dh : dv;
  const dim3 grid((skv + kBk - 1) / kBk, kh, b);
  bwd_f32_kernel<kDCap><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, dq_acc, static_cast<float*>(dk),
      static_cast<float*>(dv_out), sq, sq_pad, skv, h, kh, dh, dv, dp, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(b) * sq * h * dh;
  cast_f32_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<float*>(dq), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Returns the first CUDA error of the launches (0 on success). q, k, v, o and
// dO are read through their strides (elements; the last dimension is dense),
// given as 15 values: (batch, sequence, head) strides of q, k, v, o and dO in
// that order. lse (from the forward) is a dense fp32 (B,H,Sq); dsum and lse2
// are fp32 scratch of B * H * sq_pad values (sq_pad = Sq rounded up to 64);
// dq_acc is an fp32 buffer the caller zeroes, of B * H * sq_pad * D_pad
// values, D_pad = max(Dh, Dv) rounded up to 64;
// dq, dk and dv are dense outputs in the input type. window <= 0 means no
// sliding window. bf16 q, k, v and dO must have 16-byte aligned bases and
// strides (TMA describes them; the wrapper pads inputs that are not), else the
// call returns cudaErrorInvalidValue without a launch. The caller guarantees
// 1 <= Dh, Dv <= 256 and H % KH == 0. `heads` is the number of query heads a
// work item of the bf16 kernel takes above 128 dims (the wrapper's bwd_plan;
// H / KH or more: the whole group); where it is less, dkv_acc is an fp32
// buffer the caller zeroes, of 2 * B * KH * skv_pad * D_pad values (skv_pad =
// Skv rounded up to 64). Other calls ignore both.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* dsum, void* lse2, void* dq_acc, void* dq, void* dk,
                                   void* dv_out, int b, int sq, int skv, int h, int kh, int dh,
                                   int dv, const long long* strides, int causal, int window,
                                   float scale, void* dkv_acc, int heads, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dv < 1 || dh > kDMax || dv > kDMax || kh < 1 || h % kh != 0 ||
      (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sq_pad = (sq + kTileQ - 1) / kTileQ * kTileQ;
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  float* l2 = dtype == kBFloat16 ? static_cast<float*>(lse2) : nullptr;
  const int64_t rows = static_cast<int64_t>(b) * h * sq_pad;
  const unsigned dot_blocks = static_cast<unsigned>((rows + 7) / 8);
  const long long* s = strides;
  if (dtype == kFloat32) {
    bwd_dot_kernel<float><<<dot_blocks, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), l, ds, l2, b, sq, sq_pad,
        h, dv, s[9], s[10], s[11], s[12], s[13], s[14]);
  } else {
    bwd_dot_kernel<bf16><<<dot_blocks, 256, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), l, ds, l2, b, sq, sq_pad,
        h, dv, s[9], s[10], s[11], s[12], s[13], s[14]);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* acc = static_cast<float*>(dq_acc);
  const int dmax = dh > dv ? dh : dv;
  if (dtype == kFloat32) {
    auto run = dmax > 128 ? launch_f32<256> : launch_f32<128>;
    return run(s, q, k, v, dout, l, ds, acc, dq, dk, dv_out, b, sq, sq_pad, skv, h, kh, dh, dv,
               causal, window, scale, st);
  }
  if (dmax > 128) {
    const int group = h / kh;
    const int per = heads < 1 || heads > group ? group : heads;
    auto run = dmax > 192 ? launch_wide<256> : launch_wide<192>;
    return run(s, q, k, v, dout, l2, ds, acc, static_cast<float*>(dkv_acc), dq, dk, dv_out, b,
               sq, sq_pad, skv, h, kh, dh, dv, per, causal, window, scale, st);
  }
  auto run = dmax > 64 ? launch_wgmma<128> : launch_wgmma<64>;
  return run(s, q, k, v, dout, l2, ds, acc, dq, dk, dv_out, b, sq, sq_pad, skv, h, kh, dh, dv,
             causal, window, scale, st);
}
