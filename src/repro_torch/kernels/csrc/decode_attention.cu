// Flash-decode (one query token against a KV cache) for Hopper, sm_90a, with a
// plain C entry point for ctypes.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention ->
// _decode_kernel, the Pallas TPU kernel. Same contract: q (B,H,Dh), caches
// (B,S,KH,Dh) and (B,S,KH,Dv), n_valid (B,) int32 -> o (B,H,Dv); cache slots
// at or past n_valid[b] are masked; no sliding window; fp32 softmax state.
// Where n_valid[b] <= 0 every slot is masked and, as in the reference, the
// softmax is uniform over all S slots.
//
// What bounds it on an H100: each call reads the valid part of one layer's K
// and V cache once (17 MB at B=4, S=1056, KH=8, D=128 in bf16; 4.3 MB at
// gemma-2b's KH=1, D=256) and does about 2 FLOP per byte times the group, so
// memory bandwidth bounds it (~5 us at 3.35 TB/s).
//
// Design (flash-decoding: the cache is split over blocks, then merged):
//   * the grid is (KH, B, splits); a block takes one kv head of one batch row
//     and one split of `chunk` slots, and all G query heads of the group
//     together, so each cache row is read once for all G heads. The wrapper
//     chooses splits and chunk from S, B and KH (never from n_valid, which
//     lives on the card) so that the card holds ~2 blocks per SM;
//   * the block streams its slots through a ring of tiles in shared memory
//     with 16-byte cp.async copies (zero past Dh, Dv and the split's end); the
//     wrapper gives the kernel caches whose base and row strides are 16-byte
//     multiples (misaligned ones as zero-padded copies);
//   * bf16 (the serving path) runs both products on the tensor cores
//     (decode_mma_kernel): the G heads are the 16 rows of mma.sync m16n8k16
//     (zero past G), each warp takes 16 slots of a tile, K fragments come by
//     ldmatrix and V fragments by ldmatrix.trans, and the probabilities pass
//     from the scores' accumulators to the second product in registers
//     (rounded to bf16, as the flash forward does); one online-softmax update
//     per 16 slots;
//   * fp32 runs scalar FMAs (decode_f32_kernel): a cache row is spread over
//     the 32 lanes of a warp, 4 dims a lane (8 above 128 dims); each warp
//     scores its rows of a tile one at a time against the group's heads (up
//     to 16; above 128 dims up to 8 a block, the grid taking the group in
//     passes of 8) and makes one online-softmax update per row;
//   * the warps' (m, l, acc) merge through shared memory into one fp32
//     partial per (b, head, split), in base 2; a second small kernel, launched
//     by the same entry call, merges the splits. A split that starts at or
//     past a positive n_valid[b] writes m = -1e30, l = 0 and adds nothing;
//     with n_valid[b] <= 0 each split holds m = -1e30, l = its slot count and
//     the sum of its V rows, and the merge gives the uniform average.
// bf16 above 128 dims (padded to 192 or 256: gemma-2b's MQA, stablelm-12b's
// and nemotron-4-340b's GQA) takes one launch of decode_wide_kernel instead.
// There a call moves little (4.3 MB at gemma-2b's serving cache, 1.3 us at
// 3.35 TB/s) and the split pass's fixed latencies were the cost: q by 2-byte
// loads before the first tile's copies, one 64-slot tile a block, a 64 KB
// merge of the warps' outputs in shared memory, and a second launch reading
// the partials back. Its answers: the cache by TMA boxes (a few operations a
// block) issued before q and n_valid are read; a warp per 32 output dims, so
// the warps share one softmax maximum a round through shared memory and need
// no merge of their outputs; the splits of one (b, kv head) as one thread
// block cluster that merges them in the same launch (through L2, between
// one cluster barrier); the plan (decode_wide_plan) about one block per two
// SMs, since each block's fixed costs (its first loads, the cluster barrier
// and the merge) outweigh its slots' work at these sizes
// (scripts/kernel_report.py --sweep times the cluster sizes).
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kDMax = 256;     // largest Dh and Dv taken
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGMax = 16;      // largest group of query heads per kv head
constexpr int kStages = 2;     // tiles in flight per block
constexpr float kLog2e = 1.4426950408889634f;   // scores and partial maxima are base 2

// One tile of kRows cache rows from `first` on, K and V, into one stage with
// rows kLd elements apart; rows at or past `end` and dims past dh / dv are zero.
// The bases and row strides are 16-byte multiples.
template <typename T, int kD, int kRows, int kLd>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kbase, const T* vbase,
                                          int first, int end, int dh, int dv, int64_t k_ss,
                                          int64_t v_ss) {
  constexpr int kPack = 16 / sizeof(T);
  constexpr int kChunks = kD / kPack;          // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < 2 * kRows * kChunks; idx += kThreads) {
    const bool is_v = idx >= kRows * kChunks;
    const int i = is_v ? idx - kRows * kChunks : idx;
    const int r = i / kChunks;
    const int c = (i % kChunks) * kPack;
    const int p = first + r;
    const int d = is_v ? dv : dh;
    const T* src = is_v ? vbase + p * v_ss : kbase + p * k_ss;
    T* dst = (is_v ? vs : ks) + r * kLd + c;
    const int n = p < end ? min(max(d - c, 0), kPack) : 0;
    hopper::cp_async16(dst, n > 0 ? src + c : (is_v ? vbase : kbase),
                       n * static_cast<int>(sizeof(T)));
  }
}

// The block's partial from its workers' states in shared memory: acc
// [kWorkers][kG][kD], m and l [kWorkers][kG] (base 2). Writes (M, L) and
// sum_w acc_w 2^(m_w - M) for each of the g heads. Ends the block's use of
// the three arrays; the caller has synchronised after writing them.
template <int kWorkers, int kG, int kD>
__device__ __forceinline__ void merge_workers(const float* s_acc, const float* s_m, float* s_l,
                                              float* part_ml, float* part_acc, int64_t part0,
                                              int g, int dv, int splits) {
  // one weight per (worker, head): 2^(m_w - M) for the head's max M
  if (threadIdx.x < kG) {
    const int gi = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) mx = fmaxf(mx, s_m[w * kG + gi]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) {
      const float f = hopper::exp2_approx(s_m[w * kG + gi] - mx);
      den = fmaf(s_l[w * kG + gi], f, den);
      s_l[w * kG + gi] = f;
    }
    if (gi < g) {
      const int64_t part = part0 + static_cast<int64_t>(gi) * splits;
      part_ml[2 * part] = mx;
      part_ml[2 * part + 1] = den;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * dv; idx += kThreads) {
    const int gi = idx / dv;
    const int d = idx - gi * dv;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) {
      num = fmaf(s_acc[(w * kG + gi) * kD + d], s_l[w * kG + gi], num);
    }
    part_acc[(part0 + static_cast<int64_t>(gi) * splits) * dv + d] = num;
  }
}

// A split that starts at or past a positive n_valid: the merge weighs it by 0.
__device__ __forceinline__ void write_empty(float* part_ml, float* part_acc, int64_t part0,
                                            int g, int dv, int splits) {
  for (int idx = threadIdx.x; idx < g * dv; idx += kThreads) {
    part_acc[(part0 + static_cast<int64_t>(idx / dv) * splits) * dv + idx % dv] = 0.f;
  }
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    part_ml[2 * (part0 + static_cast<int64_t>(gi) * splits)] = kNegInf;
    part_ml[2 * (part0 + static_cast<int64_t>(gi) * splits) + 1] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;                    // cache rows per tile
constexpr int kF32WarpRows = kF32Rows / kWarps;  // rows of a tile per warp

// kDCap: the dims a block holds, 128 or 256 (4 or 8 a lane); kG: the heads a
// block scores, 16 or 8. blockIdx.x is kv head x pass: pass p takes heads
// [p kG, p kG + kG) of the group. Heads past the real group score zeros and
// are never written. Each warp keeps its own (m, l, acc): the workers that
// merge_workers joins.
template <int kDCap, int kG>
__global__ void __launch_bounds__(kThreads)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                  const float* __restrict__ vc, const int* __restrict__ n_valid,
                  float* __restrict__ part_ml, float* __restrict__ part_acc, int s, int h,
                  int dh, int dv, int group, int splits, int chunk, int64_t q_sb, int64_t q_sh,
                  int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                  int64_t v_sh, float scale_log2) {
  constexpr int kP = kDCap / 32;                 // dims per lane: whole float4s
  static_assert(kP % 4 == 0, "a lane's dims are whole float4s");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);      // [kStages][kF32Rows][kDCap]
  float* vs = ks + kStages * kF32Rows * kDCap;         // [kStages][kF32Rows][kDCap]

  const int passes = (group + kG - 1) / kG;
  const int khi = blockIdx.x / passes;
  const int g0 = (blockIdx.x % passes) * kG;     // first head of the group in this block
  const int g = min(kG, group - g0);             // heads of this block
  const int bi = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, s);
  int n = n_valid[bi];
  const bool none_valid = n <= 0;
  n = none_valid ? s : min(n, s);
  const int end = min(s1, n);    // slots [s0, end) count in this split
  const int64_t part0 = (static_cast<int64_t>(bi) * h + khi * group + g0) * splits + split;

  if (end <= s0) {   // nothing to add
    write_empty(part_ml, part_acc, part0, g, dv, splits);
    return;
  }
  const int ntiles = (end - s0 + kF32Rows - 1) / kF32Rows;
  const float* kbase = kc + bi * k_sb + khi * k_sh;
  const float* vbase = vc + bi * v_sb + khi * v_sh;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) {
      load_tile<float, kDCap, kF32Rows, kDCap>(ks + t * kF32Rows * kDCap,
                                               vs + t * kF32Rows * kDCap, kbase, vbase,
                                               s0 + t * kF32Rows, end, dh, dv, k_ss, v_ss);
    }
    hopper::cp_async_commit();
  }

  hopper::launch_dependents();
  float qr[kG][kP];
  float acc[kG][kP];
  float m[kG];
  float l[kG];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    const int64_t qoff = bi * q_sb + static_cast<int64_t>(khi * group + g0 + gi) * q_sh;
#pragma unroll
    for (int e = 0; e < kP; ++e) {
      const int d = lane * kP + e;
      qr[gi][e] = (gi < g && d < dh) ? q[qoff + d] : 0.f;
      acc[gi][e] = 0.f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int ahead = t + kStages - 1;
    if (ahead < ntiles) {
      const int st = ahead % kStages;
      load_tile<float, kDCap, kF32Rows, kDCap>(ks + st * kF32Rows * kDCap,
                                               vs + st * kF32Rows * kDCap, kbase, vbase,
                                               s0 + ahead * kF32Rows, end, dh, dv, k_ss, v_ss);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<kStages - 1>();   // tile t has landed
    __syncthreads();
    const float* kt = ks + (t % kStages) * kF32Rows * kDCap;
    const float* vt = vs + (t % kStages) * kF32Rows * kDCap;
    for (int r = 0; r < kF32WarpRows; ++r) {
      const int row = warp * kF32WarpRows + r;
      if (s0 + t * kF32Rows + row >= end) break;   // the same for the whole warp
      float kf[kP];
      float vf[kP];
#pragma unroll
      for (int e = 0; e < kP; e += 4) {
        Elem<float>::load_pack(kt + row * kDCap + lane * kP + e, kf + e);
        Elem<float>::load_pack(vt + row * kDCap + lane * kP + e, vf + e);
      }
      float sc[kG];
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kP; ++e) dot = fmaf(qr[gi][e], kf[e], dot);
        sc[gi] = dot;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) sc[gi] += __shfl_xor_sync(0xffffffffu, sc[gi], off);
      }
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        const float x = none_valid ? kNegInf : sc[gi] * scale_log2;
        const float mx = fmaxf(m[gi], x);
        const float corr = hopper::exp2_approx(m[gi] - mx);
        const float p = hopper::exp2_approx(x - mx);
        l[gi] = fmaf(l[gi], corr, p);
#pragma unroll
        for (int e = 0; e < kP; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e] * corr);
        m[gi] = mx;
      }
    }
    __syncthreads();   // the stage is free for the tile kStages ahead
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  // Merge the warps' states through shared memory (the stages are free).
  float* s_acc = reinterpret_cast<float*>(smem_raw);   // [kWarps][kG][kDCap]
  float* s_m = s_acc + kWarps * kG * kDCap;            // [kWarps][kG]
  float* s_l = s_m + kWarps * kG;
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
#pragma unroll
    for (int e = 0; e < kP; ++e) s_acc[(warp * kG + gi) * kDCap + lane * kP + e] = acc[gi][e];
    if (lane == 0) {
      s_m[warp * kG + gi] = m[gi];
      s_l[warp * kG + gi] = l[gi];
    }
  }
  __syncthreads();
  merge_workers<kWarps, kG, kDCap>(s_acc, s_m, s_l, part_ml, part_acc, part0, g, dv, splits);
}

// ---------------------------------------------------------------------------
// bf16: the G heads as the 16 rows of mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;     // slots per tile: 16 per warp

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}

// kD: Dh and Dv padded to 64 or 128 (above, decode_wide_kernel). Shared-memory
// rows are kD + 8 elements apart (16 bytes of padding), so ldmatrix's eight
// row addresses fall on distinct banks. Fragment layouts of m16n8k16 (PTX ISA), with gq = lane / 4
// and t = lane % 4: C values {0,1,2,3} at (gq, 2t), (gq, 2t+1), (gq+8, 2t),
// (gq+8, 2t+1); here a row is a head and a column a slot (scores) or a dim
// (output).
template <int kD>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc, const int* __restrict__ n_valid,
                  float* __restrict__ part_ml, float* __restrict__ part_acc, int s, int h,
                  int dh, int dv, int g, int splits, int chunk, int64_t q_sb, int64_t q_sh,
                  int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                  int64_t v_sh, float scale_log2) {
  static_assert(kD <= 128, "head dims above 128 take decode_wide_kernel");
  constexpr int kLd = kD + 8;
  constexpr int kSteps = kD / 16;     // k-steps of the scores
  constexpr int kDt = kD / 8;         // 8-dim tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);       // [kStages][kMmaRows][kLd]
  bf16* vs = ks + kStages * kMmaRows * kLd;

  const int khi = blockIdx.x;
  const int bi = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t4 = lane % 4;
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, s);
  const bf16* kbase = kc + bi * k_sb + khi * k_sh;
  const bf16* vbase = vc + bi * v_sb + khi * v_sh;
  // q as A fragments: rows = heads of the group (zero past g), k = dims
  uint32_t qa[kSteps][4];
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = gq + (r & 1) * 8;
      const int c = st * 16 + 2 * t4 + (r >= 2 ? 8 : 0);
      const bf16* qrow = q + bi * q_sb + static_cast<int64_t>(khi * g + gi) * q_sh;
      const bool in = gi < g;
      qa[st][r] = pack2(in && c < dh ? qrow[c] : zero, in && c + 1 < dh ? qrow[c + 1] : zero);
    }
  }

  int n = n_valid[bi];
  const bool none_valid = n <= 0;
  n = none_valid ? s : min(n, s);
  const int end = min(s1, n);
  const int64_t part0 = (static_cast<int64_t>(bi) * h + khi * g) * splits + split;
  if (end <= s0) {
    write_empty(part_ml, part_acc, part0, g, dv, splits);
    return;
  }
  const int ntiles = (end - s0 + kMmaRows - 1) / kMmaRows;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) {
      load_tile<bf16, kD, kMmaRows, kLd>(ks + t * kMmaRows * kLd, vs + t * kMmaRows * kLd,
                                         kbase, vbase, s0 + t * kMmaRows, end, dh, dv, k_ss,
                                         v_ss);
    }
    hopper::cp_async_commit();
  }
  hopper::launch_dependents();
  float o[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};   // heads gq and gq + 8
  float l[2] = {0.f, 0.f};           // this thread's share of each head's sum

  for (int t = 0; t < ntiles; ++t) {
    const int ahead = t + kStages - 1;
    if (ahead < ntiles) {
      const int st = ahead % kStages;
      load_tile<bf16, kD, kMmaRows, kLd>(ks + st * kMmaRows * kLd, vs + st * kMmaRows * kLd,
                                         kbase, vbase, s0 + ahead * kMmaRows, end, dh, dv,
                                         k_ss, v_ss);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<kStages - 1>();
    __syncthreads();
    const int slot0 = s0 + t * kMmaRows + warp * 16;
    if (slot0 < end) {   // the same for the whole warp
      const bf16* kt = ks + (t % kStages) * kMmaRows * kLd + warp * 16 * kLd;
      const bf16* vt = vs + (t % kStages) * kMmaRows * kLd + warp * 16 * kLd;
      // scores: sc[j] is the 16 x 8 tile of slots [8 j, 8 j + 8) of this warp
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int mi = lane / 8;
      const int rr = lane % 8;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t b[4];   // {b0, b1} of slots 0-7, then of slots 8-15
        ldmatrix_x4(b, kt + ((mi >> 1) * 8 + rr) * kLd + st * 16 + (mi & 1) * 8);
        mma_bf16(sc[0], qa[st], b[0], b[1]);
        mma_bf16(sc[1], qa[st], b[2], b[3]);
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = slot0 + 8 * j + 2 * t4 + (e & 1) < end;
          const float x = none_valid ? kNegInf : sc[j][e] * scale_log2;
          sc[j][e] = x;
          if (live) mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = hopper::exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = slot0 + 8 * j + 2 * t4 + (e & 1) < end;
          const float p = live ? hopper::exp2_approx(sc[j][e] - m[e >> 1]) : 0.f;
          sc[j][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < kDt; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      const uint32_t pa[4] = {pack2(sc[0][0], sc[0][1]), pack2(sc[0][2], sc[0][3]),
                              pack2(sc[1][0], sc[1][1]), pack2(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b[4];   // {b0, b1} of dims [16 dp, 16 dp + 8), then of the next 8
        ldmatrix_x4_trans(b, vt + ((mi & 1) * 8 + rr) * kLd + dp * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  float* s_acc = reinterpret_cast<float*>(smem_raw);   // [kWarps][16][kD]
  float* s_m = s_acc + kWarps * 16 * kD;               // [kWarps][16]
  float* s_l = s_m + kWarps * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int j = 0; j < kDt; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_acc[(warp * 16 + gq + 8 * (e >> 1)) * kD + 8 * j + 2 * t4 + (e & 1)] = o[j][e];
    }
  }
  if (t4 == 0) {
    s_m[warp * 16 + gq] = m[0];
    s_m[warp * 16 + gq + 8] = m[1];
    s_l[warp * 16 + gq] = l[0];
    s_l[warp * 16 + gq + 8] = l[1];
  }
  __syncthreads();
  merge_workers<kWarps, 16, kD>(s_acc, s_m, s_l, part_ml, part_acc, part0, g, dv, splits);
}

// ---------------------------------------------------------------------------
// bf16 above 128 head dims: one launch, the splits merged in a cluster
// ---------------------------------------------------------------------------

constexpr int kWideGroups = 8;                     // 16-slot groups a round holds at most
constexpr int kWidePLd = kWideGroups * 16 + 8;     // bf16 pitch of P's rows (head x slot)
constexpr int kClusterMax = 16;                    // blocks a cluster, splits of one cache
constexpr int kWideWarpsMax = 8;
constexpr int kWideSmemMax = 232448;               // 227 KB

// The wide kernel's dynamic shared memory (from a 1024-byte aligned base),
// for a ring of ring_rows cache rows: K then V, each [ring_rows / round_rows
// stages][kD / 64 chunks][round_rows rows x 64] bf16 as TMA writes them
// (128-byte swizzle); q [16][kLd] bf16; P [16][kWidePLd] bf16; fp32
// [kWideWarpsMax][16] round maxima and sums and [kClusterMax][16] merge
// weights; the ring's K and V barriers [2][4].
template <int kD>
struct WideSmem {
  static constexpr int kLd = kD + 8;
  static size_t __host__ __device__ q_off(int ring_rows) { return 2ull * ring_rows * kD * 2; }
  static size_t __host__ __device__ p_off(int ring_rows) {
    return q_off(ring_rows) + 16ull * kLd * 2;
  }
  static size_t __host__ __device__ f_off(int ring_rows) {
    return p_off(ring_rows) + 16ull * kWidePLd * 2;
  }
  static size_t __host__ __device__ bar_off(int ring_rows) {
    return f_off(ring_rows) + (2 * kWideWarpsMax * 16 + kClusterMax * 16) * sizeof(float);
  }
  static size_t __host__ __device__ bytes(int ring_rows) {
    return bar_off(ring_rows) + 8 * sizeof(uint64_t) + 1024;
  }
};

// fp32 a block's partial takes in the merge's scratch: (m, l) of 16 heads,
// then 16 x Dv outputs (rounded up to whole 16-byte units).
__host__ __device__ inline int wide_part_floats(int dv) {
  return 32 + 16 * ((dv + 3) / 4 * 4);
}

// kD: Dh and Dv padded to 192 or 256; kD / 32 warps. The grid is (splits, KH,
// B), launched as clusters of `splits` blocks: the splits of one (b, kv
// head) side by side. A block takes `chunk` slots (whole 16-slot groups) in
// rounds of round_rows slots: all at once where the chunk fits one round
// (stages 1), else through a ring of `stages` rounds. One thread loads them
// by TMA (a box of round_rows rows by 64 dims per chunk, zero past S and the
// head dims, completing on an mbarrier per stage and matrix): in the single
// round K before n_valid is read (the scores mask the slots past it), V
// after it; q comes by 16-byte cp.async copies. In a round each warp scores
// 16 heads (rows of mma.sync m16n8k16, zero past g) against 16-slot groups w
// and w + warps, the k-steps in two chains of sums, the K fragments read
// through the swizzle; the round's row maxima meet in shared memory, every
// warp takes the same new maximum, and the warps write P (bf16) for the
// slots they scored; then each warp adds P V for its own 32 output dims over
// all the round's slots (V's rows from n_valid to the round's last 16-slot
// group zeroed first: P is 0 there, but the cache may hold anything), so no
// warp's output needs merging with another's. A warp rescales its output
// only where a row's maximum rose. The merge: every block stores its (m, l)
// per head and its unnormalised outputs to its part of `scratch` (coalesced,
// into L2); after one cluster barrier (release and acquire at cluster scope)
// each block reads, in one round of coalesced loads, every block's (m, l)
// and every block's values of its 1/splits share of the g x Dv outputs,
// forms each head's weights by half-warp shuffles, and writes its share.
// Slots at or past
// n_valid, and the splits past them, add nothing; with n_valid <= 0 every
// slot scores -1e30 and the merge gives the uniform average, as the split
// kernels do.
template <int kD>
__global__ void __launch_bounds__(kD)
decode_wide_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const bf16* __restrict__ q, const int* __restrict__ n_valid,
                   bf16* __restrict__ o, float* __restrict__ scratch, int s, int h, int dh,
                   int dv, int g, int chunk,
                   int round_rows, int stages, int64_t q_sb, int64_t q_sh, float scale_log2) {
  static_assert(kD == 192 || kD == 256, "the wide instances");
  using L = WideSmem<kD>;
  constexpr int kW = kD / 32;           // warps: one per 32 output dims
  constexpr int kT = 32 * kW;           // threads
  constexpr int kChunks = kD / 64;
  constexpr int kLd = L::kLd;
  constexpr int kSteps = kD / 16;       // k-steps of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nsplit = gridDim.x;
  const int ring_rows = stages * round_rows;
  bf16* ks = reinterpret_cast<bf16*>(base);
  bf16* vs = ks + ring_rows * kD;
  bf16* qs = reinterpret_cast<bf16*>(base + L::q_off(ring_rows));
  bf16* ps = reinterpret_cast<bf16*>(base + L::p_off(ring_rows));
  float* xm = reinterpret_cast<float*>(base + L::f_off(ring_rows));
  float* lw = xm + kWideWarpsMax * 16;
  float* wts = lw + kWideWarpsMax * 16;   // [kClusterMax][16]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::bar_off(ring_rows));   // [2][4]

  const int split = blockIdx.x;         // the block's rank in its cluster
  const int khi = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t4 = lane % 4;
  const int mi = lane / 8;
  const int rr = lane % 8;
  const int s0 = split * chunk;
  const uint32_t box_bytes = kChunks * 128 * round_rows;   // one matrix, one round
  // a stage's tile of one matrix: chunk c of row r, 16-byte unit u (swizzled)
  auto at = [&](bf16* tile, int r, int c, int u) {
    return tile + c * round_rows * 64 + r * 64 + ((u ^ (r % 8)) * 8);
  };
  auto load = [&](const CUtensorMap* map, int which, int r) {   // thread 0
    const int st = r % stages;
    bf16* tile = (which == 0 ? ks : vs) + st * round_rows * kD;
    hopper::mbar_arrive_expect_tx(&full[4 * which + st], box_bytes);
    for (int c = 0; c < kChunks; ++c) {
      hopper::tma_load_4d(tile + c * round_rows * 64, map, &full[4 * which + st], c * 64,
                          s0 + r * round_rows, khi, bi);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) hopper::mbar_init(&full[i], 1);
    hopper::mbar_fence_init();
    hopper::tma_prefetch_map(&tk);
    hopper::tma_prefetch_map(&tv);
    if (stages == 1 && s0 < s) load(&tk, 0, 0);   // the single round's K, before n_valid
  }
  // q's rows by 16-byte copies, zero past g and dh
  for (int idx = threadIdx.x; idx < 16 * (kD / 8); idx += kT) {
    const int gi = idx / (kD / 8);
    const int c = (idx % (kD / 8)) * 8;
    const int nb = gi < g ? min(max(dh - c, 0), 8) : 0;
    const bf16* src = q + bi * q_sb + static_cast<int64_t>(khi * g + gi) * q_sh + c;
    hopper::cp_async16(qs + gi * kLd + c, nb > 0 ? src : q, nb * 2);
  }
  hopper::cp_async_commit();
  int n = n_valid[bi];
  const bool none_valid = n <= 0;
  n = none_valid ? s : min(n, s);
  const int end = min(min(s0 + chunk, s), n);   // slots [s0, end) count in this block
  const int rounds = end > s0 ? (end - s0 + round_rows - 1) / round_rows : 0;
  if (threadIdx.x == 0) {
    if (stages == 1) {
      if (rounds > 0) load(&tv, 1, 0);
    } else {
      for (int r = 0; r < stages && r < rounds; ++r) {
        load(&tk, 0, r);
        load(&tv, 1, r);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();   // q, and the barriers' initialisation

  uint32_t qa[kSteps][4];   // q as A fragments (heads x dims)
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ldmatrix_x4(qa[kk], qs + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
  }
  float acc[4][4];          // O: 16 heads x this warp's 32 dims (four 8-dim tiles)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};   // heads gq and gq + 8, base 2
  float l[2] = {0.f, 0.f};           // this thread's share of each head's sum

  for (int r = 0; r < rounds; ++r) {
    const int st = r % stages;
    const uint32_t parity = (r / stages) & 1;
    if (r > 0) {
      __syncthreads();   // every warp is past round r - 1: its stage takes round r - 1 + stages
      if (threadIdx.x == 0 && r - 1 + stages < rounds) {
        load(&tk, 0, r - 1 + stages);
        load(&tv, 1, r - 1 + stages);
      }
    }
    hopper::mbar_wait(&full[st], parity);   // K
    const int first = s0 + r * round_rows;
    const int rend = min(first + round_rows, end);
    const int groups = (rend - first + 15) / 16;
    bf16* kst = ks + st * round_rows * kD;
    bf16* vst = vs + st * round_rows * kD;

    // scores of groups warp and warp + kW: [group][8-slot tile][4], each the
    // sum of two chains (even and odd k-steps)
    float sc[2][2][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int grp = warp + kW * gi;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[gi][j][e] = 0.f;
      }
      if (grp < groups) {   // the same for the whole warp
        const int row = grp * 16 + (mi >> 1) * 8 + rr;   // this lane's K row of its matrix
        float odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t b[4];   // {b0, b1} of slots 0-7, then of slots 8-15
          ldmatrix_x4(b, at(kst, row, kk / 4, (kk % 4) * 2 + (mi & 1)));
          if (kk % 2) {
            mma_bf16(odd[0], qa[kk], b[0], b[1]);
            mma_bf16(odd[1], qa[kk], b[2], b[3]);
          } else {
            mma_bf16(sc[gi][0], qa[kk], b[0], b[1]);
            mma_bf16(sc[gi][1], qa[kk], b[2], b[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = first + grp * 16 + 8 * j + 2 * t4 + (e & 1) < rend;
            const float x = none_valid ? kNegInf : (sc[gi][j][e] + odd[j][e]) * scale_log2;
            sc[gi][j][e] = x;
            if (live) mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    }
    if (t4 == 0) {
      xm[warp * 16 + gq] = mx[0];
      xm[warp * 16 + gq + 8] = mx[1];
    }
    __syncthreads();
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float rm = m[hr];
#pragma unroll
      for (int w = 0; w < kW; ++w) rm = fmaxf(rm, xm[w * 16 + gq + 8 * hr]);
      corr[hr] = hopper::exp2_approx(m[hr] - rm);
      m[hr] = rm;
      l[hr] *= corr[hr];
    }
    // P of the scored slots, bf16, into shared memory; the sums in fp32
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int grp = warp + kW * gi;
      if (grp < groups) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = first + grp * 16 + 8 * j + 2 * t4 + (e & 1) < rend;
            const float p = live ? hopper::exp2_approx(sc[gi][j][e] - m[e >> 1]) : 0.f;
            sc[gi][j][e] = p;
            l[e >> 1] += p;
          }
          const int col = grp * 16 + 8 * j + 2 * t4;
          *reinterpret_cast<uint32_t*>(ps + gq * kWidePLd + col) =
              pack2(sc[gi][j][0], sc[gi][j][1]);
          *reinterpret_cast<uint32_t*>(ps + (gq + 8) * kWidePLd + col) =
              pack2(sc[gi][j][2], sc[gi][j][3]);
        }
      }
    }
    hopper::mbar_wait(&full[4 + st], parity);   // V
    // V's rows from `end` to the last 16-slot group: zeros (P is 0 there)
    const int dead = groups * 16 - (rend - first);
    for (int i = threadIdx.x; i < dead * kD; i += kT) {
      const int row = rend - first + i / kD;
      const int d = i % kD;
      at(vst, row, d / 64, (d % 64) / 8)[d % 8] = __float2bfloat16(0.f);
    }
    hopper::fence_proxy_async();   // before TMA writes the stage again
    __syncthreads();
    if (__any_sync(0xffffffffu, (corr[0] != 1.f) | (corr[1] != 1.f))) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
    }
    // O += P V over the round's slots and this warp's 32 dims
    for (int kk = 0; kk < groups; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, ps + (lane % 16) * kWidePLd + kk * 16 + (lane / 16) * 8);
      const int row = kk * 16 + (mi & 1) * 8 + rr;   // this lane's V row of its matrix
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        const int d = warp * 32 + dp * 16 + (mi >> 1) * 8;
        uint32_t b[4];   // {b0, b1} of dims [16 dp, 16 dp + 8), then of the next 8
        ldmatrix_x4_trans(b, at(vst, row, d / 64, (d % 64) / 8));
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }
  // a single-round block with no slot still waits for the K it was sent
  if (rounds == 0 && stages == 1 && s0 < s) hopper::mbar_wait(&full[0], 0);

  // the merge: the block's part of the scratch, (m, l) per head, then its
  // outputs; the cluster's parts lie side by side
  const int part = wide_part_floats(dv);
  const int ldo = (dv + 3) / 4 * 4;
  float* parts = scratch + (static_cast<int64_t>(bi) * gridDim.y + khi) * nsplit * part;
  float* mine = parts + split * part;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  if (t4 == 0) {
    lw[warp * 16 + gq] = l[0];
    lw[warp * 16 + gq + 8] = l[1];
    if (warp == 0) {   // the round maxima are read: xm takes the heads' m
      xm[gq] = m[0];
      xm[gq + 8] = m[1];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gi = gq + 8 * hr;
      const int d = warp * 32 + 8 * j + 2 * t4;
      if (gi < g && d < ldo) {
        *reinterpret_cast<float2*>(mine + 32 + gi * ldo + d) =
            make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w) sum += lw[w * 16 + threadIdx.x];
    mine[2 * threadIdx.x] = xm[threadIdx.x];
    mine[2 * threadIdx.x + 1] = sum;
  }
  hopper::cluster_sync();   // every block's part is in L2

  // one round of loads: this block's share of the outputs from every part,
  // and the (m, l) of head t / 16 of part t % 16 (half a warp a head)
  const int per = (g * dv + nsplit - 1) / nsplit;   // outputs a block merges
  const int lo = split * per;
  const int hi = min(lo + per, g * dv);
  const int idx0 = lo + threadIdx.x;
  float val[kClusterMax];
  {
    const int gi0 = idx0 / dv;
    const float* src = parts + 32 + gi0 * ldo + (idx0 - gi0 * dv);
#pragma unroll
    for (int c = 0; c < kClusterMax; ++c) val[c] = c < nsplit && idx0 < hi ? src[c * part] : 0.f;
  }
  for (int t = threadIdx.x; t - lane < 16 * 16; t += kT) {   // whole warps
    const int gi = t / 16;
    const int c = t % 16;
    const bool in = c < nsplit && gi < 16;
    const float mc = in ? parts[c * part + 2 * gi] : kNegInf;
    const float lc = in ? parts[c * part + 2 * gi + 1] : 0.f;
    float mx = mc;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float f = hopper::exp2_approx(mc - mx);
    float den = lc * f;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    if (in) wts[c * 16 + gi] = f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  // this block's share of the g x Dv outputs
  for (int idx = idx0; idx < hi; idx += kT) {
    const int gi = idx / dv;
    const int d = idx - gi * dv;
    if (idx != idx0) {
#pragma unroll
      for (int c = 0; c < kClusterMax; ++c) {
        val[c] = c < nsplit ? parts[c * part + 32 + gi * ldo + d] : 0.f;
      }
    }
    float num = 0.f;
#pragma unroll
    for (int c = 0; c < kClusterMax; ++c) {
      if (c < nsplit) num = fmaf(val[c], wts[c * 16 + gi], num);
    }
    o[(static_cast<int64_t>(bi) * h + khi * g + gi) * dv + d] = __float2bfloat16(num);
  }
}

// o[b, h] = sum over splits of acc 2^(m - M) / sum of l 2^(m - M), one block
// of kCT threads (128, or 256 above 128 dims) per (b, h), one thread per
// output dim. Launched to overlap the split pass's tail (programmatic
// dependent launch): it waits for the partials, then loads each thread's
// first kPre partials at once, before the weights are known.
constexpr int kPre = 16;

template <typename T, int kCT>
__global__ void __launch_bounds__(kCT)
decode_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                      T* __restrict__ o, int h, int dv, int splits) {
  extern __shared__ float sm_ml[];    // [splits][2]: (m, l), then (m, weight)
  __shared__ float total[2];          // M, 1 / L
  hopper::grid_wait();
  const int64_t row = static_cast<int64_t>(blockIdx.y) * h + blockIdx.x;
  const int d = threadIdx.x;          // dv <= kCT
  const float* acc = part_acc + row * splits * dv + d;
  float pre[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) pre[i] = d < dv && i < splits ? acc[i * dv] : 0.f;
  for (int i = threadIdx.x; i < 2 * splits; i += kCT) sm_ml[i] = part_ml[2 * row * splits + i];
  __syncthreads();
  if (threadIdx.x < 32) {
    float mx = kNegInf;
    for (int sp = threadIdx.x; sp < splits; sp += 32) mx = fmaxf(mx, sm_ml[2 * sp]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float den = 0.f;
    for (int sp = threadIdx.x; sp < splits; sp += 32) {
      den = fmaf(sm_ml[2 * sp + 1], hopper::exp2_approx(sm_ml[2 * sp] - mx), den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    if (threadIdx.x == 0) {
      total[0] = mx;
      total[1] = 1.f / fmaxf(den, 1e-30f);
    }
  }
  __syncthreads();
  for (int sp = threadIdx.x; sp < splits; sp += kCT) {
    sm_ml[2 * sp + 1] = hopper::exp2_approx(sm_ml[2 * sp] - total[0]) * total[1];
  }
  __syncthreads();
  if (d >= dv) return;
  float num = 0.f;
#pragma unroll
  for (int i = 0; i < kPre; ++i) num = fmaf(pre[i], i < splits ? sm_ml[2 * i + 1] : 0.f, num);
  for (int sp = kPre; sp < splits; ++sp) num = fmaf(acc[sp * dv], sm_ml[2 * sp + 1], num);
  o[row * dv + d] = Elem<T>::from_float(num);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* n_valid;
  void* o;
  float* part_ml;
  float* part_acc;
  int b, s, h, kh, dh, dv, splits, chunk, rows, stages;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

template <typename T, int kCT>
int launch_combine(const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.h, a.b);
  cfg.blockDim = dim3(kCT);
  cfg.dynamicSmemBytes = 2 * a.splits * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, kCT>, a.part_ml,
                                             a.part_acc, static_cast<T*>(a.o), a.h, a.dv,
                                             a.splits));
}

template <int kCT>
int combine(const Args& a, int dtype, cudaStream_t stream) {
  return dtype == kFloat32 ? launch_combine<float, kCT>(a, stream)
                           : launch_combine<bf16, kCT>(a, stream);
}

// fp32 at head-dim capacity kDCap (128: 16 heads a block; 256: 8).
template <int kDCap>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int kG = kDCap > 128 ? 8 : kGMax;
  constexpr size_t kTiles = 2ull * kStages * kF32Rows * kDCap * sizeof(float);
  constexpr size_t kMerge = (static_cast<size_t>(kWarps) * kG * kDCap + 2 * kWarps * kG) * 4;
  constexpr size_t kSmem = kTiles > kMerge ? kTiles : kMerge;
  auto kernel = decode_f32_kernel<kDCap, kG>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int passes = (a.h / a.kh + kG - 1) / kG;
  kernel<<<dim3(a.kh * passes, a.b, a.splits), kThreads, kSmem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.n_valid, a.part_ml, a.part_acc, a.s, a.h, a.dh, a.dv,
      a.h / a.kh, a.splits, a.chunk, a.q_sb, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.scale * kLog2e);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? static_cast<int>(err) : combine<kDCap>(a, kFloat32, stream);
}

template <int kD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t kTiles = 2ull * kStages * kMmaRows * (kD + 8) * sizeof(bf16);
  constexpr size_t kMerge = (static_cast<size_t>(kWarps) * 16 * kD + 2 * kWarps * 16) * 4;
  constexpr size_t kSmem = kTiles > kMerge ? kTiles : kMerge;
  auto kernel = decode_mma_kernel<kD>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  kernel<<<dim3(a.kh, a.b, a.splits), kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.n_valid, a.part_ml, a.part_acc, a.s, a.h, a.dh, a.dv,
      a.h / a.kh, a.splits, a.chunk, a.q_sb, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.scale * kLog2e);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? static_cast<int>(err) : combine<kThreads>(a, kBFloat16, stream);
}

// The wide kernel as clusters of a.splits blocks (a.chunk slots each, rounds
// of a.rows through a.stages stages); above 8 blocks a cluster is a
// non-portable size, which the launch refuses where the card cannot place it.
template <int kD>
int launch_wide(const Args& a, cudaStream_t stream) {
  const bool ring_ok = a.stages >= 2 || a.chunk <= a.rows;
  if (a.splits > kClusterMax || a.rows < 16 || a.rows % 16 != 0 || a.rows > kWideGroups * 16 ||
      a.stages < 1 || a.stages > 4 || !ring_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = WideSmem<kD>::bytes(a.stages * a.rows);
  if (smem > static_cast<size_t>(kWideSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  if (!hopper::encode_bshd(&tk, a.k, a.b, a.s, a.kh, a.dh, a.k_sb, a.k_ss, a.k_sh, a.rows) ||
      !hopper::encode_bshd(&tv, a.v, a.b, a.s, a.kh, a.dv, a.v_sb, a.v_ss, a.v_sh, a.rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = decode_wide_kernel<kD>;
  static const cudaError_t opt_in = [&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kWideSmemMax);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.kh, a.b);
  cfg.blockDim = dim3(kD);   // a warp per 32 output dims
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, tk, tv, static_cast<const bf16*>(a.q), a.n_valid, static_cast<bf16*>(a.o),
      a.part_ml, a.s, a.h, a.dh, a.dv, a.h / a.kh, a.chunk, a.rows, a.stages, static_cast<int64_t>(a.q_sb),
      static_cast<int64_t>(a.q_sh), a.scale * kLog2e));
}

}  // namespace
}  // namespace repro_torch

// Launches the split pass and the merge on `stream`, or above 128 padded head
// dims in bf16 the one wide kernel; returns cudaGetLastError() after them (0
// on success). Strides are in elements; the last dimension of q and the
// caches is dense; the caches' base addresses and strides are multiples of 16
// bytes (q's too on the wide path); n_valid is a device array of B int32; o
// is a dense (B,H,Dv) tensor; splits * chunk >= S. The split pass takes
// scratch, fp32 of B*H*splits*(Dv+2) elements, and ignores rows and stages;
// the wide kernel takes clusters of `splits` (<= 16) blocks, rounds of `rows`
// slots through `stages` stages, and scratch of fp32 B*KH*splits*(32 + 16 *
// (Dv rounded up to 4)) elements. The caller guarantees
// 1 <= Dh, Dv <= 256, H % KH == 0 and H / KH <= 16.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                    const void* n_valid, void* o, void* scratch, int b, int s,
                                    int h, int kh, int dh, int dv, int splits, int chunk,
                                    int rows, int stages,
                                    long long q_sb, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, float scale, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dv < 1 || dh > kDMax || dv > kDMax || kh < 1 || h % kh != 0 || h / kh > kGMax ||
      splits < 1 || static_cast<long long>(splits) * chunk < s) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* part_ml = static_cast<float*>(scratch);
  Args a{q, k, v, static_cast<const int*>(n_valid), o, part_ml,
         part_ml + 2ll * b * h * splits, b, s, h, kh, dh, dv, splits, chunk, rows, stages,
         q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  const int dmax = dh > dv ? dh : dv;
  if (dtype == kFloat32) return dmax > 128 ? launch_f32<256>(a, st) : launch_f32<128>(a, st);
  if (dtype == kBFloat16) {
    return dmax > 192   ? launch_wide<256>(a, st)
           : dmax > 128 ? launch_wide<192>(a, st)
           : dmax > 64  ? launch_bf16<128>(a, st)
                        : launch_bf16<64>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
