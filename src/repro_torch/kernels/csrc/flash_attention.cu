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
// TFLOP/s), not memory.
//
// Design, common to both element types:
//   * one block per (64-row query tile, head, batch); the TPU kernel's
//     sequential kv grid axis becomes a loop inside the block, and its VMEM
//     scratch (running max m, sum l, accumulator) fp32 registers;
//   * K and V tiles are staged in shared memory, zero-padded past Dh and Dv;
//   * kv tiles wholly above the causal diagonal or wholly outside the sliding
//     window are not visited (the TPU kernel's pl.when skip);
//   * q, k and v are read through their strides in the (B,S,H,D) layout, so
//     the caller makes no transposes; only the last dimension must be dense.
// bf16 (the serving path) takes the tensor cores: 4 warps of 16 query rows
// each run both products as mma.sync m16n8k16 (bf16 in, fp32 accumulate);
// the scores' accumulator fragments become the probabilities' operand
// fragments in registers, with the probabilities rounded to bf16 for the
// second product, as FlashAttention-2 does. Shared-memory rows are padded by
// 16 bytes so both products read them without bank conflicts. It does not
// yet use wgmma, TMA or a pipeline of tiles in flight: loads and products of
// a tile do not overlap. fp32 takes scalar FMAs: 4 threads share a query row,
// each holding a quarter of the row's q and accumulator, reading each kv row
// as 16-byte packs that a warp's 8 rows share (broadcasts, no conflicts).
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kDMax = 128;                       // largest Dh and Dv taken
constexpr int kBlockQ = 64;                      // query rows per block
constexpr int kRowThreads = 4;                   // threads sharing a query row
constexpr int kThreads = kBlockQ * kRowThreads;  // 256
constexpr int kSub = 16;                         // kv columns per softmax update

template <typename T, int kBlockK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int h, int kh,
                 int dh, int dv, int dp,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
                 int window, float scale) {
  using E = Elem<T>;
  constexpr int kPack = E::kPack;
  constexpr int kChunks = kDMax / (kRowThreads * kPack);  // packs per thread at kDMax
  constexpr int kPer = kChunks * kPack;                   // = kDMax / 4 values per thread

  __shared__ __align__(16) T ks[kBlockK][kDMax];
  __shared__ __align__(16) T vs[kBlockK][kDMax];

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

template <typename T, int kBlockK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
           int skv,
           int h, int kh, int dh, int dv, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int kQuad = kRowThreads * Elem<T>::kPack;
  const int dmax = dh > dv ? dh : dv;
  const int dp = (dmax + kQuad - 1) / kQuad * kQuad;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_kernel<T, kBlockK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, skv, h, kh, dh, dv, dp, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = kBlockQ / 16;      // 16 query rows per warp
constexpr int kMmaThreads = kMmaWarps * 32;  // 128
constexpr int kMmaBlockK = 64;               // kv rows per tile
constexpr int kLd = kDMax + 8;               // smem row stride in elements: +16 bytes

// Fragment layouts of m16n8k16 (PTX ISA), with g = lane / 4 and t = lane % 4:
//   A regs {0,1,2,3} hold rows {g, g+8, g, g+8}, columns {2t, 2t, 2t+8, 2t+8} (+0, +1);
//   B regs {0,1} hold k rows {2t, 2t+8} (+0, +1) of column g;
//   C values {0,1,2,3} sit at (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int h,
                     int kh, int dh, int dv, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, int causal, int window, float scale, bool kvec, bool vvec) {
  constexpr int kSteps = kDMax / 16;     // k-steps of the score product
  constexpr int kNTiles = kMmaBlockK / 8;  // 8-column tiles of a score tile
  constexpr int kDTiles = kDMax / 8;     // 8-column tiles of the output
  __shared__ __align__(16) bf16 ks[kMmaBlockK][kLd];
  __shared__ __align__(16) bf16 vs[kMmaBlockK][kLd];

  const int qt = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = hi / (h / kh);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = qt * kBlockQ;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int nsteps = (dh + 15) / 16;
  const int ndtiles = (dv + 7) / 8;

  uint32_t qf[kSteps][4];
  const bf16* qb = q + bi * q_sb + hi * q_sh;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1];
      const int c = st * 16 + 2 * t + (r >= 2 ? 8 : 0);
      bf16 e0 = __float2bfloat16(0.f);
      bf16 e1 = e0;
      if (row < sq) {
        const bf16* p = qb + row * q_ss;
        if (c < dh) e0 = p[c];
        if (c + 1 < dh) e1 = p[c + 1];
      }
      qf[st][r] = pack2(e0, e1);
    }
  }
  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  int kv_begin = 0;
  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + kBlockQ);
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const bf16* kb = k + bi * k_sb + kvh * k_sh;
  const bf16* vb = v + bi * v_sb + kvh * v_sh;

  for (int kv0 = (kv_begin / kMmaBlockK) * kMmaBlockK; kv0 < kv_end; kv0 += kMmaBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < kMmaBlockK * (kDMax / 8); idx += kMmaThreads) {
      const int r = idx / (kDMax / 8);
      const int c = (idx % (kDMax / 8)) * 8;
      const int kv = kv0 + r;
      const bool in = kv < skv;
      load8(&ks[r][c], kb + kv * k_ss, c, dh, in, kvec);
      load8(&vs[r][c], vb + kv * v_ss, c, dv, in, vvec);
    }
    __syncthreads();

    // scores: s[nt] is the 16x8 tile of kv columns [8 nt, 8 nt + 8)
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* krow = &ks[nt * 8 + g][2 * t];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st < nsteps) {
          mma_bf16(s[nt], qf[st], *reinterpret_cast<const uint32_t*>(krow + st * 16),
                   *reinterpret_cast<const uint32_t*>(krow + st * 16 + 8));
        }
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = rows[e >> 1];
        const int kv = kv0 + nt * 8 + 2 * t + (e & 1);
        const bool live =
            kv < skv && (!causal || kv <= qpos) && (window <= 0 || kv > qpos - window);
        s[nt][e] = live ? s[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a row group end with the same maximum
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        acc[dt][2 * r] *= corr;
        acc[dt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }

    // output += P V: the score tiles 2kk and 2kk+1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kMmaBlockK / 16; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                              pack2(s[2 * kk][2], s[2 * kk][3]),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int vr = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        if (dt < ndtiles) {
          const int col = dt * 8 + g;
          mma_bf16(acc[dt], pa, pack2(vs[vr][col], vs[vr + 1][col]),
                   pack2(vs[vr + 8][col], vs[vr + 9][col]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t == 0) {
      lse[(static_cast<int64_t>(bi) * h + hi) * sq + rows[r]] = m[r] + logf(denom);
    }
    bf16* orow = o + ((static_cast<int64_t>(bi) * sq + rows[r]) * h + hi) * dv;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dt * 8 + 2 * t + e;
        if (d < dv) orow[d] = __float2bfloat16(acc[dt][2 * r + e] / denom);
      }
    }
  }
}

bool aligned16(const void* p, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && ss % 8 == 0 &&
         sh % 8 == 0;
}

int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
               int sq, int skv,
               int h, int kh, int dh, int dv, long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
               long long v_sh, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  flash_fwd_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, sq, skv, h, kh, dh, dv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, causal, window, scale, aligned16(k, k_sb, k_ss, k_sh),
      aligned16(v, v_sb, v_ss, v_sh));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Returns cudaGetLastError() after the launch (0 on success). Strides are in
// elements; the last dimension of q, k and v is dense; o is a dense
// (B,Sq,H,Dv) tensor. lse, when not null, is a dense fp32 (B,H,Sq) tensor that
// receives each row's log-sum-exp of its scaled scores (what the backward
// kernel recomputes the probabilities from); serving passes null. window <= 0
// means no sliding window. The caller guarantees 1 <= Dh, Dv <= 128 and
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
  // Static shared memory per block: 32 KB for fp32 (2 tiles x 32 x 128 x 4 B),
  // 34 KB for bf16 (2 tiles x 64 x 136 x 2 B), under the 48 KB that needs no opt-in.
  if (dtype == kFloat32) {
    return launch<float, 32>(q, k, v, o, static_cast<float*>(lse), b, sq, skv, h, kh, dh, dv, q_sb, q_ss, q_sh, k_sb,
                             k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, scale, st);
  }
  if (dtype == kBFloat16) {
    return launch_mma(q, k, v, o, static_cast<float*>(lse), b, sq, skv, h, kh, dh, dv, q_sb, q_ss, q_sh, k_sb, k_ss,
                      k_sh, v_sb, v_ss, v_sh, causal, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
