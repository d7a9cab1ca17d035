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
// D=128, causal) the function does ~21 GFLOP (five products of the forward's
// size) against ~25 MB of input and output, so arithmetic bounds it (~22 us on
// the bf16 tensor cores), not memory.
//
// Design (FlashAttention-2's backward):
//   * a pre-pass computes D = rowsum(dO * O) per query row;
//   * one block owns a tile of 32 kv rows of one kv head and loops over the
//     query heads of its group and over the query tiles that can see the tile,
//     so dK and dV accumulate in its registers and need no atomics;
//   * per query tile it recomputes P = exp(S - lse) from the forward's saved
//     log-sum-exp, forms dV += P^T dO, dP = dO V^T, dS = P (dP - D), and
//     dK += scale dS^T Q, all in shared memory and registers;
//   * dQ += scale dS K goes to an fp32 buffer by atomicAdd (blocks of other kv
//     tiles add into the same rows), and a last pass casts it to the output.
// This first version uses scalar FMAs for both element types (tiles held as
// fp32 in shared memory, rows padded to an odd stride so the column walks are
// free of bank conflicts); tensor cores are left to a later speed PR.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kDMax = 128;            // largest Dh and Dv taken
constexpr int kBq = 32;               // query rows per tile
constexpr int kBk = 32;               // kv rows per block
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kBq;  // 8 threads share a row
constexpr int kPer = kDMax / kLanes;    // 16 head dims per thread
constexpr int kLd = kDMax + 1;          // fp32 smem row stride of q/k/v/dO tiles
constexpr int kPLd = kBk + 1;           // fp32 smem row stride of P and dS
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kBk * kLd + 2 * kBq * kLd + 2 * kBq * kPLd + 2 * kBq);

// D[b,h,s] = sum_d dO[b,s,h,d] O[b,s,h,d], one warp per (b, h, s) row.
template <typename T>
__global__ void bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               float* __restrict__ dsum, int b, int sq, int h, int dv,
                               int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t d_sb,
                               int64_t d_ss, int64_t d_sh) {
  using E = Elem<T>;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(b) * h * sq) return;
  const int s = static_cast<int>(row % sq);
  const int hh = static_cast<int>((row / sq) % h);
  const int bb = static_cast<int>(row / (static_cast<int64_t>(sq) * h));
  const T* orow = o + bb * o_sb + s * o_ss + hh * o_sh;
  const T* drow = dout + bb * d_sb + s * d_ss + hh * d_sh;
  float acc = 0.f;
  for (int d = lane; d < dv; d += 32) acc += E::to_float(orow[d]) * E::to_float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, float* __restrict__ dq_acc, T* __restrict__ dk,
           T* __restrict__ dvo, int sq, int skv, int h, int kh, int dh, int dv, int dp,
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
           int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t d_sb, int64_t d_ss, int64_t d_sh,
           int causal, int window, float scale) {
  using E = Elem<T>;
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
      if (d < dh) kval = E::to_float(k[bi * k_sb + kv * k_ss + kvh * k_sh + d]);
      if (d < dv) vval = E::to_float(v[bi * v_sb + kv * v_ss + kvh * v_sh + d]);
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
          if (d < dh) qval = E::to_float(q[bi * q_sb + qp * q_ss + hq * q_sh + d]);
          if (d < dv) dval = E::to_float(dout[bi * d_sb + qp * d_ss + hq * d_sh + d]);
        }
        qs[r * kLd + d] = qval;
        dos[r * kLd + d] = dval;
      }
      if (tid < kBq) {
        const int qp = q0 + tid;
        const int64_t at = (static_cast<int64_t>(bi) * h + hq) * sq + qp;
        lses[tid] = qp < sq ? lse[at] : 0.f;
        dsums[tid] = qp < sq ? dsum[at] : 0.f;
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
  T* dkrow = dk + ((static_cast<int64_t>(bi) * skv + kv) * kh + kvh) * dh;
  T* dvrow = dvo + ((static_cast<int64_t>(bi) * skv + kv) * kh + kvh) * dv;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int d = lane + kLanes * c;
    if (d < dh) dkrow[d] = E::from_float(dk_acc[c] * scale);
    if (d < dv) dvrow[d] = E::from_float(dv_acc[c]);
  }
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = Elem<T>::from_float(src[i]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* dsum, float* dq_acc, void* dq, void* dk, void* dv_out, int b,
           int sq, int skv, int h, int kh, int dh, int dv, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  // st: strides of q, k, v, o and dO, three each (batch, sequence, head)
  const int64_t rows = static_cast<int64_t>(b) * h * sq;
  bwd_dot_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, b, sq, h, dv, st[9], st[10],
      st[11], st[12], st[13], st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = dh > dv ? dh : dv;
  const dim3 grid((skv + kBk - 1) / kBk, kh, b);
  bwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv_out), sq, skv, h, kh, dh, dv, dp, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[12], st[13], st[14], causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t n = static_cast<int64_t>(b) * sq * h * dh;
  cast_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Returns the first CUDA error of the three launches (0 on success). q, k, v,
// o and dO are read through their strides (elements; the last dimension is
// dense), given as 15 values: (batch, sequence, head) strides of q, k, v, o and
// dO in that order. lse (from the forward) and dsum (scratch) are dense fp32
// (B,H,Sq); dq_acc is a dense fp32 (B,Sq,H,Dh) buffer the caller zeroes; dq,
// dk and dv are dense outputs in the input type. window <= 0 means no sliding
// window. The caller guarantees 1 <= Dh, Dv <= 128 and H % KH == 0.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* dsum, void* dq_acc, void* dq, void* dk, void* dv_out,
                                   int b, int sq, int skv, int h, int kh, int dh, int dv,
                                   const long long* strides, int causal, int window,
                                   float scale, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dv < 1 || dh > kDMax || dv > kDMax || kh < 1 || h % kh != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  float* acc = static_cast<float*>(dq_acc);
  if (dtype == kFloat32) {
    return launch<float>(q, k, v, o, dout, l, ds, acc, dq, dk, dv_out, b, sq, skv, h, kh, dh,
                         dv, strides, causal, window, scale, st);
  }
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(q, k, v, o, dout, l, ds, acc, dq, dk, dv_out, b, sq, skv, h,
                                 kh, dh, dv, strides, causal, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
