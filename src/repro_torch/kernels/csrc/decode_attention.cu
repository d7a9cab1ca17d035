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
// and V cache once (17 MB at B=4, S=1056, KH=8, D=128 in bf16) and does about
// 2 FLOP per byte, so memory bandwidth bounds it (~5 us at 3.35 TB/s).
//
// Design:
//   * one block per (kv head, batch) takes the G query heads of the group
//     together, so each cache row is read once for all G heads; the block
//     loads n_valid[b] itself (the TPU kernel's scalar prefetch) and visits
//     only the valid slots;
//   * 8 warps split the valid slots; a warp reads 4 consecutive cache rows
//     before it uses any of them, so 4 rows' loads are in flight per warp;
//     lane l holds dims l, l+32, l+64, l+96, so each load is coalesced;
//   * each warp keeps its own running (m, l, acc) per query head in fp32
//     registers; the 8 partial states are merged through shared memory.
// At B=4, KH=8 this is 32 blocks on the card's 132 SMs, so one decode call
// can use at most a quarter of the SMs' load bandwidth; splitting S over more
// blocks with a combine pass is the work of a later change.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kDMax = 128;              // largest Dh and Dv taken
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = kDMax / 32;    // dims held per lane
constexpr int kUnroll = 4;              // cache rows in flight per warp

// kG is a compile-time bound on the heads per kv head; g <= kG is the real count.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ n_valid, T* __restrict__ o, int s, int h, int kh, int dh,
              int dv, int g, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss,
              int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  using E = Elem<T>;
  extern __shared__ float smem[];  // acc [kWarps][g][kDMax], then m and l [kWarps][g]
  float* s_acc = smem;
  float* s_m = s_acc + kWarps * g * kDMax;
  float* s_l = s_m + kWarps * g;

  const int khi = blockIdx.x;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int n = n_valid[bi];
  const bool none_valid = n <= 0;
  n = none_valid ? s : min(n, s);

  float qr[kG][kPerLane];
  float acc[kG][kPerLane];
  float m[kG];
  float l[kG];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    const int64_t qoff = bi * q_sb + static_cast<int64_t>(khi * g + gi) * q_sh;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int d = e * 32 + lane;
      qr[gi][e] = (gi < g && d < dh) ? E::to_float(q[qoff + d]) : 0.f;
      acc[gi][e] = 0.f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  const T* kbase = kc + bi * k_sb + khi * k_sh;
  const T* vbase = vc + bi * v_sb + khi * v_sh;
  for (int p0 = warp * kUnroll; p0 < n; p0 += kWarps * kUnroll) {
    float kf[kUnroll][kPerLane];
    float vf[kUnroll][kPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int d = e * 32 + lane;
        kf[u][e] = (p < n && d < dh) ? E::to_float(kbase[p * k_ss + d]) : 0.f;
        vf[u][e] = (p < n && d < dv) ? E::to_float(vbase[p * v_ss + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p0 + u >= n) break;  // the same for every lane of the warp
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        if (gi < g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) dot = fmaf(qr[gi][e], kf[u][e], dot);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const float sc = none_valid ? kNegInf : dot * scale;
          const float m_new = fmaxf(m[gi], sc);
          const float corr = expf(m[gi] - m_new);
          const float p = expf(sc - m_new);
          l[gi] = l[gi] * corr + p;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) acc[gi][e] = fmaf(acc[gi][e], corr, p * vf[u][e]);
          m[gi] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    if (gi < g) {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        s_acc[(warp * g + gi) * kDMax + e * 32 + lane] = acc[gi][e];
      }
      if (lane == 0) {
        s_m[warp * g + gi] = m[gi];
        s_l[warp * g + gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // A warp that saw no slot holds m = -1e30, l = 0, acc = 0 and adds nothing.
  for (int idx = threadIdx.x; idx < g * dv; idx += kThreads) {
    const int gi = idx / dv;
    const int d = idx - gi * dv;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * g + gi]);
    float den = 0.f;
    float num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w * g + gi] - mx);
      den = fmaf(s_l[w * g + gi], f, den);
      num = fmaf(s_acc[(w * g + gi) * kDMax + d], f, num);
    }
    o[(static_cast<int64_t>(bi) * h + khi * g + gi) * dv + d] = E::from_float(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int kG>
int launch(const void* q, const void* k, const void* v, const int* n_valid, void* o, int b,
           int s, int h, int kh, int dh, int dv, long long q_sb, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, float scale, cudaStream_t stream) {
  const int g = h / kh;
  const size_t smem = static_cast<size_t>(kWarps) * g * (kDMax + 2) * sizeof(float);
  auto kernel = decode_kernel<T, kG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(kh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), n_valid,
      static_cast<T*>(o), s, h, kh, dh, dv, g, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_groups(const void* q, const void* k, const void* v, const int* n_valid, void* o,
                      int b, int s, int h, int kh, int dh, int dv, long long q_sb,
                      long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh, float scale,
                      cudaStream_t st) {
  const int g = h / kh;
#define REPRO_DECODE_LAUNCH(G)                                                              \
  return launch<T, G>(q, k, v, n_valid, o, b, s, h, kh, dh, dv, q_sb, q_sh, k_sb, k_ss, \
                      k_sh, v_sb, v_ss, v_sh, scale, st)
  if (g <= 1) REPRO_DECODE_LAUNCH(1);
  if (g <= 2) REPRO_DECODE_LAUNCH(2);
  if (g <= 4) REPRO_DECODE_LAUNCH(4);
  if (g <= 8) REPRO_DECODE_LAUNCH(8);
  if (g <= 16) REPRO_DECODE_LAUNCH(16);
#undef REPRO_DECODE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// Returns cudaGetLastError() after the launch (0 on success). Strides are in
// elements; the last dimension of q and the caches is dense; n_valid is a
// device array of B int32; o is a dense (B,H,Dv) tensor. The caller
// guarantees 1 <= Dh, Dv <= 128, H % KH == 0 and H / KH <= 16.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                    const void* n_valid, void* o, int b, int s, int h, int kh,
                                    int dh, int dv, long long q_sb, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, float scale,
                                    void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* nv = static_cast<const int*>(n_valid);
  if (dh < 1 || dv < 1 || dh > kDMax || dv > kDMax || kh < 1 || h % kh != 0 || h / kh > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kFloat32) {
    return launch_for_groups<float>(q, k, v, nv, o, b, s, h, kh, dh, dv, q_sb, q_sh, k_sb,
                                    k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
  }
  if (dtype == kBFloat16) {
    return launch_for_groups<__nv_bfloat16>(q, k, v, nv, o, b, s, h, kh, dh, dv, q_sb, q_sh,
                                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
