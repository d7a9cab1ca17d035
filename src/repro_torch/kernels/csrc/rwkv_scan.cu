// The RWKV6 recurrence for Hopper, sm_90a, with a plain C entry point for ctypes.
//
// Replaces: src/repro/kernels/rwkv_scan.py, rwkv_scan -> _rwkv_kernel, the Pallas
// TPU kernel. It computes what that kernel computes, for each (batch b, head h)
// with an (N, N) state S:
//   y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}),   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// returning y (B, S, H, N) in the inputs' type and S_T (B, H, N, N) in fp32. The
// math and the state are fp32 whatever the inputs' type.
//
// What bounds it on an H100: per (b, h, t) the function needs about 5 N^2 flops
// (y: N^2 multiply-adds of r_i S[i, j], plus O(N) for v_j sum_i r_i u_i k_i;
// the update: a multiply and a multiply-add per state entry) against 4 N inputs
// read and N outputs written. At rwkv6-7b's prefill shape (B=4, S=1024, H=64,
// N=64, fp32) the 5.4 GFLOP take 0.080 ms at the 67 TFLOP/s of fp32 outside the
// tensor cores and the 0.34 GB moved 0.103 ms at 3.35 TB/s, so the bound is the
// bytes. Neither is what limits this first version: the recurrence is sequential
// in t, so each block walks S steps one after another, and with 2 warps a block
// the loads that stage each chunk wait out the memory's latency one after
// another, so 16-byte loads, 4 (fp32) or 8 (bf16) elements each, take fewer
// such waits than scalar ones (chip_smoke.py times the scalar path, which
// misaligned inputs take, beside them). Each thread also forms
// sum_i r_i u_i k_i for itself, the same sum in every thread of the block
// (2 N^2 flops a step more than the function needs): a speed item, not a fault.
//
// Design: the Pallas grid's sequential chunk axis becomes a loop inside one
// block. One block per (b, h), one thread per column j of the state: thread j
// keeps S[:, j] in registers for the whole sequence, where the Pallas kernel
// keeps the state in VMEM scratch. Each pass stages a chunk of kChunk rows of r,
// k, v and w (each row N contiguous elements) into shared memory as fp32, with
// 16-byte loads where the rows allow them; every thread then reads step t's
// rows from there (one address for the whole warp: a broadcast). Thread j forms
// y_t[j] = v_t[j] * sum_i r_t[i] u[i] k_t[i] + sum_i r_t[i] S[i, j] itself, so no
// sum crosses threads, and then updates its column. Columns past N and rows past
// N in shared memory are zero, so the loops run over a compile-time width NT
// (16, 32 or 64) with no bounds checks.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;  // time steps staged per pass

template <int NT>
constexpr int threads_for() {
  return NT < 32 ? 32 : NT;
}

// Rows [t0, t0 + rows) of one (b, h) of a (B, S, H, n) tensor into dst[rows][NT]
// as fp32. Row t starts at src + t * row_stride.
template <typename T, int NT, bool kVec>
__device__ __forceinline__ void stage(float (*dst)[NT], const T* __restrict__ src,
                                      int64_t row_stride, int rows, int n) {
  if (kVec) {
    constexpr int P = Elem<T>::kPack;
    const int per_row = n / P;
    for (int p = threadIdx.x; p < rows * per_row; p += blockDim.x) {
      const int t = p / per_row, c = (p % per_row) * P;
      float tmp[P];
      Elem<T>::load_pack(src + t * row_stride + c, tmp);
#pragma unroll
      for (int e = 0; e < P; ++e) dst[t][c + e] = tmp[e];
    }
  } else {
    for (int p = threadIdx.x; p < rows * n; p += blockDim.x) {
      const int t = p / n, c = p % n;
      dst[t][c] = Elem<T>::to_float(src[t * row_stride + c]);
    }
  }
}

template <typename T, int NT, bool kVec>
__global__ void __launch_bounds__(threads_for<NT>())
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_t,
                 int seq, int heads, int n) {
  __shared__ float sr[kChunk][NT], sk[kChunk][NT], sv[kChunk][NT], sw[kChunk][NT];
  __shared__ float su[NT];
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int j = threadIdx.x;
  const bool own = j < n;

  // Zero the staging buffers once: the columns at n and past stay zero.
  for (int p = threadIdx.x; p < kChunk * NT; p += blockDim.x) {
    (&sr[0][0])[p] = 0.f;
    (&sk[0][0])[p] = 0.f;
    (&sv[0][0])[p] = 0.f;
    (&sw[0][0])[p] = 0.f;
  }
  for (int i = threadIdx.x; i < NT; i += blockDim.x) su[i] = i < n ? u[h * n + i] : 0.f;

  float st[NT];
  const float* s0p = s0 + static_cast<int64_t>(bh) * n * n;
#pragma unroll
  for (int i = 0; i < NT; ++i) st[i] = (own && i < n) ? s0p[i * n + j] : 0.f;

  const int64_t row_stride = static_cast<int64_t>(heads) * n;
  const int64_t base = (static_cast<int64_t>(b) * seq * heads + h) * n;
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int rows = min(kChunk, seq - t0);
    const int64_t off = base + t0 * row_stride;
    __syncthreads();  // the previous chunk is consumed (and the zero fill done)
    stage<T, NT, kVec>(sr, r + off, row_stride, rows, n);
    stage<T, NT, kVec>(sk, k + off, row_stride, rows, n);
    stage<T, NT, kVec>(sv, v + off, row_stride, rows, n);
    stage<T, NT, kVec>(sw, w + off, row_stride, rows, n);
    __syncthreads();
    if (!own) continue;
    for (int t = 0; t < rows; ++t) {
      const float vj = sv[t][j];
      float ruk[4] = {0.f, 0.f, 0.f, 0.f}, rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float ri = sr[t][i];
        ruk[i & 3] += ri * su[i] * sk[t][i];
        rs[i & 3] += ri * st[i];
      }
      const float out = vj * ((ruk[0] + ruk[1]) + (ruk[2] + ruk[3])) + ((rs[0] + rs[1]) + (rs[2] + rs[3]));
      y[off + t * row_stride + j] = Elem<T>::from_float(out);
#pragma unroll
      for (int i = 0; i < NT; ++i) st[i] = sw[t][i] * st[i] + sk[t][i] * vj;
    }
  }

  if (own) {
    float* stp = s_t + static_cast<int64_t>(bh) * n * n;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < n) stp[i * n + j] = st[i];
    }
  }
}

template <typename T, int NT>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, void* y, float* s_t, int batch, int seq, int heads, int n, bool vec,
           cudaStream_t st) {
  const dim3 grid(batch * heads);
  const int threads = threads_for<NT>();
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (vec) {
    rwkv_scan_kernel<T, NT, true><<<grid, threads, 0, st>>>(rp, kp, vp, wp, u, s0, yp, s_t, seq,
                                                            heads, n);
  } else {
    rwkv_scan_kernel<T, NT, false><<<grid, threads, 0, st>>>(rp, kp, vp, wp, u, s0, yp, s_t,
                                                             seq, heads, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* s0, void* y, float* s_t, int batch, int seq, int heads, int n,
                   bool vec, cudaStream_t st) {
  if (n <= 16) return launch<T, 16>(r, k, v, w, u, s0, y, s_t, batch, seq, heads, n, vec, st);
  if (n <= 32) return launch<T, 32>(r, k, v, w, u, s0, y, s_t, batch, seq, heads, n, vec, st);
  return launch<T, 64>(r, k, v, w, u, s0, y, s_t, batch, seq, heads, n, vec, st);
}

}  // namespace
}  // namespace repro_torch

// r, k, v, w, y: (batch, seq, heads, n), dense, of dtype (0 fp32, 1 bf16); u:
// (heads, n) fp32; s0, s_t: (batch, heads, n, n) fp32, dense. 1 <= n <= 64,
// seq >= 1. vec = 1 when every (batch, seq, heads, n) pointer is 16-byte aligned
// and n fills whole 16-byte packs. Returns the CUDA error of the launch (0 when
// it was accepted).
extern "C" int rwkv_scan(int dtype, const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* s0, void* y, void* s_t, int batch, int seq,
                         int heads, int n, int vec, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seq < 1 || heads < 1 || n < 1 || n > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* stp = static_cast<float*>(s_t);
  if (dtype == kFloat32) {
    return dispatch_width<float>(r, k, v, w, up, s0p, y, stp, batch, seq, heads, n, vec != 0, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_width<bf16>(r, k, v, w, up, s0p, y, stp, batch, seq, heads, n, vec != 0, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
