// The Mamba selective scan for Hopper, sm_90a, with a plain C entry point for
// ctypes.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan -> _ssm_kernel, the Pallas TPU
// kernel. It computes what that kernel computes, for each batch row b and channel
// d with a state h[d, 0:N):
//   h_t = exp(dt_t * A[d]) (.) h_{t-1} + (dt_t * x_t[d]) B_t,   y_t[d] = h_t . C_t,
// returning y (B, S, Di) in the requested type (x's by default) and h_T (B, Di, N)
// in fp32. The math and the state are fp32 whatever the inputs' type. The
// exponential is expf, correctly rounded to within an ulp, not the faster
// __expf, so the kernel meets the plain version at fp32's own tolerance.
//
// What bounds it on an H100: per (b, t, d) N exponentials and ~4 N flops against
// one x read and one y written (dt, B and C are shared by the channels of a batch
// row). At hymba-1.5b's prefill shape (B=4, S=1536, Di=3200, N=16) that is 315 M
// exponentials, ~0.09 ms on the SFUs, against ~0.16 GB moved, 0.05 ms at
// 3.35 TB/s. This first version is bound by neither: the scan is sequential in t,
// and each thread walks S steps one after another.
//
// Design: the Pallas grid's sequential chunk axis becomes a loop inside one
// block. One thread per (b, d), keeping h[d, :] and A[d, :] in registers for the
// whole sequence, where the Pallas kernel keeps a (block_d, N) state tile in
// VMEM scratch. A block covers kChannels channels of one batch row; each pass
// stages dt, B and C of kChunk steps into shared memory (a contiguous run of
// each, read coalesced), shared by all the block's channels as the Pallas
// kernel shares them across its channel block. x and y are read and written one
// element per thread per step, neighbouring threads on neighbouring channels.
// The last channel block is masked, so any d_inner works (hymba's 3200 is not a
// multiple of the Pallas kernel's block_d of 256). Columns past N are zero in
// shared memory and in A, so the state loops run over a compile-time width NT
// (16, 32 or 64) with no bounds checks.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChannels = 64;  // channels (threads) per block
constexpr int kChunk = 64;     // time steps staged per pass

template <typename T, typename Out, int NT>
__global__ void __launch_bounds__(kChannels)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ a,
                const float* __restrict__ h0, Out* __restrict__ y, float* __restrict__ h_t,
                int seq, int d_inner, int n) {
  __shared__ float s_dt[kChunk];
  __shared__ float s_b[kChunk][NT], s_c[kChunk][NT];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kChannels + threadIdx.x;
  const bool own = d < d_inner;

  for (int p = threadIdx.x; p < kChunk * NT; p += blockDim.x) {
    (&s_b[0][0])[p] = 0.f;
    (&s_c[0][0])[p] = 0.f;
  }
  float h[NT], av[NT];
  const int64_t state = (static_cast<int64_t>(b) * d_inner + d) * n;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const bool in = own && i < n;
    h[i] = in ? h0[state + i] : 0.f;
    av[i] = in ? a[static_cast<int64_t>(d) * n + i] : 0.f;
  }

  const int64_t row0 = static_cast<int64_t>(b) * seq;
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int rows = min(kChunk, seq - t0);
    __syncthreads();  // the previous chunk is consumed (and the zero fill done)
    const T* bsrc = bm + (row0 + t0) * n;
    const T* csrc = cm + (row0 + t0) * n;
    for (int p = threadIdx.x; p < rows * n; p += blockDim.x) {
      s_b[p / n][p % n] = Elem<T>::to_float(bsrc[p]);
      s_c[p / n][p % n] = Elem<T>::to_float(csrc[p]);
    }
    for (int p = threadIdx.x; p < rows; p += blockDim.x) {
      s_dt[p] = Elem<T>::to_float(dt[row0 + t0 + p]);
    }
    __syncthreads();
    if (!own) continue;
    for (int t = 0; t < rows; ++t) {
      const int64_t at = (row0 + t0 + t) * d_inner + d;
      const float dtv = s_dt[t];
      const float dx = dtv * Elem<T>::to_float(x[at]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        h[i] = expf(dtv * av[i]) * h[i] + dx * s_b[t][i];
        acc[i & 3] += h[i] * s_c[t][i];
      }
      y[at] = Elem<Out>::from_float((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

  if (own) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < n) h_t[state + i] = h[i];
    }
  }
}

template <typename T, typename Out>
int dispatch_width(const void* x, const void* dt, const void* bm, const void* cm, const float* a,
                   const float* h0, void* y, float* h_t, int batch, int seq, int d_inner, int n,
                   cudaStream_t st) {
  const dim3 grid((d_inner + kChannels - 1) / kChannels, batch);
  const T* xp = static_cast<const T*>(x);
  const T* dtp = static_cast<const T*>(dt);
  const T* bp = static_cast<const T*>(bm);
  const T* cp = static_cast<const T*>(cm);
  Out* yp = static_cast<Out*>(y);
  if (n <= 16) {
    ssm_scan_kernel<T, Out, 16><<<grid, kChannels, 0, st>>>(xp, dtp, bp, cp, a, h0, yp, h_t, seq,
                                                            d_inner, n);
  } else if (n <= 32) {
    ssm_scan_kernel<T, Out, 32><<<grid, kChannels, 0, st>>>(xp, dtp, bp, cp, a, h0, yp, h_t, seq,
                                                            d_inner, n);
  } else {
    ssm_scan_kernel<T, Out, 64><<<grid, kChannels, 0, st>>>(xp, dtp, bp, cp, a, h0, yp, h_t, seq,
                                                            d_inner, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_out(int out_dtype, const void* x, const void* dt, const void* bm, const void* cm,
                 const float* a, const float* h0, void* y, float* h_t, int batch, int seq,
                 int d_inner, int n, cudaStream_t st) {
  if (out_dtype == kFloat32) {
    return dispatch_width<T, float>(x, dt, bm, cm, a, h0, y, h_t, batch, seq, d_inner, n, st);
  }
  if (out_dtype == kBFloat16) {
    return dispatch_width<T, bf16>(x, dt, bm, cm, a, h0, y, h_t, batch, seq, d_inner, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// x: (batch, seq, d_inner), dt: (batch, seq, 1), bm, cm: (batch, seq, n), all dense
// and of in_dtype (0 fp32, 1 bf16); a: (d_inner, n) fp32; h0, h_t: (batch,
// d_inner, n) fp32; y: (batch, seq, d_inner) of out_dtype. 1 <= n <= 64,
// seq >= 1, batch <= 65535. Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int ssm_scan(int in_dtype, int out_dtype, const void* x, const void* dt,
                        const void* bm, const void* cm, const void* a, const void* h0, void* y,
                        void* h_t, int batch, int seq, int d_inner, int n, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || seq < 1 || d_inner < 1 || n < 1 || n > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  float* htp = static_cast<float*>(h_t);
  if (in_dtype == kFloat32) {
    return dispatch_out<float>(out_dtype, x, dt, bm, cm, ap, h0p, y, htp, batch, seq, d_inner, n,
                               st);
  }
  if (in_dtype == kBFloat16) {
    return dispatch_out<bf16>(out_dtype, x, dt, bm, cm, ap, h0p, y, htp, batch, seq, d_inner, n,
                              st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
