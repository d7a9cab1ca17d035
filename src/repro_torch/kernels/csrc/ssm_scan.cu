// The Mamba selective scan for Hopper, sm_90a, with a plain C entry point for
// ctypes.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan -> _ssm_kernel, the Pallas TPU
// kernel. It computes what that kernel computes, for each batch row b and channel
// d with a state h[d, 0:N):
//   h_t = exp(dt_t * A[d]) (.) h_{t-1} + (dt_t * x_t[d]) B_t,   y_t[d] = h_t . C_t,
// returning y (B, S, Di) in the requested type (x's by default) and h_T (B, Di, N)
// in fp32. The math and the state are fp32 whatever the inputs' type.
//
// The exponential: exp(dt a) = 2^(dt a'), a' = a log2 e formed once a lane,
// by one MUFU.EX2 (ex2.approx.ftz, relative error ~2^-22, results below
// 2^-126 flushed to zero). expf's correctly rounded range reduction puts ~8
// fp32 instructions around the same MUFU.EX2: 32 of a step's ~78 in this
// design's first build. The fp32 cases, the 1536-step prefill among them, pass at
// 1e-4 with 2^(dt a') (chip_smoke.py).
//
// What bounds it on an H100: per (b, t, d) N exponentials and ~4 N flops against
// one x read and one y written (dt, B and C are shared by the channels of a batch
// row). At hymba-1.5b's prefill shape (B=4, S=1536, Di=3200, N=16) that is 315 M
// exponentials, ~0.08 ms on the special-function units (16 a clock an SM), a
// floor, against ~0.12 GB moved, 0.036 ms at 3.35 TB/s, the bound. The first
// version was latency-bound: one thread per channel, 3 warps an SM, and a
// device-memory load of x and a store of y inside every step, each step
// waiting out a load. This one issues ~33 instructions a lane a step; what
// limits it is their dependent issue across ~12 warps an SM, not one unit's
// throughput, plus the per-chunk staging (PERF.md).
//
// Design: the Pallas grid's sequential chunk axis becomes a loop inside one
// block, and every device-memory access leaves the step loop.
// - A channel's state is split over kLanes = 4 adjacent lanes, each holding
//   NT/4 of h[d, :] and A[d, :] in registers (columns m*16 + 4g + [0, 4) for
//   lane g, so a step reads its B and C values with one 16-byte shared load
//   per piece of 4); y_t[d] is the sum of the four lanes' partials, reduced by
//   two __shfl_xor_sync (xor 1, then xor 2).
// - A block is two warps: kChannels = 16 channels of one batch row. At hymba's
//   shape that is 800 blocks, 6-7 an SM (~12 warps).
// - Each chunk of 64 steps (32 at N > 32) of x (the block's 16 channels), B
//   and C lands in shared memory through 16-byte cp.async copies,
//   double-buffered: chunk c + 1 is in flight while chunk c is walked. bf16 B
//   and C are widened to fp32 once a chunk. dt, one element a step and of no
//   useful alignment, is loaded into registers ahead and stored to shared
//   memory after the walk. y goes to a shared tile and leaves with 16-byte
//   stores, one chunk at a time. Inputs the copies cannot take (a base or a
//   row not on 16 bytes) are staged by plain loads, eight in flight a thread,
//   before each walk: the scalar path.
// - Steps are walked in groups of 4 (2 at N > 32): the group's shared loads
//   first, its shuffles side by side, its y stores last.
// - The last channel block is masked, so any d_inner works (hymba's 3200 is
//   not a multiple of the Pallas kernel's block_d of 256). Columns past N are
//   zero in shared memory and in A, so the state loops run over a
//   compile-time width NT (16, 32 or 64) with no bounds checks.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kLanes = 4;                      // lanes per channel
constexpr int kChannels = 16;                  // channels per block
constexpr int kThreads = kLanes * kChannels;   // two warps
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Time steps staged a pass: 64, or 32 at N > 32 (static shared memory stays
// under 48 KB).
template <int NT>
__host__ __device__ constexpr int chunk_for() {
  return NT == 64 ? 32 : 64;
}

template <typename T, typename Out, int NT>
struct __align__(16) Smem {
  static constexpr int kChunk = chunk_for<NT>();
  static constexpr int kWide = sizeof(T) == 2 ? kChunk : 1;   // fp32 copies of bf16 B, C
  T x[2][kChunk][kChannels];
  T b[2][kChunk][NT];
  T c[2][kChunk][NT];
  float bw[kWide][NT];
  float cw[kWide][NT];
  float dt[2][kChunk];
  Out y[kChunk][kChannels];
};

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// results below 2^-126 flushed to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Eight bf16 values at src to fp32 at dst, both 16-byte aligned.
__device__ __forceinline__ void widen8(const bf16* src, float* dst) {
  float wide[8];
  Elem<bf16>::load_pack(src, wide);
  reinterpret_cast<float4*>(dst)[0] = make_float4(wide[0], wide[1], wide[2], wide[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(wide[4], wide[5], wide[6], wide[7]);
}

// x (the block's channels), B and C of steps [t0, t0 + rows) into buffer buf.
template <typename T, typename Out, int NT, bool kVec>
__device__ __forceinline__ void stage(Smem<T, Out, NT>& sm, int buf, const T* __restrict__ x,
                                      const T* __restrict__ bm, const T* __restrict__ cm,
                                      int64_t row0, int t0, int rows, int d0, int d_inner,
                                      int n) {
  const T* xsrc = x + (row0 + t0) * d_inner + d0;
  const T* bsrc = bm + (row0 + t0) * n;
  const T* csrc = cm + (row0 + t0) * n;
  if constexpr (kVec) {
    constexpr int P = 16 / sizeof(T);
    constexpr int XP = kChannels / P;   // packs per x row
    for (int p = threadIdx.x; p < rows * XP; p += kThreads) {
      const int t = p / XP, e = (p % XP) * P;
      if (d0 + e < d_inner) hopper::cp_async16(&sm.x[buf][t][e], xsrc + t * d_inner + e, 16);
    }
    constexpr int kPacks = NT / P;   // a row's packs at the full width; those past n skip
    for (int p = threadIdx.x; p < rows * kPacks; p += kThreads) {
      const int t = p / kPacks, e = (p % kPacks) * P;
      if (e < n) {
        hopper::cp_async16(&sm.b[buf][t][e], bsrc + t * n + e, 16);
        hopper::cp_async16(&sm.c[buf][t][e], csrc + t * n + e, 16);
      }
    }
    hopper::cp_async_commit();
  } else {
    const int width = min(kChannels, d_inner - d0);
    copy_scalar<T, kThreads>(
        rows * width, [&](int p) { return xsrc[(p / width) * d_inner + p % width]; },
        [&](int p, T v) { sm.x[buf][p / width][p % width] = v; });
    copy_scalar<T, kThreads>(
        rows * n, [&](int p) { return bsrc[p]; },
        [&](int p, T v) { sm.b[buf][p / n][p % n] = v; });
    copy_scalar<T, kThreads>(
        rows * n, [&](int p) { return csrc[p]; },
        [&](int p, T v) { sm.c[buf][p / n][p % n] = v; });
  }
}

// Lane g's share of a width-NT row: pieces of 4 at columns m*16 + 4g.
template <typename T, int NT>
__device__ __forceinline__ void lane_row(const T* row, int g, float* out) {
#pragma unroll
  for (int m = 0; m < NT / 16; ++m) {
    Elem<T>::template load_small<4>(row + m * 16 + 4 * g, out + 4 * m);
  }
}

// The lane's state entries of (row, 0:n) of a dense (rows, n) fp32 array: 16-byte
// loads where the pieces allow them.
template <int NT>
__device__ __forceinline__ void load_lane_state(const float* p, int n, int g, bool own, bool vec,
                                                float* out) {
#pragma unroll
  for (int m = 0; m < NT / 16; ++m) {
    const int col = m * 16 + 4 * g;
    if (own && vec && col < n) {
      Elem<float>::load_small<4>(p + col, out + 4 * m);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * m + e] = (own && col + e < n) ? p[col + e] : 0.f;
    }
  }
}

template <typename T, typename Out, int NT, bool kVec>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ a,
                const float* __restrict__ h0, Out* __restrict__ y, float* __restrict__ h_t,
                int seq, int d_inner, int n) {
  constexpr int kChunk = chunk_for<NT>();
  constexpr int E = NT / kLanes;                 // state entries a lane
  constexpr int kGroup = NT == 64 ? 2 : 4;       // steps walked together
  constexpr int kDt = (kChunk + kThreads - 1) / kThreads;   // dt values a thread stages
  __shared__ __align__(16) unsigned char smem_raw[sizeof(Smem<T, Out, NT>)];
  auto& sm = *reinterpret_cast<Smem<T, Out, NT>*>(smem_raw);
  const int tid = threadIdx.x;
  const int ch = tid / kLanes, g = tid % kLanes;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const bool own = d < d_inner;

  // Columns n..NT of B and C stay zero; the copies write only columns < n.
  for (int p = tid; p < 2 * kChunk * NT; p += kThreads) {
    if (p % NT >= n) {
      (&sm.b[0][0][0])[p] = Elem<T>::zero();
      (&sm.c[0][0][0])[p] = Elem<T>::zero();
    }
  }
  const bool vec_state = (n % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(h_t) |
        reinterpret_cast<uintptr_t>(a)) % 16 == 0);
  float h[E], av[E];
  const int64_t state = (static_cast<int64_t>(b) * d_inner + d) * n;
  load_lane_state<NT>(h0 + state, n, g, own, vec_state, h);
  load_lane_state<NT>(a + static_cast<int64_t>(d) * n, n, g, own, vec_state, av);
#pragma unroll
  for (int i = 0; i < E; ++i) av[i] *= kLog2e;   // exp(dt a) = 2^(dt a log2 e)

  const int64_t row0 = static_cast<int64_t>(b) * seq;
  const int chunks = (seq + kChunk - 1) / kChunk;
  const bool vec_out = (d_inner * sizeof(Out)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;

  stage<T, Out, NT, kVec>(sm, 0, x, bm, cm, row0, 0, min(kChunk, seq), d0, d_inner, n);
  for (int t = tid; t < min(kChunk, seq); t += kThreads) {
    sm.dt[0][t] = Elem<T>::to_float(dt[row0 + t]);
  }

  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int t0 = c * kChunk;
    const int rows = min(kChunk, seq - t0);
    if constexpr (kVec) hopper::cp_async_wait<0>();
    __syncthreads();   // chunk c has landed; the last chunk's y tile is out
    const bool next = c + 1 < chunks;
    const int next_rows = next ? min(kChunk, seq - t0 - kChunk) : 0;
    float dt_next[kDt];
    if (next) {
      stage<T, Out, NT, kVec>(sm, buf ^ 1, x, bm, cm, row0, t0 + kChunk, next_rows, d0, d_inner,
                              n);
#pragma unroll
      for (int u = 0; u < kDt; ++u) {
        const int t = tid + u * kThreads;
        dt_next[u] = t < next_rows ? Elem<T>::to_float(dt[row0 + t0 + kChunk + t]) : 0.f;
      }
    }

    // bf16 B and C are widened to fp32 once a chunk, not once a lane a step.
    const float* bwalk;
    const float* cwalk;
    if constexpr (sizeof(T) == 2) {
      for (int p = tid * 8; p < kChunk * NT; p += kThreads * 8) {
        widen8(&sm.b[buf][0][0] + p, &sm.bw[0][0] + p);
        widen8(&sm.c[buf][0][0] + p, &sm.cw[0][0] + p);
      }
      __syncthreads();
      bwalk = &sm.bw[0][0];
      cwalk = &sm.cw[0][0];
    } else {
      bwalk = &sm.b[buf][0][0];
      cwalk = &sm.c[buf][0][0];
    }

    // Steps in groups of G: every shared load of the group first, the
    // shuffles of its steps side by side, its y stores last. A store to the y
    // tile between two steps would hold the next step's loads behind it (the
    // compiler cannot tell the buffers apart) and lay each step's latency end
    // to end.
    auto walk = [&](auto group, int t0s) {
      constexpr int G = decltype(group)::value;
      float dtv[G], dx[G], bv[G][E], cv[G][E], acc[G];
#pragma unroll
      for (int s = 0; s < G; ++s) {
        dtv[s] = sm.dt[buf][t0s + s];
        dx[s] = dtv[s] * Elem<T>::to_float(sm.x[buf][t0s + s][ch]);
        lane_row<float, NT>(bwalk + (t0s + s) * NT, g, bv[s]);
        lane_row<float, NT>(cwalk + (t0s + s) * NT, g, cv[s]);
      }
#pragma unroll
      for (int s = 0; s < G; ++s) {
        acc[s] = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          h[i] = ex2(dtv[s] * av[i]) * h[i] + dx[s] * bv[s][i];
          acc[s] = fmaf(h[i], cv[s][i], acc[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < G; ++s) acc[s] += __shfl_xor_sync(kFull, acc[s], 1);
#pragma unroll
      for (int s = 0; s < G; ++s) acc[s] += __shfl_xor_sync(kFull, acc[s], 2);
#pragma unroll
      for (int s = 0; s < G; ++s) {   // the 4 lanes of a channel store the same value
        sm.y[t0s + s][ch] = Elem<Out>::from_float(acc[s]);
      }
    };
    int ts = 0;
    for (; ts + kGroup <= rows; ts += kGroup) walk(std::integral_constant<int, kGroup>{}, ts);
    for (; ts < rows; ++ts) walk(std::integral_constant<int, 1>{}, ts);

    if (next) {
#pragma unroll
      for (int u = 0; u < kDt; ++u) {
        if (tid + u * kThreads < kChunk) sm.dt[buf ^ 1][tid + u * kThreads] = dt_next[u];
      }
    }
    __syncthreads();   // the y tile is complete
    Out* ydst = y + (row0 + t0) * d_inner + d0;
    if (vec_out) {
      constexpr int P = 16 / sizeof(Out);
      constexpr int YP = kChannels / P;
      for (int p = tid; p < rows * YP; p += kThreads) {
        const int t = p / YP, e = (p % YP) * P;
        if (d0 + e < d_inner) {
          *reinterpret_cast<uint4*>(ydst + t * d_inner + e) =
              *reinterpret_cast<const uint4*>(&sm.y[t][e]);
        }
      }
    } else {
      const int width = min(kChannels, d_inner - d0);
      for (int p = tid; p < rows * width; p += kThreads) {
        ydst[(p / width) * d_inner + p % width] = sm.y[p / width][p % width];
      }
    }
  }

  if (own) {
    float* dst = h_t + state;
#pragma unroll
    for (int m = 0; m < NT / 16; ++m) {
      const int col = m * 16 + 4 * g;
      if (vec_state && col < n) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(h[4 * m], h[4 * m + 1], h[4 * m + 2], h[4 * m + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e < n) dst[col + e] = h[4 * m + e];
        }
      }
    }
  }
}

template <typename T, typename Out, int NT>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const float* a,
           const float* h0, void* y, float* h_t, int batch, int seq, int d_inner, int n, bool vec,
           cudaStream_t st) {
  const dim3 grid((d_inner + kChannels - 1) / kChannels, batch);
  const T* xp = static_cast<const T*>(x);
  const T* dtp = static_cast<const T*>(dt);
  const T* bp = static_cast<const T*>(bm);
  const T* cp = static_cast<const T*>(cm);
  Out* yp = static_cast<Out*>(y);
  if (vec) {
    ssm_scan_kernel<T, Out, NT, true><<<grid, kThreads, 0, st>>>(xp, dtp, bp, cp, a, h0, yp, h_t,
                                                                 seq, d_inner, n);
  } else {
    ssm_scan_kernel<T, Out, NT, false><<<grid, kThreads, 0, st>>>(xp, dtp, bp, cp, a, h0, yp,
                                                                  h_t, seq, d_inner, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Out>
int dispatch_width(int width, int chunk, const void* x, const void* dt, const void* bm,
                   const void* cm, const float* a, const float* h0, void* y, float* h_t,
                   int batch, int seq, int d_inner, int n, bool vec, cudaStream_t st) {
  if (chunk != (width == 64 ? chunk_for<64>() : chunk_for<16>())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 16) {
    return launch<T, Out, 16>(x, dt, bm, cm, a, h0, y, h_t, batch, seq, d_inner, n, vec, st);
  }
  if (width == 32) {
    return launch<T, Out, 32>(x, dt, bm, cm, a, h0, y, h_t, batch, seq, d_inner, n, vec, st);
  }
  if (width == 64) {
    return launch<T, Out, 64>(x, dt, bm, cm, a, h0, y, h_t, batch, seq, d_inner, n, vec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_out(int out_dtype, int width, int chunk, const void* x, const void* dt,
                 const void* bm, const void* cm, const float* a, const float* h0, void* y,
                 float* h_t, int batch, int seq, int d_inner, int n, bool vec, cudaStream_t st) {
  if (out_dtype == kFloat32) {
    return dispatch_width<T, float>(width, chunk, x, dt, bm, cm, a, h0, y, h_t, batch, seq,
                                    d_inner, n, vec, st);
  }
  if (out_dtype == kBFloat16) {
    return dispatch_width<T, bf16>(width, chunk, x, dt, bm, cm, a, h0, y, h_t, batch, seq,
                                   d_inner, n, vec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// x: (batch, seq, d_inner), dt: (batch, seq, 1), bm, cm: (batch, seq, n), all dense
// and of in_dtype (0 fp32, 1 bf16); a: (d_inner, n) fp32; h0, h_t: (batch,
// d_inner, n) fp32; y: (batch, seq, d_inner) of out_dtype. 1 <= n <= width,
// seq >= 1, batch <= 65535. width (16, 32 or 64) and chunk are the launch
// geometry the wrapper computed (ssm_scan.geometry); a pair this file does not
// build is refused. vec = 1 when x, bm and cm are 16-byte aligned and d_inner and
// n fill whole 16-byte packs. Returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int ssm_scan(int in_dtype, int out_dtype, int width, int chunk, const void* x,
                        const void* dt, const void* bm, const void* cm, const void* a,
                        const void* h0, void* y, void* h_t, int batch, int seq, int d_inner,
                        int n, int vec, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || seq < 1 || d_inner < 1 || n < 1 || n > width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  float* htp = static_cast<float*>(h_t);
  if (in_dtype == kFloat32) {
    return dispatch_out<float>(out_dtype, width, chunk, x, dt, bm, cm, ap, h0p, y, htp, batch,
                               seq, d_inner, n, vec != 0, st);
  }
  if (in_dtype == kBFloat16) {
    return dispatch_out<bf16>(out_dtype, width, chunk, x, dt, bm, cm, ap, h0p, y, htp, batch,
                              seq, d_inner, n, vec != 0, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
