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
// bytes. The first version (one thread per state column, 64 a block) was bound
// by shared-memory load issue: every thread read each step's r, k, w rows and
// u whole (64 LDS.128 a thread a step) and formed sum_i r_i u_i k_i for
// itself, with ~4 warps an SM to hide it. This one issues ~126 instructions a
// thread a step, 97 of them the products and the update; what limits it is
// that issue on ~8 warps an SM, beside the chunks' streaming (PERF.md).
//
// Design: the Pallas grid's sequential chunk axis becomes a loop inside one
// block, one block per (b, h).
// - The state is split into tiles of R = N/8 rows x 4 columns: thread (q, cg)
//   keeps S[rows of row group q, 4 cg : 4 cg + 4) in registers, the rows in
//   pieces of 4 (m*32 + 4q + [0, 4) at N = 64), so a step reads its r, k and w
//   values with 16-byte shared loads that the warp's 8 row groups spread over
//   distinct banks, and v with one more. That is 8 loads for 96 fp32
//   operations a thread a step, against 64 loads for ~320 before. The 8 row
//   groups of a column sit in lanes 4 apart; each thread's 4 partial sums
//   sum_i r_i S[i, j] are reduced over them by a transposed butterfly (xor 16
//   and xor 8 each halve the columns a lane carries, xor 4 finishes), 4
//   shuffles a step, after which each lane holds one column's sum; lanes 4
//   apart store the same y value, so the store takes no branch. A block of
//   2 N threads (128 at N = 64) gives rwkv6-7b's shape ~8 warps an SM.
// - Steps are walked in groups of 4: the group's shared loads first, its
//   butterflies side by side, its y stores last.
// - ruk_t = sum_i r_t[i] u[i] k_t[i] is formed once per step per (b, h), in a
//   pass over the chunk spread over the block's threads (16 terms a thread,
//   then shuffles), into a shared s_ruk[t]; the walk adds v_t[j] ruk_t.
// - Chunks of kChunk = 32 steps of r, k, v and w land in shared memory through
//   16-byte cp.async copies, double-buffered: chunk c + 1 is in flight while
//   chunk c is walked. y goes to a shared tile and leaves with 16-byte stores
//   one chunk later. Inputs the copies cannot take (a base not on 16 bytes, or
//   rows that are not whole 16-byte packs) are staged by plain loads, eight in
//   flight a thread: the scalar path.
// - Columns and rows past N are zero in shared memory (and u), so the loops run
//   over a compile-time width NT (16, 32 or 64) with no bounds checks.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;   // time steps staged per pass
constexpr int kGroups = 8;   // row groups of a state column
constexpr int kCols = 4;     // state columns a thread keeps
constexpr unsigned kFull = 0xffffffffu;

template <int NT>
__host__ __device__ constexpr int threads_for() {
  return kGroups * NT / kCols;
}

template <typename T, int NT>
struct __align__(16) Smem {
  T r[2][kChunk][NT], k[2][kChunk][NT], v[2][kChunk][NT], w[2][kChunk][NT];
  T y[kChunk][NT];
  float ruk[kChunk];
  float u[NT];
};

// Rows [0, rows) of one (b, h) of a (B, S, H, n) tensor, row t at src + t *
// row_stride, into dst[rows][NT]; columns n..NT are left as they are (zero).
template <typename T, int NT, bool kVec>
__device__ __forceinline__ void stage_one(T (*dst)[NT], const T* __restrict__ src,
                                          int64_t row_stride, int rows, int n) {
  constexpr int kThreads = threads_for<NT>();
  if constexpr (kVec) {
    constexpr int P = 16 / sizeof(T);
    constexpr int kPacks = NT / P;   // a row's packs at the full width; those past n skip
    for (int p = threadIdx.x; p < rows * kPacks; p += kThreads) {
      const int t = p / kPacks, c = (p % kPacks) * P;
      if (c < n) hopper::cp_async16(&dst[t][c], src + t * row_stride + c, 16);
    }
  } else {
    copy_scalar<T, kThreads>(
        rows * n, [&](int p) { return src[(p / n) * row_stride + p % n]; },
        [&](int p, T x) { dst[p / n][p % n] = x; });
  }
}

template <typename T, int NT, bool kVec>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const T (*src)[NT],
                                           int64_t row_stride, int rows, int n) {
  constexpr int kThreads = threads_for<NT>();
  if constexpr (kVec) {
    constexpr int P = 16 / sizeof(T);
    constexpr int kPacks = NT / P;
    for (int p = threadIdx.x; p < rows * kPacks; p += kThreads) {
      const int t = p / kPacks, c = (p % kPacks) * P;
      if (c < n) {
        *reinterpret_cast<uint4*>(dst + t * row_stride + c) =
            *reinterpret_cast<const uint4*>(&src[t][c]);
      }
    }
  } else {
    for (int p = threadIdx.x; p < rows * n; p += kThreads) {
      dst[(p / n) * row_stride + p % n] = src[p / n][p % n];
    }
  }
}

template <typename T, int NT, bool kVec>
__global__ void __launch_bounds__(threads_for<NT>())
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_t,
                 int seq, int heads, int n) {
  constexpr int kThreads = threads_for<NT>();
  constexpr int R = NT / kGroups;       // state rows a thread keeps: 2, 4 or 8
  constexpr int P = R < 4 ? R : 4;      // rows a piece
  constexpr int M = R / P;              // pieces; piece m holds rows m*8P + qP + [0, P)
  constexpr int kPerStep = kThreads / kChunk;   // threads forming one step's ruk
  constexpr int kGroup = 4;                      // steps walked together
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<T, NT>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = lane >> 2;                       // row group
  const int j0 = ((tid >> 5) * 4 + (lane & 3)) * kCols;   // first of the 4 columns
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;

  // Columns n..NT of the staging buffers stay zero; the copies write columns < n.
  for (int p = tid; p < 2 * kChunk * NT; p += kThreads) {
    if (p % NT >= n) {
      (&sm.r[0][0][0])[p] = Elem<T>::zero();
      (&sm.k[0][0][0])[p] = Elem<T>::zero();
      (&sm.v[0][0][0])[p] = Elem<T>::zero();
      (&sm.w[0][0][0])[p] = Elem<T>::zero();
    }
  }
  for (int i = tid; i < NT; i += kThreads) sm.u[i] = i < n ? u[h * n + i] : 0.f;

  const bool vec_state = (n % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(s_t)) % 16 == 0);
  const float* s0p = s0 + static_cast<int64_t>(bh) * n * n;
  float st[R][kCols];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const int i = m * kGroups * P + q * P + e;
      float* row = st[m * P + e];
      if (i < n && vec_state && j0 < n) {
        Elem<float>::load_small<4>(s0p + i * n + j0, row);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) row[c] = (i < n && j0 + c < n) ? s0p[i * n + j0 + c] : 0.f;
      }
    }
  }

  const int64_t row_stride = static_cast<int64_t>(heads) * n;
  const int64_t base = (static_cast<int64_t>(b) * seq * heads + h) * n;
  const int chunks = (seq + kChunk - 1) / kChunk;
  auto stage = [&](int buf, int t0, int rows) {
    const int64_t off = base + t0 * row_stride;
    stage_one<T, NT, kVec>(sm.r[buf], r + off, row_stride, rows, n);
    stage_one<T, NT, kVec>(sm.k[buf], k + off, row_stride, rows, n);
    stage_one<T, NT, kVec>(sm.v[buf], v + off, row_stride, rows, n);
    stage_one<T, NT, kVec>(sm.w[buf], w + off, row_stride, rows, n);
    if constexpr (kVec) hopper::cp_async_commit();
  };
  stage(0, 0, min(kChunk, seq));

  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int t0 = c * kChunk;
    const int rows = min(kChunk, seq - t0);
    if constexpr (kVec) hopper::cp_async_wait<0>();
    __syncthreads();   // chunk c has landed; the walk of chunk c - 1 is done
    if (c > 0) store_tile<T, NT, kVec>(y + base + (t0 - kChunk) * row_stride, sm.y, row_stride,
                                       kChunk, n);
    if (c + 1 < chunks) stage(buf ^ 1, t0 + kChunk, min(kChunk, seq - t0 - kChunk));

    {   // ruk_t = sum_i r_t[i] u[i] k_t[i], kPerStep threads a step, 16 terms each
      // (the thread index read afresh: derived from tid and kept across the
      // walk, ptxas spills it)
      unsigned me;
      asm volatile("mov.u32 %0, %%tid.x;" : "=r"(me));
      const int t = me / kPerStep, part = me % kPerStep;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int i = part * 16 + e;
        acc = fmaf(Elem<T>::to_float(sm.r[buf][t][i]) * sm.u[i],
                   Elem<T>::to_float(sm.k[buf][t][i]), acc);
      }
#pragma unroll
      for (int off = 1; off < kPerStep; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (part == 0) sm.ruk[t] = acc;
    }
    __syncthreads();   // ruk is formed; the last y tile is out

    // Steps in groups of kGroup: every shared load of the group first, the
    // butterflies of its steps side by side, its y stores last. A store to the
    // y tile between two steps would hold the next step's loads behind it (the
    // compiler cannot tell the buffers apart) and lay each step's latency end
    // to end.
    const bool hi = lane & 16, mid = lane & 8;
    auto walk = [&](auto group, int t0s) {
      constexpr int G = decltype(group)::value;
      float rv[G][R], wv[G][R], kv[G][R], vv[G][kCols], ruk[G], sum[G];
#pragma unroll
      for (int s = 0; s < G; ++s) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int i0 = m * kGroups * P + q * P;
          Elem<T>::template load_small<P>(&sm.r[buf][t0s + s][i0], rv[s] + m * P);
          Elem<T>::template load_small<P>(&sm.w[buf][t0s + s][i0], wv[s] + m * P);
          Elem<T>::template load_small<P>(&sm.k[buf][t0s + s][i0], kv[s] + m * P);
        }
        Elem<T>::template load_small<kCols>(&sm.v[buf][t0s + s][j0], vv[s]);
        ruk[s] = sm.ruk[t0s + s];
      }
#pragma unroll
      for (int s = 0; s < G; ++s) {
        float acc[kCols];
#pragma unroll
        for (int c4 = 0; c4 < kCols; ++c4) {
          acc[c4] = 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) acc[c4] = fmaf(rv[s][i], st[i][c4], acc[c4]);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int c4 = 0; c4 < kCols; ++c4) {
            st[i][c4] = fmaf(wv[s][i], st[i][c4], kv[s][i] * vv[s][c4]);
          }
        }
        // Over the 8 row groups (lane bits 4, 3, 2): xor 16 leaves a lane
        // columns {0, 1} or {2, 3}, xor 8 one of them, xor 4 the rest of the sum.
        float keep0 = hi ? acc[2] : acc[0], keep1 = hi ? acc[3] : acc[1];
        keep0 += __shfl_xor_sync(kFull, hi ? acc[0] : acc[2], 16);
        keep1 += __shfl_xor_sync(kFull, hi ? acc[1] : acc[3], 16);
        sum[s] = mid ? keep1 : keep0;
        sum[s] += __shfl_xor_sync(kFull, mid ? keep0 : keep1, 8);
        sum[s] += __shfl_xor_sync(kFull, sum[s], 4);
      }
      const int col = j0 + (hi ? 2 : 0) + (mid ? 1 : 0);
#pragma unroll
      for (int s = 0; s < G; ++s) {   // lanes 4 apart hold the same sum: the same value
        const float vj = hi ? (mid ? vv[s][3] : vv[s][2]) : (mid ? vv[s][1] : vv[s][0]);
        sm.y[t0s + s][col] = Elem<T>::from_float(fmaf(vj, ruk[s], sum[s]));
      }
    };
    int ts = 0;
    for (; ts + kGroup <= rows; ts += kGroup) walk(std::integral_constant<int, kGroup>{}, ts);
    for (; ts < rows; ++ts) walk(std::integral_constant<int, 1>{}, ts);
  }
  __syncthreads();
  const int t_last = (chunks - 1) * kChunk;
  store_tile<T, NT, kVec>(y + base + t_last * row_stride, sm.y, row_stride, seq - t_last, n);

  // The conditions of the state's store are formed anew from an opaque copy of
  // n: kept live from the load across the walk, ptxas spills them.
  int n_end = n;
  asm volatile("" : "+r"(n_end));
  const bool vec_end = (n_end % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(s_t)) % 16 == 0);
  float* stp = s_t + static_cast<int64_t>(bh) * n_end * n_end;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const int i = m * kGroups * P + q * P + e;
      const float* row = st[m * P + e];
      if (i < n_end && vec_end && j0 < n_end) {
        *reinterpret_cast<float4*>(stp + i * n_end + j0) =
            make_float4(row[0], row[1], row[2], row[3]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (i < n_end && j0 + c < n_end) stp[i * n_end + j0 + c] = row[c];
        }
      }
    }
  }
}

// The kernel takes its shared memory (72 KB at N = 64 in fp32) dynamically; the
// attribute that allows more than 48 KB is set once, at the first launch, never
// inside a graph capture that a later launch may be part of.
template <typename T, int NT, bool kVec>
int launch(const T* r, const T* k, const T* v, const T* w, const float* u, const float* s0, T* y,
           float* s_t, int batch, int seq, int heads, int n, cudaStream_t st) {
  constexpr int smem = sizeof(Smem<T, NT>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv_scan_kernel<T, NT, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rwkv_scan_kernel<T, NT, kVec><<<batch * heads, threads_for<NT>(), smem, st>>>(
      r, k, v, w, u, s0, y, s_t, seq, heads, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int launch_width(const void* r, const void* k, const void* v, const void* w, const float* u,
                 const float* s0, void* y, float* s_t, int batch, int seq, int heads, int n,
                 bool vec, cudaStream_t st) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  return vec ? launch<T, NT, true>(rp, kp, vp, wp, u, s0, yp, s_t, batch, seq, heads, n, st)
             : launch<T, NT, false>(rp, kp, vp, wp, u, s0, yp, s_t, batch, seq, heads, n, st);
}

template <typename T>
int dispatch_width(int width, int chunk, const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* s0, void* y, float* s_t,
                   int batch, int seq, int heads, int n, bool vec, cudaStream_t st) {
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (width == 16) {
    return launch_width<T, 16>(r, k, v, w, u, s0, y, s_t, batch, seq, heads, n, vec, st);
  }
  if (width == 32) {
    return launch_width<T, 32>(r, k, v, w, u, s0, y, s_t, batch, seq, heads, n, vec, st);
  }
  if (width == 64) {
    return launch_width<T, 64>(r, k, v, w, u, s0, y, s_t, batch, seq, heads, n, vec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// r, k, v, w, y: (batch, seq, heads, n), dense, of dtype (0 fp32, 1 bf16); u:
// (heads, n) fp32; s0, s_t: (batch, heads, n, n) fp32, dense. 1 <= n <= width,
// seq >= 1. width (16, 32 or 64) and chunk are the launch geometry the wrapper
// computed (rwkv_scan.geometry); a pair this file does not build is refused.
// vec = 1 when every (batch, seq, heads, n) pointer is 16-byte aligned and n
// fills whole 16-byte packs. Returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int rwkv_scan(int dtype, int width, int chunk, const void* r, const void* k,
                         const void* v, const void* w, const void* u, const void* s0, void* y,
                         void* s_t, int batch, int seq, int heads, int n, int vec, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seq < 1 || heads < 1 || n < 1 || n > width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* stp = static_cast<float*>(s_t);
  if (dtype == kFloat32) {
    return dispatch_width<float>(width, chunk, r, k, v, w, up, s0p, y, stp, batch, seq, heads,
                                 n, vec != 0, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_width<bf16>(width, chunk, r, k, v, w, up, s0p, y, stp, batch, seq, heads, n,
                                vec != 0, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
