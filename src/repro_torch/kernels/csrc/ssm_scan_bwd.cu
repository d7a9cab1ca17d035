// The backward of the Mamba selective scan for Hopper, sm_90a, with a plain C
// entry point for ctypes.
//
// Replaces: no TPU kernel. The JAX package has no backward kernel for its scan:
// it differentiates the jnp lax.scan of src/repro/models/ssm.py (_mamba_inner)
// by autodiff. On the card the port's plain version of that backward is a
// Python loop over time that takes seconds a layer, so the training path needs
// a kernel of its own, as the flash backward was added. For each batch row b
// and channel d, with h_t = e_t (.) h_{t-1} + dt_t x_t[d] B_t, e_t = exp(dt_t A[d])
// and y_t[d] = h_t . C_t, it takes dy (B, S, Di) fp32 and dh_T (B, Di, N,
// absent = zero) and returns dx, ddt, dB, dC in the inputs' type, dA (Di, N)
// and dh0 (B, Di, N) in fp32. g_t, the whole adjoint of h_t, is
// dy_t[d] C_t + e_{t+1} (.) g_{t+1}, and
//   dx_t[d] = dt_t sum_n g_t B_t,   dB_t = sum_d g_t dt_t x_t[d],   dC_t = sum_d dy_t[d] h_t,
//   ddt_t = sum_{d,n} g_t (A e_t h_{t-1} + x_t[d] B_t),   dA = sum_{b,t} g_t dt_t e_t h_{t-1},
//   dh0 = e_1 (.) g_1.
// The math is fp32; the decay is 2^(dt A log2 e) by ex2.approx, as in the
// forward kernel.
//
// What bounds it on an H100: per (b, t, d, n) one exponential and ~17 fp32
// operations against, per (b, t, d), one x and one dy read and one dx written
// (dt, B and C are shared by a batch row's channels). At hymba-1.5b's training
// micro-batch (B=2, S=1536, Di=3200, N=16; bf16 x, fp32 dy) that is 157 M
// exponentials and 2.7 GFLOP, 0.040 ms at the 67 TFLOP/s of fp32, against 0.08
// GB moved, 0.024 ms at 3.35 TB/s: the bound is the operations, with the
// special-function units' exponentials (16 a clock an SM) close behind. This
// first version is not near it (PERF.md): it replays the forward three times
// (four exponentials an entry and step) and its sums over channels are
// shuffles.
//
// Where it is hard:
// - dB, dC and ddt are sums over all the channels of a batch row, and dA over
//   the batch. A block takes CB channels of one batch row (32 at N <= 16): its
//   channels' sums are shuffles within a warp, then shared memory across the
//   block's 4 warps, added in order every 8 steps into one fp32 partial per
//   block (nblk x B S x (2N + 1): 40 MB at the training shape, 100 blocks a
//   row). dA is a per-entry running sum, one fp32 partial per batch row. A
//   second kernel adds the blocks' partials, then the batch rows', in a fixed
//   order: no atomics, so a run repeats bit for bit.
// - h_{t-1} runs forward and g_t backward, and e_t can be 0 in fp32, so h is
//   never rebuilt by dividing by it. The block replays the forward from h0 and
//   writes its channels' h at every kChunk = 32 steps (B ceil(S/32) Di N fp32:
//   20 MB at the training shape); then, chunk by chunk from the last, it
//   replays the chunk from its checkpoint keeping h every kSub = 8 steps, and
//   for each sub-chunk from the last replays its 8 states into registers and
//   walks them back.
// - A channel's state is split over NT/4 lanes, 4 entries each (4 lanes at N
//   <= 16, as in the forward), so every thread keeps the same 4 x 8 states of
//   a sub-chunk in registers whatever N is.
// - A chunk's x, dy (the block's channels), dt, B and C are staged in shared
//   memory by plain loads, widened to fp32; steps past S read as neutral (dt
//   = 0, so e = 1, and x, dy, B, C = 0), channels past Di and columns past N as
//   zero, so the loops run over a compile-time width NT with no bounds checks.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;   // steps staged a pass; a checkpoint every kChunk steps
constexpr int kSub = 8;      // steps whose states a thread keeps in registers
constexpr int kCols = 4;     // state entries a thread keeps, of one channel
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <int NT>
__host__ __device__ constexpr int lanes_per_channel() {   // 4, 8, 16
  return NT / kCols;
}

template <int NT>
__host__ __device__ constexpr int block_channels() {       // 32, 16, 8
  return kThreads / lanes_per_channel<NT>();
}

template <int NT>
struct __align__(16) Smem {
  static constexpr int CB = block_channels<NT>();
  float x[kChunk][CB], dy[kChunk][CB], dx[kChunk][CB];
  float b[kChunk][NT], c[kChunk][NT];
  float dt[kChunk];
  float red[kSub][kWarps][2 * NT + 1];   // a warp's sums over its channels: dB, dC, ddt
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Steps [t0, t0 + rows) of batch row b: x (and dy with grads) of the block's
// channels, dt, B (and C with grads).
template <typename T, int NT>
__device__ __forceinline__ void stage(Smem<NT>& sm, const T* __restrict__ x,
                                      const T* __restrict__ dt, const T* __restrict__ bm,
                                      const T* __restrict__ cm, const float* __restrict__ dy,
                                      int64_t row0, int rows, int d0, int d_inner, int n,
                                      bool grads) {
  constexpr int CB = block_channels<NT>();
  for (int p = threadIdx.x; p < kChunk * CB; p += kThreads) {
    const int s = p / CB, cc = p % CB, d = d0 + cc;
    const bool ok = s < rows && d < d_inner;
    const int64_t off = (row0 + s) * d_inner + d;
    sm.x[s][cc] = ok ? Elem<T>::to_float(x[off]) : 0.f;
    if (grads) sm.dy[s][cc] = ok ? dy[off] : 0.f;
  }
  for (int p = threadIdx.x; p < kChunk * NT; p += kThreads) {
    const int s = p / NT, j = p % NT;
    const bool ok = s < rows && j < n;
    const int64_t off = (row0 + s) * n + j;
    sm.b[s][j] = ok ? Elem<T>::to_float(bm[off]) : 0.f;
    if (grads) sm.c[s][j] = ok ? Elem<T>::to_float(cm[off]) : 0.f;
  }
  for (int s = threadIdx.x; s < kChunk; s += kThreads) {
    sm.dt[s] = s < rows ? Elem<T>::to_float(dt[row0 + s]) : 0.f;
  }
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

__device__ __forceinline__ void store4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

// h <- e_s (.) h + dt_s x_s B_s on the thread's 4 entries of channel cl.
template <int NT>
__device__ __forceinline__ void advance(const Smem<NT>& sm, int s, int cl, int n0,
                                        const float* a2, float* h) {
  float bb[kCols];
  load4(&sm.b[s][n0], bb);
  const float dtt = sm.dt[s], dx = dtt * sm.x[s][cl];
#pragma unroll
  for (int e = 0; e < kCols; ++e) h[e] = fmaf(ex2(dtt * a2[e]), h[e], dx * bb[e]);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ a,
                    const float* __restrict__ h0, const float* __restrict__ dy,
                    const float* __restrict__ dh_t, float* __restrict__ ckpt,
                    T* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ part,
                    float* __restrict__ da_part, int batch, int seq, int d_inner, int n) {
  constexpr int L = lanes_per_channel<NT>();
  constexpr int CB = block_channels<NT>();
  __shared__ Smem<NT> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / L, gl = tid % L, n0 = gl * kCols;
  const int blk = blockIdx.x, b = blockIdx.y;
  const int d0 = blk * CB, d = d0 + cl;
  const int nblk = gridDim.x;
  const int d_pad = nblk * CB;
  const bool ch_ok = d < d_inner;
  const int chunks = (seq + kChunk - 1) / kChunk;
  const int64_t row0 = static_cast<int64_t>(b) * seq;

  float av[kCols], a2[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = n0 + e;
    av[e] = (ch_ok && j < n) ? a[static_cast<int64_t>(d) * n + j] : 0.f;
    a2[e] = av[e] * kLog2e;
  }

  // Phase 1: replay the forward from h0, writing the block's h at every chunk
  // boundary.
  float h[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = n0 + e;
    h[e] = (ch_ok && j < n) ? h0[(static_cast<int64_t>(b) * d_inner + d) * n + j] : 0.f;
  }
  float* ck = ckpt + (static_cast<int64_t>(b) * chunks * d_pad + d) * NT + n0;
  for (int c = 0; c < chunks; ++c) {
    store4(ck + static_cast<int64_t>(c) * d_pad * NT, h);
    if (c + 1 == chunks) break;
    __syncthreads();
    stage<T, NT>(sm, x, dt, bm, cm, dy, row0 + c * kChunk, kChunk, d0, d_inner, n, false);
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) advance<NT>(sm, s, cl, n0, a2, h);
  }

  // Phase 2: the reverse walk, chunk by chunk from the last.
  float q[kCols], da_acc[kCols];   // q: e_{t+1} (.) g_{t+1}
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = n0 + e;
    q[e] = (dh_t != nullptr && ch_ok && j < n)
               ? dh_t[(static_cast<int64_t>(b) * d_inner + d) * n + j] : 0.f;
    da_acc[e] = 0.f;
  }
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int rows = min(kChunk, seq - t0);
    __syncthreads();   // the last chunk's dx tile is out
    stage<T, NT>(sm, x, dt, bm, cm, dy, row0 + t0, rows, d0, d_inner, n, true);
    __syncthreads();

    load4(ck + static_cast<int64_t>(c) * d_pad * NT, h);
    float subs[kChunk / kSub][kCols];
#pragma unroll
    for (int sq = 0; sq < kChunk / kSub; ++sq) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) subs[sq][e] = h[e];
      if (sq + 1 < kChunk / kSub) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) advance<NT>(sm, sq * kSub + s, cl, n0, a2, h);
      }
    }
#pragma unroll
    for (int qq = 0; qq < kChunk / kSub; ++qq) {
      const int sq = kChunk / kSub - 1 - qq;
      float hp[kSub][kCols];   // h_{t-1} of the sub-chunk's steps
#pragma unroll
      for (int e = 0; e < kCols; ++e) hp[0][e] = subs[sq][e];
#pragma unroll
      for (int s = 1; s < kSub; ++s) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) hp[s][e] = hp[s - 1][e];
        advance<NT>(sm, sq * kSub + s - 1, cl, n0, a2, hp[s]);
      }
#pragma unroll
      for (int ss = 0; ss < kSub; ++ss) {
        const int s = kSub - 1 - ss, sl = sq * kSub + s;
        float bb[kCols], cc[kCols], cb[kCols], cc_out[kCols];
        load4(&sm.b[sl][n0], bb);
        load4(&sm.c[sl][n0], cc);
        const float xx = sm.x[sl][cl], dyd = sm.dy[sl][cl], dtt = sm.dt[sl];
        const float dxt = dtt * xx;
        float a_dx = 0.f, a_dt = 0.f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float dec = ex2(dtt * a2[e]);
          const float dh = dec * hp[s][e];              // e_t h_{t-1}
          const float ht = fmaf(dxt, bb[e], dh);        // h_t
          const float gg = fmaf(dyd, cc[e], q[e]);      // g_t
          a_dx = fmaf(gg, bb[e], a_dx);
          cb[e] = gg * dxt;
          cc_out[e] = dyd * ht;
          a_dt = fmaf(gg, fmaf(av[e], dh, xx * bb[e]), a_dt);
          da_acc[e] = fmaf(gg * dtt, dh, da_acc[e]);
          q[e] = dec * gg;
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) a_dx += __shfl_xor_sync(kFull, a_dx, off);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a_dt += __shfl_xor_sync(kFull, a_dt, off);
#pragma unroll
        for (int off = L; off < 32; off <<= 1) {   // over the warp's channels
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            cb[e] += __shfl_xor_sync(kFull, cb[e], off);
            cc_out[e] += __shfl_xor_sync(kFull, cc_out[e], off);
          }
        }
        if (gl == 0) sm.dx[sl][cl] = dtt * a_dx;
        if (lane < L) {
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            sm.red[s][warp][n0 + e] = cb[e];
            sm.red[s][warp][NT + n0 + e] = cc_out[e];
          }
        }
        if (lane == 0) sm.red[s][warp][2 * NT] = a_dt;
      }
      __syncthreads();   // the sub-chunk's warp sums are in
      for (int p = tid; p < kSub * (2 * NT + 1); p += kThreads) {
        const int s = p / (2 * NT + 1), idx = p % (2 * NT + 1);
        const int t = t0 + sq * kSub + s;
        const int col = idx < NT ? idx : idx < 2 * NT ? idx - NT : 0;
        if (t < seq && (idx == 2 * NT || col < n)) {
          float acc = 0.f;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) acc += sm.red[s][wp][idx];
          const int out = idx < NT ? idx : idx < 2 * NT ? n + idx - NT : 2 * n;
          part[((static_cast<int64_t>(blk) * batch + b) * seq + t) * (2 * n + 1) + out] = acc;
        }
      }
      __syncthreads();   // red is free again
    }
    for (int p = tid; p < rows * CB; p += kThreads) {
      const int s = p / CB, cc = p % CB;
      if (d0 + cc < d_inner) {
        dx[(row0 + t0 + s) * d_inner + d0 + cc] = Elem<T>::from_float(sm.dx[s][cc]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = n0 + e;
    if (ch_ok && j < n) {
      const int64_t off = (static_cast<int64_t>(b) * d_inner + d) * n + j;
      dh0[off] = q[e];
      da_part[off] = da_acc[e];
    }
  }
}

// dB, dC, ddt = the blocks' partials added in block order; dA = the batch
// rows' partials added in batch order.
template <typename T>
__global__ void ssm_bwd_combine_kernel(const float* __restrict__ part,
                                       const float* __restrict__ da_part, T* __restrict__ ddt,
                                       T* __restrict__ db, T* __restrict__ dc,
                                       float* __restrict__ da, int nblk, int64_t rows, int n,
                                       int batch, int64_t dn) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = rows * (2 * n + 1);
  if (idx < total) {
    float acc = 0.f;
    for (int p = 0; p < nblk; ++p) acc += part[p * total + idx];
    const int64_t row = idx / (2 * n + 1);
    const int col = static_cast<int>(idx % (2 * n + 1));
    if (col < n) {
      db[row * n + col] = Elem<T>::from_float(acc);
    } else if (col < 2 * n) {
      dc[row * n + col - n] = Elem<T>::from_float(acc);
    } else {
      ddt[row] = Elem<T>::from_float(acc);
    }
  } else if (idx < total + dn) {
    const int64_t e = idx - total;
    float acc = 0.f;
    for (int bb = 0; bb < batch; ++bb) acc += da_part[bb * dn + e];
    da[e] = acc;
  }
}

template <typename T, int NT>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const float* a,
           const float* h0, const float* dy, const float* dh_t, float* ckpt, void* dx,
           void* ddt, void* db, void* dc, float* da, float* dh0, float* part, float* da_part,
           int batch, int seq, int d_inner, int n, cudaStream_t st) {
  constexpr int CB = block_channels<NT>();
  const int nblk = (d_inner + CB - 1) / CB;
  ssm_scan_bwd_kernel<T, NT><<<dim3(nblk, batch), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), a, h0, dy, dh_t, ckpt, static_cast<T*>(dx), dh0, part,
      da_part, batch, seq, d_inner, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(batch) * seq;
  const int64_t dn = static_cast<int64_t>(d_inner) * n;
  const int64_t blocks = (rows * (2 * n + 1) + dn + 255) / 256;
  ssm_bwd_combine_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      part, da_part, static_cast<T*>(ddt), static_cast<T*>(db), static_cast<T*>(dc), da, nblk,
      rows, n, batch, dn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(int width, const void* x, const void* dt, const void* bm, const void* cm,
                   const float* a, const float* h0, const float* dy, const float* dh_t,
                   float* ckpt, void* dx, void* ddt, void* db, void* dc, float* da, float* dh0,
                   float* part, float* da_part, int batch, int seq, int d_inner, int n,
                   cudaStream_t st) {
  if (width == 16) {
    return launch<T, 16>(x, dt, bm, cm, a, h0, dy, dh_t, ckpt, dx, ddt, db, dc, da, dh0, part,
                         da_part, batch, seq, d_inner, n, st);
  }
  if (width == 32) {
    return launch<T, 32>(x, dt, bm, cm, a, h0, dy, dh_t, ckpt, dx, ddt, db, dc, da, dh0, part,
                         da_part, batch, seq, d_inner, n, st);
  }
  if (width == 64) {
    return launch<T, 64>(x, dt, bm, cm, a, h0, dy, dh_t, ckpt, dx, ddt, db, dc, da, dh0, part,
                         da_part, batch, seq, d_inner, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The channels of a block at a width (0 for a width the kernel does not build).
inline int expected_split(int width) {
  return width == 16 ? block_channels<16>() : width == 32 ? block_channels<32>()
         : width == 64 ? block_channels<64>() : 0;
}

}  // namespace
}  // namespace repro_torch

// x, dx: (batch, seq, d_inner); dt, ddt: (batch, seq, 1); bm, cm, db, dc: (batch,
// seq, n); all dense, of dtype (0 fp32, 1 bf16). dy: (batch, seq, d_inner) fp32;
// a, da: (d_inner, n) fp32; h0, dh_t, dh0: (batch, d_inner, n) fp32, dh_t may be
// null (zero). Scratch, fp32: ckpt (batch, ceil(seq / 32), d_inner padded to
// the block's channels, width); part (blocks, batch, seq, 2 n + 1); da_part
// (batch, d_inner, n). 1 <= n <= width (16, 32 or 64), seq >= 1, batch <=
// 65535. chunk and split are the caller's copy of the launch's geometry, which
// it sized the scratch from: kChunk and the block's channels at this width, or
// the call is refused before anything is written. Launches the backward and the
// kernel that adds its partials; returns the CUDA error of the launches (0 when
// they were accepted).
extern "C" int ssm_scan_bwd(int dtype, int width, const void* x, const void* dt, const void* bm,
                            const void* cm, const void* a, const void* h0, const void* dy,
                            const void* dh_t, void* ckpt, void* dx, void* ddt, void* db,
                            void* dc, void* da, void* dh0, void* part, void* da_part, int batch,
                            int seq, int d_inner, int n, int chunk, int split,
                            void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || seq < 1 || d_inner < 1 || n < 1 || n > width ||
      chunk != kChunk || split != expected_split(width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  const float* dyp = static_cast<const float*>(dy);
  const float* dhp = static_cast<const float*>(dh_t);
  float* ckp = static_cast<float*>(ckpt);
  float* dap = static_cast<float*>(da);
  float* dh0p = static_cast<float*>(dh0);
  float* pp = static_cast<float*>(part);
  float* dapp = static_cast<float*>(da_part);
  if (dtype == kFloat32) {
    return dispatch_width<float>(width, x, dt, bm, cm, ap, h0p, dyp, dhp, ckp, dx, ddt, db, dc,
                                 dap, dh0p, pp, dapp, batch, seq, d_inner, n, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_width<bf16>(width, x, dt, bm, cm, ap, h0p, dyp, dhp, ckp, dx, ddt, db, dc,
                                dap, dh0p, pp, dapp, batch, seq, d_inner, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
