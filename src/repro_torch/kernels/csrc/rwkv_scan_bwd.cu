// The backward of the RWKV6 recurrence for Hopper, sm_90a, with a plain C entry
// point for ctypes.
//
// Replaces: no TPU kernel. The JAX package has no backward kernel for its scan:
// it differentiates the jnp recurrence (src/repro/models/ssm.py,
// _rwkv_recurrence) by autodiff. On the card the port's plain version of that
// backward is a Python loop over time that takes seconds a layer, so the
// training path needs a kernel of its own, as the flash backward was added.
// For each (batch b, head h), with S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}), it takes dy (B, S, H, N) and dS_T
// (B, H, N, N, absent = zero) and returns dr, dk, dv, dw in the inputs' type,
// du (H, N) and ds0 (B, H, N, N) in fp32. G_t, the whole adjoint of S_t,
// walks back from dS_T as G_{t-1} = diag(w_t) G_t + r_t dy_t^T, and
//   dr_t = (S_{t-1} + u (.) k_t v_t^T) dy_t,      dw_t = rowsum(G_t (.) S_{t-1}),
//   dk_t = (G_t + u (.) r_t dy_t^T) v_t,          dv_t = (G_t + u (.) r_t dy_t^T)^T k_t,
//   du = sum_{b,t} r_t (.) k_t (v_t . dy_t),      ds0 = G_0.
// The math is fp32 whatever the inputs' type.
//
// What bounds it on an H100: the function needs, per (b, t, h), 12 N^2 fp32
// operations (an FMA counted as 2: the forward state once more, G's update,
// G v, G^T k, rowsum(G (.) S) and S dy) and O(N) for the u terms, against 5 N
// inputs read and 4 N outputs written. At rwkv6-7b's training micro-batch
// (B=2, S=1024, H=64, N=64, fp32) the 6.4 GFLOP take 0.097 ms at the 67
// TFLOP/s of fp32 outside the tensor cores, and the 0.31 GB moved 0.091 ms at
// 3.35 TB/s: the bound is the fp32 issue. This kernel does 16 N^2 (8.6
// GFLOP): its bracket G + u (.) r dy^T, formed once for dk and dv, and the
// u k v^T it folds into dr's product are N^2 each where the function's own
// formulas are O(N). This first version is far from the bound (PERF.md): it
// replays the forward three times, and its row sums are shuffles.
//
// Where it is hard: dw_t needs S_{t-1} and G_t at the same t, and one runs
// forward in time, the other backward. S_{t-1} is never rebuilt by dividing by
// w_t (decays reach 0). Instead:
// - A state entry S[i, j] depends only on S[i, j] (and G[i, j] only on G[i, j]),
//   so the rows split freely: a block takes a band of RB rows of one (b, h),
//   all N columns, and its thread (row i, column group) keeps 8 columns of S
//   and G in registers. Grid: (B H) x (N / RB) blocks of 128 threads (32 at
//   N = 16).
// - Checkpoints: the block first replays the forward from s0 and writes its
//   rows of S at every kChunk = 32 steps to a scratch buffer (B H ceil(S/32)
//   N^2 fp32: 64 MB at the training shape). Then, chunk by chunk from the
//   last, it replays the chunk from its checkpoint keeping S every kSub = 8
//   steps (registers), and for each sub-chunk from the last it replays the 8
//   states S_{t-1} into registers and walks them back. No state is stored
//   twice and nothing is divided.
// - The row sums (dr, dk, dw) are the thread's 8 columns, then xor shuffles
//   over the N/8 lanes of the row. The column sum of dv crosses the band's
//   rows: each step's bracket times k goes to shared memory, and every 8
//   steps the block adds each column over its rows, in order, into an fp32
//   partial per band. du is a per-row running sum, one fp32 partial per batch
//   row. A second kernel adds the bands' dv partials and the batch rows' du
//   partials in a fixed order: no atomics anywhere, so a run repeats bit for
//   bit.
// - A chunk's r, k, w (the band's rows) and v, dy (all columns) are staged in
//   shared memory by plain loads, widened to fp32; steps past S read as
//   neutral (w = 1, the rest 0), columns and rows past N as zero, so the loops
//   run over a compile-time width NT (16, 32 or 64) with no bounds checks.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;    // steps staged a pass; a checkpoint every kChunk steps
constexpr int kSub = 8;       // steps whose states a thread keeps in registers
constexpr int kCols = 8;      // state columns a thread keeps, of one row
constexpr unsigned kFull = 0xffffffffu;

template <int NT>
__host__ __device__ constexpr int lanes_per_row() {
  return NT / kCols;
}

template <int NT>
__host__ __device__ constexpr int threads_for() {
  return lanes_per_row<NT>() * NT < 128 ? lanes_per_row<NT>() * NT : 128;
}

template <int NT>
__host__ __device__ constexpr int band_rows() {   // rows a block takes: 16, 32, 16
  return threads_for<NT>() / lanes_per_row<NT>();
}

template <int NT>
struct __align__(16) Smem {
  static constexpr int RB = band_rows<NT>();
  float r[kChunk][RB], k[kChunk][RB], w[kChunk][RB];
  float v[kChunk][NT], dy[kChunk][NT];
  float dr[kChunk][RB], dk[kChunk][RB], dw[kChunk][RB];
  float pdv[kSub][RB][NT];   // a sub-chunk's bracket x k, per row and column
  float vdy[kChunk];
};

// Steps [t0, t0 + rows) of one (b, h) into shared memory: k and w of the band's
// rows (and r with grads), v (and dy with grads) of every column.
template <typename T, int NT>
__device__ __forceinline__ void stage(Smem<NT>& sm, const T* __restrict__ r,
                                      const T* __restrict__ k, const T* __restrict__ v,
                                      const T* __restrict__ w, const T* __restrict__ dy,
                                      int64_t base, int64_t row_stride, int rows, int n, int i0,
                                      bool grads) {
  constexpr int kThreads = threads_for<NT>();
  constexpr int RB = band_rows<NT>();
  for (int p = threadIdx.x; p < kChunk * RB; p += kThreads) {
    const int s = p / RB, ii = p % RB, i = i0 + ii;
    const bool ok = s < rows && i < n;
    const int64_t off = base + s * row_stride + i;
    sm.k[s][ii] = ok ? Elem<T>::to_float(k[off]) : 0.f;
    sm.w[s][ii] = ok ? Elem<T>::to_float(w[off]) : 1.f;
    if (grads) sm.r[s][ii] = ok ? Elem<T>::to_float(r[off]) : 0.f;
  }
  for (int p = threadIdx.x; p < kChunk * NT; p += kThreads) {
    const int s = p / NT, j = p % NT;
    const bool ok = s < rows && j < n;
    const int64_t off = base + s * row_stride + j;
    sm.v[s][j] = ok ? Elem<T>::to_float(v[off]) : 0.f;
    if (grads) sm.dy[s][j] = ok ? Elem<T>::to_float(dy[off]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* in) {
  reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

// S <- diag(w_s) S + k_s v_s^T on the thread's 8 columns of row rho.
template <int NT>
__device__ __forceinline__ void advance(const Smem<NT>& sm, int s, int rho, int j0, float* st) {
  float vv[kCols];
  load8(&sm.v[s][j0], vv);
  const float kk = sm.k[s][rho], ww = sm.w[s][rho];
#pragma unroll
  for (int e = 0; e < kCols; ++e) st[e] = fmaf(ww, st[e], kk * vv[e]);
}

template <typename T, int NT>
__global__ void __launch_bounds__(threads_for<NT>())
rwkv_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ w, const float* __restrict__ u,
                     const float* __restrict__ s0, const T* __restrict__ dy,
                     const float* __restrict__ ds_t, float* __restrict__ ckpt,
                     T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dw,
                     float* __restrict__ ds0, float* __restrict__ dv_part,
                     float* __restrict__ du_part, int batch, int seq, int heads, int n) {
  constexpr int kThreads = threads_for<NT>();
  constexpr int LPR = lanes_per_row<NT>();
  constexpr int RB = band_rows<NT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<NT>*>(smem_raw);
  const int tid = threadIdx.x;
  const int rho = tid / LPR, gam = tid % LPR, j0 = gam * kCols;
  const int bh = blockIdx.x, band = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int i0 = band * RB, i = i0 + rho;
  const bool row_ok = i < n;
  const int chunks = (seq + kChunk - 1) / kChunk;
  const int64_t row_stride = static_cast<int64_t>(heads) * n;
  const int64_t base = (static_cast<int64_t>(b) * seq * heads + h) * n;
  const float ui = row_ok ? u[h * n + i] : 0.f;

  // Phase 1: replay the forward from s0, writing the band's rows of S at every
  // chunk boundary.
  float st[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = j0 + e;
    st[e] = (row_ok && j < n) ? s0[(static_cast<int64_t>(bh) * n + i) * n + j] : 0.f;
  }
  float* ck = ckpt + (static_cast<int64_t>(bh) * chunks * NT + i) * NT + j0;
  for (int c = 0; c < chunks; ++c) {
    store8(ck + static_cast<int64_t>(c) * NT * NT, st);
    if (c + 1 == chunks) break;
    __syncthreads();
    stage<T, NT>(sm, r, k, v, w, dy, base + c * kChunk * row_stride, row_stride, kChunk, n,
                 i0, false);
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) advance<NT>(sm, s, rho, j0, st);
  }

  // Phase 2: the reverse walk, chunk by chunk from the last.
  float g[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = j0 + e;
    g[e] = (ds_t != nullptr && row_ok && j < n)
               ? ds_t[(static_cast<int64_t>(bh) * n + i) * n + j] : 0.f;
  }
  float du_acc = 0.f;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int rows = min(kChunk, seq - t0);
    __syncthreads();   // the last chunk's tiles are out
    stage<T, NT>(sm, r, k, v, w, dy, base + t0 * row_stride, row_stride, rows, n, i0, true);
    __syncthreads();
    for (int s = tid; s < kChunk; s += kThreads) {   // v_t . dy_t, rotated to spread banks
      float acc = 0.f;
      for (int jj = 0; jj < NT; ++jj) {
        const int j = (jj + s) & (NT - 1);
        acc = fmaf(sm.v[s][j], sm.dy[s][j], acc);
      }
      sm.vdy[s] = acc;
    }
    __syncthreads();

    load8(ck + static_cast<int64_t>(c) * NT * NT, st);
    float subs[kChunk / kSub][kCols];
#pragma unroll
    for (int q = 0; q < kChunk / kSub; ++q) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) subs[q][e] = st[e];
      if (q + 1 < kChunk / kSub) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) advance<NT>(sm, q * kSub + s, rho, j0, st);
      }
    }
#pragma unroll
    for (int qq = 0; qq < kChunk / kSub; ++qq) {
      const int q = kChunk / kSub - 1 - qq;
      float sp[kSub][kCols];   // S_{t-1} of the sub-chunk's steps
#pragma unroll
      for (int e = 0; e < kCols; ++e) sp[0][e] = subs[q][e];
#pragma unroll
      for (int s = 1; s < kSub; ++s) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) sp[s][e] = sp[s - 1][e];
        advance<NT>(sm, q * kSub + s - 1, rho, j0, sp[s]);
      }
#pragma unroll
      for (int ss = 0; ss < kSub; ++ss) {
        const int s = kSub - 1 - ss, sl = q * kSub + s;
        float vv[kCols], dd[kCols], pv[kCols];
        load8(&sm.v[sl][j0], vv);
        load8(&sm.dy[sl][j0], dd);
        const float rr = sm.r[sl][rho], kk = sm.k[sl][rho], ww = sm.w[sl][rho];
        const float ur = ui * rr, uk = ui * kk;
        float a_dk = 0.f, a_dw = 0.f, a_dr = 0.f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float br = fmaf(ur, dd[e], g[e]);   // G_t + u r_t dy_t^T
          a_dk = fmaf(vv[e], br, a_dk);
          pv[e] = kk * br;
          a_dw = fmaf(g[e], sp[s][e], a_dw);
          a_dr = fmaf(dd[e], fmaf(uk, vv[e], sp[s][e]), a_dr);
          g[e] = fmaf(ww, g[e], rr * dd[e]);        // G_{t-1}
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
          a_dk += __shfl_xor_sync(kFull, a_dk, off);
          a_dw += __shfl_xor_sync(kFull, a_dw, off);
          a_dr += __shfl_xor_sync(kFull, a_dr, off);
        }
        if (gam == 0) {
          sm.dr[sl][rho] = a_dr;
          sm.dk[sl][rho] = a_dk;
          sm.dw[sl][rho] = a_dw;
          du_acc = fmaf(rr * kk, sm.vdy[sl], du_acc);
        }
        store8(&sm.pdv[s][rho][j0], pv);
      }
      __syncthreads();   // the sub-chunk's brackets are in
      for (int p = tid; p < kSub * NT; p += kThreads) {
        const int s = p / NT, j = p % NT, t = t0 + q * kSub + s;
        if (t < seq && j < n) {
          float acc = 0.f;
#pragma unroll 4
          for (int rr = 0; rr < RB; ++rr) acc += sm.pdv[s][rr][j];
          dv_part[(((static_cast<int64_t>(band) * batch + b) * seq + t) * heads + h) * n + j] =
              acc;
        }
      }
      __syncthreads();   // pdv is free again
    }
    for (int p = tid; p < rows * RB; p += kThreads) {
      const int s = p / RB, ii = p % RB;
      if (i0 + ii < n) {
        const int64_t off = base + (t0 + s) * row_stride + i0 + ii;
        dr[off] = Elem<T>::from_float(sm.dr[s][ii]);
        dk[off] = Elem<T>::from_float(sm.dk[s][ii]);
        dw[off] = Elem<T>::from_float(sm.dw[s][ii]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = j0 + e;
    if (row_ok && j < n) ds0[(static_cast<int64_t>(bh) * n + i) * n + j] = g[e];
  }
  if (gam == 0 && row_ok) du_part[static_cast<int64_t>(bh) * n + i] = du_acc;
}

// dv = the bands' partials added in band order; du = the batch rows' partials
// added in batch order.
template <typename T>
__global__ void rwkv_bwd_combine_kernel(const float* __restrict__ dv_part,
                                        const float* __restrict__ du_part, T* __restrict__ dv,
                                        float* __restrict__ du, int64_t total, int bands,
                                        int batch, int hn) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < total) {
    float acc = 0.f;
    for (int p = 0; p < bands; ++p) acc += dv_part[p * total + idx];
    dv[idx] = Elem<T>::from_float(acc);
  } else if (idx < total + hn) {
    const int e = static_cast<int>(idx - total);
    float acc = 0.f;
    for (int bb = 0; bb < batch; ++bb) acc += du_part[static_cast<int64_t>(bb) * hn + e];
    du[e] = acc;
  }
}

// The kernel's shared memory (~62 KB at N = 64) is dynamic; the attribute that
// allows more than 48 KB is set once, at the first launch.
template <typename T, int NT>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, const void* dy, const float* ds_t, float* ckpt, void* dr, void* dk,
           void* dv, void* dw, float* du, float* ds0, float* dv_part, float* du_part, int batch,
           int seq, int heads, int n, cudaStream_t st) {
  constexpr int smem = sizeof(Smem<NT>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv_scan_bwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(batch * heads, NT / band_rows<NT>());
  rwkv_scan_bwd_kernel<T, NT><<<grid, threads_for<NT>(), smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s0, static_cast<const T*>(dy), ds_t, ckpt,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dw), ds0, dv_part, du_part,
      batch, seq, heads, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(batch) * seq * heads * n;
  const int hn = heads * n;
  const int64_t blocks = (total + hn + 255) / 256;
  rwkv_bwd_combine_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      dv_part, du_part, static_cast<T*>(dv), du, total, NT / band_rows<NT>(), batch, hn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(int width, const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* s0, const void* dy, const float* ds_t,
                   float* ckpt, void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
                   float* dv_part, float* du_part, int batch, int seq, int heads, int n,
                   cudaStream_t st) {
  if (width == 16) {
    return launch<T, 16>(r, k, v, w, u, s0, dy, ds_t, ckpt, dr, dk, dv, dw, du, ds0, dv_part,
                         du_part, batch, seq, heads, n, st);
  }
  if (width == 32) {
    return launch<T, 32>(r, k, v, w, u, s0, dy, ds_t, ckpt, dr, dk, dv, dw, du, ds0, dv_part,
                         du_part, batch, seq, heads, n, st);
  }
  if (width == 64) {
    return launch<T, 64>(r, k, v, w, u, s0, dy, ds_t, ckpt, dr, dk, dv, dw, du, ds0, dv_part,
                         du_part, batch, seq, heads, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The rows of a block's band at a width (0 for a width the kernel does not
// build).
inline int expected_split(int width) {
  return width == 16 ? band_rows<16>() : width == 32 ? band_rows<32>()
         : width == 64 ? band_rows<64>() : 0;
}

}  // namespace
}  // namespace repro_torch

// r, k, v, w, dy, dr, dk, dv, dw: (batch, seq, heads, n), dense, of dtype (0
// fp32, 1 bf16); u, du: (heads, n) fp32; s0, ds_t, ds0: (batch, heads, n, n)
// fp32, dense, ds_t may be null (zero). Scratch, fp32: ckpt (batch heads,
// ceil(seq / 32), width, width); dv_part (width / band rows, batch, seq, heads,
// n); du_part (batch, heads, n). 1 <= n <= width (16, 32 or 64), seq >= 1.
// chunk and split are the caller's copy of the launch's geometry, which it
// sized the scratch from: kChunk and the band rows at this width, or the call
// is refused before anything is written. Launches the backward and the kernel
// that adds its partials; returns the CUDA error of the launches (0 when they
// were accepted).
extern "C" int rwkv_scan_bwd(int dtype, int width, const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0, const void* dy,
                             const void* ds_t, void* ckpt, void* dr, void* dk, void* dv,
                             void* dw, void* du, void* ds0, void* dv_part, void* du_part,
                             int batch, int seq, int heads, int n, int chunk, int split,
                             void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seq < 1 || heads < 1 || n < 1 || n > width || chunk != kChunk ||
      split != expected_split(width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  const float* dsp = static_cast<const float*>(ds_t);
  float* ckp = static_cast<float*>(ckpt);
  float* dup = static_cast<float*>(du);
  float* ds0p = static_cast<float*>(ds0);
  float* dvp = static_cast<float*>(dv_part);
  float* dupp = static_cast<float*>(du_part);
  if (dtype == kFloat32) {
    return dispatch_width<float>(width, r, k, v, w, up, s0p, dy, dsp, ckp, dr, dk, dv, dw, dup,
                                 ds0p, dvp, dupp, batch, seq, heads, n, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_width<bf16>(width, r, k, v, w, up, s0p, dy, dsp, ckp, dr, dk, dv, dw, dup,
                                ds0p, dvp, dupp, batch, seq, heads, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
