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
//   dr_t = S_{t-1} dy_t + u (.) k_t (v_t . dy_t),   dw_t = rowsum(G_t (.) S_{t-1}),
//   dk_t = G_t v_t + u (.) r_t (v_t . dy_t),        dv_t = G_t^T k_t + dy_t sum_i r u k,
//   du = sum_{b,t} r_t (.) k_t (v_t . dy_t),        ds0 = G_0.
// The math is fp32 whatever the inputs' type.
//
// What bounds it on an H100: the function needs, per (b, t, h), 12 N^2 + 14 N
// fp32 operations (an FMA counted as 2: the forward state once more, G's
// update, G v, G^T k, rowsum(G (.) S) and S dy, each 2 N^2; the u terms by
// their O(N) formulas) against 5 N inputs read and 4 N outputs written. At
// rwkv6-7b's training micro-batch (B=2, S=1024, H=64, N=64, fp32) the 6.6
// GFLOP take 0.098 ms at the 67 TFLOP/s of fp32 outside the tensor cores, and
// the 0.31 GB 0.091 ms at 3.35 TB/s: the bound is the fp32 issue.
//
// The design: both recurrences are diagonal and linear, so a chunk of kChunk
// = 32 steps crosses them affinely: the state at its end is P (.) (the state
// at its start) + L, and the adjoint before it is P (.) (the adjoint after it)
// + M, with P = prod_t w_t per row, L the chunk run forward from a zero state
// and M the adjoint walked back over it from zero. Nothing is divided: a decay
// of 0 makes P = 0, which is exactly right. So the chunks run in parallel over
// time, in three launches, each deterministic (no atomics: a run repeats bit
// for bit):
// 1. Local: one block a (b, h, chunk). L = sum_t (a_t (.) k_t) v_t^T and
//    M = sum_t (b_t (.) r_t) dy_t^T, with a_t and b_t the rows' products of
//    the decays after and before step t (products, never quotients), are two
//    sums over the chunk's steps that need no step before them, so each
//    thread accumulates a 4 x 8 tile of one of them (32 FMAs for 12 values
//    read from shared memory) where the recurrence would read 10 for 8. It
//    writes P, L and M (scratch: 2 B H ceil(S/32) N^2 fp32, 134 MB at the
//    training shape).
// 2. Carry: four state entries a thread and a direction, serially over the
//    chunks: the true state at each chunk's start from s0 written over L, and
//    the true adjoint at each chunk's end from dS_T written over M (streaming
//    stores); the last gives ds0. A copy's worth of traffic (268 MB).
// 3. Walk: one block a (b, h, chunk) of N^2/8 threads (512 at N = 64), all N
//    rows of the head, so dv's sums over the rows end inside the block; each
//    thread keeps 8 columns of one row of S and G in registers. It replays the
//    chunk from its true start, keeping S at every kSub = 8 steps in shared
//    memory; then, sub-chunk by sub-chunk from the last, it replays the 8
//    states S_{t-1} into registers and walks G back over them from the
//    chunk's true end. Each step reads v_t and dy_t once for dr (S dy), dk
//    (G v), dw (G (.) S) and dv (G^T k), and updates G: 12 N^2 a step with
//    the replays, plus the u terms' O(N) formulas.
// Where the time goes on an H100 is shared memory: 4 rows of a warp read the
// same v_t and dy_t, so a thread's 8 columns are 4 at j0 and 4 at j0 + N/2
// (a warp's lanes then read 128 neighbouring bytes, no bank conflict). The
// sums come off the per-step path: each step's row partials (the thread's 8
// columns, for dr, dk, dw) go to shared memory and are added once a
// sub-chunk, in column order; dv's column sums over the warp's 4 rows are a
// reduce-scatter (each level keeps half the columns), then shared memory,
// added over the warps in order once a sub-chunk. du is one partial per (b,
// chunk), and a last launch adds them in batch order, then chunk order.
// A chunk's r, k, w, v and dy are staged in shared memory by plain loads,
// widened to fp32; steps past S read as neutral (w = 1, the rest 0), rows and
// columns past N as zero, so the loops run over a compile-time width NT (16,
// 32 or 64) with no bounds checks. Every kernel keeps within 128 registers a
// thread, without spills.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;    // steps of a chunk: one block of the local and walk passes
constexpr int kSub = 8;       // steps whose states a thread keeps in registers
constexpr int kCols = 8;      // state columns a thread keeps, of one row
constexpr unsigned kFull = 0xffffffffu;

template <int NT>
__host__ __device__ constexpr int lanes_per_row() {   // 2, 4, 8
  return NT / kCols;
}

template <int NT>
__host__ __device__ constexpr int walk_threads() {    // 32, 128, 512: NT rows of NT / 8 lanes
  return NT * lanes_per_row<NT>();
}

// A chunk's inputs of one (b, h), widened to fp32.
template <int NT>
struct __align__(16) Tiles {
  float r[kChunk][NT], k[kChunk][NT], w[kChunk][NT], v[kChunk][NT], dy[kChunk][NT];
};

template <int NT>
struct __align__(16) WalkSmem {
  static constexpr int LPR = lanes_per_row<NT>();
  static constexpr int kThreads = walk_threads<NT>();
  Tiles<NT> in;
  float sub[kChunk / kSub][kThreads][kCols];   // S at each sub-chunk's start
  float rowp[kSub][NT][LPR];                   // dr's row partials
  float2 rowkw[kSub][NT][LPR];                 // dk's and dw's row partials
  float colp[kSub][kThreads / 32][NT];         // dv's partials over a warp's rows
  float u[NT], vdy[kChunk], ruk[kChunk];
};

// Steps [t0, t0 + rows) of one (b, h), neutral past S and past n. The loads of
// a batch of up to 8 rows a thread are all issued before the first is stored
// (r, k and w, then v and dy: five at once spill at width 16).
template <typename T, int NT, int THREADS>
__device__ __forceinline__ void stage(Tiles<NT>& sm, const T* __restrict__ r,
                                      const T* __restrict__ k, const T* __restrict__ v,
                                      const T* __restrict__ w, const T* __restrict__ dy,
                                      int64_t base, int64_t row_stride, int rows, int n) {
  constexpr int kE = kChunk * NT / THREADS;   // elements a thread stages, of each input
  constexpr int kB = kE < 8 ? kE : 8;
#pragma unroll 1
  for (int q0 = 0; q0 < kE; q0 += kB) {
    float rs[kB], ks[kB], ws[kB];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int p = threadIdx.x + (q0 + q) * THREADS, s = p / NT, j = p % NT;
      const bool ok = s < rows && j < n;
      const int64_t off = base + s * row_stride + j;
      rs[q] = ok ? Elem<T>::to_float(r[off]) : 0.f;
      ks[q] = ok ? Elem<T>::to_float(k[off]) : 0.f;
      ws[q] = ok ? Elem<T>::to_float(w[off]) : 1.f;
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int p = threadIdx.x + (q0 + q) * THREADS;
      sm.r[p / NT][p % NT] = rs[q];
      sm.k[p / NT][p % NT] = ks[q];
      sm.w[p / NT][p % NT] = ws[q];
    }
  }
#pragma unroll 1
  for (int q0 = 0; q0 < kE; q0 += kB) {
    float vs[kB], ys[kB];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int p = threadIdx.x + (q0 + q) * THREADS, s = p / NT, j = p % NT;
      const bool ok = s < rows && j < n;
      const int64_t off = base + s * row_stride + j;
      vs[q] = ok ? Elem<T>::to_float(v[off]) : 0.f;
      ys[q] = ok ? Elem<T>::to_float(dy[off]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int p = threadIdx.x + (q0 + q) * THREADS;
      sm.v[p / NT][p % NT] = vs[q];
      sm.dy[p / NT][p % NT] = ys[q];
    }
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

// The thread's 8 columns of a row: 4 from j0 and 4 from j0 + NT / 2, so the 8
// lanes of a row read 128 neighbouring bytes each time (no bank conflict).
template <int NT>
__device__ __forceinline__ void load_cols(const float* row, int j0, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(row + j0);
  const float4 b = *reinterpret_cast<const float4*>(row + j0 + NT / 2);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// S <- diag(w_s) S + k_s v_s^T on the thread's 8 columns of band row rho.
template <int NT>
__device__ __forceinline__ void advance(const Tiles<NT>& sm, int s, int rho, int j0,
                                        float* st) {
  float vv[kCols];
  load_cols<NT>(sm.v[s], j0, vv);
  const float kk = sm.k[s][rho], ww = sm.w[s][rho];
#pragma unroll
  for (int e = 0; e < kCols; ++e) st[e] = fmaf(ww, st[e], kk * vv[e]);
}

// The dot product of the thread's 8 columns, as two chains of four.
__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float lo = a[0] * b[0], hi = a[1] * b[1];
#pragma unroll
  for (int e = 2; e < kCols; e += 2) {
    lo = fmaf(a[e], b[e], lo);
    hi = fmaf(a[e + 1], b[e + 1], hi);
  }
  return lo + hi;
}

// Sums pv over the lanes that differ in bit M and above (the warp's rows of
// one column group): while CNT > 1 each level keeps half the values, the lane
// with bit M set the upper half (its columns move up by JUMP at the first
// level, where the halves are the thread's two column groups, then by CNT /
// 2); past that each level adds the one value left.
template <int M, int CNT, int JUMP>
__device__ __forceinline__ void scatter(float* pv, int lane, int& col) {
  if constexpr (M < 32) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool upper = lane & M;
#pragma unroll
      for (int e = 0; e < H; ++e) {
        const float send = upper ? pv[e] : pv[e + H];
        const float keep = upper ? pv[e + H] : pv[e];
        pv[e] = keep + __shfl_xor_sync(kFull, send, M);
      }
      if (upper) col += CNT == kCols ? JUMP : H;
      scatter<M * 2, H, JUMP>(pv, lane, col);
    } else {
      pv[0] += __shfl_xor_sync(kFull, pv[0], M);
      scatter<M * 2, 1, JUMP>(pv, lane, col);
    }
  }
}

// Blocks of `threads` that fill the register file at 128 registers a thread
// (registers go to whole warps; at most 32 blocks an SM), so a launch bound
// caps every kernel at 128.
__host__ __device__ constexpr int min_blocks(int threads) {
  return 65536 / 128 / (threads < 32 ? 32 : threads) < 32
             ? 65536 / 128 / (threads < 32 ? 32 : threads) : 32;
}

constexpr int kTileRows = 4;   // rows of a local pass thread's tile of L or M (8 columns)

template <int NT>
__host__ __device__ constexpr int local_threads() {   // 256, 64, 16: a 4 x 8 tile each
  return 2 * (NT / kTileRows) * (NT / kCols);
}

// Pass 1: per (b, h, chunk), the rows' decay product P and the chunk crossed
// from zero, as two sums over the chunk's steps that need no step before
// them: L = sum_t (a_t (.) k_t) v_t^T, a_t = prod_{tau > t} w_tau the decay
// the step still meets, and M = sum_t (b_t (.) r_t) dy_t^T, b_t =
// prod_{tau < t} w_tau the decay before it; a and b are products, never
// quotients. Each thread accumulates a 4 x 8 tile of L or of M over the steps,
// 32 FMAs for every 12 values it reads from shared memory.
template <typename T, int NT>
__global__ void __launch_bounds__(local_threads<NT>(), min_blocks(local_threads<NT>()))
rwkv_bwd_local_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ w, const T* __restrict__ dy,
                      float* __restrict__ states, float* __restrict__ decay, int seq, int heads,
                      int n, int chunks) {
  constexpr int kTiles = local_threads<NT>() / 2, kSide = NT / kCols;
  static_assert(kTileRows == 4, "a tile's rows are read as one float4");
  __shared__ Tiles<NT> sm;
  const int tid = threadIdx.x;
  // blocks run chunk by chunk, the heads of a chunk side by side (their rows
  // are neighbours in memory); the scratch is laid out (b h, chunk)
  const int bhs = gridDim.x / chunks;
  const int c = blockIdx.x / bhs, bh = blockIdx.x % bhs;
  const int64_t item = static_cast<int64_t>(bh) * chunks + c;
  const int b = bh / heads, h = bh % heads;
  const int t0 = c * kChunk;
  stage<T, NT, local_threads<NT>()>(
      sm, r, k, v, w, dy, ((static_cast<int64_t>(b) * seq + t0) * heads + h) * n,
      static_cast<int64_t>(heads) * n, min(kChunk, seq - t0), n);
  __syncthreads();
  for (int i = tid; i < NT; i += local_threads<NT>()) {   // r <- b (.) r, k <- a (.) k
    float pre = 1.f, suf = 1.f;
#pragma unroll 8
    for (int s = 0; s < kChunk; ++s) {
      sm.r[s][i] *= pre;
      pre *= sm.w[s][i];
    }
#pragma unroll 8
    for (int s = kChunk - 1; s >= 0; --s) {
      sm.k[s][i] *= suf;
      suf *= sm.w[s][i];
    }
    decay[item * NT + i] = pre;
  }
  __syncthreads();
  const bool adjoint = tid >= kTiles;
  const int tile = tid % kTiles, ti = tile / kSide, tj = tile % kSide;
  const float(*left)[NT] = adjoint ? sm.r : sm.k;
  const float(*right)[NT] = adjoint ? sm.dy : sm.v;
  float acc[kTileRows][kCols];
#pragma unroll
  for (int x = 0; x < kTileRows; ++x) {
#pragma unroll
    for (int y = 0; y < kCols; ++y) acc[x][y] = 0.f;
  }
#pragma unroll 4
  for (int s = 0; s < kChunk; ++s) {
    const float4 a4 = *reinterpret_cast<const float4*>(&left[s][ti * kTileRows]);
    const float a[kTileRows] = {a4.x, a4.y, a4.z, a4.w};
    float b8[kCols];
    load8(&right[s][tj * kCols], b8);
#pragma unroll
    for (int x = 0; x < kTileRows; ++x) {
#pragma unroll
      for (int y = 0; y < kCols; ++y) acc[x][y] = fmaf(a[x], b8[y], acc[x][y]);
    }
  }
  const int64_t cell = static_cast<int64_t>(NT) * NT;
  float* out = states + (adjoint ? static_cast<int64_t>(gridDim.x) * cell : 0) + item * cell
               + ti * kTileRows * NT + tj * kCols;
#pragma unroll
  for (int x = 0; x < kTileRows; ++x) store8(out + x * NT, acc[x]);
}

// Pass 2: per four state entries of a row, the true state at each chunk's start
// (blockIdx.y 0, from s0, over L) or the true adjoint at each chunk's end (1,
// from dS_T, over M; the last is ds0), serially over the chunks. Loads go out
// kAhead chunks at a time, 16 bytes each; the stores stream (the walk reads
// them long after, so they need not stay in L2).
template <int NT>
__global__ void __launch_bounds__(256)
rwkv_bwd_carry_kernel(const float* __restrict__ s0, const float* __restrict__ ds_t,
                      float* __restrict__ states, const float* __restrict__ decay,
                      float* __restrict__ ds0, int64_t entries, int n, int chunks) {
  constexpr int kAhead = 8;
  const int64_t idx = 4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (idx >= entries) return;
  const int64_t cell = static_cast<int64_t>(NT) * NT;
  const int64_t bh = idx / cell;
  const int e = static_cast<int>(idx % cell), i = e / NT, j0 = e % NT;
  const bool back = blockIdx.y == 1;
  float4* buf = reinterpret_cast<float4*>(states + (back ? entries * chunks : 0)
                                          + bh * chunks * cell + e);
  const int64_t stride = cell / 4;
  const float* p = decay + bh * chunks * NT + i;
  const float* init = back ? ds_t : s0;
  float x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + u;
    x[u] = (i < n && j < n && init != nullptr) ? init[(bh * n + i) * n + j] : 0.f;
  }
  for (int done = 0; done < chunks; done += kAhead) {
    float4 l[kAhead];
    float d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = back ? chunks - 1 - done - u : done + u;
      const bool in = done + u < chunks;
      l[u] = in ? buf[c * stride] : make_float4(0.f, 0.f, 0.f, 0.f);
      d[u] = in ? p[c * NT] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = back ? chunks - 1 - done - u : done + u;
      if (done + u < chunks) {
        __stcs(buf + c * stride, make_float4(x[0], x[1], x[2], x[3]));
        x[0] = fmaf(d[u], x[0], l[u].x);
        x[1] = fmaf(d[u], x[1], l[u].y);
        x[2] = fmaf(d[u], x[2], l[u].z);
        x[3] = fmaf(d[u], x[3], l[u].w);
      }
    }
  }
  if (back) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (i < n && j < n) ds0[(bh * n + i) * n + j] = x[u];
    }
  }
}

// Pass 3: per (b, h, chunk), the replay from the chunk's true start and the walk
// back from its true end: dr, dk, dw, dv (the block holds all N rows, so dv's
// sums over them end inside it), du's partial for the (b, chunk).
template <typename T, int NT>
__global__ void __launch_bounds__(walk_threads<NT>(), min_blocks(walk_threads<NT>()))
rwkv_bwd_walk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ w, const float* __restrict__ u,
                     const T* __restrict__ dy, const float* __restrict__ states,
                     T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                     T* __restrict__ dw, float* __restrict__ du_part, int seq, int heads,
                     int n, int chunks) {
  using Smem = WalkSmem<NT>;
  constexpr int LPR = Smem::LPR, kThreads = Smem::kThreads;
  constexpr int RPW = 32 / LPR;           // rows a warp holds
  constexpr int kLeft = RPW >= 8 ? 1 : kCols / RPW;   // dv sums a lane holds after the scatter
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rho = tid / LPR, j0 = (tid % LPR) * 4;   // columns j0 + [0, 4), NT / 2 + j0 + [0, 4)
  const int bhs = gridDim.x / chunks;   // chunk by chunk, as the local pass
  const int c = blockIdx.x / bhs, bh = blockIdx.x % bhs;
  const int64_t item = static_cast<int64_t>(bh) * chunks + c;
  const int b = bh / heads, h = bh % heads;
  const int t0 = c * kChunk;
  const int row_stride = heads * n;
  const int64_t base = ((static_cast<int64_t>(b) * seq + t0) * heads + h) * n;
  T* const drp = dr + base;
  T* const dkp = dk + base;
  T* const dwp = dw + base;
  T* const dvp = dv + base;
  const int64_t cell = static_cast<int64_t>(NT) * NT;
  const float* start = states + item * cell + rho * NT;
  float st[kCols], g[kCols];
  load_cols<NT>(start, j0, st);
  load_cols<NT>(start + static_cast<int64_t>(gridDim.x) * cell, j0, g);
  stage<T, NT, kThreads>(sm.in, r, k, v, w, dy, base, row_stride, min(kChunk, seq - t0), n);
  for (int i = tid; i < NT; i += kThreads) sm.u[i] = i < n ? u[h * n + i] : 0.f;
  __syncthreads();
  for (int p = tid; p < 2 * kChunk; p += kThreads) {   // v_t . dy_t; sum_i r u k
    const int s = p % kChunk;
    float lo = 0.f, hi = 0.f;
    if (p < kChunk) {
#pragma unroll 8
      for (int j = 0; j < NT; j += 2) {
        lo = fmaf(sm.in.v[s][j], sm.in.dy[s][j], lo);
        hi = fmaf(sm.in.v[s][j + 1], sm.in.dy[s][j + 1], hi);
      }
      sm.vdy[s] = lo + hi;
    } else {
#pragma unroll 8
      for (int i = 0; i < NT; i += 2) {
        lo = fmaf(sm.in.r[s][i] * sm.u[i], sm.in.k[s][i], lo);
        hi = fmaf(sm.in.r[s][i + 1] * sm.u[i + 1], sm.in.k[s][i + 1], hi);
      }
      sm.ruk[s] = lo + hi;
    }
  }
  // no barrier here: vdy and ruk are first read after the walk's first barrier

  // The replay: S at each sub-chunk's start.
#pragma unroll 1
  for (int q = 0; q < kChunk / kSub; ++q) {
    store8(sm.sub[q][tid], st);
    if (q + 1 < kChunk / kSub) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) advance<NT>(sm.in, q * kSub + s, rho, j0, st);
    }
  }

  // The walk, sub-chunk by sub-chunk from the last: the sub-chunk's 8 states
  // S_{t-1} replayed into registers, then G walked back over them, each step's
  // v and dy read once for dr, dk, dw and dv.
#pragma unroll 1
  for (int qq = 0; qq < kChunk / kSub; ++qq) {
    const int q = kChunk / kSub - 1 - qq;
    float sp[kSub][kCols];   // S_{t-1} of the sub-chunk's steps
    load8(sm.sub[q][tid], sp[0]);
#pragma unroll
    for (int s = 1; s < kSub; ++s) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) sp[s][e] = sp[s - 1][e];
      advance<NT>(sm.in, q * kSub + s - 1, rho, j0, sp[s]);
    }
#pragma unroll
    for (int ss = 0; ss < kSub; ++ss) {
      const int s = kSub - 1 - ss, sl = q * kSub + s;
      float vv[kCols], dd[kCols], pv[kCols];
      load_cols<NT>(sm.in.v[sl], j0, vv);
      load_cols<NT>(sm.in.dy[sl], j0, dd);
      const float rr = sm.in.r[sl][rho], kk = sm.in.k[sl][rho], ww = sm.in.w[sl][rho];
      sm.rowp[s][rho][tid % LPR] = dot8(sp[s], dd);
      sm.rowkw[s][rho][tid % LPR] = make_float2(dot8(g, vv), dot8(g, sp[s]));
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        pv[e] = g[e] * kk;
        g[e] = fmaf(ww, g[e], rr * dd[e]);   // G_{t-1}
      }
      // dv: a reduce-scatter over the warp's rows, then shared memory
      int col = j0;
      scatter<LPR, kCols, NT / 2>(pv, lane, col);
      if (RPW <= 8 || lane < 16) {   // at NT = 16 the upper 16 lanes repeat the lower
#pragma unroll
        for (int e = 0; e < kLeft; ++e) sm.colp[s][warp][col + e] = pv[e];
      }
    }
    __syncthreads();   // the sub-chunk's partials are in
    for (int p = tid; p < kSub * NT; p += kThreads) {   // dr, dk, dw of a row
      const int i = p % NT, s = p / NT, sl = q * kSub + s;
      if (t0 + sl >= seq || i >= n) continue;
      float r_dr = 0.f, r_dk = 0.f, r_dw = 0.f;
#pragma unroll
      for (int l = 0; l < LPR; ++l) {
        r_dr += sm.rowp[s][i][l];
        const float2 kw = sm.rowkw[s][i][l];
        r_dk += kw.x;
        r_dw += kw.y;
      }
      const float uv = sm.u[i] * sm.vdy[sl];
      const int off = sl * row_stride + i;
      drp[off] = Elem<T>::from_float(fmaf(uv, sm.in.k[sl][i], r_dr));
      dkp[off] = Elem<T>::from_float(fmaf(uv, sm.in.r[sl][i], r_dk));
      dwp[off] = Elem<T>::from_float(r_dw);
    }
    for (int p = tid; p < kSub * NT; p += kThreads) {   // dv of a column
      const int j = p % NT, s = p / NT, sl = q * kSub + s;
      if (t0 + sl >= seq || j >= n) continue;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < kThreads / 32; ++wp) acc += sm.colp[s][wp][j];
      acc = fmaf(sm.in.dy[sl][j], sm.ruk[sl], acc);
      dvp[sl * row_stride + j] = Elem<T>::from_float(acc);
    }
    __syncthreads();   // rowp and colp are free again
  }
  for (int i = tid; i < n; i += kThreads) {   // du's partial for the (b, chunk)
    float acc = 0.f;
    for (int s = 0; s < kChunk; ++s) acc = fmaf(sm.in.r[s][i] * sm.in.k[s][i], sm.vdy[s], acc);
    du_part[((static_cast<int64_t>(b) * chunks + c) * heads + h) * n + i] = acc;
  }
}

// du = the (b, chunk) partials added in batch order, then chunk order.
__global__ void rwkv_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                   int64_t partials, int hn) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hn) return;
  float acc = 0.f;
  for (int64_t bc = 0; bc < partials; ++bc) acc += du_part[bc * hn + e];
  du[e] = acc;
}

template <typename T, int NT>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, const void* dy, const float* ds_t, float* states, float* decay,
           void* dr, void* dk, void* dv, void* dw, float* du, float* ds0, float* du_part,
           int batch, int seq, int heads, int n, cudaStream_t st) {
  constexpr int walk_smem = sizeof(WalkSmem<NT>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv_bwd_walk_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, walk_smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int chunks = (seq + kChunk - 1) / kChunk;
  const int64_t items = static_cast<int64_t>(batch) * heads * chunks;
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* wp = static_cast<const T*>(w);
  const T* dyp = static_cast<const T*>(dy);
  rwkv_bwd_local_kernel<T, NT><<<static_cast<unsigned>(items), local_threads<NT>(), 0, st>>>(
      rp, kp, vp, wp, dyp, states, decay, seq, heads, n, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = static_cast<int64_t>(batch) * heads * NT * NT;
  rwkv_bwd_carry_kernel<NT><<<dim3(static_cast<unsigned>((entries / 4 + 255) / 256), 2), 256,
                              0, st>>>(s0, ds_t, states, decay, ds0, entries, n, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_bwd_walk_kernel<T, NT><<<static_cast<unsigned>(items), walk_threads<NT>(), walk_smem,
                                st>>>(rp, kp, vp, wp, u, dyp, states, static_cast<T*>(dr),
                                      static_cast<T*>(dk), static_cast<T*>(dv),
                                      static_cast<T*>(dw), du_part, seq, heads, n, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hn = heads * n;
  rwkv_bwd_du_kernel<<<(hn + 255) / 256, 256, 0, st>>>(
      du_part, du, static_cast<int64_t>(batch) * chunks, hn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(int width, const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* s0, const void* dy, const float* ds_t,
                   float* states, float* decay, void* dr, void* dk, void* dv, void* dw,
                   float* du, float* ds0, float* du_part, int batch, int seq, int heads, int n,
                   cudaStream_t st) {
  if (width == 16) {
    return launch<T, 16>(r, k, v, w, u, s0, dy, ds_t, states, decay, dr, dk, dv, dw, du, ds0,
                         du_part, batch, seq, heads, n, st);
  }
  if (width == 32) {
    return launch<T, 32>(r, k, v, w, u, s0, dy, ds_t, states, decay, dr, dk, dv, dw, du, ds0,
                         du_part, batch, seq, heads, n, st);
  }
  if (width == 64) {
    return launch<T, 64>(r, k, v, w, u, s0, dy, ds_t, states, decay, dr, dk, dv, dw, du, ds0,
                         du_part, batch, seq, heads, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// r, k, v, w, dy, dr, dk, dv, dw: (batch, seq, heads, n), dense, of dtype (0
// fp32, 1 bf16); u, du: (heads, n) fp32; s0, ds_t, ds0: (batch, heads, n, n)
// fp32, dense, ds_t may be null (zero). Scratch, fp32: states (2, batch heads,
// ceil(seq / chunk), width, width), the local pass's L then M, which the carry
// pass overwrites with each chunk's true start and end; decay (batch heads,
// ceil(seq / chunk), width); du_part (batch, ceil(seq / chunk), heads, n).
// 1 <= n <= width (16, 32 or 64), seq >= 1. chunk is the caller's copy of the
// launches' geometry, which it sized the scratch from: kChunk, or the call is
// refused before anything is written. Launches the local, carry and walk
// passes and the pass that adds du's partials; returns the CUDA error of the
// launches (0 when they were accepted).
extern "C" int rwkv_scan_bwd(int dtype, int width, const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0, const void* dy,
                             const void* ds_t, void* states, void* decay, void* dr, void* dk,
                             void* dv, void* dw, void* du, void* ds0, void* du_part, int batch,
                             int seq, int heads, int n, int chunk, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seq < 1 || heads < 1 || n < 1 || n > width || chunk != kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  const float* dsp = static_cast<const float*>(ds_t);
  float* stp = static_cast<float*>(states);
  float* dcp = static_cast<float*>(decay);
  float* dup = static_cast<float*>(du);
  float* ds0p = static_cast<float*>(ds0);
  float* dupp = static_cast<float*>(du_part);
  if (dtype == kFloat32) {
    return dispatch_width<float>(width, r, k, v, w, up, s0p, dy, dsp, stp, dcp, dr, dk, dv, dw,
                                 dup, ds0p, dupp, batch, seq, heads, n, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_width<bf16>(width, r, k, v, w, up, s0p, dy, dsp, stp, dcp, dr, dk, dv, dw,
                                dup, ds0p, dupp, batch, seq, heads, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
