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
// What bounds it on an H100: per (b, t, d, n) one exponential and 18 fp32
// operations, and per (b, t, d) 2 more, against, per (b, t, d), one x and one
// dy read and one dx written (dt, B and C are shared by a batch row's
// channels). At hymba-1.5b's training micro-batch (B=2, S=1536, Di=3200, N=16;
// bf16 x, fp32 dy) that is 157 M exponentials and 2.85 GFLOP, 0.043 ms at the
// 67 TFLOP/s of fp32, against 0.08 GB moved, 0.024 ms at 3.35 TB/s: the bound
// is the operations, with the special-function units' exponentials (16 a
// clock an SM: 0.042 ms for one pass of them) beside it.
//
// The design: the recurrence and its adjoint are diagonal and linear, so a
// chunk of kChunk = 32 steps crosses them affinely: the state at its end is
// P (.) (the state at its start) + L, and the adjoint before it is P (.) (the
// adjoint after it) + M, with P = 2^(A log2 e sum_t dt_t) (one exponential a
// chunk and entry), L the chunk run forward from zero and M the adjoint walked
// back over it from zero. Nothing is divided: a decay that underflows makes
// P = 0, which is exactly right. So the chunks run in parallel over time, in
// three launches, each deterministic (no atomics: a run repeats bit for bit).
// A block is 256 threads, two state entries (d, n) and (d + CB/2, n) each:
// CB = 512 / NT channels (32 at N <= 16).
// 1. Local: one block a (b, channel block, chunk), one forward sweep: L, and
//    M = sum_t E_t (.) dy_t C_t with E_t = prod_{tau <= t} e_tau (a running
//    product), one exponential an entry and step. It writes L and M
//    (scratch: 2 B ceil(S/32) Di N fp32, 39 MB at the training shape) and the
//    chunk's sum of dt.
// 2. Carry: four state entries a thread and a direction, serially over the
//    chunks: the true state at each chunk's start from h0 written over L, and
//    the true adjoint after each chunk from dh_T written over M; the last
//    gives dh0.
// 3. Walk: the same blocks. A thread keeps its two channels' h_{t-1} over the
//    whole chunk in registers (64 of them), so the chunk is replayed once
//    from its true start and walked back once from its true end; e_t is
//    formed where it is needed, in the replay and in the walk (three
//    exponentials an entry and step in all: registers hold no room for the
//    chunk's e_t beside its h_{t-1}).
// The sums come off the per-step path: each step's partials go to shared
// memory (double buffered): dx's g B for each channel, and the two channels'
// sums of dB's g dt x, dC's dy h and ddt's A g e h; once every 8 steps the
// block adds dx over its n and dB, dC, ddt over its channel pairs, in order,
// into one fp32 partial per block (nblk x B S x (2N + 1): 41 MB at the
// training shape, 100 blocks a row); ddt's x B part is x_t times dx's sum
// over n. dA is a per-entry running sum, one partial per (b, chunk) (20 MB).
// A last launch adds the blocks' partials, then dA's, in batch and chunk
// order. Scratch in all: 100 MB at the training shape.
// A chunk's x, dy (the block's channels), dt, B and C are staged in shared
// memory by plain loads, widened to fp32, each as rows over the chunk's steps
// (a thread reads 4 steps at once); steps past S read as neutral (dt = 0, so
// e = 1, and x, dy, B, C = 0), channels past Di and columns past N as zero, so
// the loops run over a compile-time width NT with no bounds checks. Every
// kernel keeps within 128 registers a thread, without spills.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;   // steps of a chunk: one block of the local and walk passes
constexpr int kGroup = 8;    // steps whose partials are added together
constexpr int kThreads = 256;        // a block: two state entries a thread
constexpr int kPad = 4;              // floats that pad a staged row (bank spread, 16-byte rows)
constexpr float kLog2e = 1.4426950408889634f;

template <int NT>
__host__ __device__ constexpr int block_channels() {       // 32, 16, 8: two a thread
  return 2 * kThreads / NT;
}

// A chunk's inputs of a block of CB channels, widened to fp32, each row over
// the chunk's steps, so a thread reads 4 steps of its channel or column at
// once.
template <int NT, int CB>
struct __align__(16) Tiles {
  static constexpr int kRow = kChunk + kPad;
  float x[CB][kRow], dy[CB][kRow];
  float b[NT][kRow], c[NT][kRow];
  float dt[kChunk];
};

template <int NT>
struct __align__(16) WalkSmem {
  static constexpr int CB = block_channels<NT>();
  static constexpr int kRow = CB / 2 + 2;   // a staged row: 8-byte aligned, no bank conflict on the stores
  Tiles<NT, CB> in;
  float px[2][kGroup][CB][NT];          // g B, by channel then n
  float pbct[2][kGroup][3][NT][kRow];   // a channel pair's g dt x, dy h, A g e h, by n then pair
  float dx[kChunk][CB];
  float xdx[kChunk][CB];                // x_t (sum_n g B): ddt's x B part, by channel
  float tsum[kChunk][NT];               // ddt's A e h part summed over the channels, by n
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Steps [t0, t0 + rows) of batch row b, as a thread holds them between their
// loads and their stores to shared memory: x and dy of the block's channels,
// dt, B and C. load() issues every load of the tile before any is used.
template <typename T, int NT, int CB, int THREADS>
struct TileRegs {
  static constexpr int kX = (kChunk * CB + THREADS - 1) / THREADS;
  static constexpr int kB = (kChunk * NT + THREADS - 1) / THREADS;
  float xs[kX], ys[kX], bs[kB], cs[kB], dts;

  __device__ __forceinline__ void load(const T* __restrict__ x, const T* __restrict__ dt,
                                       const T* __restrict__ bm, const T* __restrict__ cm,
                                       const float* __restrict__ dy, int64_t row0, int rows,
                                       int d0, int d_inner, int n) {
#pragma unroll
    for (int u = 0; u < kX; ++u) {   // neighbouring threads read neighbouring channels
      const int p = threadIdx.x + u * THREADS, cc = p % CB, s = p / CB, d = d0 + cc;
      const bool ok = p < kChunk * CB && s < rows && d < d_inner;
      const int64_t off = (row0 + s) * d_inner + d;
      xs[u] = ok ? Elem<T>::to_float(x[off]) : 0.f;
      ys[u] = ok ? dy[off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int p = threadIdx.x + u * THREADS, j = p % NT, s = p / NT;
      const bool ok = p < kChunk * NT && s < rows && j < n;
      const int64_t off = (row0 + s) * n + j;
      bs[u] = ok ? Elem<T>::to_float(bm[off]) : 0.f;
      cs[u] = ok ? Elem<T>::to_float(cm[off]) : 0.f;
    }
    const int s = threadIdx.x;
    dts = s < rows && s < kChunk ? Elem<T>::to_float(dt[row0 + s]) : 0.f;
  }

  // Each input transposed to rows over the steps.
  __device__ __forceinline__ void store(Tiles<NT, CB>& sm) const {
#pragma unroll
    for (int u = 0; u < kX; ++u) {
      const int p = threadIdx.x + u * THREADS;
      if (p < kChunk * CB) {
        sm.x[p % CB][p / CB] = xs[u];
        sm.dy[p % CB][p / CB] = ys[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int p = threadIdx.x + u * THREADS;
      if (p < kChunk * NT) {
        sm.b[p % NT][p / NT] = bs[u];
        sm.c[p % NT][p / NT] = cs[u];
      }
    }
    if (threadIdx.x < kChunk) sm.dt[threadIdx.x] = dts;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The sum of the Q float2s at p: two chains, added at the end.
template <int Q>
__device__ __forceinline__ float sum2(const float* p) {
  float2 acc = *reinterpret_cast<const float2*>(p);
#pragma unroll
  for (int e = 1; e < Q; ++e) {
    const float2 f = reinterpret_cast<const float2*>(p)[e];
    acc.x += f.x;
    acc.y += f.y;
  }
  return acc.x + acc.y;
}

// The sum of the Q float4s at p: four chains, one a component, added at the end.
template <int Q>
__device__ __forceinline__ float sum4(const float* p) {
  float4 acc = ld4(p);
#pragma unroll
  for (int e = 1; e < Q; ++e) {
    const float4 f = ld4(p + 4 * e);
    acc.x += f.x; acc.y += f.y; acc.z += f.z; acc.w += f.w;
  }
  return (acc.x + acc.y) + (acc.z + acc.w);
}

// Where a block's thread sits: channels ch and ch + CB / 2 of the block, state
// column j; the block's CB channels start at d0. Blocks are numbered (c B + b) nblk + blk:
// chunk by chunk, the channel blocks of a row side by side (neighbours in
// memory).
struct Place {
  int b, blk, c, ch, j, d, d0;
};

template <int NT, int CB>
__device__ __forceinline__ Place place(int item, int items, int nblk, int chunks) {
  Place p;
  const int rows = items / chunks;   // (b, blk) pairs
  p.c = item / rows;
  p.blk = item % nblk;
  p.b = item % rows / nblk;
  p.ch = threadIdx.x / NT;   // < CB / 2
  p.j = threadIdx.x % NT;
  p.d0 = p.blk * CB;
  p.d = p.d0 + p.ch;
  return p;
}

// Pass 1: per (b, channel block, chunk), the chunk crossed from zero in one
// forward sweep: L, h run forward from zero, and M, the adjoint walked back
// from zero, which is sum_t E_t (.) dy_t C_t with E_t = prod_{tau <= t} e_tau (a
// running product: nothing divided, nothing kept per step). One exponential
// an entry and step. Block 0 of a batch row writes the chunk's sum of dt.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 4)
ssm_bwd_local_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ a,
                     const float* __restrict__ dy, float* __restrict__ states,
                     float* __restrict__ dtsum, int seq, int d_inner, int n, int chunks,
                     int nblk) {
  constexpr int CB = block_channels<NT>(), kHalf = CB / 2;
  __shared__ Tiles<NT, CB> sm;
  const Place p = place<NT, CB>(blockIdx.x, gridDim.x, nblk, chunks);
  const int t0 = p.c * kChunk;
  {
    TileRegs<T, NT, CB, kThreads> tile;
    tile.load(x, dt, bm, cm, dy, static_cast<int64_t>(p.b) * seq + t0, min(kChunk, seq - t0),
              p.d0, d_inner, n);
    tile.store(sm);
  }
  float a2[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int d = p.d + u * kHalf;
    a2[u] = d < d_inner && p.j < n ? a[static_cast<int64_t>(d) * n + p.j] * kLog2e : 0.f;
  }
  __syncthreads();
  float h[2] = {0.f, 0.f}, m[2] = {0.f, 0.f}, prod[2] = {1.f, 1.f};
#pragma unroll
  for (int s4 = 0; s4 < kChunk; s4 += 4) {
    const float4 dt4 = ld4(&sm.dt[s4]), b4 = ld4(&sm.b[p.j][s4]), c4 = ld4(&sm.c[p.j][s4]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 x4 = ld4(&sm.x[p.ch + u * kHalf][s4]), y4 = ld4(&sm.dy[p.ch + u * kHalf][s4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dtt = at(dt4, e), dec = ex2(dtt * a2[u]);
        h[u] = fmaf(dec, h[u], dtt * at(x4, e) * at(b4, e));
        prod[u] *= dec;
        m[u] = fmaf(prod[u] * at(y4, e), at(c4, e), m[u]);
      }
    }
  }
  const int64_t slab = static_cast<int64_t>(nblk) * CB * NT;   // one (b, chunk)'s states
  const int64_t off = (static_cast<int64_t>(p.b) * chunks + p.c) * slab + p.d0 * NT + threadIdx.x;
  const int64_t adj = static_cast<int64_t>(gridDim.x / nblk) * slab;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    __stcs(states + off + u * kHalf * NT, h[u]);   // read by the carry pass, long after
    __stcs(states + adj + off + u * kHalf * NT, m[u]);
  }
  if (p.blk == 0 && threadIdx.x == 0) {
    float acc = 0.f;
    for (int s = 0; s < kChunk; ++s) acc += sm.dt[s];
    dtsum[static_cast<int64_t>(p.b) * chunks + p.c] = acc;
  }
}

// Pass 2: per four state entries of a channel, the true state at each chunk's
// start (blockIdx.y 0, from h0, over L) or the true adjoint after each chunk
// (1, from dh_T, over M; the last is dh0), serially over the chunks, with the
// chunk's decay P = 2^(A log2 e sum dt). Loads go out kAhead chunks at a time,
// 16 bytes each.
template <int NT>
__global__ void __launch_bounds__(256)
ssm_bwd_carry_kernel(const float* __restrict__ a, const float* __restrict__ h0,
                     const float* __restrict__ dh_t, float* __restrict__ states,
                     const float* __restrict__ dtsum, float* __restrict__ dh0, int64_t entries,
                     int d_pad, int d_inner, int n, int chunks) {
  constexpr int kAhead = 8;
  const int64_t idx = 4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (idx >= entries) return;
  const int64_t slab = static_cast<int64_t>(d_pad) * NT;
  const int b = static_cast<int>(idx / slab);
  const int64_t rem = idx % slab;
  const int d = static_cast<int>(rem / NT), j0 = static_cast<int>(rem % NT);
  const bool back = blockIdx.y == 1;
  const float* init = back ? dh_t : h0;
  float a2[4], v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + u;
    const bool ok = d < d_inner && j < n;
    a2[u] = ok ? a[static_cast<int64_t>(d) * n + j] * kLog2e : 0.f;
    v[u] = ok && init != nullptr ? init[(static_cast<int64_t>(b) * d_inner + d) * n + j] : 0.f;
  }
  float4* buf = reinterpret_cast<float4*>(states + (back ? entries * chunks : 0)
                                          + static_cast<int64_t>(b) * chunks * slab + rem);
  const int64_t stride = slab / 4;
  const float* sums = dtsum + static_cast<int64_t>(b) * chunks;
  for (int done = 0; done < chunks; done += kAhead) {
    float4 l[kAhead];
    float dts[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = back ? chunks - 1 - done - u : done + u;
      const bool in = done + u < chunks;
      l[u] = in ? buf[c * stride] : make_float4(0.f, 0.f, 0.f, 0.f);
      dts[u] = in ? sums[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = back ? chunks - 1 - done - u : done + u;
      if (done + u < chunks) {
        __stcs(buf + c * stride, make_float4(v[0], v[1], v[2], v[3]));
        v[0] = fmaf(ex2(a2[0] * dts[u]), v[0], l[u].x);
        v[1] = fmaf(ex2(a2[1] * dts[u]), v[1], l[u].y);
        v[2] = fmaf(ex2(a2[2] * dts[u]), v[2], l[u].z);
        v[3] = fmaf(ex2(a2[3] * dts[u]), v[3], l[u].w);
      }
    }
  }
  if (back) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (d < d_inner && j < n) dh0[(static_cast<int64_t>(b) * d_inner + d) * n + j] = v[u];
    }
  }
}

// Pass 3: per (b, channel block, chunk), the replay from the chunk's true start
// and the walk back from its true end: dx, the block's partials of dB, dC and
// ddt, and dA's partial for the (b, chunk). A thread holds two channels' h_{t-1}
// over the whole chunk in registers (64 of them) and forms e_t where it needs
// it, once in the replay and once in the walk; the two channels' products for
// dB, dC and ddt are added in the thread before they are staged. Two blocks
// share an SM.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssm_bwd_walk_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ a,
                    const float* __restrict__ dy, const float* __restrict__ states,
                    T* __restrict__ dx, float* __restrict__ part, float* __restrict__ da_part,
                    int batch, int seq, int d_inner, int n, int chunks, int nblk) {
  constexpr int CB = block_channels<NT>(), kHalf = CB / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<WalkSmem<NT>*>(smem_raw);
  const Place p = place<NT, CB>(blockIdx.x, gridDim.x, nblk, chunks);
  const int tid = threadIdx.x, cp = p.ch, j = p.j;
  const int t0 = p.c * kChunk;
  const int64_t row0 = static_cast<int64_t>(p.b) * seq + t0;
  const int64_t slab = static_cast<int64_t>(nblk) * CB * NT;
  const int64_t off = (static_cast<int64_t>(p.b) * chunks + p.c) * slab + p.d0 * NT + tid;
  const int64_t adj = static_cast<int64_t>(gridDim.x / nblk) * slab;
  float av[2], a2[2], h[2], q[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int d = p.d + u * kHalf;
    av[u] = d < d_inner && j < n ? a[static_cast<int64_t>(d) * n + j] : 0.f;
    a2[u] = av[u] * kLog2e;
    h[u] = states[off + u * kHalf * NT];
    q[u] = states[adj + off + u * kHalf * NT];
  }
  {
    TileRegs<T, NT, CB, kThreads> tile;
    tile.load(x, dt, bm, cm, dy, row0, min(kChunk, seq - t0), p.d0, d_inner, n);
    tile.store(sm.in);
  }
  __syncthreads();

  // The replay: h_{t-1} of every step, kept in registers.
  float hp[2][kChunk];
#pragma unroll
  for (int s4 = 0; s4 < kChunk; s4 += 4) {
    const float4 dt4 = ld4(&sm.in.dt[s4]), b4 = ld4(&sm.in.b[j][s4]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 x4 = ld4(&sm.in.x[cp + u * kHalf][s4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dtt = at(dt4, e);
        hp[u][s4 + e] = h[u];
        h[u] = fmaf(ex2(dtt * a2[u]), h[u], dtt * at(x4, e) * at(b4, e));
      }
    }
  }

  // The walk, 8 steps a group from the last; each group's partials are added
  // while the next group runs.
  float ht[2] = {h[0], h[1]}, da[2] = {0.f, 0.f};
  const int row_len = 2 * n + 1;   // a partial's row: dB, dC, ddt
#pragma unroll
  for (int gg = 0; gg < kChunk / kGroup; ++gg) {
    const int gq = kChunk / kGroup - 1 - gg, buf = gg & 1;
#pragma unroll
    for (int h4 = kGroup - 4; h4 >= 0; h4 -= 4) {
      const int s4 = gq * kGroup + h4;
      const float4 dt4 = ld4(&sm.in.dt[s4]), b4 = ld4(&sm.in.b[j][s4]);
      const float4 c4 = ld4(&sm.in.c[j][s4]);
      const float4 x4[2] = {ld4(&sm.in.x[cp][s4]), ld4(&sm.in.x[cp + kHalf][s4])};
      const float4 y4[2] = {ld4(&sm.in.dy[cp][s4]), ld4(&sm.in.dy[cp + kHalf][s4])};
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        const int sl = h4 + e, s = s4 + e;
        const float dtt = at(dt4, e), bb = at(b4, e), cc = at(c4, e);
        float pb = 0.f, pc = 0.f, pt = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float dyd = at(y4[u], e), dec = ex2(dtt * a2[u]);
          const float g = fmaf(dyd, cc, q[u]);           // g_t
          const float gdh = g * (dec * hp[u][s]);        // g_t e_t h_{t-1}
          sm.px[buf][sl][cp + u * kHalf][j] = g * bb;
          pb = fmaf(g, dtt * at(x4[u], e), pb);
          pc = fmaf(dyd, ht[u], pc);
          pt = fmaf(av[u], gdh, pt);
          da[u] = fmaf(dtt, gdh, da[u]);
          q[u] = dec * g;
          ht[u] = hp[u][s];
        }
        sm.pbct[buf][sl][0][j][cp] = pb;
        sm.pbct[buf][sl][1][j][cp] = pc;
        sm.pbct[buf][sl][2][j][cp] = pt;
      }
    }
    __syncthreads();   // the group's partials are in; the other buffer is free
    for (int o = tid; o < kGroup * (CB + 3 * NT); o += kThreads) {
      if (o < kGroup * CB) {   // dx: over the channel's n
        const int sl = o / CB, cc = o % CB, s = gq * kGroup + sl;
        const float gb = sum4<NT / 4>(sm.px[buf][sl][cc]);
        sm.dx[s][cc] = sm.in.dt[s] * gb;
        sm.xdx[s][cc] = sm.in.x[cc][s] * gb;
      } else {                 // dB, dC, ddt: over the block's channel pairs
        const int r = o - kGroup * CB;
        const int kind = r / (kGroup * NT), sl = (r / NT) % kGroup, jj = r % NT;
        const int s = gq * kGroup + sl, t = t0 + s;
        const float acc = sum2<kHalf / 2>(sm.pbct[buf][sl][kind][jj]);
        if (kind == 2) {
          sm.tsum[s][jj] = acc;
        } else if (t < seq && jj < n) {
          part[((static_cast<int64_t>(p.blk) * batch + p.b) * seq + t) * row_len + kind * n
               + jj] = acc;
        }
      }
    }
  }
  __syncthreads();   // dx and ddt's sums are in
  for (int s = tid; s < kChunk; s += kThreads) {
    const int t = t0 + s;
    if (t < seq) {
      float acc = 0.f;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) acc += sm.tsum[s][jj];
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) acc += sm.xdx[s][cc];
      part[((static_cast<int64_t>(p.blk) * batch + p.b) * seq + t) * row_len + 2 * n] = acc;
    }
  }
  for (int o = tid; o < kChunk * CB; o += kThreads) {
    const int s = o / CB, cc = o % CB, d = p.d0 + cc;
    if (t0 + s < seq && d < d_inner) dx[(row0 + s) * d_inner + d] = Elem<T>::from_float(sm.dx[s][cc]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int d = p.d + u * kHalf;
    if (d < d_inner && j < n) {
      da_part[((static_cast<int64_t>(p.b) * chunks + p.c) * d_inner + d) * n + j] = da[u];
    }
  }
}

// dB, dC, ddt = the blocks' partials added in block order; dA = the (b, chunk)
// partials added in batch order, then chunk order.
template <typename T>
__global__ void ssm_bwd_combine_kernel(const float* __restrict__ part,
                                       const float* __restrict__ da_part, T* __restrict__ ddt,
                                       T* __restrict__ db, T* __restrict__ dc,
                                       float* __restrict__ da, int nblk, int64_t rows, int n,
                                       int64_t partials, int64_t dn) {
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
    for (int64_t bc = 0; bc < partials; ++bc) acc += da_part[bc * dn + e];
    da[e] = acc;
  }
}

template <typename T, int NT>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const float* a,
           const float* h0, const float* dy, const float* dh_t, float* states, float* dtsum,
           void* dx, void* ddt, void* db, void* dc, float* da, float* dh0, float* part,
           float* da_part, int batch, int seq, int d_inner, int n, cudaStream_t st) {
  constexpr int CB = block_channels<NT>();
  constexpr int walk_smem = sizeof(WalkSmem<NT>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_bwd_walk_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, walk_smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nblk = (d_inner + CB - 1) / CB;
  const int chunks = (seq + kChunk - 1) / kChunk;
  const int64_t items = static_cast<int64_t>(batch) * nblk * chunks;
  const T* xp = static_cast<const T*>(x);
  const T* dtp = static_cast<const T*>(dt);
  const T* bp = static_cast<const T*>(bm);
  const T* cp = static_cast<const T*>(cm);
  ssm_bwd_local_kernel<T, NT><<<static_cast<unsigned>(items), kThreads, 0, st>>>(
      xp, dtp, bp, cp, a, dy, states, dtsum, seq, d_inner, n, chunks, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = static_cast<int64_t>(batch) * nblk * CB * NT;
  ssm_bwd_carry_kernel<NT><<<dim3(static_cast<unsigned>((entries / 4 + 255) / 256), 2), 256,
                             0, st>>>(a, h0, dh_t, states, dtsum, dh0, entries, nblk * CB,
                                   d_inner, n, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_walk_kernel<T, NT><<<static_cast<unsigned>(items), kThreads, walk_smem, st>>>(
      xp, dtp, bp, cp, a, dy, states, static_cast<T*>(dx), part, da_part, batch, seq, d_inner,
      n, chunks, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(batch) * seq;
  const int64_t dn = static_cast<int64_t>(d_inner) * n;
  const int64_t blocks = (rows * (2 * n + 1) + dn + 255) / 256;
  ssm_bwd_combine_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      part, da_part, static_cast<T*>(ddt), static_cast<T*>(db), static_cast<T*>(dc), da, nblk,
      rows, n, static_cast<int64_t>(batch) * chunks, dn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(int width, const void* x, const void* dt, const void* bm, const void* cm,
                   const float* a, const float* h0, const float* dy, const float* dh_t,
                   float* states, float* dtsum, void* dx, void* ddt, void* db, void* dc,
                   float* da, float* dh0, float* part, float* da_part, int batch, int seq,
                   int d_inner, int n, cudaStream_t st) {
  if (width == 16) {
    return launch<T, 16>(x, dt, bm, cm, a, h0, dy, dh_t, states, dtsum, dx, ddt, db, dc, da,
                         dh0, part, da_part, batch, seq, d_inner, n, st);
  }
  if (width == 32) {
    return launch<T, 32>(x, dt, bm, cm, a, h0, dy, dh_t, states, dtsum, dx, ddt, db, dc, da,
                         dh0, part, da_part, batch, seq, d_inner, n, st);
  }
  if (width == 64) {
    return launch<T, 64>(x, dt, bm, cm, a, h0, dy, dh_t, states, dtsum, dx, ddt, db, dc, da,
                         dh0, part, da_part, batch, seq, d_inner, n, st);
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
// null (zero). Scratch, fp32: states (2, batch, ceil(seq / chunk), d_inner padded
// to the block's channels, width), the local pass's L then M, which the carry
// pass overwrites with each chunk's true start and end; dtsum (batch, ceil(seq
// / chunk)); part (blocks, batch, seq, 2 n + 1); da_part (batch, ceil(seq /
// chunk), d_inner, n). 1 <= n <= width (16, 32 or 64), seq >= 1. chunk and
// split are the caller's copy of the launches' geometry, which it sized the
// scratch from: kChunk and the block's channels at this width, or the call is
// refused before anything is written. Launches the local, carry and walk
// passes and the pass that adds the partials; returns the CUDA error of the
// launches (0 when they were accepted).
extern "C" int ssm_scan_bwd(int dtype, int width, const void* x, const void* dt, const void* bm,
                            const void* cm, const void* a, const void* h0, const void* dy,
                            const void* dh_t, void* states, void* dtsum, void* dx, void* ddt,
                            void* db, void* dc, void* da, void* dh0, void* part, void* da_part,
                            int batch, int seq, int d_inner, int n, int chunk, int split,
                            void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seq < 1 || d_inner < 1 || n < 1 || n > width || chunk != kChunk ||
      split != expected_split(width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  const float* dyp = static_cast<const float*>(dy);
  const float* dhp = static_cast<const float*>(dh_t);
  float* stp = static_cast<float*>(states);
  float* dtp = static_cast<float*>(dtsum);
  float* dap = static_cast<float*>(da);
  float* dh0p = static_cast<float*>(dh0);
  float* pp = static_cast<float*>(part);
  float* dapp = static_cast<float*>(da_part);
  if (dtype == kFloat32) {
    return dispatch_width<float>(width, x, dt, bm, cm, ap, h0p, dyp, dhp, stp, dtp, dx, ddt, db,
                                 dc, dap, dh0p, pp, dapp, batch, seq, d_inner, n, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_width<bf16>(width, x, dt, bm, cm, ap, h0p, dyp, dhp, stp, dtp, dx, ddt, db,
                                dc, dap, dh0p, pp, dapp, batch, seq, d_inner, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
