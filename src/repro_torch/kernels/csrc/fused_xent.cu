// Fused LM-head cross-entropy forward for Hopper, sm_90a, with a plain C entry
// point for ctypes.
//
// Replaces: src/repro/kernels/fused_xent.py, fused_xent -> _xent_kernel, the
// Pallas TPU kernel. It computes what that kernel computes, the per-token loss
// lse(x W) - (x W)[label], streaming the vocabulary so that the (T,V) logits
// never reach device memory, and also writes the per-token log-sum-exp that the
// backward reuses. Beyond the TPU kernel it takes ragged T and V (151936 is not
// a multiple of any power-of-two tile), gives tokens whose label is
// ignore_index a loss of 0, and reads W as (V,D) rows in place, so the tied
// head (the embedding itself) is never copied.
//
// What bounds it on an H100: at the training shapes (T=2048, D=2048, V=151936,
// bf16) the product x W is ~1.27 TFLOP against ~0.63 GB of W, so the tensor
// cores bound it (~1.29 ms at 989 TFLOP/s), not memory (~0.19 ms).
//
// Design: a GEMM with the cross-entropy in its epilogue. The grid is (token
// blocks, vocab splits), each split a contiguous run of vocab tiles, with as
// many splits as fill the card once; the token blocks of one split run side by
// side and stream the same W tiles, so W is read from device memory about
// once and from L2 by the rest. Per vocab tile the running max, the running
// sum and the gold logit of each token move on in registers (the TPU kernel's
// VMEM scratch); each block writes its split's three partials, and a second
// small kernel merges the splits into the loss and the log-sum-exp. The masks
// of ignore_index and of the ragged vocabulary tail live in these two
// kernels: there is no second pass over (T,V).
// bf16 (the training path, xent_wgmma_kernel): blocks of 128 tokens, tiles of
// 256 vocab columns. A producer warp streams 64-wide D chunks of x and W by
// TMA through a 4-stage ring of mbarrier-guarded stages, running on across
// vocab tiles, so the next tile's loads overlap this tile's epilogue; two
// consumer warpgroups of 64 tokens each run the product as wgmma (m64n256k16,
// both operands K-major: W's rows are its D-contiguous (V,D) rows) into 128
// fp32 registers a thread, one chunk's products in flight while the next
// chunk lands, and update the online log-sum-exp (base 2) from that fragment.
// TMA zero-fills past T, V and D.
// fp32 runs scalar FMAs (256 threads, a 4x4 micro-tile each, D chunks staged
// in shared memory); no training path runs it.
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kVocabTile = 256;   // vocab columns per tile: the unit of a split
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Partial state of one split: running max, running sum and gold logit per token.
struct Partials {
  float* m;
  float* l;
  float* gold;
};

// ---------------------------------------------------------------------------
// bf16: TMA-fed chunks and warpgroup products
// ---------------------------------------------------------------------------

constexpr int kXtTok = 128;      // tokens per block: two consumer warpgroups of 64
constexpr int kXtStages = 4;     // D chunks of x and W in the ring
constexpr int kXtThreads = 384;  // one producer warpgroup, two consumer warpgroups

struct alignas(1024) XtShared {
  bf16 x[kXtStages][kXtTok * 64];      // [stage][tokens x 64 of D]
  bf16 w[kXtStages][kVocabTile * 64];  // [stage][vocab rows x 64 of D]
  uint64_t full[kXtStages];
  uint64_t empty[kXtStages];           // both consumers are done with the stage
};

// Block (token block, split): warpgroup 0 is the producer, one thread
// streaming chunk after chunk of the split's vocab tiles; warpgroups 1 and 2
// each own 64 tokens.
__global__ void __launch_bounds__(kXtThreads, 1)
xent_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const int64_t* __restrict__ labels, Partials part, int t, int d, int v,
                  int tiles_per_split) {
  constexpr uint32_t kStageBytes = (kXtTok + kVocabTile) * 128;
  extern __shared__ unsigned char smem_raw[];
  XtShared& sm = *reinterpret_cast<XtShared*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int t0 = blockIdx.x * kXtTok;
  const int split = blockIdx.y;
  const int n_tiles = (v + kVocabTile - 1) / kVocabTile;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_tiles, vt_begin + tiles_per_split);
  const int nchunks = (d + 63) / 64;
  const int total = max(0, vt_end - vt_begin) * nchunks;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kXtStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tx);
      hopper::tma_prefetch_map(&tw);
      for (int i = 0; i < total; ++i) {
        const int st = i % kXtStages;
        const int c = i % nchunks;
        const int v0 = (vt_begin + i / nchunks) * kVocabTile;
        hopper::mbar_wait(&sm.empty[st], ((i / kXtStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
        hopper::tma_load_2d(sm.x[st], &tx, &sm.full[st], c * 64, t0);
        hopper::tma_load_2d(sm.w[st], &tw, &sm.full[st], c * 64, v0);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    hopper::reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int tt = threadIdx.x % 128;
    const int lane = tt % 32;
    const int quad = lane % 4;
    const int rows[2] = {t0 + 64 * wg + (tt / 32) * 16 + lane / 4,
                         t0 + 64 * wg + (tt / 32) * 16 + lane / 4 + 8};
    int64_t lab[2];
    float m[2] = {kNegInf, kNegInf};   // running max of the logits times log2(e)
    float l[2] = {0.f, 0.f};           // this thread's share of each row's sum
    float gold[2] = {0.f, 0.f};        // this thread's share of each row's gold logit
#pragma unroll
    for (int r = 0; r < 2; ++r) lab[r] = rows[r] < t ? labels[rows[r]] : -1;

    int i = 0;   // chunks consumed: the ring's position
    for (int vt = vt_begin; vt < vt_end; ++vt) {
      float acc[kVocabTile / 2];   // 64 tokens x 256 columns over the warpgroup
      hopper::fence_regs(acc);
      for (int c = 0; c < nchunks; ++c, ++i) {
        const int st = i % kXtStages;
        hopper::mbar_wait(&sm.full[st], (i / kXtStages) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = hopper::sw128_desc(&sm.x[st][64 * 64 * wg + kk * 16], 16, 1024);
          const uint64_t db = hopper::sw128_desc(&sm.w[st][kk * 16], 16, 1024);
          hopper::wgmma_ss_m64n256k16(acc, da, db, c > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        // the previous chunk's products are done: free its stage
        hopper::wgmma_wait<1>();
        hopper::fence_regs(acc);
        if (c > 0) hopper::mbar_arrive(&sm.empty[(i - 1) % kXtStages]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&sm.empty[(i - 1) % kXtStages]);

      // online log-sum-exp over this tile, base 2; value e of acc sits at row
      // rows[(e >> 1) & 1], column 8 (e >> 2) + 2 quad + (e & 1)
      const int v0 = vt * kVocabTile;
      const bool ragged = v0 + kVocabTile > v;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < kVocabTile / 2; ++e) {
        const int col = v0 + (e >> 2) * 8 + 2 * quad + (e & 1);
        const int r = (e >> 1) & 1;
        if (col == lab[r]) gold[r] += acc[e];
        acc[e] = (ragged && col >= v) ? kNegInf : acc[e] * kLog2e;
        mx[r] = fmaxf(mx[r], acc[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        l[r] *= hopper::exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int e = 0; e < kVocabTile / 2; ++e) {
        l[(e >> 1) & 1] += hopper::exp2_approx(acc[e] - m[(e >> 1) & 1]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      gold[r] += __shfl_xor_sync(0xffffffffu, gold[r], 1);
      gold[r] += __shfl_xor_sync(0xffffffffu, gold[r], 2);
      if (quad == 0 && rows[r] < t) {
        const int64_t at = static_cast<int64_t>(split) * t + rows[r];
        part.m[at] = m[r] * kLn2;
        part.l[at] = l[r];
        part.gold[at] = gold[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kTok = 64;   // tokens per block
constexpr int kVt = 64;    // vocab columns per step

// 256 threads, thread (ty, tx) owns tokens ty + 16 a and columns tx + 16 b
// (a, b < 4) of each 64 x 64 tile, with D chunks of 32 staged in shared memory.
constexpr int kF32Threads = 256;
constexpr int kDcF = 32;
constexpr int kLdF = kDcF + 1;

__global__ void __launch_bounds__(kF32Threads)
xent_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int64_t* __restrict__ labels, Partials part, int t, int d, int v,
                int64_t x_st, int64_t w_sv, int64_t w_sd, int tiles_per_split) {
  __shared__ float xs[kTok][kLdF];
  __shared__ float ws[kVt][kLdF];
  const int t0 = blockIdx.x * kTok;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  int64_t lab[4];
  float m[4], l[4], gold[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int tok = t0 + ty + 16 * a;
    lab[a] = tok < t ? labels[tok] : -1;
    m[a] = kNegInf;
    l[a] = 0.f;
    gold[a] = 0.f;
  }
  const int col_begin = split * tiles_per_split * kVocabTile;
  const int col_end = min(v, col_begin + tiles_per_split * kVocabTile);
  for (int v0 = col_begin; v0 < col_end; v0 += kVt) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    }
    for (int d0 = 0; d0 < d; d0 += kDcF) {
      __syncthreads();
      for (int idx = tid; idx < kTok * kDcF; idx += kF32Threads) {
        const int r = idx / kDcF;
        const int c = idx % kDcF;
        const int tok = t0 + r;
        const int col = v0 + r;
        const int dd = d0 + c;
        xs[r][c] = (tok < t && dd < d) ? x[tok * x_st + dd] : 0.f;
        ws[r][c] = (col < v && dd < d) ? w[col * w_sv + dd * w_sd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDcF; ++c) {
        float xv[4], wv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = xs[ty + 16 * a][c];
#pragma unroll
        for (int b = 0; b < 4; ++b) wv[b] = ws[tx + 16 * b][c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xv[a], wv[b], acc[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = m[a];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = v0 + tx + 16 * b;
        if (col >= v) acc[a][b] = kNegInf;
        if (col == lab[a]) gold[a] += acc[a][b];
        mx = fmaxf(mx, acc[a][b]);
      }
      // the 16 threads of a token row are lanes of one half-warp
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      l[a] *= expf(m[a] - mx);
      m[a] = mx;
#pragma unroll
      for (int b = 0; b < 4; ++b) l[a] += expf(acc[a][b] - mx);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      l[a] += __shfl_xor_sync(0xffffffffu, l[a], off);
      gold[a] += __shfl_xor_sync(0xffffffffu, gold[a], off);
    }
    const int tok = t0 + ty + 16 * a;
    if (tx == 0 && tok < t) {
      const int64_t at = static_cast<int64_t>(split) * t + tok;
      part.m[at] = m[a];
      part.l[at] = l[a];
      part.gold[at] = gold[a];
    }
  }
}

// Merge the splits: lse = M + log(sum_s l_s exp(m_s - M)), loss = lse - gold,
// or 0 for a token whose label is ignore_index.
__global__ void xent_combine_kernel(Partials part, const int64_t* __restrict__ labels,
                                    float* __restrict__ loss, float* __restrict__ lse, int t,
                                    int n_split, int64_t ignore_index) {
  const int tok = blockIdx.x * blockDim.x + threadIdx.x;
  if (tok >= t) return;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part.m[static_cast<int64_t>(s) * t + tok]);
  float sum = 0.f;
  float gold = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const int64_t at = static_cast<int64_t>(s) * t + tok;
    sum += part.l[at] * expf(part.m[at] - mx);
    gold += part.gold[at];
  }
  const float out = mx + logf(fmaxf(sum, 1e-30f));
  lse[tok] = out;
  loss[tok] = labels[tok] == ignore_index ? 0.f : out - gold;
}

int launch_wgmma(const void* x, const void* w, const int64_t* labels, const Partials& parts,
                 int t, int d, int v, long long x_st, long long w_sv, int n_split,
                 int tiles_per_split, cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!hopper::encode_2d(&tx, x, d, t, x_st, kXtTok) ||
      !hopper::encode_2d(&tw, w, d, v, w_sv, kVocabTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = static_cast<int>(sizeof(XtShared)) + 1024;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      xent_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((t + kXtTok - 1) / kXtTok, n_split);
  xent_wgmma_kernel<<<grid, kXtThreads, kSmem, stream>>>(tx, tw, labels, parts, t, d, v,
                                                         tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Returns the first CUDA error of the two launches (0 on success). x is (T,D)
// with a dense last dimension and row stride x_st; w is the head as (V,D) rows
// read through strides (w_sv, w_sd), in elements; labels is a dense int64 (T,);
// loss and lse are dense fp32 (T,); part is fp32 scratch of 3 * n_split * T.
// Split s covers vocab tiles [s * tiles_per_split, (s + 1) * tiles_per_split)
// of 256 columns; the caller picks n_split * tiles_per_split >= ceil(V / 256).
// bf16 needs w_sd == 1 and 16-byte aligned bases and row strides of x and w
// (TMA describes them; the wrapper pads operands that are not), else the call
// returns cudaErrorInvalidValue without a launch.
extern "C" int fused_xent_fwd(int dtype, const void* x, const void* w, const void* labels,
                              void* loss, void* lse, void* part, int t, int d, int v,
                              long long x_st, long long w_sv, long long w_sd,
                              long long ignore_index, int n_split, int tiles_per_split,
                              void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t < 1 || d < 1 || v < 1 || n_split < 1 || tiles_per_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* p = static_cast<float*>(part);
  const int64_t stride = static_cast<int64_t>(n_split) * t;
  const Partials parts{p, p + stride, p + 2 * stride};
  const int64_t* lab = static_cast<const int64_t*>(labels);
  if (dtype == kBFloat16) {
    if (w_sd != 1) return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_wgmma(x, w, lab, parts, t, d, v, x_st, w_sv, n_split,
                                 tiles_per_split, st);
    if (err != 0) return err;
  } else if (dtype == kFloat32) {
    const dim3 grid((t + kTok - 1) / kTok, n_split);
    xent_f32_kernel<<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), lab, parts, t, d, v, x_st,
        w_sv, w_sd, tiles_per_split);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_combine_kernel<<<(t + 255) / 256, 256, 0, st>>>(parts, lab, static_cast<float*>(loss),
                                                        static_cast<float*>(lse), t, n_split,
                                                        ignore_index);
  return static_cast<int>(cudaGetLastError());
}
