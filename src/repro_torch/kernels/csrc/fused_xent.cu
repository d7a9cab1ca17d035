// Fused LM-head cross-entropy forward for Hopper, sm_90a, with a plain C entry
// point for ctypes.
//
// Replaces: src/repro/kernels/fused_xent.py, fused_xent -> _xent_kernel, the
// Pallas TPU kernel. It computes what that kernel computes, the per-token loss
// lse(x W) - (x W)[label], streaming the vocabulary so that the (T,V) logits
// never reach device memory, and also writes the per-token log-sum-exp that the
// backward reuses. Beyond the TPU kernel it takes ragged T and V (151936 is not
// a multiple of any power-of-two tile), gives tokens whose label is
// ignore_index a loss of 0, and reads W through two strides, so the tied head
// (the (V,D) embedding itself) is read in place and never copied.
//
// What bounds it on an H100: at the training shapes (T=2048, D=2048, V=151936,
// bf16) the product x W is ~1.27 TFLOP against ~0.63 GB of W, so the tensor
// cores bound it (~1.3 ms at 989 TFLOP/s), not memory (~0.19 ms).
//
// Design:
//   * one block owns 64 tokens and one contiguous range of 64-column vocab
//     tiles; the grid is (token blocks, vocab splits), with enough splits to
//     fill the card even at small T. Token blocks of one split run side by
//     side and stream the same W tiles, so W is mostly read from L2;
//   * each vocab tile's logits are summed over D in 64-wide chunks staged in
//     shared memory; bf16 runs both operands on mma.sync m16n8k16 (4 warps of
//     16 tokens, fp32 accumulate), fp32 runs scalar FMAs (256 threads, a 4x4
//     micro-tile each);
//   * the running max, the running sum and the gold logit stay in registers
//     (the TPU kernel's VMEM scratch); each block writes its split's three
//     partials, and a second small kernel merges the splits into the loss and
//     the log-sum-exp. The masks of ignore_index and of the ragged vocabulary
//     tail live in these two kernels: there is no second pass over (T,V).
// No load pipeline yet: a chunk's loads and products do not overlap.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTok = 64;   // tokens per block
constexpr int kVt = 64;    // vocab columns per tile
constexpr int kDc = 64;    // D chunk (bf16)
constexpr int kLdB = kDc + 8;  // bf16 smem row stride: +16 bytes, conflict-free fragments
constexpr int kMmaThreads = 128;

// Partial state of one split: running max, running sum and gold logit per token.
struct Partials {
  float* m;
  float* l;
  float* gold;
};

__global__ void __launch_bounds__(kMmaThreads)
xent_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int64_t* __restrict__ labels, Partials part, int t, int d, int v,
                int64_t x_st, int64_t w_sv, int64_t w_sd, int tiles_per_split, bool xvec,
                bool wvec) {
  __shared__ __align__(16) bf16 xs[kTok][kLdB];
  __shared__ __align__(16) bf16 ws[kVt][kLdB];
  const int t0 = blockIdx.x * kTok;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int rows[2] = {t0 + warp * 16 + g, t0 + warp * 16 + g + 8};
  int64_t lab[2];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};     // this thread's share of each row's sum
  float gold[2] = {0.f, 0.f};  // this thread's share of each row's gold logit
#pragma unroll
  for (int r = 0; r < 2; ++r) lab[r] = rows[r] < t ? labels[rows[r]] : -1;

  const int n_vtiles = (v + kVt - 1) / kVt;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_vtiles, vt_begin + tiles_per_split);
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * kVt;
    float acc[kVt / 8][4];
#pragma unroll
    for (int nt = 0; nt < kVt / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
    for (int d0 = 0; d0 < d; d0 += kDc) {
      __syncthreads();  // every warp is done with the previous chunk
      for (int idx = tid; idx < kTok * (kDc / 8); idx += kMmaThreads) {
        const int r = idx / (kDc / 8);
        const int c = (idx % (kDc / 8)) * 8;
        const int tok = t0 + r;
        load8(&xs[r][c], x + tok * x_st + d0, c, d - d0, tok < t, xvec);
        const int col = v0 + r;
        if (w_sd == 1) {
          load8(&ws[r][c], w + col * w_sv + d0, c, d - d0, col < v, wvec);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int dd = d0 + c + e;
            ws[r][c + e] = (col < v && dd < d) ? w[col * w_sv + dd * w_sd] : __float2bfloat16(0.f);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDc / 16; ++kk) {
        const bf16* xr0 = &xs[warp * 16 + g][kk * 16 + 2 * tq];
        const bf16* xr1 = &xs[warp * 16 + g + 8][kk * 16 + 2 * tq];
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(xr0),
                               *reinterpret_cast<const uint32_t*>(xr1),
                               *reinterpret_cast<const uint32_t*>(xr0 + 8),
                               *reinterpret_cast<const uint32_t*>(xr1 + 8)};
#pragma unroll
        for (int nt = 0; nt < kVt / 8; ++nt) {
          const bf16* wr = &ws[nt * 8 + g][kk * 16 + 2 * tq];
          mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(wr),
                   *reinterpret_cast<const uint32_t*>(wr + 8));
        }
      }
    }

    // online log-sum-exp over this tile; C value e sits at row g (+8 for e >= 2),
    // column 2 tq + (e & 1) of each 8-column tile
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kVt / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + nt * 8 + 2 * tq + (e & 1);
        if (col >= v) acc[nt][e] = kNegInf;
        if (col == lab[e >> 1]) gold[e >> 1] += acc[nt][e];
        mx[e >> 1] = fmaxf(mx[e >> 1], acc[nt][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      l[r] *= expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < kVt / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += expf(acc[nt][e] - m[e >> 1]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    gold[r] += __shfl_xor_sync(0xffffffffu, gold[r], 1);
    gold[r] += __shfl_xor_sync(0xffffffffu, gold[r], 2);
    if (tq == 0 && rows[r] < t) {
      const int64_t at = static_cast<int64_t>(split) * t + rows[r];
      part.m[at] = m[r];
      part.l[at] = l[r];
      part.gold[at] = gold[r];
    }
  }
}

// fp32: 256 threads, thread (ty, tx) owns tokens ty + 16 a and columns tx + 16 b
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
  const int n_vtiles = (v + kVt - 1) / kVt;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_vtiles, vt_begin + tiles_per_split);
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * kVt;
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

bool aligned16(const void* p, long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % 8 == 0;
}

}  // namespace
}  // namespace repro_torch

// Returns the first CUDA error of the two launches (0 on success). x is (T,D)
// with a dense last dimension and row stride x_st; w is the head as (V,D) rows
// read through strides (w_sv, w_sd), in elements; labels is a dense int64 (T,);
// loss and lse are dense fp32 (T,); part is fp32 scratch of 3 * n_split * T.
// Split s covers vocab tiles [s * tiles_per_split, (s + 1) * tiles_per_split)
// of 64 columns; the caller picks n_split * tiles_per_split >= ceil(V / 64).
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
  const dim3 grid((t + kTok - 1) / kTok, n_split);
  if (dtype == kBFloat16) {
    xent_mma_kernel<<<grid, kMmaThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), lab, parts, t, d, v, x_st,
        w_sv, w_sd, tiles_per_split, aligned16(x, x_st), w_sd == 1 && aligned16(w, w_sv));
  } else if (dtype == kFloat32) {
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
