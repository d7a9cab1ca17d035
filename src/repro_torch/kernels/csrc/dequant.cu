// Dequant-on-upload for Hopper, sm_90a, with a plain C entry point for ctypes.
//
// Replaces: src/repro/kernels/dequant.py, dequant_rows -> _dequant8_kernel and
// _dequant4_kernel, the Pallas TPU kernels. It computes what they compute: rows
// of blockwise-absmax codes, each run of `block` elements sharing one fp32
// scale, widened and rescaled into compute-precision rows, out[r, e] =
// code[r, e] * scale[r, e / block], with one fp32 multiply per element and a
// round-to-nearest-even cast to the output type. The codes' storage is the
// format tag: int8 holds one code per element; uint8 holds two signed nibbles,
// element 2i in the low nibble of byte i and element 2i+1 in the high one, a
// nibble n read as n - 16 * (n >> 3).
//
// What bounds it on an H100: it is an elementwise pass with no reuse, so memory
// does. A qwen3-1.7b layer row (50,335,744 elements) moves 50 MB of int8 codes
// (25 MB of int4) and 0.8 MB of scales in and 101 MB of bf16 (201 MB of fp32)
// out: ~45 us per row for int8 -> bf16 at 3.35 TB/s.
//
// Design: the grid is (column chunks, rows); each thread owns 16 bytes of codes
// (16 int8 elements, or 32 int4 ones), read with one 16-byte load, and writes
// its elements with 16-byte stores. `block` is a multiple of 32, so a thread's
// elements share one scale, read once. Neighbouring threads touch neighbouring
// addresses on every load and store. The multiply and the cast are kept apart
// (__fmul_rn, __float2bfloat16_rn), so nothing is fused into them and the
// result equals the plain version's bit for bit.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kCodeBytes = 16;  // code bytes per thread

__device__ __forceinline__ int widen_nibble(int n) { return n - 16 * (n >> 3); }

template <typename Out>
__device__ __forceinline__ void store_pack(Out* dst, const float* v, int n);

// n elements (a multiple of 8) as 16-byte stores of 8 bf16.
template <>
__device__ __forceinline__ void store_pack<bf16>(bf16* dst, const float* v, int n) {
  for (int i = 0; i < n; i += 8) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16 lo = __float2bfloat16_rn(v[i + 2 * j]);
      const bf16 hi = __float2bfloat16_rn(v[i + 2 * j + 1]);
      w[j] = pack2(lo, hi);
    }
    *reinterpret_cast<uint4*>(dst + i) = u;
  }
}

// n elements (a multiple of 4) as 16-byte stores of 4 fp32.
template <>
__device__ __forceinline__ void store_pack<float>(float* dst, const float* v, int n) {
  for (int i = 0; i < n; i += 4) {
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// One thread: 16 code bytes of row blockIdx.y, starting at code byte
// 16 * (blockIdx.x * kThreads + threadIdx.x).
template <bool kPacked, typename Out>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
               Out* __restrict__ out, int64_t code_cols, int64_t n_blocks, int block) {
  constexpr int kElems = kPacked ? 2 * kCodeBytes : kCodeBytes;
  const int64_t row = blockIdx.y;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kCodeBytes;
  if (c0 >= code_cols) return;
  const int64_t e0 = kPacked ? 2 * c0 : c0;
  const uint4 raw = *reinterpret_cast<const uint4*>(codes + row * code_cols + c0);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  const float s = scales[row * n_blocks + e0 / block];
  float v[kElems];
#pragma unroll
  for (int i = 0; i < kCodeBytes; ++i) {
    if (kPacked) {
      v[2 * i] = __fmul_rn(static_cast<float>(widen_nibble(b[i] & 0xF)), s);
      v[2 * i + 1] = __fmul_rn(static_cast<float>(widen_nibble((b[i] >> 4) & 0xF)), s);
    } else {
      v[i] = __fmul_rn(static_cast<float>(static_cast<int8_t>(b[i])), s);
    }
  }
  store_pack<Out>(out + row * n_blocks * block + e0, v, kElems);
}

template <bool kPacked, typename Out>
void launch(const void* codes, const float* scales, void* out, int rows, int64_t code_cols,
            int64_t n_blocks, int block, cudaStream_t st) {
  const int64_t threads_per_row = code_cols / kCodeBytes;
  const dim3 grid(static_cast<unsigned>((threads_per_row + kThreads - 1) / kThreads), rows);
  dequant_kernel<kPacked, Out><<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(codes), scales, static_cast<Out*>(out), code_cols, n_blocks,
      block);
}

}  // namespace
}  // namespace repro_torch

// codes: (rows, code_cols) int8 (packed = 0) or uint8 nibble pairs (packed = 1);
// scales: (rows, n_blocks) fp32; out: (rows, n_blocks * block) of out_dtype. All
// dense and 16-byte aligned; block a multiple of 32; code_cols equal to
// n_blocks * block (int8) or n_blocks * block / 2 (int4). Returns the CUDA error
// of the launch (0 when it was accepted).
extern "C" int dequant_rows(int packed, int out_dtype, const void* codes, const void* scales,
                            void* out, int rows, long long code_cols, long long n_blocks,
                            int block, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long elems = packed ? 2 * code_cols : code_cols;
  if (rows < 1 || rows > 65535 || block < 32 || block % 32 || n_blocks < 1 ||
      elems != n_blocks * block || (packed != 0 && packed != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* sc = static_cast<const float*>(scales);
  if (out_dtype == kBFloat16) {
    if (packed) {
      launch<true, bf16>(codes, sc, out, rows, code_cols, n_blocks, block, st);
    } else {
      launch<false, bf16>(codes, sc, out, rows, code_cols, n_blocks, block, st);
    }
  } else if (out_dtype == kFloat32) {
    if (packed) {
      launch<true, float>(codes, sc, out, rows, code_cols, n_blocks, block, st);
    } else {
      launch<false, float>(codes, sc, out, rows, code_cols, n_blocks, block, st);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
