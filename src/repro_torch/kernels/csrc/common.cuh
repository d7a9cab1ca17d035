// Shared helpers of the kernels: 16-byte (and 8- or 4-byte) loads that widen to
// fp32, the scalar conversions for the two element types the kernels take, and
// the bf16 tensor-core helpers (bf16 pair packing, mma.sync fragments).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Element types as the Python wrappers number them.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// The online softmax masks with the same finite value as the reference, so a
// row whose first scores are all masked behaves as it does there.
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPack = 4;  // elements in 16 bytes
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float from_float(float x) { return x; }
  __device__ __forceinline__ static float zero() { return 0.f; }
  // p must be 16-byte aligned.
  __device__ __forceinline__ static void load_pack(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  // P (2 or 4) elements at p, aligned to P elements.
  template <int P>
  __device__ __forceinline__ static void load_small(const float* p, float* out) {
    if constexpr (P == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    } else {
      static_assert(P == 2, "load_small takes 2 or 4 elements");
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x;
      out[1] = v.y;
    }
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPack = 8;
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
  __device__ __forceinline__ static __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
  __device__ __forceinline__ static void load_pack(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  template <int P>
  __device__ __forceinline__ static void load_small(const __nv_bfloat16* p, float* out) {
    static_assert(P == 2 || P == 4, "load_small takes 2 or 4 elements");
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < P / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// The scans' staging of inputs that 16-byte copies cannot take: total elements,
// src(p) read and dst(p, value) written, eight loads in flight a thread before
// their stores.
template <typename T, int kThreads, typename Src, typename Dst>
__device__ __forceinline__ void copy_scalar(int total, Src src, Dst dst) {
  constexpr int kBatch = 8;
  for (int p0 = threadIdx.x; p0 < total; p0 += kThreads * kBatch) {
    T tmp[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      tmp[u] = p < total ? src(p) : Elem<T>::zero();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      if (p < total) dst(p, tmp[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core helpers: mma.sync m16n8k16 and its operand packing
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  const __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a (16x16, row-major fragment) * b (16x8, column-major fragment), fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro_torch
