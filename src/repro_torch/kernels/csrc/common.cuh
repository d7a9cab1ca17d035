// Shared helpers of the attention kernels: 16-byte loads that widen to fp32,
// and the scalar conversions, for the two element types the kernels take.
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
};

}  // namespace repro_torch
