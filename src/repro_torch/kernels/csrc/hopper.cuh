// Hopper (sm_90a) building blocks written as inline PTX: mbarriers, cp.async,
// TMA and bulk copies into shared memory, TMA stores and bulk reduce-adds out
// of it, named barriers, cluster barriers, wgmma descriptors and the
// warpgroup products the flash forward and backward and the fused
// cross-entropy use, and register reallocation between
// warpgroups. The tensor maps are encoded on the host through the driver's
// entry point, found at run time, so no library needs to link libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies global -> shared, the bytes past `src_bytes` zeroed
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// `count` arrivals at once.
__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed. A barrier starts in
// phase 0; waiting on parity 1 of a fresh barrier returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA: a 4-D box of a tensor map into shared memory, completion on an mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A 4-D box of shared memory out to a tensor map (the parts past the tensor's
// edges are not written); tracked by bulk groups (bulk_commit, bulk_wait_read).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A 2-D box of a tensor map into shared memory, completion on an mbarrier.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of contiguous
// global memory into shared memory, completion on an mbarrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// dst[i] += src[i] over `bytes` of fp32, shared -> global, done by the TMA unit
// as one asynchronous operation (atomic per element); tracked by bulk groups.
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most kPending bulk groups still reading their shared-memory source.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// At most kPending bulk groups not yet complete (writes done).
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Make this thread's ordinary shared-memory writes visible to the async proxy
// (wgmma operands, bulk copies out of shared memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive at named barrier `id` without waiting: a producer's half of a
// handshake whose consumers call named_sync with the same `count`.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Thread block clusters: every thread of every block of the cluster arrives,
// then waits; memory writes before it (release, cluster scope) are visible
// to the cluster's reads after it (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// 2^x in one MUFU.EX2 (flushes denormal results to zero; exp2f adds a range
// fix-up around each one).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Programmatic dependent launch: a kernel launched with programmatic stream
// serialization may start while the previous one runs; grid_wait blocks until
// that one has finished and its writes are visible. launch_dependents lets the
// next kernel start early. Both are no-ops without such a launch.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups (all four warps execute it)
// ---------------------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor for a tile written by TMA with the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units) and
// the layout type 1 (128B swizzle) in bits 62-63. Tiles start 1024-byte
// aligned, so the base offset is 0.
//   K-major (rows of 128 bytes along K): SBO = 1024 (one 8-row group), LBO
//   unused; stepping K by 16 bf16 adds 32 bytes to the start address.
//   MN-major (rows of 128 bytes along N, one row per K index): SBO = 1024
//   (8 K rows), LBO = the distance between two 64-wide N chunks.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep register operands of in-flight products alive (and unchanged) until
// this point: call after the wait_group that retires the products.
template <int N, int M>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" ::"r"(a[i][j]) : "memory");
  }
}

#define REPRO_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 128,
// bf16, shared, K-major: 128 rows of N each holding 16 K values).
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_R8(0), REPRO_R8(8), REPRO_R8(16), REPRO_R8(24), REPRO_R8(32), REPRO_R8(40),
        REPRO_R8(48), REPRO_R8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) (+)= A (64 x 16, bf16, shared) * B (16 x 64, bf16,
// shared). kTA / kTB = 0: K-major (rows along M or N, each holding 16 K
// values); 1: MN-major (one 128-byte row of M or N values per K index).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : REPRO_R8(0), REPRO_R8(8), REPRO_R8(16), REPRO_R8(24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
}

// d (64 x 256, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 256,
// bf16, shared, K-major).
__device__ __forceinline__ void wgmma_ss_m64n256k16(float (&d)[128], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_R8(0), REPRO_R8(8), REPRO_R8(16), REPRO_R8(24), REPRO_R8(32), REPRO_R8(40),
        REPRO_R8(48), REPRO_R8(56), REPRO_R8(64), REPRO_R8(72), REPRO_R8(80), REPRO_R8(88),
        REPRO_R8(96), REPRO_R8(104), REPRO_R8(112), REPRO_R8(120)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[kOff, kOff + 64) (64 x 128, fp32) += A (64 x 16, bf16, registers) * B
// (16 x 128, bf16, shared, MN-major: 16 K rows each holding 128 N values). The
// accumulator may be a wider one (64 x 2N over N / 8 fragments of 4 values
// each): columns [2 kOff, 2 kOff + 128) of it.
template <int kOff = 0, int N>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[N], const uint32_t (&a)[4],
                                                    uint64_t b) {
  static_assert(kOff % 32 == 0 && kOff + 64 <= N, "an n128 product's 64 values");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_R8(kOff), REPRO_R8(kOff + 8), REPRO_R8(kOff + 16), REPRO_R8(kOff + 24),
        REPRO_R8(kOff + 32), REPRO_R8(kOff + 40), REPRO_R8(kOff + 48), REPRO_R8(kOff + 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N = 64: d[kOff, kOff + 32).
template <int kOff = 0, int N>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[N], const uint32_t (&a)[4],
                                                   uint64_t b) {
  static_assert(kOff % 32 == 0 && kOff + 32 <= N, "an n64 product's 32 values");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_R8(kOff), REPRO_R8(kOff + 8), REPRO_R8(kOff + 16), REPRO_R8(kOff + 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_R8

// d (64 x kD, fp32) += A (64 x 16, bf16, registers) * B (16 x kD, bf16,
// shared, MN-major), B's 64-wide column chunks given by chunk(c) as
// descriptors (consecutive chunks a fixed distance apart, as the LBO says):
// one n64 product at kD = 64, else n128 products over chunk pairs and an n64
// for an odd last chunk.
template <int kD, typename Chunk>
__device__ __forceinline__ void wgmma_rs_over_d(float (&d)[kD / 2], const uint32_t (&a)[4],
                                                Chunk chunk) {
  static_assert(kD % 64 == 0 && kD >= 64 && kD <= 256, "kD is 64, 128, 192 or 256");
  if constexpr (kD == 64) {
    wgmma_rs_m64n64k16<0>(d, a, chunk(0));
  } else {
    wgmma_rs_m64n128k16<0>(d, a, chunk(0));
    if constexpr (kD == 192) wgmma_rs_m64n64k16<64>(d, a, chunk(2));
    if constexpr (kD == 256) wgmma_rs_m64n128k16<64>(d, a, chunk(2));
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; null if the driver
// does not offer it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor of shape (B, S, H, D) with element strides (sb, ss, sh, 1),
// read in boxes of 64 along D (128 bytes, the 128-byte swizzle's row) by
// `rows` along S, zero past each edge. Returns false if the driver refuses it
// (a base or stride not a multiple of 16 bytes).
inline bool encode_bshd(CUtensorMap* map, const void* base, int b, int s, int h, int d,
                        long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 matrix of `rows` rows of `cols` elements, rows `row_stride` elements
// apart, read in boxes of 64 columns (128 bytes, the 128-byte swizzle's row)
// by `box_rows` rows, zero past each edge. Returns false if the driver refuses
// it (a base or row stride not a multiple of 16 bytes).
inline bool encode_2d(CUtensorMap* map, const void* base, int cols, int rows,
                      long long row_stride, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_stride) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace repro_torch
