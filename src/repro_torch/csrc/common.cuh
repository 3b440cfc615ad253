// Helpers shared by the CUDA kernels of repro_torch. Each
// csrc/<name>.cu includes this once and builds into a library of its own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The Pallas kernels' "minus infinity": finite, so that max/exp of a row
// with nothing visible stay finite and the `alive` guard can test it.
#define ATTN_NEG_INF (-1e30f)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// Load 16 bytes of T from global memory (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) dst[i] = to_float(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cp.async (sm_80 and later): 16-byte copies from global to shared
// memory that run while the thread goes on, in commit groups.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The bytes past `src_bytes` (0 or 16) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tensor cores through mma.sync (sm_80 and later), bf16 in, fp32
// accumulate, and ldmatrix loads of their fragments from shared memory.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one 16 x 8 tile: a the 16 x 16 bf16 row-major fragment,
// b the 16 x 8 column-major one, c fp32. Not `volatile`: a pure function
// of its registers, so the compiler may interleave the products of
// independent accumulators instead of issuing each behind the one it
// waits on (a product's order on its own accumulator stays as written).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Dynamic shared memory above the default 48 KB must be asked for.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Returns launch<T, D>(...) for the wrapper's dtype code (0 = float32,
// 1 = bfloat16: DTYPES in kernels/build.py) and head dim D of 64, 128 or
// 256 (HEAD_DIMS there), and cudaErrorInvalidValue for any other pair.
#define DISPATCH_DTYPE_HEAD_DIM(dtype, D, ...)                          \
  do {                                                                  \
    if ((dtype) == 0 && (D) == 64) return launch<float, 64>(__VA_ARGS__); \
    if ((dtype) == 0 && (D) == 128)                                     \
      return launch<float, 128>(__VA_ARGS__);                           \
    if ((dtype) == 0 && (D) == 256)                                     \
      return launch<float, 256>(__VA_ARGS__);                           \
    if ((dtype) == 1 && (D) == 64)                                      \
      return launch<__nv_bfloat16, 64>(__VA_ARGS__);                    \
    if ((dtype) == 1 && (D) == 128)                                     \
      return launch<__nv_bfloat16, 128>(__VA_ARGS__);                   \
    if ((dtype) == 1 && (D) == 256)                                     \
      return launch<__nv_bfloat16, 256>(__VA_ARGS__);                   \
    return cudaErrorInvalidValue;                                       \
  } while (0)

// CUDA's string for an error code that a launch function returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
