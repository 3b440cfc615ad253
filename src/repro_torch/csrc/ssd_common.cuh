// Helpers shared by the scan's forward (csrc/ssd_scan.cu) and backward
// (csrc/ssd_scan_bwd.cu) kernels.
#pragma once

#include "common.cuh"

namespace {

// The chunk's dt (0 at or past `valid`) into dtv, by every thread of the
// block, its loads issued before they are stored. chunk <= 8 blockDim.
__device__ __forceinline__ void load_dt(const float* __restrict__ dt_row,
                                        int nh, int valid, int chunk,
                                        float* dtv) {
  float v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int t = threadIdx.x + q * blockDim.x;
    v[q] = t < valid ? dt_row[(size_t)t * nh] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int t = threadIdx.x + q * blockDim.x;
    if (t < chunk) dtv[t] = v[q];
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kPad = 8;       // bf16 padding per shared-memory row (16 bytes)

// f32 inputs carry a lo half beside each bf16 tile; bf16 inputs are exact
template <typename T>
constexpr int kHalves = sizeof(T) == 4 ? 2 : 1;

// Rows [0, rows) of `cols` (a multiple of 8) elements, `stride` elements
// apart in global memory from src, into the bf16 tile hi [rows][ld] and,
// for f32, lo; rows at or past `valid` read as 0. bf16 by cp.async (the
// caller commits and waits), f32 through registers, split into hi + lo,
// in rounds of kBatch loads a thread that are all issued before the first
// is used (a warp issues in order: a load used at once would serialize).
constexpr int kBatch = 8;
template <typename T>
__device__ __forceinline__ void load_tile(__nv_bfloat16* hi, int ld,
                                          const T* __restrict__ src,
                                          size_t stride, int rows, int cols,
                                          int valid) {
  const int per_row = cols / 8;
  const int total = rows * per_row;
  if constexpr (sizeof(T) == 2) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / per_row, c = (i % per_row) * 8;
      const bool in = r < valid;
      cp_async16(smem_u32(hi + r * ld + c),
                 src + (in ? (size_t)r * stride : 0) + c, in ? 16 : 0);
    }
  } else {
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
      float v[kBatch][8];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * blockDim.x;
        const int r = i / per_row, c = (i % per_row) * 8;
        if (i < total && r < valid) {
          load16(src + (size_t)r * stride + c, v[q]);
          load16(src + (size_t)r * stride + c + 4, v[q] + 4);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[q][e] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * blockDim.x;
        if (i >= total) break;
        const int r = i / per_row, c = (i % per_row) * 8;
        uint4 h, l;
        uint32_t* hp = reinterpret_cast<uint32_t*>(&h);
        uint32_t* lp = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_bf16(v[q][2 * e], v[q][2 * e + 1], hp[e], lp[e]);
        *reinterpret_cast<uint4*>(hi + r * ld + c) = h;
        *reinterpret_cast<uint4*>(hi + rows * ld + r * ld + c) = l;
      }
    }
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__low2float(b), __high2float(b));
}

}  // namespace
