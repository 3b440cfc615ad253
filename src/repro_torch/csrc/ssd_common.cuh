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

}  // namespace
