// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces: repro/kernels/rmsnorm.py::rmsnorm (`_kernel`), the Pallas
// kernel of every norm on the serve path (norm1, norm2 and the final norm
// of the dense family; norm1 and the final norm of Mamba2).
//
// Computes, for each row n of x [N, D]:
//   out[n] = x[n] * rsqrt(sum(x[n]^2) / D + eps) * (1 + w)
// in fp32, cast once to x's dtype (float32 or bfloat16; w has x's dtype).
//
// Bound: bytes. Each element is read once and written once and costs
// about 4 flops, far below the ~20 flop/byte the card needs in fp32 to be
// compute bound; the least time is (2 N D + D) * sizeof(T) over 3.35 TB/s.
//
// Design: the Pallas grid tiles rows and holds a whole [rows, D] block in
// VMEM. Here one block serves one row: each thread reads its share of the
// row with 16-byte loads (element by element where D * sizeof(T) is not a
// multiple of 16, so that every row stays aligned), the sum of squares is
// a warp-shuffle reduction and then one across the block's warps, and a
// second pass re-reads the row (from L1/L2, where the first pass left it),
// scales it and stores 16 bytes at a time. The eager model calls it on a
// few rows in decode (8 blocks leave most SMs idle) and on whole prefill
// chunks; keeping the row in registers between the passes and serving
// several short rows per block are for a later change.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// Store VEC = 16 / sizeof(T) floats as T, 16 bytes at a time.
__device__ __forceinline__ void store16(const float* v, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(const float* v, __nv_bfloat16* dst) {
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int D, float eps) {
  constexpr int VEC = kVec ? Vec16<T>::N : 1;
  const T* xr = x + (size_t)blockIdx.x * D;
  T* outr = out + (size_t)blockIdx.x * D;
  const int tid = threadIdx.x;

  float ss = 0.f;
  for (int i = tid * VEC; i < D; i += blockDim.x * VEC) {
    float v[VEC];
    if constexpr (kVec) {
      load16(xr + i, v);
    } else {
      v[0] = to_float(xr[i]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = fmaf(v[e], v[e], ss);
  }

  __shared__ float partial[kMaxThreads / 32];
  ss = warp_sum(ss);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / (float)D + eps);

  for (int i = tid * VEC; i < D; i += blockDim.x * VEC) {
    float v[VEC], g[VEC];
    if constexpr (kVec) {
      load16(xr + i, v);
      load16(w + i, g);
    } else {
      v[0] = to_float(xr[i]);
      g[0] = to_float(w[i]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = v[e] * inv * (1.f + g[e]);
    if constexpr (kVec) {
      store16(v, outr + i);
    } else {
      store_float(v[0], outr + i);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int N, int D,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  const bool vec = D % VEC == 0;         // every row starts 16-byte aligned
  const int units = vec ? D / VEC : D;
  const int threads = min(kMaxThreads, max(32, (units + 31) / 32 * 32));
  auto kernel = vec ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>;
  kernel<<<N, threads, 0, stream>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(w),
                                     static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). The pointers
// are 16-byte aligned and the tensors contiguous (the wrapper checks).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int N, int D, int dtype, float eps,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, N, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, N, D, eps, s);
  return cudaErrorInvalidValue;
}
