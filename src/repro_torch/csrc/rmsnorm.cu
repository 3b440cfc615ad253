// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces: repro/kernels/rmsnorm.py::rmsnorm (`_kernel`), the Pallas
// kernel of every norm on the serve path (norm1, norm2 and the final norm
// of the dense family; norm1 and the final norm of Mamba2).
//
// Computes, for each row n of x [N, D]:
//   out[n] = x[n] * rsqrt(sum(x[n]^2) * (1 / D) + eps) * (1 + w)
// in fp32, cast once to x's dtype (float32 or bfloat16; w has x's dtype).
//
// Bound: bytes. Each element is read once and written once and costs
// about 4 flops, far below the ~20 flop/byte the card needs in fp32 to be
// compute bound; the least time is (2 N D + D) * sizeof(T) over 3.35 TB/s.
//
// Design: the Pallas grid tiles rows and holds a whole [rows, D] block in
// VMEM. Here a row lives in registers from its one read to its write:
// `wpr` warps serve a row, each lane holding U 16-byte units of it, read
// interleaved so that neighbouring lanes load neighbouring 16 bytes,
// beside the same units of w. A row takes as many warps as hold it at 4
// units a lane (3 warps for a 3072-wide bf16 row, 6 for f32), at most 8,
// beyond which U grows to 16 (32768 bf16 or 16384 f32 elements): with
// fewer units a lane, a decode batch of a few rows spreads over more SMs
// and each SM's load queue is shorter. Every load is issued before the
// first is used: a warp issues in order, and a load consumed in the step
// that issues the next one serializes them (the first version of this
// design did, and was 1.6x slower than one block a row). Widths that are
// not a multiple of 16 bytes go element by element, so that every row
// stays aligned. The squares are summed by a warp butterfly and, for a
// row of several warps, the warps' sums from shared memory in warp order:
// for f32 rows in fp64, where each square is exact and a sum of at most
// 2^15 of them errs far below one f32 ulp, so the sum rounded once to f32
// does not depend, in practice, on the order (f32 is the parity dtype,
// and its int8 pages amplify last-bit differences into int8 steps); for
// bf16 rows in fp32, where each square is exact and the bf16 output
// absorbs the order's last bits. A row's bits do not depend on N: a row
// of the 8-row decode batch equals the same row in a 1024-row prefill
// chunk. A block of up to four warps serves 4 / wpr rows. The wrapper
// derives (vector path, wpr, U, rows per block) from D and the dtype
// alone. Decode-sized launches (a few rows) stay bound by launch latency,
// not bytes; CUDA graphs and fusing the norm into its neighbours are the
// levers there.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;   // warps per block (and per row) at most

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

// 16 raw bytes of T as floats
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) dst[i] = to_float(e[i]);
}

template <typename T, bool kVec, int U>
__global__ void __launch_bounds__(kMaxWarps * 32)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int N, int D, int wpr, float eps) {
  constexpr int VEC = kVec ? Vec16<T>::N : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_per_block = (blockDim.x >> 5) / wpr;
  const int row = blockIdx.x * rows_per_block + warp / wpr;
  const int first = (warp / wpr) * wpr;   // the row's first warp
  const int units = D / VEC;
  const int stride = 32 * wpr;
  const int u0 = (warp - first) * 32 + lane;
  const bool live = row < N;
  const T* xr = x + (size_t)(live ? row : 0) * D;

  // the row's units u0 + stride q, q < U, and the same units of w, all
  // loaded before any is used: a warp issues in order, so a load consumed
  // in the same step as the next one is issued would serialize them
  uint4 raw[kVec ? U : 1], wraw[kVec ? U : 1];
  float sc[kVec ? 1 : U], wsc[kVec ? 1 : U];
#pragma unroll
  for (int q = 0; q < U; ++q) {
    const int u = u0 + q * stride;
    const bool in = live && u < units;
    if constexpr (kVec) {
      raw[q] = wraw[q] = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        raw[q] = __ldg(reinterpret_cast<const uint4*>(xr + u * VEC));
        wraw[q] = __ldg(reinterpret_cast<const uint4*>(w + u * VEC));
      }
    } else {
      sc[q] = in ? to_float(xr[u]) : 0.f;
      wsc[q] = in ? to_float(w[u]) : 0.f;
    }
  }
  // f32 rows sum their squares in fp64, bf16 rows in fp32 (Acc)
  using Acc = typename std::conditional<sizeof(T) == 4, double, float>::type;
  Acc ss = 0;
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if constexpr (kVec) {
      float v[VEC];
      unpack16<T>(raw[q], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fma((Acc)v[e], (Acc)v[e], ss);
    } else {
      ss = fma((Acc)sc[q], (Acc)sc[q], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (wpr > 1) {                          // uniform across the block
    __shared__ Acc partial[kMaxWarps];
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    ss = 0;
    for (int q = 0; q < wpr; ++q) ss += partial[first + q];
  }
  if (!live) return;
  // the sum rounded once to f32, and the mean formed from it as the plain
  // version's torch.mean forms it: the sum times 1/D
  const float inv = rsqrtf((float)ss * (1.f / (float)D) + eps);

  T* outr = out + (size_t)row * D;
#pragma unroll
  for (int q = 0; q < U; ++q) {
    const int u = u0 + q * stride;
    if (u >= units) break;
    if constexpr (kVec) {
      float v[VEC], g[VEC];
      unpack16<T>(raw[q], v);
      unpack16<T>(wraw[q], g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = v[e] * inv * (1.f + g[e]);
      store16(v, outr + u * VEC);
    } else {
      store_float(sc[q] * inv * (1.f + wsc[q]), outr + u);
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch_vec(const void* x, const void* w, void* out, int N, int D,
                       int wpr, int upl, int rows_per_block, float eps,
                       cudaStream_t stream) {
  const int threads = 32 * wpr * rows_per_block;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
#define RMS_CASE(UU)                                                      \
  case UU:                                                                \
    rmsnorm_kernel<T, kVec, UU><<<blocks, threads, 0, stream>>>(          \
        xt, wt, ot, N, D, wpr, eps);                                      \
    break
  switch (upl) {
    RMS_CASE(1);
    RMS_CASE(2);
    RMS_CASE(4);
    RMS_CASE(8);
    RMS_CASE(12);
    RMS_CASE(16);
    default:
      return cudaErrorInvalidValue;
  }
#undef RMS_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int N, int D,
                   int vec, int wpr, int upl, int rows_per_block, float eps,
                   cudaStream_t stream) {
  if (wpr < 1 || rows_per_block < 1 || wpr * rows_per_block > kMaxWarps)
    return cudaErrorInvalidValue;
  if (vec) return launch_vec<T, true>(x, w, out, N, D, wpr, upl,
                                      rows_per_block, eps, stream);
  return launch_vec<T, false>(x, w, out, N, D, wpr, upl, rows_per_block,
                              eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). The pointers
// are 16-byte aligned and the tensors contiguous. vec (16-byte units,
// D * sizeof(T) a multiple of 16), wpr (warps per row), upl (units per
// lane: 1, 2, 4, 8, 12 or 16) and rows_per_block come from the wrapper's
// plan, a function of D and the dtype alone; wpr * rows_per_block <= 8.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int N, int D, int dtype, float eps, int vec,
                              int wpr, int upl, int rows_per_block,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, out, N, D, vec, wpr, upl, rows_per_block, eps,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, N, D, vec, wpr, upl,
                                 rows_per_block, eps, s);
  return cudaErrorInvalidValue;
}
