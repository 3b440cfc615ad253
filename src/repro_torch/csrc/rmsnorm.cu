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

// ---------------------------------------------------------------- backward
//
// The gradient of the norm. No Pallas kernel computes it: the JAX training
// path differentiates repro/models/layers.py::rmsnorm (models/layers.py:26)
// with XLA's autodiff. For each row n, with r = rsqrt(sum(x[n]^2) / D +
// eps) recomputed as the forward computes it and u = dy[n] * (1 + w):
//   dx[n] = r * u - x[n] * (r^3 * sum(u * x[n]) / D)    in x's dtype
//   dw    = sum over rows of dy[n] * x[n] * r          in fp32
//
// Bound: bytes. x and dy are read once and dx written once (3 N D
// elements), w read and dw written once, at about 10 flops an element: at
// f32 [1024, 3072] 37.8 MB, 0.0113 ms at 3.35 TB/s; at [1024, 768] 9.4 MB,
// 0.0028 ms.
//
// Design: a plan of its own (kernels/rmsnorm.py::bwd_plan), a function of
// D and the dtype alone: as many warps a row as hold it at 8 units a lane,
// so one warp a row up to f32 D 1024 and bf16 D 2048, and as many row
// groups as fill an 8-warp block. A group takes one row while the rows fit
// 264 blocks (two a SM), every (blocks * groups)-th row past that, and a
// row's x, dy and w stay in registers from their one read to the write of
// dx, every load issued before the first is used. The row's two sums (x^2,
// and u * x) reduce as the forward's one: a warp butterfly, then the row's
// warps in warp order through shared memory (double-buffered, one barrier
// a row), in fp64 for f32 rows and fp32 for bf16 rows. So r is the
// forward's, and a row's dx depends on D and the dtype alone, never on N
// or on the group that takes the row. dw in fixed-order steps, no
// atomics: each group sums its rows' dy x r in its row of shared memory
// (each lane its own elements: in registers they would cost a bf16 lane 64
// and the card one of its two blocks an SM); a block sums its groups in
// group order into its row of `part` [blocks, D] (fp32); then the dw
// pass, one block per 8-column tile (96 blocks at D 768, 384 at D 3072),
// 32 row slabs of part a column each summed by a thread, then the slabs
// in order. dw is the same, bit for bit, from run to run at a given N.
// The dw pass is launched as the row kernel's programmatic dependent, so
// its launch overlaps the rows' tail.

// Store n floats (a multiple of 4, 16-byte aligned), 16 bytes at a time.
template <int n>
__device__ __forceinline__ void store_floats(const float* v, float* dst) {
#pragma unroll
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <typename T, bool kVec, int U>
__global__ void __launch_bounds__(kMaxWarps * 32)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, int N, int D, int wpr,
                       float eps) {
  constexpr int VEC = kVec ? Vec16<T>::N : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (blockDim.x >> 5) / wpr;   // row groups a block
  const int g = warp / wpr;
  const int first = g * wpr;              // the group's first warp
  const int units = D / VEC;
  const int stride = 32 * wpr;
  const int u0 = (warp - first) * 32 + lane;
  const int n_groups = gridDim.x * groups;
  // the dw pass may be set up now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");

  // this lane's units of w (1 + w formed where used); its dw sums in the
  // group's row of shared memory, which only this lane touches until the
  // block's sum (registers would cost 64 a lane in bf16, and the rows of
  // two blocks an SM)
  extern __shared__ __align__(16) float red[];   // [groups][D]
  float* acc = red + (size_t)g * D;
  uint4 wr[kVec ? U : 1];
  float ws[kVec ? 1 : U];
#pragma unroll
  for (int q = 0; q < U; ++q) {
    const int u = u0 + q * stride;
    if constexpr (kVec) {
      wr[q] = u < units ? __ldg(reinterpret_cast<const uint4*>(w + u * VEC))
                        : make_uint4(0u, 0u, 0u, 0u);
      if (u < units) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(acc + u * VEC + e) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      ws[q] = u < units ? to_float(w[u]) : 0.f;
      if (u < units) acc[u] = 0.f;
    }
  }

  using Acc = typename std::conditional<sizeof(T) == 4, double, float>::type;
  __shared__ Acc partial[2][2][kMaxWarps];   // [row parity][sum][warp]
  int parity = 0;
  // base is uniform across the block, so every thread takes the same
  // number of steps and meets the same barriers
  for (int base = blockIdx.x * groups; base < N; base += n_groups) {
    const int row = base + g;
    const bool live = row < N;
    const size_t off = (size_t)(live ? row : 0) * D;
    // the row's x and dy units, all loaded before any is used
    uint4 xr[kVec ? U : 1], dr[kVec ? U : 1];
    float xs[kVec ? 1 : U], ds[kVec ? 1 : U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int u = u0 + q * stride;
      const bool in = live && u < units;
      if constexpr (kVec) {
        xr[q] = dr[q] = make_uint4(0u, 0u, 0u, 0u);
        if (in) {
          xr[q] = __ldg(reinterpret_cast<const uint4*>(x + off + u * VEC));
          dr[q] = __ldg(reinterpret_cast<const uint4*>(dy + off + u * VEC));
        }
      } else {
        xs[q] = in ? to_float(x[off + u]) : 0.f;
        ds[q] = in ? to_float(dy[off + u]) : 0.f;
      }
    }
    Acc ss = 0, sux = 0;
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if constexpr (kVec) {
        float xv[VEC], dv[VEC], gv[VEC];
        unpack16<T>(xr[q], xv);
        unpack16<T>(dr[q], dv);
        unpack16<T>(wr[q], gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fma((Acc)xv[e], (Acc)xv[e], ss);
          sux = fma((Acc)(dv[e] * (1.f + gv[e])), (Acc)xv[e], sux);
        }
      } else {
        ss = fma((Acc)xs[q], (Acc)xs[q], ss);
        sux = fma((Acc)(ds[q] * (1.f + ws[q])), (Acc)xs[q], sux);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sux += __shfl_xor_sync(0xffffffffu, sux, o);
    }
    if (wpr > 1) {                        // uniform across the block
      if (lane == 0) {
        partial[parity][0][warp] = ss;
        partial[parity][1][warp] = sux;
      }
      __syncthreads();
      ss = 0;
      sux = 0;
      for (int q = 0; q < wpr; ++q) {
        ss += partial[parity][0][first + q];
        sux += partial[parity][1][first + q];
      }
      parity ^= 1;
    }
    if (!live) continue;
    // the raw units pass an empty asm, so the values unpacked for the sums
    // are not kept for the outputs (3 x 64 floats a bf16 lane at 8 units,
    // 235 registers and one block an SM): they are unpacked again
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < U; ++q)
        asm volatile("" : "+r"(xr[q].x), "+r"(xr[q].y), "+r"(xr[q].z),
                     "+r"(xr[q].w), "+r"(dr[q].x), "+r"(dr[q].y),
                     "+r"(dr[q].z), "+r"(dr[q].w), "+r"(wr[q].x),
                     "+r"(wr[q].y), "+r"(wr[q].z), "+r"(wr[q].w));
    }
    // r as the forward forms it, then r^3 times the mean of u * x
    const float inv = rsqrtf((float)ss * (1.f / (float)D) + eps);
    const float c = inv * inv * inv * ((float)sux * (1.f / (float)D));
    T* dxr = dx + off;
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int u = u0 + q * stride;
      if (u >= units) break;
      if constexpr (kVec) {
        float xv[VEC], dv[VEC], gv[VEC], o[VEC], a[VEC];
        unpack16<T>(xr[q], xv);
        unpack16<T>(dr[q], dv);
        unpack16<T>(wr[q], gv);
        float* ap = acc + u * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ap + e);
          a[e] = v.x;
          a[e + 1] = v.y;
          a[e + 2] = v.z;
          a[e + 3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          o[e] = inv * (dv[e] * (1.f + gv[e])) - xv[e] * c;
          a[e] = fmaf(dv[e] * xv[e], inv, a[e]);
        }
        store16(o, dxr + u * VEC);
        store_floats<VEC>(a, ap);
      } else {
        store_float(inv * (ds[q] * (1.f + ws[q])) - xs[q] * c, dxr + u);
        acc[u] = fmaf(ds[q] * xs[q], inv, acc[u]);
      }
    }
  }

  // the groups' dw sums, in group order, into the block's row of part
  // (zeros for a group that took no row)
  __syncthreads();
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < groups; ++q) s += red[(size_t)q * D + j];
    part[(size_t)blockIdx.x * D + j] = s;
  }
}

// dw[j] = sum over part's P rows: block b takes columns [8 b, 8 b + 8),
// thread (c, s) sums rows s, s + 32, ... of column 8 b + c, then thread c
// sums the 32 slabs in order. A warp reads 4 rows of 8 columns, 32 bytes
// each. Launched as the row kernel's programmatic dependent: it waits for
// that grid's completion before it reads part.
constexpr int kDwCols = 8, kDwSlabs = 32;
__global__ void __launch_bounds__(kDwCols * kDwSlabs)
    rmsnorm_dw_kernel(const float* __restrict__ part, float* __restrict__ dw,
                      int P, int D) {
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the rows' part
  const int c = threadIdx.x % kDwCols, s = threadIdx.x / kDwCols;
  const int j = blockIdx.x * kDwCols + c;
  __shared__ float red[kDwSlabs][kDwCols];
  float acc = 0.f;
  if (j < D) {
#pragma unroll 8
    for (int r = s; r < P; r += kDwSlabs) acc += part[(size_t)r * D + j];
  }
  red[s][c] = acc;
  __syncthreads();
  if (s == 0 && j < D) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kDwSlabs; ++q) t += red[q][c];
    dw[j] = t;
  }
}

template <typename T, bool kVec>
cudaError_t launch_bwd_vec(const void* x, const void* w, const void* dy,
                           void* dx, float* part, float* dw, int N, int D,
                           int wpr, int upl, int groups, int blocks,
                           float eps, cudaStream_t stream) {
  const int threads = 32 * wpr * groups;
  const size_t smem = (size_t)groups * D * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  cudaError_t err = cudaSuccess;
  // the static row sums beside the dynamic buffer: opt in to whatever
  // the buffer takes, not only past 48 KB
#define RMS_BWD_CASE(UU)                                                  \
  case UU:                                                                \
    err = cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, kVec, UU>,           \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)smem);                              \
    if (err != cudaSuccess) return err;                                   \
    rmsnorm_bwd_kernel<T, kVec, UU><<<blocks, threads, smem, stream>>>(   \
        xt, wt, dyt, dxt, part, N, D, wpr, eps);                          \
    break
  switch (upl) {
    RMS_BWD_CASE(1);
    RMS_BWD_CASE(2);
    RMS_BWD_CASE(4);
    RMS_BWD_CASE(8);
    default:
      return cudaErrorInvalidValue;
  }
#undef RMS_BWD_CASE
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dw pass launched as the rows' dependent (Hopper's programmatic
  // dependent launch): its blocks are set up while the row kernel runs
  // and wait for its completion, and its memory, at griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kDwCols - 1) / kDwCols);
  cfg.blockDim = dim3(kDwCols * kDwSlabs);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rmsnorm_dw_kernel,
                           static_cast<const float*>(part), dw, blocks, D);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       float* part, float* dw, int N, int D, int vec, int wpr,
                       int upl, int groups, int blocks, float eps,
                       cudaStream_t stream) {
  if (wpr < 1 || groups < 1 || wpr * groups > kMaxWarps || blocks < 1)
    return cudaErrorInvalidValue;
  if (vec)
    return launch_bwd_vec<T, true>(x, w, dy, dx, part, dw, N, D, wpr, upl,
                                   groups, blocks, eps, stream);
  return launch_bwd_vec<T, false>(x, w, dy, dx, part, dw, N, D, wpr, upl,
                                  groups, blocks, eps, stream);
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

// The backward: x, dy and dx [N, D] and w [D] share the dtype code; part
// is fp32 [blocks, D] scratch, dw fp32 [D]. vec, wpr, upl (1, 2, 4 or 8)
// and rows_per_block (row groups a block) are the wrapper's bwd_plan;
// blocks (at least 1) its bwd_blocks. Two kernels: the rows, then dw.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* dy, void* dx, void* part,
                                  void* dw, int N, int D, int dtype,
                                  float eps, int vec, int wpr, int upl,
                                  int rows_per_block, int blocks,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<float*>(part);
  auto dwt = static_cast<float*>(dw);
  if (dtype == 0)
    return launch_bwd<float>(x, w, dy, dx, pt, dwt, N, D, vec, wpr, upl,
                             rows_per_block, blocks, eps, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, pt, dwt, N, D, vec, wpr,
                                     upl, rows_per_block, blocks, eps, s);
  return cudaErrorInvalidValue;
}
