// The Mamba2 SSD chunked scan's gradient for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package trains through XLA's
// autodiff of models/mamba2.py::ssd_chunked, the function that the
// forward kernels (csrc/ssd_scan.cu, for repro/kernels/ssd_scan.py) compute.
//
// Computes, for the output gradients dy [Bt, S, nh, hd] and dh [Bt, nh,
// hd, ds] (the final state's; both fp32): dx in x's dtype, ddt [Bt, S, nh],
// dA [nh], dB and dC in their dtype, and dh0 [Bt, nh, hd, ds]. The terms
// are those of the Mamba2 paper's SSD
// (arXiv:2405.21060) and of the public mamba_ssm chunk-scan, chunk-state
// and state-passing backward; kernels/ref.py::ssd_scan_bwd_ref writes them
// out. With L_ij = e^(cum_i - cum_j) for j <= i, CB_ij = C_i . B_j, G_ij =
// dy_i . x_j and the state H_in entering a chunk and the gradient dH_out
// of the state leaving it:
//   dx_j   = dt_j [sum_{i>=j} CB_ij L_ij dy_i + e^(cum_last-cum_j) dH_out B_j]
//   dB_j  += sum_h [sum_{i>=j} G_ij L_ij dt_j C_i + e^(..) dt_j dH_out^T x_j]
//   dC_i  += sum_h [sum_{j<=i} G_ij L_ij dt_j B_j + e^(cum_i) H_in^T dy_i]
//   dH_in  = e^(cum_last) dH_out + sum_i e^(cum_i) dy_i C_i^T
//   dcum_i = sum_j CB_ij L_ij dt_j G_ij - dt_i sum_k CB_ki L_ki G_ki
//            + e^(cum_i) C_i . H_in^T dy_i - dt_i e^(..) x_i . dH_out B_i
//            (+ at the chunk's last row, the sum of the last term over the
//            rows and e^(cum_last) <dH_out, H_in>)
// and then, with R_t = sum_{i>=t} dcum_i, ddt_t += A R_t and dA += dt_t R_t.
// dcum is the gradient in natural units: the exponentials are computed as
// 2^(cum log2 e), as the forward's are, but each of their derivatives is
// the exponential itself, so no factor of ln 2 enters anywhere.
//
// Five kernels on one stream, counted once:
//  1. ssd_bwd_state_kernel, one block per (chunk, head, 64 head-dim rows):
//     the chunk's state S_k = x^T (B o dt o e^(cum_last - cum)) and the
//     state gradient's chunk term D_k = dy^T (C o e^cum), both [hd x ds]
//     products over the chunk's rows, and the chunk's decay e^cum_last;
//  2. ssd_bwd_pass_kernel, one thread per state entry of a (row, head): the
//     state through the chunks in order, H_in_k in place of S_k (fp32: the
//     forward keeps H_in only as bf16 hi + lo, ~16 bits, and is not saved),
//     then back through them, dH_out_k in place of D_k, and dh0;
//  3. ssd_bwd_chunk_kernel, one block per (chunk, head): first the carried
//     state's terms of dC and dcum for each 64-row tile; then for each
//     64-row tile j of the chunk, each tile i >= j: the [64 x 64] tiles of
//     G and CB, the masked L (j > i masked before the exponential, as the
//     forward does: above the diagonal the exponent is positive), their
//     products into dx_j and dB_j (registers), dC_i (the head's partial in
//     device memory, which only this block touches, added to in a fixed
//     order) and dcum's row and column sums; then the state's terms of
//     dx_j, dB_j, ddt_j and dcum; last, the reverse cumsum of dcum over the
//     chunk by one warp in a fixed order, ddt and the block's share of dA;
//  4. ssd_bwd_reduce_kernel: dB and dC, each the sum of the heads'
//     partials in head order, in the input's dtype;
//  5. ssd_bwd_da_kernel: dA, the blocks' shares summed over rows and
//     chunks in order.
// x, B and C are read in f32 or bf16 by one body (the dtype is a run-time
// flag of the loads and of dx's store), so each kernel builds once per
// d_state. No atomics: every sum's order depends on (S, c, nh, hd, ds)
// alone, so a row's dx, ddt, dB, dC and dh0 alone equal its row in a batch
// bit for bit, and dA is the same from run to run.
//
// Bound: at one 1024-token row of mamba2-370m (nh 32, hd 64, ds 128, c
// 256) in f32, x, dy and dx are 8.4 MB each, B, C, dB and dC 0.5 MB each,
// dh and dh0 1 MB each: ~29 MB, ~9 us at 3.35 TB/s; the products of step 3
// are ~4 c^2/2 hd-or-ds products a chunk and head, ~6 GFLOP in all, ~90 us
// on the fp32 CUDA cores. So a CUDA-core kernel is bound by its
// operations. This first version is plain fp32 on the CUDA cores, every
// product from shared-memory tiles; the tensor cores (the forward's bf16
// hi + lo split) are later work. Its precision: x, B and C in bf16 are
// exact in fp32. Two fp32 steps would cost the decay parameters' gradients
// ~5e-4 of their size where the decay is steep: within a chunk |cum|
// reaches ~2e3, where an ulp of cum is ~1e-4 and so is the relative error
// of every L_ij, and dcum's row and column sums cancel in its reverse
// cumsum. So the cumulative decay is summed compensated (hi + lo, each
// difference from both) and dcum, its reverse cumsum and dA's shares in
// fp64; the rest is fp32, and the plain version computes in fp64.

#include "ssd_common.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBT = 64;         // rows of a tile (and head-dim rows, step 1)
constexpr int kTLD = kBT + 1;   // the row stride of the [64 x 64] tiles
constexpr int kMaxHdBwd = 128;  // a thread holds hd / 4 columns of dx_j

// a + b = s + e exactly (Knuth's two-sum), with no operation contracted
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bp = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bp)), __fsub_rn(b, bp));
}

// The chunk's cumulative decay in log2 units as an unevaluated sum hi + lo,
// in chunk_cumsum's order, compensated: each product's and each addition's
// rounding error is kept in lo. A difference (hi_i - hi_j) + (lo_i - lo_j)
// then errs by a part of cum_i - cum_j, not by an ulp of |cum| (~1e-4 at
// |cum| ~ 2e3, which a chunk of 256 steep-decay rows reaches).
__device__ __forceinline__ void chunk_cumsum2(const float* dtv, int chunk,
                                              float A_h, float* hi,
                                              float* lo) {
  A_h = __fmul_rn(A_h, kLog2e);
  const int lane = threadIdx.x & 31;
  const int per = chunk / 32, base = lane * per;
  float run = 0.f, err = 0.f;
  for (int q = 0; q < per; ++q) {
    const float v = dtv[base + q];
    const float p = __fmul_rn(v, A_h);
    float sum, e;
    two_sum(run, p, sum, e);
    run = sum;
    err = __fadd_rn(err, __fadd_rn(e, fmaf(v, A_h, -p)));
    hi[base + q] = run;
    lo[base + q] = err;
  }
  float ih = run, il = err;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float vh = __shfl_up_sync(0xffffffffu, ih, o);
    const float vl = __shfl_up_sync(0xffffffffu, il, o);
    if (lane >= o) {
      float sum, e;
      two_sum(ih, vh, sum, e);
      ih = sum;
      il = __fadd_rn(il, __fadd_rn(vl, e));
    }
  }
  float eh = __shfl_up_sync(0xffffffffu, ih, 1);
  float el = __shfl_up_sync(0xffffffffu, il, 1);
  if (lane == 0) eh = el = 0.f;
  for (int q = 0; q < per; ++q) {
    float sum, e;
    two_sum(hi[base + q], eh, sum, e);
    hi[base + q] = sum;
    lo[base + q] = __fadd_rn(lo[base + q], __fadd_rn(el, e));
  }
}

// cum_i - cum_j from the compensated sums
__device__ __forceinline__ float cum_diff(const float* hi, const float* lo,
                                          int i, int j) {
  return (hi[i] - hi[j]) + (lo[i] - lo[j]);
}

// Rows [0, kBT) of `cols` elements from src (row stride `stride`), as floats
// into dst [kBT][ld]; rows at or past `valid` read as 0 (and are not read).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          size_t stride, int cols, int valid) {
  for (int e = threadIdx.x; e < kBT * cols; e += blockDim.x) {
    const int r = e / cols, c = e % cols;
    dst[r * ld + c] = r < valid ? to_float(src[(size_t)r * stride + c]) : 0.f;
  }
}

// The same for x, B or C, whose dtype (f32, or bf16 where `bf16`) is read
// at run time, `off` elements past p: one body for both dtypes, so the
// kernels build once per d_state.
__device__ __forceinline__ void load_rows_x(float* dst, int ld, const void* p,
                                            size_t off, size_t stride,
                                            int cols, int valid, bool bf16) {
  if (bf16)
    load_rows(dst, ld, static_cast<const __nv_bfloat16*>(p) + off, stride,
              cols, valid);
  else
    load_rows(dst, ld, static_cast<const float*>(p) + off, stride, cols,
              valid);
}

// Step 1. grid (nc * n_dt, nh, Bt): block (k, h, b) takes head-dim rows
// [d0, d0 + 64) of chunk k's S_k and D_k; thread (d, g) holds the state
// columns g + 4 m of row d of both.
template <int DS>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_state_kernel(const void* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const void* __restrict__ Bm,
                         const void* __restrict__ Cm,
                         const float* __restrict__ dy,
                         float* __restrict__ states,
                         float* __restrict__ dstates,
                         float* __restrict__ decay, int S, int nh, int hd,
                         int chunk, long long x_bs, long long x_ts,
                         long long bc_bs, long long bc_ts, int bf16) {
  constexpr int BLD = DS + 1, M = DS / 4;
  const int nc = (S + chunk - 1) / chunk;
  const int k = blockIdx.x % nc, d0 = (blockIdx.x / nc) * kBT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = k * chunk, valid = min(chunk, S - t0);
  const int dcols = min(kBT, hd - d0);
  const int tid = threadIdx.x, d = tid >> 2, g = tid & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dtv = reinterpret_cast<float*>(smem_raw);
  float* hi = dtv + chunk;                // the decay, compensated
  float* lo = hi + chunk;
  float* xs = lo + chunk;                 // [kBT][kTLD]
  float* dys = xs + kBT * kTLD;           // [kBT][kTLD]
  float* bs = dys + kBT * kTLD;           // [kBT][BLD]
  float* cs = bs + kBT * BLD;             // [kBT][BLD]

  load_dt(dt + ((size_t)b * S + t0) * nh + h, nh, valid, chunk, dtv);
  __syncthreads();
  if (tid < 32) chunk_cumsum2(dtv, chunk, A[h], hi, lo);
  __syncthreads();
  const int last = chunk - 1;

  float sacc[M], dacc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) sacc[m] = dacc[m] = 0.f;
  const size_t xo = b * x_bs + (size_t)t0 * x_ts + (size_t)h * hd + d0;
  const size_t dy_ts = (size_t)nh * hd;
  const float* dyb = dy + ((size_t)b * S + t0) * dy_ts + (size_t)h * hd + d0;
  const size_t bo = b * bc_bs + (size_t)t0 * bc_ts;
  for (int j0 = 0; j0 < valid; j0 += kBT) {
    const int v = valid - j0;
    load_rows_x(xs, kTLD, x, xo + (size_t)j0 * x_ts, x_ts, dcols, v, bf16);
    load_rows<float>(dys, kTLD, dyb + (size_t)j0 * dy_ts, dy_ts, dcols, v);
    load_rows_x(bs, BLD, Bm, bo + (size_t)j0 * bc_ts, bc_ts, DS, v, bf16);
    load_rows_x(cs, BLD, Cm, bo + (size_t)j0 * bc_ts, bc_ts, DS, v, bf16);
    __syncthreads();
    if (d < dcols) {
      const int n = min(kBT, v);
      for (int j = 0; j < n; ++j) {
        const int t = j0 + j;
        const float sx = xs[j * kTLD + d] *
                         (dtv[t] * exp2_approx(cum_diff(hi, lo, last, t)));
        const float sy = dys[j * kTLD + d] * exp2_approx(hi[t] + lo[t]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          sacc[m] = fmaf(sx, bs[j * BLD + g + 4 * m], sacc[m]);
          dacc[m] = fmaf(sy, cs[j * BLD + g + 4 * m], dacc[m]);
        }
      }
    }
    __syncthreads();
  }
  if (d < dcols) {
    const size_t off =
        ((((size_t)b * nc + k) * nh + h) * hd + d0 + d) * (size_t)DS + g;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      states[off + 4 * m] = sacc[m];
      dstates[off + 4 * m] = dacc[m];
    }
  }
  if (d0 == 0 && tid == 0)
    decay[((size_t)b * nc + k) * nh + h] = exp2_approx(hi[last] + lo[last]);
}

// Step 2. grid (ceil(hd ds / 256), nh, Bt): one thread per state entry of
// (b, h): forward through the chunks (states: S_k in, H_in_k out), then
// back (dstates: D_k in, dH_out_k out), then dh0.
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_pass_kernel(const float* __restrict__ h0,
                        const float* __restrict__ dh,
                        float* __restrict__ states,
                        float* __restrict__ dstates,
                        const float* __restrict__ decay,
                        float* __restrict__ dh0, int nc, int nh,
                        int n_state) {
  const int e = blockIdx.x * kBwdThreads + threadIdx.x;
  if (e >= n_state) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * nh + h;
  float H = h0[head * n_state + e];
  for (int k = 0; k < nc; ++k) {
    const size_t bk = ((size_t)b * nc + k) * nh + h;
    float* p = states + bk * n_state + e;
    const float Sk = *p;
    *p = H;
    H = decay[bk] * H + Sk;
  }
  float G = dh[head * n_state + e];
  for (int k = nc - 1; k >= 0; --k) {
    const size_t bk = ((size_t)b * nc + k) * nh + h;
    float* p = dstates + bk * n_state + e;
    const float Dk = *p;
    *p = G;
    G = decay[bk] * G + Dk;
  }
  dh0[head * n_state + e] = G;
}

// Step 3. grid (nc, nh, Bt), one block per (chunk k, head h, row b). Shared
// memory (floats): six [c] arrays (dt, cum in log2 units, dcum's positive
// and negative parts, ddt's direct part, each row's share of the state
// update), the warps' sums, then x_j [64][hd+1], B_j [64][ds+1], the tiles
// W = CB L dt_j, Q = G L dt_j and K = CB G L [64][65], dy_i [64][hd+1] and
// C_i [64][ds+1]. H_in [hd][ds+1] lies over x_j .. K while the carried
// state's terms are formed, dH_out over W .. C_i while the state update's.
// Thread (r, g) of the 64 x 4 layout holds row r of a tile and its columns
// g + 4 m; thread (a, c) of the 16 x 16 layout the 4 x 4 block (a + 16 p,
// c + 16 q) of the tile products.
template <int DS>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_chunk_kernel(const void* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const void* __restrict__ Bm,
                         const void* __restrict__ Cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ hin,
                         const float* __restrict__ dhout,
                         void* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ dBh,
                         float* __restrict__ dCh, float* __restrict__ dA_part,
                         int S, int nh, int hd, int chunk, long long x_bs,
                         long long x_ts, long long bc_bs, long long bc_ts,
                         int bf16) {
  constexpr int BLD = DS + 1, M = DS / 4, MD = kMaxHdBwd / 4;
  const int nc = (S + chunk - 1) / chunk;
  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = k * chunk, valid = min(chunk, S - t0);
  const int n_t = (valid + kBT - 1) / kBT;
  const int XLD = hd + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r4 = tid >> 2, g4 = tid & 3;
  const int ti = tid >> 4, tj = tid & 15;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* pos = reinterpret_cast<double*>(smem_raw);
  double* neg = pos + chunk;
  double* sj = neg + chunk;
  float* dtv = reinterpret_cast<float*>(sj + chunk);
  float* hi = dtv + chunk;                // the decay, compensated
  float* lo = hi + chunk;
  float* dd = lo + chunk;
  float* red = dd + chunk;                // [32]
  float* xs = red + 32;
  float* bs = xs + kBT * XLD;
  float* wt = bs + kBT * BLD;
  float* qt = wt + kBT * kTLD;
  float* kt = qt + kBT * kTLD;
  float* dys = kt + kBT * kTLD;
  float* cs = dys + kBT * XLD;
  float* hs_in = xs;                      // H_in [hd][BLD], first
  float* hs_out = wt;                     // dH_out [hd][BLD], per j tile

  load_dt(dt + ((size_t)b * S + t0) * nh + h, nh, valid, chunk, dtv);
  for (int t = tid; t < chunk; t += blockDim.x) {
    pos[t] = neg[t] = sj[t] = 0.0;
    dd[t] = 0.f;
  }
  __syncthreads();
  if (tid < 32) chunk_cumsum2(dtv, chunk, A[h], hi, lo);

  const size_t bkh = ((size_t)b * nc + k) * nh + h;
  const int n_state = hd * DS;
  const float* hin_k = hin + bkh * n_state;
  const float* dho_k = dhout + bkh * n_state;
  const size_t dy_ts = (size_t)nh * hd;
  const float* dyb = dy + ((size_t)b * S + t0) * dy_ts + (size_t)h * hd;
  const size_t xo = b * x_bs + (size_t)t0 * x_ts + (size_t)h * hd;
  const size_t bo = b * bc_bs + (size_t)t0 * bc_ts;
  const size_t dxo = ((size_t)b * S + t0) * dy_ts + (size_t)h * hd;
  float* dBb = dBh + (((size_t)b * nh + h) * S + t0) * DS;
  float* dCb = dCh + (((size_t)b * nh + h) * S + t0) * DS;

  // H_in, and <dH_out, H_in> summed in a fixed order (each thread its
  // entries, then the lanes, then the warps)
  float hdot = 0.f;
  for (int e = tid; e < n_state; e += blockDim.x) {
    const float v = hin_k[e];
    hs_in[(e / DS) * BLD + e % DS] = v;
    hdot = fmaf(dho_k[e], v, hdot);
  }
  hdot = warp_sum(hdot);
  if (lane == 0) red[warp] = hdot;
  __syncthreads();
  hdot = 0.f;
  for (int w = 0; w < kBwdThreads / 32; ++w) hdot += red[w];
  const int last = chunk - 1;

  // the carried state's terms: v_i = H_in^T dy_i, dC_i = e^cum_i v_i (the
  // head's partial starts here), dcum_i += e^cum_i C_i . v_i
  for (int it = 0; it < n_t; ++it) {
    const int i0 = it * kBT, vi = valid - i0;
    load_rows<float>(dys, XLD, dyb + (size_t)i0 * dy_ts, dy_ts, hd, vi);
    load_rows_x(cs, BLD, Cm, bo + (size_t)i0 * bc_ts, bc_ts, DS, vi, bf16);
    __syncthreads();
    float vv[M];
#pragma unroll
    for (int m = 0; m < M; ++m) vv[m] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float yv = dys[r4 * XLD + d];
#pragma unroll
      for (int m = 0; m < M; ++m)
        vv[m] = fmaf(hs_in[d * BLD + g4 + 4 * m], yv, vv[m]);
    }
    const int i = i0 + r4;
    const float e = exp2_approx(hi[i] + lo[i]);
    float cv = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) cv = fmaf(cs[r4 * BLD + g4 + 4 * m], vv[m], cv);
    cv += __shfl_xor_sync(0xffffffffu, cv, 1);
    cv += __shfl_xor_sync(0xffffffffu, cv, 2);
    if (i < valid) {
#pragma unroll
      for (int m = 0; m < M; ++m) dCb[(size_t)i * DS + g4 + 4 * m] = e * vv[m];
      if (g4 == 0) pos[i] = (double)(e * cv);
    }
    __syncthreads();                      // dy_i and C_i read before reload
  }

  for (int jt = 0; jt < n_t; ++jt) {
    const int j0 = jt * kBT, vj = valid - j0;
    load_rows_x(xs, XLD, x, xo + (size_t)j0 * x_ts, x_ts, hd, vj, bf16);
    load_rows_x(bs, BLD, Bm, bo + (size_t)j0 * bc_ts, bc_ts, DS, vj, bf16);
    float dxa[MD], dba[M];
#pragma unroll
    for (int m = 0; m < MD; ++m) dxa[m] = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) dba[m] = 0.f;
    for (int it = jt; it < n_t; ++it) {
      const int i0 = it * kBT, vi = valid - i0;
      load_rows<float>(dys, XLD, dyb + (size_t)i0 * dy_ts, dy_ts, hd, vi);
      load_rows_x(cs, BLD, Cm, bo + (size_t)i0 * bc_ts, bc_ts, DS, vi,
                  bf16);
      __syncthreads();
      // G = dy_i x_j^T and CB = C_i B_j^T at rows ti + 16 p, columns tj + 16 q
      float gm[4][4], cb[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) gm[p][q] = cb[p][q] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float yv[4], xv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) yv[p] = dys[(ti + 16 * p) * XLD + d];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = xs[(tj + 16 * q) * XLD + d];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) gm[p][q] = fmaf(yv[p], xv[q], gm[p][q]);
      }
      for (int s = 0; s < DS; ++s) {
        float cv[4], bv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) cv[p] = cs[(ti + 16 * p) * BLD + s];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = bs[(tj + 16 * q) * BLD + s];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) cb[p][q] = fmaf(cv[p], bv[q], cb[p][q]);
      }
      // L masked to j <= i (and rows i inside S) before the exponential
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int il = i0 + ti + 16 * p, jl = j0 + tj + 16 * q;
          const bool vis = jl <= il && il < valid;
          const float L = vis ? exp2_approx(cum_diff(hi, lo, il, jl)) : 0.f;
          const float gl = gm[p][q] * L;
          const int o = (ti + 16 * p) * kTLD + tj + 16 * q;
          wt[o] = cb[p][q] * L * dtv[jl];
          qt[o] = gl * dtv[jl];
          kt[o] = cb[p][q] * gl;
        }
      }
      __syncthreads();
      // dx_j += sum_i W_ij dy_i and dB_j += sum_i Q_ij C_i (row j = r4)
      const int ni = min(kBT, vi);
      for (int i = 0; i < ni; ++i) {
        const float w = wt[i * kTLD + r4], q = qt[i * kTLD + r4];
#pragma unroll
        for (int m = 0; m < MD; ++m)
          if (4 * m < hd) dxa[m] = fmaf(w, dys[i * XLD + g4 + 4 * m], dxa[m]);
#pragma unroll
        for (int m = 0; m < M; ++m)
          dba[m] = fmaf(q, cs[i * BLD + g4 + 4 * m], dba[m]);
      }
      // dC_i += sum_j Q_ij B_j (row i = r4), into the head's partial
      {
        float acc[M];
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m] = 0.f;
        const int nj = min(kBT, vj);
        for (int j = 0; j < nj; ++j) {
          const float q = qt[r4 * kTLD + j];
#pragma unroll
          for (int m = 0; m < M; ++m)
            acc[m] = fmaf(q, bs[j * BLD + g4 + 4 * m], acc[m]);
        }
        const int i = i0 + r4;
        if (i < valid) {
#pragma unroll
          for (int m = 0; m < M; ++m)
            dCb[(size_t)i * DS + g4 + 4 * m] += acc[m];
        }
      }
      // dcum: + sum_j K_ij dt_j by row; - dt_j sum_i K_ij by column, and
      // ddt_j += sum_i K_ij
      if (tid < kBT) {
        double s = 0.0;
        for (int j = 0; j < kBT; ++j)
          s = fma((double)kt[tid * kTLD + j], (double)dtv[j0 + j], s);
        pos[i0 + tid] += s;
      } else if (tid < 2 * kBT) {
        const int j = tid - kBT;
        double s = 0.0;
        for (int i = 0; i < kBT; ++i) s += (double)kt[i * kTLD + j];
        neg[j0 + j] = fma((double)dtv[j0 + j], s, neg[j0 + j]);
        dd[j0 + j] += (float)s;
      }
      __syncthreads();                    // the tiles read before reload
    }

    // the state update's terms of row j: u = dH_out B_j, f = dt_j
    // e^(cum_last - cum_j); dx_j += f u, dB_j += f dH_out^T x_j, and
    // x_j . u into ddt_j (times e^..) and dcum (times f)
    for (int e = tid; e < n_state; e += blockDim.x)
      hs_out[(e / DS) * BLD + e % DS] = dho_k[e];
    __syncthreads();
    {
      const int j = j0 + r4;
      const float tl = exp2_approx(cum_diff(hi, lo, last, j));
      const float f = dtv[j] * tl;
      float sx = 0.f;
#pragma unroll
      for (int m = 0; m < MD; ++m) {
        if (4 * m < hd) {
          const int d = g4 + 4 * m;
          float u = 0.f;
          for (int s = 0; s < DS; ++s)
            u = fmaf(hs_out[d * BLD + s], bs[r4 * BLD + s], u);
          dxa[m] = fmaf(f, u, dxa[m]);
          sx = fmaf(xs[r4 * XLD + d], u, sx);
        }
      }
      sx += __shfl_xor_sync(0xffffffffu, sx, 1);
      sx += __shfl_xor_sync(0xffffffffu, sx, 2);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int s = g4 + 4 * m;
        float w = 0.f;
        for (int d = 0; d < hd; ++d)
          w = fmaf(hs_out[d * BLD + s], xs[r4 * XLD + d], w);
        dba[m] = fmaf(f, w, dba[m]);
      }
      if (j < valid) {
        if (g4 == 0) {
          dd[j] = fmaf(tl, sx, dd[j]);
          sj[j] = (double)f * (double)sx;
          neg[j] += sj[j];
        }
        const size_t o = dxo + (size_t)j * dy_ts + g4;
#pragma unroll
        for (int m = 0; m < MD; ++m) {
          if (4 * m >= hd) break;
          if (bf16)
            store_float(dxa[m], static_cast<__nv_bfloat16*>(dx) + o + 4 * m);
          else
            static_cast<float*>(dx)[o + 4 * m] = dxa[m];
        }
#pragma unroll
        for (int m = 0; m < M; ++m) dBb[(size_t)j * DS + g4 + 4 * m] = dba[m];
      }
    }
    __syncthreads();                      // x_j, B_j, dH_out read before reload
  }

  // dcum = pos - neg, the last row plus sum_j sj_j + e^cum_last <dH_out,
  // H_in>, in fp64 (its row and column sums cancel in R); R_t = sum_{i>=t}
  // dcum_i by warp 0 (lane l: rows [l c/32, (l+1) c/32) from their end,
  // then the lanes after it); ddt and dA's share
  if (warp == 0) {
    const int per = chunk / 32, base = lane * per;
    double s = 0.0;
    for (int q = 0; q < per; ++q) s += sj[base + q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const double add =
        s + (double)exp2_approx(hi[last] + lo[last]) * (double)hdot;
    double run = 0.0;
    for (int q = per - 1; q >= 0; --q) {
      const int t = base + q;
      run += pos[t] - neg[t] + (t == valid - 1 ? add : 0.0);
      pos[t] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += v;
    }
    double excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.0;
    const double Ah = (double)A[h];
    double da = 0.0;
    for (int q = 0; q < per; ++q) {
      const int t = base + q;
      if (t < valid) {
        const double R = pos[t] + excl;
        ddt[((size_t)b * S + t0 + t) * nh + h] =
            (float)fma(Ah, R, (double)dd[t]);
        da = fma((double)dtv[t], R, da);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
    if (lane == 0) dA_part[bkh] = (float)da;
  }
}

// Step 4. One thread per (b, t, s) of dB, then of dC: the heads' partials
// [Bt, nh, S, ds] summed in head order, in the input's dtype.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                                      const float* __restrict__ dCh,
                                      T* __restrict__ dB, T* __restrict__ dC,
                                      int S, int nh, int ds, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * n) return;
  const bool c = e >= n;
  const long long f = c ? e - n : e;
  const long long row = (long long)S * ds;
  const long long b = f / row;
  const float* src = (c ? dCh : dBh) + b * nh * row + f % row;
  float s = 0.f;
  for (int h = 0; h < nh; ++h) s += src[(size_t)h * row];
  store_float(s, (c ? dC : dB) + f);
}

// Step 5. dA[h], the blocks' shares summed over rows, then chunks, in order.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ part,
                                  float* __restrict__ dA, int Bt, int nc,
                                  int nh) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= nh) return;
  float s = 0.f;
  for (int b = 0; b < Bt; ++b)
    for (int k = 0; k < nc; ++k) s += part[((size_t)b * nc + k) * nh + h];
  dA[h] = s;
}

template <int DS>
cudaError_t launch_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       const void* dy, const void* dh, void* dx, void* ddt,
                       void* dA, void* dB, void* dC, void* dh0, void* states,
                       void* dstates, void* decay, void* dBh, void* dCh,
                       void* dA_part, int Bt, int S, int nh, int hd,
                       int chunk, long long x_bs, long long x_ts,
                       long long bc_bs, long long bc_ts, int bf16,
                       cudaStream_t stream) {
  if (chunk % kBT || chunk > 1024 || hd % 16 || hd > kMaxHdBwd || S < 1)
    return cudaErrorInvalidValue;
  constexpr int BLD = DS + 1;
  const int nc = (S + chunk - 1) / chunk;
  const int n_dt = (hd + kBT - 1) / kBT;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dyf = static_cast<const float*>(dy);
  float* st = static_cast<float*>(states);
  float* dst = static_cast<float*>(dstates);
  float* dc = static_cast<float*>(decay);
  const size_t fl = sizeof(float);

  const size_t smem1 = (3 * chunk + 2 * kBT * kTLD + 2 * kBT * BLD) * fl;
  auto k1 = ssd_bwd_state_kernel<DS>;
  cudaError_t err = allow_smem(k1, smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc * n_dt, nh, Bt), kBwdThreads, smem1, stream>>>(
      x, dtf, Af, Bm, Cm, dyf, st, dst, dc, S, nh, hd, chunk, x_bs, x_ts,
      bc_bs, bc_ts, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_state = hd * DS;
  ssd_bwd_pass_kernel<<<dim3((n_state + kBwdThreads - 1) / kBwdThreads, nh,
                             Bt), kBwdThreads, 0, stream>>>(
      static_cast<const float*>(h0), static_cast<const float*>(dh), st, dst,
      dc, static_cast<float*>(dh0), nc, nh, n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // H_in lies over x_j .. K, dH_out over W .. C_i: both fit for hd <= 128
  const size_t xt_f = (size_t)kBT * (hd + 1), bt_f = (size_t)kBT * BLD;
  const size_t tiles = 3 * (size_t)kBT * kTLD;
  if ((size_t)hd * BLD > tiles + xt_f + bt_f) return cudaErrorInvalidValue;
  const size_t smem3 =
      3 * (size_t)chunk * sizeof(double) +
      (4 * (size_t)chunk + 32 + 2 * xt_f + 2 * bt_f + tiles) * fl;
  auto k3 = ssd_bwd_chunk_kernel<DS>;
  err = allow_smem(k3, smem3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(nc, nh, Bt), kBwdThreads, smem3, stream>>>(
      x, dtf, Af, Bm, Cm, dyf, st, dst, dx, static_cast<float*>(ddt),
      static_cast<float*>(dBh), static_cast<float*>(dCh),
      static_cast<float*>(dA_part), S, nh, hd, chunk, x_bs, x_ts, bc_bs,
      bc_ts, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n = (long long)Bt * S * DS;
  const unsigned blocks = (unsigned)((2 * n + kBwdThreads - 1) / kBwdThreads);
  const float* pb = static_cast<const float*>(dBh);
  const float* pc = static_cast<const float*>(dCh);
  if (bf16)
    ssd_bwd_reduce_kernel<<<blocks, kBwdThreads, 0, stream>>>(
        pb, pc, static_cast<__nv_bfloat16*>(dB),
        static_cast<__nv_bfloat16*>(dC), S, nh, DS, n);
  else
    ssd_bwd_reduce_kernel<<<blocks, kBwdThreads, 0, stream>>>(
        pb, pc, static_cast<float*>(dB), static_cast<float*>(dC), S, nh, DS,
        n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<(nh + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(dA_part), static_cast<float*>(dA), Bt, nc,
      nh);
  return cudaGetLastError();
}

}  // namespace

// The backward: x, B and C as the forward takes them (dtype code, strides,
// ds 16, 64 or 128, chunk a multiple of 64 up to 1024, any S >= 1), hd a
// multiple of 16 up to 128; dy [Bt, S, nh, hd] and dh [Bt, nh, hd, ds]
// fp32, contiguous. Outputs: dx [Bt, S, nh, hd] in x's dtype, contiguous;
// ddt [Bt, S, nh], dA [nh] and dh0 [Bt, nh, hd, ds] fp32; dB and dC
// [Bt, S, ds] in B's dtype. Scratch, nc = ceil(S / chunk): states and
// dstates, fp32 of Bt * nc * nh * hd * ds floats each; decay and dA_part,
// fp32 of Bt * nc * nh; dBh and dCh, fp32 [Bt, nh, S, ds] each.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* h0, const void* dy, const void* dh, void* dx,
    void* ddt, void* dA, void* dB, void* dC, void* dh0, void* states,
    void* dstates, void* decay, void* dBh, void* dCh, void* dA_part, int Bt,
    int S, int nh, int hd, int ds, int chunk, long long x_bs, long long x_ts,
    long long bc_bs, long long bc_ts, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
#define SSD_BWD_LAUNCH(DS)                                                    \
  return launch_bwd<DS>(x, dt, A, Bm, Cm, h0, dy, dh, dx, ddt, dA, dB, dC,   \
                        dh0, states, dstates, decay, dBh, dCh, dA_part, Bt, \
                        S, nh, hd, chunk, x_bs, x_ts, bc_bs, bc_ts, dtype,  \
                        s)
  if (ds == 16) SSD_BWD_LAUNCH(16);
  if (ds == 64) SSD_BWD_LAUNCH(64);
  if (ds == 128) SSD_BWD_LAUNCH(128);
#undef SSD_BWD_LAUNCH
  return cudaErrorInvalidValue;
}
