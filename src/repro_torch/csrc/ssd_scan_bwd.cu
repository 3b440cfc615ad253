// The Mamba2 SSD chunked scan's gradient for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package trains through XLA's
// autodiff of models/mamba2.py::ssd_chunked (models/mamba2.py:83), the
// function that the forward kernels (csrc/ssd_scan.cu, for
// repro/kernels/ssd_scan.py) compute.
//
// Computes, for the output gradients dy [Bt, S, nh, hd] and dh [Bt, nh,
// hd, ds] (the final state's; both fp32): dx in x's dtype, ddt [Bt, S, nh],
// dA [nh], dB and dC in their dtype, and dh0 [Bt, nh, hd, ds]. The terms
// are those of the Mamba2 paper's SSD (arXiv:2405.21060) and of the public
// mamba_ssm chunk-scan, chunk-state and state-passing backward;
// kernels/ref.py::ssd_scan_bwd_ref writes them out. With L_ij =
// e^(cum_i - cum_j) for j <= i, CB_ij = C_i . B_j, G_ij = dy_i . x_j, Q_ij
// = G_ij L_ij dt_j, K_ij = CB_ij G_ij L_ij, the state H_in entering a chunk
// and the gradient dH_out of the state leaving it:
//   dx_j   = dt_j [sum_{i>=j} CB_ij L_ij dy_i + e^(cum_last-cum_j) dH_out B_j]
//   dB_j   = sum_i (sum_h Q_ij) C_i + sum_h e^(..) dt_j dH_out^T x_j
//   dC_i   = sum_j (sum_h Q_ij) B_j + sum_h e^(cum_i) H_in^T dy_i
//   dH_in  = e^(cum_last) dH_out + sum_i e^(cum_i) dy_i C_i^T
//   dcum_i = sum_j K_ij dt_j - dt_i sum_k K_ki
//            + e^(cum_i) dy_i . (H_in C_i) - dt_i e^(..) x_i . dH_out B_i
//            (+ at the chunk's last row, the sum of the last term over the
//            rows and e^(cum_last) <dH_out, H_in>)
// and then, with R_t = sum_{i>=t} dcum_i, ddt_t += A R_t and dA += dt_t R_t.
// dcum is the gradient in natural units: the exponentials are computed as
// 2^(cum log2 e), as the forward's are, but each of their derivatives is
// the exponential itself, so no factor of ln 2 enters anywhere.
//
// Bound: at one 1024-token row of mamba2-370m (nh 32, hd 64, ds 128, c
// 256) in f32 the gradient moves ~30 MB (x, dy and dx 8.4 MB each, B, C,
// dB and dC 0.5 MB each, dh and dh0 1 MB each), ~9 us at 3.35 TB/s. Its
// products, with C.B^T, dB and dC formed per head, are ~6 GFLOP as fp32
// multiply-adds, ~90 us on the fp32 CUDA cores. On the tensor cores with
// each fp32 factor split in two (three products a pair) they are ~17.9
// GFLOP of bf16 products, ~18 us at 989 TFLOP/s, so the operations bound
// it (chip_smoke.py's _ssd_bwd_work counts the function's products; the
// kernels below issue more: G twice, the diagonal tiles whole, C.B^T once
// a group of heads). Per-head partials of dB and dC would take
// [Bt, nh, S, ds] fp32 each, 67 MB written and read back at that row; one
// partial a group of 4 heads takes a quarter of that.
//
// Six kernels on one stream, counted once:
//  1. ssd_bwd_state_kernel, one block per (chunk, head, 64 head-dim rows,
//     64 state columns): the chunk's state S_k = x^T (B o dt o e^(cum_last
//     - cum)) and the state gradient's chunk term D_k = dy^T (C o e^cum),
//     two [hd x ds] products over the chunk's rows (the forward's state
//     kernel with a second product), and the chunk's decay e^cum_last;
//  2. ssd_bwd_pass_kernel, one thread per state entry of a (row, head): the
//     state through the chunks in order, H_in_k in place of S_k (fp32),
//     then back through them, dH_out_k in place of D_k, and dh0;
//  3. ssd_bwd_dx_kernel, one block per (chunk, 64-row tile j, group of
//     heads whose columns fill 128, at most 4; 2 at hd 64), the tiles with
//     the most work first: for each tile i >= j, CB^T = B_j C_i^T once for
//     the group, then per head G^T = x_j dy_i^T, the masked L^T (j > i
//     masked before the exponential: above the diagonal the exponent is
//     positive), W^T = CB^T L^T dt_j into dx_j += W^T dy_i, and K^T into a
//     shared fp32 tile whose column sums (dcum's row part, the (i, j) tile's
//     share) and row sums (its column part, ddt's direct part) are taken
//     in fp64; then the state update's terms u = B_j dH_out^T of every
//     head of the group in one product (dx_j += f u, x_j . u into ddt and
//     dcum), and the carried state's z = C_j H_in^T (dy_j . z into dcum);
//  4. ssd_bwd_dbdc_kernel, one block per (chunk, tile, dB or dC, group of
//     heads whose columns fill 256, at most 4; 4 at hd 64): QS = sum_h Q
//     over the group (dC: the tile's rows i, tiles j <= i; dB: its rows j,
//     tiles i >= j), each summed tile multiplied once into dC += QS B_j or
//     dB += QS^T C_i, then the state terms of every head of the group as
//     one product over the group's head-dim rows; the group's partial into
//     [Bt, groups, S, ds];
//  5. ssd_bwd_dcum_kernel, one block per (chunk, head): dcum from the
//     tiles' shares in tile order, the last row's terms, its reverse
//     cumsum by one warp in a fixed order, ddt and the block's share of
//     dA;
//  6. ssd_bwd_reduce_kernel: dB and dC, each the sum of the groups'
//     partials in group order, in the input's dtype, and dA, the blocks'
//     shares summed over rows and chunks in order.
// The dB / dC kernel never forms C.B^T; a dx block forms it once for its
// group's heads.
//
// Precision: every product runs on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate), fp32 operands split into bf16 hi + lo, the
// lo . lo term dropped, as the forward splits them: x, B and C in bf16 are
// exact and need no split; dy, W, QS, H_in, dH_out and the scaled x^T and
// dy^T of step 1 always split. Two fp32 steps would cost the decay
// parameters' gradients ~5e-4 of their size where the decay is steep:
// within a chunk |cum| reaches ~2e3, where an ulp of cum is ~1e-4 and so
// is the relative error of every L_ij, and dcum's row and column sums
// cancel in its reverse cumsum. So the cumulative decay is summed
// compensated (hi + lo, each difference from both) and dcum, its reverse
// cumsum and dA's shares in fp64. The split's own error (~2^-16 of each
// product) enters K once: its row and column sums read the same fp32 K
// values, so they still cancel exactly in R. A plain emulation of these
// products (operands rounded to bf16 hi + lo, fp32 accumulation;
// tests/test_torch_scan_norm_plan.py, `_split_bwd`) at mamba2-370m's
// chunk and at jamba's d_state 16, with A down to -16 (|cum| ~2e3),
// holds every gradient within 1.2e-5 of its largest magnitude against the
// fp64 plain version in f32 (ddt 8e-6 and 7.2e-6, dA 6.5e-6 and 1.2e-5 at
// d_state 128 and 16), and in bf16 within 1e-5 beside one bf16 ulp of dx,
// dB and dC: 40 times inside the 5e-4 limit. So the two-term split is
// kept for every product, those that feed dcum too.
//
// Determinism: no atomics; the blocks, the groups and every sum's order
// depend on (S, c, nh, hd, ds) alone, so a row's dx, ddt, dB, dC and dh0
// alone equal its row in a batch bit for bit, and dA is the same from run
// to run. Scratch comes from the wrapper; the kernels allocate nothing.

#include "ssd_common.cuh"

namespace {

constexpr int kThreads = 128;     // four warps, 16 rows of a tile each
constexpr int kPassThreads = 256;
constexpr int kT = 64;            // rows of a tile
constexpr int kKLD = kT + 1;      // row stride of the fp32 [64 x 64] tile
constexpr int kCols3 = 128;       // a dx block's columns (heads x head_dim)
constexpr int kCols4 = 256;       // a dB / dC block's columns
constexpr int kMaxHpg = 4;        // heads a group at most: a warp scans each
constexpr int kMaxHd = 128;

// Heads whose head_dim columns fill `cols`, at most kMaxHpg (hd <= cols)
__host__ __device__ constexpr int heads_per_group(int cols, int hd) {
  return cols / hd > kMaxHpg ? kMaxHpg : cols / hd;
}

// a + b = s + e exactly (Knuth's two-sum), with no operation contracted
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bp = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bp)), __fsub_rn(b, bp));
}

// The chunk's cumulative decay in log2 units as an unevaluated sum hi + lo,
// by one warp in a fixed order, compensated: each product's and each
// addition's rounding error is kept in lo. A difference (hi_i - hi_j) +
// (lo_i - lo_j) then errs by a part of cum_i - cum_j, not by an ulp of
// |cum| (~1e-4 at |cum| ~ 2e3, which a chunk of 256 steep-decay rows
// reaches).
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

// ------------------------------------------------- tensor-core fragments
// mma.sync m16n8k16's operands from bf16 shared-memory tiles by ldmatrix,
// in the layouts csrc/ssd_scan.cu uses. A: rows [m0, m0 + 16), k [k0, k0 +
// 16); a tile stored [m][k] (frag_a) or [k][m] (frag_a_t). B: the two
// n-blocks of columns [n0, n0 + 16) (b[0..1] and b[2..3]) at k [k0, k0 +
// 16); a tile stored [n][k] (frag_b) or [k][n] (frag_b_t).
__device__ __forceinline__ void frag_a(const __nv_bfloat16* t, int ld, int m0,
                                       int k0, uint32_t* a) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(smem_u32(t + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8), a);
}
__device__ __forceinline__ void frag_a_t(const __nv_bfloat16* t, int ld,
                                         int m0, int k0, uint32_t* a) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4_trans(smem_u32(t + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 +
                             ((l >> 3) & 1) * 8),
                    a);
}
__device__ __forceinline__ void frag_b(const __nv_bfloat16* t, int ld, int n0,
                                       int k0, uint32_t* b) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(smem_u32(t + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 +
                       ((l >> 3) & 1) * 8),
              b);
}
__device__ __forceinline__ void frag_b_t(const __nv_bfloat16* t, int ld,
                                         int n0, int k0, uint32_t* b) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4_trans(smem_u32(t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld +
                             n0 + (l >> 4) * 8),
                    b);
}

// c0, c1 (two n-blocks) += a . b over split halves: a[0] (and b[0]) the hi
// half, a[1] (b[1]) the lo half where `ah` (`bh`) is 2; lo . lo dropped.
__device__ __forceinline__ void mma_pair(float* c0, float* c1,
                                         uint32_t (*a)[4], int ah,
                                         uint32_t (*b)[4], int bh) {
  mma_bf16(c0, a[0], b[0][0], b[0][1]);
  mma_bf16(c1, a[0], b[0][2], b[0][3]);
  if (bh > 1) {
    mma_bf16(c0, a[0], b[1][0], b[1][1]);
    mma_bf16(c1, a[0], b[1][2], b[1][3]);
  }
  if (ah > 1) {
    mma_bf16(c0, a[1], b[0][0], b[0][1]);
    mma_bf16(c1, a[1], b[0][2], b[0][3]);
  }
}

// c[N0 .. N0 + 2 NP) += a . b, b the NP n-block pairs from column 8 N0 of
// a tile of `bh` halves (`half` elements apart) stored [n][k] (frag_b) or
// [k][n] (frag_b_t), at k-step k0: compile-time indices, so that the
// products of the pairs share one basic block and interleave
template <bool kTrans, int N0, int NP, int N>
__device__ __forceinline__ void mma_pairs(float (&c)[N][4], uint32_t (*a)[4],
                                          int ah, const __nv_bfloat16* t,
                                          int half, int bh, int ld, int k0) {
#pragma unroll
  for (int m = 0; m < NP; ++m) {
    uint32_t bf[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf >= bh) break;
      if (kTrans)
        frag_b_t(t + hf * half, ld, (N0 + 2 * m) * 8, k0, bf[hf]);
      else
        frag_b(t + hf * half, ld, (N0 + 2 * m) * 8, k0, bf[hf]);
    }
    mma_pair(c[N0 + 2 * m], c[N0 + 2 * m + 1], a, ah, bf, bh);
  }
}

// The A fragments (hi in a[0], lo in a[1]) of k-step ks of an fp32
// accumulator tile c (a warp's 16 rows; its columns are the k dimension)
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&c)[N][4], int ks,
                                         uint32_t (*a)[4]) {
  split_bf16(c[2 * ks][0], c[2 * ks][1], a[0][0], a[1][0]);
  split_bf16(c[2 * ks][2], c[2 * ks][3], a[0][1], a[1][1]);
  split_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1], a[0][2], a[1][2]);
  split_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3], a[0][3], a[1][3]);
}

// A fragments from `halves` halves of a tile (hi, then lo `half` elements
// on), summed, each element times the scale of its row (s_lo for rows m0 +
// 0..7, s_hi for m0 + 8..15; frag_a's layout) or, where `trans`, of its k
// column (the four scales of k0 + 2tg, + 1, + 8, + 9; frag_a_t's layout),
// split again into hi and lo
template <bool kTrans>
__device__ __forceinline__ void scaled_a(const __nv_bfloat16* t, int half,
                                         int halves, int ld, int m0, int k0,
                                         const float* s, uint32_t (*a)[4]) {
  uint32_t raw[2][4];
  if (kTrans) {
    frag_a_t(t, ld, m0, k0, raw[0]);
    if (halves > 1) frag_a_t(t + half, ld, m0, k0, raw[1]);
  } else {
    frag_a(t, ld, m0, k0, raw[0]);
    if (halves > 1) frag_a(t + half, ld, m0, k0, raw[1]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 v = unpack_bf16(raw[0][e]);
    if (halves > 1) {
      const float2 l = unpack_bf16(raw[1][e]);
      v.x += l.x;
      v.y += l.y;
    }
    // frag_a: e & 1 picks the row (m0 + 8); frag_a_t: e >= 2 picks k + 8
    const float s0 = kTrans ? s[(e >> 1) * 2] : s[e & 1];
    const float s1 = kTrans ? s[(e >> 1) * 2 + 1] : s[e & 1];
    split_bf16(v.x * s0, v.y * s1, a[0][e], a[1][e]);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// ------------------------------------------------------------- step 1
// grid (nc * n_dt * n_st, nh, Bt): block (k, h, b) takes head-dim rows
// [d0, d0 + 64) and state columns [s0, s0 + NS) of chunk k's S_k and D_k.
// Warp w owns 16 head-dim rows; the A fragments of x^T and dy^T come by
// ldmatrix.trans, scaled by their row's factor and split in registers.
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm,
                         const float* __restrict__ dy,
                         float* __restrict__ states,
                         float* __restrict__ dstates,
                         float* __restrict__ decay, int S, int nh, int hd,
                         int chunk, long long x_bs, long long x_ts,
                         long long bc_bs, long long bc_ts) {
  constexpr int H2 = kHalves<T>;
  constexpr int NS = DS < kT ? DS : kT;
  constexpr int n_st = DS / NS;
  constexpr int XLD = kT + kPad, BLD = NS + kPad;
  constexpr int XT = kT * XLD, BT = kT * BLD;
  const int nc = (S + chunk - 1) / chunk;
  const int k = blockIdx.x % nc, sub = blockIdx.x / nc;
  const int d0 = (sub / n_st) * kT, s0 = (sub % n_st) * NS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = k * chunk, valid = min(chunk, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int dcols = min(kT, hd - d0);
  const bool active = warp * 16 < dcols;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [H2]
  __nv_bfloat16* ys = xs + H2 * XT;       // dy, [2]
  __nv_bfloat16* bs = ys + 2 * XT;        // [H2]
  __nv_bfloat16* cs = bs + H2 * BT;       // [H2]
  float* dtv = reinterpret_cast<float*>(cs + H2 * BT);
  float* hi = dtv + chunk;                // the decay, compensated
  float* lo = hi + chunk;
  float* sc = lo + chunk;                 // dt_j e^(cum_last - cum_j)
  float* ec = sc + chunk;                 // e^cum_j

  load_dt(dt + ((size_t)b * S + t0) * nh + h, nh, valid, chunk, dtv);
  __syncthreads();
  if (warp == 0) chunk_cumsum2(dtv, chunk, A[h], hi, lo);
  __syncthreads();
  const int last = chunk - 1;
  for (int t = tid; t < chunk; t += kThreads) {
    sc[t] = dtv[t] * exp2_approx(cum_diff(hi, lo, last, t));
    ec[t] = exp2_approx(hi[t] + lo[t]);
  }
  if (sub == 0 && tid == 0)
    decay[((size_t)b * nc + k) * nh + h] = exp2_approx(hi[last] + lo[last]);

  float sa[NS / 8][4], da[NS / 8][4];
#pragma unroll
  for (int n = 0; n < NS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[n][e] = da[n][e] = 0.f;
  const size_t y_ts = (size_t)nh * hd;
  const T* xb = x + b * x_bs + (size_t)t0 * x_ts + (size_t)h * hd + d0;
  const float* yb = dy + ((size_t)b * S + t0) * y_ts + (size_t)h * hd + d0;
  const T* bb = Bm + b * bc_bs + (size_t)t0 * bc_ts + s0;
  const T* cb = Cm + b * bc_bs + (size_t)t0 * bc_ts + s0;
  const int n_jt = (valid + kT - 1) / kT;
  for (int jt = 0; jt < n_jt; ++jt) {
    const int j0 = jt * kT, v = valid - j0;
    load_tile<T>(xs, XLD, xb + (size_t)j0 * x_ts, x_ts, kT, dcols, v);
    load_tile<float>(ys, XLD, yb + (size_t)j0 * y_ts, y_ts, kT, dcols, v);
    load_tile<T>(bs, BLD, bb + (size_t)j0 * bc_ts, bc_ts, kT, NS, v);
    load_tile<T>(cs, BLD, cb + (size_t)j0 * bc_ts, bc_ts, kT, NS, v);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();                      // the tiles, and sc, ec
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const int jl = kk * 16, j = j0 + jl + 2 * tg;
        const float ss[4] = {sc[j], sc[j + 1], sc[j + 8], sc[j + 9]};
        const float se[4] = {ec[j], ec[j + 1], ec[j + 8], ec[j + 9]};
        uint32_t xa[2][4], ya[2][4];
        scaled_a<true>(xs, XT, H2, XLD, warp * 16, jl, ss, xa);
        scaled_a<true>(ys, XT, 2, XLD, warp * 16, jl, se, ya);
#pragma unroll
        for (int n = 0; n < NS / 8; n += 2) {
          uint32_t bf[2][4], cf[2][4];
#pragma unroll
          for (int hf = 0; hf < H2; ++hf) {
            frag_b_t(bs + hf * BT, BLD, n * 8, jl, bf[hf]);
            frag_b_t(cs + hf * BT, BLD, n * 8, jl, cf[hf]);
          }
          mma_pair(sa[n], sa[n + 1], xa, 2, bf, H2);
          mma_pair(da[n], da[n + 1], ya, 2, cf, H2);
        }
      }
    }
    __syncthreads();                      // the tiles read before reload
  }
  if (!active) return;
  const size_t row =
      (((size_t)b * nc + k) * nh + h) * hd + d0 + warp * 16 + gr;
#pragma unroll
  for (int n = 0; n < NS / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t o = (row + 8 * r) * DS + s0 + n * 8 + 2 * tg;
      store2(states + o, sa[n][2 * r], sa[n][2 * r + 1]);
      store2(dstates + o, da[n][2 * r], da[n][2 * r + 1]);
    }
}

// ------------------------------------------------------------- step 2
// grid (ceil(hd ds / 256), nh, Bt): one thread per state entry of (b, h):
// forward through the chunks (states: S_k in, H_in_k out), then back
// (dstates: D_k in, dH_out_k out), then dh0.
__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_pass_kernel(const float* __restrict__ h0,
                        const float* __restrict__ dh,
                        float* __restrict__ states,
                        float* __restrict__ dstates,
                        const float* __restrict__ decay,
                        float* __restrict__ dh0, int nc, int nh,
                        int n_state) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= n_state) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * nh + h;
  // four chunks' terms and decays loaded before they are used
  constexpr int kAhead = 4;
  float H = h0[head * n_state + e];
  for (int k0 = 0; k0 < nc; k0 += kAhead) {
    float Sk[kAhead], dk[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const size_t bk = ((size_t)b * nc + min(k0 + q, nc - 1)) * nh + h;
      Sk[q] = states[bk * n_state + e];
      dk[q] = decay[bk];
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (k0 + q >= nc) break;
      const size_t bk = ((size_t)b * nc + k0 + q) * nh + h;
      states[bk * n_state + e] = H;
      H = dk[q] * H + Sk[q];
    }
  }
  float G = dh[head * n_state + e];
  for (int k0 = nc - 1; k0 >= 0; k0 -= kAhead) {
    float Dk[kAhead], dk[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const size_t bk = ((size_t)b * nc + max(k0 - q, 0)) * nh + h;
      Dk[q] = dstates[bk * n_state + e];
      dk[q] = decay[bk];
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (k0 - q < 0) break;
      const size_t bk = ((size_t)b * nc + k0 - q) * nh + h;
      dstates[bk * n_state + e] = G;
      G = dk[q] * G + Dk[q];
    }
  }
  dh0[head * n_state + e] = G;
}

// ------------------------------------------------------------- step 3
// grid (nc, groups, nt Bt): block (chunk k, group g of hpg heads, tile jt
// slowest, row b) owns rows j of tile jt, warp w the tile's rows 16 w ..
// 16 w + 15. C.B^T is formed once a tile pair, for all the group's heads.
// Shared memory: the bf16 tiles C_i [H2], dy_i [2], B_j [H2] and x_j [H2]
// (x and dy: the group's columns, heads side by side), the fp32 tile K^T,
// the dcum shares of the (j, j) tile,
// dcum's column part, the state update's share, dt and ddt's direct part
// of rows j (fp64 but the last; [4][64] each), then the heads' dt and
// compensated decay ([hpg][c] each). The state pieces (the group's rows of
// dH_out, then of H_in, 64 state columns at a time, hi + lo) lie over C_i
// and dy_i, then over B_j, x_j and K^T. dsum [Bt, nc, nh, nt +
// 2, c] fp64 takes per head: in slot t < nt the (i, t) tiles' shares of
// dcum's row part at rows i (and the carried state's term at the rows of
// tile t), in slot nt the column part (negated in step 5), in slot nt + 1
// the state update's share of each row; ddv [Bt, nc, nh, c] ddt's direct
// part.
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ dy,
                      const float* __restrict__ hin,
                      const float* __restrict__ dhout, T* __restrict__ dx,
                      double* __restrict__ dsum, float* __restrict__ ddv,
                      int S, int nh, int hd, int chunk, long long x_bs,
                      long long x_ts, long long bc_bs, long long bc_ts) {
  constexpr int H2 = kHalves<T>;
  constexpr int BLD = DS + kPad, BT = kT * BLD;
  constexpr int XLD = kCols3 + kPad, XT = kT * XLD;
  constexpr int PW = DS < 64 ? DS : 64, PLD = PW + kPad;
  constexpr int PT = kCols3 * PLD;        // one half of a state piece
  constexpr int NB = kCols3 / 8;          // n-blocks of the group's columns
  const int nc = (S + chunk - 1) / chunk, nt = chunk / kT;
  const int hpg = heads_per_group(kCols3, hd);
  const int k = blockIdx.x, g = blockIdx.y;
  const int Bt = gridDim.z / nt;
  const int jt = blockIdx.z / Bt, b = blockIdx.z % Bt;
  const int t0 = k * chunk, valid = min(chunk, S - t0);
  const int j0 = jt * kT;
  if (j0 >= valid) return;                // the tile lies wholly past S
  const int h0 = g * hpg, ng = min(hpg, nh - h0), cols = ng * hd;
  const int nbh = hd / 8;                 // n-blocks a head
  const int n_it = (valid + kT - 1) / kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int last = chunk - 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ys = cs + H2 * BT;
  __nv_bfloat16* bs = ys + 2 * XT;
  __nv_bfloat16* xs = bs + H2 * BT;
  float* kt = reinterpret_cast<float*>(xs + H2 * XT);
  double* posj = reinterpret_cast<double*>(kt + kT * kKLD);
  double* negs = posj + kMaxHpg * kT;
  double* sjs = negs + kMaxHpg * kT;
  double* dtd = sjs + kMaxHpg * kT;       // dt of rows j in fp64
  float* dds = reinterpret_cast<float*>(dtd + kMaxHpg * kT);
  float* dtv = dds + kMaxHpg * kT;
  float* chi = dtv + hpg * chunk;
  float* clo = chi + hpg * chunk;

  const size_t y_ts = (size_t)nh * hd;
  const T* xb = x + b * x_bs + (size_t)t0 * x_ts + (size_t)h0 * hd;
  const float* yb = dy + ((size_t)b * S + t0) * y_ts + (size_t)h0 * hd;
  const T* bb = Bm + b * bc_bs + (size_t)t0 * bc_ts;
  const T* cb = Cm + b * bc_bs + (size_t)t0 * bc_ts;
  load_tile<T>(xs, XLD, xb + (size_t)j0 * x_ts, x_ts, kT, cols, valid - j0);
  load_tile<T>(bs, BLD, bb + (size_t)j0 * bc_ts, bc_ts, kT, DS, valid - j0);
  cp_async_commit();
  for (int hh = 0; hh < ng; ++hh)
    load_dt(dt + ((size_t)b * S + t0) * nh + h0 + hh, nh, valid, chunk,
            dtv + hh * chunk);
  for (int e = tid; e < kMaxHpg * kT; e += kThreads) {
    posj[e] = negs[e] = sjs[e] = 0.0;
    dds[e] = 0.f;
  }
  __syncthreads();
  if (warp < ng)
    chunk_cumsum2(dtv + warp * chunk, chunk, A[h0 + warp], chi + warp * chunk,
                  clo + warp * chunk);
  for (int e = tid; e < ng * kT; e += kThreads)
    dtd[e] = (double)dtv[(e / kT) * chunk + j0 + e % kT];
  cp_async_wait<0>();
  __syncthreads();

  float dxa[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[n][e] = 0.f;

  for (int it = jt; it < n_it; ++it) {
    const int i0 = it * kT;
    load_tile<T>(cs, BLD, cb + (size_t)i0 * bc_ts, bc_ts, kT, DS, valid - i0);
    load_tile<float>(ys, XLD, yb + (size_t)i0 * y_ts, y_ts, kT, cols,
                     valid - i0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // CB^T = B_j C_i^T: the warp's rows j, the tile's 64 columns i; once
    // for the group's heads
    float cbt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cbt[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DS / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int hf = 0; hf < H2; ++hf)
        frag_a(bs + hf * BT, BLD, warp * 16, ks * 16, a[hf]);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t bf[2][4];
#pragma unroll
        for (int hf = 0; hf < H2; ++hf)
          frag_b(cs + hf * BT, BLD, n * 8, ks * 16, bf[hf]);
        mma_pair(cbt[n], cbt[n + 1], a, H2, bf, H2);
      }
    }
    for (int hh = 0; hh < ng; ++hh) {
      const float* dth = dtv + hh * chunk;
      const float* hi = chi + hh * chunk;
      const float* lo = clo + hh * chunk;
      // G^T = x_j dy_i^T over the head's columns
      float gt[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gt[n][e] = 0.f;
      for (int ks = 0; ks < nbh / 2; ++ks) {
        const int kc = hh * hd + ks * 16;
        uint32_t a[2][4];
#pragma unroll
        for (int hf = 0; hf < H2; ++hf)
          frag_a(xs + hf * XT, XLD, warp * 16, kc, a[hf]);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t bf[2][4];
          frag_b(ys, XLD, n * 8, kc, bf[0]);
          frag_b(ys + XT, XLD, n * 8, kc, bf[1]);
          mma_pair(gt[n], gt[n + 1], a, H2, bf, 2);
        }
      }
      // L^T masked to i >= j (and i inside S) before the exponential; W^T
      // = CB^T L^T dt_j into gt, K^T = CB^T (G^T L^T) into kt. The rows'
      // decay and dt are read before the stores into kt, which the
      // compiler cannot tell apart from them
      float rhi[2], rlo[2], rdt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jl = j0 + warp * 16 + gr + 8 * r;
        rhi[r] = hi[jl];
        rlo[r] = lo[jl];
        rdt[r] = dth[jl];
      }
      // K^T in registers first, stored after: a store between them would
      // keep each column's decay load behind it
      float kv[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int jl = j0 + warp * 16 + gr + 8 * r;
          const int il = i0 + n * 8 + 2 * tg + (e & 1);
          const bool vis = il >= jl && il < valid;
          const float L =
              vis ? exp2_approx((hi[il] - rhi[r]) + (lo[il] - rlo[r])) : 0.f;
          kv[n][e] = cbt[n][e] * (gt[n][e] * L);
          gt[n][e] = cbt[n][e] * L * rdt[r];
        }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kt[(warp * 16 + gr + 8 * (e >> 1)) * kKLD + n * 8 + 2 * tg +
             (e & 1)] = kv[n][e];
      // dx_j += W^T dy_i, the head's columns (head_dim 64: its 4 pairs
      // of n-blocks without a branch between them)
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        uint32_t wa[2][4];
        acc_to_a(gt, ks, wa);
        if (nbh == 8 && hh == 0) {
          mma_pairs<true, 0, 4>(dxa, wa, 2, ys, XT, 2, XLD, ks * 16);
        } else if (nbh == 8 && hh == 1) {
          mma_pairs<true, 8, 4>(dxa, wa, 2, ys, XT, 2, XLD, ks * 16);
        } else {
#pragma unroll
          for (int n = 0; n < NB; n += 2) {
            if (n / nbh != hh) continue;
            uint32_t bf[2][4];
            frag_b_t(ys, XLD, n * 8, ks * 16, bf[0]);
            frag_b_t(ys + XT, XLD, n * 8, ks * 16, bf[1]);
            mma_pair(dxa[n], dxa[n + 1], wa, 2, bf, 2);
          }
        }
      }
      __syncthreads();                    // K^T written
      if (tid < kT) {
        // column i: sum_j K_ij dt_j, the (i, j) tile's share of dcum_i,
        // rows j = 4 m + q into four sums, then those in a fixed order
        double sq[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
        for (int j = 0; j < kT; j += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sq[q] = fma((double)kt[(j + q) * kKLD + tid],
                        dtd[hh * kT + j + q], sq[q]);
        const double s = (sq[0] + sq[1]) + (sq[2] + sq[3]);
        if (it == jt)
          posj[hh * kT + tid] = s;
        else
          dsum[((((size_t)b * nc + k) * nh + h0 + hh) * (nt + 2) + jt) *
                   chunk + i0 + tid] = s;
      } else {
        // row j: sum_i K_ij, into dcum's column part and ddt's direct part
        const int j = tid - kT;
        double sq[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
        for (int i = 0; i < kT; i += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q) sq[q] += (double)kt[j * kKLD + i + q];
        const double s = (sq[0] + sq[1]) + (sq[2] + sq[3]);
        negs[hh * kT + j] = fma(dtd[hh * kT + j], s, negs[hh * kT + j]);
        dds[hh * kT + j] += (float)s;
      }
      __syncthreads();                    // K^T read; C_i, dy_i too
    }
  }

  // the state update's terms of rows j: u = B_j dH_out^T for every head of
  // the group at once (its rows of dH_out are the group's columns)
  const size_t st0 = (((size_t)b * nc + k) * nh + h0) * (size_t)hd * DS;
  float ua[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ua[n][e] = 0.f;
  __nv_bfloat16* mp = cs;                 // over C_i and dy_i
#pragma unroll
  for (int q = 0; q < DS / PW; ++q) {
    load_tile<float>(mp, PLD, dhout + st0 + q * PW, DS, kCols3, PW, cols);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < PW / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int hf = 0; hf < H2; ++hf)
        frag_a(bs + hf * BT, BLD, warp * 16, q * PW + ks * 16, a[hf]);
      if (cols == kCols3) {
        mma_pairs<false, 0, NB / 2>(ua, a, H2, mp, PT, 2, PLD, ks * 16);
      } else {
#pragma unroll
        for (int n = 0; n < NB; n += 2) {
          if (n * 8 >= cols) break;
          uint32_t bf[2][4];
          frag_b(mp, PLD, n * 8, ks * 16, bf[0]);
          frag_b(mp + PT, PLD, n * 8, ks * 16, bf[1]);
          mma_pair(ua[n], ua[n + 1], a, H2, bf, 2);
        }
      }
    }
    __syncthreads();
  }
  // dx_j += f u, f = dt_j e^(cum_last - cum_j); sx_j = x_j . u into ddt's
  // direct part (times e^..) and dcum (times f); then dx_j's store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int jr = warp * 16 + gr + 8 * r, jl = j0 + jr;
    for (int hh = 0; hh < ng; ++hh) {
      const float* dth = dtv + hh * chunk;
      const float* hi = chi + hh * chunk;
      const float* lo = clo + hh * chunk;
      const float tl = exp2_approx(cum_diff(hi, lo, last, jl));
      const float f = dth[jl] * tl;
      float sx = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n / nbh != hh) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = jr * XLD + n * 8 + 2 * tg + e;
          float xv = __bfloat162float(xs[c]);
          if (H2 == 2) xv += __bfloat162float(xs[XT + c]);
          const float u = ua[n][2 * r + e];
          sx = fmaf(xv, u, sx);
          dxa[n][2 * r + e] = fmaf(f, u, dxa[n][2 * r + e]);
        }
      }
      sx += __shfl_xor_sync(0xffffffffu, sx, 1);
      sx += __shfl_xor_sync(0xffffffffu, sx, 2);
      if (tg == 0) {
        dds[hh * kT + jr] = fmaf(tl, sx, dds[hh * kT + jr]);
        const double sj = (double)f * (double)sx;
        sjs[hh * kT + jr] = sj;
        negs[hh * kT + jr] += sj;
      }
    }
    if (jl < valid) {
      T* dr = dx + ((size_t)b * S + t0 + jl) * y_ts + (size_t)h0 * hd;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n * 8 >= cols) break;
        store2(dr + n * 8 + 2 * tg, dxa[n][2 * r], dxa[n][2 * r + 1]);
      }
    }
  }

  // the carried state's term of rows i of tile jt: z = C_i H_in^T for the
  // group's heads, e^cum_i dy_i . z into dcum_i; C_i and dy_i of this tile
  // again, the state pieces over B_j, x_j and K^T
  __syncthreads();                        // x_j and B_j read
  load_tile<T>(cs, BLD, cb + (size_t)j0 * bc_ts, bc_ts, kT, DS, valid - j0);
  load_tile<float>(ys, XLD, yb + (size_t)j0 * y_ts, y_ts, kT, cols,
                   valid - j0);
  cp_async_commit();
  float za[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) za[n][e] = 0.f;
  __nv_bfloat16* mq = bs;
#pragma unroll
  for (int q = 0; q < DS / PW; ++q) {
    load_tile<float>(mq, PLD, hin + st0 + q * PW, DS, kCols3, PW, cols);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < PW / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int hf = 0; hf < H2; ++hf)
        frag_a(cs + hf * BT, BLD, warp * 16, q * PW + ks * 16, a[hf]);
      if (cols == kCols3) {
        mma_pairs<false, 0, NB / 2>(za, a, H2, mq, PT, 2, PLD, ks * 16);
      } else {
#pragma unroll
        for (int n = 0; n < NB; n += 2) {
          if (n * 8 >= cols) break;
          uint32_t bf[2][4];
          frag_b(mq, PLD, n * 8, ks * 16, bf[0]);
          frag_b(mq + PT, PLD, n * 8, ks * 16, bf[1]);
          mma_pair(za[n], za[n + 1], a, H2, bf, 2);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ir = warp * 16 + gr + 8 * r, il = j0 + ir;
    for (int hh = 0; hh < ng; ++hh) {
      float cv = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n / nbh != hh) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ir * XLD + n * 8 + 2 * tg + e;
          const float yv =
              __bfloat162float(ys[c]) + __bfloat162float(ys[XT + c]);
          cv = fmaf(yv, za[n][2 * r + e], cv);
        }
      }
      cv += __shfl_xor_sync(0xffffffffu, cv, 1);
      cv += __shfl_xor_sync(0xffffffffu, cv, 2);
      if (tg == 0) {
        const float e =
            exp2_approx(chi[hh * chunk + il] + clo[hh * chunk + il]);
        posj[hh * kT + ir] += (double)(e * cv);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < ng * kT; e += kThreads) {
    const int hh = e / kT, r = e % kT;
    const size_t bkh = ((size_t)b * nc + k) * nh + h0 + hh;
    double* o = dsum + bkh * (nt + 2) * chunk + j0 + r;
    o[(size_t)jt * chunk] = posj[e];
    o[(size_t)nt * chunk] = negs[e];
    o[(size_t)(nt + 1) * chunk] = sjs[e];
    ddv[bkh * chunk + j0 + r] = dds[e];
  }
}

// ------------------------------------------------------------- step 4
// grid (2 nc, groups, nt Bt): block (chunk k, dC or dB, group g of hpg
// heads, tile slot slowest, row b). dC takes tile t = nt - 1 - slot (rows
// i, partner tiles j <= t), dB tile t = slot (rows j, partner tiles i >=
// t), so the blocks with the most partners come first. Shared memory: the
// row operand R (dC: dy_t; dB: x_t) and the partner P (dC: x_p; dB: dy_p),
// each the group's columns, hi + lo; the product partner Y (dC: B_p; dB:
// C_p); the group's dt and compensated decay. The state pieces (the
// group's rows of H_in or dH_out, 64 state columns at a time) lie over P
// and Y.
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dbdc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm,
                        const float* __restrict__ dy,
                        const float* __restrict__ hin,
                        const float* __restrict__ dhout,
                        float* __restrict__ dBg, float* __restrict__ dCg,
                        int S, int nh, int hd, int chunk, long long x_bs,
                        long long x_ts, long long bc_bs, long long bc_ts) {
  constexpr int H2 = kHalves<T>;
  constexpr int BLD = DS + kPad, BT = kT * BLD;
  constexpr int RLD = kCols4 + kPad, RT = kT * RLD;
  constexpr int PW = DS < 64 ? DS : 64, PLD = PW + kPad;
  constexpr int PT = kCols4 * PLD;
  constexpr int NB = DS / 8;
  const int nc = (S + chunk - 1) / chunk, nt = chunk / kT;
  const int hpg = heads_per_group(kCols4, hd);
  const int k = blockIdx.x >> 1;
  const bool is_dc = (blockIdx.x & 1) == 0;
  const int g = blockIdx.y;
  const int Bt = gridDim.z / nt;
  const int slot = blockIdx.z / Bt, b = blockIdx.z % Bt;
  const int t = is_dc ? nt - 1 - slot : slot;
  const int t0 = k * chunk, valid = min(chunk, S - t0);
  const int r0 = t * kT;
  if (r0 >= valid) return;                // the tile lies wholly past S
  const int n_p = (valid + kT - 1) / kT;
  const int p_lo = is_dc ? 0 : t, p_hi = is_dc ? t : n_p - 1;
  const int h0 = g * hpg, ng = min(hpg, nh - h0), cols = ng * hd;
  const int nbh = hd / 8;
  const int RH = is_dc ? 2 : H2, PH = is_dc ? H2 : 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int last = chunk - 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2]
  __nv_bfloat16* ps = rs + 2 * RT;        // [2]
  __nv_bfloat16* ys = ps + 2 * RT;        // [H2]
  float* dtv = reinterpret_cast<float*>(ys + H2 * BT);
  float* chi = dtv + hpg * chunk;
  float* clo = chi + hpg * chunk;

  const size_t y_ts = (size_t)nh * hd;
  const T* xb = x + b * x_bs + (size_t)t0 * x_ts + (size_t)h0 * hd;
  const float* yb = dy + ((size_t)b * S + t0) * y_ts + (size_t)h0 * hd;
  const T* pb = (is_dc ? Bm : Cm) + b * bc_bs + (size_t)t0 * bc_ts;
  if (is_dc)
    load_tile<float>(rs, RLD, yb + (size_t)r0 * y_ts, y_ts, kT, cols,
                     valid - r0);
  else
    load_tile<T>(rs, RLD, xb + (size_t)r0 * x_ts, x_ts, kT, cols, valid - r0);
  cp_async_commit();
  for (int hh = 0; hh < ng; ++hh)
    load_dt(dt + ((size_t)b * S + t0) * nh + h0 + hh, nh, valid, chunk,
            dtv + hh * chunk);
  __syncthreads();
  if (warp < ng)
    chunk_cumsum2(dtv + warp * chunk, chunk, A[h0 + warp], chi + warp * chunk,
                  clo + warp * chunk);

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int p = p_lo; p <= p_hi; ++p) {
    const int p0 = p * kT;
    if (is_dc)
      load_tile<T>(ps, RLD, xb + (size_t)p0 * x_ts, x_ts, kT, cols,
                   valid - p0);
    else
      load_tile<float>(ps, RLD, yb + (size_t)p0 * y_ts, y_ts, kT, cols,
                       valid - p0);
    load_tile<T>(ys, BLD, pb + (size_t)p0 * bc_ts, bc_ts, kT, DS, valid - p0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();                      // the tiles (and the decay)
    // QS = sum over the group's heads of G o L o dt (dC: G = dy_t x_p^T,
    // rows i, dt_j of the columns; dB: G^T = x_t dy_p^T, rows j, dt_j of
    // the rows), in head order
    float qs[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) qs[n][e] = 0.f;
    for (int hh = 0; hh < ng; ++hh) {
      const float* dth = dtv + hh * chunk;
      const float* hi = chi + hh * chunk;
      const float* lo = clo + hh * chunk;
      float gq[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gq[n][e] = 0.f;
      for (int ks = 0; ks < nbh / 2; ++ks) {
        const int kc = hh * hd + ks * 16;
        uint32_t a[2][4];
        frag_a(rs, RLD, warp * 16, kc, a[0]);
        if (RH > 1) frag_a(rs + RT, RLD, warp * 16, kc, a[1]);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t bf[2][4];
          frag_b(ps, RLD, n * 8, kc, bf[0]);
          if (PH > 1) frag_b(ps + RT, RLD, n * 8, kc, bf[1]);
          mma_pair(gq[n], gq[n + 1], a, RH, bf, PH);
        }
      }
      float rhi[2], rlo[2], rdt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = r0 + warp * 16 + gr + 8 * r;
        rhi[r] = hi[rl];
        rlo[r] = lo[rl];
        rdt[r] = dth[rl];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int rl = r0 + warp * 16 + gr + 8 * r;
          const int pl = p0 + n * 8 + 2 * tg + (e & 1);
          const bool vis = is_dc ? (pl <= rl && rl < valid)
                                 : (rl <= pl && pl < valid);
          const float d = is_dc ? (rhi[r] - hi[pl]) + (rlo[r] - lo[pl])
                                : (hi[pl] - rhi[r]) + (lo[pl] - rlo[r]);
          const float L = vis ? exp2_approx(d) : 0.f;
          qs[n][e] += gq[n][e] * L * (is_dc ? dth[pl] : rdt[r]);
        }
    }
    // acc += QS Y_p over the partner's 64 rows
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
      uint32_t qa[2][4];
      acc_to_a(qs, ks, qa);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bf[2][4];
#pragma unroll
        for (int hf = 0; hf < H2; ++hf)
          frag_b_t(ys + hf * BT, BLD, n * 8, ks * 16, bf[hf]);
        mma_pair(acc[n], acc[n + 1], qa, 2, bf, H2);
      }
    }
    __syncthreads();                      // P and Y read before reload
  }

  // the state terms, every head of the group as one product over its
  // head-dim rows: dC += (e^cum_i dy_i) H_in, dB += (f_j x_j) dH_out
  const float* M = (is_dc ? hin : dhout) +
                   (((size_t)b * nc + k) * nh + h0) * (size_t)hd * DS;
  __nv_bfloat16* mp = ps;
  const int ra = r0 + warp * 16 + gr;     // this thread's rows ra, ra + 8
#pragma unroll
  for (int q = 0; q < DS / PW; ++q) {
    load_tile<float>(mp, PLD, M + q * PW, DS, kCols4, PW, cols);
    cp_async_wait<0>();
    __syncthreads();
    for (int kk = 0; kk < cols / 16; ++kk) {
      const int hh = kk * 16 / hd;
      const float* hi = chi + hh * chunk;
      const float* lo = clo + hh * chunk;
      const float* dth = dtv + hh * chunk;
      float s[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ra + 8 * r;
        s[r] = is_dc ? exp2_approx(hi[row] + lo[row])
                     : dth[row] * exp2_approx(cum_diff(hi, lo, last, row));
      }
      uint32_t a[2][4];
      scaled_a<false>(rs, RT, RH, RLD, warp * 16, kk * 16, s, a);
#pragma unroll
      for (int n = 0; n < PW / 8; n += 2) {
        uint32_t bf[2][4];
        frag_b_t(mp, PLD, n * 8, kk * 16, bf[0]);
        frag_b_t(mp + PT, PLD, n * 8, kk * 16, bf[1]);
        mma_pair(acc[q * (PW / 8) + n], acc[q * (PW / 8) + n + 1], a, 2, bf,
                 2);
      }
    }
    __syncthreads();
  }
  float* out = (is_dc ? dCg : dBg) +
               (((size_t)b * gridDim.y + g) * S + t0) * DS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= valid) continue;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store2(out + (size_t)row * DS + n * 8 + 2 * tg, acc[n][2 * r],
             acc[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------- step 5
// grid (nc, nh, Bt), one block per (chunk k, head h, row b): dcum_t, the
// tiles' shares of its row part in tile order less its column part (fp64),
// plus at the last valid row the state update's shares summed in a fixed
// order and e^cum_last <dH_out, H_in> (each thread its entries, then the
// lanes, then the warps); R_t = sum_{i>=t} dcum_i by warp 0 (lane l: rows
// [l c/32, (l+1) c/32) from their end, then the lanes after it); ddt and
// the block's share of dA.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcum_kernel(const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ hin,
                        const float* __restrict__ dhout,
                        const double* __restrict__ dsum,
                        const float* __restrict__ ddv,
                        float* __restrict__ ddt, float* __restrict__ dA_part,
                        int S, int nh, int n_state, int chunk) {
  const int nc = (S + chunk - 1) / chunk, nt = chunk / kT;
  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = k * chunk, valid = min(chunk, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* dc = reinterpret_cast<double*>(smem_raw);
  float* dtv = reinterpret_cast<float*>(dc + chunk);
  float* hi = dtv + chunk;
  float* lo = hi + chunk;
  float* red = lo + chunk;                // [4]

  load_dt(dt + ((size_t)b * S + t0) * nh + h, nh, valid, chunk, dtv);
  const size_t bkh = ((size_t)b * nc + k) * nh + h;
  const double* ds = dsum + bkh * (nt + 2) * chunk;
  for (int t = tid; t < chunk; t += kThreads) {
    double v = 0.0;
    if (t < valid) {
      for (int s = 0; s <= t / kT; ++s) v += ds[(size_t)s * chunk + t];
      v -= ds[(size_t)nt * chunk + t];
    }
    dc[t] = v;
  }
  float hdot = 0.f;
#pragma unroll 8
  for (int e = tid; e < n_state; e += kThreads)
    hdot = fmaf(dhout[bkh * n_state + e], hin[bkh * n_state + e], hdot);
  hdot = warp_sum(hdot);
  if (lane == 0) red[warp] = hdot;
  __syncthreads();
  if (warp != 0) return;
  chunk_cumsum2(dtv, chunk, A[h], hi, lo);
  hdot = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) hdot += red[w];
  const int last = chunk - 1;
  const int per = chunk / 32, base = lane * per;
  double s = 0.0;
  for (int q = 0; q < per; ++q)
    if (base + q < valid) s += ds[(size_t)(nt + 1) * chunk + base + q];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const double add =
      s + (double)exp2_approx(hi[last] + lo[last]) * (double)hdot;
  double run = 0.0;
  for (int q = per - 1; q >= 0; --q) {
    const int t = base + q;
    run += dc[t] + (t == valid - 1 ? add : 0.0);
    dc[t] = run;
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
      const double R = dc[t] + excl;
      ddt[((size_t)b * S + t0 + t) * nh + h] =
          (float)fma(Ah, R, (double)ddv[bkh * chunk + t]);
      da = fma((double)dtv[t], R, da);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0) dA_part[bkh] = (float)da;
}

// ------------------------------------------------------------- step 6
// One thread per (b, t, s) of dB, then of dC: the groups' partials
// [Bt, groups, S, ds] summed in group order, in the input's dtype; then
// one per head of dA, the blocks' shares summed over rows, then chunks.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBg,
                                      const float* __restrict__ dCg,
                                      const float* __restrict__ dA_part,
                                      T* __restrict__ dB, T* __restrict__ dC,
                                      float* __restrict__ dA, int Bt, int S,
                                      int ds, int groups, int nc, int nh,
                                      long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < 2 * n) {
    const bool c = e >= n;
    const long long f = c ? e - n : e;
    const long long row = (long long)S * ds;
    const long long b = f / row;
    const float* src = (c ? dCg : dBg) + b * groups * row + f % row;
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += src[(size_t)g * row];
    store_float(s, (c ? dC : dB) + f);
  } else if (e < 2 * n + nh) {
    const int h = (int)(e - 2 * n);
    float s = 0.f;
    for (int b = 0; b < Bt; ++b)
      for (int k = 0; k < nc; ++k) s += dA_part[((size_t)b * nc + k) * nh + h];
    dA[h] = s;
  }
}

template <typename T, int DS>
cudaError_t launch_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       const void* dy, const void* dh, void* dx, void* ddt,
                       void* dA, void* dB, void* dC, void* dh0, void* states,
                       void* dstates, void* decay, void* dsum, void* ddv,
                       void* dBg, void* dCg, void* dA_part, int Bt, int S,
                       int nh, int hd, int chunk, long long x_bs,
                       long long x_ts, long long bc_bs, long long bc_ts,
                       cudaStream_t stream) {
  if (chunk % kT || chunk > 1024 || hd % 16 || hd > kMaxHd || S < 1)
    return cudaErrorInvalidValue;
  constexpr int H2 = kHalves<T>;
  constexpr int NS = DS < kT ? DS : kT;
  constexpr int PW = DS < 64 ? DS : 64;
  const int nc = (S + chunk - 1) / chunk, nt = chunk / kT;
  const int n_dt = (hd + kT - 1) / kT;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dyf = static_cast<const float*>(dy);
  float* st = static_cast<float*>(states);
  float* dst = static_cast<float*>(dstates);
  float* dc = static_cast<float*>(decay);
  const size_t bf = sizeof(__nv_bfloat16), fl = sizeof(float);

  const size_t smem1 = ((2 + H2) * (size_t)kT * (kT + kPad) +
                        2 * H2 * (size_t)kT * (NS + kPad)) * bf +
                       5 * (size_t)chunk * fl;
  auto k1 = ssd_bwd_state_kernel<T, DS>;
  cudaError_t err = allow_smem(k1, smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc * n_dt * (DS / NS), nh, Bt), kThreads, smem1, stream>>>(
      xt, dtf, Af, bt, ct, dyf, st, dst, dc, S, nh, hd, chunk, x_bs, x_ts,
      bc_bs, bc_ts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_state = hd * DS;
  ssd_bwd_pass_kernel<<<dim3((n_state + kPassThreads - 1) / kPassThreads, nh,
                             Bt), kPassThreads, 0, stream>>>(
      static_cast<const float*>(h0), static_cast<const float*>(dh), st, dst,
      dc, static_cast<float*>(dh0), nc, nh, n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // step 3; a state piece (the group's rows, PW columns, hi + lo) must fit
  // over C_i and dy_i, and over B_j, x_j and the K^T tiles
  const size_t bt3 = (size_t)kT * (DS + kPad), xt3 = (size_t)kT * (kCols3 + kPad);
  const size_t piece3 = 2 * (size_t)kCols3 * (PW + kPad) * bf;
  if (piece3 > (H2 * bt3 + 2 * xt3) * bf ||
      piece3 > H2 * (bt3 + xt3) * bf + (size_t)kT * kKLD * fl)
    return cudaErrorInvalidValue;
  const int g3 = heads_per_group(kCols3, hd);
  const size_t smem3 = (2 * H2 * bt3 + (2 + H2) * xt3) * bf +
                       (size_t)kT * kKLD * fl + 4 * kMaxHpg * kT * 8 +
                       kMaxHpg * kT * fl + 3 * (size_t)g3 * chunk * fl;
  auto k3 = ssd_bwd_dx_kernel<T, DS>;
  err = allow_smem(k3, smem3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(nc, (nh + g3 - 1) / g3, nt * Bt), kThreads, smem3, stream>>>(
      xt, dtf, Af, bt, ct, dyf, st, dst, static_cast<T*>(dx),
      static_cast<double*>(dsum), static_cast<float*>(ddv), S, nh, hd, chunk,
      x_bs, x_ts, bc_bs, bc_ts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // step 4; a state piece must fit over P and Y
  const size_t rt4 = (size_t)kT * (kCols4 + kPad);
  if (2 * (size_t)kCols4 * (PW + kPad) > 2 * rt4 + H2 * (size_t)kT * (DS + kPad))
    return cudaErrorInvalidValue;
  const int g4 = heads_per_group(kCols4, hd);
  const int groups = (nh + g4 - 1) / g4;
  const size_t smem4 = (4 * rt4 + H2 * (size_t)kT * (DS + kPad)) * bf +
                       3 * (size_t)g4 * chunk * fl;
  auto k4 = ssd_bwd_dbdc_kernel<T, DS>;
  err = allow_smem(k4, smem4);
  if (err != cudaSuccess) return err;
  k4<<<dim3(2 * nc, groups, nt * Bt), kThreads, smem4, stream>>>(
      xt, dtf, Af, bt, ct, dyf, st, dst, static_cast<float*>(dBg),
      static_cast<float*>(dCg), S, nh, hd, chunk, x_bs, x_ts, bc_bs, bc_ts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem5 = (size_t)chunk * 8 + (3 * (size_t)chunk + 4) * fl;
  err = allow_smem(ssd_bwd_dcum_kernel, smem5);
  if (err != cudaSuccess) return err;
  ssd_bwd_dcum_kernel<<<dim3(nc, nh, Bt), kThreads, smem5, stream>>>(
      dtf, Af, st, dst, static_cast<const double*>(dsum),
      static_cast<const float*>(ddv), static_cast<float*>(ddt),
      static_cast<float*>(dA_part), S, nh, n_state, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n = (long long)Bt * S * DS;
  const unsigned blocks = (unsigned)((2 * n + nh + 255) / 256);
  ssd_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dBg), static_cast<const float*>(dCg),
      static_cast<const float*>(dA_part), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA), Bt, S, DS, groups, nc, nh,
      n);
  return cudaGetLastError();
}

}  // namespace

// The backward: x, B and C as the forward takes them (dtype code, strides,
// ds 16, 64 or 128, chunk a multiple of 64 up to 1024, any S >= 1), hd a
// multiple of 16 up to 128; dy [Bt, S, nh, hd] and dh [Bt, nh, hd, ds]
// fp32, contiguous. Outputs: dx [Bt, S, nh, hd] in x's dtype, contiguous;
// ddt [Bt, S, nh], dA [nh] and dh0 [Bt, nh, hd, ds] fp32; dB and dC
// [Bt, S, ds] in B's dtype. Scratch (kernels/ssd_scan.py::plan_bwd), nc =
// ceil(S / chunk), nt = chunk / 64, groups = ceil(nh / g) with g the heads
// whose columns fill 256 (at most 4): states and dstates, fp32 of Bt * nc
// * nh * hd * ds floats each; decay and dA_part, fp32 of Bt * nc * nh;
// dsum, fp64 of Bt * nc * nh * (nt + 2) * chunk; ddv, fp32 of Bt * nc * nh
// * chunk; dBg and dCg, fp32 [Bt, groups, S, ds] each.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* h0, const void* dy, const void* dh, void* dx,
    void* ddt, void* dA, void* dB, void* dC, void* dh0, void* states,
    void* dstates, void* decay, void* dsum, void* ddv, void* dBg, void* dCg,
    void* dA_part, int Bt, int S, int nh, int hd, int ds, int chunk,
    long long x_bs, long long x_ts, long long bc_bs, long long bc_ts,
    int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define SSD_BWD_LAUNCH(T, DS)                                                 \
  return launch_bwd<T, DS>(x, dt, A, Bm, Cm, h0, dy, dh, dx, ddt, dA, dB, dC, \
                           dh0, states, dstates, decay, dsum, ddv, dBg, dCg,  \
                           dA_part, Bt, S, nh, hd, chunk, x_bs, x_ts, bc_bs,  \
                           bc_ts, s)
  if (dtype == 0 && ds == 16) SSD_BWD_LAUNCH(float, 16);
  if (dtype == 0 && ds == 64) SSD_BWD_LAUNCH(float, 64);
  if (dtype == 0 && ds == 128) SSD_BWD_LAUNCH(float, 128);
  if (dtype == 1 && ds == 16) SSD_BWD_LAUNCH(__nv_bfloat16, 16);
  if (dtype == 1 && ds == 64) SSD_BWD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && ds == 128) SSD_BWD_LAUNCH(__nv_bfloat16, 128);
#undef SSD_BWD_LAUNCH
  return cudaErrorInvalidValue;
}
