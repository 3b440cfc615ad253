// Mamba2 SSD chunked scan for Hopper (sm_90a): the chunk-parallel form.
//
// Replaces: repro/kernels/ssd_scan.py::ssd_scan (`_kernel`), the Pallas
// kernel of the Mamba2 mixer's prefill (models/mamba2.py::ssd_chunked).
//
// Computes, for each row b and head h, over chunks of c tokens, with the
// fp32 state H [hd, ds] carried across chunks (H starts at h0[b, h]):
//   cum_i = sum_{t <= i} dt_t A_h                       (within the chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) H C_i
//   H    <- exp(cum_last) H + sum_j x_j (B_j dt_j exp(cum_last - cum_j))^T
// x [Bt, S, nh, hd] and B, C [Bt, S, ds] are read in the model's dtype
// (float32 or bfloat16), each with its own batch and token strides (the
// model passes slices of one projection); dt [Bt, S, nh], A [nh], y
// [Bt, S, nh, hd] and the state are fp32. Any S >= 1: the rows of the
// last chunk past S count as dt = 0, which leaves the state unchanged,
// and tiles that lie wholly past S are skipped.
//
// Bound: at one full-width 1024-token row (nh 32, hd 64, ds 128, c 256)
// the inputs and outputs are ~15 MB, 4.6 us at 3.35 TB/s; the products
// below are ~3.3 GFLOP of bf16 tensor-core work with the hi/lo split
// counted, 3.3 us at 989 TFLOP/s. So bytes bound it, but what holds the
// kernels back is the traffic between L2 and the SMs (tiles of B, C, x
// and the entering state re-read by the blocks that share them) and each
// block's chain of dependent loads and products; the design's aim is
// enough independent blocks, and few enough bytes a block, to hide it.
//
// Design: the Mamba2 paper's chunked decomposition (arXiv:2405.21060), in
// three kernels on one stream; the wrapper counts the call once.
//  1. ssd_chunk_state_kernel, one block per (chunk, head, 64 x 64 tile of
//     the state), all in parallel: the chunk's cumulative decay (a warp
//     scan in a fixed order), then S_k = x^T (B o dt o 2^(cum_last -
//     cum)) as an [hd x c] . [c x ds] product into the states scratch,
//     and the chunk's decay 2^cum_last into the decay scratch.
//  2. ssd_state_pass_kernel, one thread per 4 state entries of a (row,
//     head), over the chunks in order: H_k = decay_k H_{k-1} + S_k,
//     elementwise. It writes the state entering each chunk, already split
//     into bf16 hi + lo for the tensor cores, and the final state.
//  3. ssd_chunk_scan_kernel, one block per (128-row tile of a chunk, head,
//     64 head-dim columns), all in parallel, the tiles with the most work
//     issued first: y = 2^cum (C . H_in^T), then for each 64-column tile
//     j <= i of the chunk, W = (C . B^T) o L o dt with L = 2^(cum_i -
//     cum_j) masked to j <= i before the exponential (above the diagonal
//     the exponent is positive and would overflow), and y += W . x. C .
//     B^T never leaves the registers: its accumulator fragments are the A
//     fragments of W . x, as the attention kernels reuse P.
// At one 1024-token row that is 256 state blocks and 256 scan blocks of 8
// warps, against 128 serial blocks of the first version. The cumulative
// decay is kept in log2 units (A scaled by log2(e) before the sum, so the
// scaling's rounding moves cum_i - cum_j by a part of that difference, not
// of |cum|), so each exponential is one ex2.approx instruction.
//
// Precision: every product runs on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate). x, B and C in bf16 are exact. An fp32
// factor v (W, the scaled x of step 1, H_in) is split into hi = bf16(v)
// and lo = bf16(v - hi), and both halves are multiplied into one fp32
// accumulator, so each product keeps ~16 bits of v (~2^-17 relative),
// as the prefill kernel splits P. f32 inputs take the same path with x,
// B and C split as well (three products per pair: hi.hi, hi.lo, lo.hi),
// rather than a second body on the CUDA cores; f32 is the parity and
// test dtype, held to the same SSD_REL limit.
//
// Shared memory: tiles are bf16, rows padded by 16 bytes so that
// ldmatrix's eight row reads hit distinct banks; bf16 tiles arrive by
// 16-byte cp.async (step 1: a ring of four stages, a 256-token chunk's
// loads all in flight at once; step 3: two stages, the next column tile
// loading while this one is multiplied), f32 tiles through registers,
// where they are split.
//
// Determinism: the split into blocks, the cumulative decay's order and
// every accumulation order depend on (S, c, nh, hd, ds) alone, so a row
// served alone equals the same row in a batch bit for bit. Scratch comes
// from the wrapper; the kernels allocate nothing.
//
// Its gradient is csrc/ssd_scan_bwd.cu.
#include "ssd_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;     // chunk rows, head-dim and state columns per tile
constexpr int kPassThreads = 256;

// The chunk's cumulative decay in log2 units, cum_t = sum_{u <= t} dtv_u
// A_h log2(e), by one warp in a fixed order: lane l sums rows [l c/32,
// (l + 1) c/32) in turn, then an inclusive shuffle scan over the lanes
// adds the rows before. A_h is scaled before the sum, so the scaling's
// rounding moves cum_i - cum_j by a part of that difference, not of |cum|.
// c is a multiple of 32.
__device__ __forceinline__ void chunk_cumsum(const float* dtv, int chunk,
                                             float A_h, float* cum) {
  A_h *= kLog2e;
  const int lane = threadIdx.x & 31;
  const int per = chunk / 32, base = lane * per;
  float run = 0.f;
  for (int q = 0; q < per; ++q) {
    run += dtv[base + q] * A_h;
    cum[base + q] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int q = 0; q < per; ++q) cum[base + q] += excl;
}

// Step 1. grid (nc * n_dt * n_st, nh, Bt): block (k, h, b) takes head-dim
// rows [d0, d0 + 64) and state columns [s0, s0 + NS) of chunk k's state
// S_k = x^T (B o sc), sc_j = dt_j 2^(cum_last - cum_j). Warp w owns 16
// head-dim rows; the chunk's 64-row tiles of x and B stream through a ring
// of kStages1 stages, so a 256-token chunk's loads are all in flight at
// once. The A fragments of x^T come by ldmatrix.trans and are scaled by
// sc and split into hi + lo in registers.
constexpr int kStages1 = 4;
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const T* __restrict__ Bm,
                           float* __restrict__ states, float* __restrict__ decay,
                           int S, int nh, int hd, int chunk, long long x_bs,
                           long long x_ts, long long bc_bs, long long bc_ts) {
  constexpr int NS = DS < kTile ? DS : kTile;   // state columns per block
  constexpr int n_st = DS / NS;
  constexpr int H2 = kHalves<T>;
  constexpr int XLD = kTile + kPad, BLD = NS + kPad;
  constexpr int XT = kTile * XLD, BT = kTile * BLD;   // one half of a tile
  constexpr int STAGE = H2 * (XT + BT);
  const int nc = (S + chunk - 1) / chunk;
  const int k = blockIdx.x % nc;
  const int sub = blockIdx.x / nc;
  const int d0 = (sub / n_st) * kTile, s0 = (sub % n_st) * NS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = k * chunk;
  const int valid = min(chunk, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = lane & 3;
  const int dcols = min(kTile, hd - d0);
  const bool active = warp * 16 < dcols;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* dtv = reinterpret_cast<float*>(tiles + kStages1 * STAGE);
  float* cum = dtv + chunk;
  float* sc = cum + chunk;

  const T* xb = x + b * x_bs + (size_t)t0 * x_ts + (size_t)h * hd + d0;
  const T* Bb = Bm + b * bc_bs + (size_t)t0 * bc_ts + s0;
  const int n_jt = (valid + kTile - 1) / kTile;
  auto load = [&](int jt) {               // into stage jt % kStages1
    if (jt >= n_jt) return;
    __nv_bfloat16* xs = tiles + (jt % kStages1) * STAGE;
    __nv_bfloat16* bs = xs + H2 * XT;
    const int j0 = jt * kTile;
    load_tile<T>(xs, XLD, xb + (size_t)j0 * x_ts, x_ts, kTile, dcols,
                 valid - j0);
    load_tile<T>(bs, BLD, Bb + (size_t)j0 * bc_ts, bc_ts, kTile, NS,
                 valid - j0);
  };
  for (int jt = 0; jt < kStages1 - 1; ++jt) {
    load(jt);
    cp_async_commit();                    // one group a stage, maybe empty
  }
  load_dt(dt + ((size_t)b * S + t0) * nh + h, nh, valid, chunk, dtv);
  __syncthreads();
  if (warp == 0) chunk_cumsum(dtv, chunk, A[h], cum);
  __syncthreads();
  const float last = cum[chunk - 1];
  for (int t = tid; t < chunk; t += kThreads)
    sc[t] = dtv[t] * exp2_approx(last - cum[t]);
  if (sub == 0 && tid == 0)
    decay[((size_t)b * nc + k) * nh + h] = exp2_approx(last);

  float acc[NS / 8][4];
#pragma unroll
  for (int n = 0; n < NS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jt = 0; jt < n_jt; ++jt) {
    load(jt + kStages1 - 1);
    cp_async_commit();
    cp_async_wait<kStages1 - 1>();        // tile jt has landed
    __syncthreads();                      // for every thread, and sc too
    const __nv_bfloat16* xs = tiles + (jt % kStages1) * STAGE;
    const __nv_bfloat16* bs = xs + H2 * XT;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const int jl = kk * 16;           // the k-step's first row in the tile
        // A = x^T: stored [j][d], so ldmatrix.trans; matrix q = lane / 8
        // holds j rows 8 (q / 2) .., d columns 8 (q % 2) ..
        const uint32_t aoff =
            (uint32_t)((jl + (lane & 7) + (lane >> 4) * 8) * XLD + warp * 16 +
                       ((lane >> 3) & 1) * 8) * 2;
        uint32_t raw[H2][4];
#pragma unroll
        for (int hf = 0; hf < H2; ++hf)
          ldmatrix_x4_trans(smem_u32(xs + hf * XT) + aoff, raw[hf]);
        const int j = jt * kTile + jl + 2 * tg;
        const float s0v = sc[j], s1v = sc[j + 1], s8v = sc[j + 8],
                    s9v = sc[j + 9];
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 v = unpack_bf16(raw[0][e]);
          if constexpr (H2 == 2) {
            const float2 l = unpack_bf16(raw[1][e]);
            v.x += l.x;
            v.y += l.y;
          }
          const bool hi_k = e >= 2;       // registers 2, 3: k + 8
          split_bf16(v.x * (hi_k ? s8v : s0v), v.y * (hi_k ? s9v : s1v),
                     ah[e], al[e]);
        }
        // B: stored [j][s], k = j, so ldmatrix.trans as for V in attention
        const int brow = jl + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int n = 0; n < NS / 8; n += 2) {
          const uint32_t boff =
              (uint32_t)(brow * BLD + n * 8 + (lane >> 4) * 8) * 2;
          uint32_t bf[4];
          ldmatrix_x4_trans(smem_u32(bs) + boff, bf);
          mma_bf16(acc[n], ah, bf[0], bf[1]);
          mma_bf16(acc[n], al, bf[0], bf[1]);
          mma_bf16(acc[n + 1], ah, bf[2], bf[3]);
          mma_bf16(acc[n + 1], al, bf[2], bf[3]);
          if constexpr (H2 == 2) {
            ldmatrix_x4_trans(smem_u32(bs + BT) + boff, bf);
            mma_bf16(acc[n], ah, bf[0], bf[1]);
            mma_bf16(acc[n + 1], ah, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();                      // the stage is read before reload
  }

  if (!active) return;
  const int gr = lane >> 2;
  const size_t ds = (size_t)DS;
  float* out = states + ((((size_t)b * nc + k) * nh + h) * hd + d0 +
                         warp * 16 + gr) * ds + s0;
#pragma unroll
  for (int n = 0; n < NS / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + r * 8 * ds + n * 8 + 2 * tg) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

// Step 2. grid (ceil(hd ds / 4 / 256), nh, Bt): each thread carries four
// entries of the (b, h) state through the chunks in order. The state
// entering chunk k goes to hin[b, k, h] split into bf16 hi [hd, ds] and lo
// [hd, ds], ready for step 3's tensor cores; the final state to hout.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(const float* __restrict__ h0,
                          const float* __restrict__ states,
                          const float* __restrict__ decay,
                          __nv_bfloat16* __restrict__ hin,
                          float* __restrict__ hout, int nc, int nh,
                          int n_state) {
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= n_state) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * nh + h;
  float4 H = *reinterpret_cast<const float4*>(h0 + head * n_state + e);
  for (int k = 0; k < nc; ++k) {
    const size_t bk = ((size_t)b * nc + k) * nh + h;
    const float4 Sk =
        *reinterpret_cast<const float4*>(states + bk * n_state + e);
    uint2 hi, lo;
    split_bf16(H.x, H.y, hi.x, lo.x);
    split_bf16(H.z, H.w, hi.y, lo.y);
    __nv_bfloat16* p = hin + bk * 2 * n_state + e;
    *reinterpret_cast<uint2*>(p) = hi;
    *reinterpret_cast<uint2*>(p + n_state) = lo;
    const float d = decay[bk];
    H = make_float4(d * H.x + Sk.x, d * H.y + Sk.y, d * H.z + Sk.z,
                    d * H.w + Sk.w);
  }
  *reinterpret_cast<float4*>(hout + head * n_state + e) = H;
}

// Step 3. grid (nh nc, Bt n_dt, n_it): block (tile i of kRows3 rows of
// chunk k, head h, row b, head-dim columns [d0, d0 + 64)); warp w owns the
// tile's rows 16 w .. 16 w + 15. The tile index is the slowest grid axis,
// the last tiles of every chunk (those that see the most column tiles)
// first. Column tiles are 64 rows; a warp skips those wholly above its
// rows and masks only those that cross its diagonal.
constexpr int kRows3 = 128;
constexpr int kWarps3 = kRows3 / 16;
template <typename T, int DS>
__global__ void __launch_bounds__(kWarps3 * 32, 2)
    ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm,
                          const __nv_bfloat16* __restrict__ hin,
                          float* __restrict__ y, int S, int nh, int hd,
                          int chunk, long long x_bs, long long x_ts,
                          long long bc_bs, long long bc_ts) {
  constexpr int H2 = kHalves<T>;
  constexpr int CLD = DS + kPad, XLD = kTile + kPad;
  constexpr int BT = kTile * CLD, XT = kTile * XLD;   // one half of a tile
  constexpr int CT = kRows3 * CLD;                     // one half of C
  constexpr int STAGE = H2 * (BT + XT);                // B tile, x tile
  constexpr int KS = DS / 16;                          // k-steps over ds
  constexpr int HREG = 2 * BT;                         // H_in hi + lo
  constexpr int UNION = HREG > 2 * STAGE ? HREG : 2 * STAGE;
  const int nc = (S + chunk - 1) / chunk;
  const int n_it = (chunk + kRows3 - 1) / kRows3;
  const int n_dt = (hd + kTile - 1) / kTile;
  const int h = blockIdx.x % nh, k = blockIdx.x / nh;
  const int b = blockIdx.y / n_dt, d0 = (blockIdx.y % n_dt) * kTile;
  const int it = n_it - 1 - (int)blockIdx.z;
  const int t0 = k * chunk, i0 = it * kRows3;
  const int valid = min(chunk, S - t0);
  if (i0 >= valid) return;                // the tile lies wholly past S
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int dcols = min(kTile, hd - d0);
  const int n_db = dcols / 8;             // head-dim column blocks of 8
  const int r_first = i0 + warp * 16;     // this warp's rows in the chunk
  const int r_last = r_first + 15;
  const bool live = r_first < valid;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [H2]
  __nv_bfloat16* un = Cs + H2 * CT;       // H_in, then the stages
  float* dtv = reinterpret_cast<float*>(un + UNION);
  float* cum = dtv + chunk;

  const size_t row0 = (size_t)t0;
  const T* xb = x + b * x_bs + row0 * x_ts + (size_t)h * hd + d0;
  const T* Bb = Bm + b * bc_bs + row0 * bc_ts;
  const T* Cb = Cm + b * bc_bs + row0 * bc_ts;
  // the state entering chunk k, rows d0 .., as bf16 hi and lo; the C tile
  const __nv_bfloat16* hb =
      hin + (((size_t)b * nc + k) * nh + h) * 2 * hd * DS + (size_t)d0 * DS;
  load_tile<__nv_bfloat16>(un, CLD, hb, DS, kTile, DS, dcols);
  load_tile<__nv_bfloat16>(un + BT, CLD, hb + (size_t)hd * DS, DS, kTile, DS,
                           dcols);
  load_tile<T>(Cs, CLD, Cb + (size_t)i0 * bc_ts, bc_ts, kRows3, DS,
               valid - i0);
  cp_async_commit();
  load_dt(dt + ((size_t)b * S + t0) * nh + h, nh, valid, chunk, dtv);
  __syncthreads();
  if (warp == 0) chunk_cumsum(dtv, chunk, A[h], cum);
  cp_async_wait<0>();
  __syncthreads();

  // A fragments of this warp's 16 C rows at k-step ks (ldmatrix, no trans)
  const uint32_t c_off =
      (uint32_t)((warp * 16 + (lane & 15)) * CLD + (lane >> 4) * 8) * 2;
  // B fragments of rows n .. n + 15 of a [n][k] tile at k-step ks
  const int nrow = (lane & 7) + ((lane >> 4) << 3);
  const int ncol = ((lane >> 3) & 1) * 8;

  // y = 2^cum_i (C_i . H_in^T), H_in as hi + lo
  float acc[kTile / 8][4];
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (live) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ch[H2][4];
#pragma unroll
      for (int hf = 0; hf < H2; ++hf)
        ldmatrix_x4(smem_u32(Cs + hf * CT) + c_off + ks * 32, ch[hf]);
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        if (n >= n_db) break;
        const uint32_t off =
            (uint32_t)((n * 8 + nrow) * CLD + ks * 16 + ncol) * 2;
        uint32_t hh[4], hl[4];
        ldmatrix_x4(smem_u32(un) + off, hh);
        ldmatrix_x4(smem_u32(un + BT) + off, hl);
        mma_bf16(acc[n], ch[0], hh[0], hh[1]);
        mma_bf16(acc[n], ch[0], hl[0], hl[1]);
        mma_bf16(acc[n + 1], ch[0], hh[2], hh[3]);
        mma_bf16(acc[n + 1], ch[0], hl[2], hl[3]);
        if constexpr (H2 == 2) {
          mma_bf16(acc[n], ch[1], hh[0], hh[1]);
          mma_bf16(acc[n + 1], ch[1], hh[2], hh[3]);
        }
      }
    }
  }
  const int i_lo = r_first + gr;          // this thread's rows i_lo, + 8
  const float cum_i[2] = {cum[min(i_lo, chunk - 1)],
                          cum[min(i_lo + 8, chunk - 1)]};
  {
    const float e0 = exp2_approx(cum_i[0]), e1 = exp2_approx(cum_i[1]);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
  }
  __syncthreads();                        // H_in read: its space is reused

  auto load = [&](int jt, int st) {
    __nv_bfloat16* bs = un + st * STAGE;
    __nv_bfloat16* xs = bs + H2 * BT;
    const int j0 = jt * kTile;
    load_tile<T>(bs, CLD, Bb + (size_t)j0 * bc_ts, bc_ts, kTile, DS,
                 valid - j0);
    load_tile<T>(xs, XLD, xb + (size_t)j0 * x_ts, x_ts, kTile, dcols,
                 valid - j0);
  };
  // the column tiles up to the tile's last valid row
  const int n_jt = (min(i0 + kRows3, valid) + kTile - 1) / kTile;
  load(0, 0);
  cp_async_commit();
  for (int jt = 0, st = 0; jt < n_jt; ++jt, st ^= 1) {
    if (jt + 1 < n_jt) load(jt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* bs = un + st * STAGE;
    const __nv_bfloat16* xs = bs + H2 * BT;
    const int j0 = jt * kTile;
    if (live && j0 <= r_last) {           // else wholly above the diagonal
      const bool cross = j0 + kTile - 1 > r_first;   // crosses it: mask
      // C_i . B_j^T for the warp's 16 rows and the tile's 64 columns
      float w[kTile / 8][4];
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ch[H2][4];
#pragma unroll
        for (int hf = 0; hf < H2; ++hf)
          ldmatrix_x4(smem_u32(Cs + hf * CT) + c_off + ks * 32, ch[hf]);
#pragma unroll
        for (int n = 0; n < kTile / 8; n += 2) {
          if (j0 + n * 8 > r_last) break;       // wholly above the diagonal
          const uint32_t off =
              (uint32_t)((n * 8 + nrow) * CLD + ks * 16 + ncol) * 2;
          uint32_t bh[4];
          ldmatrix_x4(smem_u32(bs) + off, bh);
          mma_bf16(w[n], ch[0], bh[0], bh[1]);
          mma_bf16(w[n + 1], ch[0], bh[2], bh[3]);
          if constexpr (H2 == 2) {
            uint32_t bl[4];
            ldmatrix_x4(smem_u32(bs + BT) + off, bl);
            mma_bf16(w[n], ch[0], bl[0], bl[1]);
            mma_bf16(w[n + 1], ch[0], bl[2], bl[3]);
            mma_bf16(w[n], ch[1], bh[0], bh[1]);
            mma_bf16(w[n + 1], ch[1], bh[2], bh[3]);
          }
        }
      }
      // W = (C . B^T) o 2^(cum_i - cum_j) o dt_j, masked to j <= i before
      // the exp where the tile crosses the warp's diagonal
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int j = j0 + n * 8 + 2 * tg + (e & 1);
          const bool vis = !cross || j <= i_lo + 8 * r;
          w[n][e] = vis ? w[n][e] * exp2_approx(cum_i[r] - cum[j]) * dtv[j]
                        : 0.f;
        }
      }
      // y += W . x, W split into hi + lo; x stored [j][d]: ldmatrix.trans
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        if (j0 + ks * 16 > r_last) break;     // W is 0 past the diagonal
        uint32_t wh[4], wl[4];
        split_bf16(w[2 * ks][0], w[2 * ks][1], wh[0], wl[0]);
        split_bf16(w[2 * ks][2], w[2 * ks][3], wh[1], wl[1]);
        split_bf16(w[2 * ks + 1][0], w[2 * ks + 1][1], wh[2], wl[2]);
        split_bf16(w[2 * ks + 1][2], w[2 * ks + 1][3], wh[3], wl[3]);
        const int key = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int n = 0; n < kTile / 8; n += 2) {
          if (n >= n_db) break;
          const uint32_t off =
              (uint32_t)(key * XLD + n * 8 + (lane >> 4) * 8) * 2;
          uint32_t xf[4];
          ldmatrix_x4_trans(smem_u32(xs) + off, xf);
          mma_bf16(acc[n], wh, xf[0], xf[1]);
          mma_bf16(acc[n], wl, xf[0], xf[1]);
          mma_bf16(acc[n + 1], wh, xf[2], xf[3]);
          mma_bf16(acc[n + 1], wl, xf[2], xf[3]);
          if constexpr (H2 == 2) {
            ldmatrix_x4_trans(smem_u32(xs + XT) + off, xf);
            mma_bf16(acc[n], wh, xf[0], xf[1]);
            mma_bf16(acc[n + 1], wh, xf[2], xf[3]);
          }
        }
      }
    }
    __syncthreads();                      // stage st read before reload
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_lo + 8 * r;
    if (i >= valid) continue;
    float* yr = y + (((size_t)b * S + t0 + i) * nh + h) * hd + d0;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      if (n >= n_db) break;
      *reinterpret_cast<float2*>(yr + n * 8 + 2 * tg) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <typename T, int DS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* hout, void* states, void* decay, void* hin, int Bt,
                   int S, int nh, int hd, int chunk, long long x_bs,
                   long long x_ts,
                   long long bc_bs, long long bc_ts, cudaStream_t stream) {
  if (chunk % kTile || chunk > 1024 || hd % 16 || S < 1)
    return cudaErrorInvalidValue;
  constexpr int H2 = kHalves<T>;
  constexpr int NS = DS < kTile ? DS : kTile;
  const int nc = (S + chunk - 1) / chunk;
  const int n_dt = (hd + kTile - 1) / kTile;
  const int n_st = DS / NS;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* dc = static_cast<float*>(decay);
  const size_t bf = sizeof(__nv_bfloat16);

  const size_t smem1 =
      kStages1 * H2 * (kTile * (kTile + kPad) + kTile * (NS + kPad)) * bf +
      3 * chunk * sizeof(float);
  auto k1 = ssd_chunk_state_kernel<T, DS>;
  cudaError_t err = allow_smem(k1, smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc * n_dt * n_st, nh, Bt), kThreads, smem1, stream>>>(
      xt, dtf, Af, bt, st, dc, S, nh, hd, chunk, x_bs, x_ts, bc_bs, bc_ts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_state = hd * DS;
  const int per_block = 4 * kPassThreads;
  ssd_state_pass_kernel<<<dim3((n_state + per_block - 1) / per_block, nh,
                               Bt), kPassThreads, 0, stream>>>(
      static_cast<const float*>(h0), st, dc,
      static_cast<__nv_bfloat16*>(hin), static_cast<float*>(hout), nc, nh,
      n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t bt3 = (size_t)kTile * (DS + kPad);
  const size_t stage = H2 * (bt3 + kTile * (kTile + kPad));
  const size_t un = 2 * bt3 > 2 * stage ? 2 * bt3 : 2 * stage;
  const size_t smem3 = (H2 * (size_t)kRows3 * (DS + kPad) + un) * bf +
                       2 * chunk * sizeof(float);
  auto k3 = ssd_chunk_scan_kernel<T, DS>;
  err = allow_smem(k3, smem3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(nh * nc, Bt * n_dt, (chunk + kRows3 - 1) / kRows3),
       kWarps3 * 32, smem3, stream>>>(
      xt, dtf, Af, bt, static_cast<const T*>(Cm),
      static_cast<const __nv_bfloat16*>(hin), static_cast<float*>(y), S, nh,
      hd, chunk, x_bs, x_ts, bc_bs, bc_ts);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C share it). ds: 16, 64 or
// 128; chunk a multiple of 64 up to 1024; hd a multiple of 16; any S >= 1
// (the wrapper checks all of them). x_bs / x_ts and bc_bs / bc_ts: the
// batch and token strides, in elements, of x and of B and C (each token's
// x is [nh, hd] and its B and C rows [ds], contiguous; every stride a
// multiple of 16 bytes). Scratch, nc = ceil(S / chunk): states, fp32 of
// Bt * nc * nh * hd * ds floats; decay, fp32 of Bt * nc * nh; hin, bf16 of
// Bt * nc * nh * 2 * hd * ds.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* h0, void* y, void* hout,
                               void* states, void* decay, void* hin,
                               int Bt, int S, int nh, int hd, int ds,
                               int chunk,
                               long long x_bs, long long x_ts,
                               long long bc_bs, long long bc_ts, int dtype,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define SSD_LAUNCH(T, DS)                                                     \
  return launch<T, DS>(x, dt, A, Bm, Cm, h0, y, hout, states, decay, hin,   \
                       Bt, S, nh, hd, chunk, x_bs, x_ts, bc_bs, bc_ts, s)
  if (dtype == 0 && ds == 16) SSD_LAUNCH(float, 16);
  if (dtype == 0 && ds == 64) SSD_LAUNCH(float, 64);
  if (dtype == 0 && ds == 128) SSD_LAUNCH(float, 128);
  if (dtype == 1 && ds == 16) SSD_LAUNCH(__nv_bfloat16, 16);
  if (dtype == 1 && ds == 64) SSD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && ds == 128) SSD_LAUNCH(__nv_bfloat16, 128);
#undef SSD_LAUNCH
  return cudaErrorInvalidValue;
}
