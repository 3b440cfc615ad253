// Chunked-prefill attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/chunked_prefill_attention.py::
// chunked_prefill_attention, the Pallas kernel of the prefill rows (its
// dynamic mode `_kernel_dyn`; the static mode passes broadcast offsets).
//
// Computes, for each row b: C chunk queries at positions q_offsets[b] + i
// attend causally over a contiguous cache [S, KV, D] that already holds the
// prefix and the chunk. Head h reads kv-head h / G. Scores are scaled by
// D^-1/2 and masked by kpos <= qpos, kpos < kv_lens[b] and, when window > 0,
// qpos - kpos < window. Online softmax in fp32; the output is
// acc / max(l, 1e-30), so a pad row (kv_lens = 0) gives zeros.
//
// Bound: operations for long chunks (4 flops per visible query-key pair
// and head dimension against the q, k, v and output bytes), bytes for
// short ones. At the timed bf16 shape (4 rows of 512-token chunks, 24
// heads, D 128, S 1024) the bound is 0.0094 ms of bytes; the ~4.4 GFLOP
// of visible pairs take 0.0044 ms at the 989 TFLOP/s bf16 tensor-core
// rate and 0.065 ms at the 67 TFLOP/s fp32 rate of the CUDA cores.
//
// bf16 design (chunked_prefill_mma_kernel), which the serve paths run: one
// block per (tile of 64 query rows, head, row b), four warps of 16 query
// rows each; the grid issues the last query tile of a chunk first, since
// under the causal mask it has the most keys. The Pallas grid's sequential
// k-block axis becomes a loop inside the block over 64-key tiles that start
// at multiples of 64 in absolute key position, from the window's first
// visible key to the tile's causal frontier min(kv_lens[b], q_offsets[b] +
// last row + 1). K and V tiles stay bf16 in shared memory (rows padded by 16
// bytes, so ldmatrix's eight row reads hit distinct banks) and arrive by
// 16-byte cp.async into a two-stage ring: the next tile loads while this one
// is computed. The Q fragments are read once with ldmatrix and stay in
// registers. S = Q.K^T runs on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate: bf16 products are exact in fp32). The online softmax runs
// in fp32 registers, in log2 units (exp2 of scores scaled by D^-1/2 log2 e);
// a tile that all 16 rows of a warp see whole skips the mask arithmetic. A
// masked score enters the max as -inf, so a fully masked tile leaves m, l
// and acc bit-unchanged and a query's result does not depend on the tile,
// chunk or batch it lands in. P.V keeps P's precision: P is split into hi =
// bf16(P) and lo = bf16(P - hi) and both products accumulate in fp32 on the
// tensor cores (twice the P.V MMAs; the error is ~2^-17 of the output, where
// rounding P to bf16 would miss the one-bf16-ulp limit on small outputs).
// Ragged C and the key tail past the frontier are zero-filled by cp.async
// and masked. Three blocks fit an SM (167 registers a thread at D = 128,
// 68 KB of shared memory). D = 256 (gemma3-4b) has a tile plan of its own
// (MmaPlan<256>): the fp32 accumulator of 16 rows x 256 columns is 128
// registers a lane, so the Q tile stays in shared memory and is read at
// each k-step, key tiles are 32 keys, and two blocks fit an SM (99 KB of
// shared memory each). The same body serves the decode rows of the
// sliding-window layers (C = 1 over the gathered view, as the JAX kernel
// branch routes them): a block then holds one live query row of 64, which
// is correct and wasteful. Left for later: wgmma with TMA-fed tiles and
// warp specialisation, skipping the P.V products of key steps that a
// warp's rows cannot see, and a decode body for windowed C = 1 rows.
//
// f32 design (chunked_prefill_kernel): the tensor cores have no fp32
// path that holds the f32 limit (1e-4) with TF32 off, and f32 is the
// parity and test dtype, not the serve dtype, so f32 keeps the first
// version's body: one block per (32 query rows, head, row b), fp32 tiles
// in shared memory, 32-key tiles (also aligned to absolute key
// positions), products on the CUDA cores, warp w owning rows 8w .. 8w+7.
// Its shared memory is (3 x 32 x D + 32 + 32 x 32) x 4 bytes, 100 KB at
// D = 256, above the default 48 KB: allow_smem opts in.
#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- f32

constexpr int kRows = 32;                 // query rows per block
constexpr int kKeys = 32;                 // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    chunked_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ q_offsets,
                           const int* __restrict__ kv_lens,
                           T* __restrict__ out, int C, int H, int S, int KV,
                           int window, float scale) {
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int VEC = Vec16<T>::N;
  constexpr int CHUNKS = D / VEC;
  constexpr int COLS = D / 32;

  extern __shared__ float smem[];
  float* Qs = smem;                       // [kRows][D]
  float* Ks = Qs + kRows * D;             // [kKeys][D + 1]
  float* Vs = Ks + kKeys * (D + 1);       // [kKeys][D]
  float* Ps = Vs + kKeys * D;             // [kRows][kKeys]

  const int nq = min(kRows, C - q0);
  const int qoff = q_offsets[b];
  const int kv_len = min(kv_lens[b], S);
  // the tile's causal frontier: its last query sits at qoff + q0 + nq - 1
  const int kv_end = min(kv_len, qoff + q0 + nq);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, qoff + q0 - window + 1);
  kv_begin = kv_begin / kKeys * kKeys;

  for (int i = tid; i < kRows * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    float x[VEC];
    if (r < nq) {
      load16(q + (((size_t)b * C + q0 + r) * H + h) * D + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) Qs[r * D + c + j] = x[j];
  }

  float acc[kRowsPerWarp][COLS];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = ATTN_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;   // this warp's first tile row

  for (int k0 = kv_begin; k0 < kv_end; k0 += kKeys) {
    __syncthreads();                      // previous tile consumed
    for (int i = tid; i < kKeys * CHUNKS; i += blockDim.x) {
      const int t = i / CHUNKS;
      const int c = (i % CHUNKS) * VEC;
      float kx[VEC], vx[VEC];
      if (k0 + t < kv_end) {
        const size_t off = (((size_t)b * S + k0 + t) * KV + kvh) * D + c;
        load16(k + off, kx);
        load16(v + off, vx);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kx[j] = vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        Ks[t * (D + 1) + c + j] = kx[j];
        Vs[t * D + c + j] = vx[j];
      }
    }
    __syncthreads();

    float dots[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) dots[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        dots[r] = fmaf(Qs[(row0 + r) * D + d], kd, dots[r]);
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + r;
      const int qpos = qoff + q0 + i;
      const bool valid = i < nq && kpos <= qpos && kpos < kv_len &&
                         (window <= 0 || qpos - kpos < window);
      const float s = valid ? dots[r] * scale : ATTN_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      const bool alive = m_new > ATTN_NEG_INF / 2;
      const float alpha = alive ? expf(m[r] - m_new) : 0.f;
      const float p = valid ? expf(s - (alive ? m_new : 0.f)) : 0.f;
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      Ps[i * kKeys + lane] = p;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();                         // the warp's Ps rows are written
    const int nk = min(kKeys, kv_end - k0);
    for (int j = 0; j < nk; ++j) {
      float vj[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) vj[c] = Vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = Ps[(row0 + r) * kKeys + j];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = fmaf(p, vj[c], acc[r][c]);
      }
    }
    __syncwarp();                         // Ps read before the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    if (i >= nq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o = out + (((size_t)b * C + q0 + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      store_float(acc[r][c] * inv, o + lane + 32 * c);
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kMmaRows = 64;              // query rows per block
constexpr int kMmaWarps = 4;              // 16 query rows each

// The tile plan of a head dim. D 64 and 128: 64-key tiles, the warp's Q
// fragments held in registers (KSTEPS x 4) for the whole key loop, three
// blocks an SM. D 256: a warp's fp32 accumulator alone is 16 x 256 / 32 =
// 128 registers a lane and its Q fragments would be 64 more, so the Q
// tile stays in shared memory (its fragments are read with ldmatrix at
// each k-step of Q.K^T), the key tiles are 32 keys (the scores take 16
// registers, not 32), and two blocks fit an SM (2 x 99 KB of shared
// memory, up to 255 registers a thread).
template <int D>
struct MmaPlan {
  static constexpr int kKeys = 64;        // keys per tile
  static constexpr bool kQInRegs = true;  // Q fragments in registers
  static constexpr int kMinBlocks = 3;    // blocks an SM (launch bound)
};
template <>
struct MmaPlan<256> {
  static constexpr int kKeys = 32;
  static constexpr bool kQInRegs = false;
  static constexpr int kMinBlocks = 2;
};

// Bytes of shared memory a block of the tensor-core body takes: two
// stages of K and V tiles, and the Q tile, which shares K's stage 1 when
// its fragments move to registers before the loop.
template <int D>
constexpr size_t mma_smem_bytes() {
  constexpr size_t row = (size_t)(D + 8) * sizeof(__nv_bfloat16);
  return 4 * MmaPlan<D>::kKeys * row +
         (MmaPlan<D>::kQInRegs ? 0 : (size_t)kMmaRows * row);
}

// Thread layout of the m16n8k16 fragments (PTX ISA): lane = 4 * gr + tg;
// an accumulator holds rows gr and gr + 8, columns 2 tg and 2 tg + 1.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32, MmaPlan<D>::kMinBlocks)
    chunked_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const int* __restrict__ q_offsets,
                               const int* __restrict__ kv_lens,
                               __nv_bfloat16* __restrict__ out, int C, int H,
                               int S, int KV, int window, float scale) {
  constexpr int kMmaKeys = MmaPlan<D>::kKeys;
  constexpr bool kQInRegs = MmaPlan<D>::kQInRegs;
  constexpr int ROW = D + 8;              // padded smem row, bf16 elements
  constexpr int TILE = kMmaKeys * ROW;    // one K or V tile
  constexpr int CH = D / 8;               // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;          // k-steps of Q.K^T
  constexpr int NB = kMmaKeys / 8;        // key blocks of 8 in S
  constexpr int DB = D / 8;               // column blocks of 8 in acc
  // grid (H, B, query tiles), the last query tile first: under the causal
  // mask it has the most keys, so the longest blocks start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaRows;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  // scores in log2 units: exp(x) = exp2(x * log2(e))
  const float scale2 = scale * 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                               // [2]
  // the Q tile: in K's stage 1 when its fragments move to registers
  // before the loop, else after the V stages for the whole loop
  __nv_bfloat16* Qs = kQInRegs ? Ks + TILE : Vs + 2 * TILE;

  const int nq = min(kMmaRows, C - q0);
  const int qoff = q_offsets[b];
  const int kv_len = min(kv_lens[b], S);
  const int kv_end = min(kv_len, qoff + q0 + nq);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, qoff + q0 - window + 1);
  kv_begin = kv_begin / kMmaKeys * kMmaKeys;

  const int r_lo = warp * 16 + gr;        // this thread's rows r_lo, +8
  __nv_bfloat16* o_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    o_row[r] = out + (((size_t)b * C + q0 + r_lo + 8 * r) * H + h) * D;

  if (kv_begin >= kv_end) {               // nothing visible: zeros
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r_lo + 8 * r >= nq) continue;
#pragma unroll
      for (int nd = 0; nd < DB; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(o_row[r] + nd * 8 + 2 * tg) =
            zero;
    }
    return;
  }

  // K and V rows k0 .. k0 + 63 into stage st; rows at or past kv_end are
  // zero-filled (they are masked, and never read from global memory).
  auto load_kv = [&](int k0, int st) {
    const uint32_t kd = smem_u32(Ks + st * TILE);
    const uint32_t vd = smem_u32(Vs + st * TILE);
    for (int i = tid; i < kMmaKeys * CH; i += kMmaWarps * 32) {
      const int t = i / CH, c = (i % CH) * 8;
      const bool in = k0 + t < kv_end;
      const size_t off =
          (((size_t)b * S + (in ? k0 + t : 0)) * KV + kvh) * D + c;
      const uint32_t so = (uint32_t)(t * ROW + c) * 2;
      cp_async16(kd + so, k + off, in ? 16 : 0);
      cp_async16(vd + so, v + off, in ? 16 : 0);
    }
  };

  // the Q tile (rows past nq zero-filled) and the first K/V tile
  {
    const uint32_t qd = smem_u32(Qs);
    for (int i = tid; i < kMmaRows * CH; i += kMmaWarps * 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r < nq;
      const size_t off =
          (((size_t)b * C + q0 + (in ? r : 0)) * H + h) * D + c;
      cp_async16(qd + (uint32_t)(r * ROW + c) * 2, q + off, in ? 16 : 0);
    }
  }
  load_kv(kv_begin, 0);
  cp_async_commit();
  // this lane's ldmatrix address of the warp's Q fragment at k-step 0
  const uint32_t q_addr =
      smem_u32(Qs) +
      (uint32_t)((warp * 16 + (lane & 15)) * ROW + (lane >> 4) * 8) * 2;
  uint32_t qf[kQInRegs ? KSTEPS : 1][4];
  if constexpr (kQInRegs) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldmatrix_x4(q_addr + kk * 16 * 2, qf[kk]);
    __syncthreads();                      // Q read before stage 1 reloads
  }

  float acc[DB][4];
#pragma unroll
  for (int nd = 0; nd < DB; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                // this thread's share of the sum
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = qoff + q0 + r_lo + 8 * r;
  const bool row_in[2] = {r_lo < nq, r_lo + 8 < nq};

  int st = 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kMmaKeys, st ^= 1) {
    if (k0 + kMmaKeys < kv_end) load_kv(k0 + kMmaKeys, st ^ 1);
    cp_async_commit();                    // (an empty group at the end)
    cp_async_wait<1>();                   // this tile has landed
    __syncthreads();

    // S = Q . K^T for this warp's 16 rows and the tile's 64 keys
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
    const uint32_t kb = smem_u32(Ks + st * TILE);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t* qa = qf[kQInRegs ? kk : 0];
      if constexpr (!kQInRegs) ldmatrix_x4(q_addr + kk * 16 * 2, qf[0]);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        const int key = nb * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kf[4];
        ldmatrix_x4(kb + (uint32_t)(key * ROW + col) * 2, kf);
        mma_bf16(s[nb], qa, kf[0], kf[1]);
        mma_bf16(s[nb + 1], qa, kf[2], kf[3]);
      }
    }

    // scale (log2 units) and mask; the row max over the quad sharing a
    // row. A tile that every row of the warp sees whole skips the mask.
    float mx[2] = {m[0], m[1]};
    const int qlo = qoff + q0 + warp * 16;  // the warp's first row
    const bool whole = warp * 16 + 16 <= nq && k0 + kMmaKeys - 1 <= qlo &&
                       k0 + kMmaKeys <= kv_len &&
                       (window <= 0 || qlo + 15 - k0 < window);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int kpos = k0 + nb * 8 + 2 * tg + (i & 1);
        const bool valid =
            whole || (row_in[r] && kpos <= qpos[r] && kpos < kv_len &&
                      (window <= 0 || qpos[r] - kpos < window));
        s[nb][i] = valid ? s[nb][i] * scale2 : -INFINITY;
        mx[r] = fmaxf(mx[r], s[nb][i]);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with nothing visible yet keeps m = -inf, l = 0, acc = 0; a
      // tile that raises no row max leaves m, l and acc bit-unchanged
      m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = m[r] == m_use[r] ? 1.f : exp2f(m[r] - m_use[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[nb][i] - m_use[i >> 1]);  // exp2(-inf) = 0
        s[nb][i] = p;
        l[i >> 1] += p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < DB; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] *= alpha[i >> 1];

    // acc += P . V, P as hi + lo in bf16
    const uint32_t vb = smem_u32(Vs + st * TILE);
#pragma unroll
    for (int ks = 0; ks < kMmaKeys / 16; ++ks) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
      const int key = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nd = 0; nd < DB; nd += 2) {
        const int col = nd * 8 + (lane >> 4) * 8;
        uint32_t vf[4];
        ldmatrix_x4_trans(vb + (uint32_t)(key * ROW + col) * 2, vf);
        mma_bf16(acc[nd], ph, vf[0], vf[1]);
        mma_bf16(acc[nd], pl, vf[0], vf[1]);
        mma_bf16(acc[nd + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[nd + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                      // stage st read before reload
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_in[r]) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < DB; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(o_row[r] + nd * 8 + 2 * tg) =
          __floats2bfloat162_rn(acc[nd][2 * r] * inv,
                                acc[nd][2 * r + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_offsets, const void* kv_lens, void* out,
                   int B, int C, int H, int S, int KV, int window,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem =
        (size_t)(kRows * D + kKeys * (D + 1) + kKeys * D + kRows * kKeys) *
        sizeof(float);
    auto kernel = chunked_prefill_kernel<T, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((C + kRows - 1) / kRows, H, B);
    kernel<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(q_offsets),
        static_cast<const int*>(kv_lens), static_cast<T*>(out), C, H, S, KV,
        window, scale);
  } else {
    const size_t smem = mma_smem_bytes<D>();
    auto kernel = chunked_prefill_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(H, B, (C + kMmaRows - 1) / kMmaRows);
    kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(q_offsets),
        static_cast<const int*>(kv_lens), static_cast<T*>(out), C, H, S, KV,
        window, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: 64, 128 or 256 (the wrapper
// checks). window <= 0 means no window.
extern "C" int chunked_prefill_attention_launch(
    const void* q, const void* k, const void* v, const void* q_offsets,
    const void* kv_lens, void* out, int B, int C, int H, int S, int KV,
    int D, int window, int dtype, float scale, void* stream) {
  DISPATCH_DTYPE_HEAD_DIM(dtype, D, q, k, v, q_offsets, kv_lens, out, B, C,
                          H, S, KV, window, scale,
                          static_cast<cudaStream_t>(stream));
}
