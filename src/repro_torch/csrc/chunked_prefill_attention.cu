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
// Bound: operations for long chunks (4 flops per query-key pair and head
// dimension against the q, k, v and output bytes), bytes for short ones.
// This first version does its products on the CUDA cores in fp32, not on
// the tensor cores, so it runs far from the bf16 tensor-core bound; wgmma,
// TMA and split-K are for later changes.
//
// Design: one block per (tile of 32 query rows, head, row b). The Pallas
// grid's sequential k-block axis becomes a loop inside the block over
// 32-key tiles, from the window's first visible key to the tile's own
// causal frontier min(kv_lens[b], q_offsets[b] + last row + 1): nothing
// past it is read. Ragged edges of C and S are masked in the kernel (the
// Pallas `C % bq == 0` assertion does not carry over). The Q tile and each
// K/V tile sit in shared memory as fp32 (K rows padded by one float so
// that 32 lanes reading 32 keys hit distinct banks). Warp w owns query rows
// 8w .. 8w+7: lane j scores key j against all 8 rows, the softmax max and
// sum are warp shuffles, and lane d' keeps the output columns d' + 32c of
// its 8 rows in registers.
#include "common.cuh"

namespace {

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_offsets, const void* kv_lens, void* out,
                   int B, int C, int H, int S, int KV, int window,
                   float scale, cudaStream_t stream) {
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
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: 64 or 128 (the wrapper checks).
// window <= 0 means no window.
extern "C" int chunked_prefill_attention_launch(
    const void* q, const void* k, const void* v, const void* q_offsets,
    const void* kv_lens, void* out, int B, int C, int H, int S, int KV,
    int D, int window, int dtype, float scale, void* stream) {
  DISPATCH_DTYPE_HEAD_DIM(dtype, D, q, k, v, q_offsets, kv_lens, out, B, C,
                          H, S, KV, window, scale,
                          static_cast<cudaStream_t>(stream));
}
