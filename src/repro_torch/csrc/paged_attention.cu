// Paged decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_attention.py::paged_attention (the f32 /
// bf16 variant, `_kernel`), the Pallas kernel of the decode sub-batch.
//
// Computes, for each row b and query head h: one query token attends over
// the row's KV, which lives in pages [P, page, KV, D] reached through
// block_table[b, :] (-1 = unallocated). Head h reads kv-head h / G. Scores
// are scaled by D^-1/2 and masked by kpos < lens[b] and block_table >= 0;
// an online softmax runs across pages and the output is acc / max(l, 1e-30),
// so a row with nothing visible gives zeros.
//
// Bound: bytes. Each query token reads its row's live K and V once and does
// 4 flops per element read, far below the ~295 flop/byte the card needs to
// be compute bound; the least time is the live KV bytes over 3.35 TB/s.
//
// Design: the Pallas grid (B, H, n_pages) refetches each KV tile once per
// query head. Here one block serves a (row, kv-head) pair and all G query
// heads of its group, so each K/V element is read from device memory once.
// The sequential page axis of the grid becomes a loop inside the block: it
// walks the block table, skips -1 pages without reading them, and stops at
// the first page past lens[b]. Each tile of 32 tokens is loaded by the whole
// block with 16-byte loads into shared memory as fp32 (K rows padded by one
// float so that the 32 lanes, one token each, read distinct banks). Warp g
// owns query head g of the group (the block has max(4, G) warps; warps past
// G only load): lane t scores token t, the max and the sum of the online
// softmax are warp shuffles, and the running max, denominator and output
// columns lane + 32c stay in fp32 registers. Tiles are not double buffered
// and one block runs per (row, kv-head), so small batches leave SMs idle;
// split-K over pages (flash-decoding) and TMA loads are for a later change.
#include "common.cuh"

namespace {

constexpr int kTile = 32;       // tokens per tile: one per lane
constexpr int kMinWarps = 4;    // warps that load a tile, at least
constexpr int kMaxGroup = 32;   // query heads per kv-head: one warp each

template <typename T, int D>
__global__ void __launch_bounds__(kMaxGroup * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp, const int* __restrict__ bt,
                        const int* __restrict__ lens, T* __restrict__ out,
                        int H, int KV, int page, int n_pages, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;                // this warp's query head
  constexpr int VEC = Vec16<T>::N;
  constexpr int CHUNKS = D / VEC;
  constexpr int COLS = D / 32;

  extern __shared__ float smem[];
  float* Ks = smem;                      // [kTile][D + 1]
  float* Vs = Ks + kTile * (D + 1);      // [kTile][D]
  float* Qs = Vs + kTile * D;            // [G][D]

  // q heads kvh*G .. kvh*G+G-1 of row b are contiguous: [G][D]
  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x)
    Qs[i] = to_float(q[head0 + i]);

  float m = ATTN_NEG_INF, l = 0.f, acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  const int len = lens[b];
  const int* row = bt + (size_t)b * n_pages;
  const int n_live = len > 0 ? min(n_pages, (len + page - 1) / page) : 0;

  for (int pi = 0; pi < n_live; ++pi) {
    const int pg = row[pi];
    if (pg < 0) continue;                // bt < 0: masked, never read
    const int n_tok = min(page, len - pi * page);
    for (int t0 = 0; t0 < n_tok; t0 += kTile) {
      const int nt = min(kTile, n_tok - t0);
      __syncthreads();                   // the previous tile is consumed
      for (int i = tid; i < kTile * CHUNKS; i += blockDim.x) {
        const int t = i / CHUNKS;
        const int c = (i % CHUNKS) * VEC;
        float kv[VEC], vv[VEC];
        if (t < nt) {
          const size_t off =
              (((size_t)pg * page + t0 + t) * KV + kvh) * D + c;
          load16(kp + off, kv);
          load16(vp + off, vv);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) kv[j] = vv[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          Ks[t * (D + 1) + c + j] = kv[j];
          Vs[t * D + c + j] = vv[j];
        }
      }
      __syncthreads();
      if (g >= G) continue;              // warp-uniform: a loading warp

      const bool valid = lane < nt;      // kpos < len and the page is live
      float s = ATTN_NEG_INF;
      if (valid) {
        const float* kr = Ks + lane * (D + 1);
        const float* qr = Qs + g * D;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const bool alive = m_new > ATTN_NEG_INF / 2;
      const float alpha = alive ? expf(m - m_new) : 0.f;
      const float p = valid ? expf(s - (alive ? m_new : 0.f)) : 0.f;
      l = alpha * l + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] *= alpha;
      for (int j = 0; j < nt; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[c] = fmaf(pj, Vs[j * D + lane + 32 * c], acc[c]);
      }
    }
  }
  if (g < G) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      store_float(acc[c] * inv,
                  out + head0 + (size_t)g * D + lane + 32 * c);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* bt, const void* lens, void* out, int B, int H,
                   int KV, int page, int n_pages, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  if (G > kMaxGroup) return cudaErrorInvalidValue;
  const int threads = 32 * max(kMinWarps, G);
  const size_t smem =
      (size_t)(kTile * (D + 1) + kTile * D + G * D) * sizeof(float);
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(KV, B), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<T*>(out), H, KV, page,
      n_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: 64 or 128, H / KV <= 32 (the
// wrapper checks both).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* lens, void* out, int B,
                                      int H, int KV, int D, int page,
                                      int n_pages, int dtype, float scale,
                                      void* stream) {
  DISPATCH_DTYPE_HEAD_DIM(dtype, D, q, k_pages, v_pages, block_table, lens,
                          out, B, H, KV, page, n_pages, scale,
                          static_cast<cudaStream_t>(stream));
}
