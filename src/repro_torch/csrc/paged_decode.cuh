// The paged decode attention kernel, shared by paged_attention.cu (pages
// in the model dtype, f32 or bf16) and paged_attention_int8.cu (int8 pages
// with bf16 scales, one per token and kv-head). Each of the two sources
// instantiates it for its page type and builds into a library of its own,
// with its own launch function; paged_attention.cu holds the design note.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace paged_decode {

constexpr int kTile = 32;       // tokens per tile: one per lane
constexpr int kMinWarps = 4;    // warps that load a tile, at least
constexpr int kMaxGroup = 32;   // query heads per kv-head: one warp each

// T: the type of q and the output (float or bf16). KVT: the type of the
// pages, T itself or int8_t. With int8_t pages, ks and vs are the scale
// pages [P, page, KV] (bf16) and each element enters the fp32 tile as
// float(k8) * float(scale), which is exact in fp32; otherwise ks and vs are
// not read.
template <typename T, typename KVT, int D>
__global__ void __launch_bounds__(kMaxGroup * 32)
    paged_decode_kernel(const T* __restrict__ q, const KVT* __restrict__ kp,
                        const KVT* __restrict__ vp,
                        const __nv_bfloat16* __restrict__ ks,
                        const __nv_bfloat16* __restrict__ vs,
                        const int* __restrict__ bt,
                        const int* __restrict__ lens, T* __restrict__ out,
                        int H, int KV, int page, int n_pages, float scale) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;                // this warp's query head
  constexpr int VEC = Vec16<KVT>::N;     // page elements per 16-byte load
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
          // (token, kv-head) row of the pages, and of the scale pages
          const size_t tok = ((size_t)pg * page + t0 + t) * KV + kvh;
          load16(kp + tok * D + c, kv);
          load16(vp + tok * D + c, vv);
          if constexpr (kQuant) {
            const float sk = __bfloat162float(ks[tok]);
            const float sv = __bfloat162float(vs[tok]);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              kv[j] *= sk;
              vv[j] *= sv;
            }
          }
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

// One block per (kv-head, row), max(kMinWarps, G) warps; the fp32 tiles and
// the group's queries in dynamic shared memory. ks and vs may be null when
// KVT is T.
template <typename T, typename KVT, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* bt,
                   const void* lens, void* out, int B, int H, int KV,
                   int page, int n_pages, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G > kMaxGroup) return cudaErrorInvalidValue;
  const int threads = 32 * max(kMinWarps, G);
  const size_t smem =
      (size_t)(kTile * (D + 1) + kTile * D + G * D) * sizeof(float);
  auto kernel = paged_decode_kernel<T, KVT, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(KV, B), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<T*>(out), H, KV, page,
      n_pages, scale);
  return cudaGetLastError();
}

}  // namespace paged_decode
