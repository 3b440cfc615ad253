// The paged decode attention kernels, shared by paged_attention.cu (pages
// in the model dtype, f32 or bf16) and paged_attention_int8.cu (int8 pages
// with bf16 scales, one per token and kv-head). Each of the two sources
// instantiates them for its page type and builds into a library of its
// own, with its own launch function; paged_attention.cu holds the design
// note.
//
// Two kernels per call, on one stream:
//   paged_decode_partial_kernel, grid (KV, B, n_splits): split s of row b
//     covers block-table entries [s * pages_per_split, (s + 1) *
//     pages_per_split) and writes the online softmax's fp32 partial
//     (m, l, acc[D]) of each of the group's query heads to a workspace;
//   paged_decode_combine_kernel, one warp per (row, head): merges the
//     row's partials in split order and writes acc / max(l, 1e-30).
// The wrapper plans the splits (kernels/paged_attention.py::plan_splits:
// pages_per_split from the page size alone, n_splits from the table's
// width) and allocates the workspace, so nothing here depends on B or on
// another row, and the kernels allocate nothing.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace paged_decode {

constexpr int kTile = 32;         // tokens per tile: one per lane
constexpr int kMinWarps = 4;      // warps that load a tile, at least
constexpr int kMaxGroup = 32;     // query heads per kv-head: one warp each
constexpr int kCombineWarps = 4;  // (row, head) pairs per combine block

template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

// The four signed bytes of w as floats, exactly, without the quarter-rate
// integer-to-float unit: a byte permute builds 2^23 + (x + 128) as an
// fp32 bit pattern and one subtraction leaves x.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* dst) {
  const uint32_t u = w ^ 0x80808080u;     // x + 128 in each byte
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
             8388736.f;                   // 2^23 + 128
}

// N consecutive elements of T from shared memory as floats, in one load
// when they fit in 16 bytes (aligned to their size), else in 16-byte
// loads (16-byte aligned): at D = 256 a lane's 8 output columns of f32
// pages are 32 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_smem(const T* src, float* dst) {
  if constexpr (N * sizeof(T) > 16) {
    constexpr int HALF = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += HALF) load_smem<T, HALF>(src + i, dst + i);
  } else {
    using R = typename Raw<N * sizeof(T)>::type;
    const R raw = *reinterpret_cast<const R*>(src);
    if constexpr (std::is_same<T, int8_t>::value && N % 4 == 0) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) int8x4_to_float(w[i], dst + 4 * i);
    } else {
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) dst[i] = to_float(e[i]);
    }
  }
}

// Bytes of one K or V row of a tile in shared memory: the page row
// padded by 16 bytes, so that the 8 lanes of each quarter-warp reading 16
// bytes of 8 consecutive rows hit distinct banks.
template <typename KVT, int D>
__host__ __device__ constexpr int row_bytes() {
  return D * (int)sizeof(KVT) + 16;
}

// T: the type of q and the output (float or bf16). KVT: the type of the
// pages, T itself or int8_t. With int8_t pages, ks and vs are the scale
// pages [P, page, KV] (bf16) and each element is read as float(k8) *
// float(scale), which is exact in fp32; otherwise ks and vs are not read.
// ml: [2][B][H][n_splits] (m, then l); acc: [B][H][n_splits][D].
template <typename T, typename KVT, int D>
__global__ void __launch_bounds__(kMaxGroup * 32)
    paged_decode_partial_kernel(
        const T* __restrict__ q, const KVT* __restrict__ kp,
        const KVT* __restrict__ vp, const __nv_bfloat16* __restrict__ ks,
        const __nv_bfloat16* __restrict__ vs, const int* __restrict__ bt,
        const int* __restrict__ lens, float* __restrict__ ml,
        float* __restrict__ acc_out, int B, int H, int KV, int page,
        int n_pages, int pages_per_split, int n_splits, float scale) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  constexpr int ROW = row_bytes<KVT, D>();
  constexpr int CH = D * (int)sizeof(KVT) / 16;  // 16-byte chunks a row
  constexpr int VEC = 16 / (int)sizeof(KVT);     // elements a chunk
  constexpr int COLS = D / 32;                   // output columns a lane
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;                 // this warp's query head
  const int nthreads = blockDim.x;

  const int len = lens[b];
  const int* row = bt + (size_t)b * n_pages;
  const int n_live = len > 0 ? min(n_pages, (len + page - 1) / page) : 0;
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, n_live);
  // this warp's partial: (row b, head kvh * G + g, split)
  const size_t part = ((size_t)b * H + (size_t)kvh * G + g) * n_splits +
                      split;
  const size_t BHS = (size_t)B * H * n_splits;
  if (p_begin >= p_end) {                 // past the live pages: empty
    if (g < G && lane == 0) {
      ml[part] = -INFINITY;
      ml[BHS + part] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2 stages][K, V][kTile][ROW] bytes
  unsigned char* tiles = smem_raw;
  float* Qs = reinterpret_cast<float*>(tiles + 4 * kTile * ROW);  // [G][D]
  float* Sk = Qs + G * D;  // int8: the split's scales, [split tokens]
  float* Sv = Sk + pages_per_split * page;

  // q heads kvh*G .. kvh*G+G-1 of row b are contiguous: [G][D]
  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * D;

  // the split's tiles, in order: tile i is page p_begin + i / tpp, tokens
  // (i % tpp) * kTile ..; holes (-1) and tiles past len are skipped unread
  const int tpp = (page + kTile - 1) / kTile;
  const int n_tiles = (p_end - p_begin) * tpp;
  auto live = [&](int i) {
    const int pi = p_begin + i / tpp;
    return row[pi] >= 0 && (i % tpp) * kTile < len - pi * page;
  };
  auto next = [&](int i) {
    while (i < n_tiles && !live(i)) ++i;
    return i;
  };
  auto tile_tokens = [&](int i) {
    const int pi = p_begin + i / tpp;
    const int t0 = (i % tpp) * kTile;
    return min(kTile, min(page, len - pi * page) - t0);
  };
  auto load = [&](int i, int st) {
    const int pi = p_begin + i / tpp;
    const int t0 = (i % tpp) * kTile;
    const int nt = tile_tokens(i);
    const size_t tok0 = ((size_t)row[pi] * page + t0) * KV + kvh;
    unsigned char* kd = tiles + (2 * st) * kTile * ROW;
    unsigned char* vd = kd + kTile * ROW;
    for (int j = tid; j < nt * CH; j += nthreads) {
      const int t = j / CH, c = j % CH;
      const size_t src = (tok0 + (size_t)t * KV) * D * sizeof(KVT) + c * 16;
      cp_async16(smem_u32(kd + t * ROW + c * 16),
                 reinterpret_cast<const unsigned char*>(kp) + src);
      cp_async16(smem_u32(vd + t * ROW + c * 16),
                 reinterpret_cast<const unsigned char*>(vp) + src);
    }
  };

  int cur = next(0);
  if (cur < n_tiles) load(cur, 0);
  cp_async_commit();
  for (int i = tid; i < G * D; i += nthreads) Qs[i] = to_float(q[head0 + i]);
  if constexpr (kQuant) {
    // the split's scales, read once while the first tile loads
    for (int j = tid; j < (p_end - p_begin) * page; j += nthreads) {
      const int pi = p_begin + j / page;
      const int t = j % page;
      const int pg = row[pi];
      if (pg < 0 || t >= len - pi * page) continue;
      const size_t tok = ((size_t)pg * page + t) * KV + kvh;
      Sk[j] = __bfloat162float(ks[tok]);
      Sv[j] = __bfloat162float(vs[tok]);
    }
  }

  float m = -INFINITY, l = 0.f, acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int st = 0; cur < n_tiles; st ^= 1) {
    const int nxt = next(cur + 1);
    if (nxt < n_tiles) load(nxt, st ^ 1);
    cp_async_commit();                    // (an empty group at the end)
    cp_async_wait<1>();                   // tile `cur` has landed
    __syncthreads();
    if (g < G) {                          // warp-uniform: a loading warp
      const int nt = tile_tokens(cur);
      // index of the tile's first token among the split's, for scales
      const int sc0 = (cur / tpp) * page + (cur % tpp) * kTile;
      const unsigned char* kt = tiles + (2 * st) * kTile * ROW;
      const unsigned char* vt = kt + kTile * ROW;
      const bool valid = lane < nt;       // kpos < len and the page is live
      float s = -INFINITY;
      if (valid) {
        const KVT* kr = reinterpret_cast<const KVT*>(kt + lane * ROW);
        const float* qr = Qs + g * D;
        const float sk = kQuant ? Sk[sc0 + lane] : 1.f;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float kv[VEC];
          load_smem<KVT, VEC>(kr + c * VEC, kv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if constexpr (kQuant) kv[e] *= sk;
            dot = fmaf(qr[c * VEC + e], kv[e], dot);
          }
        }
        s = dot * scale;
      }
      const float m_new = fmaxf(m, warp_max(s));
      // a split with nothing visible yet keeps m = -inf, l = 0, acc = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - m_use);
      const float p = valid ? expf(s - m_use) : 0.f;
      l = alpha * l + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] *= alpha;
      for (int j = 0; j < nt; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        float vv[COLS];
        load_smem<KVT, COLS>(
            reinterpret_cast<const KVT*>(vt + j * ROW) + lane * COLS, vv);
        const float sv = kQuant ? Sv[sc0 + j] : 1.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          if constexpr (kQuant) vv[c] *= sv;
          acc[c] = fmaf(pj, vv[c], acc[c]);
        }
      }
    }
    __syncthreads();                      // stage st read before reload
    cur = nxt;
  }
  if (g < G) {
    if (lane == 0) {
      ml[part] = m;
      ml[BHS + part] = l;
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      acc_out[part * D + lane * COLS + c] = acc[c];
  }
}

// One warp per (row, head): the partials of its n_splits splits merged in
// split order, empty ones (l = 0) skipped; a row with nothing visible
// gives zeros.
template <typename T, int D>
__global__ void __launch_bounds__(kCombineWarps * 32)
    paged_decode_combine_kernel(const float* __restrict__ ml,
                                const float* __restrict__ acc,
                                T* __restrict__ out, int BH, int n_splits) {
  constexpr int COLS = D / 32;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (bh >= BH) return;
  const float* m = ml + (size_t)bh * n_splits;
  const float* l = m + (size_t)BH * n_splits;
  float M = -INFINITY;
  for (int s = lane; s < n_splits; s += 32)
    if (l[s] > 0.f) M = fmaxf(M, m[s]);
  M = warp_max(M);
  float L = 0.f, o[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) o[c] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float ls = l[s];
    if (!(ls > 0.f)) continue;
    const float w = expf(m[s] - M);
    L = fmaf(ls, w, L);
    const float* a = acc + ((size_t)bh * n_splits + s) * D + lane * COLS;
#pragma unroll
    for (int c = 0; c < COLS; ++c) o[c] = fmaf(a[c], w, o[c]);
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    store_float(o[c] * inv, out + (size_t)bh * D + lane * COLS + c);
}

// The partial pass, max(kMinWarps, G) warps a block, two stages of K/V
// tiles in the page type, the group's queries and (int8) the split's
// scales in dynamic shared memory; then the combine pass. ks and vs may
// be null when KVT is T.
template <typename T, typename KVT, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* bt,
                   const void* lens, void* ml, void* acc, void* out, int B,
                   int H, int KV, int page, int n_pages, int pages_per_split,
                   int n_splits, float scale, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  const int G = H / KV;
  if (G > kMaxGroup || pages_per_split < 1 || n_splits < 1)
    return cudaErrorInvalidValue;
  const int threads = 32 * max(kMinWarps, G);
  const size_t smem = (size_t)4 * kTile * row_bytes<KVT, D>() +
                      (size_t)G * D * sizeof(float) +
                      (kQuant ? (size_t)2 * pages_per_split * page *
                                    sizeof(float)
                              : 0);
  auto partial = paged_decode_partial_kernel<T, KVT, D>;
  cudaError_t err = allow_smem(partial, smem);
  if (err != cudaSuccess) return err;
  partial<<<dim3(KV, B, n_splits), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<float*>(ml),
      static_cast<float*>(acc), B, H, KV, page, n_pages, pages_per_split,
      n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  paged_decode_combine_kernel<T, D>
      <<<(BH + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0,
         stream>>>(static_cast<const float*>(ml),
                   static_cast<const float*>(acc), static_cast<T*>(out), BH,
                   n_splits);
  return cudaGetLastError();
}

}  // namespace paged_decode
