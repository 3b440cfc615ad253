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
// The kernel itself is in paged_decode.cuh, which paged_attention_int8.cu
// instantiates for int8 pages.
#include "paged_decode.cuh"

namespace {

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* bt, const void* lens, void* out, int B, int H,
                   int KV, int page, int n_pages, float scale,
                   cudaStream_t stream) {
  return paged_decode::launch<T, T, D>(q, kp, vp, nullptr, nullptr, bt, lens,
                                       out, B, H, KV, page, n_pages, scale,
                                       stream);
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
