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
// be compute bound; the least time is the live KV bytes over 3.35 TB/s
// (0.0067 ms for the timed batch: 8 rows, 5481 live tokens, 8 kv-heads of
// 128, bf16).
//
// What held the first version back was latency and occupancy, not bytes:
// one block per (row, kv-head) gave 64 blocks for 132 SMs at B = 8, each
// walking its row's whole length alone with synchronous loads into fp32
// tiles (0.28 ms, 41x the bound, on an H100 80GB HBM3 at 700 W; halving
// the bytes with int8 pages moved it 3%).
//
// Design (paged_decode.cuh): split-K over the block table, as
// flash-decoding does. The partial pass runs one block per (kv-head, row,
// split); a split covers pages_per_split consecutive table entries (128
// tokens: 2 pages of 64), so a long row spreads over many SMs, and the
// number of splits follows the table's width alone: a row's result does
// not depend on B, on the other rows or on the page-window bucket. A
// split walks its pages, skips -1 pages unread and loads 32-token tiles
// of K and V in the page type with 16-byte cp.async into a two-stage
// ring, so the next tile loads while this one is computed. The block
// serves all G query heads of the kv-head from one copy of the tiles:
// warp g owns query head g, lane t scores token t, the online softmax's
// max and sum are warp shuffles and its state stays in fp32 registers.
// Each split writes its (m, l, acc) to an fp32 workspace that the wrapper
// allocates; the combine pass (one warp per (row, head)) merges a row's
// splits in split order, skips empty ones and writes acc / max(l, 1e-30),
// without atomics, so a row's output is bit-identical whatever the batch
// and the table's width. The int8 pages of paged_attention_int8.cu run the
// same template. The timed batch now takes 0.033 ms (H100 80GB HBM3, 700
// W), 20% of its bound and 2.8x under SDPA over the gathered view; what is
// left is latency: a 128-token split is four dependent tile loads, and
// the combine pass is a second launch. Left for later: CUDA graphs
// around the two launches, a deeper ring or TMA for the tiles. At D = 256
// (gemma3-4b's global layers) the same template holds 8 output columns a
// lane and 66 KB of bf16 tiles (130 KB for f32 pages, past the default
// 48 KB, so allow_smem opts in); its time equals D = 128's at the same
// bytes (PERF.md).
#include "paged_decode.cuh"

namespace {

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* bt, const void* lens, void* ml, void* acc,
                   void* out, int B, int H, int KV, int page, int n_pages,
                   int pages_per_split, int n_splits, float scale,
                   cudaStream_t stream) {
  return paged_decode::launch<T, T, D>(q, kp, vp, nullptr, nullptr, bt, lens,
                                       ml, acc, out, B, H, KV, page, n_pages,
                                       pages_per_split, n_splits, scale,
                                       stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: 64, 128 or 256, H / KV <= 32 (the
// wrapper checks both). ml [2, B, H, n_splits] and acc [B, H, n_splits, D]
// are the fp32 workspace of the splits (kernels/paged_attention.py::
// plan_splits).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* lens, void* ml, void* acc,
                                      void* out, int B, int H, int KV, int D,
                                      int page, int n_pages,
                                      int pages_per_split, int n_splits,
                                      int dtype, float scale, void* stream) {
  DISPATCH_DTYPE_HEAD_DIM(dtype, D, q, k_pages, v_pages, block_table, lens,
                          ml, acc, out, B, H, KV, page, n_pages,
                          pages_per_split, n_splits, scale,
                          static_cast<cudaStream_t>(stream));
}
