// Paged decode attention over int8 pages with fused dequantization, for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_attention.py::paged_attention, its int8
// variant (`_kernel_quant`), which the int8 paged KV cache's decode batch
// runs.
//
// Computes what paged_attention.cu computes, over pages [P, page, KV, D] of
// int8 with scale pages k_scales / v_scales [P, page, KV] of bf16, one per
// token and kv-head, reached through the same block table: each element is
// dequantized as float(k8) * float(k_scale), exactly in fp32 (an 8-bit
// integer times a bf16 value needs at most 15 significant bits), and is
// never rounded to bf16. q and the output are in the model dtype, f32 or
// bf16.
//
// Bound: bytes. Per live token and kv-head the kernel reads 2 * D bytes of
// pages and 4 bytes of scales, 260 bytes at D = 128 against 512 for bf16
// pages; the 4 flops per element read leave it far below the card's
// flop/byte balance.
//
// Design: the kernel of paged_attention.cu (paged_decode.cuh), instantiated
// for int8 pages: one block per (row, kv-head) serving all G query heads,
// walking the block table and skipping -1 pages unread. A tile's K and V
// rows arrive as 16 int8 values per 16-byte load; the thread that loads a
// row's 16 values loads its bf16 scale too (the row's other loads hit the
// same line in L1) and writes the products into the same fp32 shared-memory
// tile as the bf16 kernel, so everything after the load is shared. Like the
// bf16 kernel it is held by latency and occupancy (one block per (row,
// kv-head), no overlap of loads with compute), not by its bytes.
#include "paged_decode.cuh"

namespace {

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* bt,
                   const void* lens, void* out, int B, int H, int KV,
                   int page, int n_pages, float scale, cudaStream_t stream) {
  return paged_decode::launch<T, int8_t, D>(q, kp, vp, ks, vs, bt, lens, out,
                                            B, H, KV, page, n_pages, scale,
                                            stream);
}

}  // namespace

// dtype: of q and the output, 0 = float32, 1 = bfloat16. Pages int8, scales
// bf16. D: 64 or 128, H / KV <= 32 (the wrapper checks all of these).
extern "C" int paged_attention_int8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lens, void* out, int B, int H, int KV, int D, int page,
    int n_pages, int dtype, float scale, void* stream) {
  DISPATCH_DTYPE_HEAD_DIM(dtype, D, q, k_pages, v_pages, k_scales, v_scales,
                          block_table, lens, out, B, H, KV, page, n_pages,
                          scale, static_cast<cudaStream_t>(stream));
}
