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
// Design: the split-K kernels of paged_attention.cu (paged_decode.cuh),
// instantiated for int8 pages: one block per (kv-head, row, split) serving
// all G query heads, walking its pages and skipping -1 pages unread, then
// the combine pass. A tile's K and V rows arrive as 16 int8 values per
// 16-byte cp.async into the two-stage ring, in int8 (half the bf16 tile);
// the split's bf16 scales are read once into shared memory as fp32 while
// the first tile loads, and each element is dequantized as float(k8) *
// float(scale) where it is read, exactly as before; the int8 to fp32
// conversion is a byte permute and a subtraction (exact), since the
// integer-to-float unit runs at a quarter of the fp32 rate. On an H100
// 80GB HBM3 at 700 W the timed batch takes 0.040 ms against 0.033 for
// bf16 pages (the first version: 0.272 against 0.281): per-element work
// (conversion, the dequantizing product, the FMA), not bytes, holds it,
// at 9% of its bound.
#include "paged_decode.cuh"

namespace {

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* bt,
                   const void* lens, void* ml, void* acc, void* out, int B,
                   int H, int KV, int page, int n_pages, int pages_per_split,
                   int n_splits, float scale, cudaStream_t stream) {
  return paged_decode::launch<T, int8_t, D>(
      q, kp, vp, ks, vs, bt, lens, ml, acc, out, B, H, KV, page, n_pages,
      pages_per_split, n_splits, scale, stream);
}

}  // namespace

// dtype: of q and the output, 0 = float32, 1 = bfloat16. Pages int8, scales
// bf16. D: 64, 128 or 256, H / KV <= 32 (the wrapper checks all of
// these). ml and acc: the splits' fp32 workspace, as in
// paged_attention.cu.
extern "C" int paged_attention_int8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_table,
    const void* lens, void* ml, void* acc, void* out, int B, int H, int KV,
    int D, int page, int n_pages, int pages_per_split, int n_splits,
    int dtype, float scale, void* stream) {
  DISPATCH_DTYPE_HEAD_DIM(dtype, D, q, k_pages, v_pages, k_scales, v_scales,
                          block_table, lens, ml, acc, out, B, H, KV, page,
                          n_pages, pages_per_split, n_splits, scale,
                          static_cast<cudaStream_t>(stream));
}
