"""Paged decode attention over int8 pages on Hopper: the wrapper of
``csrc/paged_attention_int8.cu``.

Replaces the int8 variant of the Pallas kernel
``repro/kernels/paged_attention.py::paged_attention`` (``_kernel_quant``):
int8 K/V pages with bf16 scale pages, one scale per token and kv-head,
dequantized inside the kernel exactly in fp32. The kernels are the bf16
decode kernels' (a split-K partial pass and a combine pass),
instantiated for int8 pages, with the same split plan; see the source's
note.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import build
from .paged_attention import MAX_GROUP, plan_splits, workspace

NAME = "paged_attention_int8"

launches = 0    # wrapper calls that launched the kernels, by this process
variants: Counter = Counter()   # the (head_dim, page) of each of those
heads: Counter = Counter()      # the (H, KV) of each of those


def _check(q, k_pages, v_pages, k_scales, v_scales, block_table, lens):
    """``build.check_inputs`` for q and the index tensors (its one-dtype
    rule cannot take the int8 pages), then this kernel's own rules: pages
    int8, contiguous and 16-byte aligned, and scales bf16 of shape
    ``[P, page, KV]``; a head dim of ``build.HEAD_DIMS`` and at most
    ``MAX_GROUP`` query heads per kv-head; last, every tensor on q's
    CUDA device."""
    build.check_inputs(NAME, (q,), (block_table, lens))
    pages, scales = (k_pages, v_pages), (k_scales, v_scales)
    if any(t.dtype != torch.int8 for t in pages):
        raise TypeError(f"{NAME}: the pages must be int8, got "
                        f"{[t.dtype for t in pages]}")
    if any(t.dtype != torch.bfloat16 for t in scales):
        raise TypeError(f"{NAME}: the scales must be bfloat16, got "
                        f"{[t.dtype for t in scales]}")
    if not all(t.is_contiguous() for t in pages + scales):
        raise ValueError(f"{NAME}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in pages):
        raise ValueError(f"{NAME}: the pages must be 16-byte aligned (the "
                         f"kernel loads 16 bytes at a time)")
    build.check_head_dim(NAME, q.shape[-1])
    B, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape \
            or k_scales.shape != (P, page, KV) \
            or v_scales.shape != k_scales.shape or H % KV \
            or H // KV > MAX_GROUP or block_table.dim() != 2 \
            or block_table.shape[0] != B or lens.shape != (B,):
        raise ValueError(
            f"{NAME}: unsupported shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, scales {tuple(k_scales.shape)}, "
            f"block_table {tuple(block_table.shape)}, lens "
            f"{tuple(lens.shape)} (scales are [P, page, KV]; at most "
            f"{MAX_GROUP} query heads per kv-head)")
    build.check_device(NAME, (q, *pages, *scales, block_table, lens))


def paged_attention_int8_cuda(q, k_pages, v_pages, k_scales, v_scales,
                              block_table, lens):
    """q: [B, H, D] (f32 or bf16); k_pages/v_pages: [P, page, KV, D] int8;
    k_scales/v_scales: [P, page, KV] bf16; block_table: [B, n_pages]
    int32 (-1 = unallocated); lens: [B] int32. Returns [B, H, D] in q's
    dtype. Launches the partial and the combine kernel on the current
    stream (one count)."""
    global launches
    _check(q, k_pages, v_pages, k_scales, v_scales, block_table, lens)
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_pages = block_table.shape[1]
    pages_per_split, n_splits = plan_splits(n_pages, page)
    ml, acc = workspace(q, n_pages, page)
    build.launch(NAME, q, k_pages, v_pages, k_scales, v_scales, block_table,
                 lens, ml, acc, out, B, H, KV, D, page, n_pages,
                 pages_per_split, n_splits, build.DTYPES[q.dtype],
                 D ** -0.5)
    with build.count_lock:
        launches += 1
        variants[D, page] += 1
        heads[H, KV] += 1
    return out
