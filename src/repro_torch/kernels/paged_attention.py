"""Paged decode attention on Hopper: the wrapper of
``csrc/paged_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/paged_attention.py::
paged_attention`` (its fp/bf16 variant; the int8 one is
``paged_attention_int8``). One CUDA block serves one ``(row, kv-head)`` pair and all G query
heads of that group, walking the row's block table page by page; see
the source's note for the design and its bound.
"""
from __future__ import annotations

import torch

from . import build

NAME = "paged_attention"
MAX_GROUP = 32      # query heads per kv-head: one warp each

launches = 0    # kernel launches by this process


def _check(q, k_pages, v_pages, block_table, lens):
    build.check_inputs(NAME, (q, k_pages, v_pages), (block_table, lens))
    build.check_head_dim(NAME, q.shape[-1])
    B, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape or H % KV \
            or H // KV > MAX_GROUP or block_table.dim() != 2 \
            or block_table.shape[0] != B or lens.shape != (B,):
        raise ValueError(
            f"paged_attention: unsupported shapes q {tuple(q.shape)}, "
            f"pages {tuple(k_pages.shape)}, block_table "
            f"{tuple(block_table.shape)}, lens {tuple(lens.shape)} "
            f"(at most {MAX_GROUP} query heads per kv-head)")


def paged_attention_cuda(q, k_pages, v_pages, block_table, lens):
    """q: [B, H, D]; k_pages/v_pages: [P, page, KV, D] (f32 or bf16);
    block_table: [B, n_pages] int32 (-1 = unallocated); lens: [B] int32.
    Returns [B, H, D] in q's dtype. Launches on the current stream."""
    global launches
    _check(q, k_pages, v_pages, block_table, lens)
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    build.launch(NAME, q, k_pages, v_pages, block_table, lens, out, B, H,
                 KV, D, page, block_table.shape[1], build.DTYPES[q.dtype],
                 D ** -0.5)
    launches += 1
    return out
