"""Paged decode attention on Hopper: the wrapper of
``csrc/paged_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/paged_attention.py::
paged_attention`` (its fp/bf16 variant; the int8 one is
``paged_attention_int8``). A call is two kernels: a partial pass, one
block per ``(kv-head, row, split)`` where a split is a fixed run of
block-table entries, and a combine pass that merges each row's splits
in order (split-K, as flash-decoding does); see the source's note.
``plan_splits`` and ``workspace`` are the wrapper's pure-Python plan of
the splits and their fp32 workspace, shared with the int8 wrapper.
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch

from . import build

NAME = "paged_attention"
MAX_GROUP = 32      # query heads per kv-head: one warp each
SPLIT_TOKENS = 128  # tokens a split covers (at least one page)

launches = 0    # wrapper calls that launched the kernels, by this process
variants: Counter = Counter()   # the (head_dim, page) of each of those
heads: Counter = Counter()      # the (H, KV) of each of those


def plan_splits(n_pages: int, page: int) -> Tuple[int, int]:
    """``(pages_per_split, n_splits)`` for a block table ``n_pages``
    entries wide over pages of ``page`` tokens. They depend on those two
    alone, never on the batch or on a row's length, so a row's result is
    the same in any batch, and a table widened by columns of -1 only adds
    empty splits."""
    pages_per_split = max(1, SPLIT_TOKENS // page)
    return pages_per_split, max(1, -(-n_pages // pages_per_split))


def workspace(q, n_pages: int, page: int):
    """The empty fp32 workspace of a call on q's device (the kernels
    allocate nothing): each split's running max and sum
    ``[2, B, H, n_splits]`` and its unnormalised output
    ``[B, H, n_splits, D]``."""
    B, H, D = q.shape
    n_splits = plan_splits(n_pages, page)[1]
    return (torch.empty((2, B, H, n_splits), dtype=torch.float32,
                        device=q.device),
            torch.empty((B, H, n_splits, D), dtype=torch.float32,
                        device=q.device))


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
    build.check_device(NAME, (q, k_pages, v_pages, block_table, lens))


def paged_attention_cuda(q, k_pages, v_pages, block_table, lens):
    """q: [B, H, D]; k_pages/v_pages: [P, page, KV, D] (f32 or bf16);
    block_table: [B, n_pages] int32 (-1 = unallocated); lens: [B] int32.
    Returns [B, H, D] in q's dtype. Launches the partial and the combine
    kernel on the current stream (one count)."""
    global launches
    _check(q, k_pages, v_pages, block_table, lens)
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_pages = block_table.shape[1]
    pages_per_split, n_splits = plan_splits(n_pages, page)
    ml, acc = workspace(q, n_pages, page)
    build.launch(NAME, q, k_pages, v_pages, block_table, lens, ml, acc, out,
                 B, H, KV, D, page, n_pages, pages_per_split, n_splits,
                 build.DTYPES[q.dtype], D ** -0.5)
    with build.count_lock:
        launches += 1
        variants[D, page] += 1
        heads[H, KV] += 1
    return out
