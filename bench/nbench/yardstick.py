"""The yardstick's arithmetic: the table of peaks, a kernel's bound and
the work that a plan's attention needs. The model FLOPs of a plan depend
on the architecture, so each family module counts its own
(``step_flops``, ``nbench/family.py``).

``bound_ms``, ``_paged_work``, ``_live_tokens``, ``_prefill_mask`` and
``_prefill_work`` are frozen copies of ``chip_smoke.py``'s (the
kernels phase), with the mask built on its inputs' device;
``bench/tests/test_bench_copies.py`` holds them to the original. The
benchmark counts work from what a plan needs (its real rows, chunks and
context lengths), never from the buckets or launches that serve it, so
a change to a kernel cannot move its own yardstick: ``decode_work`` and
``prefill_work`` are the copies' counts for the plan's real rows alone,
in closed form.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
              torch.bfloat16: 989e12}  # dense bf16 tensor cores


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_tokens(bt, lens, page: int) -> int:
    """Tokens of pages in the table below each row's length."""
    bt_h, lens_h = bt.cpu().numpy(), lens.cpu().numpy()
    live = 0
    for b in range(bt_h.shape[0]):
        for pi in range(bt_h.shape[1]):
            if bt_h[b, pi] >= 0:
                live += max(0, min(page, lens_h[b] - pi * page))
    return live


def _paged_work(q, kp, bt, lens, quant: bool = False):
    """Bytes and flops of the live work: the K/V rows of the live tokens
    (with int8 pages, ``quant``, their bf16 scales too: one each per token
    and kv-head), q, the output, the table and lens; 4 flops per (head,
    element), and with int8 pages the dequantization's product per page
    element."""
    B, H, D = q.shape
    page, KV = kp.shape[1], kp.shape[2]
    live = _live_tokens(bt, lens, page)
    row_bytes = D * kp.element_size() + (2 if quant else 0)
    nbytes = 2 * live * KV * row_bytes + 2 * B * H * D * q.element_size() \
        + bt.numel() * 4 + B * 4
    flops = 4.0 * live * H * D + (2.0 * live * KV * D if quant else 0.0)
    return nbytes, flops


def _prefill_mask(C, S, q_offsets, kv_lens, window=None):
    dev = q_offsets.device
    qpos = q_offsets.long()[:, None] + torch.arange(C, device=dev)
    kpos = torch.arange(S, device=dev)
    mask = (kpos[None, None] <= qpos[:, :, None]) \
        & (kpos[None, None] < kv_lens.long()[:, None, None])
    if window is not None:
        mask &= qpos[:, :, None] - kpos[None, None] < window
    return mask                                            # [B, C, S]


def _prefill_work(q, k, q_offsets, kv_lens, window=None):
    """Bytes and flops of the live work: visible (query, key) pairs, the
    key rows any query sees, q and the output."""
    B, C, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    mask = _prefill_mask(C, S, q_offsets, kv_lens, window)
    pairs = int(mask.sum())
    key_rows = int(mask.any(dim=1).sum())
    nbytes = 2 * key_rows * KV * D * es + 2 * B * C * H * D * es + 8 * B
    return nbytes, 4.0 * pairs * H * D


def decode_work(ctxs: Iterable[int], H: int, KV: int, D: int, page: int,
                es: int) -> Tuple[float, float]:
    """``_paged_work`` of one decode call over the plan's real rows only:
    ``ctxs`` are the rows' lengths after this step's write, each row's
    table as wide as its own pages."""
    ctxs = list(ctxs)
    B = len(ctxs)
    live = sum(ctxs)
    pages = sum(-(-c // page) for c in ctxs)
    nbytes = 2 * live * KV * D * es + 2 * B * H * D * es + pages * 4 + B * 4
    return float(nbytes), 4.0 * live * H * D


def prefill_work(chunks: Iterable[Tuple[int, int]], H: int, KV: int,
                 D: int, es: int) -> Tuple[float, float]:
    """``_prefill_work`` of one prefill call over the plan's real chunks
    only, each ``(start, real)`` as its own unpadded row: a chunk's
    queries see ``start + i + 1`` keys each, and its ``start + real`` key
    rows are read once."""
    nbytes = pairs = 0
    for start, real in chunks:
        pairs += real * start + real * (real + 1) // 2
        nbytes += 2 * (start + real) * KV * D * es + 2 * real * H * D * es \
            + 8
    return float(nbytes), 4.0 * pairs * H * D

