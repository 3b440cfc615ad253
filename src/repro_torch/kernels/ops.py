"""Device dispatch of the attention kernels, and their counts.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref``),
a CUDA tensor to the hand-written kernel; there is no fallback from one
to the other, so a kernel that fails to build or launch raises.
Inside ``with plain_versions():`` the plain versions run on any device:
``chip_smoke.py`` compares the model's kernel path with them on the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from . import chunked_prefill_attention as _cpa
from . import paged_attention as _pa
from . import ref

# calls of each plain version made through this module
plain_calls: Dict[str, int] = {"paged_attention": 0,
                               "chunked_prefill_attention": 0}
_force_plain = False


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run the plain versions on every device while the block lasts."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def _plain(name: str, device: torch.device) -> bool:
    if _force_plain or device.type == "cpu":
        plain_calls[name] += 1
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"{name}: no implementation for device {device}")


def paged_attention(q, k_pages, v_pages, block_table, lens):
    """q: [B, H, D]; k_pages/v_pages: [P, page, KV, D];
    block_table: [B, n_pages] int32 (-1 = unused); lens: [B] int32.
    Returns [B, H, D]."""
    if _plain("paged_attention", q.device):
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                       lens)
    return _pa.paged_attention_cuda(q, k_pages, v_pages, block_table, lens)


def chunked_prefill_attention(q, k, v, *, q_offset: int = 0,
                              kv_len=None, window=None, q_offsets=None,
                              kv_lens=None):
    """q: [B, C, H, D]; k, v: [B, S, KV, D] (cache, chunk already
    written). Returns [B, C, H, D].

    As in the JAX package, two modes: static, with one ``q_offset`` /
    ``kv_len`` (default ``S``) for every row, and dynamic, with per-row
    ``q_offsets`` / ``kv_lens`` ([B] int32), which then take precedence."""
    if q_offsets is None:
        B, S = q.shape[0], k.shape[1]
        q_offsets = torch.full((B,), q_offset, dtype=torch.int32,
                               device=q.device)
        kv_lens = torch.full((B,), S if kv_len is None else kv_len,
                             dtype=torch.int32, device=q.device)
    if _plain("chunked_prefill_attention", q.device):
        return ref.chunked_prefill_attention_ref(q, k, v, q_offsets,
                                                 kv_lens, window=window)
    return _cpa.chunked_prefill_attention_cuda(q, k, v, q_offsets, kv_lens,
                                               window=window)


def reset_counts() -> None:
    """Zero every kernel's launch count and every plain-call count."""
    _pa.launches = 0
    _cpa.launches = 0
    for name in plain_calls:
        plain_calls[name] = 0


def counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "plain": m}}`` since the last reset."""
    return {"paged_attention": {"launches": _pa.launches,
                                "plain": plain_calls["paged_attention"]},
            "chunked_prefill_attention": {
                "launches": _cpa.launches,
                "plain": plain_calls["chunked_prefill_attention"]}}
