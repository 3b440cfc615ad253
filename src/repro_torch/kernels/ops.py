"""Device dispatch of the kernels, and their counts.

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

from . import build
from . import chunked_prefill_attention as _cpa
from . import paged_attention as _pa
from . import paged_attention_int8 as _pa8
from . import ref
from . import rmsnorm as _rms
from . import ssd_scan as _ssd

# each kernel's wrapper module, which counts its launches
_WRAPPERS = {"paged_attention": _pa, "paged_attention_int8": _pa8,
             "chunked_prefill_attention": _cpa, "rmsnorm": _rms,
             "ssd_scan": _ssd}
# calls of each plain version made through this module (updated under
# ``build.count_lock``, as the wrappers' launch counts are)
plain_calls: Dict[str, int] = {name: 0 for name in _WRAPPERS}
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
        with build.count_lock:
            plain_calls[name] += 1
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"{name}: no implementation for device {device}")


def paged_attention(q, k_pages, v_pages, block_table, lens, *,
                    k_scales=None, v_scales=None):
    """q: [B, H, D]; k_pages/v_pages: [P, page, KV, D] in q's dtype, or
    int8 with ``k_scales``/``v_scales`` [P, page, KV] bf16 (the
    fused-dequant variant, a kernel of its own on the card);
    block_table: [B, n_pages] int32 (-1 = unused); lens: [B] int32.
    Returns [B, H, D] in q's dtype."""
    if k_scales is not None:
        if _plain("paged_attention_int8", q.device):
            return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                           lens, k_scales, v_scales)
        return _pa8.paged_attention_int8_cuda(q, k_pages, v_pages, k_scales,
                                              v_scales, block_table, lens)
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


def rmsnorm(x, w, eps: float = 1e-5):
    """x: [..., D]; w: [D]. Returns ``x``'s shape and dtype."""
    if _plain("rmsnorm", x.device):
        return ref.rmsnorm_ref(x, w, eps)
    shape = x.shape
    out = _rms.rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                            w.contiguous(), eps)
    return out.reshape(shape)


def ssd_scan(x, dt, A, B_, C_, init_state, *, chunk: int):
    """x: [Bt, S, nh, hd]; dt: [Bt, S, nh] f32; A: [nh] f32; B_, C_:
    [Bt, S, ds]; init_state: [Bt, nh, hd, ds] f32. Any ``S``: the plain
    version zero-pads to the chunk grid, the kernel reads the last chunk's
    tail as dt = 0 in place. Returns (y [Bt, S, nh, hd] f32, final state
    [Bt, nh, hd, ds] f32)."""
    if _plain("ssd_scan", x.device):
        return ref.ssd_scan_ref(x, dt, A, B_, C_, init_state, chunk)
    return _ssd.ssd_scan_cuda(x, dt, A, B_, C_, init_state, chunk)


def reset_counts() -> None:
    """Zero every kernel's launch count and every plain-call count, and
    forget the attention kernels' variants."""
    with build.count_lock:
        for name, mod in _WRAPPERS.items():
            mod.launches = 0
            plain_calls[name] = 0
        for mod in (_pa, _pa8, _cpa):
            mod.variants.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "plain": m}}`` since the last reset."""
    with build.count_lock:
        return {name: {"launches": mod.launches, "plain": plain_calls[name]}
                for name, mod in _WRAPPERS.items()}


def variants() -> Dict[str, Dict]:
    """The launches of each attention kernel since the last reset, by
    variant: ``(head_dim, page)`` for decode, ``(head_dim, window)`` for
    prefill."""
    with build.count_lock:
        return {name: dict(mod.variants) for name, mod in
                (("paged_attention", _pa), ("paged_attention_int8", _pa8),
                 ("chunked_prefill_attention", _cpa))}
