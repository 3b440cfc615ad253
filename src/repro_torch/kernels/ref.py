"""Plain PyTorch versions of the attention kernels.

The simplest correct implementation of each function (a gather and a
naive masked softmax in fp32), written apart from the CUDA kernels so
that agreement between the two means something. The CPU path of
``kernels.ops`` runs them, the tests hold them against the JAX package's
``kernels/ref.py`` and Pallas kernels, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.

Unlike the JAX oracles (softmax over ``-inf``), a row with nothing
visible gives zeros here, as the Pallas kernels and the model's masked
softmax do: the engine's pad rows and inactive decode slots are such
rows, and their outputs must stay finite.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import _softmax_masked


def _per_row(x, batch: int, device) -> torch.Tensor:
    """An int or a ``[B]`` tensor as a ``[B, 1]`` int64 column."""
    t = torch.as_tensor(x, device=device).to(torch.int64).reshape(-1, 1)
    return t.expand(batch, 1)


def chunked_prefill_attention_ref(q, k, v, q_offset, kv_len, window=None):
    """q: [B, C, H, D] chunk queries at positions ``q_offset + i``.
    k, v: [B, S, KV, D] cache buffer (the first ``kv_len`` rows valid,
    the chunk included). ``q_offset`` and ``kv_len`` are ints (the JAX
    static mode) or ``[B]`` tensors (per-row, the dynamic mode).
    Returns [B, C, H, D]."""
    B, C, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qf = q.reshape(B, C, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * D ** -0.5
    qpos = _per_row(q_offset, B, dev) + torch.arange(C, device=dev)  # [B, C]
    kpos = torch.arange(S, device=dev)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) \
        & (kpos[None, None, :] < _per_row(kv_len, B, dev)[:, :, None])
    if window is not None:
        mask = mask & (qpos[:, :, None] - kpos[None, None, :] < window)
    p = _softmax_masked(s, mask[:, None, None])               # [B,KV,G,C,S]
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, C, H, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_table, lens):
    """Decode attention over a paged KV cache.

    q: [B, H, D]; k_pages/v_pages: [P, page, KV, D];
    block_table: [B, n_pages] int32 (page ids, -1 pad); lens: [B] int32.
    Returns [B, H, D]."""
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    n_pages = block_table.shape[1]
    safe = block_table.clamp_min(0).long()
    k = k_pages[safe].reshape(B, n_pages * page, KV, D)
    v = v_pages[safe].reshape(B, n_pages * page, KV, D)
    pos = torch.arange(n_pages * page, device=q.device)
    valid = (pos[None, :] < lens[:, None]) \
        & (block_table >= 0).repeat_interleave(page, dim=1)
    qf = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * D ** -0.5
    p = _softmax_masked(s, valid[:, None, None, :])
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)
