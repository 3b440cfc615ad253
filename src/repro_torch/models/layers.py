"""Layer primitives, as plain functions on tensors.

Each is the PyTorch counterpart of the function of the same name in the
JAX package's ``models/layers.py``, with the same arithmetic: fp32 math
inside ``rmsnorm`` and ``apply_rope``, the ``(1 + w)`` norm scale, and
attention scores and outputs accumulated in fp32 (JAX's
``preferred_element_type``). ``rmsnorm`` goes through ``kernels.ops``:
the CUDA kernel on the card, the plain version
(``kernels/ref.py::rmsnorm_ref``) on the CPU. The attention functions
(``blocked_attention``, ``swa_blocked_attention``, ``decode_attention``)
are the counterparts of jnp functions, not of Pallas kernels: they run
as torch ops on every device, with a Python loop over query blocks
where JAX scans.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.torch_api import einsum
from repro_torch.kernels import ops

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """``w`` is cast to x's dtype, which holds its values exactly where
    the two differ (bf16 weights over the encoder's fp32 rows)."""
    return ops.rmsnorm(x, w.to(x.dtype), eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [S] or [B, S] (global token positions).
    Rotates the two halves of the head dimension."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    ang = positions[..., None].float() * freqs              # [(B,) S, D/2]
    ang = ang[None, :, None, :] if positions.dim() == 1 \
        else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def _gqa_scores(q, k):
    """q: [B, Sq, KV, G, D], k: [B, Sk, KV, D] -> [B, KV, G, Sq, Sk] fp32."""
    return einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def _gqa_out(p, v):
    """p: [B, KV, G, Sq, Sk] fp32, v: [B, Sk, KV, D] -> [B, Sq, KV, G, D]."""
    return einsum("bkgqs,bskd->bqkgd", p, v.float())


def _softmax_masked(scores, mask):
    scores = torch.where(mask, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.clamp_min(m, -1e29)  # rows that are fully masked stay finite
    e = torch.exp(scores - m)
    e = torch.where(mask, e, 0.0)
    s = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp_min(s, 1e-30)


def _per_row_len(kv_len, B: int, device) -> torch.Tensor:
    """A scalar or ``[B]`` length as a ``[B]`` tensor."""
    t = torch.as_tensor(kv_len, device=device)
    return t.expand(B) if t.dim() == 0 else t


def blocked_attention(q, k, v, *, q_offset, kv_len, causal: bool = True,
                      window: Optional[int] = None, block_q: int = 512,
                      scale: Optional[float] = None):
    """Blocked attention without the [Sq, Sk] score matrix of the whole
    chunk: query stripes of ``block_q`` rows, one at a time.

    q:       [B, Sq, H, D]    query chunk (H = KV * G)
    k, v:    [B, Sk, KV, D]   full key/value buffer (cache prefix + chunk)
    q_offset: int — global position of q[:, 0]
    kv_len:  int or [B]       number of valid kv rows (<= Sk)
    window:  sliding window size (None = full)
    Returns [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.reshape(B, Sq, KV, G, D)
    kv_len = _per_row_len(kv_len, B, q.device)
    bq = min(block_q, Sq)
    kv_pos = torch.arange(Sk, device=q.device)
    outs = []
    for i0 in range(0, Sq, bq):
        q_blk = qf[:, i0:i0 + bq]
        if q_blk.shape[1] < bq:         # the padded last stripe, as in JAX
            q_blk = F.pad(q_blk, (0, 0, 0, 0, 0, 0, 0, bq - q_blk.shape[1]))
        q_pos = q_offset + i0 + torch.arange(bq, device=q.device)
        s = _gqa_scores(q_blk, k) * scale                 # [B,KV,G,bq,Sk]
        mask = (kv_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        p = _softmax_masked(s, mask)
        outs.append(_gqa_out(p, v).to(q.dtype))           # [B,bq,KV,G,D]
    out = torch.cat(outs, dim=1).reshape(B, -1, H, D)
    return out[:, :Sq]


def swa_blocked_attention(q, k, v, *, q_offset, kv_len, window: int,
                          block_q: int = 512,
                          scale: Optional[float] = None):
    """Banded sliding-window attention: each query stripe reads only the
    [window + block] key band it can see. The band's start is clipped to
    the buffer as ``lax.dynamic_slice`` clips it."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    bq = min(block_q, Sq)
    band = window + bq
    if Sk <= band:   # band covers the whole buffer — fall back
        return blocked_attention(q, k, v, q_offset=q_offset, kv_len=kv_len,
                                 causal=True, window=window, block_q=block_q,
                                 scale=scale)
    qf = q.reshape(B, Sq, KV, G, D)
    kv_len = _per_row_len(kv_len, B, q.device)
    outs = []
    for i0 in range(0, Sq, bq):
        q_blk = qf[:, i0:i0 + bq]
        if q_blk.shape[1] < bq:
            q_blk = F.pad(q_blk, (0, 0, 0, 0, 0, 0, 0, bq - q_blk.shape[1]))
        blk_start = q_offset + i0                         # pos of row 0
        start = min(max(blk_start - window + 1, 0), Sk - band)
        k_b, v_b = k[:, start:start + band], v[:, start:start + band]
        kv_pos = start + torch.arange(band, device=q.device)
        q_pos = blk_start + torch.arange(bq, device=q.device)
        s = _gqa_scores(q_blk, k_b) * scale
        mask = (kv_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        p = _softmax_masked(s, mask)
        outs.append(_gqa_out(p, v_b).to(q.dtype))
    out = torch.cat(outs, dim=1).reshape(B, -1, H, D)
    return out[:, :Sq]


def decode_attention(q, k, v, *, kv_len, window: Optional[int] = None,
                     scale: Optional[float] = None):
    """Single-token decode attention. q: [B, 1, H, D]; k/v: [B, Sk, KV, D];
    kv_len: [B] — the new token's position is kv_len-1 (already written)."""
    B, _, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.reshape(B, 1, KV, G, D)
    kv_pos = torch.arange(Sk, device=q.device)
    s = _gqa_scores(qf, k) * scale                        # [B,KV,G,1,Sk]
    mask = kv_pos[None, :] < kv_len[:, None]
    if window is not None:
        q_pos = kv_len - 1
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    p = _softmax_masked(s, mask[:, None, None, None, :])
    return _gqa_out(p, v).to(q.dtype).reshape(B, 1, H, D)


# ---------------------------------------------------------------- mlp

def swiglu(x, w_gate, w_up, w_down, constrain=None):
    """``constrain`` (the serve forward's ``shard``) sees the hidden
    activations between the up-projections and ``w_down``: a
    tensor-parallel rank gathers its d_ff slices there (``tp_ffn``), so
    the down-projection runs replicated, as in JAX."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    if constrain is not None:
        h = constrain(h, "tp_ffn")
    return h @ w_down
