"""Chunked-prefill attention on Hopper: the wrapper of
``csrc/chunked_prefill_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/chunked_prefill_attention.py::
chunked_prefill_attention`` in both of its modes. The dynamic mode
(per-row ``q_offsets`` / ``kv_lens``) is what the engine calls; the
static mode (one ``q_offset`` / ``kv_len`` for every row) runs the same
kernel with the two values broadcast, since the kernel trims each query
tile's key loop at its own causal frontier either way. In bf16 the
products run on the tensor cores; f32 keeps a CUDA-core body (see the
source's note). Sliding-window layers pass ``window``; their decode rows
come here too, as one-token chunks (C = 1).
"""
from __future__ import annotations

from collections import Counter

import torch

from . import build

NAME = "chunked_prefill_attention"

launches = 0    # kernel launches by this process
# the (head_dim, window) of each of those launches (window None: causal)
variants: Counter = Counter()
heads: Counter = Counter()      # the (H, KV) of each of those


def _check(q, k, v, q_offsets, kv_lens, window):
    build.check_inputs(NAME, (q, k, v), (q_offsets, kv_lens))
    build.check_head_dim(NAME, q.shape[-1])
    B, C, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or v.shape != k.shape or H % k.shape[2] \
            or q_offsets.shape != (B,) or kv_lens.shape != (B,):
        raise ValueError(
            f"chunked_prefill_attention: unsupported shapes q "
            f"{tuple(q.shape)}, k/v {tuple(k.shape)}/{tuple(v.shape)}, "
            f"q_offsets {tuple(q_offsets.shape)}, kv_lens "
            f"{tuple(kv_lens.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"chunked_prefill_attention: window {window} "
                         f"must be positive")
    build.check_device(NAME, (q, k, v, q_offsets, kv_lens))


def chunked_prefill_attention_cuda(q, k, v, q_offsets, kv_lens, window=None):
    """q: [B, C, H, D]; k, v: [B, S, KV, D] (f32 or bf16, chunk already
    written); q_offsets, kv_lens: [B] int32. Mask ``kpos <= qpos``,
    ``kpos < kv_lens[b]`` and, with a window, ``qpos - kpos < window``.
    Returns [B, C, H, D] in q's dtype. Launches on the current stream."""
    global launches
    _check(q, k, v, q_offsets, kv_lens, window)
    B, C, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    build.launch(NAME, q, k, v, q_offsets, kv_lens, out, B, C, H, S, KV, D,
                 0 if window is None else window, build.DTYPES[q.dtype],
                 D ** -0.5)
    with build.count_lock:
        launches += 1
        variants[D, window] += 1
        heads[H, KV] += 1
    return out
