"""Layer primitives of the serve path, as plain functions on tensors.

Each is the PyTorch counterpart of the function of the same name in the
JAX package's ``models/layers.py``, with the same arithmetic: fp32 math
inside ``rmsnorm`` and ``apply_rope``, and the ``(1 + w)`` norm scale.
``rmsnorm`` goes through ``kernels.ops``: the CUDA kernel on the card,
the plain version (``kernels/ref.py::rmsnorm_ref``) on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    return ops.rmsnorm(x, w, eps)


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


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
