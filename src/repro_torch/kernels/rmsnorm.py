"""Fused RMSNorm on Hopper: the wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``: one
pass over ``[N, D]`` rows computing ``x * rsqrt(mean(x^2) + eps) *
(1 + w)`` in fp32 and writing the result in ``x``'s dtype. One CUDA
block serves one row; see the source's note for the design and its
bound.
"""
from __future__ import annotations

import torch

from . import build

NAME = "rmsnorm"

launches = 0    # kernel launches by this process


def _check(x, w):
    build.check_inputs(NAME, (x, w), ())
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} (x is [N, D], w is [D])")
    build.check_device(NAME, (x, w))


def rmsnorm_cuda(x, w, eps: float = 1e-5):
    """x: [N, D] (f32 or bf16); w: [D] in x's dtype. Any D: rows whose
    width is a multiple of 16 bytes are read 16 bytes at a time, others
    element by element. Returns [N, D] in x's dtype. Launches on the
    current stream."""
    global launches
    _check(x, w)
    N, D = x.shape
    out = torch.empty_like(x)
    if N == 0 or D == 0:
        return out
    build.launch(NAME, x, w, out, N, D, build.DTYPES[x.dtype], float(eps))
    launches += 1
    return out
