"""Fused RMSNorm on Hopper: the wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``: one
pass over ``[N, D]`` rows computing ``x * rsqrt(mean(x^2) + eps) *
(1 + w)`` in fp32 and writing the result in ``x``'s dtype. A row stays in
registers from its one read to its write, ``plan`` warps per row, its
squares summed by warp shuffles (in fp64 for f32 rows); see the source's
note for the design and its bound.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

NAME = "rmsnorm"
UNITS_PER_LANE = (1, 2, 4, 8, 12, 16)   # the kernel's instantiations
LANE_UNITS = 4      # units a lane holds before a row takes another warp
BLOCK_WARPS = 4     # warps per block while a row needs at most four
MAX_WARPS = 8       # warps per row (and per block) at most

launches = 0    # kernel launches by this process


class Plan(NamedTuple):
    vec: bool           # 16-byte units (D * itemsize a multiple of 16)
    warps_per_row: int
    units_per_lane: int
    rows_per_block: int


def plan(D: int, dtype: torch.dtype) -> Plan:
    """How the kernel lays a row of ``D`` elements of ``dtype`` over its
    threads: as many warps as hold the row at ``LANE_UNITS`` 16-byte
    units (or elements, for rows that are not a multiple of 16 bytes) a
    lane, at most ``MAX_WARPS``, beyond which a lane holds up to 16. It
    depends on the width and the dtype alone, never on the number of
    rows."""
    es = torch.empty((), dtype=dtype).element_size()
    vec = D * es % 16 == 0
    units = D // (16 // es) if vec else D
    wpr = min(MAX_WARPS, max(1, -(-units // (32 * LANE_UNITS))))
    need = -(-units // (32 * wpr))
    if need > UNITS_PER_LANE[-1]:
        raise ValueError(f"rmsnorm: a row of {D} {dtype} elements needs "
                         f"more than {MAX_WARPS} warps of "
                         f"{UNITS_PER_LANE[-1]} units a lane")
    upl = next(u for u in UNITS_PER_LANE if u >= need)
    return Plan(vec, wpr, upl, max(1, BLOCK_WARPS // wpr))


def _check(x, w):
    build.check_inputs(NAME, (x, w), ())
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} (x is [N, D], w is [D])")
    p = plan(x.shape[1], x.dtype)
    build.check_device(NAME, (x, w))
    return p


def rmsnorm_cuda(x, w, eps: float = 1e-5):
    """x: [N, D] (f32 or bf16); w: [D] in x's dtype. Any D up to eight
    warps' registers: rows whose width is a multiple of 16 bytes are read
    16 bytes at a time (up to 32768 bf16 or 16384 f32 elements), others
    element by element (up to 4096). Returns [N, D] in x's dtype.
    Launches on the current stream."""
    global launches
    p = _check(x, w)
    N, D = x.shape
    out = torch.empty_like(x)
    if N == 0 or D == 0:
        return out
    build.launch(NAME, x, w, out, N, D, build.DTYPES[x.dtype], float(eps),
                 int(p.vec), p.warps_per_row, p.units_per_lane,
                 p.rows_per_block)
    with build.count_lock:
        launches += 1
    return out
