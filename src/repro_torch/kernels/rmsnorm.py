"""Fused RMSNorm on Hopper: the wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``: one
pass over ``[N, D]`` rows computing ``x * rsqrt(mean(x^2) + eps) *
(1 + w)`` in fp32 and writing the result in ``x``'s dtype. A row stays in
registers from its one read to its write, ``plan`` warps per row, its
squares summed by warp shuffles (in fp64 for f32 rows); see the source's
note for the design and its bound.

Its gradient, ``rmsnorm_bwd_cuda``, is the second entry of the same
source (the JAX package's training path differentiates
``models/layers.py::rmsnorm`` with XLA's autodiff instead): its own row
plan (``bwd_plan``: one warp a row where the row fits a warp at
``BWD_UNITS`` units a lane), each row's ``dx`` in registers, ``dw`` as one
fp32 partial row a block (its groups summed in group order), added by a
second launch over column tiles and row slabs in a fixed order, with its
own launch count.
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

BWD_UNITS = 8       # units a lane holds in the backward
BWD_UNITS_PER_LANE = (1, 2, 4, 8)   # the backward's instantiations
BWD_BLOCK_WARPS = 8  # warps per block of the backward
BWD_MAX_BLOCKS = 264  # two 8-warp blocks on each of the card's 132 SMs
DW_SLABS = 32       # row slabs of part a dw column is summed in, in order

launches = 0        # forward kernel launches by this process
bwd_launches = 0    # backward calls (two kernels each) by this process


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


def bwd_plan(D: int, dtype: torch.dtype) -> Plan:
    """How the backward lays a row of ``D`` elements of ``dtype`` over its
    threads: as many warps as hold the row at ``BWD_UNITS`` 16-byte units
    (or elements, for rows that are not a multiple of 16 bytes) a lane,
    so one warp a row up to 1024 f32 or 2048 bf16 elements; the smallest
    instantiated units per lane that cover it; as many row groups a block
    as ``BWD_BLOCK_WARPS`` warps hold. Like ``plan``, a function of the
    width and the dtype alone: a row's lanes and its sums' order never
    depend on the number of rows."""
    es = torch.empty((), dtype=dtype).element_size()
    vec = D * es % 16 == 0
    units = D // (16 // es) if vec else D
    wpr = max(1, -(-units // (32 * BWD_UNITS)))
    if wpr > MAX_WARPS:
        raise ValueError(f"rmsnorm backward: a row of {D} {dtype} elements "
                         f"needs {wpr} warps at {BWD_UNITS} units a lane; "
                         f"the backward takes at most {MAX_WARPS}")
    need = -(-units // (32 * wpr))
    upl = next(u for u in BWD_UNITS_PER_LANE if u >= need)
    return Plan(vec, wpr, upl, max(1, BWD_BLOCK_WARPS // wpr))


def bwd_blocks(N: int, p: Plan) -> int:
    """The backward's grid for ``N`` rows under ``p = bwd_plan(...)``: a
    row a group while the rows fit ``BWD_MAX_BLOCKS`` blocks of
    ``p.rows_per_block`` groups, then that many blocks, each group taking
    every ``blocks * rows_per_block``-th row. Each block writes one fp32
    row of ``dw`` partial sums."""
    return max(1, min(-(-N // p.rows_per_block), BWD_MAX_BLOCKS))


def _check(x, w, *more):
    """The checks of both entries; ``more`` is the backward's ``dy``,
    shaped and typed as ``x``."""
    build.check_inputs(NAME, (x, w, *more), ())
    if x.dim() != 2 or w.shape != (x.shape[1],) \
            or any(t.shape != x.shape for t in more):
        raise ValueError(f"rmsnorm: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}"
                         + "".join(f", dy {tuple(t.shape)}" for t in more)
                         + " (x and dy are [N, D], w is [D])")
    p = (bwd_plan if more else plan)(x.shape[1], x.dtype)
    build.check_device(NAME, (x, w, *more))
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


def rmsnorm_bwd_cuda(x, w, dy, eps: float = 1e-5):
    """The gradient of ``rmsnorm_cuda``. x, dy: [N, D] (f32 or bf16); w:
    [D] in x's dtype. Rows up to eight warps at ``BWD_UNITS`` units a
    lane (16384 bf16 or 8192 f32 elements 16 bytes at a time, 2048
    element by element), laid out by ``bwd_plan``. Returns (dx [N, D] in
    x's dtype, dw [D] fp32). Two kernels on the current stream, counted
    once."""
    global bwd_launches
    p = _check(x, w, dy)
    N, D = x.shape
    dx = torch.empty_like(x)
    if N == 0 or D == 0:
        return dx, torch.zeros(D, dtype=torch.float32, device=x.device)
    blocks = bwd_blocks(N, p)
    part = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    build.launch(NAME, x, w, dy, dx, part, dw, N, D, build.DTYPES[x.dtype],
                 float(eps), int(p.vec), p.warps_per_row, p.units_per_lane,
                 p.rows_per_block, blocks, entry="rmsnorm_bwd_launch")
    with build.count_lock:
        bwd_launches += 1
    return dx, dw
