"""Mamba2 chunked SSD scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan``. A
first CUDA kernel writes each chunk's C.B^T to a scratch buffer; then one
block per (row, head, slice of 16 head-dim columns) walks the row's
chunks in order, carrying its slice of the fp32 state in shared memory.
See the source's note for the design and its bound.

Where the Pallas wrapper asserts ``S % chunk == 0``, this one zero-pads
``S`` to the chunk grid as ``models/mamba2.py::ssd_chunked`` does (a
zero ``dt`` leaves the state unchanged), and returns the first ``S``
rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

NAME = "ssd_scan"
TILE = 64           # chunk rows per tile: the chunk is a multiple of it
MAX_CHUNK = 1024    # the chunk's decays and dt live in shared memory
HD_SLICE = 16       # head-dim columns per block
STATE_DIMS = (64, 128)

launches = 0    # kernel launches by this process


def _check(x, dt, A, B_, C_, h0, chunk):
    build.check_inputs(NAME, (x, B_, C_), ())
    build.check_inputs(NAME, (dt, A, h0), ())
    if dt.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt, A and the state are float32, got "
                        f"{dt.dtype}")
    Bt, S, nh, hd = x.shape
    ds = B_.shape[-1]
    if dt.shape != (Bt, S, nh) or A.shape != (nh,) \
            or B_.shape != (Bt, S, ds) or C_.shape != B_.shape \
            or h0.shape != (Bt, nh, hd, ds):
        raise ValueError(
            f"ssd_scan: unsupported shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
            f"{tuple(B_.shape)}/{tuple(C_.shape)}, state {tuple(h0.shape)}")
    if chunk % TILE or not 0 < chunk <= MAX_CHUNK or hd % HD_SLICE \
            or ds not in STATE_DIMS:
        raise ValueError(
            f"ssd_scan: chunk {chunk} must be a multiple of {TILE} up to "
            f"{MAX_CHUNK}, head_dim {hd} a multiple of {HD_SLICE}, d_state "
            f"{ds} one of {STATE_DIMS}")
    build.check_device(NAME, (x, dt, A, B_, C_, h0))


def ssd_scan_cuda(x, dt, A, B_, C_, init_state, chunk: int):
    """x: [Bt, S, nh, hd] and B_, C_: [Bt, S, ds] in f32 or bf16; dt:
    [Bt, S, nh], A: [nh] and init_state: [Bt, nh, hd, ds] in f32.
    Returns (y [Bt, S, nh, hd] f32, final state [Bt, nh, hd, ds] f32).
    Launches on the current stream."""
    global launches
    Bt, S = x.shape[:2]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    x, dt, A, B_, C_, h0 = (t.contiguous()
                            for t in (x, dt, A, B_, C_, init_state))
    _check(x, dt, A, B_, C_, h0, chunk)
    _, Sp, nh, hd = x.shape
    ds = B_.shape[-1]
    y = torch.empty((Bt, Sp, nh, hd), dtype=torch.float32, device=x.device)
    h = torch.empty_like(h0)
    if Bt == 0 or Sp == 0:
        return y[:, :S], h0.clone()
    # C.B^T of every chunk, which the first of the two kernels writes
    cb = torch.empty((Bt, Sp // chunk, chunk, chunk), dtype=torch.float32,
                     device=x.device)
    build.launch(NAME, x, dt, A, B_, C_, h0, y, h, cb, Bt, Sp, nh, hd, ds,
                 chunk, build.DTYPES[x.dtype])
    launches += 1
    return y[:, :S], h
