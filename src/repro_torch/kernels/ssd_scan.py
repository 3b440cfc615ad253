"""Mamba2 chunked SSD scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan``. One
call runs three kernels on the current stream and counts once: the
chunk states (one block per chunk, head and 64 x 64 tile of the state),
the pass that carries the state through the chunks, and the chunk
outputs (one block per 128-row tile of a chunk, head and 64 head-dim
columns), with every product on the tensor cores. See the source's note
for the design and its bound.

Any ``S``: the kernels treat the rows of the last chunk past ``S`` as
``dt = 0`` (the state unchanged) and skip the tiles wholly past it, so
nothing is padded here. ``x``, ``B`` and ``C`` may be strided views, as
the mixer's slices of its ``xBC`` projection are: the kernels take their
batch and token strides, and only a layout they cannot read (inner
dimensions not contiguous, strides not a multiple of 16 bytes) is copied
with ``.contiguous()``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import build

NAME = "ssd_scan"
TILE = 64           # chunk rows, head-dim and state columns per tile
ROWS = 128          # chunk rows per block of the output kernel
MAX_CHUNK = 1024    # the chunk's dt and decays live in shared memory
HD_MULTIPLE = 16    # head_dim: whole 16-column mma blocks
STATE_DIMS = (16, 64, 128)
PASS_THREADS = 256  # threads per block of the state pass, 4 entries each

launches = 0    # calls that launched the kernels, in this process


def plan(Bt: int, S: int, chunk: int, nh: int, hd: int,
         ds: int) -> Dict[str, Tuple[int, ...]]:
    """The grids of the three kernels and the shapes of the scratch the
    wrapper allocates, as ``csrc/ssd_scan.cu``'s ``launch`` computes
    them: each chunk's state (fp32), each chunk's decay (fp32) and the
    state entering each chunk split into bf16 hi and lo. ``Bt`` enters
    only as the batch axis of each grid and scratch: the blocks of one
    row, and so every sum's order, do not depend on it."""
    nc = -(-S // chunk)
    n_dt = -(-hd // TILE)
    n_st = ds // min(ds, TILE)
    return {
        "chunks": (nc,),
        "state_grid": (nc * n_dt * n_st, nh, Bt),
        "pass_grid": (-(-(hd * ds) // (4 * PASS_THREADS)), nh, Bt),
        "scan_grid": (nh * nc, Bt * n_dt, -(-chunk // ROWS)),
        "states": (Bt, nc, nh, hd, ds),
        "decay": (Bt, nc, nh),
        "hin": (Bt, nc, nh, 2, hd, ds),
    }


def _strided(t: torch.Tensor, inner: int) -> torch.Tensor:
    """``t`` as the kernels read it: its last ``inner`` dimensions
    contiguous and its batch and token strides multiples of 16 bytes
    from a 16-byte-aligned start; otherwise a contiguous copy."""
    want = 1
    ok = True
    for dim in range(t.dim() - 1, t.dim() - 1 - inner, -1):
        ok &= t.shape[dim] == 1 or t.stride(dim) == want
        want *= t.shape[dim]
    es = t.element_size()
    ok &= all(s * es % 16 == 0 for s in t.stride()[:2]) \
        and t.data_ptr() % 16 == 0
    return t if ok else t.contiguous()


def _check(x, dt, A, B_, C_, h0, chunk):
    dts = {x.dtype, B_.dtype, C_.dtype}
    if len(dts) != 1 or x.dtype not in build.DTYPES:
        raise TypeError(f"ssd_scan: x, B and C must share a dtype of "
                        f"{list(build.DTYPES)}, got {x.dtype}, {B_.dtype}, "
                        f"{C_.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, h0)):
        raise TypeError(f"ssd_scan: dt, A and the state are float32, got "
                        f"{dt.dtype}, {A.dtype}, {h0.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x is [Bt, S, nh, hd], got "
                         f"{tuple(x.shape)}")
    Bt, S, nh, hd = x.shape
    ds = B_.shape[-1]
    if dt.shape != (Bt, S, nh) or A.shape != (nh,) \
            or B_.shape != (Bt, S, ds) or C_.shape != B_.shape \
            or h0.shape != (Bt, nh, hd, ds):
        raise ValueError(
            f"ssd_scan: unsupported shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
            f"{tuple(B_.shape)}/{tuple(C_.shape)}, state {tuple(h0.shape)}")
    if chunk % TILE or not 0 < chunk <= MAX_CHUNK or hd % HD_MULTIPLE \
            or ds not in STATE_DIMS:
        raise ValueError(
            f"ssd_scan: chunk {chunk} must be a multiple of {TILE} up to "
            f"{MAX_CHUNK}, head_dim {hd} a multiple of {HD_MULTIPLE}, "
            f"d_state {ds} one of {STATE_DIMS}")
    if any(t.data_ptr() % 16 for t in (dt, A, h0)):
        raise ValueError("ssd_scan: dt, A and the state must be 16-byte "
                         "aligned (the kernels load 16 bytes at a time)")
    build.check_device(NAME, (x, dt, A, B_, C_, h0))


def ssd_scan_cuda(x, dt, A, B_, C_, init_state, chunk: int):
    """x: [Bt, S, nh, hd] and B_, C_: [Bt, S, ds] in f32 or bf16, strided
    views allowed; dt: [Bt, S, nh], A: [nh] and init_state:
    [Bt, nh, hd, ds] in f32. Any ``S``. Returns (y [Bt, S, nh, hd] f32,
    final state [Bt, nh, hd, ds] f32). Launches on the current stream."""
    global launches
    dt, A, h0 = (t.contiguous() for t in (dt, A, init_state))
    x = _strided(x, 2)
    B_, C_ = _strided(B_, 1), _strided(C_, 1)
    if B_.stride() != C_.stride():
        B_, C_ = B_.contiguous(), C_.contiguous()
    _check(x, dt, A, B_, C_, h0, chunk)
    Bt, S, nh, hd = x.shape
    ds = B_.shape[-1]
    y = torch.empty((Bt, S, nh, hd), dtype=torch.float32, device=x.device)
    if Bt == 0 or S == 0:
        return y, h0.clone()
    p = plan(Bt, S, chunk, nh, hd, ds)
    states = torch.empty(p["states"], dtype=torch.float32, device=x.device)
    decay = torch.empty(p["decay"], dtype=torch.float32, device=x.device)
    hin = torch.empty(p["hin"], dtype=torch.bfloat16, device=x.device)
    h = torch.empty_like(h0)
    build.launch(NAME, x, dt, A, B_, C_, h0, y, h, states, decay, hin, Bt, S,
                 nh, hd, ds, chunk, build.Long(x.stride(0)),
                 build.Long(x.stride(1)), build.Long(B_.stride(0)),
                 build.Long(B_.stride(1)), build.DTYPES[x.dtype])
    with build.count_lock:
        launches += 1
    return y, h
