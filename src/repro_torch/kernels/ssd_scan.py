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

Its gradient, ``ssd_scan_bwd_cuda``, wraps ``csrc/ssd_scan_bwd.cu``
(the JAX package's training path differentiates
``models/mamba2.py::ssd_chunked`` with XLA's autodiff instead): six
kernels, counted once in ``bwd_launches``, every product on the tensor
cores: each chunk's state and the state gradient's chunk term, the state
carried forward and its gradient back through the chunks in fp32, dx and
dcum's shares (C.B^T once for a group of heads), dB and dC (Q summed over
a group of heads before its products; one partial a group), then dcum's
reverse cumsum into ddt and dA, and the groups' partials summed in a
fixed order. It takes what the forward takes, with head_dim up to
``BWD_MAX_HD``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import build

NAME = "ssd_scan"
BWD_NAME = "ssd_scan_bwd"
TILE = 64           # chunk rows, head-dim and state columns per tile
ROWS = 128          # chunk rows per block of the output kernel
MAX_CHUNK = 1024    # the chunk's dt and decays live in shared memory
HD_MULTIPLE = 16    # head_dim: whole 16-column mma blocks
STATE_DIMS = (16, 64, 128)
PASS_THREADS = 256  # threads per block of the state pass, 4 entries each
PASS_THREADS_BWD = 256  # threads per block of the backward's state pass
BWD_MAX_HD = 128    # a dx block holds its group's columns, 128 at most
DX_COLS = 128       # a dx block's columns: heads x head_dim
DBDC_COLS = 256     # a dB / dC block's columns
MAX_GROUP = 4       # heads a group at most

launches = 0        # calls that launched the forward's kernels
bwd_launches = 0    # calls that launched the backward's kernels


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


def heads_per_group(cols: int, hd: int) -> int:
    """The heads of a backward block: as many as fill ``cols`` columns
    of head_dim ``hd``, at most ``MAX_GROUP``."""
    return min(MAX_GROUP, cols // hd)


def plan_bwd(Bt: int, S: int, chunk: int, nh: int, hd: int,
             ds: int) -> Dict[str, Tuple[int, ...]]:
    """The grids of the backward's six kernels and the shapes of its
    scratch, as ``csrc/ssd_scan_bwd.cu``'s ``launch_bwd`` computes them:
    each chunk's state (then the state entering it) and the state
    gradient's chunk term (then the gradient of the state leaving it),
    fp32; each chunk's decay; dcum's shares (fp64: per head, one slot a
    64-row tile for its row part, then its column part and the state
    update's share) and ddt's direct part; the dB and dC partials of each
    group of ``groups[1]`` heads; each (row, chunk, head)'s share of dA.
    ``groups`` is the heads of a dx block and of a dB / dC block. As in
    ``plan``, ``Bt`` enters only as the batch axis of the per-row grids
    and scratch."""
    nc = -(-S // chunk)
    nt = chunk // TILE
    g3, g4 = heads_per_group(DX_COLS, hd), heads_per_group(DBDC_COLS, hd)
    ng4 = -(-nh // g4)
    return {
        "chunks": (nc,),
        "groups": (g3, g4),
        "state_grid": (nc * -(-hd // TILE) * (ds // min(ds, TILE)), nh, Bt),
        "pass_grid": (-(-(hd * ds) // PASS_THREADS_BWD), nh, Bt),
        "chunk_grid": (nc, -(-nh // g3), nt * Bt),
        "dbdc_grid": (2 * nc, ng4, nt * Bt),
        "dcum_grid": (nc, nh, Bt),
        "reduce_grid": (-(-(2 * Bt * S * ds + nh) // PASS_THREADS_BWD),),
        "states": (Bt, nc, nh, hd, ds),
        "dstates": (Bt, nc, nh, hd, ds),
        "decay": (Bt, nc, nh),
        "dsum": (Bt, nc, nh, nt + 2, chunk),
        "ddt_direct": (Bt, nc, nh, chunk),
        "group_partials": (Bt, ng4, S, ds),
        "da_partials": (Bt, nc, nh),
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


def _check(x, dt, A, B_, C_, h0, chunk, grads=()):
    """The forward's rules; ``grads`` is the backward's (dy, dh), fp32,
    shaped as y and the state, and the backward takes head_dim up to
    ``BWD_MAX_HD``."""
    dts = {x.dtype, B_.dtype, C_.dtype}
    if len(dts) != 1 or x.dtype not in build.DTYPES:
        raise TypeError(f"ssd_scan: x, B and C must share a dtype of "
                        f"{list(build.DTYPES)}, got {x.dtype}, {B_.dtype}, "
                        f"{C_.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, h0, *grads)):
        raise TypeError(f"ssd_scan: dt, A, the state and the output "
                        f"gradients are float32, got "
                        f"{[t.dtype for t in (dt, A, h0, *grads)]}")
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
    if grads:
        dy, dh = grads
        if dy.shape != x.shape or dh.shape != h0.shape:
            raise ValueError(f"ssd_scan backward: unsupported shapes dy "
                             f"{tuple(dy.shape)}, dh {tuple(dh.shape)} (y "
                             f"is {tuple(x.shape)}, the state "
                             f"{tuple(h0.shape)})")
        if hd > BWD_MAX_HD:
            raise ValueError(f"ssd_scan backward: head_dim {hd} is past "
                             f"{BWD_MAX_HD}")
    if any(t.data_ptr() % 16 for t in (dt, A, h0)):
        raise ValueError("ssd_scan: dt, A and the state must be 16-byte "
                         "aligned (the kernels load 16 bytes at a time)")
    build.check_device(BWD_NAME if grads else NAME,
                       (x, dt, A, B_, C_, h0, *grads))


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


def ssd_scan_bwd_cuda(x, dt, A, B_, C_, init_state, dy, dh, chunk: int):
    """The gradient of ``ssd_scan_cuda`` for the output gradients ``dy``
    ([Bt, S, nh, hd]) and ``dh`` ([Bt, nh, hd, ds]), both f32. Takes the
    forward's inputs as it does, head_dim up to ``BWD_MAX_HD``. Returns
    (dx [Bt, S, nh, hd] in x's dtype, ddt [Bt, S, nh] f32, dA [nh] f32, dB
    and dC [Bt, S, ds] in their dtype, dh0 [Bt, nh, hd, ds] f32). Six
    kernels on the current stream, counted once."""
    global bwd_launches
    dt, A, h0, dy, dh = (t.contiguous() for t in (dt, A, init_state, dy, dh))
    x = _strided(x, 2)
    B_, C_ = _strided(B_, 1), _strided(C_, 1)
    if B_.stride() != C_.stride():
        B_, C_ = B_.contiguous(), C_.contiguous()
    _check(x, dt, A, B_, C_, h0, chunk, (dy, dh))
    Bt, S, nh, hd = x.shape
    ds = B_.shape[-1]
    dev = x.device
    dx = torch.empty((Bt, S, nh, hd), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bt, S, nh), dtype=torch.float32, device=dev)
    dB = torch.empty((Bt, S, ds), dtype=B_.dtype, device=dev)
    dC = torch.empty_like(dB)
    if Bt == 0 or S == 0:
        return (dx, ddt, torch.zeros_like(A), dB, dC, dh.clone())
    p = plan_bwd(Bt, S, chunk, nh, hd, ds)
    f32 = dict(dtype=torch.float32, device=dev)
    states = torch.empty(p["states"], **f32)
    dstates = torch.empty(p["dstates"], **f32)
    decay = torch.empty(p["decay"], **f32)
    dsum = torch.empty(p["dsum"], dtype=torch.float64, device=dev)
    ddv = torch.empty(p["ddt_direct"], **f32)
    dBg = torch.empty(p["group_partials"], **f32)
    dCg = torch.empty(p["group_partials"], **f32)
    da_part = torch.empty(p["da_partials"], **f32)
    dA = torch.empty_like(A)
    dh0 = torch.empty_like(h0)
    build.launch(BWD_NAME, x, dt, A, B_, C_, h0, dy, dh, dx, ddt, dA, dB,
                 dC, dh0, states, dstates, decay, dsum, ddv, dBg, dCg,
                 da_part, Bt, S, nh, hd, ds, chunk, build.Long(x.stride(0)),
                 build.Long(x.stride(1)), build.Long(B_.stride(0)),
                 build.Long(B_.stride(1)), build.DTYPES[x.dtype])
    with build.count_lock:
        bwd_launches += 1
    return dx, ddt, dA, dB, dC, dh0
