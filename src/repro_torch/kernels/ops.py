"""Device dispatch of the kernels, and their counts.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref``),
a CUDA tensor to the hand-written kernel; there is no fallback from one
to the other, so a kernel that fails to build or launch raises.
Inside ``with plain_versions():`` the plain versions run on any device:
``chip_smoke.py`` compares the model's kernel path with them on the card.

``rmsnorm`` and ``ssd_scan`` carry their gradients: where an input
requires one (and grad mode is on) each runs as a
``torch.autograd.Function`` whose forward and backward are the CUDA
kernels on the card (``rmsnorm_cuda`` and ``rmsnorm_bwd_cuda``;
``ssd_scan_cuda`` and ``ssd_scan_bwd_cuda``) and the plain versions on
the CPU (``rmsnorm_ref`` and ``rmsnorm_bwd_ref``; ``ssd_scan_ref`` and
``ssd_scan_bwd_ref``); otherwise it is the plain forward call. The
attention kernels have no backward: on the kernel route they raise where
an input requires a gradient, rather than hand back a result with no
``grad_fn``, which would drop the gradient without an error. Their plain
versions are PyTorch ops and differentiate as such.

DTensors (the sharded steps of ``distributed/sharding.py``) take the
plain versions only: on the kernel route a DTensor raises, naming the op,
and is never handed to a kernel's wrapper; the kernels on each rank's
local shards wait for a card per rank. The plain versions run on
DTensors as DTensor ops, except the scan, which runs on each rank's own
(batch, head) shards (``local_map``): it is independent per batch row
and head, and DTensor's einsum over its chunked form fails on shards.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from repro_torch.distributed.torch_api import (DTensor, Partial, Replicate,
                                               Shard, is_dtensor, local_map)

from . import build
from . import chunked_prefill_attention as _cpa
from . import paged_attention as _pa
from . import paged_attention_int8 as _pa8
from . import ref
from . import rmsnorm as _rms
from . import ssd_scan as _ssd

# each kernel's wrapper module and the name of its launch count there
_COUNTERS = {"paged_attention": (_pa, "launches"),
             "paged_attention_int8": (_pa8, "launches"),
             "chunked_prefill_attention": (_cpa, "launches"),
             "rmsnorm": (_rms, "launches"),
             "rmsnorm_bwd": (_rms, "bwd_launches"),
             "ssd_scan": (_ssd, "launches"),
             "ssd_scan_bwd": (_ssd, "bwd_launches")}
# calls of each plain version made through this module (updated under
# ``build.count_lock``, as the wrappers' launch counts are)
plain_calls: Dict[str, int] = {name: 0 for name in _COUNTERS}
_force_plain = False


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run the plain versions on every device while the block lasts."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def _plain(name: str, t: torch.Tensor) -> bool:
    """Whether ``name`` runs its plain version for the lead input ``t``
    (counted in ``plain_calls``); False means its kernel. Raises for a
    DTensor on the kernel route and for a device without either."""
    device = t.device
    if _force_plain or device.type == "cpu":
        with build.count_lock:
            plain_calls[name] += 1
        return True
    _no_dtensor(name, t)
    if device.type == "cuda":
        return False
    raise ValueError(f"{name}: no implementation for device {device}")


def _no_dtensor(name: str, t: torch.Tensor) -> None:
    """Raise where a DTensor would take a kernel route."""
    if is_dtensor(t) and not (_force_plain or t.device.type == "cpu"):
        raise NotImplementedError(
            f"{name}: a DTensor on the CUDA kernel route; the kernels run "
            f"on plain tensors only (one card, or each rank's local "
            f"shards), and a sharded program runs the plain versions "
            f"(on the CPU, or inside kernels.ops.plain_versions())")


def _no_backward(name: str, *tensors) -> None:
    """On the kernel route of a kernel without a backward: raise where
    grad mode is on and an input requires a gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward kernel, and an input "
            f"requires a gradient, which its output would drop; run it "
            f"under torch.no_grad(), or through its plain version (on the "
            f"CPU, or inside kernels.ops.plain_versions())")


def paged_attention(q, k_pages, v_pages, block_table, lens, *,
                    k_scales=None, v_scales=None):
    """q: [B, H, D]; k_pages/v_pages: [P, page, KV, D] in q's dtype, or
    int8 with ``k_scales``/``v_scales`` [P, page, KV] bf16 (the
    fused-dequant variant, a kernel of its own on the card);
    block_table: [B, n_pages] int32 (-1 = unused); lens: [B] int32.
    Returns [B, H, D] in q's dtype."""
    if k_scales is not None:
        if _plain("paged_attention_int8", q):
            return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                           lens, k_scales, v_scales)
        _no_backward("paged_attention_int8", q, k_scales, v_scales)
        return _pa8.paged_attention_int8_cuda(q, k_pages, v_pages, k_scales,
                                              v_scales, block_table, lens)
    if _plain("paged_attention", q):
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                       lens)
    _no_backward("paged_attention", q, k_pages, v_pages)
    return _pa.paged_attention_cuda(q, k_pages, v_pages, block_table, lens)


def chunked_prefill_attention(q, k, v, *, q_offset: int = 0,
                              kv_len=None, window=None, q_offsets=None,
                              kv_lens=None):
    """q: [B, C, H, D]; k, v: [B, S, KV, D] (cache, chunk already
    written). Returns [B, C, H, D].

    As in the JAX package, two modes: static, with one ``q_offset`` /
    ``kv_len`` (default ``S``) for every row, and dynamic, with per-row
    ``q_offsets`` / ``kv_lens`` ([B] int32), which then take precedence."""
    if q_offsets is None:
        B, S = q.shape[0], k.shape[1]
        q_offsets = torch.full((B,), q_offset, dtype=torch.int32,
                               device=q.device)
        kv_lens = torch.full((B,), S if kv_len is None else kv_len,
                             dtype=torch.int32, device=q.device)
    if _plain("chunked_prefill_attention", q):
        return ref.chunked_prefill_attention_ref(q, k, v, q_offsets,
                                                 kv_lens, window=window)
    _no_backward("chunked_prefill_attention", q, k, v)
    return _cpa.chunked_prefill_attention_cuda(q, k, v, q_offsets, kv_lens,
                                               window=window)


def rmsnorm(x, w, eps: float = 1e-5):
    """x: [..., D]; w: [D] in x's dtype. Returns ``x``'s shape and dtype;
    differentiable in ``x`` and ``w`` (``_RMSNorm``)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm(x, w, eps)


def _rmsnorm(x, w, eps: float):
    if _plain("rmsnorm", x):
        return ref.rmsnorm_ref(x, w, eps)
    shape = x.shape
    out = _rms.rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                            w.contiguous(), eps)
    return out.reshape(shape)


def rmsnorm_bwd(x, w, dy, eps: float = 1e-5):
    """The gradient of ``rmsnorm`` at ``x`` for the output gradient
    ``dy`` (``x``'s shape and dtype): (dx in x's dtype, dw [D] fp32)."""
    if _plain("rmsnorm_bwd", x):
        return ref.rmsnorm_bwd_ref(x, w, dy, eps)
    D = x.shape[-1]
    dx, dw = _rms.rmsnorm_bwd_cuda(x.reshape(-1, D).contiguous(),
                                   w.contiguous(),
                                   dy.reshape(-1, D).contiguous(), eps)
    return dx.reshape(x.shape), dw


class _RMSNorm(torch.autograd.Function):
    """``rmsnorm`` with its gradient: forward and backward each through
    ``kernels.ops``, so the kernels on the card and the plain versions on
    the CPU or inside ``plain_versions()``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw.to(w.dtype), None


def ssd_scan(x, dt, A, B_, C_, init_state, *, chunk: int):
    """x: [Bt, S, nh, hd]; dt: [Bt, S, nh] f32; A: [nh] f32; B_, C_:
    [Bt, S, ds]; init_state: [Bt, nh, hd, ds] f32. Any ``S``: the plain
    version zero-pads to the chunk grid, the kernel reads the last chunk's
    tail as dt = 0 in place. Returns (y [Bt, S, nh, hd] f32, final state
    [Bt, nh, hd, ds] f32); differentiable in every input (``_SSDScan``),
    the mixer's strided slices of its projection included. DTensor
    inputs scan each rank's own shards (``_scan_shards``)."""
    if is_dtensor(x):
        return _scan_shards(x, dt, A, B_, C_, init_state, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_, C_, init_state)):
        return _SSDScan.apply(x, dt, A, B_, C_, init_state, chunk)
    return _ssd_scan(x, dt, A, B_, C_, init_state, chunk)


# per ssd_scan input and output: its dim that holds x's batch dim (0) and
# head dim (2), where it has one; a mesh axis that shards x on either
# shards each of these on that dim and replicates the rest
_SCAN_DIMS = {"x": {0: 0, 2: 2}, "dt": {0: 0, 2: 2}, "A": {2: 0},
              "B": {0: 0}, "C": {0: 0}, "h0": {0: 0, 2: 1}}


def _scan_shards(x, dt, A, B_, C_, init_state, chunk: int):
    """``ssd_scan`` over DTensors, each rank scanning its (batch, head)
    shards with the plain version through ``local_map`` (a kernel on a
    kernel route raises). A mesh axis that shards x on another dim is
    gathered first; the outputs take x's batch and head placements. The
    scan is independent per batch row and head, so the result is the
    unsharded scan's, with no collective but those gathers."""
    _no_dtensor("ssd_scan", x)
    mesh = x.device_mesh
    split = [p.dim if isinstance(p, Shard) and p.dim in (0, 2) else None
             for p in x.placements]

    def pl(which, grad=False):
        # an input whole on an axis that splits x on a dim it lacks (A
        # over the batch, B and C over the heads) gets the sum of each
        # rank's part as its gradient
        dims = _SCAN_DIMS[which]
        return tuple(Replicate() if d is None else
                     Shard(dims[d]) if d in dims else
                     Partial() if grad else Replicate() for d in split)

    names = ("x", "dt", "A", "B", "C", "h0")
    fn = local_map(
        lambda *a: ssd_scan(*a, chunk=chunk),
        out_placements=(pl("x"), pl("h0")),
        in_placements=tuple(pl(n) for n in names),
        in_grad_placements=tuple(pl(n, grad=True) for n in names),
        device_mesh=mesh, redistribute_inputs=True)
    rep = (Replicate(),) * mesh.ndim    # a plain input (a fresh state)
    return fn(*(t if is_dtensor(t) else
                DTensor.from_local(t, mesh, rep, run_check=False)
                for t in (x, dt, A, B_, C_, init_state)))


def _ssd_scan(x, dt, A, B_, C_, init_state, chunk: int):
    if _plain("ssd_scan", x):
        return ref.ssd_scan_ref(x, dt, A, B_, C_, init_state, chunk)
    return _ssd.ssd_scan_cuda(x, dt, A, B_, C_, init_state, chunk)


def ssd_scan_bwd(x, dt, A, B_, C_, init_state, dy, dh, *, chunk: int):
    """The gradient of ``ssd_scan`` at its inputs for the output
    gradients ``dy`` ([Bt, S, nh, hd]) and ``dh`` ([Bt, nh, hd, ds]):
    (dx, ddt, dA, dB, dC, dh0), each its input's shape, dx, dB and dC in
    their input's dtype, the rest fp32."""
    if _plain("ssd_scan_bwd", x):
        return ref.ssd_scan_bwd_ref(x, dt, A, B_, C_, init_state, dy, dh,
                                    chunk)
    return _ssd.ssd_scan_bwd_cuda(x, dt, A, B_, C_, init_state, dy, dh,
                                  chunk)


class _SSDScan(torch.autograd.Function):
    """``ssd_scan`` with its gradient: forward and backward each through
    ``kernels.ops``. It saves the inputs, not the chunk states: the
    backward recomputes the state entering each chunk."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, init_state, chunk):
        ctx.save_for_backward(x, dt, A, B_, C_, init_state)
        ctx.chunk = chunk
        return _ssd_scan(x, dt, A, B_, C_, init_state, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy, dh, chunk=ctx.chunk),
                None)


def reset_counts() -> None:
    """Zero every kernel's launch count and every plain-call count, and
    forget the attention kernels' variants and head layouts."""
    with build.count_lock:
        for name, (mod, attr) in _COUNTERS.items():
            setattr(mod, attr, 0)
            plain_calls[name] = 0
        for mod in (_pa, _pa8, _cpa):
            mod.variants.clear()
            mod.heads.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "plain": m}}`` since the last reset
    (``rmsnorm_bwd``: the norm's backward, two kernels a call;
    ``ssd_scan_bwd``: the scan's backward, six kernels a call)."""
    with build.count_lock:
        return {name: {"launches": getattr(mod, attr),
                       "plain": plain_calls[name]}
                for name, (mod, attr) in _COUNTERS.items()}


def variants() -> Dict[str, Dict]:
    """The launches of each attention kernel since the last reset, by
    variant: ``(head_dim, page)`` for decode, ``(head_dim, window)`` for
    prefill."""
    with build.count_lock:
        return {name: dict(mod.variants) for name, mod in
                (("paged_attention", _pa), ("paged_attention_int8", _pa8),
                 ("chunked_prefill_attention", _cpa))}


def heads() -> Dict[str, Dict]:
    """The launches of each attention kernel since the last reset, by
    the ``(H, KV)`` of its query and its pages: a tensor-parallel rank
    launches at its local head counts."""
    with build.count_lock:
        return {name: dict(mod.heads) for name, mod in
                (("paged_attention", _pa), ("paged_attention_int8", _pa8),
                 ("chunked_prefill_attention", _cpa))}
