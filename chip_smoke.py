"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. build: compile every CUDA kernel of ``src/repro_torch/csrc`` with
   nvcc, one process per source, all started at once;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes, in f32 (TF32 off in matmuls and cuDNN) and
   bf16, with its time, the plain version's, one library call's where
   one computes the same function (``F.scaled_dot_product_attention``
   over the same data gathered to a dense view; ``F.rms_norm`` with
   weight ``1 + w``; none for ``ssd_scan``), and the least time the card
   could take;
3. serve: ``repro_torch.launch.serve.main`` serves full-width
   llama3.2-3b and then full-width mamba2-370m (random weights from a
   seed, bf16) through the NiyamaScheduler priced on the H100 spec; every
   request must finish with all its tokens, every kernel of each path
   must have launched in that path's run (counts zeroed just before it),
   and no plain version may have run;
4. profile: one decode and one prefill iteration of each served engine,
   timed on the host and traced with torch.profiler (device time by
   kernel, idle share);
5. parity: full-width 2-layer f32 copies of both families run one mixed
   iteration through the kernels and through the plain versions; the
   final hidden states and the written pages or state rows agree within
   the limits stated there and the sampled ids are equal.

Prints the card's name and power limit, one JSON line of the kernels and,
as its last line, ``{"ok": true, "device": {...}}``. Exits non-zero
without a result where torch sees no CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
              torch.bfloat16: 989e12}  # dense bf16 tensor cores
# Each element of a kernel's output must lie within ATOL + RTOL * |plain|
# of its plain version's, and within CAP. f32 (TF32 off): the summation
# order differs, nothing else. bf16: both accumulate in fp32 and round
# the output once, so they differ by at most one bf16 ulp, 2^-7 of the
# value.
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0, cap=1e-4),
       torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7, cap=2e-2)}
# rmsnorm, from the first readings on an H100 (PERF.md): f32 differs by at
# most 2 ulps (9.5e-7 at values up to 5.5), held to 8 ulps (2^-20
# relative) plus 1e-6; bf16 by one bf16 ulp, as above.
RMSNORM_TOL = {torch.float32: dict(atol=1e-6, rtol=2 ** -20, cap=1e-4),
               torch.bfloat16: TOL[torch.bfloat16]}
# ssd_scan, y and the final state: both versions compute in fp32 in either
# input dtype, but sum the chunk's cumulative decay in different orders;
# at |cum| ~ 1e3 one ulp of cum_i - cum_j is ~1e-4, so an element is held
# to SSD_REL of its output's largest magnitude (first readings: at most
# 1.8e-4 of it, in the 2 x 700-token case below).
SSD_REL = 5e-4
# the final hidden states of the 2-layer mamba2-370m parity check
MAMBA_PARITY_HIDDEN = 1e-4
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:78"),
    "chunked_prefill_attention": (
        "src/repro_torch/csrc/chunked_prefill_attention.cu",
        "src/repro/kernels/chunked_prefill_attention.py:90"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:70"),
}
# the kernels each served family's path runs
PATHS = {"llama3.2-3b": ("paged_attention", "chunked_prefill_attention",
                         "rmsnorm"),
         "mamba2-370m": ("rmsnorm", "ssd_scan")}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------- timing

_flush_buf = None
SPIN_MS = 5.0           # device time queued ahead of each timed call
_cycles_per_ms = None


def _spin(ms: float) -> None:
    """Keep the device busy for about ``ms`` ms: while it spins, the host
    queues the timed call's launches, so the events that bracket the call
    read device time only, not the host's time to issue the launches."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(10 ** 6)
        e1.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 10 ** 6 / e0.elapsed_time(e1)
    torch.cuda._sleep(int(_cycles_per_ms * ms))


def _flush_l2() -> None:
    """Overwrite a buffer four times the 50 MB L2, so the next launch
    finds its inputs in device memory, as a layer of the model does."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(200 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
    _flush_buf.zero_()


def time_ms(fn, reps: int = 20, warmup: int = 3,
            spin_ms: float = SPIN_MS) -> float:
    """Median device time of one call of ``fn``, cold L2, CUDA events,
    with the call queued behind a spin (``_spin``) of ``spin_ms`` (longer
    for a plain version of many launches). Fails if the host took longer
    than the spin to queue the call, as it would if ``fn`` waited on the
    device."""
    for _ in range(warmup):
        fn()
    # the spin's calibration and the flush buffer's allocation wait on the
    # device: do them once here, not inside a timed call's issue window
    _spin(spin_ms)
    _flush_l2()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _spin(spin_ms)
        _flush_l2()
        e0.record()
        fn()
        e1.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        check(issue_ms < spin_ms, f"timing: the host took {issue_ms:.2f} ms "
              f"to queue one call, longer than the {spin_ms} ms spin")
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1

def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    secs = time.perf_counter() - t0
    print(f"[build] {built or 'nothing (libraries current)'} in "
          f"{secs:.1f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return secs


# ---------------------------------------------------------------- phase 2

def _paged_case(rng, dtype, B, H, KV, D, page, n_pages, lens, holes):
    """Decode inputs: ragged ``lens``; ``holes`` lists (row, page index)
    table entries set to -1 (a row of all -1 is an inactive slot)."""
    P = B * n_pages + 3
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, page, KV, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, KV, D), np.float32))
    bt = np.full((B, n_pages), -1, np.int32)
    perm = rng.permutation(P)
    for b in range(B):
        n = -(-lens[b] // page)
        bt[b, :n] = perm[b * n_pages:b * n_pages + n]
    for b, pi in holes:
        bt[b, pi] = -1
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _paged_work(q, kp, bt, lens):
    """Bytes and flops of the live work: the K/V rows of pages in the
    table below each row's length, q, the output, the table and lens."""
    B, H, D = q.shape
    page, KV = kp.shape[1], kp.shape[2]
    es = q.element_size()
    bt_h, lens_h = bt.cpu().numpy(), lens.cpu().numpy()
    live = 0
    for b in range(B):
        for pi in range(bt_h.shape[1]):
            if bt_h[b, pi] >= 0:
                live += max(0, min(page, lens_h[b] - pi * page))
    nbytes = 2 * live * KV * D * es + 2 * B * H * D * es \
        + bt.numel() * 4 + B * 4
    return nbytes, 4.0 * live * H * D


def _gathered(k_pages, v_pages, bt, lens, H):
    """The pages of each row as a dense [B, H, n*page, D] view (kv heads
    repeated to H) and the visibility mask, for the SDPA yardstick."""
    B, n = bt.shape
    page, KV, D = k_pages.shape[1:]
    idx = bt.clamp_min(0).long()
    G = H // KV

    def dense(p):
        x = p[idx].reshape(B, n * page, KV, D).transpose(1, 2)
        return x.repeat_interleave(G, dim=1).contiguous()
    pos = torch.arange(n * page, device=bt.device)
    mask = (pos[None] < lens[:, None]) \
        & (bt >= 0).repeat_interleave(page, dim=1)
    return dense(k_pages), dense(v_pages), mask[:, None, None, :]


def _prefill_case(rng, dtype, B, C, H, KV, D, S, offs, reals):
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, C, H, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, D), np.float32))
    kv_lens = [o + r if r else 0 for o, r in zip(offs, reals)]
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.tensor(offs, dtype=torch.int32, device=dev),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev))


def _prefill_mask(C, S, q_offsets, kv_lens, window=None):
    qpos = q_offsets.long()[:, None] + torch.arange(C, device="cuda")
    kpos = torch.arange(S, device="cuda")
    mask = (kpos[None, None] <= qpos[:, :, None]) \
        & (kpos[None, None] < kv_lens.long()[:, None, None])
    if window is not None:
        mask &= qpos[:, :, None] - kpos[None, None] < window
    return mask                                            # [B, C, S]


def _prefill_work(q, k, q_offsets, kv_lens, window=None):
    """Bytes and flops of the live work: visible (query, key) pairs, the
    key rows any query sees, q and the output."""
    B, C, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    mask = _prefill_mask(C, S, q_offsets, kv_lens, window)
    pairs = int(mask.sum())
    key_rows = int(mask.any(dim=1).sum())
    nbytes = 2 * key_rows * KV * D * es + 2 * B * C * H * D * es + 8 * B
    return nbytes, 4.0 * pairs * H * D


def _compare(name, label, dtype, got, want, tol=None):
    """Max |kernel - plain|; fails unless every element is within the
    limit ``tol`` (by default the attention kernels' ``TOL[dtype]``)."""
    diff = (got.float() - want.float()).abs()
    t = TOL[dtype] if tol is None else tol
    limit = (t["atol"] + t["rtol"] * want.float().abs()).clamp(max=t["cap"])
    worst = float((diff / limit).max())
    finite = bool(torch.isfinite(got.float()).all())
    err = float(diff.max())
    check(finite and worst <= 1.0,
          f"{name} [{label}]: |kernel - plain| up to {worst:.3g} times its "
          f"limit {t} (max {err:.3g}), finite={finite}")
    return err, worst


def phase_kernels() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill_attention import \
        chunked_prefill_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    head = {}

    # ---- paged decode: the engine's decode batch at full width
    lens = [2048, 1500, 1, 700, 64, 1023, 333, 900]
    for dtype, label, shape in [
            (torch.float32, "f32 B8 H24 KV8 D128", (8, 24, 8, 128)),
            (torch.bfloat16, "bf16 B8 H24 KV8 D128", (8, 24, 8, 128)),
            (torch.float32, "f32 B8 H8 KV8 D64 (G=1)", (8, 8, 8, 64)),
            (torch.float32, "f32 B8 H32 KV4 D128 (G=8)", (8, 32, 4, 128))]:
        B, H, KV, D = shape
        holes = [(2, 0)] + [(5, pi) for pi in range(32)] + [(1, 7)]
        args = _paged_case(rng, dtype, B, H, KV, D, 64, 32, lens, holes)
        got = paged_attention_cuda(*args)
        want = ref.paged_attention_ref(*args)
        torch.cuda.synchronize()
        err, worst = _compare("paged_attention", label, dtype, got, want)
        check(bool((got[5] == 0).all()),
              "paged_attention: a row whose table is all -1 must give 0")
        ms = time_ms(lambda: paged_attention_cuda(*args))
        plain = time_ms(lambda: ref.paged_attention_ref(*args))
        kd, vd, mask = _gathered(args[1], args[2], args[3], args[4], H)
        qd = args[0][:, :, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        nbytes, flops = _paged_work(args[0], args[1], args[3], args[4])
        bms, by = bound_ms(nbytes, flops, dtype)
        print(f"[kernels] paged_attention {label}: {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms "
              f"({by}), max err {err:.3g} ({worst:.2f} of the limit)")
        if label.startswith("bf16"):
            head["paged_attention"] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, max_abs_err=err)

    # ---- chunked prefill: a 4-row bucket of 512-token chunks over a
    # 16-page view, ragged offsets and one pad row
    for dtype, label, shape, offs, reals, window in [
            (torch.float32, "f32 P4 C512 H24 KV8 D128 S1024",
             (4, 512, 24, 8, 128, 1024), [0, 128, 300, 0],
             [512, 512, 77, 0], None),
            (torch.bfloat16, "bf16 P4 C512 H24 KV8 D128 S1024",
             (4, 512, 24, 8, 128, 1024), [0, 128, 300, 0],
             [512, 512, 77, 0], None),
            (torch.float32, "f32 P2 C200 H8 KV8 D64 S512 (G=1)",
             (2, 200, 8, 8, 64, 512), [37, 0], [200, 150], None),
            (torch.float32, "f32 P2 C128 H24 KV8 D128 S512 window 100",
             (2, 128, 24, 8, 128, 512), [300, 5], [128, 100], 100)]:
        B, C, H, KV, D, S = shape
        q, k, v, qo, kl = _prefill_case(rng, dtype, B, C, H, KV, D, S,
                                        offs, reals)
        got = chunked_prefill_attention_cuda(q, k, v, qo, kl, window=window)
        want = ref.chunked_prefill_attention_ref(q, k, v, qo, kl,
                                                 window=window)
        torch.cuda.synchronize()
        err, worst = _compare("chunked_prefill_attention", label, dtype,
                              got, want)
        pad = [b for b, r in enumerate(reals) if r == 0]
        check(all(bool((got[b] == 0).all()) for b in pad),
              "chunked_prefill_attention: a pad row must give 0")
        ms = time_ms(lambda: chunked_prefill_attention_cuda(
            q, k, v, qo, kl, window=window))
        plain = time_ms(lambda: ref.chunked_prefill_attention_ref(
            q, k, v, qo, kl, window=window))
        G = H // KV
        qd = q.transpose(1, 2)
        kd = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vd = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        mask = _prefill_mask(C, S, qo, kl, window)[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        nbytes, flops = _prefill_work(q, k, qo, kl, window)
        bms, by = bound_ms(nbytes, flops, dtype)
        print(f"[kernels] chunked_prefill_attention {label}: {ms:.4f} ms, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} "
              f"ms ({by}), max err {err:.3g} ({worst:.2f} of the limit)")
        if label.startswith("bf16"):
            head["chunked_prefill_attention"] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, max_abs_err=err)

    # the static mode (one offset for every row) through the same kernel
    from repro_torch.kernels import ops
    q, k, v, _, _ = _prefill_case(rng, torch.float32, 2, 96, 24, 8, 128,
                                  256, [0, 0], [1, 1])
    got = ops.chunked_prefill_attention(q, k, v, q_offset=100, kv_len=196)
    with ops.plain_versions():
        want = ops.chunked_prefill_attention(q, k, v, q_offset=100,
                                             kv_len=196)
    torch.cuda.synchronize()
    err, _ = _compare("chunked_prefill_attention", "static mode",
                      torch.float32, got, want)
    print(f"[kernels] chunked_prefill_attention static mode f32: max err "
          f"{err:.3g}")
    _kernels_rmsnorm(head)
    _kernels_ssd_scan(head)
    return head


def _label(dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def _kernels_rmsnorm(head: dict) -> None:
    """The norms of both paths: the llama decode batch [8, 3072], a
    prefill chunk of llama [1024, 3072] and of mamba2-370m [1024, 1024];
    then rows whose width is not a multiple of 16 bytes."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = [(dtype, shape) for shape in ((8, 3072), (1024, 3072),
                                          (1024, 1024))
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(torch.bfloat16, (5, 1001)), (torch.float32, (3, 77))]
    for dtype, (N, D) in cases:
        label = f"{_label(dtype)} [{N}, {D}]"
        x = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
        w = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
        got = rmsnorm_cuda(x, w, 1e-5)
        want = ref.rmsnorm_ref(x, w, 1e-5)
        torch.cuda.synchronize()
        err, worst = _compare("rmsnorm", label, dtype, got, want,
                              RMSNORM_TOL[dtype])
        ms = time_ms(lambda: rmsnorm_cuda(x, w, 1e-5))
        plain = time_ms(lambda: ref.rmsnorm_ref(x, w, 1e-5))
        w1 = 1.0 + w          # the library's weight, made outside the timing
        lib = time_ms(lambda: F.rms_norm(x, (D,), weight=w1, eps=1e-5))
        # each element read once and written once, ~4 fp32 flops each
        bms, by = bound_ms((2 * N * D + D) * x.element_size(), 4.0 * N * D,
                           torch.float32)
        print(f"[kernels] rmsnorm {label}: {ms:.4f} ms, plain {plain:.4f} "
              f"ms, F.rms_norm {lib:.4f} ms, bound {bms:.4f} ms ({by}), max "
              f"err {err:.3g} ({worst:.2f} of the limit)")
        if label == "bf16 [1024, 3072]":
            head["rmsnorm"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bms, bound_by=by,
                                   max_abs_err=err)


def _ssd_case(gen, dtype, Bt, S, nh=32, hd=64, ds=128, zero_tail=0):
    """Scan inputs at mamba2-370m's widths: x, B, C ~ N(0, 1) in
    ``dtype``; dt = softplus(N(0, 1)), the last ``zero_tail`` tokens 0
    (masked pad tokens); A = -linspace(1, 16) (the model's init); a
    random carried state."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = F.softplus(randn(Bt, S, nh))
    if zero_tail:
        dt[:, S - zero_tail:] = 0.0
    return (randn(Bt, S, nh, hd).to(dtype), dt,
            -torch.linspace(1.0, 16.0, nh, device="cuda"),
            randn(Bt, S, ds).to(dtype), randn(Bt, S, ds).to(dtype),
            randn(Bt, nh, hd, ds))


def _ssd_work(x, B, chunk):
    """Bytes (inputs read once, y and the state written once) and fp32
    flops of the chunked dual form: C.B^T and the weighted sum over the
    causal pairs of each chunk, and the state's two terms."""
    Bt, S, nh, hd = x.shape
    ds = B.shape[-1]
    n = -(-S // chunk)
    nbytes = (x.numel() + 2 * B.numel()) * x.element_size() \
        + 4 * (Bt * S * nh + nh + Bt * S * nh * hd + 2 * Bt * nh * hd * ds)
    pairs = chunk * (chunk + 1) / 2
    flops = Bt * n * (2 * pairs * (ds + nh * hd) + 4 * chunk * nh * hd * ds)
    return nbytes, flops


def _kernels_ssd_scan(head: dict) -> None:
    """Full-width prefill rows of 1024 tokens (1 and 4 rows, the chunk of
    256), then 2 rows of 700 tokens (padded to the chunk grid) whose
    last 200 tokens have dt = 0."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    chunk = 256
    cases = [(dtype, rows, 1024, 0) for rows in (1, 4)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(torch.bfloat16, 2, 700, 200)]
    for dtype, rows, S, tail in cases:
        label = f"{_label(dtype)} {rows} x {S}" \
            + (f", dt = 0 on the last {tail}" if tail else "")
        args = _ssd_case(gen, dtype, rows, S, zero_tail=tail)
        y, h = ssd_scan_cuda(*args, chunk)
        y_ref, h_ref = ref.ssd_scan_ref(*args, chunk)
        torch.cuda.synchronize()
        errs = []
        for what, got, want in (("y", y, y_ref), ("state", h, h_ref)):
            scale = float(want.abs().max())
            errs.append(_compare("ssd_scan", f"{label}, {what}", dtype, got,
                                 want, dict(atol=SSD_REL * scale, rtol=0.0,
                                            cap=float("inf")))[0])
        if tail:              # a zero-dt tail leaves the state unchanged
            _, h_cut = ref.ssd_scan_ref(*(a[:, :S - tail] if a.dim() > 1
                                          and a.shape[1] == S else a
                                          for a in args), chunk)
            _compare("ssd_scan", f"{label}, state vs the cut rows", dtype, h,
                     h_cut, dict(atol=SSD_REL * float(h_cut.abs().max()),
                                 rtol=0.0, cap=float("inf")))
        ms = time_ms(lambda: ssd_scan_cuda(*args, chunk))
        plain = time_ms(lambda: ref.ssd_scan_ref(*args, chunk), reps=10,
                        spin_ms=60.0)
        bms, by = bound_ms(*_ssd_work(args[0], args[3], chunk),
                           torch.float32)
        print(f"[kernels] ssd_scan {label}: {ms:.4f} ms, plain {plain:.4f} "
              f"ms, no library call, bound {bms:.4f} ms ({by}), max err y "
              f"{errs[0]:.3g} (of {float(y_ref.abs().max()):.3g}), state "
              f"{errs[1]:.3g} (of {float(h_ref.abs().max()):.3g})")
        if label == "bf16 1 x 1024":
            head["ssd_scan"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                    bound_ms=bms, bound_by=by,
                                    max_abs_err=errs[0])


# ---------------------------------------------------------------- phase 3

def phase_serve(arch: str) -> tuple:
    """Serve 12 requests of ``arch`` at full width with the counts zeroed
    just before; returns the counts read just after, and the engine."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    ops.reset_counts()
    t0 = time.perf_counter()
    rep = serve.main(["--arch", arch, "--device", "cuda", "--dtype", "bf16",
                      "--n-requests", "12", "--max-len", "2048",
                      "--slots", "8", "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    eng = rep.backend
    reqs = rep.all_requests()
    check(len(rep.finished) == len(reqs) == 12,
          f"serve: {len(rep.finished)}/{len(reqs)} requests finished")
    for r in reqs:
        got = len(eng.generated[r.rid])
        check(got == r.decode_len,
              f"serve: rid {r.rid} streamed {got} of {r.decode_len} tokens")
        check(all(0 <= t < eng.cfg.vocab_size for t in eng.generated[r.rid]),
              f"serve: rid {r.rid} sampled an id outside the vocabulary")
    for name in PATHS[arch]:
        check(counts[name]["launches"] > 0,
              f"serve {arch}: {name} was never launched")
    for name, c in counts.items():
        check(c["plain"] == 0,
              f"serve {arch}: the plain {name} ran {c['plain']} times")
    n_tok = sum(len(g) for g in eng.generated.values())
    n_prompt = sum(r.prompt_len for r in reqs)
    busy = rep.busy_time      # wall time inside the engine's iterations
    print(f"[serve] {arch}: {len(reqs)} requests, {rep.iterations} "
          f"iterations, "
          f"{n_prompt} prompt + {n_tok} output tokens; {wall:.2f} s wall "
          f"with the model build, {busy:.2f} s in iterations: "
          f"{n_tok / busy:.1f} output tok/s, {(n_prompt + n_tok) / busy:.1f} "
          f"tok/s; launches {counts}")
    print(f"[serve] {arch}: page-window buckets: {eng.gather_bucket_hits}")
    return counts, eng


# ---------------------------------------------------------------- phase 4

def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(event, attr, None)
        if t:
            return float(t)
    return 0.0


# the kernels of the port, as the profiler names them
OWN_KERNELS = ("paged_decode_kernel", "chunked_prefill_kernel",
               "rmsnorm_kernel", "ssd_cb_kernel", "ssd_scan_kernel")


def phase_profile(eng) -> None:
    """Where one decode and one prefill iteration of a served engine
    spend their time: host wall time per iteration, device busy time by
    kernel (torch.profiler) and the device's idle share. The iterations
    write the engine's cache in place; the engine serves nothing after."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    n, mb, dev = eng.n_slots, 16, eng.device
    i32 = dict(dtype=torch.int32, device=dev)

    def z(*shape):
        return torch.zeros(shape, **i32)
    bt = torch.arange(n * mb, **i32).reshape(n, mb)
    def flags(*shape, value=False):
        return torch.full(shape, value, dtype=torch.bool, device=dev)
    plans = {
        "decode 8 rows at 1000 tokens": (
            z(0, 1), z(0), z(0), z(0), flags(0), z(0), z(n),
            torch.full((n,), 1000, **i32), flags(n, value=True), z(0, mb),
            bt),
        "prefill 1 row of 1024 tokens": (
            z(1, 1024), z(1), z(1), torch.full((1,), 1024, **i32),
            flags(1, value=True), torch.full((1,), 1023, **i32), z(0), z(0),
            flags(0), bt[:1], z(0, mb)),
    }
    reps = 5
    for name, args in plans.items():
        def step():
            return T.fused_serve_forward(eng.params, eng.cfg, eng.cache,
                                         *args)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if _device_us(e) > 0]
        kernels = {e.key: _device_us(e) / reps / 1e3 for e in events}
        launches = sum(e.count for e in events) / reps
        busy = sum(kernels.values())
        if busy == 0:
            print(f"[profile] {eng.cfg.name} {name}: {wall_ms:.2f} ms wall "
                  f"per iteration; "
                  f"device time not measured (the profiler saw no kernel)")
            continue
        own = {o: sum(t for k, t in kernels.items() if o in k)
               for o in OWN_KERNELS}
        own_ms = sum(own.values())
        gemm = sum(t for k, t in kernels.items()
                   if any(w in k.lower() for w in ("gemm", "cutlass",
                                                   "sm90_xmma", "nvjet")))
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        own_txt = ", ".join(f"{o} {t:.2f}" for o, t in own.items() if t)
        print(f"[profile] {eng.cfg.name} {name}: {wall_ms:.2f} ms wall per "
              f"iteration, {launches:.0f} kernels, device busy {busy:.2f} ms "
              f"(idle share {max(0.0, 1 - busy / wall_ms):.1%}): the port's "
              f"kernels {own_ms:.2f} ms ({own_txt}), GEMMs {gemm:.2f} ms, "
              f"other {busy - own_ms - gemm:.2f} ms")
        for k, t in top:
            print(f"[profile]   {t:.3f} ms  {k[:90]}")


# ---------------------------------------------------------------- phase 5

def _clone_cache(cache):
    return {"layers": [type(c)(*(t.clone() for t in c))
                       for c in cache["layers"]]}


def phase_parity() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    full = get_config("llama3.2-3b")
    cfg = dataclasses.replace(full, num_layers=2, layers=full.layers[:2])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, "cuda", torch.float32)
    rng = np.random.default_rng(1)
    bs, n_slots, maxb = 64, 8, 16
    nb = n_slots * maxb
    cache = T.init_paged_cache(cfg, n_slots, nb, bs, torch.float32, "cuda")
    for c in cache["layers"]:       # stale and prefix KV in every page
        c.k.normal_(generator=gen)
        c.v.normal_(generator=gen)
    perm = rng.permutation(nb).reshape(n_slots, maxb).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).cuda()
    # prefill: rows on slots 0-2 at ragged offsets, one pad row
    pre_slots = np.array([0, 1, 2, n_slots], np.int32)
    pre_reset = np.array([1, 0, 0, 0], bool)
    pre_start = np.array([0, 200, 513, 0], np.int32)
    pre_len = np.array([256, 256, 90, 0], np.int32)
    pre_tokens = rng.integers(0, cfg.vocab_size, (4, 256)).astype(np.int32)
    pre_bt = np.full((4, maxb), -1, np.int32)
    pre_bt[:3] = perm[:3]
    pre_sample = np.maximum(pre_len - 1, 0).astype(np.int32)
    # decode: slots 3-7, two of them inactive (slot 6 mid-prefill length)
    dec_start = np.array([0, 0, 0, 700, 31, 1000, 450, 64], np.int32)
    dec_active = np.array([0, 0, 0, 1, 1, 1, 0, 1], bool)
    dec_bt = np.full((n_slots, maxb), -1, np.int32)
    dec_bt[dec_active] = perm[dec_active]
    dec_tokens = rng.integers(0, cfg.vocab_size, n_slots).astype(np.int32)
    args = [dev(a) for a in (pre_tokens, pre_slots, pre_start, pre_len,
                             pre_reset, pre_sample, dec_tokens, dec_start,
                             dec_active, pre_bt, dec_bt)]

    def run():
        with torch.inference_mode():
            hid = T._sampled_hidden(params, cfg, _clone_cache(cache), *args)
        c = _clone_cache(cache)
        ids = T.fused_serve_forward(params, cfg, c, *args)
        return hid, ids, c

    hk, ik, ck = run()
    with ops.plain_versions():
        hp, ip, cp = run()
    torch.cuda.synchronize()
    live = np.r_[pre_len > 0, dec_active]
    err = float((hk - hp).abs().max())
    check(bool(torch.isfinite(hk).all()), "parity: non-finite hidden state")
    check(err <= 1e-4, f"parity: max |hidden kernel - plain| = {err:.3g} "
          f"> 1e-4")
    check(torch.equal(ik[dev(live)], ip[dev(live)]),
          f"parity: sampled ids differ: {ik.tolist()} vs {ip.tolist()}")
    # every page but the sink, whose content is whichever invalid write
    # landed last
    page_err = max(float((x[:-1] - y[:-1]).abs().max())
                   for a, b in zip(ck["layers"], cp["layers"])
                   for x, y in ((a.k, b.k), (a.v, b.v)))
    check(page_err <= 1e-4, f"parity: written pages differ by {page_err}")
    print(f"[parity] llama3.2-3b, 2-layer full-width f32: max |hidden "
          f"kernel - plain| {err:.3g}, pages {page_err:.3g}, sampled ids "
          f"equal ({ik[dev(live)].tolist()})")


def phase_parity_mamba() -> None:
    """Two full-width mamba2-370m layers in f32, one mixed iteration:
    a first chunk (state reset) of 512 tokens, a chunk resuming a slot's
    state, a short first chunk, a pad row; 8 decode slots, 2 inactive.
    Kernels (rmsnorm, ssd_scan) against the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    full = get_config("mamba2-370m")
    cfg = dataclasses.replace(full, num_layers=2, layers=full.layers[:2])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, "cuda", torch.float32)
    rng = np.random.default_rng(2)
    n_slots = 8
    cache = T.init_paged_cache(cfg, n_slots, 0, 64, torch.float32, "cuda")
    for c in cache["layers"]:       # every slot carries a state
        c.conv.normal_(generator=gen)
        c.ssm.normal_(generator=gen)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).cuda()
    pre_slots = np.array([0, 1, 2, n_slots], np.int32)
    pre_start = np.array([0, 256, 0, 0], np.int32)
    pre_len = np.array([512, 300, 77, 0], np.int32)
    pre_reset = np.array([1, 0, 1, 0], bool)
    pre_tokens = rng.integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    pre_sample = np.maximum(pre_len - 1, 0).astype(np.int32)
    dec_tokens = rng.integers(0, cfg.vocab_size, n_slots).astype(np.int32)
    dec_start = np.array([0, 0, 0, 700, 31, 1000, 450, 64], np.int32)
    dec_active = np.array([0, 0, 0, 1, 1, 1, 0, 1], bool)
    args = [dev(a) for a in (pre_tokens, pre_slots, pre_start, pre_len,
                             pre_reset, pre_sample, dec_tokens, dec_start,
                             dec_active, np.full((4, 1), -1, np.int32),
                             np.full((n_slots, 1), -1, np.int32))]

    def run():
        with torch.inference_mode():
            hid = T._sampled_hidden(params, cfg, _clone_cache(cache), *args)
        c = _clone_cache(cache)
        ids = T.fused_serve_forward(params, cfg, c, *args)
        return hid, ids, c

    ops.reset_counts()
    hk, ik, ck = run()
    launched = ops.counts()
    with ops.plain_versions():
        hp, ip, cp = run()
    torch.cuda.synchronize()
    check(launched["ssd_scan"]["launches"] == 2 * cfg.num_layers
          and launched["ssd_scan"]["plain"] == 0,
          f"parity mamba2: the kernel path ran {launched}")
    live = np.r_[pre_len > 0, dec_active]
    err = float((hk - hp).abs().max())
    check(bool(torch.isfinite(hk).all()),
          "parity mamba2: non-finite hidden state")
    check(err <= MAMBA_PARITY_HIDDEN,
          f"parity mamba2: max |hidden kernel - plain| = {err:.3g} > "
          f"{MAMBA_PARITY_HIDDEN}")
    check(torch.equal(ik[dev(live)], ip[dev(live)]),
          f"parity mamba2: sampled ids differ: {ik.tolist()} vs "
          f"{ip.tolist()}")
    # every slot's row (not the sink): conv windows and fp32 states
    state_err = 0.0
    for a, b in zip(ck["layers"], cp["layers"]):
        for x, y in ((a.conv, b.conv), (a.ssm, b.ssm)):
            scale = float(y[:-1].abs().max())
            e = float((x[:-1] - y[:-1]).abs().max())
            check(e <= SSD_REL * scale, f"parity mamba2: state rows differ "
                  f"by {e:.3g} (of {scale:.3g})")
            state_err = max(state_err, e / scale)
    print(f"[parity] mamba2-370m, 2-layer full-width f32: max |hidden "
          f"kernel - plain| {err:.3g}, state rows {state_err:.3g} of their "
          f"scale, sampled ids equal ({ik[dev(live)].tolist()})")


# ---------------------------------------------------------------- main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    # the card's name and power limit, as nvidia-smi prints them
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    # f32 comparisons run in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    head = phase_kernels()
    # each served path: counts zeroed just before it, read just after
    launches = {name: 0 for name in SOURCES}
    for arch in PATHS:
        counts, eng = phase_serve(arch)
        for name in SOURCES:
            launches[name] += counts[name]["launches"]
        phase_profile(eng)
        del eng
    phase_parity()
    phase_parity_mamba()
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            **head[name]))
        print(f"[kernels] {name}: ported (cuda, {src}), agrees with its "
              f"plain version in f32 and bf16, launched {launches[name]} "
              f"times while serving")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
