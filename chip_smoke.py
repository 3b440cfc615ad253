"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. build: compile every CUDA kernel of ``src/repro_torch/csrc`` with
   nvcc, all sources at once;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, in f32 (TF32 off) and bf16, with its time, the
   plain version's, ``F.scaled_dot_product_attention``'s over the same
   data gathered to a dense view, and the least time the card could take;
3. serve: ``repro_torch.launch.serve.main`` serves full-width
   llama3.2-3b (random weights from a seed, bf16) through the
   NiyamaScheduler priced on the H100 spec; every request must finish
   with all its tokens, and both kernels must have launched while the
   plain attention versions ran 0 times;
4. profile: one decode and one prefill iteration of that engine, timed
   on the host and traced with torch.profiler (device time by kernel,
   idle share);
5. parity: a full-width 2-layer f32 copy runs one mixed iteration through
   the kernels and through the plain versions; the final hidden states
   agree within 1e-4 and the sampled ids are equal.

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
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:78"),
    "chunked_prefill_attention": (
        "src/repro_torch/csrc/chunked_prefill_attention.cu",
        "src/repro/kernels/chunked_prefill_attention.py:90"),
}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------- timing

_flush_buf = None
SPIN_MS = 5.0           # device time queued ahead of each timed call
_spin_cycles = None


def _spin() -> None:
    """Keep the device busy for about SPIN_MS ms: while it spins, the host
    queues the timed call's launches, so the events that bracket the call
    read device time only, not the host's time to issue the launches."""
    global _spin_cycles
    if _spin_cycles is None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(10 ** 6)
        e1.record()
        torch.cuda.synchronize()
        _spin_cycles = int(10 ** 6 * SPIN_MS / e0.elapsed_time(e1))
    torch.cuda._sleep(_spin_cycles)


def _flush_l2() -> None:
    """Overwrite a buffer four times the 50 MB L2, so the next launch
    finds its inputs in device memory, as a layer of the model does."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(200 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
    _flush_buf.zero_()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, cold L2, CUDA events,
    with the call queued behind a spin (``_spin``). Fails if the host
    took longer than the spin to queue the call, as it would if ``fn``
    waited on the device."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _spin()
        _flush_l2()
        e0.record()
        fn()
        e1.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        check(issue_ms < SPIN_MS, f"timing: the host took {issue_ms:.2f} ms "
              f"to queue one call, longer than the {SPIN_MS} ms spin")
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


def _compare(name, label, dtype, got, want):
    """Max |kernel - plain|; fails unless every element is within the
    dtype's limit (``TOL``)."""
    diff = (got.float() - want.float()).abs()
    t = TOL[dtype]
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
    return head


# ---------------------------------------------------------------- phase 3

def phase_serve() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    ops.reset_counts()
    t0 = time.perf_counter()
    rep = serve.main(["--device", "cuda", "--dtype", "bf16",
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
    for name, c in counts.items():
        check(c["launches"] > 0, f"serve: {name} was never launched")
        check(c["plain"] == 0,
              f"serve: the plain {name} ran {c['plain']} times")
    n_tok = sum(len(g) for g in eng.generated.values())
    n_prompt = sum(r.prompt_len for r in reqs)
    busy = rep.busy_time      # wall time inside the engine's iterations
    print(f"[serve] {len(reqs)} requests, {rep.iterations} iterations, "
          f"{n_prompt} prompt + {n_tok} output tokens; {wall:.2f} s wall "
          f"with the model build, {busy:.2f} s in iterations: "
          f"{n_tok / busy:.1f} output tok/s, {(n_prompt + n_tok) / busy:.1f} "
          f"tok/s; launches {counts}")
    print(f"[serve] page-window buckets: {eng.gather_bucket_hits}")
    return counts, eng


# ---------------------------------------------------------------- phase 4

def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(event, attr, None)
        if t:
            return float(t)
    return 0.0


def phase_profile(eng) -> None:
    """Where one decode and one prefill iteration of the serve phase's
    engine spend their time: host wall time per iteration, device busy
    time by kernel (torch.profiler) and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    n, mb, dev = eng.n_slots, 16, eng.device
    i32 = dict(dtype=torch.int32, device=dev)

    def z(*shape):
        return torch.zeros(shape, **i32)
    bt = torch.arange(n * mb, **i32).reshape(n, mb)
    plans = {
        "decode 8 rows at 1000 tokens": (
            z(0, 1), z(0), z(0), z(0), z(n), torch.full((n,), 1000, **i32),
            torch.ones(n, dtype=torch.bool, device=dev), z(0, mb), bt),
        "prefill 1 row of 1024 tokens": (
            z(1, 1024), z(1), torch.full((1,), 1024, **i32),
            torch.full((1,), 1023, **i32), z(0), z(0),
            torch.zeros(0, dtype=torch.bool, device=dev), bt[:1], z(0, mb)),
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
            print(f"[profile] {name}: {wall_ms:.2f} ms wall per iteration; "
                  f"device time not measured (the profiler saw no kernel)")
            continue
        attn = sum(t for k, t in kernels.items()
                   if "paged_decode_kernel" in k
                   or "chunked_prefill_kernel" in k)
        gemm = sum(t for k, t in kernels.items()
                   if any(w in k.lower() for w in ("gemm", "cutlass",
                                                   "sm90_xmma", "nvjet")))
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        print(f"[profile] {name}: {wall_ms:.2f} ms wall per iteration, "
              f"{launches:.0f} kernels, device busy {busy:.2f} ms (idle share "
              f"{max(0.0, 1 - busy / wall_ms):.1%}): attention kernels "
              f"{attn:.2f} ms, GEMMs {gemm:.2f} ms, other "
              f"{busy - attn - gemm:.2f} ms")
        for k, t in top:
            print(f"[profile]   {t:.3f} ms  {k[:90]}")


# ---------------------------------------------------------------- phase 5

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
    cache = T.init_paged_cache(cfg, nb, bs, torch.float32, "cuda")
    for c in cache["layers"]:       # stale and prefix KV in every page
        c.k.normal_(generator=gen)
        c.v.normal_(generator=gen)
    perm = rng.permutation(nb).reshape(n_slots, maxb).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).cuda()
    # prefill: rows on slots 0-2 at ragged offsets, one pad row
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
    args = [dev(pre_tokens), dev(pre_start), dev(pre_len), dev(pre_sample),
            dev(dec_tokens), dev(dec_start), dev(dec_active), dev(pre_bt),
            dev(dec_bt)]

    def run():
        c = {"layers": [T.PagedAttnCache(x.k.clone(), x.v.clone())
                        for x in cache["layers"]]}
        with torch.inference_mode():
            hid = T._sampled_hidden(params, cfg, c, *args)
        c = {"layers": [T.PagedAttnCache(x.k.clone(), x.v.clone())
                        for x in cache["layers"]]}
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
    print(f"[parity] 2-layer full-width f32: max |hidden kernel - plain| "
          f"{err:.3g}, pages {page_err:.3g}, sampled ids equal "
          f"({ik[dev(live)].tolist()})")


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
    counts, eng = phase_serve()
    phase_profile(eng)
    phase_parity()
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            launches=counts[name]["launches"],
                            **head[name]))
        print(f"[kernels] {name}: ported (cuda, {src}), agrees with its "
              f"plain version in f32 and bf16, launched "
              f"{counts[name]['launches']} times while serving")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
