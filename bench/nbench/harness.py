"""One run of one cell: set-up, ramp, window, the readers, the check.

Set-up draws the weights from the seed on the device (the leaves that
the configuration's family module names) and hands them to the
program's replica, warms the engine (which builds and loads its
kernels), then offers the cell's traffic for the mix's ramp so that the
running batch and the KV pool are at steady state when the window
opens. The window measures for ``seconds``; then the peak memory is
read, the trace reduced, the metrics read, the program's state freed and
the served tokens of a sample of served requests compared with the
plain reference.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from nbench import check, program, spec
from nbench.profile import Profiled
from nbench.records import Run, pct
from nbench.serve import drive
from nbench.traffic import prompt_tokens, schedule
from nbench.weights import SeededWeights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TOP_OPS = 10


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def _top(d: Dict[str, float]) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:TOP_OPS]]


def set_up(cell: spec.Cell, seed: int, device):
    """The run's weights, drawn through the cell's family, and the
    program's replica and engine built on them."""
    m, serve_cfg = cell.config["model"], cell.config["serve"]
    weights = SeededWeights(cell.family, m, seed, device,
                            getattr(torch, serve_cfg["dtype"]))
    rep, eng = program.build_replica(program.port_config(cell.config),
                                     serve_cfg, weights, device)
    weights.release()
    return weights, rep, eng


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: Optional[float] = None,
             rate: Optional[float] = None, control: bool = False,
             by_request: bool = False, log=print) -> dict:
    """One run; ``control`` also reads the fp8 control's gaps on the same
    sample (``result["control"]``), and ``by_request`` adds each checked
    request's own gaps (``result["per_request"]``), for setting the
    limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load(root, cell_name)
    cfg_file, mix = cell.config, cell.mix
    m, serve_cfg = cfg_file["model"], cfg_file["serve"]

    marks = [("start", t_start)]

    def mark(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append((name, time.perf_counter()))

    weights, rep, eng = set_up(cell, seed, device)
    mark("weights")
    eng.warm()
    mark("warm")
    items = schedule(mix, seconds, seed, rate)
    prompts = {it.rid: prompt_tokens(seed, it.rid, it.prompt_len,
                                     m["vocab_size"]) for it in items}
    mark("traffic")
    tracer = Profiled(device) if trace else None
    t_ramp = time.perf_counter()
    reqs, steps, t_open, t_close, t_prof = drive(
        rep, items, mix, prompts, seconds, t_ramp, tracer)
    marks.append(("ramp", t_open))
    mark("window")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    run = Run(model=m, seconds=float(seconds), t_open=t_open,
              t_close=t_close, setup_s=t_open - t_start,
              reqs=list(reqs.values()), steps=steps, serve=serve_cfg,
              t_prof=t_prof, family=cell.family)
    if tracer is not None:
        run.trace = tracer.reduce(sum(s.profiled for s in steps))
        tracer.prof = None
        mark("trace")
    metrics = {}
    for metric in (cell.traced_metrics if trace else cell.metrics):
        v = metric.read(run)
        if v is not None:
            metrics[metric.name] = {"value": float(v), "unit": metric.unit}
    served = {rid: program.served(eng, rid) for rid in reqs}
    n_win = sum(r.in_window for r in reqs.values())

    program.forget(rep)
    del rep, eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rids = check.sample(reqs, served, seed)
    got = check.served_gaps(cell.family, m, weights, rids, prompts, served,
                            device, control)
    mark("check")
    limits = cfg_file["check"]
    over = check.failed(got["per_request"], limits)
    n_tok = got["tokens"]
    checks = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    correct = n_tok >= check.MIN_TOKENS and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    checks["tokens_checked"] = {"value": n_tok,
                                "limit": f">= {check.MIN_TOKENS}"}
    result = {"correct": bool(correct), "attempted": n_win,
              "failed": int(over), "metrics": metrics,
              "device": _device(device, peak)}
    if run.trace is not None:
        t = run.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": _top(t.kernels),
                               "idle_gaps": _top(t.idle)}
    result["load"] = {"rate_per_s": rate or mix.rate,
                      "backlog_open": _backlog(reqs, t_open),
                      "backlog_close": _backlog(reqs, t_close),
                      "finished_in_window": sum(
                          r.in_window and r.done_by(t_close)
                          for r in reqs.values()),
                      "waiting_slope_per_s": _slope(reqs, t_open, t_close,
                                                    _waiting),
                      "backlog_slope_per_s": _slope(reqs, t_open, t_close,
                                                    _backlog),
                      "ttft_s_by_pct": _ttft_pcts(run)}
    result["memory"] = _held(steps, cfg_file, peak, cell.family)
    result["gaps"] = {k: got[k] for k in ("max_logit_gap", "mean_logit_gap",
                                          "request_mean_gap")}
    if control:
        result["control"] = {k[len("control_"):]: v for k, v in got.items()
                             if k.startswith("control_")}
    if by_request:
        result["per_request"] = got["per_request"]
    result["checks"] = checks
    log(f"[bench] {cell_name} seed {seed}: {n_win} requests due in the "
        f"window, {len(steps)} steps, {len(rids)} requests checked",
        file=sys.stderr)
    log("[bench] seconds: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(marks, marks[1:])),
        file=sys.stderr)
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}",
            file=sys.stderr)
    return result


def _ttft_pcts(run: Run) -> dict:
    """The window's TTFTs at a few percentiles, beside the result (a
    diagnostic the driver does not read)."""
    w = [min(r.tokens[0] if r.tokens else run.t_close, run.t_close) - r.due
         for r in run.window_reqs()]
    return {str(q): pct(w, q) for q in (50, 90, 95, 99)}


def _backlog(reqs, t: float) -> int:
    """Requests due by ``t`` and not finished by then."""
    return sum(r.due <= t and not r.done_by(t) for r in reqs.values())


def _waiting(reqs, t: float) -> int:
    """Requests due by ``t`` that no step had begun to prefill by then."""
    return sum(r.due <= t and (r.admitted is None or r.admitted > t)
               for r in reqs.values())


def _slope(reqs, t0: float, t1: float, count, n: int = 101) -> float:
    """Least-squares slope, a second, of ``count(reqs, t)`` at ``n``
    instants evenly over [t0, t1]."""
    ts = [t0 + (t1 - t0) * i / (n - 1) for i in range(n)]
    ys = [count(reqs, t) for t in ts]
    mt, my = sum(ts) / n, sum(ys) / n
    var = sum((t - mt) ** 2 for t in ts)
    return sum((t - mt) * (y - my) for t, y in zip(ts, ys)) / var \
        if var else 0.0


def _held(steps, cfg_file: dict, peak: int, fam) -> dict:
    """The KV pool's most-held share over the run's steps, and the peak
    less the pool's blocks that no step held: the memory the run used,
    beside the peak that counts the whole pool reserved. A block holds
    K and V in each of the family's ``kv_layers``."""
    m, serve = cfg_file["model"], cfg_file["serve"]
    block = (2 * fam.kv_layers(m) * m["num_kv_heads"] * m["head_dim"]
             * getattr(torch, serve["dtype"]).itemsize * serve["block_size"])
    used = max((s.kv_used for s in steps), default=0)
    total = steps[-1].kv_total if steps else serve["kv_blocks"]
    return {"kv_blocks": total, "kv_peak_used_blocks": used,
            "kv_peak_used_pct": 100.0 * used / total if total else 0.0,
            "held_bytes": int(peak - (total - used) * block) if peak
            else 0}


def _device(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
