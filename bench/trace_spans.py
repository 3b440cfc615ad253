"""Runs of a cell with the program's spans (``repro_torch.obs.spans``)
turned on, read beside the cell's own metrics; each run served as
``bench/run.py`` serves it (the same set-up, ramp, window and readers),
without the check of the served tokens.

    python3 bench/trace_spans.py --workload qwen7b.conv --seeds 11 \
        --trace 1 [--seconds 51] [--out spans.jsonl]
    python3 bench/trace_spans.py --workload qwen7b.code --seeds 11 12 13 \
        --trace 0 --spans 0 1          # the table's cost: tokens_s off/on
    python3 bench/trace_spans.py --workload qwen3moe.code --seeds 11 \
        --audit 40 --seconds 4         # the forward's synchronising calls

Traced (``--trace 1``), the table is on for the whole run and the line
holds the traced metrics, the reduction of ``nbench/spans.py`` (idle
seconds by the innermost program span, launches inside ``engine.launch``
against the kernel events, ``idle_launch_pct``, ``launches_per_step``),
the host readings of the table's per-step deltas over
``Run.host_steps()`` (``engine_launch_ms``, ``host_serial_ms``,
``host_reads_per_step``, the four ``engine.*`` spans against
``engine_ms``) and the reduction's own seconds. Untraced, each seed runs
once per ``--spans`` setting, the order turned about from seed to seed.
``--audit N`` runs the first N steps that execute under
``torch.cuda.set_sync_debug_mode("warn")`` and lists every call that
synchronised the host with the card: its file and line and whether
``fused_serve_forward`` was on the stack.
"""
import argparse
import gc
import json
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def _record_steps(rep, table, audit: int = 0):
    """Wrap ``rep.step``: each call's delta of the span table, and under
    ``audit`` the synchronising calls of the first ``audit`` steps that
    ran the forward (``sites``: (the program's innermost frame and its
    caller, in the forward) -> calls)."""
    import torch

    from nbench.spans import delta

    deltas, sites = [], Counter()
    inner = rep.step
    left = [audit]

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if "/src/repro_torch/" in f.filename]
        if not own:
            return      # the switch itself, outside the program
        where = " <- ".join(
            f"{f.filename.split('/src/')[-1]}:{f.lineno} {f.name}"
            for f in own[:-3:-1])
        sites[(where, any(x.name == "fused_serve_forward"
                          for x in stack))] += 1

    def step():
        before = table.totals()
        if left[0] <= 0:
            try:
                return inner()
            finally:
                deltas.append(delta(table.totals(), before))
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return inner()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                d = delta(table.totals(), before)
                deltas.append(d)
                if "engine.launch" in d:
                    left[0] -= 1
    rep.step = step
    return deltas, sites


def serve(root: Path, cell_name: str, seed: int, seconds: float,
          trace: bool, on: bool, device="cuda", audit: int = 0) -> dict:
    import torch

    from nbench import harness, program, readers, spec
    from nbench.profile import Profiled, reduce_events
    from nbench.records import Run
    from nbench.serve import drive
    from nbench.spans import host_readings, reduce_program
    from nbench.traffic import prompt_tokens, schedule
    from repro_torch.obs import spans as table

    t_start = time.perf_counter()
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load(root, cell_name)
    cfg_file, mix = cell.config, cell.mix
    m, serve_cfg = cfg_file["model"], cfg_file["serve"]
    _, rep, eng = harness.set_up(cell, seed, device)
    eng.warm()
    items = schedule(mix, seconds, seed)
    prompts = {it.rid: prompt_tokens(seed, it.rid, it.prompt_len,
                                     m["vocab_size"]) for it in items}
    table.reset()
    table.enable(on or audit > 0)
    deltas, sites = _record_steps(rep, table, audit)
    tracer = Profiled(device) if trace else None
    try:
        reqs, steps, t_open, t_close, t_prof = drive(
            rep, items, mix, prompts, seconds, time.perf_counter(), tracer)
    finally:
        table.enable(False)
    assert len(deltas) == len(steps)
    of = {id(s): d for s, d in zip(steps, deltas)}
    run = Run(model=m, seconds=float(seconds), t_open=t_open,
              t_close=t_close, setup_s=t_open - t_start,
              reqs=list(reqs.values()), steps=steps, serve=serve_cfg,
              t_prof=t_prof, family=cell.family)
    out = {"workload": cell_name, "seed": seed, "trace": int(trace),
           "spans": int(on), "steps": len(steps)}
    if tracer is not None:
        t0 = time.perf_counter()
        events = tracer.prof.events()
        t1 = time.perf_counter()
        run.trace = reduce_events(events, sum(s.profiled for s in steps))
        t2 = time.perf_counter()
        pt = reduce_program(events)
        t3 = time.perf_counter()
        tracer.prof = events = None
        out["reduce_s"] = {"events": t1 - t0, "reduce_events": t2 - t1,
                           "reduce_program": t3 - t2}
        out["idle_by_span"] = pt.idle_by_span
        out["program_trace"] = {
            "window_s": pt.window_s, "idle_s": pt.idle_s,
            "busy_s": run.trace.busy_s,
            "idle_by_span_sum": sum(pt.idle_by_span.values()),
            "bench_step_share": pt.idle_by_span.get("bench.step", 0.0)
            / pt.idle_s if pt.idle_s else None,
            "idle_launch_pct": pt.idle_launch_pct,
            "launches_per_step": pt.launches_per_step,
            "launches": pt.launches, "launch_spans": pt.launch_spans,
            "kernel_events": pt.kernel_events,
            "launches_by_name": pt.launches_by_name,
            "traced_steps": run.trace.steps}
    metrics = {}
    for metric in (cell.traced_metrics if trace else cell.metrics):
        v = metric.read(run)
        if v is not None:
            metrics[metric.name] = float(v)
    out["metrics"] = metrics
    if on:
        host = [of[id(s)] for s in run.host_steps()]
        out["host"] = dict(host_readings(host),
                           engine_ms=readers.engine_ms(run),
                           host_steps=len(host))
        out["totals"] = table.totals()
    if audit:
        out["sync_sites"] = [
            {"site": w, "in_forward": f, "calls": n}
            for (w, f), n in sorted(sites.items(), key=lambda kv: -kv[1])]
        out["audited_steps"] = audit
    program.forget(rep)
    del rep, eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, nargs="+", choices=(0, 1),
                    default=[1])
    ap.add_argument("--audit", type=int, default=0,
                    help="steps run under the sync debug mode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args()

    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        print("trace_spans: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(a.seeds):
        order = a.spans if i % 2 == 0 else a.spans[::-1]
        for on in order:
            res = serve(ROOT, a.workload, seed, a.seconds, bool(a.trace),
                        bool(on), a.device, a.audit)
            line = json.dumps(res)
            print(line, flush=True)
            if a.out is not None:
                a.out.parent.mkdir(parents=True, exist_ok=True)
                with a.out.open("a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
