"""Readings for the limit of a cell's check: the program's gaps
(``nbench/check.py``: the widest, the mean, the largest request's mean)
over many seeds, and the fp8 control's on the first few, every run a
short window at the cell's own load, all in one process so the set-up is
paid once per seed and not per process. Each row also lists the checked
requests' own readings (tokens, widest, mean; the control's beside).

    python3 bench/calibrate.py --workload qwen7b.code --seeds 101 102 ... \
        --control 3 [--seconds 12] [--out chiprun_out/cal.json]
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="read the control on the first N seeds")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args()

    import torch

    from nbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        res = harness.run_cell(ROOT, a.workload, seed, a.seconds, False,
                               "cuda", control=i < a.control,
                               by_request=True)
        c = res["checks"]
        ctl = res.get("control", {})
        row = {"seed": seed, "gap": res["gaps"]["max_logit_gap"],
               "mean_gap": res["gaps"]["mean_logit_gap"],
               "request_gap": res["gaps"]["request_mean_gap"],
               "tokens": c["tokens_checked"]["value"],
               "control": ctl.get("max_logit_gap"),
               "control_mean": ctl.get("mean_logit_gap"),
               "control_request": ctl.get("request_mean_gap"),
               "requests": [
                   [g["tokens"], g["max_logit_gap"], g["mean_logit_gap"]]
                   + ([ctl["per_request"][r]["max_logit_gap"],
                       ctl["per_request"][r]["mean_logit_gap"]]
                      if ctl else [])
                   for r, g in res["per_request"].items()],
               "correct": res["correct"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": a.workload, "rows": rows,
               "device": torch.cuda.get_device_name()}
    for k, ck in (("gap", "control"), ("mean_gap", "control_mean"),
                  ("request_gap", "control_request")):
        v = [r[k] for r in rows if r[k] is not None]
        c = [r[ck] for r in rows if r[ck] is not None]
        summary[f"program_max_{k}"] = max(v)
        summary[f"control_min_{k}"] = min(c) if c else None
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
