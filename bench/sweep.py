"""The knee of a cell's traffic: one run of the cell at each of a list
of rates on each of a few seeds, each run a process of its own, and a
table of what came out.

    python3 bench/sweep.py --workload qwen7b.conv --rates 2.8 3.5 4.0 \
        [--seconds 30] [--seeds 11 12]

A rate sustains when, on every seed, the queue of requests due and not
yet begun (no step has prefilled any of their prompt) grows over the
window by at most ``TOLERANCE`` requests a second, as the least-squares
slope of its length read at 101 instants of the window: a fixed rate of
growth, the same at every offered rate. The knee is the highest rate
that sustains. The slope of the whole backlog (requests due and not
finished) is printed beside it, but not judged: under heavy-tailed
output lengths it keeps rising for as long as the longest requests live,
below the knee too. Each run's result line is kept beside the table
(``--out``).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOLERANCE = 0.1     # requests a second


def sustains(res: dict) -> bool:
    return res["load"]["waiting_slope_per_s"] <= TOLERANCE


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12])
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args()
    rows, lines = [], []
    for rate in a.rates:
        for seed in a.seeds:
            p = subprocess.run(
                [sys.executable, str(ROOT / "bench" / "run.py"),
                 "--workload", a.workload, "--seed", str(seed),
                 "--seconds", str(a.seconds), "--trace", "0",
                 "--rate", str(rate)],
                cwd=ROOT, capture_output=True, text=True)
            if p.returncode:
                print(f"rate {rate} seed {seed}: exit {p.returncode}\n"
                      f"{p.stderr[-3000:]}", flush=True)
                rows.append((rate, seed, None))
                continue
            res = json.loads(p.stdout.strip().splitlines()[-1])
            lines.append(dict(res, seed=seed))
            rows.append((rate, seed, res))
    print(f"{a.workload}: {a.seconds} s windows, seeds {a.seeds}, "
          f"tolerance {TOLERANCE} req/s")
    held = {}
    for rate, seed, res in rows:
        if res is None:
            print(f"  {rate:6.2f} req/s seed {seed}: failed")
            held[rate] = False
            continue
        ld, met = res["load"], res["metrics"]
        ok = sustains(res)
        held[rate] = held.get(rate, True) and ok
        vals = " ".join(f"{k} {v['value']:.4g}" for k, v in met.items())
        print(f"  {rate:6.2f} req/s seed {seed}: waiting slope "
              f"{ld['waiting_slope_per_s']:+.4f}/s, backlog slope "
              f"{ld['backlog_slope_per_s']:+.4f}/s ({ld['backlog_open']} -> "
              f"{ld['backlog_close']}), finished "
              f"{ld['finished_in_window']} of {res['attempted']}, "
              f"{'sustains' if ok else 'grows'}; {vals}; TTFT p50/p95 "
              f"{ld['ttft_s_by_pct']['50']:.3f}/"
              f"{ld['ttft_s_by_pct']['95']:.3f} s; kv held "
              f"{res['memory']['kv_peak_used_pct']:.1f}% at most; "
              f"correct {res['correct']}")
    knee = max((r for r, ok in held.items() if ok), default=None)
    print(f"knee: {knee} req/s")
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({"knee": knee, "tolerance": TOLERANCE,
                                     "runs": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
