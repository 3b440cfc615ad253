"""The benchmark of repro_torch: one run of one cell on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` at the root of the checkout,
serves its traffic through the program for a ramp and then ``--seconds``
of window, and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; ``checks`` last.
Exits non-zero, printing no result, without a CUDA device, with fewer
than the cell's cards, without the program (``src/repro_torch``), or
when JAX or the JAX package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="arrivals a second instead of the mix's (the "
                         "knee sweep, bench/sweep.py)")
    a = ap.parse_args(argv)

    import torch

    from nbench import harness, spec

    chips = spec.load(ROOT, a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, a.workload, a.seed, a.seconds,
                              bool(a.trace), "cuda", T_START, a.rate)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
