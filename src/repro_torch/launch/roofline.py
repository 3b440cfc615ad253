"""Roofline report: reads experiments/dryrun_torch/*.json (written by
``launch/dryrun.py``) and prints the markdown table of the JAX package's
``launch/roofline.py`` -- the three terms in seconds, the dominant one,
model flops over traced flops, the peak per device and a one-line
improvement note per (arch x shape x mesh). The terms come from the H100
datasheet's constants over a trace on meta tensors: they are computed,
not measured.

  python -m repro_torch.launch.roofline [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

# where ``launch/dryrun.py`` writes its reports and this table reads them
RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"

NOTES = {
    ("compute", "train"): "raise tensor-core occupancy: larger per-device "
    "microbatch or fewer remat recomputes",
    ("memory", "train"): "activation layout / fusion; raise arithmetic "
    "intensity with bigger microbatch",
    ("collective", "train"): "overlap seq-parallel all-gathers with "
    "matmuls; shrink FSDP regather via 2D sharding",
    ("compute", "prefill"): "near roofline — only kernel-level wins left",
    ("memory", "prefill"): "KV-write/prefix-read bound: larger chunks or "
    "fused attention kernel",
    ("collective", "prefill"): "reshard: keep seq local, gather KV once",
    ("memory", "decode"): "KV reads dominate (expected): quantize KV, "
    "GQA-share loads, or grow batch per GPU",
    ("compute", "decode"): "unusual for decode — check redundant "
    "replicated compute",
    ("collective", "decode"): "partial-softmax combine traffic over "
    "NVLink/IB: shard cache seq on fewer axes or tree-combine",
}


def kind_of(shape: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill"}.get(
        shape, "decode")


def fmt(x: float) -> str:
    return f"{x:.2e}"


def load(mesh: str):
    rows = []
    for f in sorted(RESULTS_DIR.glob(f"*__{mesh}.json")):
        d = json.loads(f.read_text())
        if d.get("mesh") == mesh:
            rows.append(d)
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rows.sort(key=lambda d: (d["arch"], order.get(d["shape"], 9)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = load(args.mesh)
    print("| arch | shape | t_compute | t_memory | t_collective | "
          "dominant | useful/traced | peak GiB | note |")
    print("|---|---|---|---|---|---|---|---|---|")
    n_ok = n_fail = 0
    for d in rows:
        if d.get("skipped"):
            print(f"| {d['arch']} | {d['shape']} | — | — | — | skipped | — "
                  f"| — | {d['skipped'][:48]} |")
            continue
        if not d.get("ok"):
            n_fail += 1
            print(f"| {d['arch']} | {d['shape']} | FAIL | | | | | | "
                  f"{d.get('error', '')[:60]} |")
            continue
        n_ok += 1
        note = NOTES.get((d["dominant"], kind_of(d["shape"])), "")
        variant = "*" if d.get("attn_variant") == "swa_500k" else ""
        print(f"| {d['arch']}{variant} | {d['shape']} "
              f"| {fmt(d['t_compute_s'])} | {fmt(d['t_memory_s'])} "
              f"| {fmt(d['t_collective_s'])} | {d['dominant']} "
              f"| {d['useful_flops_ratio']:.2f} "
              f"| {d['peak_bytes_per_dev']/2**30:.1f} | {note} |")
    print(f"\n{n_ok} ok, {n_fail} failed (* = swa_500k variant)")


if __name__ == "__main__":
    main()
