"""Time training steps of one architecture at full width and full depth.

Builds the model from the registry (random weights from ``--seed``),
fp32, AdamW, remat on, and runs ``--steps`` steps of ``make_train_step``
on ``synthetic_batch`` batches of ``--batch`` x ``--seq`` tokens, timing
each step on the host's clock up to a device synchronisation. It prints
every step's milliseconds, the median of all but the first (which warms
up), and the scan's and the norm's kernel launches and plain calls of the
timed steps.

``--tree DIR`` times the port of another checkout (``DIR/src``, for
example an earlier commit unpacked by ``git archive``) with this script,
so two commits are compared on one card in one call: run parent, change,
change, parent.

  PYTHONPATH=src python -m repro_torch.launch.step_time \\
      --arch mamba2-370m --batch 2 --seq 1024 --steps 6
  PYTHONPATH=src python -m repro_torch.launch.step_time --tree parent \\
      --arch mamba2-370m --batch 2 --seq 1024 --steps 6
  PYTHONPATH=src python -m repro_torch.launch.step_time --device cpu \\
      --reduced --arch mamba2-370m --batch 1 --seq 64 --steps 2
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _use_tree(tree: str) -> None:
    """Import ``repro_torch`` from ``tree/src`` from here on."""
    src = str(Path(tree).resolve() / "src")
    if not (Path(src) / "repro_torch").is_dir():
        raise SystemExit(f"step_time: no src/repro_torch under {tree}")
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, src)


def time_steps(arch: str, batch: int, seq: int, steps: int, seed: int = 0,
               device: str = "cuda", reduced: bool = False) -> dict:
    """``steps`` AdamW steps of ``arch``; returns each step's ms, the
    median of all but the first, the losses and the kernels' counts over
    the steps."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.engine.steps import init_train_state, make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch.train import synthetic_batch

    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params, opt = init_train_state(cfg, gen, device=dev)
    rng = np.random.default_rng(seed)
    batches = [synthetic_batch(rng, cfg, batch, seq, dev)
               for _ in range(steps)]
    step = make_train_step(cfg)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    ops.reset_counts()
    ms, losses = [], []
    for b in batches:
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(ms=ms, median_ms=float(np.median(ms[1:] or ms)),
                losses=losses, counts=ops.counts(), layers=cfg.num_layers,
                d_model=cfg.d_model)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", default=None,
                    help="a checkout whose src/repro_torch is timed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() variant")
    args = ap.parse_args(argv)
    if args.tree:
        _use_tree(args.tree)
    r = time_steps(args.arch, args.batch, args.seq, args.steps, args.seed,
                   args.device, args.reduced)
    kern = {k: c for k, c in r["counts"].items()
            if c["launches"] or c["plain"]}
    pkg = Path(sys.modules["repro_torch"].__file__).parents[1]
    print(f"[step_time] repro_torch from {pkg}: "
          f"{args.arch} ({r['layers']} layers, d_model {r['d_model']}), "
          f"f32, batch {args.batch} x {args.seq}: median step "
          f"{r['median_ms']:.1f} ms of steps 2-{args.steps} (steps "
          f"{[round(x, 1) for x in r['ms']]} ms), losses "
          f"{[round(x, 4) for x in r['losses']]}; kernels " + ", ".join(
              f"{k} {c['launches']} launches, {c['plain']} plain"
              for k, c in kern.items()))
    return r


if __name__ == "__main__":
    main()
