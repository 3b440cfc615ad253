"""The training script of the port, as the JAX package's ``launch/train.py``.

Trains a ~100M-parameter variant of any registered architecture
(``small_100m``) on a synthetic learnable LM task (``synthetic_batch``:
an affine next-token map with 10% noise), fp32 weights, AdamW, remat
on. The map is one of 32768 rows per token, and 8 x 128 tokens a step
see each row about once in 40 steps: at the defaults the loss falls
below ln V only after ~150 steps, in JAX's script too, whose docstring
says tens of steps. Flags are
JAX's, plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain
kernel versions); it prints JAX's lines. The weights come from
``init_params`` seeded by ``--seed`` (a torch generator: not JAX's
numbers); the batches from numpy seeded the same way, the same calls in
the same order, so a seed gives JAX's tokens and frames. As in JAX,
``--resume`` restarts the batch stream from the seed.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 200 --log-every 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch mamba2-370m --steps 20 --batch 2 --seq 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.engine.steps import init_train_state, make_train_step


def small_100m(cfg):
    """~100M-param same-family variant (CPU-trainable)."""
    n_layers = min(8, cfg.num_layers)
    layers = tuple(cfg.layers[i % len(cfg.layers)] for i in range(n_layers))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                  d_ff_expert=1536)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, chunk=64)
    enc = None
    if cfg.encoder is not None:
        enc = dataclasses.replace(cfg.encoder, num_layers=2,
                                  num_positions=64)
    fe = cfg.frontend
    if fe is not None:
        fe = dataclasses.replace(fe, num_tokens=16)
    return dataclasses.replace(
        cfg, name=cfg.name + "-100m", num_layers=n_layers, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32768, layers=layers, moe=moe, ssm=ssm, encoder=enc,
        frontend=fe)


def synthetic_batch(rng, cfg, batch: int, seq: int, device="cpu"):
    """Learnable synthetic LM: affine next-token map with 10% noise. The
    numpy calls are JAX's, in its order; the tensors land on
    ``device``."""
    v = cfg.vocab_size
    t0 = rng.integers(0, v, size=(batch, 1))
    toks = [t0]
    for _ in range(seq):
        nxt = (toks[-1] * 31 + 17) % v
        noise = rng.integers(0, v, size=nxt.shape)
        use_noise = rng.random(nxt.shape) < 0.1
        toks.append(np.where(use_noise, noise, nxt))
    arr = np.concatenate(toks, axis=1).astype(np.int32)
    dev = resolve_device(device)
    batch_d = {"tokens": torch.from_numpy(arr[:, :seq].copy()).to(dev),
               "labels": torch.from_numpy(arr[:, 1:seq + 1].copy()).to(dev)}
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        batch_d["frontend_embeds"] = torch.zeros(
            (batch, cfg.frontend.num_tokens, cfg.d_model), device=dev)
    if cfg.encoder is not None:
        batch_d["frames"] = torch.from_numpy(
            (rng.normal(size=(batch, cfg.encoder.num_positions,
                              cfg.d_model)) * 0.02).astype(np.float32)
        ).to(dev)
    return batch_d


def main(argv=None):
    """Run the training; returns the trained ``(params, opt, metrics)`` of
    the last step (for callers in the same process)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = small_100m(get_config(args.arch))
    n_params = cfg.param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"layers={cfg.num_layers} d_model={cfg.d_model}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params, opt = init_train_state(cfg, gen, device=dev)
    start = 0
    if args.resume:
        params, opt, start = restore_checkpoint(args.resume, params, opt)
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, lr=args.lr)
    rng = np.random.default_rng(args.seed)
    metrics = None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic_batch(rng, cfg, args.batch, args.seq, dev)
        params, opt, metrics = step_fn(params, opt, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            toks = args.batch * args.seq * (step + 1 - start)
            print(f"step {step:4d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"tok/s {toks/(time.time()-t0):8.0f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt, args.steps)
        print(f"saved {args.checkpoint}")
    print(f"final loss {float(metrics['loss']):.4f} "
          f"(uniform = {np.log(cfg.vocab_size):.2f})")
    return params, opt, metrics


if __name__ == "__main__":
    main()
