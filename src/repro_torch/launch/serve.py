"""The serve script of the port: the Niyama stack end to end on PyTorch.

The counterpart of the JAX package's ``launch/serve.py --backend jax``
single-replica path: the same request mix, the same scheduler and
replica, served by ``TorchEngine`` through ``make_torch_replica``. On
the card (the default) it serves the full configuration with the
NiyamaScheduler priced on the ``H100`` spec; ``--reduced`` gives the JAX
serve script's ``.reduced(num_layers=2, d_model=256)`` model, for CPU runs.
``--arch`` picks the architecture from the port's registry
(``repro_torch.configs``): ``llama3.2-3b`` (the default),
``mamba2-370m``, the MoE decoders ``qwen3-moe-30b-a3b`` and
``dbrx-132b``, the hybrid ``jamba-v0.1-52b``, ``granite-8b``,
``starcoder2-15b`` or the sliding-window decoder ``gemma3-4b``.
``--prefix-cache`` gives the replica the KV hierarchy's shared-prefix
tier, as in the JAX serve script.

  PYTHONPATH=src python -m repro_torch.launch.serve --dtype bf16 \
      --n-requests 12 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --dtype bf16 --n-requests 12 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch qwen3-moe-30b-a3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --dtype bf16 --n-requests 12 --max-len 2048
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.predictor import H100
from repro_torch.core.request import Request
from repro_torch.device import resolve_device
from repro_torch.serving.kvcache import KVCacheConfig
from repro_torch.serving.metrics import compute_metrics
from repro_torch.serving.schemes import CPU_HW, CPU_TIERS, make_torch_replica

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_requests(rng: np.random.Generator, n: int, max_len: int):
    """The JAX serve script's request mix: arrivals spread over ``n``
    seconds, prompts of 32 .. max_len/2 tokens, 4 .. 23 output tokens,
    the three tiers in turn, every fifth request unimportant."""
    reqs = []
    arr = np.sort(rng.uniform(0, n * 1.0, n))
    for i, t in enumerate(arr):
        q = CPU_TIERS[i % 3]
        reqs.append(Request(
            rid=i, arrival=float(t),
            prompt_len=int(rng.integers(32, max_len // 2)),
            decode_len=int(rng.integers(4, 24)), qos=q,
            app_id=q.name, important=bool(i % 5)))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="an architecture of repro_torch.configs")
    ap.add_argument("--scheme", default="niyama")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                    help="weights and KV pages; bf16 is the serving type "
                         "on the card")
    ap.add_argument("--reduced", action="store_true",
                    help="serve .reduced(num_layers=2, d_model=256)")
    ap.add_argument("--block-size", type=int, default=64,
                    help="tokens per KV block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="physical blocks in the pool (default: enough "
                         "for every slot at max-len)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the shared-prefix KV cache tier on the "
                         "engine's pages")
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=2, d_model=256)
    rng = np.random.default_rng(args.seed)
    rep = make_torch_replica(
        args.scheme, cfg, n_slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, kv_blocks=args.kv_blocks,
        seed=args.seed, hw=H100 if device.type == "cuda" else CPU_HW,
        device=device, dtype=DTYPES[args.dtype],
        kv_cfg=(KVCacheConfig(enable_prefix=True) if args.prefix_cache
                else None))
    reqs = make_requests(rng, args.n_requests, args.max_len)
    # build and load the kernels and run one iteration at the model's
    # shapes before the clock starts, so no request pays for the set-up
    rep.backend.warm()
    # arrivals in virtual time; each iteration advances it by its
    # measured wall-clock time
    rep.submit_all(reqs)
    rep.run()
    dur = rep.now

    m = compute_metrics(rep.all_requests(), dur)
    print(f"\nscheme={args.scheme} device={device} dtype={args.dtype} "
          f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model}")
    print(f"  served {len(rep.finished)}/{m.n} requests in {dur:.1f}s "
          f"({rep.iterations} iterations)")
    print(f"  TTFT p50/p99: {m.ttft_p50:.2f}/{m.ttft_p99:.2f}s  "
          f"TBT p99: {m.tbt_p99*1e3:.0f}ms")
    print(f"  SLO violations: {m.violation_frac:.1%} "
          f"(by tier: {m.violation_by_tier})")
    print(f"  goodput: {m.goodput:.2f} req/s  "
          f"throughput: {m.throughput_tok:.1f} tok/s  "
          f"relegated: {m.relegated_frac:.1%}")
    print(f"  kv pool: {rep.kv.num_blocks} blocks x {rep.kv.block_size} "
          f"tokens, util {rep.kv.utilization():.0%} at exit")
    some = {k: v[:8] for k, v in list(rep.backend.generated.items())[:3]}
    print(f"  sample generations (token ids): {some}")
    return rep


if __name__ == "__main__":
    main()
