"""END-TO-END example of the PyTorch port: serve a real (reduced) model
with batched requests through the full Niyama stack — actual torch
forward passes (on the card by default, ``--device cpu`` on the host),
the engine's KV cache, chunked prefills picked by hybrid prioritization,
chunk sizes solved by dynamic chunking, real wall-clock latencies.

The twin of ``examples/multi_qos_serving.py`` on ``repro_torch``. Also
verifies the served generations against a straight greedy decode with
the same weights through the port's offline ``prefill`` /
``decode_step`` (the engine must be token-identical to offline
inference).

  PYTHONPATH=src python examples/torch/multi_qos_serving.py [--arch gemma3-4b]
  PYTHONPATH=src python examples/torch/multi_qos_serving.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import QoSSpec, Request
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.serving.metrics import compute_metrics
from repro_torch.serving.schemes import make_torch_replica

CHAT = QoSSpec("chat", interactive=True, ttft_slo=30.0, tbt_slo=3.0)
BULK = QoSSpec("bulk", interactive=False, ttlt_slo=300.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--n-requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--engine", choices=["fused", "reference"],
                    default="fused")
    ap.add_argument("--kv-layout", choices=["paged", "dense"],
                    default="paged")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced(num_layers=2, d_model=256)
    print(f"serving {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.slots} cache slots, {args.engine} engine "
          f"({args.kv_layout} KV) on {args.device}")
    # the same factory launch/serve.py uses: scheduler + paged KV pool +
    # real engine, constructed identically to the production serve script
    replica = make_torch_replica("niyama", cfg, engine=args.engine,
                                 kv_layout=args.kv_layout,
                                 n_slots=args.slots, max_len=256, seed=3,
                                 device=args.device)
    engine = replica.backend
    dev = engine.device

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.n_requests):
        qos = CHAT if i % 2 == 0 else BULK
        reqs.append(Request(
            rid=i, arrival=float(i) * 0.6,
            prompt_len=int(rng.integers(40, 100)),
            decode_len=int(rng.integers(5, 15)),
            qos=qos, app_id=qos.name, important=(i % 4 != 0)))
    replica.submit_all(reqs)
    replica.run()

    m = compute_metrics(replica.finished, duration=replica.now)
    print(f"finished {len(replica.finished)}/{len(reqs)} in "
          f"{replica.now:.1f}s wall, {replica.iterations} iterations")
    print(f"TTFT p50 {m.ttft_p50:.2f}s  TBT p99 {m.tbt_p99*1e3:.0f}ms  "
          f"violations {m.violation_frac:.0%}")

    # --- verify generations against offline greedy decode -----------------
    print("verifying served tokens == offline greedy decode ...")
    i32 = dict(dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for r in reqs[:4]:
            prompt = engine.tokens[r.rid]
            cache = init_cache(cfg, 1, 256, dtype=torch.float32, chunk=256,
                               device=dev)
            lg, cache = prefill(engine.params, cfg, cache,
                                torch.as_tensor(prompt, **i32)[None],
                                torch.zeros((1,), **i32))
            toks = [int(torch.argmax(lg[0, -1, :cfg.vocab_size]))]
            for _ in range(r.decode_len - 1):
                lg, cache = decode_step(engine.params, cfg, cache,
                                        torch.tensor([[toks[-1]]], **i32))
                toks.append(int(torch.argmax(lg[0, 0, :cfg.vocab_size])))
            assert engine.generated[r.rid] == toks, \
                f"rid {r.rid}: {engine.generated[r.rid]} != {toks}"
            print(f"  rid {r.rid}: {toks[:6]}... OK")
    print("all verified — the scheduler machinery is transparent to "
          "model outputs")


if __name__ == "__main__":
    main()
