"""Capacity planning (paper Fig 7a): how many GPUs does a 50 QPS
three-tier workload need under (a) siloed per-tier fleets vs (b) Niyama
co-scheduling on a shared cluster?

The twin of ``examples/capacity_planning.py`` on ``repro_torch``, with
its own copy of the capacity search that the JAX example imports from
the benchmark helpers (``benchmarks/common.py::capacity_qps``).

  PYTHONPATH=src python examples/torch/capacity_planning.py \
      [--dataset sharegpt]
"""
import argparse
import math

import numpy as np

from repro_torch.configs.paper_models import LLAMA3_8B
from repro_torch.core.qos import PAPER_TIERS
from repro_torch.data.workloads import (DATASETS, make_requests,
                                        poisson_arrivals)
from repro_torch.serving.cluster import find_capacity
from repro_torch.serving.metrics import compute_metrics
from repro_torch.serving.schemes import make_replica

TARGET = 50.0


def capacity_qps(scheme: str, dataset: str, duration: float = 200.0,
                 seed: int = 11, budget: float = 0.01, tiers=None) -> float:
    """Max QPS of one simulated llama3-8b replica at <=1% violations (the
    paper's serving-capacity definition)."""
    ds = DATASETS[dataset]

    def runner(qps: float):
        rng = np.random.default_rng(seed)
        arr = poisson_arrivals(rng, qps, duration)
        reqs = make_requests(ds, arr, rng, tiers=tiers or PAPER_TIERS)
        rep = make_replica(scheme, LLAMA3_8B, seed=seed)
        rep.submit_all(reqs)
        rep.run(until=duration * 20.0)
        return compute_metrics(rep.all_requests(), duration,
                               long_p90_threshold=ds.long_threshold())

    return find_capacity(runner, lo=0.25, hi=4.0, violation_budget=budget,
                         iters=4)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="azure_code",
                    choices=["azure_code", "azure_conv", "sharegpt"])
    ap.add_argument("--duration", type=float, default=150.0)
    args = ap.parse_args()

    print(f"dataset={args.dataset}, target load {TARGET} QPS across "
          f"{len(PAPER_TIERS)} equal QoS tiers\n")

    # siloed: each tier on its own Sarathi fleet
    silo_total = 0
    for tier in PAPER_TIERS:
        cap = capacity_qps("sarathi-fcfs", args.dataset,
                           duration=args.duration, tiers=(tier,))
        n = math.ceil((TARGET / 3) / max(cap, 1e-3))
        silo_total += n
        print(f"  silo {tier.name}: {cap:5.2f} QPS/replica "
              f"-> {n} GPUs for {TARGET/3:.1f} QPS")

    cap_n = capacity_qps("niyama", args.dataset, duration=args.duration)
    n_niyama = math.ceil(TARGET / max(cap_n, 1e-3))
    print(f"\n  siloed total:        {silo_total} GPUs")
    print(f"  niyama (shared):     {n_niyama} GPUs "
          f"({cap_n:.2f} QPS/replica)")
    red = 1 - n_niyama / silo_total
    print(f"  reduction:           {red:.0%}  (paper reports 13-32%)")


if __name__ == "__main__":
    main()
