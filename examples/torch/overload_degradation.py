"""Graceful degradation under a traffic spike (paper §4.3, Figs 10/11).

A diurnal workload alternates 2 QPS / 6 QPS on one A100-class replica
(sim backend). Compare how Sarathi-FCFS, Sarathi-EDF and Niyama absorb the
bursts; Niyama relegates a small set of (preferentially free-tier) requests
and keeps every important request within SLO.

The twin of ``examples/overload_degradation.py`` on ``repro_torch``: the
same workload and table.

  PYTHONPATH=src python examples/torch/overload_degradation.py
"""
import numpy as np

from repro_torch.configs.paper_models import LLAMA3_8B
from repro_torch.core.qos import PAPER_TIERS
from repro_torch.data.workloads import (DATASETS, diurnal_arrivals,
                                        make_requests)
from repro_torch.serving.metrics import compute_metrics
from repro_torch.serving.schemes import make_replica

DURATION = 1800.0     # 30 min demo (paper runs 4 h)
PERIOD = 450.0


def run(scheme: str):
    rng = np.random.default_rng(42)
    ds = DATASETS["azure_code"]
    arr = diurnal_arrivals(rng, 2.0, 6.0, PERIOD, DURATION)
    reqs = make_requests(ds, arr, rng, tiers=PAPER_TIERS,
                         important_frac=0.8)
    rep = make_replica(scheme, LLAMA3_8B, seed=42)
    rep.submit_all(reqs)
    rep.run(until=DURATION * 3)
    allr = rep.all_requests()
    return compute_metrics(allr, DURATION,
                           long_p90_threshold=ds.long_threshold())


def main():
    print(f"{'scheme':14s} {'viol%':>7s} {'important%':>11s} "
          f"{'relegated%':>11s} {'p99 TTFT':>9s}")
    results = {}
    for scheme in ("sarathi-fcfs", "sarathi-edf", "niyama"):
        m = run(scheme)
        results[scheme] = m
        print(f"{scheme:14s} {m.violation_frac:7.1%} "
              f"{m.violation_important:11.1%} {m.relegated_frac:11.1%} "
              f"{m.ttft_p99:8.1f}s")
    ny, fc = results["niyama"], results["sarathi-fcfs"]
    assert ny.violation_frac < fc.violation_frac
    print(f"\nNiyama keeps {1-ny.violation_frac:.0%} of requests within "
          f"SLO during the bursts (FCFS: {1-fc.violation_frac:.0%}) by "
          f"relegating {ny.relegated_frac:.1%} of traffic — graceful "
          f"degradation instead of cascading violations.")


if __name__ == "__main__":
    main()
