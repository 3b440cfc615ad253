"""Canonical BatchPlan trace capture for scheduler-equivalence tests.

The hot-path refactor (docs/perf.md) promises *bit-identical* scheduling:
with execution noise off, the vectorized scheduler must produce exactly
the BatchPlan sequence the scalar reference produced. This module defines
the canonical, order-preserving serialization of a plan (floats rendered
via ``float.hex`` so the comparison really is bit-level), a scheduler
wrapper that records one line per ``schedule()`` call, and the two fixed
workload scenarios the golden regression test locks down.

The port's traces are held to the JAX package's recorded fixture
(``tests/data/golden_traces.json``), which the port never rewrites. To
write the port's own fixture for a comparison, name a directory:

    PYTHONPATH=src python -m repro_torch.sim.trace /tmp/port_traces
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

from repro_torch.core.scheduler import BatchPlan


def plan_line(now: float, plan: BatchPlan) -> str:
    """One canonical line per scheduling decision. Order-preserving (batch
    composition order feeds the cost model) and bit-exact (hex floats)."""
    d = ",".join(str(r.rid) for r in plan.decode)
    p = ",".join(f"{r.rid}:{c}" for r, c in plan.prefill)
    rel = ",".join(str(r.rid) for r in plan.relegate)
    res = ",".join(str(r.rid) for r in plan.resume)
    return (f"{float(now).hex()}|d={d}|p={p}|rel={rel}|res={res}"
            f"|t={float(plan.predicted_time).hex()}"
            f"|sw={float(plan.swap_bytes).hex()}")


def trace_digest(lines: List[str]) -> str:
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


class TraceRecorder:
    """Transparent scheduler wrapper that appends one canonical line per
    ``schedule()`` call. Delegates everything else (``cfg``, ``cost``,
    ``est``...) so replicas and the fleet controller see the scheduler
    they expect."""

    def __init__(self, inner):
        self.inner = inner
        self.lines: List[str] = []

    def schedule(self, now, view):
        plan = self.inner.schedule(now, view)
        self.lines.append(plan_line(now, plan))
        return plan

    def on_finish(self, req) -> None:
        self.inner.on_finish(req)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ---------------------------------------------------------------------
# Golden scenarios (fixed seeds, noise OFF so the oracle equals the
# scheduler's own cost model and virtual time is fully deterministic)
# ---------------------------------------------------------------------

def golden_solo_trace() -> List[str]:
    """Single overloaded Niyama replica: exercises dynamic chunking,
    hybrid prioritization, eager relegation, and relegated resume."""
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.data.workloads import paper_workload
    from repro_torch.serving.schemes import make_replica

    reqs = paper_workload("azure_code", qps=5.0, duration=40.0, seed=7,
                          important_frac=0.7)
    rep = make_replica("niyama", LLAMA3_8B, seed=7, sim_noise=0.0)
    rec = TraceRecorder(rep.scheduler)
    rep.scheduler = rec
    rep.submit_all(reqs)
    rep.run(until=200.0)
    return rec.lines


def golden_fleet_trace() -> Dict[str, List[str]]:
    """Two-replica online fleet at the capacity edge: slack routing plus
    relegation offload and queued-prefill migration, so the recorded plans
    also lock the snapshot/backlog values the controller decides on."""
    import numpy as np

    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.data.workloads import DATASETS, diurnal_arrivals, \
        make_requests
    from repro_torch.serving.schemes import make_fleet, run_fleet_workload

    rng = np.random.default_rng(3)
    arr = diurnal_arrivals(rng, 4.0, 12.0, period=20.0, duration=40.0)
    reqs = make_requests(DATASETS["azure_code"], arr, rng,
                         tier_probs=[0.6, 0.25, 0.15], important_frac=0.6)
    fleet = make_fleet(LLAMA3_8B, 2, policy="slack", seed=3, sim_noise=0.0)
    recs = []
    for rep in fleet.replicas:
        rec = TraceRecorder(rep.scheduler)
        rep.scheduler = rec
        recs.append(rec)
    run_fleet_workload(fleet, reqs, until=200.0, duration=40.0)
    return {f"replica{i}": rec.lines for i, rec in enumerate(recs)}


def golden_fixture() -> Dict:
    """The full fixture dict the regression test compares against."""
    solo = golden_solo_trace()
    fleet = golden_fleet_trace()
    fix: Dict = {"solo": {"n_plans": len(solo),
                          "sha256": trace_digest(solo),
                          "head": solo[:3], "tail": solo[-3:]}}
    for name, lines in fleet.items():
        fix[f"fleet_{name}"] = {"n_plans": len(lines),
                                "sha256": trace_digest(lines),
                                "head": lines[:3], "tail": lines[-3:]}
    return fix


if __name__ == "__main__":
    import json
    import pathlib
    import sys

    if len(sys.argv) != 2:
        sys.exit("usage: python -m repro_torch.sim.trace OUT_DIR")
    out_dir = pathlib.Path(sys.argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "golden_traces.json"
    fix = golden_fixture()
    path.write_text(json.dumps(fix, indent=2) + "\n")
    for k, v in fix.items():
        print(f"{k}: {v['n_plans']} plans sha256={v['sha256'][:16]}...")
    print(f"wrote {path}")
