"""Cluster deployments: shared co-scheduling vs siloed per-tier fleets
(paper §2.2/§4 baselines), plus the capacity-search used for Fig 7a.

This module is now a thin compatibility shim over the fleet runtime
(serving/fleet/): ``Cluster`` wraps a ``FleetController`` configured for
the legacy *offline* deployment — one-shot JSQ dispatch before anything
runs, no cross-replica decisions. The online deployment (dynamic routing,
relegation offload, migration) lives in ``FleetController`` directly; see
``repro_torch.serving.schemes.make_fleet`` and docs/fleet.md.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.request import Request
from repro_torch.serving.fleet.controller import FleetController
from repro_torch.serving.metrics import MetricsReport, compute_metrics
from repro_torch.serving.replica import Replica

ReplicaFactory = Callable[[int], Replica]   # rid -> fresh replica


@dataclass
class Cluster:
    """A pool of replicas with one-shot join-shortest-queue dispatch.
    ``route`` optionally maps a request to a subset of replicas (silo
    partitioning). Shim over :class:`FleetController` with every dynamic
    feature disabled (offline routing, no offload, no migration)."""
    replicas: List[Replica]
    route: Optional[Callable[[Request], Sequence[int]]] = None
    _fleet: FleetController = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._fleet = FleetController(self.replicas, router=None,
                                      offload=False, migrate=False,
                                      allowed=self.route)

    def dispatch(self, requests: Sequence[Request]) -> None:
        self._fleet.dispatch(requests, route=self.route)

    def run(self, until: Optional[float] = None) -> None:
        self._fleet.run(until=until)

    def finished(self) -> List[Request]:
        """All requests the cluster was responsible for: finished plus any
        still queued, relegated, or — previously undercounted — never even
        admitted from the intake heap before the ``until`` cutoff. The
        stragglers count against unfinished_frac / SLO violations."""
        return self._fleet.all_requests()


def make_shared_cluster(n: int, factory: ReplicaFactory) -> Cluster:
    return Cluster([factory(i) for i in range(n)])


def make_silo_cluster(per_tier: Dict[str, int],
                      factory_for_tier: Callable[[str, int], Replica]
                      ) -> Cluster:
    """One replica group per QoS tier (the SOTA siloed deployment)."""
    replicas: List[Replica] = []
    groups: Dict[str, List[int]] = {}
    i = 0
    for tier, count in per_tier.items():
        groups[tier] = []
        for _ in range(count):
            replicas.append(factory_for_tier(tier, i))
            groups[tier].append(i)
            i += 1
    return Cluster(replicas, route=lambda r: groups[r.qos.name])


def run_workload(factory: ReplicaFactory, requests: Sequence[Request],
                 n_replicas: int = 1, until: Optional[float] = None,
                 long_threshold: Optional[int] = None) -> MetricsReport:
    cluster = make_shared_cluster(n_replicas, factory)
    cluster.dispatch(requests)
    cluster.run(until=until)
    dur = max((r.arrival for r in requests), default=0.0)
    return compute_metrics(cluster.finished(), duration=max(dur, 1e-9),
                           long_p90_threshold=long_threshold)


def find_capacity(run_at_qps: Callable[[float], MetricsReport],
                  lo: float = 0.25, hi: float = 16.0,
                  violation_budget: float = 0.01, iters: int = 7,
                  hi_max: float = 24.0) -> float:
    """Max sustainable QPS with <= ``violation_budget`` SLO violations
    (paper §4.1 serving-throughput-per-replica definition). Bisection."""
    def ok(q: float) -> bool:
        return run_at_qps(q).violation_frac <= violation_budget

    if not ok(lo):
        return 0.0
    while ok(hi) and hi < hi_max:
        lo, hi = hi, hi * 2
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo
