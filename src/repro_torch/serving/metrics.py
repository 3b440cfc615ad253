"""Outcome metrics: latency percentiles, SLO violations (overall / per tier /
by importance / by request length), goodput — the quantities of paper
Figs 7-11 and Table 3."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request

if TYPE_CHECKING:
    from repro_torch.serving.fleet.telemetry import FleetReport


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


@dataclass
class MetricsReport:
    n: int = 0
    duration: float = 0.0
    ttft_p50: float = 0.0
    ttft_p95: float = 0.0
    ttft_p99: float = 0.0
    ttlt_p50: float = 0.0
    ttlt_p95: float = 0.0
    tbt_p99: float = 0.0
    violation_frac: float = 0.0
    tbt_violation_frac: float = 0.0
    violation_by_tier: Dict[str, float] = field(default_factory=dict)
    violation_important: float = 0.0
    violation_long: float = 0.0
    violation_short: float = 0.0
    relegated_frac: float = 0.0
    relegated_total: int = 0      # requests relegated at least once
    migrated_frac: float = 0.0    # re-homed across replicas (fleet layer)
    migrations_total: int = 0     # sum of per-request re-homing hops
    unfinished_frac: float = 0.0
    goodput: float = 0.0          # requests/s finished within SLO
    throughput_tok: float = 0.0   # output tokens/s
    # SLO-violation attribution
    # (repro_torch.obs.attribution.annotate_report): fraction of violated
    # requests with a dominant cause, and the dominant-cause histogram
    # over them
    attributed_frac: float = 0.0
    violation_causes: Dict[str, int] = field(default_factory=dict)
    fleet: Optional["FleetReport"] = None   # fleet-level telemetry, if any

    def row(self) -> Dict[str, float]:
        d = {k: v for k, v in self.__dict__.items()
             if isinstance(v, (int, float))}
        for t, v in self.violation_by_tier.items():
            d[f"viol_{t}"] = v
        for c, v in self.violation_causes.items():
            d[f"cause_{c}"] = v
        if self.fleet is not None:
            # namespace the fleet keys: a FleetReport field sharing a name
            # with a top-level metric must not silently overwrite it
            # (FleetReport.row() already emits fleet_*, but a subclass or
            # future field is not trusted to remember)
            for k, v in self.fleet.row().items():
                d[k if k.startswith("fleet_") else f"fleet_{k}"] = v
        return d


def compute_metrics(requests: Sequence[Request], duration: float,
                    long_p90_threshold: Optional[int] = None,
                    fleet: Optional["FleetReport"] = None
                    ) -> MetricsReport:
    reqs = list(requests)
    r = MetricsReport(n=len(reqs), duration=duration, fleet=fleet)
    if not reqs:
        return r
    if long_p90_threshold is None:
        long_p90_threshold = int(np.percentile(
            [q.prompt_len for q in reqs], 90))

    ttfts = [q.ttft() for q in reqs if q.ttft() is not None]
    ttlts = [q.ttlt() for q in reqs if q.ttlt() is not None]
    tbts = [d for q in reqs for d in q.tbts()]
    r.ttft_p50, r.ttft_p95, r.ttft_p99 = (_pct(ttfts, 50), _pct(ttfts, 95),
                                          _pct(ttfts, 99))
    r.ttlt_p50, r.ttlt_p95 = _pct(ttlts, 50), _pct(ttlts, 95)
    r.tbt_p99 = _pct(tbts, 99)

    viol = [q.violated() for q in reqs]
    r.violation_frac = float(np.mean(viol))
    n_tbt = sum(q.tbt_violations() for q in reqs)
    r.tbt_violation_frac = n_tbt / max(1, len(tbts))
    for tier in sorted({q.qos.name for q in reqs}):
        sel = [q.violated() for q in reqs if q.qos.name == tier]
        r.violation_by_tier[tier] = float(np.mean(sel))
    imp = [q.violated() for q in reqs if q.important]
    r.violation_important = float(np.mean(imp)) if imp else 0.0
    lng = [q.violated() for q in reqs if q.prompt_len >= long_p90_threshold]
    sht = [q.violated() for q in reqs if q.prompt_len < long_p90_threshold]
    r.violation_long = float(np.mean(lng)) if lng else 0.0
    r.violation_short = float(np.mean(sht)) if sht else 0.0
    r.relegated_frac = float(np.mean([q.was_relegated for q in reqs]))
    r.relegated_total = int(sum(bool(q.was_relegated) for q in reqs))
    r.migrated_frac = float(np.mean([q.migrations > 0 for q in reqs]))
    r.migrations_total = int(sum(q.migrations for q in reqs))
    r.unfinished_frac = float(np.mean([q.finish_time is None for q in reqs]))
    ok = sum(1 for q in reqs if q.finish_time is not None and not q.violated())
    r.goodput = ok / max(1e-9, duration)
    r.throughput_tok = (sum(q.decoded for q in reqs) / max(1e-9, duration))
    return r
