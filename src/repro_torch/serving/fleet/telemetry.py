"""Fleet telemetry: per-replica snapshots taken at lockstep barriers, the
migration event log, and the aggregated ``FleetReport``.

Snapshots are the ONLY state the router and the migration policies may
read — they are captured at a barrier, so no global decision ever observes
one replica's future relative to another (the lockstep invariant tested in
tests/test_fleet.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.reqtable import (full_prefill_est_cached,
                                       prefill_est_cached)
from repro_torch.core.request import Phase, Request
from repro_torch.serving.replica import Replica

# nominal decode horizon (tokens) used to turn a decode batch into a
# seconds-of-load figure without reading ground-truth decode lengths
DECODE_HORIZON = 32


@dataclass
class ReplicaSnapshot:
    """Live state of one replica as seen at a barrier."""
    rid: int
    now: float
    backlog_s: float            # est. seconds of queued+running prefill work
    decode_s: float             # est. seconds to run the decode batch out
    n_queued: int               # prefill queue + not-yet-admitted intake
    n_decode: int
    n_relegated: int
    kv_util: float
    host_util: float = 0.0      # host swap-tier occupancy (KV hierarchy)
    prefix_hit_rate: float = 0.0   # token-weighted prefix-cache hit rate
    tier_mix: Dict[str, int] = field(default_factory=dict)

    @property
    def load_s(self) -> float:
        """Scalar load key used by JSQ-style comparisons."""
        return self.backlog_s + self.decode_s


@dataclass
class MigrationEvent:
    t: float                    # barrier time the decision was made
    rid: int                    # request id
    src: int                    # source replica
    dst: int                    # destination replica
    kind: str                   # "offload" | "offload-transfer" |
                                # "rebalance" | "live"


@dataclass
class FleetReport:
    """Aggregate fleet telemetry over one run (feeds MetricsReport.fleet)."""
    n_replicas: int = 0
    ticks: int = 0
    offloads: int = 0           # relegation offloads via recompute
    offload_transfers: int = 0  # relegation offloads via host-KV transfer
    rebalances: int = 0         # queued-prefill migrations
    live_migrations: int = 0    # in-flight decode KV-transfer migrations
    kv_moved_bytes: float = 0.0  # total KV bytes moved across the link
    peak_backlog_s: float = 0.0
    peak_kv_util: float = 0.0
    peak_host_util: float = 0.0
    mean_kv_util: float = 0.0
    prefix_hit_rate: float = 0.0       # fleet-mean token hit rate at drain
    backlog_imbalance_s: float = 0.0   # peak (max-min) backlog across replicas
    max_overshoot_s: float = 0.0       # furthest any replica ran past a
                                       # barrier (bounded by one iteration)
    iterations: int = 0
    busy_time: float = 0.0
    tier_mix: Dict[str, int] = field(default_factory=dict)
    events: List[MigrationEvent] = field(default_factory=list)

    @property
    def migrations(self) -> int:
        return (self.offloads + self.offload_transfers + self.rebalances
                + self.live_migrations)

    def row(self) -> Dict[str, float]:
        return {
            "fleet_replicas": self.n_replicas,
            "fleet_ticks": self.ticks,
            "fleet_offloads": self.offloads,
            "fleet_offload_transfers": self.offload_transfers,
            "fleet_rebalances": self.rebalances,
            "fleet_live_migrations": self.live_migrations,
            "fleet_kv_moved_gb": self.kv_moved_bytes / 1e9,
            "fleet_migrations": self.migrations,
            "fleet_peak_backlog_s": self.peak_backlog_s,
            "fleet_peak_kv_util": self.peak_kv_util,
            "fleet_peak_host_util": self.peak_host_util,
            "fleet_prefix_hit_rate": self.prefix_hit_rate,
            "fleet_imbalance_s": self.backlog_imbalance_s,
        }


def replica_cost(rep: Replica):
    """Both NiyamaScheduler and SarathiScheduler expose .cost; None for
    exotic schedulers (callers fall back to token-count heuristics)."""
    return getattr(rep.scheduler, "cost", None)


_cost_of = replica_cost   # backwards-compat alias


def prefill_seconds(rep: Replica, reqs: Sequence[Request]) -> float:
    cost = _cost_of(rep)
    if cost is None:
        # ~4k prefill tokens/s as a crude fallback
        return sum(r.prefill_remaining for r in reqs) / 4096.0
    return sum(prefill_est_cached(cost, r) for r in reqs)


def full_prefill_seconds(rep: Replica, req: Request) -> float:
    """Cost of prefilling ``req`` from zero on ``rep`` — the conservative
    estimate for a migration whose prefix-cache hits do not travel (the
    destination may re-hit its own cache, but that is not knowable at the
    decision barrier)."""
    cost = _cost_of(rep)
    if cost is None:
        return req.prompt_len / 4096.0
    return full_prefill_est_cached(cost, req)


def snapshot(rep: Replica) -> ReplicaSnapshot:
    """Barrier snapshot of one replica. Single fused pass over the queues
    (estimates come from the per-request caches); queued and intake
    backlogs accumulate separately and are then added, preserving the
    historical ``sum(queued) + sum(intake)`` float grouping."""
    cost = _cost_of(rep)
    ptab = getattr(rep.prefill_queue, "table", None) \
        if cost is not None else None
    synced = None
    if ptab is not None:
        # reuse the scheduler-maintained columns: refresh stale rows and
        # read the queue-order backlog sum and tier counts in O(changes)
        synced = ptab.sync(rep.prefill_queue,
                           cost, rep.scheduler.est) \
            if hasattr(rep.scheduler, "est") else None
    if synced is not None:
        n_queued = len(rep.prefill_queue)
        backlog_q = ptab.backlog_queued()
        mix = dict(ptab.tier_counts)
        tok_q = 0
    else:
        mix = {}
        n_queued = 0
        backlog_q = 0.0
        tok_q = 0
        for r in rep.prefill_queue:
            if r.phase is Phase.QUEUED or r.phase is Phase.PREFILL:
                n_queued += 1
                mix[r.qos.name] = mix.get(r.qos.name, 0) + 1
                if cost is not None:
                    backlog_q += prefill_est_cached(cost, r)
                else:
                    tok_q += r.prefill_remaining
    backlog_i = 0.0
    tok_i = 0
    for _, _, r in rep._arrivals:
        n_queued += 1
        mix[r.qos.name] = mix.get(r.qos.name, 0) + 1
        if cost is not None:
            backlog_i += prefill_est_cached(cost, r)
        else:
            tok_i += r.prefill_remaining
    if cost is None:
        backlog_q, backlog_i = tok_q / 4096.0, tok_i / 4096.0
    backlog = backlog_q + backlog_i
    dq = rep.decode_queue
    if dq and cost is not None:
        dtab = getattr(dq, "table", None)
        ctxs = dtab.ctx_view(len(dq)) if dtab is not None \
            else [r.total_len for r in dq]
        decode_s = DECODE_HORIZON * cost.decode_iteration_time(ctxs)
    else:
        decode_s = 0.0
    for r in dq:
        mix[r.qos.name] = mix.get(r.qos.name, 0) + 1
    host_util = (rep.kv.host_utilization()
                 if hasattr(rep.kv, "host_utilization") else 0.0)
    hit_rate = (rep.kv.prefix_hit_rate()
                if hasattr(rep.kv, "prefix_hit_rate") else 0.0)
    return ReplicaSnapshot(
        rid=rep.rid, now=rep.now, backlog_s=backlog, decode_s=decode_s,
        n_queued=n_queued, n_decode=len(dq),
        n_relegated=len(rep.relegated_queue),
        kv_util=rep.kv.utilization(), host_util=host_util,
        prefix_hit_rate=hit_rate, tier_mix=mix)
