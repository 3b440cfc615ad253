"""Dynamic request routing over live fleet state.

Three online policies (picked per-arrival at the tick barrier, using only
barrier snapshots — never another replica's future):

  jsq    — join-shortest-queue over live *seconds of backlog* (not the
           offline expected-token counter the legacy Cluster used)
  tier   — JSQ plus an interactive-spreading penalty: interactive arrivals
           avoid replicas already deep in interactive work, so one replica's
           TTFT queue never becomes the fleet's head-of-line block
  slack  — predicted-slack-aware: estimate, per replica, when this request
           would produce first progress (live backlog + its own prefill cost
           from that replica's ModelCostModel), drop replicas that would
           already miss the deadline, then take the earliest predicted
           progress (on a homogeneous balanced fleet: JSQ + own cost)

``offline_jsq`` is the legacy one-shot dispatch (expected work =
prompt + 4*decode ground-truth tokens) kept verbatim for the
serving/cluster.py compatibility shim.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.reqtable import prefill_est_cached
from repro_torch.core.request import Request
from repro_torch.serving.fleet.telemetry import ReplicaSnapshot, replica_cost
from repro_torch.serving.replica import Replica

# seconds of penalty per already-queued interactive request (tier policy)
TIER_SPREAD_W = 0.05

PolicyFn = Callable[["Router", Request, Sequence[ReplicaSnapshot],
                     Sequence[int]], int]


def _jsq(router: "Router", req: Request,
         snaps: Sequence[ReplicaSnapshot], idxs: Sequence[int]) -> int:
    return min(idxs, key=lambda i: (snaps[i].load_s, i))


def _tier(router: "Router", req: Request,
          snaps: Sequence[ReplicaSnapshot], idxs: Sequence[int]) -> int:
    def score(i: int) -> float:
        s = snaps[i].load_s
        if req.qos.interactive:
            s += TIER_SPREAD_W * router.n_interactive[i]
        return s
    return min(idxs, key=lambda i: (score(i), i))


def _slack(router: "Router", req: Request,
           snaps: Sequence[ReplicaSnapshot], idxs: Sequence[int]) -> int:
    deadline = req.deadline_first()

    def done(i: int) -> float:
        """Predicted first-progress completion on replica i: live backlog
        plus this request's own prefill cost from i's ModelCostModel."""
        start = max(snaps[i].now, req.arrival)
        return start + snaps[i].load_s + router.prefill_est(i, req)

    # restrict to replicas predicted to still meet the deadline (bites on
    # heterogeneous or heavily skewed fleets — a lightly-loaded-but-slow
    # replica gets skipped); among those, or among all when the deadline
    # is unreachable everywhere, take the earliest predicted progress.
    # On a homogeneous balanced fleet this reduces to JSQ + own cost.
    feasible = [i for i in idxs if done(i) <= deadline]
    pool = feasible or list(idxs)
    return min(pool, key=lambda i: (done(i), i))


POLICIES: Dict[str, PolicyFn] = {
    "jsq": _jsq,
    "tier": _tier,
    "slack": _slack,
}


class Router:
    """Pluggable per-arrival routing over barrier snapshots.

    The router mutates its snapshot view as it assigns (``backlog_s`` grows
    by the routed request's prefill estimate) so a burst arriving within one
    tick spreads instead of dog-piling the momentarily-least-loaded replica.
    """

    def __init__(self, replicas: Sequence[Replica], policy: str = "jsq",
                 allowed: Optional[Callable[[Request], Sequence[int]]] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"choose from {sorted(POLICIES)}")
        self.replicas = list(replicas)
        self.policy = policy
        self._fn = POLICIES[policy]
        self.allowed = allowed
        self.n_interactive: List[int] = [0] * len(self.replicas)

    def prefill_est(self, i: int, req: Request) -> float:
        cost = replica_cost(self.replicas[i])
        if cost is None:
            return req.prefill_remaining / 4096.0
        return prefill_est_cached(cost, req)

    def begin_tick(self) -> None:
        """Refresh per-tick routing state. Replicas are paused at the
        barrier when this runs, so reading their queues IS barrier state."""
        self.n_interactive = [
            sum(1 for r in rep.prefill_queue if r.qos.interactive)
            + sum(1 for r in rep.unadmitted if r.qos.interactive)
            for rep in self.replicas]

    def choose(self, req: Request,
               snaps: Sequence[ReplicaSnapshot]) -> int:
        idxs = list(self.allowed(req)) if self.allowed is not None \
            else list(range(len(self.replicas)))
        if not idxs:
            raise ValueError(
                f"no replica may serve request {req.rid} "
                f"(tier {req.qos.name}): routing constraint is empty")
        i = self._fn(self, req, snaps, idxs)
        # incremental accounting so same-tick arrivals spread
        snaps[i].backlog_s += self.prefill_est(i, req)
        snaps[i].n_queued += 1
        if req.qos.interactive:
            self.n_interactive[i] += 1
        return i


def offline_jsq(requests: Sequence[Request], n_replicas: int,
                route: Optional[Callable[[Request], Sequence[int]]] = None
                ) -> List[int]:
    """Legacy one-shot dispatch: JSQ over *expected* work (queued prompt
    tokens + 4x decode tokens), assigned in arrival order before anything
    runs. Returns the replica index per request (in the given order)."""
    load = [0.0] * n_replicas
    order = sorted(range(len(requests)), key=lambda k: requests[k].arrival)
    assign = [0] * len(requests)
    for k in order:
        req = requests[k]
        idxs = list(route(req)) if route is not None else range(n_replicas)
        if not idxs:
            raise ValueError(
                f"no replica may serve request {req.rid} "
                f"(tier {req.qos.name}): routing constraint is empty")
        best = min(idxs, key=lambda i: load[i])
        assign[k] = best
        load[best] += req.prompt_len + 4 * req.decode_len
    return assign
