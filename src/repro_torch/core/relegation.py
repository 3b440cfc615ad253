"""Eager relegation + violation checking (paper §3.4, Fig 5).

A request is a relegation victim when it has already violated its
TTFT/TTLT deadline or provably will (its best-case completion estimate
exceeds the deadline). Application hints order victims: low-priority
(free-tier) requests are relegated first — including preemptively under
overload — while important requests are only relegated once actually
violating, preventing cascading deadline violations for the majority.
Relegated requests are NOT dropped: they are served opportunistically when
load subsides (serving/replica.py re-admits them at lowest priority).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .predictor import DecodeLengthEstimator, ModelCostModel
from .reqtable import RequestTable
from .request import Request


@dataclass
class ViolationVerdict:
    violated: bool        # deadline already passed
    will_violate: bool    # best-case completion exceeds deadline
    est_completion: float


def check_first_token(req: Request, now: float, cost: ModelCostModel
                      ) -> ViolationVerdict:
    """Can this (queued / partially prefilled) request still meet its
    first-progress deadline? Best case: it runs alone starting now.
    (Host-swapped requests never reach these checks: they are
    was_relegated and exempt from re-relegation, so their swap-in cost
    is priced via BatchPlanCost.swap_bytes instead.)"""
    d = req.deadline_first()
    est = now + cost.prefill_time_estimate(req.prefill_remaining,
                                           req.prefilled)
    return ViolationVerdict(violated=now > d, will_violate=est > d,
                            est_completion=est)


def check_total(req: Request, now: float, cost: ModelCostModel,
                est: DecodeLengthEstimator) -> ViolationVerdict:
    d = req.deadline_total()
    dec_rem = max(0.0, est.estimate(req.app_id) - req.decoded)
    t = (cost.prefill_time_estimate(req.prefill_remaining, req.prefilled)
         + cost.decode_time_estimate(int(dec_rem), req.prompt_len))
    return ViolationVerdict(violated=now > d, will_violate=now + t > d,
                            est_completion=now + t)


class RelegationPolicy:
    """Decides, per scheduling iteration, which prefill-phase requests to
    move to the relegated queue. Decode-phase requests are never relegated
    (mirrors the paper's no-decode-preemption rule, §3.4)."""

    def __init__(self, enabled: bool = True, use_hints: bool = True):
        self.enabled = enabled
        self.use_hints = use_hints

    def pick_victims(self, candidates: Sequence[Request], now: float,
                     cost: ModelCostModel, est: DecodeLengthEstimator,
                     overloaded: bool) -> List[Request]:
        if not self.enabled:
            return []
        low: List[Request] = []
        hi_violated: List[Request] = []
        hi_predicted: List[Request] = []
        for req in candidates:
            if req.was_relegated:
                # already degraded once: serve to eventual completion,
                # never bounce back to the relegated queue (would livelock)
                continue
            v = (check_first_token(req, now, cost) if req.qos.interactive
                 else check_total(req, now, cost, est))
            if not (v.violated or v.will_violate):
                continue
            if self.use_hints and not req.important:
                low.append(req)          # free tier: eager on prediction
            elif v.violated:
                hi_violated.append(req)  # lost already: prevent cascade
            elif overloaded:
                hi_predicted.append(req)
        # paper §3.4: low-priority first; important predicted-violators are
        # only relegated when there are no more low-priority victims
        victims = low + hi_violated
        if not low:
            victims += hi_predicted
        return victims

    def pick_victims_idx(self, table: RequestTable, now: float,
                         overloaded: bool) -> np.ndarray:
        """Vectorized ``pick_victims`` over a request table: numpy-batched
        violation verdicts (the ``check_first_token`` / ``check_total``
        comparisons element-wise, same float ops) and the same hint-aware
        victim partition. Returns candidate indices; element-wise
        equivalence with the scalar path is property-tested."""
        if not self.enabled or table.n == 0:
            return np.empty(0, dtype=np.int64)
        # interactive deadline_first == non-interactive deadline_total, so
        # one deadline column serves both verdict flavours
        d = table.deadline_first
        violated = now > d
        # best-case completion starting now: the table's work column is
        # remaining prefill (+ estimated decode for non-interactive)
        will = now + table.work > d
        bad = (violated | will) & ~table.was_relegated
        if not bad.any():
            return np.empty(0, dtype=np.int64)
        if self.use_hints:
            low = bad & ~table.important
            hi_violated = bad & table.important & violated
            hi_predicted = bad & table.important & ~violated
        else:
            low = np.zeros(table.n, dtype=bool)
            hi_violated = bad & violated
            hi_predicted = bad & ~violated
        low_idx = np.flatnonzero(low)
        out = [low_idx, np.flatnonzero(hi_violated)]
        if overloaded and low_idx.size == 0:
            out.append(np.flatnonzero(hi_predicted))
        return np.concatenate(out)
