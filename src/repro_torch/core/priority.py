"""Prioritization policies (paper §2.4, §3.4).

Every policy maps a request to a scalar key — LOWER runs first. The hybrid
policy (eqs 4-5) linearly interpolates between EDF (deadline term) and SRPF
(remaining-work term) via alpha; alpha can optionally adapt to load so the
scheduler behaves like EDF at low load and like SRPF under overload (§4.2).

The scalar functions are the reference semantics (and the property-test
oracle); the scheduler's hot path evaluates the same keys in one shot via
``hybrid_keys`` over a ``reqtable.RequestTable`` — element-wise identical
by construction (same float op order — see docs/perf.md).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .predictor import DecodeLengthEstimator, ModelCostModel
from .reqtable import RequestTable
from .request import Request


def fcfs_key(req: Request, now: float, cost: ModelCostModel,
             est: DecodeLengthEstimator) -> float:
    return req.arrival


def edf_key(req: Request, now: float, cost: ModelCostModel,
            est: DecodeLengthEstimator) -> float:
    return req.deadline_first()


def sjf_key(req: Request, now: float, cost: ModelCostModel,
            est: DecodeLengthEstimator) -> float:
    """Shortest (estimated total) job first — static per request."""
    dec = est.estimate(req.app_id)
    return (cost.prefill_time_estimate(req.prompt_len, 0)
            + cost.decode_time_estimate(int(dec), req.prompt_len))


def srpf_key(req: Request, now: float, cost: ModelCostModel,
             est: DecodeLengthEstimator) -> float:
    """Shortest remaining prompt first — re-evaluated as prefill advances."""
    return req.prefill_remaining


def hybrid_key(req: Request, now: float, cost: ModelCostModel,
               est: DecodeLengthEstimator, alpha: float) -> float:
    """Paper eqs 4-5.

    interactive:      P = t_arr + SLO_TTFT + alpha * T(prefill_rem)
    non-interactive:  P = t_arr + SLO_TTLT + alpha * (T(prefill_rem)
                                                       + T(decode_rem_est))
    """
    t_prefill = cost.prefill_time_estimate(req.prefill_remaining,
                                           req.prefilled)
    if req.qos.interactive:
        return req.arrival + req.qos.ttft_slo + alpha * t_prefill
    dec_rem = max(0.0, est.estimate(req.app_id) - req.decoded)
    t_decode = cost.decode_time_estimate(int(dec_rem), req.prompt_len)
    return req.arrival + req.qos.ttlt_slo + alpha * (t_prefill + t_decode)


def hybrid_keys(table: RequestTable, alpha: float) -> np.ndarray:
    """Vectorized ``hybrid_key`` over a request table (paper eqs 4-5).

    Both branches share one shape — ``(arrival + slo) + alpha * work``
    with ``work`` the table's interactive-aware remaining-work column —
    which is exactly the scalar float sequence, so sort orders cannot
    diverge."""
    return table.deadline_first + alpha * table.work


def edf_keys(table: RequestTable) -> np.ndarray:
    """Vectorized ``edf_key``: the first-progress deadline column."""
    return table.deadline_first


def adaptive_alpha(alpha0: float, backlog_s: float, threshold_s: float,
                   alpha_max: float = 50.0, gain: float = 4.0) -> float:
    """Smoothly raise alpha as prefill backlog exceeds what the nearest
    deadlines can absorb — EDF at low load, SRPF-leaning under overload."""
    if threshold_s <= 0:
        return alpha0
    over = max(0.0, backlog_s / threshold_s - 1.0)
    return min(alpha_max, alpha0 * (1.0 + gain * over))


POLICIES: dict[str, Callable] = {
    "fcfs": fcfs_key,
    "edf": edf_key,
    "sjf": sjf_key,
    "srpf": srpf_key,
}
