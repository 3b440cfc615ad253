"""Dynamic chunking (paper §3.3).

Each iteration, the prefill chunk budget is maximized subject to the minimum
deadline slack across in-flight decodes: for interactive decodes the slack is
the eq-2 next-token deadline minus now; for non-interactive decodes the TTLT
budget is spread uniformly over the estimated remaining tokens (the paper's
'characteristics of the requests in decode phase'). The predictor's roofline
iteration-time model is inverted in closed form and snapped to the 128-token
grid (TPU lane quantization, DESIGN.md §4.2); see
``ModelCostModel.solve_max_chunk``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .predictor import BatchPlanCost, DecodeLengthEstimator, ModelCostModel
from .request import Request


def decode_slack(req: Request, now: float, est: DecodeLengthEstimator,
                 floor: float = 1e-3) -> float:
    """Seconds until this decode request's next token is overdue.

    A decode that has already slipped past its absolute eq-2 schedule
    switches to PACING: its next token is due one TBT after its last token
    (otherwise one late token pins the whole replica's chunk budget at
    zero for the rest of that request)."""
    if req.qos.interactive:
        s = req.deadline_next_token() - now
        if s <= 0 and req.token_times:
            s = (req.token_times[-1] + req.qos.tbt_slo) - now
        return max(floor, s)
    rem = max(1.0, est.estimate(req.app_id) - req.decoded)
    budget = req.deadline_total() - now
    return max(floor, budget / rem)


def min_decode_slack(decodes: Sequence[Request], now: float,
                     est: DecodeLengthEstimator,
                     tbt_floor: Optional[float] = None) -> float:
    """Tightest slack across the decode queue; inf when no decodes
    (throughput-optimal chunks are then allowed, §3.5)."""
    if not decodes:
        return float("inf")
    s = min(decode_slack(r, now, est) for r in decodes)
    if tbt_floor is not None:
        s = max(s, tbt_floor)
    return s


def solve_chunk_budget(cost: ModelCostModel, slack: float,
                       decodes: Sequence[Request], prefix: int,
                       max_chunk: int = 8192, quantum: int = 128,
                       swap_bytes: float = 0.0, ctxs=None,
                       decode_agg=None) -> int:
    """Max prefill tokens schedulable this iteration without violating the
    slack of any in-flight decode. ``swap_bytes`` is the host->HBM KV
    swap-in the top-priority candidate would trigger on admission (KV
    hierarchy resume path) — it eats the same decode slack the chunk
    does, so the solver charges it up front. ``ctxs`` optionally supplies
    the decode context lengths as a ready-made array (the replica's
    incremental decode table) instead of re-deriving them per request."""
    if slack == float("inf"):
        return max_chunk
    if ctxs is None:
        ctxs = [r.total_len for r in decodes]
    return cost.solve_max_chunk(slack, prefix, ctxs,
                                max_chunk=max_chunk, quantum=quantum,
                                swap_bytes=swap_bytes,
                                decode_agg=decode_agg)


def allocate_chunks(budget: int, candidates: List[Request],
                    quantum: int = 128) -> List[tuple]:
    """Greedily pack the token budget across prefill candidates in priority
    order (paper Fig 6: after A, tokens from B and D fill the chunk).
    Returns [(request, chunk_tokens)].

    Reference semantics: the scheduler's ``admit_prefills`` inlines this
    packing into its admission loop for speed (like
    ``solve_max_chunk_bisect``, this stays as the oracle — the
    equivalence is asserted in tests/test_hotpath.py)."""
    out = []
    left = budget
    for req in candidates:
        if left < quantum:
            break
        take = min(req.prefill_remaining, left)
        # quantize up-aligned chunks except a final short remainder
        if take < req.prefill_remaining:
            take = (take // quantum) * quantum
        if take <= 0:
            continue
        out.append((req, take))
        left -= take
    return out
