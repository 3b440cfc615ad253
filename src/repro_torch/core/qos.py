"""QoS classes and per-token deadlines (paper §3.2, eqs 1-3).

Two QoS classes — interactive (TTFT + TBT SLOs) and non-interactive (TTLT
SLO) — with application-customizable targets within the class. Table 2 of the
paper defines the three evaluation tiers Q1/Q2/Q3 reproduced here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class QoSSpec:
    name: str
    interactive: bool
    ttft_slo: Optional[float] = None   # seconds
    tbt_slo: Optional[float] = None    # seconds
    ttlt_slo: Optional[float] = None   # seconds

    def __post_init__(self):
        if self.interactive:
            assert self.ttft_slo is not None and self.tbt_slo is not None
        else:
            assert self.ttlt_slo is not None

    # ---- deadlines (eqs 1-3) ----
    def deadline_first(self, t_arrival: float) -> float:
        """D_first = t_arrival + SLO_TTFT (eq 1). Non-interactive requests
        have no first-token deadline; return the TTLT deadline instead so a
        single call site can ask 'when must this request make progress'."""
        if self.interactive:
            return t_arrival + self.ttft_slo
        return t_arrival + self.ttlt_slo

    def deadline_token(self, t_arrival: float, n: int) -> float:
        """D_n = t_arrival + SLO_TTFT + (n-1) * SLO_TBT (eq 2), 1-indexed."""
        assert self.interactive
        return t_arrival + self.ttft_slo + (n - 1) * self.tbt_slo

    def deadline_total(self, t_arrival: float) -> float:
        """D_total = t_arrival + SLO_TTLT (eq 3)."""
        if self.interactive:
            # interactive requests are judged token-by-token; a total bound
            # still exists implicitly via eq 2 at the final token
            return float("inf")
        return t_arrival + self.ttlt_slo


# Paper Table 2: three evaluation tiers, 1/3 of traffic each.
Q1_INTERACTIVE = QoSSpec("Q1", interactive=True, ttft_slo=6.0, tbt_slo=0.050)
Q2_BATCH = QoSSpec("Q2", interactive=False, ttlt_slo=600.0)
Q3_BATCH = QoSSpec("Q3", interactive=False, ttlt_slo=1800.0)

PAPER_TIERS = (Q1_INTERACTIVE, Q2_BATCH, Q3_BATCH)
