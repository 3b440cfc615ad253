"""Request lifecycle state (prefill -> decode -> finished, with the
relegated detour of paper §3.4)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from .qos import QoSSpec


class Phase(enum.Enum):
    QUEUED = "queued"          # in prefill queue, no tokens processed yet
    PREFILL = "prefill"        # partially prefilled (holds KV blocks)
    DECODE = "decode"          # generating tokens
    RELEGATED = "relegated"    # eagerly relegated (paper §3.4)
    FINISHED = "finished"


@dataclass(eq=False)
class Request:
    """(``eq=False``: a request is an entity — queue membership tests and
    removals compare by identity, not by field values, which also keeps
    ``in``/``remove`` O(1)-per-element on the scheduling hot path.)"""
    rid: int
    arrival: float
    prompt_len: int
    decode_len: int                    # ground truth; scheduler must NOT
    qos: QoSSpec                       # read it (it uses the estimator)
    app_id: str = "default"
    important: bool = True             # application hint (paid vs free tier)
    # shared-prefix identity (multi-tenant system prompt): requests with the
    # same prefix_id share their first prefix_len prompt tokens, so a prefix
    # cache (serving/kvcache) can reuse those KV blocks across requests
    prefix_id: Optional[int] = None
    prefix_len: int = 0

    # ---- runtime state ----
    phase: Phase = Phase.QUEUED
    prefilled: int = 0                 # prompt tokens processed
    decoded: int = 0                   # output tokens generated
    first_token_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    finish_time: Optional[float] = None
    relegated_at: Optional[float] = None
    was_relegated: bool = False
    preempt_count: int = 0
    enqueue_time: Optional[float] = None   # set by the replica on admission
    migrations: int = 0                # cross-replica re-homes (fleet layer)
    last_migrated_at: Optional[float] = None
    cache_hit_tokens: int = 0          # prefill tokens skipped via prefix cache

    # ---- hot-path memo slots (core/reqtable.py): last (cost-model, args,
    # value) triples for this request's prefill/decode estimates. They only
    # short-circuit lookups that would hit the cost model's memo anyway, so
    # cached and uncached paths return the same floats.
    _pf_est: Optional[tuple] = field(default=None, repr=False)
    _pf_full_est: Optional[tuple] = field(default=None, repr=False)
    _t1_est: Optional[tuple] = field(default=None, repr=False)
    _row: Optional[tuple] = field(default=None, repr=False)

    # ---- derived ----
    @property
    def prefill_remaining(self) -> int:
        return max(0, self.prompt_len - self.prefilled)

    @property
    def decode_remaining(self) -> int:
        return max(0, self.decode_len - self.decoded)

    @property
    def done(self) -> bool:
        return self.phase == Phase.FINISHED

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.decoded

    # ---- deadlines ----
    def deadline_first(self) -> float:
        return self.qos.deadline_first(self.arrival)

    def deadline_next_token(self) -> float:
        """Deadline for the *next* output token (used for decode slack,
        paper §3.3). Interactive: eq 2. Non-interactive: the TTLT budget
        spread uniformly over the estimated remaining tokens."""
        if self.qos.interactive:
            return self.qos.deadline_token(self.arrival, self.decoded + 1)
        return self.qos.deadline_total(self.arrival)

    def deadline_total(self) -> float:
        return self.qos.deadline_total(self.arrival)

    # ---- outcome metrics ----
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def ttlt(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def tbts(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    def violated(self) -> bool:
        """Paper's per-request violation notion: interactive -> TTFT SLO;
        non-interactive -> TTLT SLO. (TBT violations are tracked separately;
        they are <0.1% across schemes by chunk-size construction, §4.2.)"""
        if self.qos.interactive:
            t = self.ttft()
            return t is None or t > self.qos.ttft_slo
        t = self.ttlt()
        return t is None or t > self.qos.ttlt_slo

    def tbt_violations(self) -> int:
        """Token-level deadline misses per eq 2 (Etalon-style): token n is
        late iff it lands after t_arrival + SLO_TTFT + (n-1)*SLO_TBT.
        Raw inter-token GAPS may legitimately exceed SLO_TBT when a request
        accumulated slack — that slack is exactly what dynamic chunking
        spends (§3.3), so gap-based accounting would be wrong."""
        if not self.qos.interactive or self.qos.tbt_slo is None:
            return 0
        return sum(
            1 for n, t in enumerate(self.token_times, start=1)
            if t > self.qos.deadline_token(self.arrival, n) + 1e-9)
