"""The Niyama scheduler (paper §3) and the Sarathi-style baselines (§4).

Per iteration (paper Fig 3): build a batch of ALL decode-queue requests plus
prefill chunks chosen by hybrid prioritization, sized by dynamic chunking
against the decodes' deadline slack, with eager relegation of requests that
cannot meet their deadlines and selective preemption limited to
prefill-phase requests.

Hot path (docs/perf.md): the per-candidate work — priority keys, violation
verdicts, backlog — runs vectorized over a ``reqtable.RequestTable`` built
once per call, decode-queue state comes from the replica's incrementally
maintained ``DecodeTable``, and the chunk budget is solved in closed form.
Every vectorized step replicates the scalar float arithmetic exactly, so
scheduling decisions are bit-identical to the per-Request reference
implementation (golden-trace regression in tests/test_hotpath.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .chunking import min_decode_slack, solve_chunk_budget
from .kvpool import KVPool, blocks_for
from .predictor import (BatchPlanCost, DecodeLengthEstimator, ModelCostModel)
from .priority import POLICIES, adaptive_alpha, hybrid_key, hybrid_keys
from .relegation import RelegationPolicy
from .reqtable import RequestTable, min_decode_slack_table
from .request import Phase, Request


@dataclass
class BatchPlan:
    decode: List[Request] = field(default_factory=list)
    prefill: List[Tuple[Request, int]] = field(default_factory=list)
    relegate: List[Request] = field(default_factory=list)
    resume: List[Request] = field(default_factory=list)   # from relegated q
    predicted_time: float = 0.0
    swap_bytes: float = 0.0     # host->HBM KV swap-in admitted this iteration
    # decode context lengths + (flops, bytes) aggregate at plan time (from
    # the replica's incremental decode table, when available) — saves
    # cost() re-deriving them per request; values identical by construction
    ctx_hint: Optional[Sequence[int]] = None
    decode_agg: Optional[Tuple[float, float]] = None
    # admission-verdict detail for the observability plane, filled ONLY
    # when SchedulerView.trace is set (a replica has a recorder attached)
    # and always AFTER every decision is final — never an input to one
    trace: Optional[dict] = None
    _cost: Optional[BatchPlanCost] = None

    @property
    def empty(self) -> bool:
        return not self.decode and not self.prefill

    def cost(self) -> BatchPlanCost:
        # memoized: called once by the scheduler (predicted_time) and once
        # by the backend; the plan does not change in between
        if self._cost is not None:
            return self._cost
        ctxs = self.ctx_hint if self.ctx_hint is not None \
            else [r.total_len for r in self.decode]
        self._cost = BatchPlanCost(
            prefill_items=[(c, r.prefilled) for r, c in self.prefill],
            decode_ctxs=ctxs,
            swap_bytes=self.swap_bytes,
            decode_agg=self.decode_agg)
        return self._cost


@dataclass
class SchedulerView:
    """Queues + memory state handed to the scheduler each iteration."""
    prefill_queue: List[Request]
    decode_queue: List[Request]
    relegated_queue: List[Request]
    kv: KVPool
    # when True the scheduler records its admission verdict (candidate
    # keys, losers, solver inputs) into BatchPlan.trace; decisions are
    # identical either way (read-only tap, tested in tests/test_obs.py)
    trace: bool = False


def admit_prefills(kv: KVPool, decode: Sequence[Request],
                   candidates: List[Request], budget: int, quantum: int,
                   watermark: float, swap_budget: Optional[float] = None,
                   decode_ctxs=None,
                   n_decode_total: Optional[int] = None
                   ) -> Tuple[List[Tuple[Request, int]], float]:
    """Admission + tentative KV accounting shared by Niyama and Sarathi:
    pack the chunk budget over candidates in priority order, reserving the
    decode batch's boundary blocks up front (decodes grow first and are
    never preempted), enforcing the admission watermark for new requests,
    and keeping joint admissions within the pool.

    ``swap_budget`` enables the KV-hierarchy swap-in gate (Niyama): at most
    one host->HBM swap-in per iteration, never exceeding the bytes the
    chunk solver charged against the decode slack. ``None`` disables swap
    accounting entirely (Sarathi semantics). Returns (admitted chunks,
    swap-in bytes admitted).

    When the pool advertises ``max_seqs`` (a real engine's concurrent-slot
    cap — block-granular pools can hold many more requests' blocks than
    the engine has decode rows), admissions that would start a NEW
    sequence are additionally gated on free seats: every decode-queue
    request and every mid-prefill candidate occupies one.
    ``n_decode_total`` is the FULL decode-queue depth (``decode`` is the
    batch, already capped at max_decode_batch — requests beyond the cap
    still hold their seats); defaults to ``len(decode)``."""
    bs = kv.block_size
    if decode_ctxs is not None:
        reserve = int((decode_ctxs % bs == 0).sum())
    else:
        reserve = sum(1 for r in decode if r.total_len % bs == 0)
    free = kv.free - reserve
    admitted: List[Tuple[Request, int]] = []
    swap_bytes = 0.0
    nb = kv.num_blocks
    held = kv.held
    seats = getattr(kv, "max_seqs", None)
    if seats is not None:
        nd = len(decode) if n_decode_total is None else n_decode_total
        seats -= nd + sum(1 for r in candidates
                          if r.phase is Phase.PREFILL)
    left = budget
    for req in candidates:
        # inline chunking.allocate_chunks: greedy budget packing in
        # priority order, up-aligned except a final short remainder (the
        # budget is spent whether or not admission below accepts)
        if left < quantum:
            break
        rem = req.prefill_remaining
        take = rem if rem < left else left
        if take < rem:
            take = (take // quantum) * quantum
        if take <= 0:
            continue
        left -= take
        need = blocks_for(req.prefilled + take, bs) - held(req.rid)
        if req.phase is Phase.QUEUED \
                and (nb - free + need) / nb > watermark:
            continue
        if swap_budget is not None:
            # first chunk of a hierarchy-resumed request swaps its parked
            # KV back in: the transfer rides on this iteration's cost. At
            # most ONE swap-in per iteration, and never more bytes than
            # the chunk solver charged against the decode slack — larger
            # (or additional) transfers wait until they head the queue
            sb = kv.swap_in_bytes(req.rid)
            if sb and (swap_bytes or sb > swap_budget):
                continue
        else:
            sb = 0.0
        if need > free:
            continue
        if seats is not None and req.phase is not Phase.PREFILL:
            if seats <= 0:
                continue
            seats -= 1
        free -= need
        admitted.append((req, take))
        swap_bytes += sb
    return admitted, swap_bytes


class Scheduler:
    name = "base"

    def schedule(self, now: float, view: SchedulerView) -> BatchPlan:
        raise NotImplementedError

    def on_finish(self, req: Request) -> None:
        pass


# =====================================================================
# Niyama
# =====================================================================

@dataclass
class NiyamaConfig:
    alpha: float = 0.5
    adaptive_alpha: bool = True
    max_chunk: int = 8192
    min_chunk: int = 128
    quantum: int = 128
    max_decode_batch: int = 256
    enable_dynamic_chunking: bool = True
    fixed_chunk: int = 256            # used when dynamic chunking disabled
    enable_relegation: bool = True
    use_hints: bool = True
    enable_hybrid: bool = True        # False -> pure EDF selection
    admission_watermark: float = 0.90  # max pool utilization for new admits
    relegated_resume_backlog_s: float = 0.5
    # minimum time a relegated request stays parked before local resume.
    # 0 = resume whenever load allows (solo-replica behaviour). A fleet
    # controller raises this to ~2 ticks so the cross-replica offload pass
    # gets first refusal on relegated work before the replica takes it back.
    relegated_park_s: float = 0.0
    slack_safety: float = 0.8         # headroom for predictor error (TBT)


class NiyamaScheduler(Scheduler):
    name = "niyama"

    def __init__(self, cost: ModelCostModel,
                 est: Optional[DecodeLengthEstimator] = None,
                 cfg: Optional[NiyamaConfig] = None):
        self.cost = cost
        self.est = est or DecodeLengthEstimator()
        self.cfg = cfg or NiyamaConfig()
        self.releg = RelegationPolicy(self.cfg.enable_relegation,
                                      self.cfg.use_hints)
        self._last_prefill_rids: set = set()

    # ---------------- scalar reference helpers ----------------
    def _backlog_s(self, queue: Sequence[Request]) -> float:
        return sum(self.cost.prefill_time_estimate(r.prefill_remaining,
                                                   r.prefilled)
                   for r in queue)

    def _priority(self, req: Request, now: float, alpha: float) -> float:
        if not self.cfg.enable_hybrid:
            return req.deadline_first()
        return hybrid_key(req, now, self.cost, self.est, alpha)

    def on_finish(self, req: Request) -> None:
        self.est.observe(req.app_id, req.decoded)

    # ---------------- main entry ----------------
    def schedule(self, now: float, view: SchedulerView) -> BatchPlan:
        cfg = self.cfg
        plan = BatchPlan()
        plan.decode = view.decode_queue[: cfg.max_decode_batch]
        k_dec = len(plan.decode)
        # incremental decode columns (replica-maintained); tests handing in
        # plain lists fall back to per-request derivation
        dtab = getattr(view.decode_queue, "table", None)
        ctxs = dtab.ctx_view(k_dec) if dtab is not None else None
        agg = dtab.decode_agg(self.cost, k_dec) if dtab is not None \
            else None

        # columnar view: sync the replica's persistent prefill table when
        # available (stale rows refresh in queue order, preserving the
        # memo first-touch order of the scalar reference); otherwise
        # build per call
        tab = None
        ptab = getattr(view.prefill_queue, "table", None)
        if ptab is not None:
            tab = ptab.sync(view.prefill_queue, self.cost, self.est)
        if tab is not None:
            candidates = list(tab.reqs)   # the view may be cache-shared
        else:
            _q, _p = Phase.QUEUED, Phase.PREFILL
            candidates = [r for r in view.prefill_queue
                          if r.phase is _q or r.phase is _p]
            tab = RequestTable(candidates, self.cost, self.est)

        # --- overload estimate & adaptive alpha
        backlog = tab.backlog
        slo_floor = tab.min_ttft
        threshold = slo_floor if slo_floor is not None else 5.0
        overloaded = backlog > threshold
        alpha = (adaptive_alpha(cfg.alpha, backlog, threshold)
                 if cfg.adaptive_alpha else cfg.alpha)

        # --- eager relegation (violation checker, paper Fig 3 step 2-3).
        # Swap-in cost needs no charge here: every host-swapped request is
        # was_relegated and so exempt from re-relegation by policy; its
        # transfer is priced where it is paid, via BatchPlanCost.swap_bytes
        vict = self.releg.pick_victims_idx(tab, now, overloaded)
        if vict.size:
            vict = np.sort(vict)          # relegate in candidate order
            plan.relegate = [candidates[i] for i in vict]
            keep = np.ones(tab.n, dtype=bool)
            keep[vict] = False
            keep_idx = np.flatnonzero(keep)
            candidates = [candidates[i] for i in keep_idx]
            tab = tab.select(keep_idx)

        # --- opportunistically resume relegated work at low load (only
        # after its park time, so a fleet controller may re-home it first)
        if (not candidates or backlog < cfg.relegated_resume_backlog_s) \
                and view.relegated_queue:
            resumable = sorted(
                (r for r in view.relegated_queue
                 if r.relegated_at is None
                 or now >= r.relegated_at + cfg.relegated_park_s),
                key=lambda r: (not r.important, r.arrival))
            for r in resumable[:4]:
                plan.resume.append(r)
                candidates.append(r)
            if plan.resume:
                tab = tab.extend(RequestTable(plan.resume, self.cost,
                                              self.est))

        # --- hybrid prioritization (paper eq 4/5); once-relegated requests
        # run opportunistically BEHIND all regular work regardless of their
        # (long-expired) deadlines
        keys = None
        if tab.n > 1:
            prio = hybrid_keys(tab, alpha) if cfg.enable_hybrid \
                else tab.deadline_first
            order = np.lexsort((prio, tab.was_relegated))
            candidates = [candidates[i] for i in order]
            if view.trace:
                # read-only tap: the final priority order with each
                # candidate's hybrid key (post-decision, for tracing only)
                keys = {candidates[i].rid: float(prio[order[i]])
                        for i in range(len(order))}

        # --- selective preemption guard (paper §3.4): an in-flight prefill
        # may be displaced by a higher-priority arrival ONLY if skipping one
        # iteration cannot cost it its own deadline; decode-queue requests
        # are never preempted (they are all in the batch unconditionally).
        if self._last_prefill_rids and len(candidates) > 1:
            t_iter = self.cost.iteration_time(BatchPlanCost(
                ((cfg.fixed_chunk, 0),),
                ctxs if ctxs is not None
                else [q.total_len for q in plan.decode],
                decode_agg=agg))
            must_run, rest = [], []
            for r in candidates:
                if r.rid in self._last_prefill_rids \
                        and r.phase == Phase.PREFILL:
                    d = r.deadline_first()
                    t_fin = self.cost.prefill_time_estimate(
                        r.prefill_remaining, r.prefilled)
                    if now + t_fin <= d < now + t_iter + t_fin:
                        must_run.append(r)   # skipping would kill it
                        continue
                rest.append(r)
            candidates = must_run + rest

        # --- dynamic chunking (paper §3.3); safety factor absorbs latency
        # predictor error so TBT violations stay negligible (§4.2).
        # Small decode batches take the scalar path (numpy dispatch costs
        # more than it saves below ~16 rows); both paths are identical.
        if dtab is not None and k_dec > 16:
            slack = min_decode_slack_table(dtab, k_dec, now, self.est) \
                * cfg.slack_safety
        else:
            slack = min_decode_slack(plan.decode, now, self.est) \
                * cfg.slack_safety
        # the solver charges exactly one pending host->HBM swap-in (the
        # top candidate's) against the decode slack; admission below may
        # only spend up to that budget
        swap_budget = float("inf")
        if not cfg.enable_dynamic_chunking:
            budget = cfg.fixed_chunk
        elif candidates:
            swap_budget = view.kv.swap_in_bytes(candidates[0].rid)
            budget = solve_chunk_budget(
                self.cost, slack, plan.decode, candidates[0].prefilled,
                max_chunk=cfg.max_chunk, quantum=cfg.quantum,
                swap_bytes=swap_budget, ctxs=ctxs, decode_agg=agg)
        else:
            budget = 0

        # --- admission + KV accounting, pack chunk budget by priority.
        # Tentative accounting: several admissions in ONE plan must not
        # jointly exceed the pool.
        plan.prefill, plan.swap_bytes = admit_prefills(
            view.kv, plan.decode, candidates, budget, cfg.quantum,
            cfg.admission_watermark, swap_budget=swap_budget,
            decode_ctxs=ctxs, n_decode_total=len(view.decode_queue))

        self._last_prefill_rids = {r.rid for r, _ in plan.prefill}
        if ctxs is not None:
            plan.ctx_hint = ctxs.copy()
            plan.decode_agg = agg
        pc = plan.cost()
        plan.predicted_time = self.cost.iteration_time(pc)
        if view.trace:
            admitted = {r.rid for r, _ in plan.prefill}
            plan.trace = {
                "alpha": float(alpha), "backlog": float(backlog),
                "overloaded": bool(overloaded), "slack": float(slack),
                "budget": int(budget),
                "swap_budget": float(swap_budget),
                # TP collective share of predicted_time (0.0 off-TP) —
                # SLO attribution bins it as collective_overhead
                "comm_s": float(self.cost.comm_seconds(pc)),
                "candidates": [[r.rid, keys.get(r.rid) if keys else None]
                               for r in candidates],
                "losers": [r.rid for r in candidates
                           if r.rid not in admitted],
            }
        return plan


# =====================================================================
# Sarathi baselines (fixed chunk, pluggable priority, no relegation)
# =====================================================================

class SarathiScheduler(Scheduler):
    """Sarathi-Serve with a fixed chunk budget and a priority policy:
    fcfs (the production default), edf, sjf, srpf. Used for the paper's
    Sarathi-FCFS / Sarathi-EDF / Sarathi-SRPF baselines and, with
    per-tier chunk sizes, the Sarathi-Silo deployment."""

    def __init__(self, cost: ModelCostModel, policy: str = "fcfs",
                 chunk_size: int = 256, max_decode_batch: int = 256,
                 est: Optional[DecodeLengthEstimator] = None,
                 admission_watermark: float = 0.90):
        assert policy in POLICIES, policy
        self.cost = cost
        self.policy = policy
        self.key_fn = POLICIES[policy]
        self.chunk_size = chunk_size
        self.max_decode_batch = max_decode_batch
        self.est = est or DecodeLengthEstimator()
        self.admission_watermark = admission_watermark
        self.name = f"sarathi-{policy}"

    def on_finish(self, req: Request) -> None:
        self.est.observe(req.app_id, req.decoded)

    def schedule(self, now: float, view: SchedulerView) -> BatchPlan:
        plan = BatchPlan()
        plan.decode = list(view.decode_queue[: self.max_decode_batch])
        dtab = getattr(view.decode_queue, "table", None)
        ctxs = dtab.ctx_view(len(plan.decode)) if dtab is not None else None
        candidates = sorted(
            (r for r in view.prefill_queue
             if r.phase in (Phase.QUEUED, Phase.PREFILL)),
            key=lambda r: self.key_fn(r, now, self.cost, self.est))
        plan.prefill, _ = admit_prefills(
            view.kv, plan.decode, candidates, self.chunk_size, 1,
            self.admission_watermark, swap_budget=None, decode_ctxs=ctxs,
            n_decode_total=len(view.decode_queue))
        if ctxs is not None:
            plan.ctx_hint = ctxs.copy()
        pc = plan.cost()
        plan.predicted_time = self.cost.iteration_time(pc)
        if view.trace:
            admitted = {r.rid for r, _ in plan.prefill}
            plan.trace = {
                "budget": int(self.chunk_size), "policy": self.policy,
                "comm_s": float(self.cost.comm_seconds(pc)),
                "candidates": [[r.rid,
                                float(self.key_fn(r, now, self.cost,
                                                  self.est))]
                               for r in candidates],
                "losers": [r.rid for r in candidates
                           if r.rid not in admitted],
            }
        return plan
