"""Engine-agnostic replica serving loop (paper Fig 3 outer loop).

The SAME scheduler drives (a) the event-driven simulator backend
(sim/backend.py — virtual clock, analytical execution oracle) and (b) the
real JAX engine (engine/jax_backend.py — actual forward passes). A backend
only needs to execute a BatchPlan and report elapsed seconds.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Protocol

from repro_torch.core.backpressure import EngineBackpressure
from repro_torch.core.kvpool import KVPool, blocks_for
from repro_torch.core.reqtable import DecodeTable, PrefillTable
from repro_torch.core.request import Phase, Request
from repro_torch.core.scheduler import BatchPlan, Scheduler, SchedulerView
from repro_torch.obs.spans import span


class ExecutionBackend(Protocol):
    def execute(self, plan: BatchPlan, now: float) -> float:
        """Run one iteration; return elapsed wall/virtual seconds."""
        ...

    def on_admit(self, req: Request) -> None: ...
    def on_release(self, req: Request) -> None: ...


class _MirroredQueue(list):
    """Request list with an array-backed table mirror. The serving loop
    only uses append/remove/pop/clear (kept incremental); every other
    inherited mutator falls back to a full table rebuild so exotic edits
    can never silently desync the columns."""

    def _rebuild(self) -> None:
        self.table.rebuild(self)

    def insert(self, i, req) -> None:
        super().insert(i, req)
        self._rebuild()

    def extend(self, iterable) -> None:
        super().extend(iterable)
        self._rebuild()

    def sort(self, **kw) -> None:
        super().sort(**kw)
        self._rebuild()

    def reverse(self) -> None:
        super().reverse()
        self._rebuild()

    def __setitem__(self, i, v) -> None:
        super().__setitem__(i, v)
        self._rebuild()

    def __delitem__(self, i) -> None:
        super().__delitem__(i)
        self._rebuild()

    def __iadd__(self, other):
        out = super().__iadd__(other)
        self._rebuild()
        return out


class DecodeQueue(_MirroredQueue):
    """The replica's decode queue: an ordinary request list that keeps an
    array-backed ``DecodeTable`` mirror in sync (incremental queue state —
    docs/perf.md). The scheduler reads contexts/deadline columns straight
    from ``.table`` instead of touching every ``Request`` per iteration."""

    def __init__(self, iterable: Iterable[Request] = ()):
        super().__init__(iterable)
        self.table = DecodeTable()
        for r in self:
            self.table.append(r)

    def append(self, req: Request) -> None:
        super().append(req)
        self.table.append(req)

    def remove(self, req: Request) -> None:
        i = self.index(req)
        list.pop(self, i)
        self.table.remove_at(i)

    def pop(self, i: int = -1) -> Request:
        req = list.pop(self, i)
        # len(self) is already post-pop; negative i counted from the
        # original length, so the removed row is len(self) + 1 + i
        self.table.remove_at(i if i >= 0 else len(self) + 1 + i)
        return req

    def clear(self) -> None:
        super().clear()
        self.table.rebuild(())

    def bump_tokens(self, k: int, t_end: float) -> None:
        """First ``k`` requests (this iteration's decode batch) each
        gained one token at ``t_end``."""
        self.table.bump_tokens(k, t_end)


class PrefillQueue(_MirroredQueue):
    """The replica's prefill queue: a request list keeping a persistent
    ``PrefillTable`` mirror (priority-key / verdict columns, tier counts,
    backlog estimates) in sync. The scheduler refreshes stale rows via
    ``table.sync`` instead of rebuilding a columnar view per call."""

    def __init__(self, iterable: Iterable[Request] = ()):
        super().__init__(iterable)
        self.table = PrefillTable()
        for r in self:
            self.table.append(r)

    def append(self, req: Request) -> None:
        super().append(req)
        self.table.append(req)

    def remove(self, req: Request) -> None:
        i = self.index(req)
        list.pop(self, i)
        self.table.remove_at(i, req)

    def pop(self, i: int = -1) -> Request:
        req = list.pop(self, i)
        # negative i counts from the pre-pop length (see DecodeQueue.pop)
        self.table.remove_at(i if i >= 0 else len(self) + 1 + i, req)
        return req

    def clear(self) -> None:
        super().clear()
        self.table.rebuild(())


@dataclass
class Replica:
    scheduler: Scheduler
    backend: ExecutionBackend
    kv: KVPool
    rid: int = 0
    idle_quantum: float = 0.005     # virtual seconds to skip when idle

    now: float = 0.0
    prefill_queue: PrefillQueue = field(default_factory=PrefillQueue)
    decode_queue: DecodeQueue = field(default_factory=DecodeQueue)
    relegated_queue: List[Request] = field(default_factory=list)
    finished: List[Request] = field(default_factory=list)
    _arrivals: list = field(default_factory=list)   # heap of (t, seq, req)
    _seq: int = 0
    iterations: int = 0
    busy_time: float = 0.0
    # iterations where the engine pushed back (typed EngineBackpressure)
    # and the prefill tail was deferred instead of crashing the loop
    backpressure_defers: int = 0
    # monotonically bumped whenever queues, KV, or the clock change; the
    # fleet controller keys its barrier-snapshot cache on it so unchanged
    # replicas are never re-snapshotted (docs/perf.md)
    state_version: int = 0
    # minimum park time before force-resuming relegated work when idle;
    # a fleet controller raises it so offload gets first refusal. The
    # effective park is the max of this and the scheduler's own
    # relegated_park_s (when its config defines one).
    relegated_park_s: float = 0.0
    # virtual-time horizon of the current run() call: idle clock jumps may
    # not cross it, so a lockstep controller's barriers stay barriers
    horizon: Optional[float] = None
    # optional obs.TraceRecorder: every hook is guarded on it, so a
    # replica without one runs the exact pre-observability code path, and
    # one WITH it only records decisions after they are final
    # (docs/observability.md; inertness tested in tests/test_obs.py)
    tracer: Optional[object] = None

    # ------------------------------------------------ request intake
    def submit(self, req: Request) -> None:
        heapq.heappush(self._arrivals, (req.arrival, self._seq, req))
        self._seq += 1
        self.state_version += 1
        if self.tracer is not None:
            self.tracer.emit("arrive", req.arrival, rid=req.rid,
                             rep=self.rid)

    def submit_at(self, req: Request, t: float) -> None:
        """Deliver ``req`` at virtual time ``t`` (>= its original arrival).
        Used by the fleet layer for migrations: the request re-enters this
        replica's intake at the *decision* time, never in its past."""
        heapq.heappush(self._arrivals, (t, self._seq, req))
        self._seq += 1
        self.state_version += 1
        if self.tracer is not None:
            self.tracer.emit("arrive", t, rid=req.rid, rep=self.rid)

    def submit_all(self, reqs: Iterable[Request]) -> None:
        for r in reqs:
            self.submit(r)

    def _admit_arrivals(self) -> None:
        while self._arrivals and self._arrivals[0][0] <= self.now:
            _, _, req = heapq.heappop(self._arrivals)
            req.enqueue_time = self.now
            if self.tracer is not None:
                self.tracer.emit("enqueue", self.now, rid=req.rid,
                                 rep=self.rid, phase=req.phase.name)
            if req.phase == Phase.DECODE:
                # live KV-transfer migration landed (fleet layer): blocks
                # were reserved at the decision barrier; resume decoding
                self.decode_queue.append(req)
            else:
                # prefix-cache match may skip already-cached prefill tokens
                self.kv.attach(req)
                self.prefill_queue.append(req)

    @property
    def pending(self) -> int:
        return (len(self._arrivals) + len(self.prefill_queue)
                + len(self.decode_queue) + len(self.relegated_queue))

    @property
    def unadmitted(self) -> List[Request]:
        """Requests submitted but not yet past their arrival time (still in
        the intake heap). These were silently dropped from cluster reports
        before — they count against unfinished_frac / SLO violations."""
        return [req for _, _, req in self._arrivals]

    def outstanding(self) -> List[Request]:
        """Every request this replica is responsible for that has not
        finished, whichever queue it sits in."""
        return (self.unadmitted + list(self.prefill_queue)
                + list(self.decode_queue) + list(self.relegated_queue))

    def all_requests(self) -> List[Request]:
        return list(self.finished) + self.outstanding()

    def queue_depth(self) -> int:
        return len(self.prefill_queue) + len(self.decode_queue)

    def _relegated_park(self) -> float:
        """Effective relegation park time: the stricter of the replica's
        and the scheduler's setting (single knob either way)."""
        cfg = getattr(self.scheduler, "cfg", None)
        return max(self.relegated_park_s,
                   getattr(cfg, "relegated_park_s", 0.0) if cfg else 0.0)

    # ------------------------------------------------ fleet detach
    def take_for_migration(self, req: Request) -> bool:
        """Detach ``req`` so the fleet layer can re-home it via the
        *recompute* path. Only safe for requests holding no private HBM
        blocks and no backend state: relegated requests and queued,
        not-yet-prefilled requests. Prefix-cache references and host-tier
        KV are dropped here — prefill restarts from zero (modulo the
        destination's own cache) at the new home. Returns False if the
        request is in neither detachable queue."""
        assert self.kv.private_blocks(req.rid) == 0, \
            f"rid {req.rid} still holds KV blocks on replica {self.rid}"
        if req in self.relegated_queue:
            self.relegated_queue.remove(req)
            self.kv.release(req.rid)
            req.prefilled = 0
            req.cache_hit_tokens = 0
            self.state_version += 1
            return True
        if req in self.prefill_queue and req.phase == Phase.QUEUED \
                and self.kv.private_blocks(req.rid) == 0 \
                and req.prefilled == req.cache_hit_tokens:
            self.prefill_queue.remove(req)
            self.kv.release(req.rid)
            req.prefilled = 0
            req.cache_hit_tokens = 0
            self.state_version += 1
            return True
        return False

    def detach_swapped(self, req: Request) -> Optional[int]:
        """Detach a relegated request whose KV is parked in the host tier,
        *keeping* the prefilled state for a cross-replica KV transfer.
        Returns the number of prefilled tokens whose KV must travel, or
        None if the request has no transferable host-tier state."""
        if req not in self.relegated_queue \
                or self.kv.swapped_tokens(req.rid) <= 0:
            return None
        self.relegated_queue.remove(req)
        tokens = req.prefilled
        self.kv.release(req.rid)    # frees host blocks + prefix pins here
        self.state_version += 1
        return tokens

    def receive_swapped(self, req: Request, t: float, tokens: int) -> bool:
        """Land a migrated request whose ``tokens`` of prefilled KV arrive
        into this replica's host tier (it resumes like a locally-swapped
        relegated request: swap-in charged on first admission)."""
        blocks = blocks_for(tokens, self.kv.block_size)
        if not getattr(self.kv, "host_receive", None) \
                or not self.kv.host_receive(req.rid, blocks, tokens):
            return False
        req.prefilled = tokens
        self.submit_at(req, t)
        return True

    def detach_live(self, req: Request) -> Optional[int]:
        """Detach an in-flight decode request for live KV-transfer
        migration. Returns its resident context length in tokens (sizing
        the transfer), or None if it is not migratable."""
        if req not in self.decode_queue or req.phase != Phase.DECODE:
            return None
        self.decode_queue.remove(req)
        tokens = req.total_len
        self.kv.release(req.rid)
        self.backend.on_release(req)
        self.state_version += 1
        return tokens

    def receive_live(self, req: Request, t: float, tokens: int) -> None:
        """Accept a live-migrated decode request: HBM blocks are reserved
        NOW (the transfer is in flight); decoding resumes at ``t``."""
        ok = self.kv.grow(req.rid, tokens)
        assert ok, "live migration delivered without reserved capacity"
        self.backend.on_admit(req)
        heapq.heappush(self._arrivals, (t, self._seq, req))
        self._seq += 1
        self.state_version += 1

    def receive_live_swapped(self, req: Request, t: float,
                             tokens: int) -> bool:
        """Accept a live-migrated decode request whose FULL context
        arrived as serialized host-tier state (real-engine fleets: the
        peer engine's pages landed in our engine's swap store). Mirrors
        ``receive_live``'s reserve-at-decision semantics: the state is
        pulled through the host tier into fresh HBM blocks and an engine
        slot NOW, so no later admission can race it out of capacity;
        decoding resumes at ``t``."""
        blocks = blocks_for(tokens, self.kv.block_size)
        if not getattr(self.kv, "host_receive", None) \
                or not self.kv.host_receive(req.rid, blocks, tokens):
            return False
        # swap_in allocates the blocks and restores the pages (runtime
        # hook); on_admit then restores the slot-side cursor/recurrence
        self.kv.swap_in(req.rid)
        self.backend.on_admit(req)
        heapq.heappush(self._arrivals, (t, self._seq, req))
        self._seq += 1
        self.state_version += 1
        return True

    # ------------------------------------------------ bookkeeping
    def _apply_relegation(self, plan: BatchPlan) -> None:
        for req in plan.relegate:
            req.phase = Phase.RELEGATED
            req.was_relegated = True
            req.relegated_at = self.now
            if self.tracer is not None:
                self.tracer.emit("relegate", self.now, rid=req.rid,
                                 rep=self.rid)
            # memory policy is the pool's: a flat pool frees the KV and
            # prefill restarts from scratch on resume (vLLM-style recompute
            # — DESIGN.md §4.5); a hierarchy swaps it to the host tier and
            # preserves the prefilled tokens
            req.prefilled = self.kv.on_relegate(req.rid, req.prefilled)
            self.prefill_queue.remove(req)
            self.relegated_queue.append(req)
            self.backend.on_release(req)
        for req in plan.resume:
            if req in self.relegated_queue:
                self.relegated_queue.remove(req)
                req.phase = Phase.QUEUED
                # recompute-relegated requests may re-match the prefix
                # cache on their way back in (swapped ones keep their KV)
                self.kv.attach(req)
                self.prefill_queue.append(req)
                if self.tracer is not None:
                    self.tracer.emit("resume", self.now, rid=req.rid,
                                     rep=self.rid)

    def _apply_results(self, plan: BatchPlan, t_end: float) -> None:
        # decode columns first: every batched decode (rows 0..k-1 of the
        # queue — appends land behind them, and nothing is removed between
        # schedule() and here) gains one token, as a single array bump
        self.decode_queue.bump_tokens(len(plan.decode), t_end)
        if plan.prefill:
            self.prefill_queue.table.note_prefilled()
        # prefill chunks
        for req, chunk in plan.prefill:
            if self.kv.swapped_tokens(req.rid):
                # first chunk after a swap-preserving relegation: host-tier
                # blocks come back to HBM (transfer already priced into the
                # plan's swap_bytes by the scheduler)
                self.kv.swap_in(req.rid)
            assert self.kv.grow(req.rid, req.prefilled + chunk), \
                "scheduler admitted beyond pool capacity"
            was_queued = req.phase == Phase.QUEUED
            req.phase = Phase.PREFILL
            if was_queued:
                self.backend.on_admit(req)
            req.prefilled += chunk
            # publish newly-completed shareable blocks to the prefix cache
            self.kv.promote(req.rid, req.prefilled)
            if req.prefill_remaining == 0:
                # last prefill chunk emits the first output token
                req.first_token_time = t_end
                req.token_times.append(t_end)
                req.decoded = 1
                req.phase = Phase.DECODE
                self.prefill_queue.remove(req)
                if req.decode_remaining == 0:
                    self._finish(req, t_end)
                else:
                    self.decode_queue.append(req)
        # decode tokens
        for req in plan.decode:
            self.kv.grow(req.rid, req.total_len + 1)
            req.decoded += 1
            req.token_times.append(t_end)
            if req.decode_remaining == 0:
                self._finish(req, t_end)

    def _finish(self, req: Request, t: float) -> None:
        req.phase = Phase.FINISHED
        req.finish_time = t
        if self.tracer is not None:
            self.tracer.emit("finish", t, rid=req.rid, rep=self.rid)
        if req in self.decode_queue:
            self.decode_queue.remove(req)
        self.kv.release(req.rid)
        self.backend.on_release(req)
        self.finished.append(req)
        self.scheduler.on_finish(req)

    # ------------------------------------------------ main loop
    def step(self) -> bool:
        """One scheduling iteration. Returns False when fully drained."""
        self.state_version += 1
        with span("replica.admit"):
            self._admit_arrivals()
            view = SchedulerView(self.prefill_queue, self.decode_queue,
                                 self.relegated_queue, self.kv,
                                 trace=self.tracer is not None)
        with span("replica.schedule"):
            plan = self.scheduler.schedule(self.now, view)
            self._apply_relegation(plan)
        if plan.empty:
            if self.prefill_queue:
                # work exists but nothing admitted (KV watermark / zero
                # budget): let virtual time advance so state can change
                self.now += self.idle_quantum
                return True
            if self._arrivals:
                t_next = self._arrivals[0][0]
                if self.horizon is not None:
                    t_next = min(t_next, self.horizon)
                self.now = max(self.now, t_next)
                return True
            if self.relegated_queue:
                # only relegated work left: force-resume it once parked
                # long enough (a fleet controller may still re-home it)
                park = self._relegated_park()
                eligible = [r for r in self.relegated_queue
                            if r.relegated_at is None
                            or self.now >= r.relegated_at + park]
                if eligible:
                    req = eligible[0]
                    self.relegated_queue.remove(req)
                    req.phase = Phase.QUEUED
                    self.kv.attach(req)
                    self.prefill_queue.append(req)
                    if self.tracer is not None:
                        self.tracer.emit("resume", self.now, rid=req.rid,
                                         rep=self.rid)
                    return True
                t_next = min(r.relegated_at + park
                             for r in self.relegated_queue)
                if self.horizon is not None:
                    t_next = min(t_next, self.horizon)
                self.now = max(self.now, t_next)
                return True
            return self.pending > 0
        with span("replica.execute"):
            elapsed, plan = self._execute_deferring(plan)
        if plan is None:
            # full backpressure: nothing in the plan could run right now;
            # let time advance so finishing work can free capacity
            self.now += self.idle_quantum
            return True
        t_start = self.now
        self.now += elapsed
        self.busy_time += elapsed
        self.iterations += 1
        with span("replica.apply"):
            self._apply_results(plan, self.now)
            if self.tracer is not None:
                self.tracer.emit(
                    "iter", self.now, rep=self.rid, t0=t_start,
                    elapsed=elapsed, predicted=plan.predicted_time,
                    prefill=[[r.rid, c] for r, c in plan.prefill],
                    decode=[r.rid for r in plan.decode], sched=plan.trace)
        return True

    def _execute_deferring(self, plan: BatchPlan):
        """Execute a plan, absorbing *deferrable* engine backpressure: the
        engine's pre-mutation preflight names how many prefill items fit
        (``n_prefill_fit``); the tail is deferred — those requests simply
        stay queued, untouched — and the truncated plan retried. Returns
        ``(elapsed, executed_plan)``; ``(0, None)`` when nothing fit.
        Non-deferrable pressure (the decode batch itself does not fit) is
        a sizing bug and propagates."""
        try:
            return self.backend.execute(plan, self.now), plan
        except EngineBackpressure as bp:
            if not bp.deferrable:
                raise
            fit, err = bp.n_prefill_fit, bp
        self.backpressure_defers += 1
        self.state_version += 1
        if self.tracer is not None:
            self.tracer.emit("defer", self.now, rep=self.rid,
                             rids=[r.rid for r, _ in plan.prefill[fit:]])
        kept = plan.prefill[:fit]
        swap = sum(self.kv.swap_in_bytes(r.rid) for r, _ in kept
                   if self.kv.swapped_tokens(r.rid) > 0)
        trimmed = BatchPlan(decode=plan.decode, prefill=kept,
                            predicted_time=plan.predicted_time,
                            swap_bytes=swap, ctx_hint=plan.ctx_hint,
                            decode_agg=plan.decode_agg,
                            trace=plan.trace)
        if trimmed.empty:
            if not plan.decode and self.kv.used == 0:
                # the engine is EMPTY and the head request still does not
                # fit: waiting frees nothing — that is a sizing bug
                raise err
            return 0.0, None
        return self.backend.execute(trimmed, self.now), trimmed

    def run(self, until: Optional[float] = None,
            max_iterations: int = 50_000_000) -> None:
        self.horizon = until
        it = 0
        while self.pending and it < max_iterations:
            if until is not None and self.now >= until:
                break
            if not self.step():
                break
            it += 1
        self.horizon = None
