"""AsyncFleet: the event-driven async fleet runtime (tentpole subsystem).

``FleetController`` makes every global decision (routing, relegation
offload, queued-prefill rebalance, live KV migration) but advances its
replicas in *lockstep virtual time* — fine for simulation studies, useless
for serving real engines whose iterations take real seconds concurrently.

``AsyncFleet`` subclasses it and changes ONLY the execution substrate:

  * **one worker thread per engine** (``worker.EngineWorker``) owns all
    replica/engine mutation;
  * **virtual mode** (``VirtualClock``, the default): the inherited
    lockstep ``run()`` executes unchanged, with ``_advance_to`` fanning
    the barrier advance out to the worker threads and joining. Every
    decision runs byte-for-byte the parent's code — this is the
    equivalence oracle mode that must reproduce the golden BatchPlan
    traces (tests/test_torch_asyncfleet.py);
  * **wall mode** (``WallClock`` + ``start()``): workers free-run their
    replicas against real time, a control thread routes streaming
    arrivals on event-driven published snapshots and periodically parks
    the fleet at *soft barriers* where the inherited decision passes run
    verbatim;
  * **real cross-replica KV transfer**: the six controller seam hooks
    are overridden so that when both endpoints are real ``TorchEngine``\\ s,
    a migration moves the actual pages — the source engine's host-parked
    state (``export_swapped``: pages + recurrent state + sampling cursor
    + prompt + generated stream) crosses the modeled ``link_bw`` link and
    is imported by the destination engine, which resumes the sequence
    bit-identically. Sim↔sim keeps the historical accounting-only moves;
    mixed sim/real pairs fall back to the recompute path (there is no
    wire format across worlds).

Streaming front-end: ``subscribe(req)`` + ``submit_now(req)`` give a
per-request token queue fed by the owning worker with per-token wall
timestamps; ``asyncfleet.server.AsyncServer`` wraps this for asyncio.
"""
from __future__ import annotations

import functools
import heapq
import threading
from typing import Dict, List, Optional, Sequence

from repro_torch.core.kvpool import blocks_for
from repro_torch.core.request import Request
from repro_torch.serving.fleet.controller import FleetController
from repro_torch.serving.fleet.telemetry import replica_cost
from repro_torch.serving.replica import Replica

from .clock import VirtualClock, WallClock
from .worker import EngineWorker


class _Sub:
    __slots__ = ("req", "queue", "closed")

    def __init__(self, req, q):
        self.req = req
        self.queue = q
        self.closed = False


class AsyncFleet(FleetController):
    def __init__(self, replicas: Sequence[Replica], router=None, *,
                 clock=None, barrier_timeout_s: float = 60.0, **kw):
        super().__init__(replicas, router, **kw)
        self.clock = clock if clock is not None else VirtualClock()
        self.barrier_timeout_s = barrier_timeout_s
        self.workers = [EngineWorker(self, i)
                        for i in range(len(self.replicas))]
        self._started = False
        self._stopping = False
        self._control: Optional[threading.Thread] = None
        self._intake_lock = threading.Lock()
        # in-flight migration payloads: rid -> engine wire dict, set by a
        # detach hook and consumed by the matching receive hook within the
        # same barrier pass
        self._wire: Dict[int, dict] = {}
        # streaming front-end state (wall mode)
        self._subscribers: Dict[int, _Sub] = {}
        self._stream_pos: Dict[int, int] = {}
        self._forced: List[tuple] = []   # queued (rid, dst_i) live moves

    # ------------------------------------------------ engine discovery
    @staticmethod
    def engine_of(rep: Replica):
        """The real ``TorchEngine`` behind a replica's backend (unwrapping
        test shims exposing ``.inner``), or None for sim backends."""
        be = rep.backend
        for _ in range(4):
            if be is None:
                return None
            if hasattr(be, "_swap_store"):
                return be
            be = getattr(be, "inner", None)
        return None

    @staticmethod
    def _compatible(se, de) -> bool:
        """Two engines can exchange KV payloads only when their caches are
        layout- and content-compatible: same model config, same page
        geometry, same dtype, and the same parameter seed (different
        weights would decode garbage from transferred KV). The port also
        compares ``kv_quant``: int8 pages travel as four fields (pages and
        scales), bf16 and f32 pages as two, so neither engine can land
        the other's payload (the JAX check lacks this term; ROADMAP §3)."""
        return (se.cfg.name == de.cfg.name and se.seed == de.seed
                and se.paged and de.paged
                and se.block_size == de.block_size
                and se.dtype == de.dtype
                and se.kv_quant == de.kv_quant)

    # ------------------------------------------------ worker management
    def _ensure_workers(self) -> None:
        if not self._started:
            for w in self.workers:
                w.start()
            self._started = True

    def _check_errors(self) -> None:
        for w in self.workers:
            if w.error is not None:
                raise RuntimeError(
                    f"engine worker {w.index} died") from w.error

    # ------------------------------------------------ virtual mode
    # run() is inherited: the lockstep loop with every decision pass
    # unchanged. Only the barrier advance fans out to the worker threads.
    def _advance_to(self, t_end: Optional[float]) -> None:
        self._ensure_workers()
        if t_end is not None and not self.clock.wall:
            self.clock.advance(t_end)
        boxes = [w.submit(functools.partial(w.rep.run, until=t_end))
                 for w in self.workers]
        for b in boxes:
            b.result()
        self._check_errors()

    # ------------------------------------------------ wall mode
    def start(self) -> None:
        """Begin free-running wall-clock serving: workers serve their
        engines continuously; a control thread routes streaming arrivals
        and runs the global decision passes at periodic soft barriers."""
        assert self.clock.wall, \
            "start() is wall-clock serving; use run() with a VirtualClock"
        assert self._control is None, "fleet already started"
        self._ensure_workers()
        self._stopping = False
        for w in self.workers:
            w.free_running = True
        self._control = threading.Thread(target=self._control_loop,
                                         daemon=True, name="fleet-control")
        self._control.start()

    def submit_now(self, req: Request,
                   at: Optional[float] = None) -> None:
        """Thread-safe streaming intake: ``req`` arrives at wall-now (or
        ``at``) and is routed by the control loop on the next dispatch."""
        req.arrival = float(self.clock.now() if at is None else at)
        with self._intake_lock:
            heapq.heappush(self._pending, (req.arrival, self._seq, req))
            self._seq += 1
        self._count([req])

    def subscribe(self, req: Request):
        """Register a token stream for ``req`` BEFORE submitting it.
        Returns a ``queue.Queue`` receiving ``(index, token_id, t_wall)``
        per generated token and a final ``None`` sentinel. Sim-backed
        replicas emit ``-1`` placeholders (they hold no real tokens)."""
        import queue as _q
        q: "_q.Queue" = _q.Queue()
        self._subscribers[req.rid] = _Sub(req, q)
        self._stream_pos.setdefault(req.rid, 0)
        return q

    def request_live_move(self, rid: int, dst_i: int) -> None:
        """Queue a manual live migration of ``rid`` to replica ``dst_i``,
        executed at the next soft barrier (subject to the same capacity
        and compatibility gates as policy-driven moves)."""
        self._forced.append((rid, dst_i))

    def drain(self, timeout: float = 120.0, poll: float = 0.005) -> bool:
        """Wait until every submitted request has finished (wall mode)."""
        end = self.clock.now() + timeout
        while self.clock.now() < end:
            self._check_errors()
            if self.pending == 0:
                return True
            self.clock.sleep(poll)
        return False

    def stop(self) -> None:
        """End wall-clock serving and finalize the report."""
        self._stopping = True
        if self._control is not None:
            self._control.join(timeout=self.barrier_timeout_s)
            self._control = None
        for w in self.workers:
            w.free_running = False
        self._check_errors()
        self._finalize()

    def close(self) -> None:
        """Terminate the worker threads (irreversible; the fleet can no
        longer run). Daemon threads die with the process anyway — this is
        for eager cleanup in tests and long-lived drivers."""
        if self._control is not None:
            self.stop()
        for w in self.workers:
            w.stop()
        for w in self.workers:
            if w.is_alive():
                w.join(timeout=5.0)

    def _control_loop(self) -> None:
        try:
            last_barrier = self.clock.now()
            while not self._stopping:
                self._check_errors()
                now = self.clock.now()
                self._dispatch_due(now)
                if self.dynamic and now - last_barrier >= self.tick:
                    self._wall_barrier(now)
                    last_barrier = now
                self.clock.sleep(0.001)
        except BaseException:           # noqa: BLE001
            # surfaced by _check_errors() via the worker it came from, or
            # by stop(); park state is already consistent (finally blocks)
            self._stopping = True
            raise

    def _dispatch_due(self, now: float) -> None:
        """Route arrivals that are due, using the workers' *published*
        snapshots — event-driven telemetry, refreshed only when a
        replica's ``state_version`` moved, never a lockstep barrier."""
        due = []
        with self._intake_lock:
            while self._pending and self._pending[0][0] <= now:
                due.append(heapq.heappop(self._pending)[2])
        if not due:
            return
        if self.router is None:
            # offline dispatch mode: deliver round-robin by least index
            for req in due:
                self.workers[0].submit(
                    functools.partial(self.replicas[0].submit, req))
            return
        snaps = [w.published() for w in self.workers]
        self.router.begin_tick()
        for req in due:
            i = self.router.choose(req, snaps)
            self.workers[i].submit(
                functools.partial(self.replicas[i].submit, req))

    def _wall_barrier(self, t: float) -> None:
        """Soft barrier: park every worker, run the inherited global
        decision passes (which may move real KV via the hook overrides),
        release. Hang-proof: a dead worker reports itself parked."""
        for w in self.workers:
            w.request_park()
        for w in self.workers:
            if not w.wait_parked(self.barrier_timeout_s):
                raise TimeoutError(
                    f"engine worker {w.index} failed to park within "
                    f"{self.barrier_timeout_s}s")
        try:
            self._check_errors()
            snaps = [self._snapshot(i) for i in range(len(self.replicas))]
            self._observe(t, snaps)
            for rid, dst_i in self._take_forced():
                self._force_live_move(rid, dst_i, t, snaps)
            if self.offload:
                self._offload_relegated(t, snaps)
            if self.migrate:
                self._rebalance_queued(t, snaps)
            if self.live_migrate:
                self._migrate_live(t, snaps)
            self.report.ticks += 1
        finally:
            for w in self.workers:
                w.release()

    def _take_forced(self) -> List[tuple]:
        out, self._forced = self._forced, []
        return out

    def _force_live_move(self, rid: int, dst_i: int, t: float,
                         snaps) -> bool:
        src = req = None
        for si, rep in enumerate(self.replicas):
            req = next((r for r in rep.decode_queue if r.rid == rid), None)
            if req is not None:
                src = rep
                break
        if req is None or src is self.replicas[dst_i]:
            return False
        dst = self.replicas[dst_i]
        need = blocks_for(req.total_len, dst.kv.block_size) + 4
        if dst.kv.free < need or not self._live_ok(src, dst, req):
            return False
        dst_cost = replica_cost(dst)
        nbytes = (dst_cost.kv_transfer_bytes(req.total_len)
                  if dst_cost is not None else 0.0)
        pause = (dst_cost.link_transfer_time(nbytes)
                 if dst_cost is not None else 0.0)
        tokens = self._detach_live(src, req)
        if tokens is None:
            return False
        self._receive_live(dst, req, max(t, src.now) + pause, tokens)
        self._record_move(req, src, dst_i, t, "live", snaps,
                          count_backlog=False)
        self.report.live_migrations += 1
        self.report.kv_moved_bytes += nbytes
        return True

    # ------------------------------------------------ KV transfer hooks
    # Sim↔sim pairs keep the parent's accounting-only behavior (the
    # virtual-mode golden-trace guarantee). Real↔real pairs move actual
    # engine state; mixed pairs refuse (recompute path instead).
    def _transfer_ok(self, src: Replica, dst: Replica,
                     req: Request) -> bool:
        se, de = self.engine_of(src), self.engine_of(dst)
        if se is None and de is None:
            return True
        if se is None or de is None:
            return False
        return (self._compatible(se, de)
                and req.rid in se._swap_store
                # shared prefix head pages stay pinned in the source's
                # cache, NOT in its swap store: the payload would be
                # incomplete, so such requests take the recompute path
                and src.kv.resident_tokens(req.rid) == 0
                and getattr(dst.kv, "cfg", None) is not None
                and dst.kv.cfg.enable_swap)

    def _detach_swapped(self, src: Replica, req: Request) -> Optional[int]:
        se = self.engine_of(src)
        if se is None or req.rid not in se._swap_store:
            return super()._detach_swapped(src, req)
        # export BEFORE detaching: detach releases the pool entry, whose
        # runtime `drop` hook discards the engine's parked state
        payload = se.export_swapped(req.rid)
        tokens = super()._detach_swapped(src, req)
        if tokens is None:      # decision raced; restore the parked state
            se.import_swapped(req.rid, payload)
            return None
        self._wire[req.rid] = payload
        return tokens

    def _receive_swapped(self, dst: Replica, req: Request, t_arr: float,
                         tokens: int) -> bool:
        payload = self._wire.pop(req.rid, None)
        if payload is None:
            return super()._receive_swapped(dst, req, t_arr, tokens)
        de = self.engine_of(dst)
        de.import_swapped(req.rid, payload)
        if not super()._receive_swapped(dst, req, t_arr, tokens):
            # raced out of host room: discard the payload; the caller
            # falls back to the recompute path (the destination engine
            # regenerates the prompt deterministically from the rid)
            de.drop(req.rid)
            de.tokens.pop(req.rid, None)
            de.generated.pop(req.rid, None)
            return False
        return True

    def _live_ok(self, src: Replica, dst: Replica, req: Request) -> bool:
        se, de = self.engine_of(src), self.engine_of(dst)
        if se is None and de is None:
            return True
        if se is None or de is None:
            return False
        rid = req.rid
        host = getattr(dst.kv, "host", None)
        return (self._compatible(se, de)
                and rid in se.slot_of
                and bool(de.free_slots)
                # the full context must travel as one payload: no shared
                # prefix pages at the source (cache-owned, not swappable)
                and src.kv.resident_tokens(rid) == 0
                # it stages through the destination's host tier
                and host is not None
                and host.free >= blocks_for(req.total_len,
                                            dst.kv.block_size))

    def _detach_live(self, src: Replica, req: Request) -> Optional[int]:
        se = self.engine_of(src)
        if se is None or req.rid not in se.slot_of:
            return super()._detach_live(src, req)
        rid = req.rid
        # serialize the live state while the slot is still held: swap_out
        # pulls the pages + recurrent state + sampling cursor host-side,
        # export packages them with the prompt and generated stream
        se.swap_out(rid, src.kv.block_table(rid))
        payload = se.export_swapped(rid)
        tokens = super()._detach_live(src, req)
        if tokens is None:
            se.import_swapped(rid, payload)
            return None
        self._wire[rid] = payload
        return tokens

    def _receive_live(self, dst: Replica, req: Request, t_arr: float,
                      tokens: int) -> None:
        payload = self._wire.pop(req.rid, None)
        if payload is None:
            super()._receive_live(dst, req, t_arr, tokens)
            return
        de = self.engine_of(dst)
        de.import_swapped(req.rid, payload)
        ok = dst.receive_live_swapped(req, t_arr, tokens)
        # _live_ok reserved host room and a free slot at decision time,
        # and the fleet is parked at the barrier: landing cannot race
        assert ok, "live transfer landed without reserved capacity"
