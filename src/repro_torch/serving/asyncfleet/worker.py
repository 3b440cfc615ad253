"""Per-engine worker threads for the async fleet runtime.

Thread-ownership contract (docs/fleet.md §Async runtime): ALL mutation of
a replica — its queues, its KV pool, and its engine's device state — runs
on that replica's one ``EngineWorker`` thread. Other threads interact in
exactly three ways:

  * ``submit(fn)`` — enqueue a thunk to run on the worker thread (intake
    delivery, virtual-mode ``rep.run`` advances) and get a waitable box;
  * ``request_park()`` / ``wait_parked()`` / ``release()`` — the soft
    barrier: once parked, the worker is quiescent and the control thread
    may touch the replica directly (the migration passes);
  * ``published()`` — a copy of the last snapshot the worker published,
    keyed on ``Replica.state_version`` (re-published only when the
    replica actually changed), for event-driven routing.

A worker that dies stores the exception in ``.error`` AND reports itself
parked, so a barrier never deadlocks on a corpse; the controller re-raises
on its next health check.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Optional

from repro_torch.core.request import Phase
from repro_torch.serving.fleet.telemetry import snapshot


class Box:
    """A waitable result slot for a thunk shipped to a worker thread."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.value = None
        self.exc: Optional[BaseException] = None
        self.done = threading.Event()

    def run(self) -> None:
        try:
            self.value = self.fn()
        except BaseException as e:      # noqa: BLE001 — re-raised in result()
            self.exc = e
        finally:
            self.done.set()

    def result(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError("worker thunk did not complete in time")
        if self.exc is not None:
            raise self.exc
        return self.value


class EngineWorker(threading.Thread):
    """One thread per replica/engine. In *virtual* mode it only executes
    submitted thunks (the lockstep controller ships ``rep.run(until=...)``
    advances). In *wall* mode (``free_running=True``) it additionally
    serves its replica continuously against the fleet's wall clock,
    publishing telemetry snapshots and emitting stream tokens."""

    #: seconds a quiescent worker blocks on its command queue per loop
    IDLE_WAIT = 0.02

    def __init__(self, fleet, index: int):
        super().__init__(daemon=True, name=f"engine-worker-{index}")
        self.fleet = fleet
        self.index = index
        self.rep = fleet.replicas[index]
        self.engine = fleet.engine_of(self.rep)
        self.free_running = False
        self.error: Optional[BaseException] = None
        self._cmds: "queue.Queue" = queue.Queue()
        self._park_req = threading.Event()
        self._parked = threading.Event()
        self._release_evt = threading.Event()
        self._halt = False
        # snapshot publishing: (state_version, pristine snapshot). The
        # counter is observable so tests can assert the dirty-flag
        # contract: re-published exactly when the version moved.
        self.publishes = 0
        self._published = (self.rep.state_version, snapshot(self.rep))

    # ------------------------------------------------ cross-thread API
    def submit(self, fn: Callable) -> Box:
        box = Box(fn)
        self._cmds.put(box)
        return box

    def call(self, fn: Callable, timeout: Optional[float] = None):
        return self.submit(fn).result(timeout)

    def request_park(self) -> None:
        self._release_evt.clear()
        self._park_req.set()
        self._cmds.put(None)            # nudge out of a queue wait

    def wait_parked(self, timeout: Optional[float] = None) -> bool:
        return self._parked.wait(timeout)

    def release(self) -> None:
        self._park_req.clear()
        self._parked.clear()
        self._release_evt.set()

    def stop(self) -> None:
        self._halt = True
        self._cmds.put(None)

    def published(self):
        """Copy of the last published snapshot (never the pristine one:
        routers mutate snapshots in place for same-batch accounting)."""
        snap = self._published[1]
        return dataclasses.replace(snap, tier_mix=dict(snap.tier_mix))

    # ------------------------------------------------ thread body
    def run(self) -> None:
        try:
            while not self._halt:
                self._tick()
        except BaseException as e:      # noqa: BLE001 — surfaced via .error
            self.error = e
            self._parked.set()          # a barrier must never wait on a corpse

    def _tick(self) -> None:
        if self._park_req.is_set():
            # quiescent: commands queued during a barrier are NOT run (the
            # control thread owns the replica until release), they drain
            # right after
            self._parked.set()
            self._release_evt.wait(self.IDLE_WAIT)
            return
        busy = self.free_running and self._has_work_now()
        try:
            cmd = self._cmds.get(block=not busy,
                                 timeout=None if busy else self.IDLE_WAIT)
        except queue.Empty:
            cmd = None
        if cmd is not None:
            cmd.run()
            return
        if busy and not self._park_req.is_set():
            self._step_wall()

    # ------------------------------------------------ wall-mode serving
    def _has_work_now(self) -> bool:
        rep = self.rep
        if rep.prefill_queue or rep.decode_queue:
            return True
        now = self.fleet.clock.now()
        if rep._arrivals and rep._arrivals[0][0] <= now:
            return True
        if rep.relegated_queue:
            park = rep._relegated_park()
            return any(r.relegated_at is None
                       or now >= r.relegated_at + park
                       for r in rep.relegated_queue)
        return False

    def _step_wall(self) -> None:
        rep = self.rep
        now = self.fleet.clock.now()
        # the replica's virtual clock is slaved to the wall: it never
        # admits a future arrival early, and idle jumps may not cross
        # wall-now (horizon), so deliveries timed in the future (e.g. a
        # migration's modeled link pause) really are waited out
        rep.horizon = now
        if rep.now < now:
            rep.now = now
        it0 = rep.iterations
        rep.step()
        rep.horizon = None
        self._publish()
        self._emit()
        if rep.iterations == it0:
            # no engine work ran (blocked admission / empty plan): yield
            # the core briefly instead of spinning the scheduler
            self.fleet.clock.sleep(0.001)

    def _publish(self) -> None:
        rep = self.rep
        if self._published[0] != rep.state_version:
            self._published = (rep.state_version, snapshot(rep))
            self.publishes += 1

    def _owns(self, req) -> bool:
        rep = self.rep
        return (req in rep.finished or req in rep.decode_queue
                or req in rep.prefill_queue or req in rep.relegated_queue
                or any(r is req for _, _, r in rep._arrivals))

    def _emit(self) -> None:
        """Push newly decoded tokens of subscribed requests into their
        stream queues, stamped with the wall clock. Stream position lives
        on the fleet (``_stream_pos``): request ownership only changes at
        barriers (all workers parked), so exactly one worker emits for a
        given request at any time and positions survive migration."""
        subs = self.fleet._subscribers
        if not subs:
            return
        now = self.fleet.clock.now()
        for rid, sub in list(subs.items()):
            req = sub.req
            if sub.closed or not self._owns(req):
                continue
            pos = self.fleet._stream_pos.get(rid, 0)
            n = req.decoded
            if n > pos:
                gen = self.engine.generated.get(rid) \
                    if self.engine is not None else None
                for i in range(pos, n):
                    tok = int(gen[i]) if gen is not None else -1
                    sub.queue.put((i, tok, now))
                self.fleet._stream_pos[rid] = n
            if req.phase is Phase.FINISHED:
                sub.closed = True
                sub.queue.put(None)     # end-of-stream sentinel
