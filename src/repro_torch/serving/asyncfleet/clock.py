"""Injectable clocks for the async fleet runtime.

The runtime never calls ``time`` directly — it asks its clock. That one
seam is what makes the equivalence oracle possible: under a
``VirtualClock`` the async machinery (worker threads, barriers, the
streaming front-end) runs against deterministic virtual time and must
reproduce the lockstep controller's golden BatchPlan traces decision for
decision; under the ``WallClock`` the same code serves real engines in
real time (docs/fleet.md §Async runtime).
"""
from __future__ import annotations

import time


class WallClock:
    """Real time, zeroed at construction so fleet timestamps are small
    positive floats comparable to the simulator's virtual seconds."""

    wall = True

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Deterministic virtual time, advanced explicitly by the runtime's
    lockstep loop. ``sleep`` advances instead of blocking, so code written
    against the wall clock degrades to a no-wait simulation."""

    wall = False

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def advance(self, t: float) -> None:
        self._t = max(self._t, float(t))

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self._t += dt
