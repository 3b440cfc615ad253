"""Host-RAM swap tier for relegated KV state.

A relegated request's private HBM blocks move here instead of being freed
for recompute; the blocks are pinned (host RAM is cheap, the pool exists
to bound the model, not to thrash) until the request resumes — swap-in
back over the PCIe/host link — finishes, or is re-homed to another
replica (transfer over ``link_bw``, see the fleet controller).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class HostSwapPool:
    capacity_blocks: int
    _held: Dict[int, int] = field(default_factory=dict)   # rid -> blocks
    swap_outs: int = 0
    swap_ins: int = 0

    @property
    def used(self) -> int:
        return sum(self._held.values())

    @property
    def free(self) -> int:
        return self.capacity_blocks - self.used

    def held(self, rid: int) -> int:
        return self._held.get(rid, 0)

    def put(self, rid: int, blocks: int) -> bool:
        """Swap ``blocks`` out for ``rid``; False (no-op) if it won't fit."""
        if blocks <= 0:
            return True
        if blocks > self.free:
            return False
        assert rid not in self._held, f"rid {rid} already swapped"
        self._held[rid] = blocks
        self.swap_outs += 1
        return True

    def take(self, rid: int) -> int:
        """Remove and return ``rid``'s swapped blocks (swap-in/drop/moved)."""
        n = self._held.pop(rid, 0)
        if n:
            self.swap_ins += 1
        return n
