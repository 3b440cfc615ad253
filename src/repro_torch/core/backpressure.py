"""Typed engine backpressure (jax-free so the serving layer can catch it).

A real engine has hard physical limits the scheduler's accounting can be
configured to overshoot: concurrent decode rows (``n_slots``) and physical
KV blocks (``num_blocks`` x ``block_size``). Historically hitting either
mid-``execute`` raised a bare ``RuntimeError`` and killed the serving
loop. ``EngineBackpressure`` keeps the message (the sizing advice in it is
load-bearing for operators and asserted by tests) but makes the condition
*structured*: admission code catches it, reads how much of the plan DID
fit (``n_prefill_fit``), defers the rest, and retries — oversubscription
degrades to queueing instead of a crash.

Subclasses ``RuntimeError`` so pre-existing ``except RuntimeError``
handlers (and tests matching on it) keep working unchanged.
"""
from __future__ import annotations

from typing import Optional


class EngineBackpressure(RuntimeError):
    """An engine cannot take more work right now.

    ``kind``
        ``"slots"`` (all decode rows busy) or ``"kv"`` (page pool
        exhausted).
    ``n_prefill_fit``
        How many of the plan's prefill items (in plan order) the engine
        could have executed before resources ran out. ``None`` means the
        shortfall is not deferrable by trimming prefills — the decode
        batch itself does not fit, which is a sizing bug, not transient
        pressure.
    ``n_slots`` / ``num_blocks`` / ``block_size``
        The engine's physical capacity, for operator-facing messages.
    """

    def __init__(self, message: str, *, kind: str,
                 n_prefill_fit: Optional[int] = None,
                 n_slots: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 rid: Optional[int] = None):
        super().__init__(message)
        self.kind = kind
        self.n_prefill_fit = n_prefill_fit
        self.n_slots = n_slots
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.rid = rid

    @property
    def deferrable(self) -> bool:
        """True when dropping tail prefill items can relieve the pressure
        this iteration (the decode batch itself fits)."""
        return self.n_prefill_fit is not None
