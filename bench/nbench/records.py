"""What a run leaves for the metric readers: the requests and the steps
on the wall clock, the window, the model's sizes and family module and,
in a traced run, the reduced trace. ``pct`` is a frozen copy of
``repro_torch/serving/metrics.py::_pct`` (numpy's linear percentile).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def pct(xs: Sequence[float], q: float) -> Optional[float]:
    """``_pct``, or None where there is nothing to read."""
    return _pct(xs, q) if len(xs) else None


@dataclass
class ReqRec:
    rid: int
    due: float
    tier: str
    interactive: bool
    prompt_len: int
    decode_len: int
    in_window: bool
    admitted: Optional[float] = None      # first step that prefilled it
    tokens: List[float] = field(default_factory=list)   # wall times

    def done_by(self, t: float) -> bool:
        return len(self.tokens) >= self.decode_len and self.tokens[-1] <= t


@dataclass
class StepRec:
    t0: float                  # wall clock as the step began
    t1: float = 0.0            # wall clock as it returned
    sched_s: float = 0.0       # host seconds inside the scheduler
    engine_s: Optional[float] = None     # the engine's own seconds
    predicted_s: Optional[float] = None  # the scheduler's prediction
    chunks: List[Tuple[int, int]] = field(default_factory=list)
    ctxs: List[int] = field(default_factory=list)  # decode, after write
    sampled: int = 0           # rows that emitted a token
    kv_used: int = 0
    kv_total: int = 1
    profiled: bool = False


@dataclass
class Trace:
    """A traced span, reduced: its seconds, the device's busy seconds
    inside it, device seconds by kernel name and by host span, and the
    idle seconds by what the host was doing."""
    window_s: float
    busy_s: float
    kernels: Dict[str, float]
    spans: Dict[str, float]
    idle: Dict[str, float]
    steps: int


@dataclass
class Run:
    model: dict
    seconds: float
    t_open: float
    t_close: float
    setup_s: float
    reqs: List[ReqRec]
    steps: List[StepRec]
    serve: dict = field(default_factory=dict)
    trace: Optional[Trace] = None
    t_prof: Optional[float] = None   # the profiler's start, traced runs
    family: Optional[ModuleType] = None   # the model's family module

    @property
    def host_end(self) -> float:
        """The end of the part of the window that ran without the
        profiler: its start in a traced run, the close otherwise."""
        return self.t_close if self.t_prof is None else self.t_prof

    @property
    def dtype(self):
        import torch
        return getattr(torch, self.serve["dtype"])

    def tbt_gaps(self, end: float) -> List[float]:
        """Seconds between consecutive output tokens of the interactive
        tier, for every gap that ends in [``t_open``, ``end``); a request
        of the tier still decoding at ``end`` adds its open gap, counted
        to ``end``."""
        gaps = []
        for r in self.reqs:
            if not r.interactive or not r.tokens:
                continue
            ts = [t for t in r.tokens if t < end]
            gaps += [b - a for a, b in zip(ts, ts[1:]) if b >= self.t_open]
            if ts and len(ts) < r.decode_len:
                gaps.append(end - ts[-1])
        return gaps

    def window_reqs(self) -> List[ReqRec]:
        return [r for r in self.reqs if r.in_window]

    def window_steps(self) -> List[StepRec]:
        """Steps that returned inside the window."""
        return [s for s in self.steps
                if self.t_open <= s.t1 < self.t_close]

    def host_steps(self) -> List[StepRec]:
        """The window's steps that returned before the profiler started
        (all of them in an untraced run): what the host-side readers
        read, so that the profiler's own cost is not in them."""
        return [s for s in self.window_steps() if s.t1 < self.host_end]

    def traced_steps(self) -> List[StepRec]:
        return [s for s in self.steps if s.profiled]
