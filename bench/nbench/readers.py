"""Arithmetic that several metric readers share."""
from __future__ import annotations

from typing import Optional

from nbench.records import Run
from nbench.yardstick import PEAK_FLOPS


def mfu_pct(run: Run) -> Optional[float]:
    """Model FLOPs of the work the window's steps did (the family's
    ``step_flops``: for a decoder every real token's projections and
    FFN, a routed FFN's chosen experts only, attention over the visible
    keys, the head over the rows that emitted a token) over the window's
    seconds at the card's dense peak in the served dtype, in %. A traced
    run reads the part of the window before the profiler started
    (``Run.host_steps``)."""
    flops = sum(run.family.step_flops(run.model, s.chunks, s.ctxs,
                                      s.sampled)
                for s in run.host_steps())
    seconds = run.host_end - run.t_open
    return 100.0 * flops / (seconds * PEAK_FLOPS[run.dtype]) \
        if flops and seconds > 0 else None


def engine_ms(run: Run) -> Optional[float]:
    """Mean wall ms of the engine's ``execute`` over the window's steps
    (``TorchEngine.iteration_log``), before the profiler started."""
    s = [x.engine_s for x in run.host_steps() if x.engine_s is not None]
    return 1e3 * sum(s) / len(s) if s else None
