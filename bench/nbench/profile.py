"""The traced span of a run: ``torch.profiler`` over the host and the
card, its events kept in memory, reduced once the window has closed.

Reduction: the device's busy seconds are the union of its kernels'
intervals inside the span ``bench.profiled`` (from the profiler's start
to the end of the last step it saw); each kernel's seconds are summed by
the name the profiler gives; a host span's device seconds are what its
event adds up from the kernels launched inside it (``moe.experts`` and
its kin, opened by the program); every idle stretch of the device is
split by the innermost ``bench.*`` host span open at each instant of it
(``bench.schedule``, ``bench.step`` for the rest of the
replica's step, ``bench.wait`` for the wait for arrivals), or to
``bench.loop`` outside them.
"""
from __future__ import annotations

import bisect
from contextlib import contextmanager
from typing import Dict, List, Tuple

from nbench.records import Trace

SPAN = "bench.profiled"


class Profiled:
    def __init__(self, device):
        self.device = device
        self.on = False
        self.prof = None
        self._outer = None

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._outer = record_function(SPAN)
        self._outer.__enter__()
        self.on = True

    def stop(self) -> None:
        import torch
        self._outer.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        self.on = False

    def reduce(self, steps: int) -> Trace:
        return reduce_events(self.prof.events(), steps)


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _kernels(events):
    """The device's own activity: its events but the host spans' copies
    on the device timeline (user annotations), which share a host
    event's name."""
    host = {e.name for e in events if not _is_device(e)}
    return [e for e in events if _is_device(e) and e.name not in host
            and not getattr(e, "is_user_annotation", False)]


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _device_us(e) -> float:
    attr = "device_time_total" if hasattr(e, "device_time_total") \
        else "cuda_time_total"
    return float(getattr(e, attr, 0.0) or 0.0)


def _by_host(gaps, host, w0: float, w1: float) -> Dict[str, float]:
    """Seconds of ``gaps`` under each host span, each instant put down to
    the innermost span open then (the latest opened; the loop's spans
    nest at most two deep, so it is among the last few opened)."""
    cuts = sorted({w0, w1, *(h[0] for h in host), *(h[1] for h in host)})
    starts = [h[0] for h in host]
    segs = []
    for x, y in zip(cuts, cuts[1:]):
        mid, name = (x + y) / 2, "bench.loop"
        k = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, k - 4):k]):
            if h[1] >= mid:
                name = h[2]
                break
        segs.append((x, y, name))
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            x, y, name = segs[k]
            o = min(b, y) - max(a, x)
            if o > 0:
                out[name] = out.get(name, 0.0) + o * 1e-6
            k += 1
    return out


def reduce_events(events, steps: int) -> Trace:
    """Seconds throughout; event times are the profiler's microseconds."""
    outer = [e for e in events if e.name == SPAN and not _is_device(e)]
    if not outer:
        raise RuntimeError(f"the trace holds no {SPAN} span")
    w0, w1 = outer[0].time_range.start, outer[0].time_range.end
    kernels: Dict[str, float] = {}
    iv = []
    for e in _kernels(events):
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        iv.append((a, b))
        kernels[e.name] = kernels.get(e.name, 0.0) + (b - a) * 1e-6
    busy = _merge(iv)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans: Dict[str, float] = {}
    host = []
    for e in events:
        if _is_device(e):
            continue
        if e.name.startswith("bench.") and e.name != SPAN:
            host.append((e.time_range.start, e.time_range.end, e.name))
        elif "." in e.name and not e.name.startswith("aten::"):
            spans[e.name] = spans.get(e.name, 0.0) + _device_us(e) * 1e-6
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = _by_host(gaps, sorted(host), w0, w1)
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, kernels=kernels,
                 spans=spans, idle=idle, steps=steps)
