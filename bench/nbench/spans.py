"""The program's spans (``repro_torch.obs.spans``) in a run: the traced
span's idle time put down to them, the launches inside them, and the
host seconds of the span table's per-step deltas.

``reduce_program`` walks the same profiler events as
``profile.reduce_events`` and leaves its readings as they are:

- **idle by span**: each instant of the device's idle gaps inside
  ``bench.profiled`` goes to the innermost host span open then among
  ``bench.*``, ``replica.*`` and ``engine.*`` (``moe.*`` is passed over,
  so the MoE's launches count as ``engine.launch``), or to
  ``bench.loop`` outside them all. A sweep over the spans' start and end
  points with a stack of the open ones, so nesting of any depth and any
  number of closed children are put down right (``profile._by_host``
  looks at the last four spans opened, enough for the harness's own
  two-deep spans and no more);
- **launches**: the launch calls of the ``cuda*`` and ``cu*`` APIs
  (names holding ``LaunchKernel`` or ``LaunchCooperativeKernel``; a
  ``cudaGraphLaunch`` counts once) that start inside an ``engine.launch`` span, and the
  number of such spans: one a step that ran the forward;
- **kernel events**: the device's kernels (no copies, no fills of
  memory) that start inside the traced span, to hold the launches to.

``host_readings`` reads the per-step deltas of the span table (``{name:
(calls, seconds)}``, one a ``Replica.step``) of the steps it is given.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from nbench.profile import SPAN, _is_device, _kernels, _merge

OWNERS = ("bench.", "replica.", "engine.")
OUTSIDE = "bench.loop"
LAUNCH = "engine.launch"
HOST_READ = "engine.host_read"
ENGINE = ("engine.pack", LAUNCH, "engine.sync", "engine.post")
# host work while nothing new is queued on the card
SERIAL = ("replica.admit", "replica.schedule", "replica.apply",
          "engine.pack", "engine.post")


@dataclass
class ProgramTrace:
    window_s: float
    idle_s: float
    idle_by_span: Dict[str, float]   # largest first
    launches: int                    # launch calls inside engine.launch
    launch_spans: int                # engine.launch spans in the window
    kernel_events: int               # kernels starting in the window
    launches_by_name: Dict[str, int] = field(default_factory=dict)

    @property
    def idle_launch_pct(self) -> Optional[float]:
        """Share of the traced span with no kernel running while the
        innermost open span is ``engine.launch``, in %; None without an
        ``engine.launch`` span or without a kernel (no device ran)."""
        if not self.launch_spans or not self.kernel_events \
                or self.window_s <= 0:
            return None
        return 100.0 * self.idle_by_span.get(LAUNCH, 0.0) / self.window_s

    @property
    def launches_per_step(self) -> Optional[float]:
        if not self.launch_spans or not self.launches:
            return None
        return self.launches / self.launch_spans


def is_launch(name: str) -> bool:
    return ("LaunchKernel" in name or "LaunchCooperativeKernel" in name
            or "GraphLaunch" in name)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def innermost(host: Iterable[Tuple[float, float, str]], w0: float,
              w1: float) -> List[Tuple[float, float, str]]:
    """[w0, w1] cut into (start, end, name) pieces, ``name`` the innermost
    of the ``host`` spans open there (the latest opened of those that
    contain it), ``OUTSIDE`` where none is."""
    stack: List[Tuple[float, float, str]] = []
    segs: List[Tuple[float, float, str]] = []
    t = w0

    def upto(x: float) -> None:
        nonlocal t
        while t < x:
            while stack and stack[-1][1] <= t:
                stack.pop()
            if stack:
                y, name = min(x, stack[-1][1]), stack[-1][2]
            else:
                y, name = x, OUTSIDE
            segs.append((t, y, name))
            t = y

    # the outer of two spans opened at one instant first
    for a, b, name in sorted(host, key=lambda h: (h[0], -h[1])):
        if a >= w1:
            break
        upto(a)
        while stack and stack[-1][1] <= a:
            stack.pop()
        stack.append((a, b, name))
    upto(w1)
    return segs


def split_gaps(gaps: Iterable[Tuple[float, float]],
               segs: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of ``gaps`` (profiler microseconds) under each piece's
    name; both lists in time order."""
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


def reduce_program(events) -> ProgramTrace:
    """Seconds throughout; event times are the profiler's microseconds."""
    outer = [e for e in events if e.name == SPAN and not _is_device(e)]
    if not outer:
        raise RuntimeError(f"the trace holds no {SPAN} span")
    w0, w1 = outer[0].time_range.start, outer[0].time_range.end
    iv, n_kernels = [], 0
    for e in _kernels(events):
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        iv.append((a, b))
        if not _is_copy(e.name) and w0 <= e.time_range.start < w1:
            n_kernels += 1
    busy = _merge(iv)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host, launch_iv, calls = [], [], []
    for e in events:
        if _is_device(e):
            continue
        r = e.time_range
        if e.name.startswith(OWNERS) and e.name != SPAN:
            host.append((r.start, r.end, e.name))
            if e.name == LAUNCH and r.start < w1 and r.end > w0:
                launch_iv.append((r.start, r.end))
        elif is_launch(e.name):
            calls.append((r.start, e.name))
    idle = split_gaps(gaps, innermost(host, w0, w1))
    n_spans = len(launch_iv)
    launch_iv = _merge(launch_iv)
    starts = [a for a, _ in launch_iv]
    by_name: Dict[str, int] = {}
    for t, name in calls:
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= launch_iv[k][1]:
            by_name[name] = by_name.get(name, 0) + 1
    return ProgramTrace(
        window_s=(w1 - w0) * 1e-6,
        idle_s=sum(b - a for a, b in gaps) * 1e-6,
        idle_by_span=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        launches=sum(by_name.values()), launch_spans=n_spans,
        kernel_events=n_kernels, launches_by_name=by_name)


def delta(after: Mapping[str, Tuple[int, float]],
          before: Mapping[str, Tuple[int, float]]
          ) -> Dict[str, Tuple[int, float]]:
    """``after`` less ``before``, names that moved only."""
    out = {}
    for k, (c, s) in after.items():
        c0, s0 = before.get(k, (0, 0.0))
        if c != c0:
            out[k] = (c - c0, s - s0)
    return out


def host_readings(deltas: List[Mapping[str, Tuple[int, float]]]
                  ) -> Dict[str, Optional[float]]:
    """Means over the steps given, of each step's delta of the table:

    - ``engine_launch_ms``: host ms inside ``engine.launch`` less its
      ``engine.host_read`` children;
    - ``host_serial_ms``: host ms in ``replica.admit``,
      ``replica.schedule``, ``replica.apply``, ``engine.pack`` and
      ``engine.post``;
    - ``host_reads_per_step``: ``engine.host_read`` spans;
    - ``engine_spans_ms``: the four ``engine.*`` spans' ms, over the
      steps that opened ``engine.launch`` only (to hold beside
      ``engine_ms.*``).

    None where no step opened ``engine.launch``."""
    def s(d, k):
        return d.get(k, (0, 0.0))[1]
    ran = [d for d in deltas if LAUNCH in d]
    if not ran:
        return {k: None for k in ("engine_launch_ms", "host_serial_ms",
                                  "host_reads_per_step", "engine_spans_ms")}
    n = len(deltas)
    return {
        "engine_launch_ms": 1e3 * sum(s(d, LAUNCH) - s(d, HOST_READ)
                                      for d in deltas) / n,
        "host_serial_ms": 1e3 * sum(s(d, k) for d in deltas
                                    for k in SERIAL) / n,
        "host_reads_per_step": sum(d.get(HOST_READ, (0, 0.0))[0]
                                   for d in deltas) / n,
        "engine_spans_ms": 1e3 * sum(s(d, k) for d in ran
                                     for k in ENGINE) / len(ran)}
