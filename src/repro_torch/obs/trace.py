"""Structured lifecycle trace layer (docs/observability.md §Span schema).

A ``TraceRecorder`` is a thread-safe, ring-buffered event log. The serving
stack carries optional ``tracer`` attributes (``Replica.tracer``,
``FleetController.tracer``) that default to ``None``; every instrumentation
site is guarded by that check, so with no recorder attached the traced
code is byte-identical to the untraced code (inertness — the golden
BatchPlan digests in tests/test_obs.py). When a recorder IS attached, the
hooks only read decision *outputs* after they are final: recording cannot
change what the scheduler or the fleet controller decides.

Event kinds (one dict per event, ``kind`` + ``t`` + kind-specific fields;
``EVENT_SCHEMA`` is the validation contract the CI smoke checks JSONL
against):

  arrive    request handed to a replica's intake           (rid, rep)
  enqueue   admitted from intake into a queue              (rid, rep, phase)
  iter      one executed scheduling iteration              (rep, t0,
            elapsed, predicted, prefill=[[rid, chunk]..], decode=[rid..],
            sched=admission-verdict detail or None)
  defer     engine backpressure deferred a prefill tail    (rep, rids)
  relegate  request parked by eager relegation             (rid, rep)
  resume    relegated request re-entered the prefill queue (rid, rep)
  migrate   cross-replica move decided at a barrier        (rid, src, dst,
            mkind, bytes, t_arr)
  finish    request completed                              (rid, rep)
  abort     request abandoned without finishing            (rid, rep)

``iter.sched`` (present when the scheduler filled ``BatchPlan.trace``)
records the admission verdict: the hybrid keys of every candidate in
priority order, the losing candidates, the chunk budget and the solver
inputs that produced it (slack, alpha, backlog, swap budget).
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

#: kind -> fields required on top of ("kind", "t")
EVENT_SCHEMA: Dict[str, tuple] = {
    "arrive": ("rid", "rep"),
    "enqueue": ("rid", "rep", "phase"),
    "iter": ("rep", "t0", "elapsed", "predicted", "prefill", "decode"),
    "defer": ("rep", "rids"),
    "relegate": ("rid", "rep"),
    "resume": ("rid", "rep"),
    "migrate": ("rid", "src", "dst", "mkind", "bytes", "t_arr"),
    "finish": ("rid", "rep"),
    "abort": ("rid", "rep"),
}


def _json_safe(v):
    """JSONL must stay loadable by strict parsers: non-finite floats
    (slack can be +inf with an empty decode batch) become None."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


class TraceRecorder:
    """Ring-buffered span/event recorder. ``emit`` is cheap and
    thread-safe (wall-mode engine workers all record into one ring);
    the ring drops the OLDEST events on overflow and counts the drops so
    a truncated trace is never mistaken for a complete one."""

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self.enabled = True

    # ------------------------------------------------ recording
    def emit(self, kind: str, t: float, **fields) -> None:
        if not self.enabled:
            return
        ev = {"kind": kind, "t": float(t)}
        ev.update(fields)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> List[dict]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # ------------------------------------------------ export
    def export_jsonl(self, path: str) -> int:
        """One JSON object per line, in emission order. Returns the number
        of events written."""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(_json_safe(ev), sort_keys=True))
                f.write("\n")
        return len(evs)

    def export_chrome(self, path: str) -> int:
        """Chrome ``trace_event`` JSON (load via chrome://tracing or
        https://ui.perfetto.dev). Replicas map to pids; executed
        iterations are complete ("X") slices on tid 0, lifecycle and
        migration events are instants on tid 1. Timestamps are in
        microseconds of replica/fleet clock time."""
        out = []
        for ev in self.events():
            kind = ev["kind"]
            if kind == "iter":
                out.append({
                    "name": (f"iter p{len(ev['prefill'])}"
                             f" d{len(ev['decode'])}"),
                    "ph": "X", "pid": ev["rep"], "tid": 0,
                    "ts": ev["t0"] * 1e6, "dur": ev["elapsed"] * 1e6,
                    "args": _json_safe({
                        "predicted_s": ev["predicted"],
                        "prefill": ev["prefill"], "decode": ev["decode"],
                        "sched": ev.get("sched")}),
                })
            elif kind == "migrate":
                out.append({
                    "name": f"migrate:{ev['mkind']} rid={ev['rid']}",
                    "ph": "X", "pid": ev["src"], "tid": 1,
                    "ts": ev["t"] * 1e6,
                    "dur": max(ev["t_arr"] - ev["t"], 0.0) * 1e6,
                    "args": _json_safe({"dst": ev["dst"],
                                        "bytes": ev["bytes"]}),
                })
            else:
                pid = ev.get("rep", ev.get("src", 0))
                args = {k: v for k, v in ev.items()
                        if k not in ("kind", "t", "rep")}
                out.append({
                    "name": f"{kind} rid={ev['rid']}" if "rid" in ev
                            else kind,
                    "ph": "i", "s": "p", "pid": pid, "tid": 1,
                    "ts": ev["t"] * 1e6, "args": _json_safe(args),
                })
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
        return len(out)


def validate_events(events: Iterable[dict],
                    max_errors: int = 20) -> List[str]:
    """Check events against ``EVENT_SCHEMA``; returns a list of error
    strings (empty = valid). Used by tests and the CI trace smoke."""
    errors: List[str] = []
    for i, ev in enumerate(events):
        if len(errors) >= max_errors:
            errors.append("... (further errors suppressed)")
            break
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        kind = ev.get("kind")
        if kind not in EVENT_SCHEMA:
            errors.append(f"event {i}: unknown kind {kind!r}")
            continue
        if not isinstance(ev.get("t"), (int, float)):
            errors.append(f"event {i} ({kind}): missing numeric 't'")
        missing = [f for f in EVENT_SCHEMA[kind] if f not in ev]
        if missing:
            errors.append(f"event {i} ({kind}): missing {missing}")
    return errors


def install_tracer(target, recorder: Optional[TraceRecorder]
                   ) -> Optional[TraceRecorder]:
    """Attach (or detach, with ``None``) a recorder to a replica, a list
    of replicas, or a fleet controller and all its replicas. Returns the
    recorder for chaining."""
    reps: Sequence = ()
    if hasattr(target, "replicas"):          # a fleet controller
        target.tracer = recorder
        reps = target.replicas
    elif isinstance(target, (list, tuple)):
        reps = target
    else:
        reps = (target,)
    for rep in reps:
        rep.tracer = recorder
    return recorder
