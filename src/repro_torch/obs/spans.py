"""Program spans: named host intervals at the port's layer boundaries
(``replica.*`` in ``Replica.step``, ``engine.*`` in
``TorchEngine.execute``, ``moe.*`` and ``engine.host_read`` in the MoE
FFN), on the profiler's clock (docs/observability.md §Program spans).

``span(name)`` is a context manager:

- off (the default) it returns one shared ``nullcontext``, unless a
  ``torch.profiler`` is recording: then it enters
  ``record_function(name)``, so the span lands on the trace's timeline
  beside the kernels launched inside it;
- on (``enable(True)``) it also adds the block's ``perf_counter``
  seconds and one call under ``name`` in a process-wide table
  (``totals()``, ``reset()``), guarded by a lock as
  ``TraceRecorder.emit`` is.

Spans only read the clock: they never change what the program computes
or decides. The module imports torch only once torch is loaded (a
profiler cannot run before), so the simulator's replica stays torch-free.
"""
from __future__ import annotations

import sys
import threading
import time
from contextlib import nullcontext
from typing import Dict, Tuple

_ON = False
_NULL = nullcontext()
_lock = threading.Lock()
_table: Dict[str, list] = {}     # name -> [calls, seconds]
_probe = None    # torch.autograd._profiler_enabled, once torch is loaded


def _never() -> bool:
    return False


def _find_probe():
    """The profiler's query once torch is loaded (a profiler cannot
    record before), else a query that answers no."""
    global _probe
    torch = sys.modules.get("torch")
    if torch is None:
        return _never
    _probe = torch.autograd._profiler_enabled
    return _probe


def _record(name: str):
    from torch.autograd.profiler import record_function
    return record_function(name)


class _Timed:
    """An on span: the profiler's range where one records, and the
    block's seconds into the table."""
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if (_probe or _find_probe())():
            self.rf = _record(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _lock:
            row = _table.get(self.name)
            if row is None:
                _table[self.name] = [1, dt]
            else:
                row[0] += 1
                row[1] += dt
        return False


def span(name: str):
    """The context manager of the span ``name``: see the module's
    docstring."""
    if _ON:
        return _Timed(name)
    if (_probe or _find_probe())():
        return _record(name)
    return _NULL


def enable(on: bool = True) -> None:
    """Turn the table on or off for the whole process."""
    global _ON
    _ON = bool(on)


def totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (calls, seconds)}`` of every span closed while on."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _table.items()}


def reset() -> None:
    with _lock:
        _table.clear()
