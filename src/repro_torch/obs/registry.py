"""Live metrics registry: Counter / Gauge / Histogram with labels and
Prometheus text-format export (docs/observability.md §Registry).

Zero-dependency by design (the container pins its package set): the text
renderer writes exposition format 0.0.4 by hand. Metrics follow the
Prometheus naming conventions — ``repro_`` namespace, ``_total`` suffix
on counters, base units (seconds, bytes) in the name.

Sources in this repo are mostly *pre-existing* cumulative counters
(``Replica.backpressure_defers``, ``TorchEngine.prefill_rows``,
``PrefixCache.hit_tokens``...). ``Counter.set_total`` exists for exactly
that scrape pattern: the registry mirrors the source's monotonic value
instead of double-counting increments (see ``obs/scrape.py``).
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._series: Dict[Tuple, float] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.label_names)

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0.0)

    def samples(self) -> List[Tuple[str, str, float]]:
        """(name, label_str, value) per series, label-sorted."""
        with self._lock:
            items = sorted(self._series.items())
        return [(self.name, _label_str(self.label_names, k), v)
                for k, v in items]

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for name, ls, v in self.samples():
            lines.append(f"{name}{ls} {_fmt(v)}")
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        assert amount >= 0, "counters only go up"
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def set_total(self, total: float, **labels) -> None:
        """Mirror an external cumulative counter: the stored value only
        ratchets up, so a scrape racing a source reset stays monotonic."""
        k = self._key(labels)
        with self._lock:
            self._series[k] = max(self._series.get(k, 0.0), float(total))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))
        # per-series: [bucket counts..., +Inf count], sum
        self._counts: Dict[Tuple, List[float]] = {}
        self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0.0] * (len(self.buckets) + 1))
            counts[bisect_left(self.buckets, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + float(value)
            self._series[k] = self._series.get(k, 0.0) + 1  # sample count

    def samples(self) -> List[Tuple[str, str, float]]:
        out: List[Tuple[str, str, float]] = []
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        names = self.label_names
        for k, counts in items:
            cum = 0.0
            for edge, c in zip(self.buckets, counts):
                cum += c
                out.append((self.name + "_bucket",
                            _label_str(names + ("le",), k + (_fmt(edge),)),
                            cum))
            cum += counts[-1]
            out.append((self.name + "_bucket",
                        _label_str(names + ("le",), k + ("+Inf",)), cum))
            out.append((self.name + "_sum", _label_str(names, k), sums[k]))
            out.append((self.name + "_count", _label_str(names, k), cum))
        return out


class MetricsRegistry:
    """Get-or-create metric namespace with a Prometheus text renderer.
    Re-registering a name returns the existing metric (so scrape passes
    are idempotent); a kind or label mismatch is a bug and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str,
             label_names: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, label_names, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) \
                or m.label_names != tuple(label_names):
            raise ValueError(f"metric {name!r} re-registered with a "
                             f"different kind or label set")
        return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, label_names,
                         buckets=buckets)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus exposition text (version 0.0.4)."""
        return "\n".join(m.render() for m in self.metrics()) + "\n"
