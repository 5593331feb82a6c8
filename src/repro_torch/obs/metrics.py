"""Typed metrics: Counter / Gauge / Histogram with label sets (a copy of
the reference's ``obs/metrics.py``; framework-free).

A :class:`MetricsRegistry` owns named metrics; each metric owns children
keyed by label-value tuples. ``registry.render_prometheus()`` emits the
Prometheus text exposition format so an RPC front can serve the string
as ``/metrics`` verbatim.

Histograms keep cumulative buckets (Prometheus convention) plus an
optional bounded reservoir of raw samples so exact small-n percentiles
(e.g. the service's ``p50_ms``/``p99_ms`` wire fields) survive the
migration from ad-hoc deques.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "render_prometheus", "DEFAULT_BUCKETS"]

# Latency-flavoured default buckets (seconds): 100us .. 60s.
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

LabelKey = Tuple[str, ...]


def _label_key(metric: "_Metric", labels: Dict[str, Any]) -> LabelKey:
    if set(labels) != set(metric.label_names):
        raise ValueError(
            f"{metric.name}: expected labels {metric.label_names}, "
            f"got {tuple(sorted(labels))}")
    return tuple(str(labels[k]) for k in metric.label_names)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(label_names)
        self._lock = threading.Lock()

    def _fmt_labels(self, key: LabelKey,
                    extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = list(zip(self.label_names, key)) + list(extra)
        if not pairs:
            return ""
        body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
        return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


class Counter(_Metric):
    """Monotonic counter (per label set)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 label_names: Iterable[str] = ()):
        super().__init__(name, help, label_names)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = _label_key(self, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(self, labels)
        with self._lock:
            return self._values.get(key, 0)

    def values(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values()) if self._values else 0

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0)]
        return [f"{self.name}{self._fmt_labels(k)} {_num(v)}"
                for k, v in items]


class Gauge(_Metric):
    """Point-in-time value; supports inc/dec/set and high-watermarks."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 label_names: Iterable[str] = ()):
        super().__init__(name, help, label_names)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(self, labels)
        with self._lock:
            self._values[key] = value

    def set_max(self, value: float, **labels: Any) -> None:
        """Keep the running maximum (high-watermark gauges)."""
        key = _label_key(self, labels)
        with self._lock:
            if value > self._values.get(key, float("-inf")):
                self._values[key] = value

    def inc(self, amount: float = 1, **labels: Any) -> None:
        key = _label_key(self, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: Any) -> float:
        key = _label_key(self, labels)
        with self._lock:
            return self._values.get(key, 0)

    def values(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0)]
        return [f"{self.name}{self._fmt_labels(k)} {_num(v)}"
                for k, v in items]


class _HistChild:
    __slots__ = ("counts", "sum", "count", "reservoir")

    def __init__(self, n_buckets: int, reservoir: int):
        self.counts = [0] * n_buckets   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        self.reservoir: Optional[Deque[float]] = (
            deque(maxlen=reservoir) if reservoir else None)


class Histogram(_Metric):
    """Bucketed distribution + optional raw-sample reservoir."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 reservoir: int = 0):
        super().__init__(name, help, label_names)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.reservoir_size = reservoir
        self._children: Dict[LabelKey, _HistChild] = {}

    def _child(self, key: LabelKey) -> _HistChild:
        child = self._children.get(key)
        if child is None:
            child = self._children.setdefault(
                key, _HistChild(len(self.buckets) + 1, self.reservoir_size))
        return child

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(self, labels)
        idx = bisect_left(self.buckets, value)
        with self._lock:
            child = self._child(key)
            child.counts[idx] += 1
            child.sum += value
            child.count += 1
            if child.reservoir is not None:
                child.reservoir.append(value)

    def count(self, **labels: Any) -> int:
        key = _label_key(self, labels)
        with self._lock:
            child = self._children.get(key)
            return child.count if child else 0

    def sum(self, **labels: Any) -> float:
        key = _label_key(self, labels)
        with self._lock:
            child = self._children.get(key)
            return child.sum if child else 0.0

    def samples(self, **labels: Any) -> List[float]:
        """The raw reservoir (most recent samples), oldest first."""
        key = _label_key(self, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None or child.reservoir is None:
                return []
            return list(child.reservoir)

    def percentile(self, q: float, **labels: Any) -> float:
        """Exact percentile over the reservoir (recent samples).

        Falls back to a bucket upper-bound estimate when the reservoir
        is disabled. Returns 0.0 with no samples.
        """
        key = _label_key(self, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None or child.count == 0:
                return 0.0
            if child.reservoir:
                data = sorted(child.reservoir)
                pos = min(len(data) - 1,
                          max(0, math.ceil(q / 100.0 * len(data)) - 1))
                return data[pos]
            # bucket-based estimate: first bucket whose cumulative count
            # covers the quantile
            target = q / 100.0 * child.count
            cum = 0
            for i, c in enumerate(child.counts):
                cum += c
                if cum >= target:
                    return (self.buckets[i] if i < len(self.buckets)
                            else self.buckets[-1])
            return self.buckets[-1]

    def values(self) -> Dict[LabelKey, Tuple[int, float]]:
        with self._lock:
            return {k: (c.count, c.sum) for k, c in self._children.items()}

    def render(self) -> List[str]:
        lines: List[str] = []
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            cum = 0
            for i, bound in enumerate(self.buckets):
                cum += child.counts[i]
                lines.append(
                    f"{self.name}_bucket"
                    f"{self._fmt_labels(key, (('le', _num(bound)),))} {cum}")
            cum += child.counts[-1]
            lines.append(
                f"{self.name}_bucket"
                f"{self._fmt_labels(key, (('le', '+Inf'),))} {cum}")
            lines.append(
                f"{self.name}_sum{self._fmt_labels(key)} {_num(child.sum)}")
            lines.append(
                f"{self.name}_count{self._fmt_labels(key)} {child.count}")
        return lines


def _num(v: float) -> str:
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class MetricsRegistry:
    """Named metrics with get-or-create semantics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, label_names, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, label_names=label_names, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise TypeError(f"{name} already registered as {m.kind}")
        if m.label_names != tuple(label_names):
            raise ValueError(f"{name}: label mismatch "
                             f"{m.label_names} vs {tuple(label_names)}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  reservoir: int = 0) -> Histogram:
        return self._get(Histogram, name, help, tuple(labels),
                         buckets=buckets, reservoir=reservoir)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def value(self, name: str, default: float = 0.0, **labels: Any) -> float:
        """Scalar read of a counter/gauge (0/default when absent)."""
        m = self.get(name)
        if m is None or not isinstance(m, (Counter, Gauge)):
            return default
        return m.value(**labels)

    def collect(self) -> Dict[str, Dict[LabelKey, Any]]:
        """Snapshot {metric_name: {label_key: value}} for tests/benches."""
        out: Dict[str, Dict[LabelKey, Any]] = {}
        for m in self.metrics():
            out[m.name] = m.values()
        return out

    def render_prometheus(self) -> str:
        return render_prometheus(self)


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Prometheus text exposition across one or more registries."""
    lines: List[str] = []
    seen = set()
    for reg in registries:
        for m in sorted(reg.metrics(), key=lambda m: m.name):
            if m.name in seen:      # first registry wins on name clash
                continue
            seen.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
    return "\n".join(lines) + ("\n" if lines else "")
