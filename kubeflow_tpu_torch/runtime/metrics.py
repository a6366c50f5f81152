"""Minimal Prometheus client (text exposition format).

The reference registers custom collectors with controller-runtime's registry
(``notebook-controller/pkg/metrics/metrics.go:14-99``). No prometheus client
ships in this image, so this is a from-scratch implementation of the 20% we
use: counters, gauges, histograms, labels, and text-format exposition.

The port's copy of ``kubeflow_tpu/runtime/metrics.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


def _escape_label_value(value: str) -> str:
    """Prometheus text exposition escaping for label values: backslash,
    double-quote, and newline (a notebook name containing a quote would
    otherwise corrupt the whole /metrics scrape)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Child:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class _Metric:
    type_name = "untyped"

    def __init__(self, name: str, help_: str, label_names: list[str]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: dict[tuple, _Child] = defaultdict(_Child)

    def labels(self, **labels: str) -> _Child:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        return self._children[key]

    # convenience for label-less metrics
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def collect(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.type_name}",
        ]
        children = self._children or {(): _Child()}
        for key, child in sorted(children.items()):
            labels = dict(zip(self.label_names, key))
            lines.append(f"{self.name}{_fmt_labels(labels)} {child.value}")
        return lines


class Counter(_Metric):
    type_name = "counter"


class Gauge(_Metric):
    type_name = "gauge"


class _HistogramChild:
    """A label-bound observer. ``hist.labels(...)`` used to inherit the
    counter/gauge child from ``_Metric`` and silently write into a dead
    ``_children`` map that ``Histogram.collect()`` never read — data was
    dropped. Now labels() routes to observe() and the counter/gauge verbs
    raise instead of lying."""

    def __init__(self, hist: "Histogram", labels: dict):
        self._hist = hist
        self._labels = labels

    def observe(self, value: float) -> None:
        self._hist.observe(value, **self._labels)

    def time(self) -> "_Timer":
        return _Timer(self._hist, self._labels)

    def inc(self, amount: float = 1.0) -> None:
        raise TypeError("histograms have no inc(); use observe()")

    def set(self, value: float) -> None:
        raise TypeError("histograms have no set(); use observe()")


class Histogram(_Metric):
    type_name = "histogram"

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)

    def __init__(self, name, help_, label_names, buckets=None):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._data: dict[tuple, dict] = defaultdict(
            lambda: {"counts": [0] * len(self.buckets), "sum": 0.0, "count": 0}
        )
        self._lock = threading.Lock()

    def labels(self, **labels: str) -> _HistogramChild:
        return _HistogramChild(self, labels)

    def inc(self, amount: float = 1.0) -> None:
        raise TypeError("histograms have no inc(); use observe()")

    def set(self, value: float) -> None:
        raise TypeError("histograms have no set(); use observe()")

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            data = self._data[key]
            data["sum"] += value
            data["count"] += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    data["counts"][i] += 1
                    break  # collect() cumulates; counting once keeps buckets monotone

    def time(self, **labels: str) -> "_Timer":
        """``with hist.time(controller="notebook"): ...`` observes the
        block's wall duration — the reconcile-latency idiom."""
        return _Timer(self, labels)

    def snapshot(self, **labels: str) -> dict:
        """(count, sum) for one label set — lets the bench report mean
        latency without parsing the exposition text."""
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            data = self._data.get(key)
            return {"count": data["count"], "sum": data["sum"]} if data else \
                {"count": 0, "sum": 0.0}


    def collect(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        for key, data in sorted(self._data.items()):
            labels = dict(zip(self.label_names, key))
            cumulative = 0
            for bound, count in zip(self.buckets, data["counts"]):
                cumulative += count
                lines.append(
                    f'{self.name}_bucket{_fmt_labels({**labels, "le": str(bound)})} {cumulative}'
                )
            lines.append(f'{self.name}_bucket{_fmt_labels({**labels, "le": "+Inf"})} {data["count"]}')
            lines.append(f"{self.name}_sum{_fmt_labels(labels)} {data['sum']}")
            lines.append(f"{self.name}_count{_fmt_labels(labels)} {data['count']}")
        return lines


class _Timer:
    def __init__(self, hist: Histogram, labels: dict):
        self._hist = hist
        self._labels = labels

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.perf_counter() - self._t0, **self._labels)


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help_, label_names, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                # Re-registration is idempotent ONLY for an identical
                # schema; silently returning a metric with different label
                # names or type would make writers disagree with collect()
                # about the label tuple and corrupt the series.
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}"
                    )
                if existing.label_names != list(label_names or []):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{existing.label_names}, not {list(label_names or [])}"
                    )
                return existing
            metric = cls(name, help_, label_names or [], **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_: str = "", label_names: list[str] | None = None) -> Counter:
        return self._register(Counter, name, help_, label_names)

    def gauge(self, name: str, help_: str = "", label_names: list[str] | None = None) -> Gauge:
        return self._register(Gauge, name, help_, label_names)

    def histogram(
        self, name: str, help_: str = "", label_names: list[str] | None = None, buckets=None
    ) -> Histogram:
        return self._register(Histogram, name, help_, label_names, buckets=buckets)

    def expose(self) -> str:
        lines: list[str] = []
        for metric in self._metrics.values():
            lines.extend(metric.collect())
        return "\n".join(lines) + "\n"


global_registry = Registry()
