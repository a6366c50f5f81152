"""Minimal Prometheus client (text exposition format).

A copy of ``kubeflow_tpu/runtime/metrics.py``: the port keeps its own
copy so that it imports nothing of the JAX package.

The reference registers custom collectors with controller-runtime's registry
(``notebook-controller/pkg/metrics/metrics.go:14-99``). No prometheus client
ships in this image, so this is a from-scratch implementation of the 20% we
use: counters, gauges, labels, and text-format exposition (the port
keeps the counters and gauges its serving engine and its telemetry
publisher register).
"""

from __future__ import annotations

import threading
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


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help_, label_names):
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
            metric = cls(name, help_, label_names or [])
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_: str = "", label_names: list[str] | None = None) -> Counter:
        return self._register(Counter, name, help_, label_names)

    def gauge(self, name: str, help_: str = "", label_names: list[str] | None = None) -> Gauge:
        return self._register(Gauge, name, help_, label_names)

    def expose(self) -> str:
        lines: list[str] = []
        for metric in self._metrics.values():
            lines.extend(metric.collect())
        return "\n".join(lines) + "\n"


global_registry = Registry()
