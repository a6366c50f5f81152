"""SLO feed for the serving loop.

A copy of the parts of ``kubeflow_tpu/runtime/slo.py`` that the serving
engine reaches: the ``serving_latency`` row of the SLI registry, its
objective from env, good/bad totals against the objective's threshold,
and the module-level :func:`observe` that the engine calls once per
completed request. With no engine installed (:func:`install`) the feed
is a no-op. The control plane's other SLIs, the time buckets, burn
rates and the ``/debug/slo`` payload are not part of the port.
"""

from __future__ import annotations

import os
import threading

from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry

# Master switch.
SLO_ENABLED_ENV = "KFTPU_SLO"

# The SLI registry: (name, objective env knob, default threshold seconds,
# default target, description).
SLI_SPECS = (
    ("serving_latency", "KFTPU_SLO_SERVING_LATENCY",
     2.0, 0.99,
     "per-request serving latency (arrival to completion) from the "
     "serving engine's continuous-batching loop"),
)


def slo_enabled(environ=os.environ) -> bool:
    """``KFTPU_SLO`` master switch — anything but off/false/0/no keeps
    the engine on."""
    return environ.get(SLO_ENABLED_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )


def objective_for(name: str, environ=os.environ) -> tuple[float, float]:
    """(threshold seconds, target fraction) for one SLI. Accepts
    ``"30"`` or ``"30:0.995"``; malformed values fall back to the spec
    default."""
    for sli, env, threshold, target, _desc in SLI_SPECS:
        if sli != name:
            continue
        raw = environ.get(env)
        if raw:
            head, _, tail = raw.strip().partition(":")
            try:
                threshold = float(head)
                if tail:
                    t = float(tail)
                    if 0.0 < t < 1.0:
                        target = t
            except ValueError:
                pass
        return threshold, target
    raise KeyError(f"unknown SLI {name!r} (registry: "
                   f"{[s[0] for s in SLI_SPECS]})")


class _Sli:
    """One SLI's good/bad totals against its threshold."""

    def __init__(self, name: str, threshold: float, target: float):
        self.name = name
        self.threshold = threshold
        self.target = target
        self.total_good = 0
        self.total_bad = 0

    def observe(self, seconds: float) -> bool:
        good = seconds <= self.threshold
        if good:
            self.total_good += 1
        else:
            self.total_bad += 1
        return good


class SloEngine:
    """Observes SLI events. Thread-safe — a serving worker thread may
    observe while another thread reads."""

    def __init__(self, registry: Registry | None = None, *,
                 environ=os.environ):
        self.enabled = slo_enabled(environ)
        self._lock = threading.Lock()
        self.slis: dict[str, _Sli] = {}
        for name, _env, _thr, _tgt, _desc in SLI_SPECS:
            thr, tgt = objective_for(name, environ)
            self.slis[name] = _Sli(name, thr, tgt)
        registry = registry or global_registry
        self.c_events = registry.counter(
            "tpu_slo_events_total",
            "SLI events by outcome vs the objective threshold",
            ["sli", "outcome"])

    def observe(self, sli: str, seconds: float) -> None:
        """Feed one measurement. Unknown SLI names raise."""
        if not self.enabled:
            return
        entry = self.slis.get(sli)
        if entry is None:
            raise KeyError(f"unknown SLI {sli!r}")
        with self._lock:
            good = entry.observe(float(seconds))
        self.c_events.labels(sli=sli,
                             outcome="good" if good else "bad").inc()


# ---- process-wide current engine -----------------------------------------------

_current: SloEngine | None = None


def install(engine: SloEngine | None) -> SloEngine | None:
    global _current
    _current = engine
    return engine


def observe(sli: str, seconds: float) -> None:
    """Feed the installed engine, if any."""
    engine = _current
    if engine is not None:
        engine.observe(sli, seconds)
