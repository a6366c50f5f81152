"""Fleet SLO engine: declarative SLIs, sliding windows, burn rates.

An operator serving millions of users needs one page that answers "are
we meeting our latency promises?" — not a wall of raw histograms. This
module is that layer, in the SRE multi-window multi-burn-rate idiom
(Google SRE workbook ch. 5; the Prometheus/OpenTelemetry ecosystem the
reference stack assumes):

- **Declarative SLI registry** (:data:`SLI_SPECS`): each SLI is a named
  latency promise — notebook time-to-ready, scheduler time-to-admission,
  drain roundtrip, serving request latency, reconcile latency — fed from
  the instrumentation that already exists (the scheduler's wait
  histogram, the drain timer, the manager's reconcile clock, the serving
  engine's completions). Zero new measurement points; the SLO layer is a
  second consumer of the same numbers.
- **Objectives from env** (``KFTPU_SLO_<SLI>``): ``"30"`` (seconds) or
  ``"30:0.995"`` (seconds:target). The default target is 0.99 — "99% of
  events under the threshold".
- **Sliding windows + burn rates**: per SLI, good/bad counters in
  10-second buckets retained for 6 h; burn rate over 5m/1h/6h windows is
  ``bad_fraction / error_budget`` — burn 1.0 spends the budget exactly
  at the objective's rate, 14.4 spends 2% of a 30-day budget per hour
  (the classic page threshold). Surfaced as
  ``tpu_slo_burn_rate{sli,window}`` / ``tpu_slo_budget_remaining{sli}``
  gauges and the ``/debug/slo`` page (worst offenders with exemplar
  trace ids linked from the flight recorder).

Overhead is bench-gated (``bench.py slo_overhead``, <5% of
control-plane throughput — the same protocol as the tracing gate);
:func:`set_enabled` is the A/B switch the bench flips.

The port's copy of ``kubeflow_tpu/runtime/slo.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry

# Master switch (docs/operations.md "SLOs & burn-rate alerting").
SLO_ENABLED_ENV = "KFTPU_SLO"

# The SLI registry: (name, objective env knob, default threshold seconds,
# default target, description). A PURE LITERAL on purpose — the
# ``slo-registry`` analysis pass (ci/analysis/passes/sloreg.py) reads it
# from the AST and fails CI when an SLI's knob or name is missing from
# docs/operations.md, so the registry and the runbook cannot drift.
SLI_SPECS = (
    ("notebook_time_to_ready", "KFTPU_SLO_NOTEBOOK_TIME_TO_READY",
     30.0, 0.99,
     "start of a notebook's startup episode (create / re-queue / "
     "restore) to every TPU worker Ready, from the lifecycle timeline"),
    ("scheduler_time_to_admission", "KFTPU_SLO_TIME_TO_ADMISSION",
     60.0, 0.99,
     "gang submission to fleet-scheduler admission (the scheduler's "
     "admission-wait histogram, per admitted gang)"),
    ("drain_roundtrip", "KFTPU_SLO_DRAIN_ROUNDTRIP",
     60.0, 0.99,
     "drain request to checkpoint-ack park (grace-deadline hard stops "
     "count as bad events at the full elapsed time)"),
    ("serving_latency", "KFTPU_SLO_SERVING_LATENCY",
     2.0, 0.99,
     "per-request serving latency (arrival to completion) from the "
     "serving engine's continuous-batching loop"),
    ("reconcile_latency", "KFTPU_SLO_RECONCILE_LATENCY",
     1.0, 0.999,
     "reconcile wall time per workqueue key across every controller"),
    ("checkpoint_commit", "KFTPU_SLO_CHECKPOINT_COMMIT",
     60.0, 0.99,
     "checkpoint snapshot-ack to durable commit (the background upload "
     "the drain SLI deliberately excludes; commit-grace timeouts count "
     "as bad events even when the grace is below the objective)"),
    ("restore", "KFTPU_SLO_RESTORE",
     30.0, 0.99,
     "checkpoint restore wall time through the tier fallthrough "
     "(staging or object store), including integrity-fallback reads"),
    ("training_step", "KFTPU_SLO_TRAINING_STEP",
     1.0, 0.99,
     "rolling-window p50 training-step wall time from the telemetry "
     "annotation, fed once per new publish seq by the notebook "
     "controller's status fold"),
)

# Multi-window set: the short window catches a fast burn the moment it
# starts, the long ones keep a slow leak visible. Fixed — alerting math
# (the 14.4/6 thresholds below) is calibrated to these widths.
WINDOWS = (("5m", 300.0), ("1h", 3600.0), ("6h", 21600.0))
LONGEST_WINDOW_SECONDS = 21600.0
BUCKET_SECONDS = 10.0

# Multi-window multi-burn-rate alerting thresholds (SRE workbook): page
# when BOTH the 5m and 1h burn exceed 14.4 (2% of a 30-day budget per
# hour, still burning), warn when both 1h and 6h exceed 6.
CRITICAL_BURN = 14.4
WARNING_BURN = 6.0

_enabled = True  # process-wide A/B switch for the overhead bench


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def slo_enabled(environ=os.environ) -> bool:
    """``KFTPU_SLO`` master switch — anything but off/false/0/no keeps
    the engine on."""
    return environ.get(SLO_ENABLED_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )


def objective_for(name: str, environ=os.environ) -> tuple[float, float]:
    """(threshold seconds, target fraction) for one SLI — the pure
    env-reading half, importable by the web backend (the JWA
    waiting-longer-than-expected message) without an engine. Accepts
    ``"30"`` or ``"30:0.995"``; malformed values fall back to the
    spec default."""
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
    """One SLI's counters: good/bad in time buckets + worst offenders."""

    def __init__(self, name: str, threshold: float, target: float,
                 description: str, env: str):
        self.name = name
        self.threshold = threshold
        self.target = target
        self.description = description
        self.env = env
        # deque of [bucket_index, good, bad]; bucket_index = now // 10s.
        self.buckets: deque = deque()
        # Worst offenders: recent bad observations with exemplar trace
        # ids (the /debug/slo → /debug/traces?key= join).
        self.offenders: deque = deque(maxlen=8)
        self.total_good = 0
        self.total_bad = 0

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    def observe(self, seconds: float, *, now: float, key=None,
                trace_id: str | None = None) -> bool:
        good = seconds <= self.threshold
        idx = int(now // BUCKET_SECONDS)
        if self.buckets and self.buckets[-1][0] == idx:
            bucket = self.buckets[-1]
        elif self.buckets and self.buckets[-1][0] > idx:
            bucket = self.buckets[-1]  # clock went backwards; keep order
        else:
            self.buckets.append([idx, 0, 0])
            bucket = self.buckets[-1]
        bucket[1 if good else 2] += 1
        if good:
            self.total_good += 1
        else:
            self.total_bad += 1
            self.offenders.append({
                "key": ("/".join(str(p) for p in key)
                        if isinstance(key, (tuple, list)) else key),
                "seconds": round(float(seconds), 4),
                "trace_id": trace_id,
                "at": now,
            })
        horizon = idx - int(LONGEST_WINDOW_SECONDS // BUCKET_SECONDS) - 1
        while self.buckets and self.buckets[0][0] < horizon:
            self.buckets.popleft()
        return good

    def counts(self, window_seconds: float, now: float) -> tuple[int, int]:
        """(good, bad) inside the trailing window."""
        cutoff = int((now - window_seconds) // BUCKET_SECONDS)
        good = bad = 0
        for idx, g, b in reversed(self.buckets):
            if idx <= cutoff:
                break
            good += g
            bad += b
        return good, bad

    def burn_rate(self, window_seconds: float, now: float) -> float:
        good, bad = self.counts(window_seconds, now)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / self.error_budget

    def budget_remaining(self, now: float) -> float:
        """Fraction of the error budget left over the LONGEST window,
        floored at 0 (a blown budget reads 0, never negative)."""
        good, bad = self.counts(LONGEST_WINDOW_SECONDS, now)
        total = good + bad
        if total == 0:
            return 1.0
        return max(0.0, 1.0 - (bad / total) / self.error_budget)

    def health(self, now: float) -> str:
        b5 = self.burn_rate(WINDOWS[0][1], now)
        b1 = self.burn_rate(WINDOWS[1][1], now)
        b6 = self.burn_rate(WINDOWS[2][1], now)
        if b5 >= CRITICAL_BURN and b1 >= CRITICAL_BURN:
            return "critical"
        if b1 >= WARNING_BURN and b6 >= WARNING_BURN:
            return "warning"
        return "ok"


class SloEngine:
    """The manager-owned engine: observes, computes burn rates, exposes
    the gauges and the ``/debug/slo`` payload. Thread-safe — the serving
    engine's worker thread observes while the event loop reads."""

    def __init__(self, registry: Registry | None = None, *,
                 environ=os.environ, now=time.time):
        self.enabled = slo_enabled(environ)
        self._now = now
        self._lock = threading.Lock()
        self.slis: dict[str, _Sli] = {}
        for name, env, _thr, _tgt, desc in SLI_SPECS:
            # objective_for is the ONE reader of the objective (spec
            # default + env override); the spec's literal defaults are
            # deliberately unused here.
            thr, tgt = objective_for(name, environ)
            self.slis[name] = _Sli(name, thr, tgt, desc, env)
        registry = registry or global_registry
        self.g_burn = registry.gauge(
            "tpu_slo_burn_rate",
            "Error-budget burn rate per SLI and window (1.0 = spending "
            "exactly at the objective's rate)", ["sli", "window"])
        self.g_budget = registry.gauge(
            "tpu_slo_budget_remaining",
            "Fraction of the 6h error budget remaining per SLI (never "
            "negative)", ["sli"])
        self.c_events = registry.counter(
            "tpu_slo_events_total",
            "SLI events by outcome vs the objective threshold",
            ["sli", "outcome"])

    def observe(self, sli: str, seconds: float, *, key=None,
                trace_id: str | None = None, now: float | None = None,
                ) -> None:
        """Feed one measurement. Unknown SLI names raise — a typo'd feed
        silently counting nowhere is exactly the drift class the
        registry exists to kill."""
        if not (_enabled and self.enabled):
            return
        entry = self.slis.get(sli)
        if entry is None:
            raise KeyError(f"unknown SLI {sli!r}")
        t = self._now() if now is None else now
        with self._lock:
            good = entry.observe(float(seconds), now=t, key=key,
                                 trace_id=trace_id)
        self.c_events.labels(sli=sli,
                             outcome="good" if good else "bad").inc()

    def refresh(self, now: float | None = None) -> None:
        """Recompute the burn/budget gauges (called by /metrics and
        /debug/slo — scrape-time, not per-observation)."""
        t = self._now() if now is None else now
        with self._lock:
            for name, entry in self.slis.items():
                for wname, wsec in WINDOWS:
                    self.g_burn.labels(sli=name, window=wname).set(
                        round(entry.burn_rate(wsec, t), 4))
                self.g_budget.labels(sli=name).set(
                    round(entry.budget_remaining(t), 4))

    def burn_rate(self, sli: str, window: str,
                  now: float | None = None) -> float:
        t = self._now() if now is None else now
        wsec = dict(WINDOWS)[window]
        with self._lock:
            return self.slis[sli].burn_rate(wsec, t)

    def counts(self, sli: str, window: str,
               now: float | None = None) -> tuple[int, int]:
        t = self._now() if now is None else now
        wsec = dict(WINDOWS)[window]
        with self._lock:
            return self.slis[sli].counts(wsec, t)

    def budget_remaining(self, sli: str, now: float | None = None) -> float:
        t = self._now() if now is None else now
        with self._lock:
            return self.slis[sli].budget_remaining(t)

    def debug_info(self, now: float | None = None) -> dict:
        """The ``/debug/slo`` payload: per-SLI objective, window counts,
        burn rates, budget, health, and the worst offenders with their
        exemplar trace ids."""
        t = self._now() if now is None else now
        out: dict = {"enabled": self.enabled and _enabled, "slis": []}
        worst_health = "ok"
        rank = {"ok": 0, "warning": 1, "critical": 2}
        with self._lock:
            for name, e in self.slis.items():
                health = e.health(t)
                if rank[health] > rank[worst_health]:
                    worst_health = health
                windows = {}
                for wname, wsec in WINDOWS:
                    good, bad = e.counts(wsec, t)
                    windows[wname] = {
                        "good": good, "bad": bad,
                        "burn_rate": round(e.burn_rate(wsec, t), 4),
                    }
                out["slis"].append({
                    "sli": name,
                    "description": e.description,
                    "objective": {
                        "threshold_seconds": e.threshold,
                        "target": e.target,
                        "env": e.env,
                    },
                    "windows": windows,
                    "budget_remaining": round(e.budget_remaining(t), 4),
                    "health": health,
                    "events": {"good": e.total_good, "bad": e.total_bad},
                    "worst_offenders": sorted(
                        ({**o, "at_ago_sec": round(t - o["at"], 1)}
                         for o in e.offenders),
                        key=lambda o: -o["seconds"]),
                })
        out["health"] = worst_health
        out["alerting"] = {
            "critical": f"burn_rate(5m) >= {CRITICAL_BURN} AND "
                        f"burn_rate(1h) >= {CRITICAL_BURN}",
            "warning": f"burn_rate(1h) >= {WARNING_BURN} AND "
                       f"burn_rate(6h) >= {WARNING_BURN}",
        }
        return out


# ---- process-wide current engine -----------------------------------------------
# Producers scattered across layers (scheduler admission, drain finalize,
# serving engine completions) feed the module-level observe(): the
# manager installs its engine at construction, so no constructor
# threading is needed — exactly the "zero new instrumentation points"
# contract. No engine installed (bare unit tests) → feeds are no-ops.

_current: SloEngine | None = None


def install(engine: SloEngine | None) -> SloEngine | None:
    global _current
    _current = engine
    return engine


def current() -> SloEngine | None:
    return _current


def observe(sli: str, seconds: float, *, key=None,
            trace_id: str | None = None) -> None:
    engine = _current
    if engine is not None:
        engine.observe(sli, seconds, key=key, trace_id=trace_id)
