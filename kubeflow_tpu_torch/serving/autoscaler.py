"""Pure replica-autoscaling policy for InferenceServices: a copy of
``kubeflow_tpu/serving/autoscaler.py`` (no accelerator in it).

Knative-KPA-shaped, reduced to a clock-free function of
``(config, observed signals, current state, now)`` so tier-1 can
property-test it under seeded random traffic without an event loop:

- **demand**: replicas needed = max(rate/target_rate,
  inflight/target_inflight), ceil'd — whichever signal is hotter wins
  (a slow model saturates on concurrency long before rate).
- **bounds**: the recommendation is always clamped to
  ``[min_replicas, max_replicas]``.
- **scale-up is immediate**: burst traffic must not wait out a window.
- **scale-down is stabilized**: the effective recommendation is the
  MAXIMUM over the trailing ``scale_down_stabilization_seconds`` — one
  quiet sample between two bursts must not flap replicas (and with them
  whole GPU slice gangs) down and back up.
- **scale-to-zero is a separate, stricter gate**: only with
  ``min_replicas == 0``, zero demand, AND no request for
  ``scale_to_zero_after_seconds`` — an idle *window*, not an idle
  sample. A service that has never seen a request idles from
  ``created_at``.
- **SLO-driven scaling**: when the SLO engine is on,
  ``Signals.burn_rate`` carries the ``serving_latency`` error-budget
  burn rate and the policy scales to protect the *objective*, not a
  proxy: critical burn forces an aggressive step-up, warning burn adds
  a replica, any burn above budget blocks scale-down. With
  ``burn_rate=None`` (``KFTPU_SLO`` off) every code path below is
  byte-for-byte the raw rate/concurrency policy — the kill-switch test
  pins that.

The ledger is deliberately not consulted here: the fleet scheduler owns
cards. The autoscaler says how many replicas the service *wants*; each
wanted replica then bids through
``GpuFleetScheduler.serving_admission`` and may sit Queued — desired
and admitted are different numbers, and the controller surfaces both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class AutoscalerConfig:
    min_replicas: int = 0
    max_replicas: int = 1
    # Demand targets: how much load one replica is sized for.
    target_rate_per_replica: float = 8.0       # requests/sec
    target_inflight_per_replica: float = 4.0   # concurrent requests
    # Scale-to-zero: only after this long with no request (and only when
    # min_replicas == 0).
    scale_to_zero_after_seconds: float = 300.0
    # Scale-down hold: the recommendation may only drop once it has been
    # below the current count for this long.
    scale_down_stabilization_seconds: float = 60.0
    # SLO-driven scaling thresholds over the serving_latency error
    # budget — literals deliberately mirror runtime/slo.py's paging
    # calibration (CRITICAL_BURN / WARNING_BURN) without importing it:
    # this module stays pure and dependency-free for property tests.
    burn_critical: float = 14.4
    burn_warning: float = 6.0

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                "max_replicas must be >= max(1, min_replicas); got "
                f"min={self.min_replicas} max={self.max_replicas}")


@dataclass(frozen=True)
class Signals:
    """Observed load, as stamped on the CR by the gateway/load generator."""

    rate: float = 0.0              # requests/sec (EWMA)
    inflight: float = 0.0          # concurrent requests right now
    last_request_at: float | None = None   # epoch seconds; None = never
    # serving_latency error-budget burn rate from the SLO engine's fast
    # window, or None when KFTPU_SLO is off. None keeps the decision
    # function byte-for-byte the raw rate/concurrency policy.
    burn_rate: float | None = None


@dataclass
class AutoscalerState:
    """Carried across decisions (the controller keeps one per service).
    ``window`` holds (t, raw recommendation) samples inside the
    stabilization window — the scale-down hold is its max."""

    window: list = field(default_factory=list)
    created_at: float = 0.0        # idle floor for never-hit services


@dataclass(frozen=True)
class Decision:
    replicas: int
    raw: int                       # unstabilized demand (diagnostics)
    reason: str


def _demand(cfg: AutoscalerConfig, signals: Signals) -> int:
    by_rate = (signals.rate / cfg.target_rate_per_replica
               if cfg.target_rate_per_replica > 0 else 0.0)
    by_inflight = (signals.inflight / cfg.target_inflight_per_replica
                   if cfg.target_inflight_per_replica > 0 else 0.0)
    need = max(by_rate, by_inflight)
    return int(math.ceil(need - 1e-9)) if need > 0 else 0


def _slo_demand(cfg: AutoscalerConfig, signals: Signals,
                current: int) -> int | None:
    """SLO-driven demand overlay: how many replicas the burn rate says
    we need, or ``None`` when the SLO signal is absent or the budget is
    healthy (burn <= 1 means the objective is being met — the raw
    policy decides alone, including scale-down)."""
    burn = signals.burn_rate
    if burn is None or burn <= 1.0:
        return None
    if burn >= cfg.burn_critical:
        # Paging-grade burn: step up hard (+50%, at least one replica)
        # — waiting for the rate signal to catch up is how p99 SLOs die.
        return current + max(1, math.ceil(current * 0.5))
    if burn >= cfg.burn_warning:
        return current + 1
    # Budget burning but below warning: hold the line — never scale
    # down while the objective is losing ground.
    return current


def desired_replicas(cfg: AutoscalerConfig, signals: Signals,
                     current: int, now: float,
                     state: AutoscalerState | None = None) -> Decision:
    """One autoscaling decision. Pure given (cfg, signals, current, now,
    state); mutates only ``state`` (the trailing window)."""
    state = state if state is not None else AutoscalerState(created_at=now)
    raw = _demand(cfg, signals)
    slo_need = _slo_demand(cfg, signals, current)
    demand = raw if slo_need is None else max(raw, slo_need)
    slo_driven = demand > raw      # the SLO overlay raised the ask
    floor = cfg.min_replicas
    # Any live demand keeps at least one replica even at min_replicas=0
    # — scale-to-zero is the stricter gate below, never a side effect of
    # a rate rounding to zero replicas.
    if demand > 0:
        floor = max(floor, 1)
    bounded = max(floor, min(cfg.max_replicas, max(demand, floor)))

    # Trailing-window stabilization: remember this sample, drop expired
    # ones, and never scale below the window's high-water mark.
    state.window.append((now, bounded))
    cutoff = now - cfg.scale_down_stabilization_seconds
    state.window[:] = [(t, r) for t, r in state.window if t >= cutoff]
    hold = max(r for _, r in state.window)

    if bounded >= current:
        if bounded > current:
            if slo_driven:
                # Stable strings (no live burn number): these land in
                # status under write-elision, same as the hold reasons.
                kind = ("critical"
                        if signals.burn_rate >= cfg.burn_critical
                        else "warning")
                return Decision(bounded, demand, "scale-up: "
                                f"serving_latency burn-rate {kind} (SLO)")
            return Decision(bounded, demand, "scale-up: demand "
                            f"{demand} replica(s)")
        if slo_driven and raw < current:
            return Decision(current, demand,
                            "hold: serving_latency burn above budget (SLO)")
        return Decision(current, demand, "steady")

    # Candidate scale-down. Zero is gated separately and harder.
    target = max(bounded, min(hold, current))
    if target == 0:
        last = signals.last_request_at
        idle_since = last if last is not None else state.created_at
        if signals.inflight > 0 or signals.rate > 0:
            return Decision(max(current, 1), demand,
                            "hold: live traffic blocks scale-to-zero")
        if now - idle_since < cfg.scale_to_zero_after_seconds:
            # Reason strings land in status and must stay STABLE while
            # the situation is unchanged — a live seconds counter here
            # would defeat the controller's status write-elision and
            # patch the CR every pass for the whole idle window.
            return Decision(max(current if current > 0 else 1,
                                max(floor, 1)), demand,
                            "hold: inside the scale-to-zero idle window "
                            f"({cfg.scale_to_zero_after_seconds:.0f}s)")
        return Decision(0, demand, "scale-to-zero: idle past the window")
    if target < current:
        return Decision(target, demand,
                        f"scale-down (stabilized over "
                        f"{cfg.scale_down_stabilization_seconds:.0f}s)")
    return Decision(current, demand, "hold: stabilization window")


def config_from_spec(scaling: dict, *,
                     default_target_rate: float = 8.0,
                     default_idle_window: float = 300.0,
                     default_stabilization: float = 60.0,
                     ) -> AutoscalerConfig:
    """spec.scaling → AutoscalerConfig with operator-level defaults for
    the knobs the CR leaves unset (cmd/envconfig.py serving_options)."""

    def _num(key: str, default: float) -> float:
        try:
            value = float(scaling.get(key, default))
        except (TypeError, ValueError):
            return default
        return value if value > 0 else default

    return AutoscalerConfig(
        min_replicas=max(0, int(scaling.get("minReplicas", 0) or 0)),
        max_replicas=max(1, int(scaling.get("maxReplicas", 1) or 1),
                         int(scaling.get("minReplicas", 0) or 0)),
        target_rate_per_replica=_num("targetRequestsPerReplica",
                                     default_target_rate),
        scale_to_zero_after_seconds=_num("scaleToZeroAfterSeconds",
                                         default_idle_window),
        scale_down_stabilization_seconds=_num(
            "scaleDownStabilizationSeconds", default_stabilization),
    )
