"""The port's replica autoscaler (``kubeflow_tpu_torch/serving/
autoscaler.py``): the property tests of tests/test_serving_autoscaler.py
against the port's module, and seeded traces on which the port's
``desired_replicas`` equals the reference's at every tick, with the SLO
burn-rate overlay on and off.

The ledger-composition property drives the port's GPU policy queue over
the fleet the reference's TPU one maps to (``v5e`` ``2x2``, one host of
4 chips, → ``nvidia-h100-80gb`` ``1x4``, one node of 4 cards).
"""

import math
import random

import pytest

from kubeflow_tpu.serving import autoscaler as ref
from kubeflow_tpu_torch.scheduler.fleet import Fleet
from kubeflow_tpu_torch.scheduler.policy import (GangRequest, PolicyConfig,
                                                 PolicyQueue)
from kubeflow_tpu_torch.serving import autoscaler as port
from kubeflow_tpu_torch.serving.autoscaler import (
    AutoscalerConfig,
    AutoscalerState,
    Signals,
    config_from_spec,
    desired_replicas,
)

CFG = AutoscalerConfig(
    min_replicas=0, max_replicas=4, target_rate_per_replica=8.0,
    target_inflight_per_replica=4.0, scale_to_zero_after_seconds=300.0,
    scale_down_stabilization_seconds=60.0)
H100 = "nvidia-h100-80gb"


def _decide(signals, current, now, state=None, cfg=CFG):
    return desired_replicas(cfg, Signals(**signals), current, now,
                            state or AutoscalerState(created_at=0.0))


# (signals, current, now, created_at, replicas, reason fragment)
POINT_CASES = {
    "ceil": (dict(rate=8.1), 1, 10.0, 0.0, 2, "scale-up"),
    "clamped_to_max": (dict(rate=1000.0), 2, 11.0, 0.0, 4, "scale-up"),
    "any_demand_keeps_one": (dict(rate=0.01), 0, 10.0, 0.0, 1, "scale-up"),
    "inside_idle_window": (dict(rate=0.0, last_request_at=900.0), 1, 1000.0,
                           0.0, 1, "idle window"),
    "past_idle_window": (dict(rate=0.0, last_request_at=600.0), 1, 1000.0,
                         0.0, 0, "scale-to-zero"),
    "never_hit_inside_window": (dict(), 1, 150.0, 100.0, 1, "idle window"),
    "never_hit_past_window": (dict(), 1, 500.0, 100.0, 0, "scale-to-zero"),
    "inflight_blocks_zero": (dict(inflight=0.5, last_request_at=0.0), 1,
                             10_000.0, 0.0, 1, ""),
    "critical_burn": (dict(rate=1.0, last_request_at=10.0, burn_rate=20.0),
                      2, 10.0, 0.0, 3,
                      "scale-up: serving_latency burn-rate critical (SLO)"),
    "critical_burn_clamped": (dict(rate=1.0, last_request_at=10.0,
                                   burn_rate=20.0), 4, 11.0, 0.0, 4, ""),
    "warning_burn": (dict(rate=1.0, last_request_at=10.0, burn_rate=7.0), 2,
                     10.0, 0.0, 3,
                     "scale-up: serving_latency burn-rate warning (SLO)"),
    "burn_blocks_scale_down": (dict(rate=2.0, last_request_at=10.0,
                                    burn_rate=3.0), 3, 10.0, 0.0, 3,
                               "hold: serving_latency burn above budget "
                               "(SLO)"),
    "raw_wins_over_overlay": (dict(rate=33.0, last_request_at=10.0,
                                   burn_rate=7.0), 2, 10.0, 0.0, 4,
                              "scale-up: demand"),
}


@pytest.mark.parametrize("name", sorted(POINT_CASES))
def test_one_decision(name):
    signals, current, now, created, replicas, reason = POINT_CASES[name]
    d = _decide(signals, current, now, AutoscalerState(created_at=created))
    assert d.replicas == replicas
    assert reason in d.reason
    if name == "raw_wins_over_overlay":
        assert "SLO" not in d.reason


def test_never_below_min_replicas():
    cfg = AutoscalerConfig(min_replicas=2, max_replicas=4)
    assert _decide({}, 2, 0.0, cfg=cfg).replicas == 2


def test_scale_down_is_stabilized_scale_up_is_immediate():
    cfg = AutoscalerConfig(min_replicas=1, max_replicas=4,
                           scale_down_stabilization_seconds=60.0)
    state = AutoscalerState(created_at=0.0)
    assert _decide(dict(rate=30.0), 1, 0.0, state, cfg).replicas == 4
    # One quiet sample 10s later must NOT drop below the window's max.
    assert _decide(dict(rate=2.0), 4, 10.0, state, cfg).replicas == 4
    # Quiet past the window: the drop lands.
    assert _decide(dict(rate=2.0), 4, 100.0, state, cfg).replicas == 1


def test_monotone_in_rate():
    """For fixed everything else, more rate never means fewer replicas."""
    rng = random.Random(7)
    for _ in range(50):
        rates = sorted(rng.uniform(0, 60) for _ in range(2))
        current = rng.randint(0, 4)
        lo = _decide(dict(rate=rates[0]), current, 50.0).replicas
        hi = _decide(dict(rate=rates[1]), current, 50.0).replicas
        assert lo <= hi, (rates, current, lo, hi)


def test_monotone_response_to_rate_steps():
    state = AutoscalerState(created_at=0.0)
    prev, t = 0, 0.0
    for rate in (0.0, 4.0, 9.0, 17.0, 33.0):
        t += 1.0
        d = _decide(dict(rate=rate, last_request_at=t), prev, t, state)
        assert d.replicas >= prev
        assert d.replicas >= min(CFG.max_replicas,
                                 math.ceil(rate / CFG.target_rate_per_replica))
        prev = d.replicas


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1337])
def test_property_random_traffic_holds_invariants(seed):
    """Bounds always hold, zero only ever happens after the idle window,
    and the wanted replicas bidding through the port's policy queue over
    a fleet of two 4-card shares never oversell it."""
    rng = random.Random(seed)
    cfg = AutoscalerConfig(
        min_replicas=rng.randint(0, 1), max_replicas=rng.randint(2, 5),
        target_rate_per_replica=rng.uniform(2, 10),
        scale_to_zero_after_seconds=rng.uniform(5, 50),
        scale_down_stabilization_seconds=rng.uniform(1, 10))
    state = AutoscalerState(created_at=0.0)
    fleet = Fleet.parse(f"pool-a={H100}:1x4:2")
    q = PolicyQueue(fleet=fleet, config=PolicyConfig(enable_preemption=False))
    current, now, last_request = 0, 0.0, None
    admitted: set = set()
    for _ in range(200):
        now += rng.uniform(0.5, 3.0)
        rate = rng.choice([0.0, 0.0, rng.uniform(0.1, 40.0)])
        if rate > 0:
            last_request = now
        d = desired_replicas(cfg, Signals(rate=rate,
                                          last_request_at=last_request),
                             current, now, state)
        assert cfg.min_replicas <= d.replicas <= cfg.max_replicas \
            or d.replicas == 0
        if d.replicas == 0 and current > 0:
            idle_since = last_request if last_request is not None else 0.0
            assert now - idle_since >= cfg.scale_to_zero_after_seconds
            assert rate == 0.0
        for i in range(d.replicas):
            key = ("ns", f"svc#r{i}")
            if key not in admitted:
                q.submit(GangRequest(
                    key=key, namespace="ns", accelerator=H100,
                    topology="1x4", num_slices=1, chips=4, priority=100,
                    submitted_at=now, workload="serving"))
        for i in range(d.replicas, cfg.max_replicas + 1):
            q.release(("ns", f"svc#r{i}"))
            admitted.discard(("ns", f"svc#r{i}"))
        for a in q.schedule(now).admitted:
            admitted.add(a.key)
        q.ledger.assert_consistent()
        assert q.ledger.violations == 0
        assert len(admitted) <= fleet.total_slices(H100, "1x4")
        current = d.replicas


def test_config_from_spec_defaults_and_garbage():
    cfg = config_from_spec({})
    assert cfg.min_replicas == 0 and cfg.max_replicas == 1
    spec = {"minReplicas": 2, "maxReplicas": 1,  # floor wins
            "targetRequestsPerReplica": "garbage",
            "scaleToZeroAfterSeconds": -5}
    cfg = config_from_spec(spec, default_target_rate=6.0,
                           default_idle_window=120.0)
    assert cfg.max_replicas == 2
    assert cfg.target_rate_per_replica == 6.0
    assert cfg.scale_to_zero_after_seconds == 120.0
    assert cfg == _as_port(ref.config_from_spec(
        spec, default_target_rate=6.0, default_idle_window=120.0))


def test_burn_rate_none_or_healthy_is_the_raw_policy():
    rng = random.Random(17)
    for _ in range(500):
        sig = dict(rate=rng.uniform(0, 40), inflight=rng.uniform(0, 20),
                   last_request_at=rng.uniform(0, 1000))
        current, now = rng.randint(0, 5), rng.uniform(0, 2000)
        base = _decide(sig, current, now)
        for burn in (None, 0.2, 1.0):
            d = _decide({**sig, "burn_rate": burn}, current, now)
            assert (d.replicas, d.reason) == (base.replicas, base.reason)
        assert "SLO" not in base.reason


def _as_port(cfg) -> AutoscalerConfig:
    return AutoscalerConfig(**vars(cfg))


@pytest.mark.parametrize("slo", [False, True], ids=["burn_off", "burn_on"])
@pytest.mark.parametrize("seed", [3, 11, 29])
def test_the_port_decides_as_the_reference_at_every_tick(seed, slo):
    """One seeded trace of load, inflight and burn rate (None with the
    SLO overlay off), fed to both modules with each one's own state and
    the replica count it chose: every decision, its raw demand and its
    reason are equal, and so is each state's window."""
    rng = random.Random(seed)
    spec = {"minReplicas": rng.randint(0, 1),
            "maxReplicas": rng.randint(2, 6),
            "targetRequestsPerReplica": rng.uniform(2, 10),
            "scaleToZeroAfterSeconds": rng.uniform(5, 40),
            "scaleDownStabilizationSeconds": rng.uniform(1, 10)}
    cfgs = (ref.config_from_spec(spec), port.config_from_spec(spec))
    assert _as_port(cfgs[0]) == cfgs[1]
    states = (ref.AutoscalerState(created_at=0.0),
              port.AutoscalerState(created_at=0.0))
    current, now, last, seen = [0, 0], 0.0, None, set()
    for tick in range(400):
        now += rng.uniform(0.2, 2.5)
        busy = (tick // 50) % 2 == 0    # bursts, then idle spells
        rate = rng.choice([0.0, rng.uniform(0.1, 60.0)]) if busy else 0.0
        if rate > 0:
            last = now
        inflight = rng.choice([0.0, 3.0, 9.0]) if busy else \
            rng.choice([0.0] * 19 + [2.0])
        signals = dict(rate=rate, inflight=inflight, last_request_at=last,
                       burn_rate=(rng.choice([0.0, 0.5, 2.0, 7.0, 20.0])
                                  if slo else None))
        got = [mod.desired_replicas(cfg, mod.Signals(**signals), cur, now,
                                    state)
               for mod, cfg, cur, state in zip((ref, port), cfgs, current,
                                               states)]
        assert vars(got[0]) == vars(got[1])
        assert states[0].window == states[1].window
        current = [d.replicas for d in got]
        seen.add(got[1].reason)
    # The trace reached the policy's branches, the overlay's with it.
    kinds = {reason.split(":")[0].split(" (")[0] for reason in seen}
    assert {"scale-up", "steady", "hold"} <= kinds
    assert ("scale-to-zero" in kinds) == (spec["minReplicas"] == 0)
    assert any("SLO" in reason for reason in seen) == slo
