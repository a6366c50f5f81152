"""The port's telemetry (``kubeflow_tpu_torch.telemetry``) against the JAX
package's ``kubeflow_tpu.telemetry``: the same inputs and the same
injected clocks through both, outputs equal (the profiler's summary,
``overlap_fraction``, ``window_steps``, the master switch, the
publisher's wire format, rate limit and metrics, the ledger's EWMA and
explain). Then serialize mode on the long-context ring step in a gloo
world of 2 (``tests/test_torch_longctx.py``'s config): the same loss and
gradients, bitwise, and a fence on both sides of every registered
collective, forward and backward. The spawned processes import this
module, so JAX is imported only inside the functions that need it.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch import telemetry
from kubeflow_tpu_torch.models import longctx
from kubeflow_tpu_torch.models.tree import value_and_grad
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.runtime.metrics import Registry
from kubeflow_tpu_torch.telemetry import ledger, profiler, publisher, sections

torch.set_num_threads(1)


def _jax_telemetry():
    from kubeflow_tpu import telemetry as jax_telemetry
    from kubeflow_tpu.telemetry import ledger as jax_ledger
    from kubeflow_tpu.telemetry import profiler as jax_profiler
    from kubeflow_tpu.telemetry import publisher as jax_publisher

    return jax_telemetry, jax_profiler, jax_publisher, jax_ledger


class TickClock:
    """A clock that moves ``tick`` seconds at every read, so the two
    profilers agree only if they read it at the same points."""

    def __init__(self, tick=0.001):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def advance(self, dt):
        self.t += dt


# ---- profiler ----------------------------------------------------------------


def _observe_steps(prof, sync):
    # The first step apart, then a window's worth and more, so the
    # rolling window evicts; a sync value at every step (only window
    # boundaries block on it).
    for i, dt in enumerate([10.0, 0.5, 0.25, 0.75, 0.5, 0.3, 0.9, 0.4]):
        prof.observe(i + 1, dt, sync_value=sync)


def _start_stop(prof, sync):
    for dt in (1.0, 0.25, 0.35, 0.15):
        prof.start()
        prof._clock.advance(dt)
        prof.stop(sync_value=sync)


def _notes(prof, sync):
    _observe_steps(prof, sync)
    prof.note_overlap(1.7, 2.0)
    prof.note_overlap(0.4)
    prof.note_hbm()


SCENARIOS = {
    "observe_window": (dict(flops_per_step=1e12, tokens_per_step=4096,
                            peak_flops=2e12, window=4, sync_every=3),
                       _observe_steps, {}),
    "start_stop": (dict(window=4, sync_every=100), _start_stop, {}),
    "every_step_syncs": (dict(flops_per_step=3e12, peak_flops=989e12,
                              window=8, sync_every=1), _observe_steps, {}),
    "notes": (dict(window=3), _notes, {}),
    "disabled": (dict(window=4), _observe_steps, {"KFTPU_TELEMETRY": "off"}),
    "window_env": (dict(), _observe_steps, {"KFTPU_TELEMETRY_WINDOW": "3"}),
    "basis": (dict(flops_per_step=1e12, peak_flops=4e12,
                   mfu_basis="host_matmul_probe", window=2),
              _observe_steps, {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_profiler_summary_matches_jax(scenario):
    import jax.numpy as jnp

    _, jax_profiler, _, _ = _jax_telemetry()
    kwargs, drive, environ = SCENARIOS[scenario]
    out = []
    for mod, sync in ((jax_profiler, jnp.zeros(())),
                      (profiler, torch.zeros(()))):
        prof = mod.StepProfiler("burnin", clock=TickClock(),
                                environ=environ, **kwargs)
        drive(prof, sync)
        out.append((prof.summary(), prof.steps, prof.last_step,
                    prof.sync_every, prof.window, prof.compile_sec()))
    assert out[1] == out[0]


@pytest.mark.parametrize("value", [None, "1", "on", "off", "false", "0",
                                   "no", " Disabled ", "yes"])
def test_master_switch_matches_jax(value):
    jax_telemetry, *_ = _jax_telemetry()
    environ = {} if value is None else {telemetry.TELEMETRY_ENABLED_ENV: value}
    assert telemetry.TELEMETRY_ENABLED_ENV == \
        jax_telemetry.TELEMETRY_ENABLED_ENV
    got = [telemetry.telemetry_enabled(environ)]
    want = [jax_telemetry.telemetry_enabled(environ)]
    for forced in (True, False, None):
        telemetry.set_enabled(forced)
        jax_telemetry.set_enabled(forced)
        try:
            got.append(telemetry.is_enabled(environ))
            want.append(jax_telemetry.is_enabled(environ))
        finally:
            telemetry.set_enabled(None)
            jax_telemetry.set_enabled(None)
    assert got == want


@pytest.mark.parametrize("value", [None, "7", "1", "2", "junk", "-4", "64"])
def test_window_steps_matches_jax(value):
    _, jax_profiler, _, _ = _jax_telemetry()
    environ = {} if value is None else {profiler.TELEMETRY_WINDOW_ENV: value}
    assert profiler.window_steps(environ) == \
        jax_profiler.window_steps(environ)


@pytest.mark.parametrize("overlapped,serialized", [
    (0.6, 1.0), (1.2, 1.0), (0.5, 0.0), (0.0, 2.0), (2.0, 2.0),
    (0.123, 0.456), (-1.0, 1.0)])
def test_overlap_fraction_matches_jax(overlapped, serialized):
    _, jax_profiler, _, _ = _jax_telemetry()
    assert profiler.overlap_fraction(overlapped, serialized) == \
        jax_profiler.overlap_fraction(overlapped, serialized)


def test_hbm_high_water_is_none_on_the_cpu():
    _, jax_profiler, _, _ = _jax_telemetry()
    assert profiler.hbm_high_water_bytes("cpu") is None
    assert profiler.hbm_high_water_bytes(torch.device("cpu")) is None
    if not torch.cuda.is_available():
        assert profiler.hbm_high_water_bytes() is None
        assert jax_profiler.hbm_high_water_bytes() is None


# ---- publisher ---------------------------------------------------------------


def _summary(**over):
    base = {
        "family": "moe", "step": 120, "mfu": 0.4321, "step_p50_sec": 0.0123,
        "overlap_fraction": 0.41, "mfu_basis": "accelerator",
        "tokens_per_sec": 81000.0, "compile_sec": 8.2,
        "hbm_high_water_bytes": 123456789,
    }
    base.update(over)
    return base


SUMMARIES = {
    "full": _summary(),
    "nones": _summary(mfu=None, overlap_fraction=None, mfu_basis=None,
                      hbm_high_water_bytes=None),
    "long_family": _summary(family="x" * 80, step=None),
    "profiler": profiler.StepProfiler("burnin", environ={}).summary(),
}


def test_annotation_key_is_the_jax_packages():
    from kubeflow_tpu.api import keys

    assert publisher.TELEMETRY_ANNOTATION == keys.NOTEBOOK_TPU_TELEMETRY


@pytest.mark.parametrize("cap", [None, 4096, 200, 150, 120, 1])
@pytest.mark.parametrize("name", sorted(SUMMARIES))
def test_encode_and_decode_match_jax(name, cap):
    _, _, jax_publisher, _ = _jax_telemetry()
    summary = SUMMARIES[name]
    got = publisher.encode(summary, seq=7, at=1234.5678, cap=cap)
    assert got == jax_publisher.encode(summary, seq=7, at=1234.5678, cap=cap)
    annotations = {publisher.TELEMETRY_ANNOTATION: got}
    assert publisher.decode(annotations) == jax_publisher.decode(annotations)


@pytest.mark.parametrize("raw", [None, "", "{not json", "[1,2]",
                                 '{"seq": 1}', '{"at": "yesterday"}',
                                 '{"at": 3, "seq": "x"}',
                                 '{"at": 5.5, "seq": 2, "step": 9}'])
def test_decode_of_bad_annotations_matches_jax(raw):
    _, _, jax_publisher, _ = _jax_telemetry()
    annotations = None if raw is None else {
        publisher.TELEMETRY_ANNOTATION: raw}
    assert publisher.decode(annotations) == jax_publisher.decode(annotations)


@pytest.mark.parametrize("now,stale_after", [(150.0, 120.0), (221.0, 120.0),
                                             (220.0, 120.0), (90.0, None),
                                             (400.0, None)])
def test_is_stale_matches_jax(now, stale_after):
    _, _, jax_publisher, _ = _jax_telemetry()
    entry = {"at": 100.0}
    assert publisher.is_stale(entry, now, stale_after) == \
        jax_publisher.is_stale(entry, now, stale_after)


def _publish_run(mod):
    """A rate-limited publisher through a fixed schedule of publishes,
    clock advances and a failing patcher: what it patched and counted."""
    clock = TickClock(tick=0.0)
    patches = []
    pub = mod.TelemetryPublisher(patches.append, min_interval=30.0,
                                 now_fn=lambda: 1000.0, clock=clock,
                                 environ={})
    results = []
    for advance, force in ((0, False), (0, False), (0, True), (31, False),
                           (10, False), (25, False), (0, True)):
        clock.advance(advance)
        results.append(pub.publish(_summary(step=len(results)),
                                   force=force))

    def boom(body):
        raise RuntimeError("api server down")

    failing = mod.TelemetryPublisher(boom, min_interval=0.0, clock=clock,
                                     now_fn=lambda: 1000.0, environ={})
    results.append(failing.publish(_summary()))
    return results, patches, pub.seq, failing.errors, failing.last_error


def test_publisher_rate_limit_and_failures_match_jax():
    _, _, jax_publisher, _ = _jax_telemetry()
    got, want = _publish_run(publisher), _publish_run(jax_publisher)
    assert got == want
    assert got[0] == [True, False, True, True, False, True, True, False]


@pytest.mark.parametrize("summary", [
    _summary(), {"family": "vision", "mfu": 0.1, "step_sec": 0.5,
                 "overlap": 0.2, "hbm": 7}, {"mfu": None}],
    ids=["summary", "short_keys", "empty"])
def test_publish_metrics_matches_jax(summary):
    from kubeflow_tpu.runtime.metrics import Registry as JaxRegistry

    _, _, jax_publisher, _ = _jax_telemetry()
    got, want = Registry(), JaxRegistry()
    publisher.publish_metrics(summary, got)
    jax_publisher.publish_metrics(summary, want)
    assert got.expose() == want.expose()


@pytest.mark.parametrize("environ", [
    {}, {"KFTPU_TELEMETRY_PUBLISH_SECONDS": "5",
         "KFTPU_TELEMETRY_MAX_CHARS": "100",
         "KFTPU_TELEMETRY_STALE_SECONDS": "9"},
    {"KFTPU_TELEMETRY_PUBLISH_SECONDS": "x",
     "KFTPU_TELEMETRY_MAX_CHARS": "y",
     "KFTPU_TELEMETRY_STALE_SECONDS": "z"}], ids=["unset", "set", "junk"])
def test_publisher_env_parses_match_jax(environ):
    _, _, jax_publisher, _ = _jax_telemetry()
    for fn in ("publish_seconds", "max_chars", "stale_after_seconds"):
        assert getattr(publisher, fn)(environ) == \
            getattr(jax_publisher, fn)(environ)


# ---- efficiency ledger -------------------------------------------------------


NOTES = [("ns/a", "moe", "v5e:4x4", 0.5), ("ns/a", "moe", "v5e:4x4", 0.1),
         ("ns/slow", "moe", "v5e:4x4", 0.05),
         ("ns/slow", "moe", "v5e:4x4", 0.05),
         ("ns/slow", "moe", "v5e:4x4", 0.05),
         ("ns/fast", "burnin", "h100:1", 0.9),
         ("ns/fast", "burnin", "h100:1", 1.4),
         ("ns/blind", "vision", "h100:1", None),
         ("ns/blind", "vision", "h100:1", None),
         ("ns/moved", "moe", "v5e:4x4", 0.2),
         ("ns/moved", "vision", None, -0.3)]


def _ledger_run(mod, **kwargs):
    led = mod.EfficiencyLedger(**kwargs)
    seen = []
    for key, family, shape, mfu in NOTES:
        led.note(key, family, shape, mfu)
        seen.append((led.gang_mfu(key), led.persistently_low(key),
                     led.explain(key)))
    led.forget("ns/a")
    keys = sorted({key for key, *_ in NOTES})
    return (seen, [led.explain(k) for k in keys],
            [led.persistently_low(k) for k in keys],
            led.expected_mfu("moe", "v5e:4x4"),
            led.expected_mfu("moe", "h100:1"), led.debug_info())


@pytest.mark.parametrize("kwargs", [
    dict(low_mfu=0.25, samples_needed=3), dict(low_mfu=0.6, samples_needed=1),
    dict(environ={"KFTPU_TELEMETRY_LOW_MFU": "0.3",
                  "KFTPU_TELEMETRY_MIN_SAMPLES": "2"}),
    dict(environ={"KFTPU_TELEMETRY_LOW_MFU": "junk",
                  "KFTPU_TELEMETRY_MIN_SAMPLES": "0"})],
    ids=["three_samples", "one_sample", "env", "env_junk"])
def test_ledger_matches_jax(kwargs):
    *_, jax_ledger = _jax_telemetry()
    assert _ledger_run(ledger, **kwargs) == _ledger_run(jax_ledger, **kwargs)


# ---- sections ----------------------------------------------------------------


def test_sections_are_the_jax_packages():
    from kubeflow_tpu.telemetry import sections as jax_sections

    assert sections.SECTION_NAMES == jax_sections.SECTION_NAMES
    assert len(sections.SECTION_SPECS) == len(sections.SECTION_NAMES)
    for name, module, desc in sections.SECTION_SPECS:
        assert module.startswith("kubeflow_tpu_torch/parallel/") and desc


@pytest.mark.parametrize("serialize", [False, True])
def test_collective_rejects_unregistered_names(serialize):
    sections.set_serialize_collectives(serialize)
    try:
        assert sections.serialize_collectives() is serialize
        with pytest.raises(ValueError, match="unregistered telemetry section"):
            sections.collective("made_up_section", lambda x: x,
                                torch.ones(3))
    finally:
        sections.set_serialize_collectives(False)


def test_serialize_mode_takes_effect_per_call():
    events = []
    real = sections._fence

    def counting():
        events.append("fence")
        real()

    sections._fence = counting
    try:
        x = torch.ones(3)
        sections.collective("ring_kv_hop", torch.neg, x)
        sections.set_serialize_collectives(True)
        out = sections.collective("ring_kv_hop", torch.add, x, other=x)
        sections.set_serialize_collectives(False)
        sections.collective("ring_kv_hop", torch.neg, x)
    finally:
        sections._fence = real
        sections.set_serialize_collectives(False)
    assert events == ["fence", "fence"]  # one call, fenced on both sides
    assert torch.equal(out, 2 * x)


# ---- serialize mode on the ring step (gloo world of 2) -----------------------

# tests/test_torch_longctx.py's config and batch.
LONGCTX = dict(vocab=64, d_model=32, n_layers=1, d_ff=64, n_heads=4,
               seq_len=64, dtype="float32")
BATCH = 2
# Each attention's collectives: the forward's section names and the
# backward's (the ring's dense hop sends its gradient back through the
# same section).
ATTENTIONS = {"ring": ({"ring_kv_hop"}, {"ring_kv_hop"}),
              "ring_flash": ({"ring_flash_kv_hop"}, {"ring_flash_grad_hop"}),
              "ulysses_flash": ({"ulysses_all_to_all"},
                                {"ulysses_all_to_all"})}


def _ring_world(rank, tokens):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "seq"))
    real_collective, real_fence = sections.collective, sections._fence
    events = []

    def collective(name, op, *operands, **kwargs):
        def traced(*a, **k):
            events.append("op")
            return op(*a, **k)

        events.append(("call", name))
        return real_collective(name, traced, *operands, **kwargs)

    def fence():
        events.append("fence")
        real_fence()

    out = {}
    for attention in ATTENTIONS:
        cfg = longctx.LongContextConfig(**LONGCTX, attention=attention)
        params = longctx.init_params(cfg, seed=13, device="cpu")
        local, params = longctx.shard_inputs(torch.from_numpy(tokens),
                                             params, mesh)
        runs = {}
        for serialize in (False, True):
            sections.collective, sections._fence = collective, fence
            sections.set_serialize_collectives(serialize)
            try:
                events.clear()
                with torch.no_grad():
                    longctx.loss_fn(params, local, cfg, mesh)
                forward = list(events)
                events.clear()
                loss, grads = value_and_grad(longctx.loss_fn, params, local,
                                             cfg, mesh)
                runs[serialize] = {"loss": loss, "grads": grads,
                                   "forward": forward, "step": list(events)}
            finally:
                sections.collective, sections._fence = (real_collective,
                                                        real_fence)
                sections.set_serialize_collectives(False)
        out[attention] = runs
    return out


@pytest.fixture(scope="module")
def ring_world():
    tokens = np.random.default_rng(12).integers(
        0, LONGCTX["vocab"], (BATCH, LONGCTX["seq_len"]))
    return run_world(_ring_world, 2, tokens, timeout=300)


@pytest.mark.parametrize("attention", sorted(ATTENTIONS))
def test_serialized_step_is_bitwise_the_overlapped_step(ring_world,
                                                        attention):
    for rank in ring_world:
        runs = rank[attention]
        assert torch.equal(runs[True]["loss"], runs[False]["loss"])
        assert len(runs[True]["grads"]) == len(runs[False]["grads"])
        for a, b in zip(runs[True]["grads"], runs[False]["grads"]):
            assert torch.equal(a, b)


def _calls(events) -> list:
    return [e[1] for e in events if isinstance(e, tuple)]


@pytest.mark.parametrize("attention", sorted(ATTENTIONS))
def test_serialize_fences_every_collective_forward_and_backward(
        ring_world, attention):
    forward_names, backward_names = ATTENTIONS[attention]
    for rank in ring_world:
        runs = rank[attention]
        # Overlapped: no fence anywhere.
        assert "fence" not in runs[False]["forward"] + runs[False]["step"]
        step = runs[True]["step"]
        calls = _calls(step)
        n_forward = len(_calls(runs[True]["forward"]))
        assert n_forward > 0 and len(calls) > n_forward
        assert set(calls[:n_forward]) == forward_names
        assert set(calls[n_forward:]) == backward_names
        # Each call: the fence, the op, the fence; nothing else between.
        assert step == [e for name in calls
                        for e in (("call", name), "fence", "op", "fence")]
        assert _calls(runs[False]["step"]) == calls
