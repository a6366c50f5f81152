"""The port's training harness against the JAX package's optax harness,
and the port's ``entry()``.

Same config as tests/test_trainer.py (f32, plain attention), parameters
from ``jax.random`` via ``params_from_jax``, seeded numpy batches. The
JAX steps are jitted, as its own tests jit them.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from kubeflow_tpu.models import burnin as jax_burnin
from kubeflow_tpu.models import trainer as jax_trainer
from kubeflow_tpu_torch.entry import entry
from kubeflow_tpu_torch.models import burnin, params_from_jax, trainer

# The shapes are tiny: one intra-op thread keeps torch's OpenMP pool
# from spinning on cores that the other test workers share.
torch.set_num_threads(1)

KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, seq_len=16,
          dtype="float32")
JCFG, CFG = jax_burnin.BurninConfig(**KW), burnin.BurninConfig(**KW)
# Warmup 3, cosine to 0 at 15: 20 steps see the lr-0 first update, the
# warmup, the cosine and the floor past the horizon. The gradients' global
# norms run from 0.9 to 1.6 along the way, so the default clip at 1.0
# scales some steps and leaves others.
TRAIN = dict(lr=1e-2, warmup_steps=3, decay_steps=15, grad_clip=1.0)
# f32 parameters after each of 20 steps. SGD: summation order only
# (measured 3e-8). AdamW divides by sqrt(nu), which turns the gradients'
# last-bit differences into larger update differences (measured 2e-6).
TRAJECTORY_TOL = {"sgd": 1e-6, "adamw": 1e-5}


def _batches(n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, KW["vocab"], (batch, KW["seq_len"]))
            .astype(np.int32) for _ in range(n)]


def _jax_params():
    return jax.device_get(jax_burnin.init_params(jax.random.key(0), JCFG))


def _np_leaves(params) -> list:
    """Copies of the port's leaves, in jax.tree's (sorted-key) order."""
    return jax.tree.leaves(burnin.map_params(
        lambda t: t.detach().clone().numpy(), params))


def _port_parts(**tcfg):
    tx = trainer.make_optimizer(trainer.TrainerConfig(**tcfg))
    state = trainer.init_state(
        params_from_jax(_jax_params(), CFG, device="cpu"), tx)
    return state, tx


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_twenty_step_trajectory_matches_optax(optimizer):
    tcfg = dict(TRAIN, optimizer=optimizer)
    tx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**tcfg))
    jparams = _jax_params()
    jstate = jax_trainer.init_state(jparams, tx)
    jstep = jax.jit(jax_trainer.make_train_step(
        partial(jax_burnin.loss_fn, cfg=JCFG), tx))
    state, ptx = _port_parts(**tcfg)
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), ptx)
    for i, batch in enumerate(_batches(20)):
        jstate, jloss = jstep(jstate, jnp.asarray(batch))
        state, loss = step(state, torch.from_numpy(batch).long())
        assert abs(float(loss) - float(jloss)) <= 1e-5
        got = _np_leaves(state["params"])
        for g, r in zip(got, jax.tree.leaves(jstate["params"])):
            np.testing.assert_allclose(g, np.asarray(r), rtol=0,
                                       atol=TRAJECTORY_TOL[optimizer])
        if i == 0 and optimizer == "adamw":
            # optax counts from 0: the first update runs at lr 0.
            for g, r in zip(got, jax.tree.leaves(jparams)):
                np.testing.assert_array_equal(g, np.asarray(r))
    assert state["step"] == int(jstate["step"]) == 20


def test_schedule_counts_from_zero_like_optax():
    cfg = trainer.TrainerConfig(**TRAIN)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.lr, warmup_steps=cfg.warmup_steps,
        decay_steps=cfg.decay_steps)
    factor = trainer.warmup_cosine(cfg)
    for count in range(25):
        assert abs(cfg.lr * factor(count) - float(ref(count))) <= 1e-9
    state, _ = _port_parts(**TRAIN)
    assert state["opt_state"]["optimizer"].param_groups[0]["lr"] == 0.0


@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0],
                         ids=["below", "at", "above"])
def test_clip_matches_optax_without_epsilon(scale):
    rng = np.random.default_rng(3)
    raw = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((4, 5), (7,), (3, 2, 2))]
    norm = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                       for a in raw))
    max_norm = float(np.float32(norm / scale))
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(a) for a in raw], optax.EmptyState())
    grads = [torch.from_numpy(a.copy()) for a in raw]
    got = trainer.clip_by_global_norm_(grads, max_norm)
    assert abs(float(got) - norm) <= 1e-5 * norm
    for g, r, a in zip(grads, ref, raw):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
        if scale == 0.5:               # below the threshold: untouched
            np.testing.assert_array_equal(g.numpy(), a)


def test_gradient_accumulation_matches_full_batch():
    """accum_steps=4 over a batch of 8 == one full-batch step, in the port
    and against the JAX package's accumulated step."""
    tcfg = dict(optimizer="sgd", lr=1e-2, grad_clip=0.0)
    batch = _batches(1, batch=8)[0]
    loss_fn = partial(burnin.loss_fn, cfg=CFG)
    results = []
    for accum in (1, 4):
        state, tx = _port_parts(**tcfg)
        state, loss = trainer.make_train_step(loss_fn, tx, accum)(
            state, torch.from_numpy(batch).long())
        results.append((float(loss), _np_leaves(state["params"])))
    jtx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**tcfg))
    jstate, jloss = jax.jit(jax_trainer.make_train_step(
        partial(jax_burnin.loss_fn, cfg=JCFG), jtx, accum_steps=4))(
        jax_trainer.init_state(_jax_params(), jtx), jnp.asarray(batch))
    (l_full, p_full), (l_acc, p_acc) = results
    np.testing.assert_allclose(l_acc, l_full, rtol=1e-5)
    np.testing.assert_allclose(l_acc, float(jloss), rtol=1e-6)
    for a, b, r in zip(p_full, p_acc, jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b, np.asarray(r), rtol=0, atol=1e-7)


def test_accumulation_refuses_a_batch_it_cannot_split():
    state, tx = _port_parts(optimizer="sgd", lr=1e-2)
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), tx, 3)
    with pytest.raises(ValueError, match="divisible"):
        step(state, torch.from_numpy(_batches(1, batch=8)[0]).long())
    with pytest.raises(ValueError, match="accum_steps"):
        trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), tx, 0)


class _Checkpoints:
    """The duck-typed checkpoint manager fit takes: deep copies in memory."""

    def __init__(self):
        self.saved, self.waits = {}, 0

    def save(self, step, state):
        self.saved[step] = copy.deepcopy(state)

    def wait(self):
        self.waits += 1


def test_fit_resumed_at_k_equals_a_straight_run():
    """restore-at-2 + the remaining steps == 4 straight steps over the same
    batches (the fast-forward skips the first 2), as test_resume_equivalence."""
    batches = [torch.from_numpy(b).long() for b in _batches(4)]
    state, tx = _port_parts(**TRAIN)
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), tx)
    ckpt = _Checkpoints()
    seen = []
    final = trainer.fit(state, iter(batches), steps=4, step_fn=step,
                        checkpoints=ckpt, save_every=2,
                        on_step=lambda i, loss: seen.append(i))
    assert sorted(ckpt.saved) == [2, 4] and ckpt.waits == 1
    assert seen == [1, 2, 3, 4] and final["step"] == 4
    mid = ckpt.saved[2]
    assert mid["step"] == 2
    resumed = trainer.fit(mid, iter(batches), steps=4, step_fn=step)
    assert resumed["step"] == 4
    for a, b in zip(_np_leaves(final["params"]),
                    _np_leaves(resumed["params"])):
        np.testing.assert_array_equal(a, b)


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fit_with_telemetry(steps=5, **publisher_kw):
    from kubeflow_tpu_torch import telemetry

    state, tx = _port_parts(**TRAIN)
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), tx)
    prof = telemetry.StepProfiler("burnin", flops_per_step=1e9,
                                  tokens_per_step=64, peak_flops=1e12,
                                  window=8, environ={})
    patches = []
    pub = telemetry.TelemetryPublisher(patches.append, environ={},
                                       **publisher_kw)
    batches = [torch.from_numpy(b).long() for b in _batches(steps)]
    final = trainer.fit(state, iter(batches), steps=steps, step_fn=step,
                        profiler=prof, publisher=pub)
    return final, prof, pub, patches


def test_fit_profiles_every_step_and_keeps_the_first_apart():
    final, prof, _, _ = _fit_with_telemetry(steps=5)
    assert final["step"] == 5
    summary = prof.summary()
    assert prof.steps == summary["steps_measured"] == 4
    assert summary["step"] == prof.last_step == 5
    assert summary["first_step_sec"] > 0 and summary["step_p50_sec"] > 0
    assert summary["mfu"] == pytest.approx(
        1e9 / summary["step_p50_sec"] / 1e12)
    assert summary["hbm_high_water_bytes"] is None      # the CPU keeps none


def test_fit_publishes_in_the_loop_and_forces_the_last_publish():
    from kubeflow_tpu_torch.telemetry import publisher

    # A rate limit longer than the run: the first in-loop publish goes
    # out, the others are held, and the forced flush at the end goes out.
    clock = _Clock()
    _, prof, pub, patches = _fit_with_telemetry(
        steps=4, min_interval=3600.0, clock=clock, now_fn=lambda: 50.0)
    assert pub.seq == len(patches) == 2 and pub.errors == 0
    first, last = (publisher.decode(p["metadata"]["annotations"])
                   for p in patches)
    assert first["step"] == 1 and first["seq"] == 1
    assert last["step"] == 4 and last["seq"] == 2 and last["at"] == 50.0
    assert last["family"] == "burnin"
    assert last["mfu"] == round(prof.mfu(), 4)
    # Without the limit every step publishes, then the flush.
    _, _, _, every = _fit_with_telemetry(steps=3, min_interval=0.0)
    assert len(every) == 4


def test_fit_telemetry_matches_the_jax_fit():
    """The same profiler hooks through the port's fit and the JAX fit on
    the tiny config: the summaries' keys, the measured steps and the step
    counter agree (the times are each run's own)."""
    from kubeflow_tpu import telemetry as jax_telemetry
    from kubeflow_tpu_torch import telemetry

    steps = 4
    kw = dict(flops_per_step=1e9, tokens_per_step=64, peak_flops=1e12,
              window=8, environ={})
    tx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**TRAIN))
    jstep = jax.jit(jax_trainer.make_train_step(
        partial(jax_burnin.loss_fn, cfg=JCFG), tx))
    jprof = jax_telemetry.StepProfiler("burnin", **kw)
    jpatches = []
    jax_trainer.fit(jax_trainer.init_state(_jax_params(), tx),
                    iter([jnp.asarray(b) for b in _batches(steps)]),
                    steps=steps, step_fn=jstep, profiler=jprof,
                    publisher=jax_telemetry.TelemetryPublisher(
                        jpatches.append, min_interval=0.0, environ={}))
    _, prof, _, patches = _fit_with_telemetry(steps=steps, min_interval=0.0)
    want, got = jprof.summary(), prof.summary()
    assert sorted(got) == sorted(want)
    for key in ("family", "step", "steps_measured", "window", "mfu_basis"):
        assert got[key] == want[key]
    assert {k for k, v in got.items() if v is None} == \
        {k for k, v in want.items() if v is None}
    assert len(patches) == len(jpatches) == steps + 1


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="lion"):
        trainer.make_optimizer(trainer.TrainerConfig(optimizer="lion"))


def test_entry_on_the_cpu_matches_the_jax_entry():
    jfn, (jparams, jtokens) = jax_entry()
    fn, (params, tokens) = entry(device="cpu")
    out = fn(params, tokens)
    assert out.shape == (4, 64, 256) and out.dtype == torch.float32
    assert tokens.shape == (4, 64) and tokens.device.type == "cpu"
    ref = np.asarray(jax.jit(jfn)(jparams, jtokens))
    same = params_from_jax(jax.device_get(jparams), fn.keywords["cfg"],
                           device="cpu")
    # bf16 compute: one to two bf16 ulps, as test_torch_burnin's logits.
    np.testing.assert_allclose(fn(same, tokens).numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
