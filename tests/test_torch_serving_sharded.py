"""The port's sharded serving engine (``use_mesh`` in a world of more than
one process) against the JAX engine and the port's one-device engine.

The torch side runs in 4 CPU processes on gloo
(``kubeflow_tpu_torch.parallel.launch.run_world``), one spawn for every
case: the tiny f32 config of ``test_torch_serving_engine.py`` at meshes
1 x 4 (4 heads, one a process), 2 x 2 (2 heads, one a model process)
and 1 x 4 with 2 heads (``n_heads % model != 0``: qkv and attn_out stay
whole, only the FF splits). The engine's default mesh is the world's
``plan_mesh`` (1 x 4), so each case's child hands the registry its plan
through ``make_mesh``. Every rank runs the same lifecycle calls; every
forward the engine runs is recorded with its last position's logits.
The JAX engine (one device, as ``test_lanes_match_the_jax_engine_on_one_trace``
runs it) gives the lanes, the KV peak pressure and the registry's
``debug_info``; the port's one-device engine gives each forward's logits
and argmax. This module imports JAX only inside the functions that need
it, so the spawned processes load torch and the port alone.
"""

from functools import partial

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models.burnin import BurninConfig, param_shapes
from kubeflow_tpu_torch.models.tree import leaves
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import MeshPlan
from kubeflow_tpu_torch.serving import engine as engine_mod
from kubeflow_tpu_torch.serving.engine import (
    DEFAULT_MODEL,
    EngineOptions,
    Request,
    ServingEngine,
)

torch.set_num_threads(1)

# test_torch_serving_engine.py's TINY config, in f32 (where the sharded and
# one-device forwards differ in summation order only), and its lane-trace
# options.
TINY_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
               seq_len=32, dtype="float32")
OPTS = dict(kv_blocks=10, kv_block_size=8, prefill_chunk=8)
MAX_BATCH = 3
# (data, model, config overrides) of the world-4 engines.
CASES = {"1x4": (1, 4, {"n_heads": 4}), "2x2": (2, 2, {}),
         "1x4_heads2": (1, 4, {})}
# f32 logits of the sharded forward against the one-device forward: the
# model-axis sums add the shares in another order (summation order only).
TOL_LOGITS = 1e-5
# A second trace after park / warm restore, on the restored shards.
REPLAY = [Request(rid=100 + i, arrival=0.0, tokens_out=2,
                  prompt_tokens=12 if i == 0 else 0) for i in range(4)]


def _lane_trace():
    """test_torch_serving_engine.py's ``_lane_trace``: every request
    arrives at 0, so the lanes depend on the trace alone."""
    return [Request(rid=i, arrival=0.0, tokens_out=2 + i % 3,
                    prompt_tokens=20 if i % 3 == 0 else 0,
                    model="alt" if i in (4, 5) else DEFAULT_MODEL)
            for i in range(9)]


def _probe(cfg):
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (MAX_BATCH, cfg.seq_len)))


def _report(r) -> tuple:
    """Everything a ServeReport holds, as plain values."""
    return (r.steps, r.prefill_chunks, r.prefill_tokens, r.model_swaps,
            r.kv_rejections, r.batch_occupancy, r.kv_peak_pressure,
            r.wall_sec,
            [(c.rid, c.tokens, c.model, c.prompt_tokens, c.arrival,
              c.started, c.finished) for c in r.completions])


def _lanes(r) -> tuple:
    """test_lanes_match_the_jax_engine_on_one_trace's lanes."""
    return (r.steps, r.prefill_chunks, r.prefill_tokens, r.model_swaps,
            r.kv_rejections, round(r.batch_occupancy, 9),
            [(c.rid, c.tokens, c.model) for c in r.completions])


def _drive(cfg, use_mesh, calls):
    """The lifecycle every rank runs, each forward's last-position logits
    appended to ``calls``: cold start, a second model, the lane trace,
    park, warm restore, a replay, then one score of seeded tokens."""
    real = engine_mod.forward

    def recording(params, tokens, cfg, mesh=None):
        logits = real(params, tokens, cfg, mesh)
        calls.append(logits[:, -1].clone())
        return logits

    engine_mod.forward = recording
    try:
        engine = ServingEngine(cfg, max_batch=MAX_BATCH, use_mesh=use_mesh,
                               options=EngineOptions(**OPTS), device="cpu")
        engine.cold_start(seed=0)
        engine.register_model("alt")
        out = {"report": engine.serve(_lane_trace()),
               "models": engine.models.debug_info()}
        out["device_shapes"] = [tuple(t.shape)
                                for t in leaves(engine._params)]
        engine.park()
        host = engine.models.entry(engine._active_model).host_params
        out["host_shapes"] = [tuple(t.shape) for t in leaves(host)]
        out["host_devices"] = sorted({t.device.type for t in leaves(host)})
        before = [t.clone() for t in leaves(host)]
        engine.warm_restore()
        out["restored_shapes"] = [tuple(t.shape)
                                  for t in leaves(engine._params)]
        out["restored_equal"] = all(
            torch.equal(a, b) for a, b in zip(before, leaves(engine._params)))
        out["replay"] = engine.serve(REPLAY)
        out["argmax"] = engine._step_fn(engine._params, _probe(cfg))
        out["mesh"] = (None if engine.models.mesh is None
                       else engine.models.mesh.mesh.tolist())
        out["mesh_names"] = (None if engine.models.mesh is None
                             else engine.models.mesh.mesh_dim_names)
        out["active"] = engine._active_model
        out["park_step"] = engine.park_step
        return out
    finally:
        engine_mod.forward = real


def _world_serve(rank):
    real_make_mesh = engine_mod.make_mesh
    results = {}
    for case, (data, model, overrides) in CASES.items():
        engine_mod.make_mesh = partial(real_make_mesh, MeshPlan(data, model))
        calls = []
        try:
            out = _drive(BurninConfig(**{**TINY_KW, **overrides}), True,
                         calls)
        finally:
            engine_mod.make_mesh = real_make_mesh
        out["report"] = _report(out["report"])
        out["replay"] = _report(out["replay"])
        out["calls"] = calls
        results[case] = out
    # A request that can never fit: rank 0's admission raises, and the
    # followers, waiting for its next control word, must raise too.
    engine = ServingEngine(BurninConfig(**TINY_KW), max_batch=MAX_BATCH,
                           options=EngineOptions(kv_blocks=2,
                                                 kv_block_size=8),
                           device="cpu")
    engine.cold_start(seed=0)
    try:
        engine.serve([Request(rid=0, arrival=0.0, tokens_out=64)])
        results["failure"] = None
    except RuntimeError as exc:
        results["failure"] = type(exc).__name__
    return results


@pytest.fixture(scope="module")
def world():
    return run_world(_world_serve, 4, timeout=300)


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device engine through the same lifecycle, by case."""
    results = {}
    for case, (_, _, overrides) in CASES.items():
        calls = []
        out = _drive(BurninConfig(**{**TINY_KW, **overrides}), False, calls)
        out["calls"] = calls
        results[case] = out
    return results


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine's lanes, KV peak pressure and registry on the lane
    trace (one device)."""
    from kubeflow_tpu.models.burnin import BurninConfig as JaxBurninConfig
    from kubeflow_tpu.serving.engine import EngineOptions as JaxEngineOptions
    from kubeflow_tpu.serving.engine import Request as JaxRequest
    from kubeflow_tpu.serving.engine import ServingEngine as JaxServingEngine

    ref = JaxServingEngine(JaxBurninConfig(**TINY_KW), max_batch=MAX_BATCH,
                           use_mesh=False, options=JaxEngineOptions(**OPTS))
    ref.cold_start(seed=0)
    ref.register_model("alt")
    report = ref.serve([JaxRequest(**vars(r)) for r in _lane_trace()])
    return {"lanes": _lanes(report), "kv_peak": report.kv_peak_pressure,
            "models": ref.models.debug_info()}


def _lanes_of(report: tuple) -> tuple:
    steps, chunks, tokens, swaps, rejections, occupancy = report[:6]
    return (steps, chunks, tokens, swaps, rejections, round(occupancy, 9),
            [(rid, n, model) for rid, n, model, *_ in report[8]])


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_rank_returns_the_same_report(world, case):
    got = [r[case] for r in world]
    for r in got[1:]:
        assert r["report"] == got[0]["report"]
        assert r["replay"] == got[0]["replay"]
        assert r["models"] == got[0]["models"]
        assert r["active"] == got[0]["active"]
        assert r["park_step"] == got[0]["park_step"]
    assert len(got[0]["report"][8]) == len(_lane_trace())
    assert len(got[0]["replay"][8]) == len(REPLAY)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lanes_kv_and_registry_match_the_jax_engine(world, jax_engine, case):
    for r in world:
        report = r[case]["report"]
        assert _lanes_of(report) == jax_engine["lanes"]
        assert report[6] == jax_engine["kv_peak"]
        assert r[case]["models"] == jax_engine["models"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_forward_matches_the_one_device_engine(world, one_device,
                                                    case):
    """Every forward the engine ran (warm-ups, prefill chunks, decode
    steps, the swap's and restore's warm-ups, the seeded score): the
    argmax exactly, the logits within TOL_LOGITS."""
    want = one_device[case]
    assert _lanes(want["report"]) == _lanes_of(world[0][case]["report"])
    for r in world:
        got = r[case]
        assert len(got["calls"]) == len(want["calls"]) > 0
        for a, b in zip(got["calls"], want["calls"]):
            assert torch.equal(a.argmax(-1), b.argmax(-1))
            torch.testing.assert_close(a, b, rtol=0, atol=TOL_LOGITS)
        assert torch.equal(got["argmax"], want["argmax"])


def _shard_shapes(kw, model):
    """Each leaf's shape on one of ``model`` model processes, in leaves
    order: qkv and attn_out cut by whole heads where the heads divide."""
    cfg = BurninConfig(**kw)
    heads = cfg.n_heads % model == 0
    shapes = []
    for path, shape in _named_shapes(param_shapes(cfg)):
        name = path[-1]
        if name == "qkv" and heads:
            shape = (shape[0], shape[1] // model)
        elif name == "attn_out" and heads:
            shape = (shape[0] // model, shape[1])
        elif name == "ff1":
            shape = (shape[0], shape[1] // model)
        elif name == "ff2":
            shape = (shape[0] // model, shape[1])
        shapes.append(tuple(shape))
    return shapes


def _named_shapes(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_shapes(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named_shapes(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_use_mesh_in_a_world_shards_and_sets_mesh(world, case):
    data, model, overrides = CASES[case]
    want = _shard_shapes({**TINY_KW, **overrides}, model)
    for r in world:
        got = r[case]
        assert got["mesh"] == np.arange(4).reshape(data, model).tolist()
        assert got["mesh_names"] == ("data", "model")
        assert got["device_shapes"] == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_park_keeps_each_ranks_shard_and_restore_never_cuts_it_again(
        world, case):
    """The host holds this rank's shard alone (fewer elements than the
    whole model), and warm restore moves it back as it is."""
    _, model, overrides = CASES[case]
    kw = {**TINY_KW, **overrides}
    whole = sum(int(np.prod(s)) for _, s in
                _named_shapes(param_shapes(BurninConfig(**kw))))
    want = _shard_shapes(kw, model)
    for r in world:
        got = r[case]
        assert got["host_devices"] == ["cpu"]
        assert got["host_shapes"] == got["restored_shapes"] == want
        assert sum(int(np.prod(s)) for s in got["host_shapes"]) < whole
        assert got["restored_equal"]


def test_a_failure_on_rank_0_raises_on_every_rank(world):
    """Rank 0 sends an abort word where its loop raises, so no follower
    waits for a word that never comes."""
    assert [r["failure"] for r in world] == \
        ["KVCacheError"] + ["RuntimeError"] * 3


def _world_device_failure(rank):
    """Rank 0's decode fn raises after its control word went out, while
    the followers are already inside the forward's model-axis sum."""
    engine = ServingEngine(BurninConfig(**TINY_KW), max_batch=MAX_BATCH,
                           options=EngineOptions(**OPTS), device="cpu")
    engine.cold_start(seed=0)
    if rank == 0:
        def failing(params, tokens):
            raise ValueError("injected device failure")

        engine._step_fn = failing
    engine.serve([Request(rid=0, arrival=0.0, tokens_out=2)])


def test_a_device_failure_on_rank_0_ends_every_rank():
    """A failure inside rank 0's device call leaves the followers in that
    call's collective, not waiting for a control word: rank 0 does not
    wait for its abort word, its process ends, and the followers raise
    when the process group loses it (on gloo, its closed connections,
    long before the group's timeout)."""
    with pytest.raises(RuntimeError) as failed:
        run_world(_world_device_failure, 4, timeout=120)
    assert "exit codes [1, 1, 1, 1]" in str(failed.value)
    assert "injected device failure" in str(failed.value)
