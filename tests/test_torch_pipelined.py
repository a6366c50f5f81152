"""The port's pipelined model against the JAX package's.

The parameters are the JAX init's, converted with ``params_from_jax``;
tokens come from numpy; f32, where the sides differ in summation order
only. One stage (``mesh=None``) runs in this process against the JAX step
on a 1x1 ("data", "stage") mesh and against ``reference_loss``, on the
fused path and through the tick schedule (``force_schedule``), at
attention "xla" and "flash" (the JAX flash kernels in Pallas interpret
mode, as its own tests run them on the CPU). The pipelined steps at
(data, stage, model) = (1, 4, 1), (2, 2, 1) and (1, 2, 2) run the torch
side in 4 CPU processes on gloo (``tests/torch_world.py``) and the JAX
side on the conftest's virtual CPU devices with a mesh of the same shape;
the losses and every leaf after one step, each process's shard, must
agree. This module imports JAX only inside the functions that need it, so
the spawned processes load torch and the port alone.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import pipelined
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.tree import map_params
from torch_world import run_world

torch.set_num_threads(1)

# seq_len 17: the loss trains on 16 positions; head_dim 8 (d_model 32
# over 4 heads); 4 layers split over up to 4 stages, 4 heads and 64 ff
# columns over up to 2 model shards.
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
            seq_len=17, n_micro=2, dtype="float32")
BATCH = 4
LR = 1e-2
# f32, summation order only: losses and updated params against the JAX
# step (as tests/test_pipeline.py holds the JAX step to its oracle, 2e-5
# on the loss). Measured at one stage: loss 0 to 4.8e-7, params 3e-8.
TOL_LOSS = 2e-5
TOL_PARAM = 2e-6
# (data, stage, model) of the world-4 steps.
MESHES = {"1x4x1": (1, 4, 1), "2x2x1": (2, 2, 1), "1x2x2": (1, 2, 2)}
WORLD_BATCH = 8


def _tokens(batch=BATCH, seed=31):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (batch, BASE["seq_len"]))


def _jax_cfg(cfg):
    from kubeflow_tpu.models import pipelined as jax_pipelined

    return jax_pipelined.PipelinedConfig(**cfg.__dict__)


def _jax_params(cfg, seed=32):
    import jax

    from kubeflow_tpu.models import pipelined as jax_pipelined

    return jax.device_get(jax_pipelined.init_params(jax.random.key(seed),
                                                    _jax_cfg(cfg)))


def _jax_mesh(data, stage, model=1):
    import jax

    from kubeflow_tpu.models import pipelined as jax_pipelined

    return jax_pipelined.make_pp_mesh(
        jax.devices()[:data * stage * model], n_stages=stage, n_model=model)


def _leaves(tree):
    import jax

    return [np.asarray(t) for t in jax.tree.leaves(tree)]


def _to_numpy(tree):
    return map_params(lambda t: t.detach().numpy().copy(), tree)


def _jax_step(cfg, tree, tokens, mesh, force_schedule=False):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import pipelined as jax_pipelined

    jcfg = _jax_cfg(cfg)
    params = jax_pipelined.shard_params(tree, mesh, jcfg)
    new, loss = jax.jit(jax_pipelined.make_train_step(
        jcfg, mesh, lr=LR, force_schedule=force_schedule))(
            params, jnp.asarray(tokens))
    return float(loss), jax.device_get(new)


@pytest.mark.parametrize("force_schedule", [False, True],
                         ids=["fused", "schedule"])
@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_one_stage_loss_and_step_match_jax(attention, force_schedule):
    import jax.numpy as jnp

    from kubeflow_tpu.models import pipelined as jax_pipelined

    cfg = pipelined.PipelinedConfig(**BASE, attention=attention)
    tree = _jax_params(cfg)
    tokens = _tokens()
    ref_loss, ref = _jax_step(cfg, tree, tokens, _jax_mesh(1, 1),
                              force_schedule)
    oracle = jax_pipelined.reference_loss(tree, jnp.asarray(tokens),
                                          _jax_cfg(cfg))

    params = params_from_jax(tree, cfg, "cpu")
    t = torch.from_numpy(tokens)
    np.testing.assert_allclose(
        float(pipelined.reference_loss(params, t, cfg)), float(oracle),
        rtol=TOL_LOSS, atol=TOL_LOSS)
    params, loss = pipelined.make_train_step(
        cfg, lr=LR, force_schedule=force_schedule)(params, t)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=TOL_LOSS,
                               atol=TOL_LOSS)
    np.testing.assert_allclose(float(loss), float(oracle), rtol=TOL_LOSS,
                               atol=TOL_LOSS)
    for a, b in zip(_leaves(_to_numpy(params)), _leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_PARAM)


def test_schedule_and_fused_paths_agree_and_train():
    cfg = pipelined.PipelinedConfig(**BASE)
    params = pipelined.init_params(cfg, seed=0, device="cpu")
    t = torch.from_numpy(_tokens())
    losses = {}
    for forced in (False, True):
        step = pipelined.make_train_step(cfg, lr=LR, force_schedule=forced)
        run = map_params(torch.clone, params)
        trace = []
        for _ in range(4):
            run, loss = step(run, t)
            trace.append(float(loss))
        losses[forced] = trace
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
    assert losses[False][-1] < losses[False][0], losses


def test_params_from_jax_takes_the_pipelined_tree():
    cfg = pipelined.PipelinedConfig(**BASE)
    tree = _jax_params(cfg)
    params = params_from_jax(tree, cfg, "cpu")
    for a, b in zip(_leaves(_to_numpy(params)), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert params["layers"]["qkv"].shape == (4, 32, 3, 4, 8)
    assert params["layers"]["attn_out"].shape == (4, 4, 8, 32)
    with pytest.raises(ValueError, match="qkv"):
        params_from_jax(tree, pipelined.PipelinedConfig(
            **{**BASE, "n_heads": 2}), "cpu")


def test_init_params_has_the_jax_tree_and_runs_on_the_card_by_default():
    cfg = pipelined.PipelinedConfig(**BASE)
    params = pipelined.init_params(cfg, seed=0, device="cpu")
    assert [a.shape for a in _leaves(_to_numpy(params))] == [
        b.shape for b in _leaves(_jax_params(cfg))]
    ff2 = params["layers"]["ff2"]
    assert abs(float(ff2.std()) - (1 / cfg.d_ff) ** 0.5) < 0.02
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipelined.init_params(cfg, seed=0)


def test_microbatch_and_attention_validation():
    cfg = pipelined.PipelinedConfig(**{**BASE, "n_micro": 3})
    params = pipelined.init_params(cfg, seed=1, device="cpu")
    tokens = torch.zeros((4, cfg.seq_len), dtype=torch.long)  # 4 % 3
    for forced in (False, True):
        with pytest.raises(ValueError, match="n_micro"):
            pipelined.make_train_step(cfg, force_schedule=forced)(params,
                                                                  tokens)
    with pytest.raises(ValueError, match="attention"):
        pipelined.PipelinedConfig(attention="Flash")
    from kubeflow_tpu_torch.parallel.pipeline import pipeline_spans

    with pytest.raises(ValueError, match="divisible"):
        pipeline_spans(7, 2)


def test_sharding_rules_and_one_shard():
    cfg = pipelined.PipelinedConfig(**BASE)
    rules = pipelined.param_sharding_rules(cfg, "model")
    assert rules["embed"] == rules["pos"] == rules["out_norm"] == ()
    assert rules["layers"]["qkv"] == ("stage", None, None, "model", None)
    assert rules["layers"]["ff2"] == ("stage", "model", None)
    assert pipelined.param_sharding_rules(cfg)["layers"]["ff1"] == (
        "stage", None, None)
    params = pipelined.init_params(cfg, seed=1, device="cpu")
    assert pipelined.shard_params(params, None, cfg)["layers"]["qkv"] \
        is params["layers"]["qkv"]


def _pipelined_world(rank, tree, tokens):
    cfg = pipelined.PipelinedConfig(**BASE)
    results = {}
    for case, (data, stage, model) in MESHES.items():
        mesh = pipelined.make_pp_mesh(stage, model, device_type="cpu")
        params = pipelined.shard_params(params_from_jax(tree, cfg, "cpu"),
                                        mesh, cfg)
        b = WORLD_BATCH // data
        d_index = rank // (stage * model)
        local = torch.from_numpy(tokens[d_index * b:(d_index + 1) * b])
        params, loss = pipelined.make_train_step(cfg, mesh, lr=LR)(params,
                                                                   local)
        results[case] = {"loss": float(loss), "mesh": mesh.mesh_dim_names,
                         "params": map_params(lambda t: t.detach().clone(),
                                              params)}
    return results


@pytest.fixture(scope="module")
def world():
    cfg = pipelined.PipelinedConfig(**BASE)
    tree = _jax_params(cfg)
    tokens = _tokens(WORLD_BATCH, seed=33)
    ranks = run_world(_pipelined_world, tree, tokens, timeout=90)
    for r in ranks:
        for case in MESHES:
            r[case]["params"] = _to_numpy(r[case]["params"])
    return cfg, tree, tokens, ranks


def _jax_shard(leaf, spec, coords, sizes):
    """The block of a JAX leaf that the process at ``coords`` holds."""
    for dim, name in enumerate(spec):
        if name in coords and sizes[name] > 1:
            n = leaf.shape[dim] // sizes[name]
            leaf = np.take(leaf, range(coords[name] * n,
                                       (coords[name] + 1) * n), axis=dim)
    return leaf


@pytest.mark.parametrize("case", sorted(MESHES))
def test_one_pipelined_step_matches_jax_at_world_4(world, case):
    cfg, tree, tokens, ranks = world
    data, stage, model = MESHES[case]
    ref_loss, ref = _jax_step(cfg, tree, tokens,
                              _jax_mesh(data, stage, model))
    rules = pipelined.param_sharding_rules(cfg, "model" if model > 1
                                           else None)
    sizes = {"data": data, "stage": stage, "model": model}
    for rank, r in enumerate(ranks):
        got = r[case]
        assert got["mesh"] == (("data", "stage", "model") if model > 1
                               else ("data", "stage"))
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=TOL_LOSS,
                                   atol=TOL_LOSS)
        coords = {"stage": rank // model % stage, "model": rank % model}
        got_leaves = _leaves(got["params"])
        ref_leaves = _leaves(map_params(
            lambda pair: _jax_shard(np.asarray(pair[0]), pair[1], coords,
                                    sizes),
            _zip_trees(ref, rules)))
        assert len(got_leaves) == len(ref_leaves) == 9
        for a, b in zip(got_leaves, ref_leaves):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_PARAM)


def _zip_trees(values, specs):
    """One tree of (value, spec) pairs from two trees of one structure."""
    if isinstance(specs, dict):
        return {key: _zip_trees(values[key], specs[key]) for key in specs}
    return (values, specs)
