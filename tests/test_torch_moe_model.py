"""The port's MoE model against the JAX package's.

The parameters are the JAX init's, converted with ``params_from_jax``;
tokens come from numpy; f32, where the sides differ in summation order
only. One shard (``mesh=None``) runs in this process against the JAX
model on a 1x1 ("data", "expert") mesh, at attention "xla" and "flash"
(the JAX flash kernels in Pallas interpret mode, as its own tests run
them on the CPU). The expert-parallel step runs the torch side in 4 CPU
processes on gloo (``tests/torch_world.py``) at 2 data x 2 expert and at
1 x 4, and the JAX side on the conftest's virtual CPU devices with a mesh
of the same shape; the losses and the updated parameters, each process's
expert shard included, must agree. This module imports JAX only inside
the functions that need it, so the spawned processes load torch and the
port alone.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import moe
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.tree import map_params
from torch_world import run_world

torch.set_num_threads(1)

# seq_len 33: the loss trains on 32 positions. head_dim 16 (d_model 32
# over 2 heads). cf 1.0 at top-2 is bench.py's MOE_MODEL routing, and it
# drops choices at these sizes.
BASE = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            seq_len=33, n_experts=4, capacity_factor=1.0, router_top_k=2,
            dtype="float32")
BATCH = 4
LR = 1e-2
# One shard, f32, summation order only (measured: logits 1.9e-7, aux
# 1.2e-7, loss 4.8e-7, params after a step 1.5e-8).
TOL_LOGITS = 2e-5
TOL_LOSS = 1e-5
TOL_PARAM = 1e-6
# The world-4 steps hold the same bounds (measured: loss 4.8e-7, params
# 1.5e-8 at 2x2 and at 1x4).
# The aux term's weight in the world steps: large enough that its
# gradient, which the JAX package's pmean spreads over the mesh, moves
# the router visibly.
WORLD_AUX_WEIGHT = 1.0
WORLD_BATCH = 8
# (mesh shape) of the world-4 steps, ("data", "expert").
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


def _tokens(batch=BATCH, seed=21):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (batch, BASE["seq_len"]))


def _jax_params(cfg, seed=22):
    import jax

    from kubeflow_tpu.models import moe as jax_moe

    jcfg = jax_moe.MoEConfig(**cfg.__dict__)
    return jcfg, jax.device_get(jax_moe.init_params(jax.random.key(seed),
                                                    jcfg))


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "expert"))


def _leaves(tree):
    import jax

    return [np.asarray(t) for t in jax.tree.leaves(tree)]


def _to_numpy(tree):
    return map_params(lambda t: t.detach().numpy().copy(), tree)


@pytest.mark.parametrize("attention,top_k", [("xla", 1), ("xla", 2),
                                             ("flash", 2)])
def test_forward_loss_and_one_step_match_jax_on_one_shard(attention, top_k):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import moe as jax_moe

    cfg = moe.MoEConfig(**{**BASE, "router_top_k": top_k},
                        attention=attention)
    jcfg, tree = _jax_params(cfg)
    mesh = _jax_mesh((1, 1))
    tokens = _tokens()
    ref_logits, ref_aux = jax.jit(
        lambda p, t: jax_moe.forward(p, t, jcfg, mesh))(tree,
                                                        tokens[:, :-1])
    ref_params, ref_loss = jax.jit(jax_moe.make_train_step(
        jcfg, mesh, lr=LR))(tree, jnp.asarray(tokens))

    params = params_from_jax(tree, cfg, "cpu")
    t = torch.from_numpy(tokens)
    logits, aux = moe.forward(params, t[:, :-1], cfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=TOL_LOSS)
    params, loss = moe.make_train_step(cfg, lr=LR)(params, t)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL_LOSS,
                               atol=TOL_LOSS)
    for a, b in zip(_leaves(_to_numpy(params)), _leaves(ref_params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_PARAM)


def test_five_steps_lower_the_loss():
    cfg = moe.MoEConfig(**BASE)
    params = moe.init_params(cfg, seed=0, device="cpu")
    step = moe.make_train_step(cfg, lr=LR)
    t = torch.from_numpy(_tokens())
    losses = []
    for _ in range(5):
        params, loss = step(params, t)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_params_from_jax_takes_the_moe_tree():
    cfg = moe.MoEConfig(**BASE)
    _, tree = _jax_params(cfg)
    params = params_from_jax(tree, cfg, "cpu")
    for a, b in zip(_leaves(_to_numpy(params)), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert params["layers"][0]["expert_w1"].shape == (4, 32, 64)
    with pytest.raises(ValueError, match="router"):
        params_from_jax(tree, moe.MoEConfig(**{**BASE, "n_experts": 8}),
                        "cpu")


def test_init_params_has_the_jax_tree_and_runs_on_the_card_by_default():
    cfg = moe.MoEConfig(**BASE)
    _, tree = _jax_params(cfg)
    params = moe.init_params(cfg, seed=0, device="cpu")
    assert [a.shape for a in _leaves(_to_numpy(params))] == [
        b.shape for b in _leaves(tree)]
    # fan-in is the penultimate dim: the experts do not scale by E.
    w1 = params["layers"][0]["expert_w1"]
    assert abs(float(w1.std()) - (1 / cfg.d_model) ** 0.5) < 0.02
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            moe.init_params(cfg, seed=0)


def test_sharding_rules_split_only_the_experts():
    cfg = moe.MoEConfig(**BASE)
    rules = moe.param_sharding_rules(cfg)
    assert rules["embed"] == rules["pos"] == rules["out_norm"] == ()
    for layer in rules["layers"]:
        assert layer["expert_w1"] == layer["expert_w2"] == ("expert", None,
                                                            None)
        assert all(layer[k] == () for k in ("ln1", "ln2", "qkv", "attn_out",
                                             "router"))
    params = moe.init_params(cfg, seed=1, device="cpu")
    assert moe.shard_params(params, None, cfg)["layers"][0]["expert_w1"] \
        is params["layers"][0]["expert_w1"]


def _moe_world(rank, tree, tokens):
    from torch.distributed.device_mesh import DeviceMesh

    from kubeflow_tpu_torch.parallel.mesh import make_mesh

    results = {"model_mesh": tuple(make_mesh(device_type="cpu")
                                   .mesh_dim_names)}
    cfg = moe.MoEConfig(**{**BASE, "aux_weight": WORLD_AUX_WEIGHT})
    for case, shape in MESHES.items():
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=("data", "expert"))
        params = moe.shard_params(params_from_jax(tree, cfg, "cpu"), mesh,
                                  cfg)
        b = WORLD_BATCH // 4
        local = torch.from_numpy(tokens[rank * b:(rank + 1) * b])
        params, loss = moe.make_train_step(cfg, mesh, lr=LR)(params, local)
        logits, aux = moe.forward(params, local[:, :-1], cfg, mesh)
        results[case] = {"loss": float(loss), "aux_after": float(aux),
                         "params": map_params(lambda t: t.detach().clone(),
                                              params)}
    return results


@pytest.fixture(scope="module")
def world():
    cfg = moe.MoEConfig(**{**BASE, "aux_weight": WORLD_AUX_WEIGHT})
    _, tree = _jax_params(cfg)
    tokens = _tokens(WORLD_BATCH, seed=23)
    ranks = run_world(_moe_world, tree, tokens)
    for r in ranks:
        for case in MESHES:
            r[case]["params"] = _to_numpy(r[case]["params"])
    return tree, tokens, ranks


def _jax_step(shape, tree, tokens):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kubeflow_tpu.models import moe as jax_moe

    jcfg = jax_moe.MoEConfig(**{**BASE, "aux_weight": WORLD_AUX_WEIGHT})
    mesh = _jax_mesh(shape)
    params = jax_moe.shard_params(tree, mesh, jcfg)
    toks = jax.device_put(tokens,
                          NamedSharding(mesh, P(("data", "expert"), None)))
    new, loss = jax.jit(jax_moe.make_train_step(jcfg, mesh, lr=LR))(params,
                                                                    toks)
    return float(loss), jax.device_get(new)


@pytest.mark.parametrize("case", sorted(MESHES))
def test_one_expert_parallel_step_matches_jax_at_world_4(world, case):
    tree, tokens, ranks = world
    shape = MESHES[case]
    ref_loss, ref = _jax_step(shape, tree, tokens)
    n_expert = shape[1]
    e_local = BASE["n_experts"] // n_expert
    for rank, r in enumerate(ranks):
        got = r[case]
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=TOL_LOSS,
                                   atol=TOL_LOSS)
        mine = slice((rank % n_expert) * e_local,
                     (rank % n_expert + 1) * e_local)
        for layer, ref_layer in zip(got["params"]["layers"], ref["layers"]):
            for name in ("expert_w1", "expert_w2"):
                np.testing.assert_allclose(
                    layer[name], np.asarray(ref_layer[name])[mine],
                    rtol=0, atol=TOL_PARAM, err_msg=name)
        replicated = {**got["params"], "layers": [
            {k: v for k, v in lay.items() if not k.startswith("expert")}
            for lay in got["params"]["layers"]]}
        ref_replicated = {**ref, "layers": [
            {k: v for k, v in lay.items() if not k.startswith("expert")}
            for lay in ref["layers"]]}
        for a, b in zip(_leaves(replicated), _leaves(ref_replicated)):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_PARAM)


@pytest.mark.parametrize("case", sorted(MESHES))
def test_replicated_leaves_agree_across_the_world(world, case):
    _, _, ranks = world
    first = ranks[0][case]["params"]
    for r in ranks[1:]:
        for name in ("embed", "pos", "out_norm"):
            np.testing.assert_array_equal(r[case]["params"][name],
                                          first[name])
        for lay, lay0 in zip(r[case]["params"]["layers"], first["layers"]):
            for name in ("ln1", "ln2", "qkv", "attn_out", "router"):
                np.testing.assert_array_equal(lay[name], lay0[name])
        # The aux loss is averaged over the mesh: one value everywhere.
        assert r[case]["aux_after"] == ranks[0][case]["aux_after"]


def test_make_mesh_plans_the_world(world):
    _, _, ranks = world
    assert all(r["model_mesh"] == ("data", "model") for r in ranks)
