"""The port's sharded main path against the JAX package's: the burn-in
step data x tensor parallel, the trainer's sharded state and step, and
vision's data-parallel batch.

The parameters are the JAX init's, converted with ``params_from_jax``;
tokens, images and labels come from numpy; f32, where the sides differ in
summation order only. The torch side runs in CPU processes on gloo
(``kubeflow_tpu_torch.parallel.launch.run_world``): world 4 for the
burn-in meshes 1x4, 2x2 and 4x1 ("data", "model") at attention "xla" and
"flash" (the kernels' plain versions), for ``n_heads=2`` on 4 model shards and for the trainer at 2x2;
world 2 for vision. Each world runs all its cases in one spawn. The JAX
side runs as ``__graft_entry__.dryrun_multichip`` runs it on the
conftest's virtual CPU devices: ``shard_params`` and ``jax.jit`` with the
rules' shardings (the flash path's Pallas kernels in interpret mode). The
losses and every leaf, gathered back to the global layout by
``unshard_params``, must agree. This module imports JAX only inside the
functions that need it, so the spawned processes load torch and the port
alone.
"""

from functools import partial

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from kubeflow_tpu_torch.models import burnin, trainer, vision
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.tree import leaves, map_params, map_with
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import (MeshPlan, make_mesh, shard,
                                              unshard)

torch.set_num_threads(1)

# seq_len 33: the loss trains on 32 positions; head_dim 32 (d_model 128
# over 4 heads): 4 heads and 256 ff columns split over up to 4 model
# shards.
BASE = dict(vocab=64, d_model=128, n_heads=4, n_layers=2, d_ff=256,
            seq_len=33, dtype="float32")
BATCH = 8
LR = 1e-2
# tests/test_torch_train.py's float32 tolerances (the sides differ in
# summation order only): the loss, gradient-like leaves (the AdamW
# moments) relative to their largest magnitude, parameters after a step.
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-6
# Parameters after AdamW steps: tests/test_torch_trainer.py's AdamW
# tolerance (dividing by sqrt(nu) turns the gradients' last-bit
# differences into larger update differences). Measured here: 2.3e-6, the
# moments within 4.9e-6 of their largest magnitude.
ADAMW_PARAM_TOL = 1e-5
# (data, model, attention, config overrides) of the world-4 burn-in steps.
STEPS = {f"{d}x{m}_{attn}": (d, m, attn, {})
         for d, m in ((1, 4), (2, 2), (4, 1)) for attn in ("xla", "flash")}
STEPS["1x4_heads2"] = (1, 4, "xla", {"n_heads": 2})
# The trainer, at tests/test_trainer.py's config and lr (as its
# sharded-state test): 3 AdamW steps at 2x2, accumulating 2 microbatches,
# the clip far below the gradients' global norm (~1), so it binds each
# step.
TRAINER_MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     seq_len=16, dtype="float32")
TRAIN = dict(lr=1e-3, warmup_steps=1, decay_steps=10, grad_clip=0.05)
TRAIN_STEPS = 3
ACCUM = 2
# Vision at world 2, as tests/test_torch_vision.py's SMALL config.
VISION = dict(image_size=16, channels=3, widths=(16, 32, 64),
              blocks_per_stage=1, num_classes=10, dtype="float32")
VISION_BATCH = 4


def _tokens(batch=BATCH, seed=61, kw=BASE):
    return np.random.default_rng(seed).integers(
        0, kw["vocab"], (batch, kw["seq_len"])).astype(np.int32)


def _jax_params(seed=62, kw=BASE):
    import jax

    from kubeflow_tpu.models import burnin as jax_burnin

    return jax.device_get(jax_burnin.init_params(
        jax.random.key(seed), jax_burnin.BurninConfig(**kw)))


def _jax_mesh(data, model):
    import jax

    from kubeflow_tpu.parallel import MeshPlan as JaxPlan
    from kubeflow_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(jax.devices()[:data * model], JaxPlan(data, model))


def _np_leaves(tree) -> list:
    """The leaves as numpy, in jax.tree's (sorted-key) order."""
    import jax

    return [np.asarray(t) for t in jax.tree.leaves(map_params(
        lambda t: t.detach().numpy() if torch.is_tensor(t) else t, tree))]


def _shardings(mesh, rules):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.tree.map(lambda s: NamedSharding(mesh, s), rules,
                        is_leaf=lambda x: isinstance(x, P))


def _jax_burnin_step(kw, tree, tokens, data, model):
    """One sharded SGD step as __graft_entry__.dryrun_multichip jits it."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kubeflow_tpu.models import burnin as jax_burnin

    cfg = jax_burnin.BurninConfig(**kw)
    mesh = _jax_mesh(data, model)
    params = jax_burnin.shard_params(tree, mesh, cfg)
    rules = _shardings(mesh, jax_burnin.param_sharding_rules(cfg))
    batch = NamedSharding(mesh, P("data", None))
    step = jax.jit(jax_burnin.make_train_step(cfg, lr=LR),
                   in_shardings=(rules, batch),
                   out_shardings=(rules, NamedSharding(mesh, P())))
    new, loss = step(params, jax.device_put(tokens, batch))
    return float(loss), jax.device_get(new)


def _world_burnin(rank, tree, tokens, trainer_tree, trainer_tokens):
    results = {}
    for case, (data, model, attention, overrides) in STEPS.items():
        cfg = burnin.BurninConfig(**{**BASE, **overrides},
                                  attention=attention)
        mesh = make_mesh(MeshPlan(data, model), "cpu")
        params = burnin.shard_params(params_from_jax(tree, cfg, "cpu"),
                                     mesh, cfg)
        local = shard(torch.from_numpy(tokens).long(), ("data",), mesh)
        params, loss = burnin.make_train_step(cfg, mesh, lr=LR)(params,
                                                                local)
        results[case] = {"loss": float(loss),
                         "params": burnin.unshard_params(params, mesh, cfg)}
    cfg = burnin.BurninConfig(**BASE)
    global_params = params_from_jax(tree, cfg, "cpu")
    for model in (1, 2, 4):
        mesh = make_mesh(MeshPlan(4 // model, model), "cpu")
        mine = burnin.shard_params(global_params, mesh, cfg)
        results[f"model{model}"] = {
            "qkv": mine["layers"][0]["qkv"].clone(),
            "attn_out": mine["layers"][0]["attn_out"].clone(),
            "round_trip": burnin.unshard_params(mine, mesh, cfg)}
    bad = burnin.BurninConfig(**{**BASE, "d_ff": 250})
    try:
        burnin.shard_params(burnin.init_params(bad, seed=0, device="cpu"),
                            make_mesh(MeshPlan(1, 4), "cpu"), bad)
    except ValueError as err:
        results["d_ff_250"] = str(err)
    results["trainer"] = _world_trainer(trainer_tree, trainer_tokens)
    return results


def _moments(state) -> dict:
    """The AdamW moments as trees shaped like the params."""
    opt = state["opt_state"]["optimizer"]
    return {key: map_params(lambda p: opt.state[p][key], state["params"])
            for key in ("exp_avg", "exp_avg_sq")}


def _world_trainer(tree, tokens):
    cfg = burnin.BurninConfig(**TRAINER_MODEL)
    mesh = make_mesh(MeshPlan(2, 2), "cpu")
    tx = trainer.make_optimizer(trainer.TrainerConfig(**TRAIN))
    params = params_from_jax(tree, cfg, "cpu")
    rules = trainer.state_sharding_rules(burnin.param_sharding_rules(cfg),
                                         params, tx)
    state = trainer.shard_state(trainer.init_state(params, tx), mesh, rules)
    step = trainer.make_train_step(
        partial(burnin.loss_fn, cfg=cfg, mesh=mesh), tx, ACCUM, mesh=mesh,
        rules=rules)
    local = shard(torch.from_numpy(tokens).long(), ("data",), mesh)
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, local)
        losses.append(float(loss))
    gathered = {key: map_with(lambda p, spec: unshard(p, spec, mesh), tree_,
                              rules["opt_state"][key])
                for key, tree_ in _moments(state).items()}
    return {"losses": losses, "step": state["step"],
            "params": burnin.unshard_params(state["params"], mesh, cfg),
            **gathered}


@pytest.fixture(scope="module")
def world():
    tree = _jax_params()
    tokens = _tokens()
    trainer_inputs = (_jax_params(65, TRAINER_MODEL),
                      _tokens(seed=66, kw=TRAINER_MODEL))
    ranks = run_world(_world_burnin, 4, tree, tokens, *trainer_inputs,
                      timeout=120)
    return tree, tokens, trainer_inputs, ranks


def test_param_sharding_rules_are_the_jax_rules():
    import jax
    from jax.sharding import PartitionSpec as P

    from kubeflow_tpu.models import burnin as jax_burnin

    def translated(spec):      # P(None, None) is replicated: ()
        return tuple(spec) if any(spec) else ()

    for n_heads in (4, 2):
        cfg = burnin.BurninConfig(**{**BASE, "n_heads": n_heads})
        ref = jax.tree.leaves(jax_burnin.param_sharding_rules(
            jax_burnin.BurninConfig(**{**BASE, "n_heads": n_heads})),
            is_leaf=lambda x: isinstance(x, P))
        got = jax.tree.leaves(map_params(lambda s: ("rule", s),
                                         burnin.param_sharding_rules(cfg)),
                              is_leaf=lambda x: isinstance(x, tuple)
                              and x[:1] == ("rule",))
        assert [g[1] for g in got] == [translated(r) for r in ref]


def test_shard_round_trips_at_model_1_2_and_4(world):
    tree, _, _, ranks = world
    want = _np_leaves(tree)
    for r in ranks:
        for model in (1, 2, 4):
            got = _np_leaves(r[f"model{model}"]["round_trip"])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_a_qkv_shard_holds_whole_heads_of_q_k_and_v(world):
    tree, _, _, ranks = world
    d, h = BASE["d_model"], BASE["n_heads"]
    hd = d // h
    qkv = np.asarray(tree["layers"][0]["qkv"]).reshape(d, 3, h, hd)
    attn_out = np.asarray(tree["layers"][0]["attn_out"]).reshape(h, hd, d)
    for rank, r in enumerate(ranks):
        for model in (1, 2, 4):
            local = h // model
            mine = slice(rank % model * local, (rank % model + 1) * local)
            got = r[f"model{model}"]
            np.testing.assert_array_equal(
                got["qkv"].numpy(), qkv[:, :, mine].reshape(d, -1))
            np.testing.assert_array_equal(
                got["attn_out"].numpy(), attn_out[mine].reshape(-1, d))
            if model == 4:        # one head: q, then k, then v columns
                for part in range(3):
                    np.testing.assert_array_equal(
                        got["qkv"].numpy()[:, part * hd:(part + 1) * hd],
                        qkv[:, part, rank])


def test_a_d_ff_that_does_not_divide_raises_as_in_jax(world):
    from kubeflow_tpu.models import burnin as jax_burnin

    _, _, _, ranks = world
    for r in ranks:
        assert "does not divide into 4 shards" in r["d_ff_250"]
    import jax

    cfg = jax_burnin.BurninConfig(**{**BASE, "d_ff": 250})
    with pytest.raises(ValueError, match="divisible by 4"):
        jax_burnin.shard_params(
            jax_burnin.init_params(jax.random.key(0), cfg), _jax_mesh(1, 4),
            cfg)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_one_sharded_step_matches_jax_at_world_4(world, case):
    tree, tokens, _, ranks = world
    data, model, attention, overrides = STEPS[case]
    ref_loss, ref = _jax_burnin_step({**BASE, **overrides,
                                      "attention": attention},
                                     tree, tokens, data, model)
    want = _np_leaves(ref)
    for r in ranks:
        got = r[case]
        assert abs(got["loss"] - ref_loss) <= LOSS_TOL
        got_leaves = _np_leaves(got["params"])
        assert len(got_leaves) == len(want) == 15
        for a, b in zip(got_leaves, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL)


def test_state_sharding_rules_give_the_moments_the_params_rules():
    cfg = burnin.BurninConfig(**BASE)
    params = burnin.init_params(cfg, seed=0, device="cpu")
    rules = burnin.param_sharding_rules(cfg)
    tx = trainer.make_optimizer(trainer.TrainerConfig())
    state_rules = trainer.state_sharding_rules(rules, params, tx)
    assert state_rules["params"] is rules
    for key in ("exp_avg", "exp_avg_sq"):
        assert state_rules["opt_state"][key] is rules
    assert state_rules["opt_state"]["count"] == ()
    assert state_rules["step"] == ()
    # As tests/test_trainer.py asserts: a moment carries the column split.
    assert (None, "model") in leaves(state_rules["opt_state"]["exp_avg"])
    sgd = trainer.make_optimizer(trainer.TrainerConfig(optimizer="sgd"))
    assert "exp_avg" not in trainer.state_sharding_rules(
        rules, params, sgd)["opt_state"]
    with pytest.raises(ValueError, match="leaves"):
        trainer.state_sharding_rules(rules["layers"], params, tx)


def _jax_trainer_steps(tree, tokens):
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kubeflow_tpu.models import burnin as jax_burnin
    from kubeflow_tpu.models import trainer as jax_trainer

    cfg = jax_burnin.BurninConfig(**TRAINER_MODEL)
    mesh = _jax_mesh(2, 2)
    tx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**TRAIN))
    rules = jax_trainer.state_sharding_rules(
        jax_burnin.param_sharding_rules(cfg), tree, tx)
    state = jax_trainer.shard_state(jax_trainer.init_state(tree, tx), mesh,
                                    rules)
    loss_fn = partial(jax_burnin.loss_fn, cfg=cfg)
    step = jax.jit(jax_trainer.make_train_step(loss_fn, tx, ACCUM))
    norm = jax.jit(lambda p, t: optax.global_norm(jax.grad(loss_fn)(p, t)))
    batch = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
    losses, norms = [], []
    for _ in range(TRAIN_STEPS):
        norms.append(float(norm(state["params"], batch)))
        state, loss = step(state, batch)
        losses.append(float(loss))
    adam = next(s for s in jax.tree.leaves(
        state["opt_state"], is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu"))
    return (losses, norms, int(state["step"]), jax.device_get(
        state["params"]), jax.device_get(adam.mu), jax.device_get(adam.nu))


def test_sharded_trainer_steps_match_jax_at_2x2(world):
    _, _, (tree, tokens), ranks = world
    losses, norms, steps, params, mu, nu = _jax_trainer_steps(tree, tokens)
    assert min(norms) > 2 * TRAIN["grad_clip"]     # the clip binds
    want = _np_leaves(params)
    for r in ranks:
        got = r["trainer"]
        assert got["step"] == steps == TRAIN_STEPS
        np.testing.assert_allclose(got["losses"], losses, rtol=0,
                                   atol=LOSS_TOL)
        for a, b in zip(_np_leaves(got["params"]), want):
            np.testing.assert_allclose(a, b, rtol=0, atol=ADAMW_PARAM_TOL)
        for key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
            for a, b in zip(_np_leaves(got[key]), _np_leaves(ref)):
                assert a.shape == b.shape
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=GRAD_TOL * np.abs(b).max())


def _vision_batch(cfg, seed=63):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (VISION_BATCH, cfg.image_size, cfg.image_size, cfg.channels)).astype(
            np.float32)
    return images, rng.integers(0, cfg.num_classes, (VISION_BATCH,))


def _world_vision(rank, tree, images, labels):
    cfg = vision.VisionConfig(**VISION)
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
    images, labels = torch.from_numpy(images), torch.from_numpy(labels)
    # A data axis that the mesh lacks raises: it never runs each process
    # on its half of the batch alone.
    missing = []
    for make in (lambda: vision.shard_batch(images, labels, mesh, "dp"),
                 lambda: vision.make_train_step(cfg, mesh, data_axis="dp")):
        try:
            make()
        except ValueError as err:
            missing.append(str(err))
    batch = vision.shard_batch(images, labels, mesh)
    params, loss = vision.make_train_step(cfg, mesh, lr=LR)(
        params_from_jax(tree, cfg, "cpu"), batch)
    return {"images": batch[0].clone(), "labels": batch[1].clone(),
            "loss": float(loss), "params": params, "missing": missing}


@pytest.fixture(scope="module")
def vision_world():
    cfg = vision.VisionConfig(**VISION)
    images, labels = _vision_batch(cfg)
    tree = _jax_vision_params()
    ranks = run_world(_world_vision, 2, tree, images, labels, timeout=90)
    return tree, images, labels, ranks


def _jax_vision_params():
    import jax

    from kubeflow_tpu.models import vision as jax_vision

    return jax.device_get(jax_vision.init_params(
        jax.random.key(64), jax_vision.VisionConfig(**VISION)))


def test_vision_data_parallel_step_matches_jax_at_world_2(vision_world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kubeflow_tpu.models import vision as jax_vision

    tree, images, labels, ranks = vision_world
    jcfg = jax_vision.VisionConfig(**VISION)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    sharded = jax_vision.shard_batch(jnp.asarray(images),
                                     jnp.asarray(labels), mesh)
    ref_params, ref_loss = jax.jit(jax_vision.make_train_step(jcfg, lr=LR))(
        jax.device_put(tree, NamedSharding(mesh, P())), sharded)

    want = _np_leaves(jax.device_get(ref_params))
    half = VISION_BATCH // 2
    for rank, r in enumerate(ranks):
        rows = slice(rank * half, (rank + 1) * half)
        np.testing.assert_array_equal(r["images"].numpy(), images[rows])
        np.testing.assert_array_equal(r["labels"].numpy(), labels[rows])
        assert abs(r["loss"] - float(ref_loss)) <= LOSS_TOL
        for a, b in zip(_np_leaves(r["params"]), want):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL)


def test_vision_raises_on_a_mesh_without_its_data_axis(vision_world):
    *_, ranks = vision_world
    for r in ranks:
        assert len(r["missing"]) == 2, r["missing"]
        assert all("no axis 'dp'" in msg for msg in r["missing"])


def test_one_process_paths_take_no_mesh():
    """At one shard the sharded entry points are the unsharded ones: the
    tree itself, and a step equal to the mesh-free step."""
    cfg = burnin.BurninConfig(**BASE)
    params = burnin.init_params(cfg, seed=3, device="cpu")
    assert burnin.shard_params(params, None, cfg)["layers"][0]["qkv"] \
        is params["layers"][0]["qkv"]
    tokens = torch.from_numpy(_tokens(2)).long()
    a = map_params(torch.clone, params)
    _, loss_a = burnin.make_train_step(cfg, None, lr=LR)(a, tokens)
    _, loss_b = burnin.make_train_step(cfg, lr=LR)(params, tokens)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(params)))
    images = torch.zeros((2, 16, 16, 3))
    labels = torch.zeros((2,), dtype=torch.long)
    got = vision.shard_batch(images, labels, None)
    assert got[0] is images and got[1] is labels
