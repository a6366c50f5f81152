"""The port's long-context model against the JAX package's.

The parameters are the JAX init's, converted with ``params_from_jax``;
tokens come from numpy. World size 1 (``mesh=None``) runs in this
process; world size 4 runs the torch side in 4 CPU processes on gloo (as
``test_torch_ring.py`` does) and the JAX side on the conftest's virtual
CPU devices with the same mesh, and compares one SGD step's loss and
updated parameters. This module imports JAX only inside the functions
that need it, so the spawned processes load torch and the port alone.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import longctx
from kubeflow_tpu_torch.models.convert import params_from_jax
from torch_world import run_world

torch.set_num_threads(1)

BASE = dict(vocab=64, d_model=32, n_layers=1, d_ff=64, n_heads=4,
            seq_len=64, dtype="float32")
BATCH = 2
LR = 1e-2
RING_ULY = ("seq_ring", "seq_uly")
# (attention, mesh axis names, mesh shape, seq_axis) of the world-4 steps.
STEPS = {
    "ring/1x4": ("ring", ("data", "seq"), (1, 4), "seq"),
    "ring/2x2": ("ring", ("data", "seq"), (2, 2), "seq"),
    "ring_flash/1x4": ("ring_flash", ("data", "seq"), (1, 4), "seq"),
    "ring_flash/2x2": ("ring_flash", ("data", "seq"), (2, 2), "seq"),
    "ring_ulysses_flash/1x2x2": ("ring_ulysses_flash",
                                 ("data", *RING_ULY), (1, 2, 2), RING_ULY),
}
# One step's loss and params at the JAX package's own bounds for the
# longctx steps (tests/test_ring_attention.py:173-177).
TOL_LOSS = 2e-5
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-5
# Forward logits at test_longctx_matches_dense_forward_numerics' 2e-4.
TOL_LOGITS = 2e-4


def _tokens(shape=(BATCH, BASE["seq_len"]), seed=12):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], shape)


def _jax_params(cfg, seed=13):
    import jax

    from kubeflow_tpu.models import longctx as jax_longctx

    jcfg = jax_longctx.LongContextConfig(**cfg.__dict__)
    return jcfg, jax.device_get(jax_longctx.init_params(jax.random.key(seed),
                                                        jcfg))


def _jax_mesh(names, shape):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _leaves(tree):
    import jax

    return [np.asarray(t) for t in jax.tree.leaves(tree)]


def _to_numpy(tree):
    from kubeflow_tpu_torch.models.tree import map_params

    return map_params(lambda t: t.detach().numpy().copy(), tree)


@pytest.mark.parametrize("attention", ["ring", "ring_flash", "ulysses",
                                       "ulysses_flash", "ring_ulysses_flash"])
def test_forward_matches_jax_at_world_1(attention):
    from kubeflow_tpu.models import longctx as jax_longctx

    cfg = longctx.LongContextConfig(**BASE, attention=attention)
    jcfg, tree = _jax_params(cfg)
    tokens = _tokens()
    if attention.startswith("ring_ulysses"):
        names, seq_axis = RING_ULY, RING_ULY
    else:
        names, seq_axis = ("seq",), "seq"
    mesh = _jax_mesh(names, (1,) * len(names))
    ref = jax_longctx.forward(tree, tokens, jcfg, mesh, seq_axis)
    got = longctx.forward(params_from_jax(tree, cfg, "cpu"),
                          torch.from_numpy(tokens), cfg, None, seq_axis)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)


def _longctx_world(rank, trees, tokens):
    from torch.distributed.device_mesh import DeviceMesh

    results = {}
    for case, (attention, names, shape, seq_axis) in STEPS.items():
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=names)
        cfg = longctx.LongContextConfig(**BASE, attention=attention)
        params = params_from_jax(trees[attention], cfg, "cpu")
        local, params = longctx.shard_inputs(torch.from_numpy(tokens),
                                             params, mesh, seq_axis)
        step = longctx.make_train_step(cfg, mesh, lr=LR, seq_axis=seq_axis)
        params, loss = step(params, local)
        results[case] = {
            "loss": float(loss), "params": params,
            "tokens": local,
            "targets": longctx._next_tokens(local, mesh, seq_axis)}
    return results


@pytest.fixture(scope="module")
def world():
    tokens = _tokens()
    trees = {attention: _jax_params(longctx.LongContextConfig(
        **BASE, attention=attention))[1]
        for attention, *_ in STEPS.values()}
    ranks = run_world(_longctx_world, trees, tokens)
    return tokens, trees, ranks


def _jax_step(attention, names, shape, seq_axis, tree, tokens):
    import jax

    from kubeflow_tpu.models import longctx as jax_longctx

    jcfg = jax_longctx.LongContextConfig(**BASE, attention=attention)
    mesh = _jax_mesh(names, shape)
    toks, params = jax_longctx.shard_inputs(tokens, tree, mesh,
                                            seq_axis=seq_axis)
    step = jax.jit(jax_longctx.make_train_step(jcfg, mesh, lr=LR,
                                               seq_axis=seq_axis))
    new_params, loss = step(params, toks)
    return float(loss), jax.device_get(new_params)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_one_sgd_step_matches_jax_at_world_4(world, case):
    tokens, trees, ranks = world
    attention, names, shape, seq_axis = STEPS[case]
    ref_loss, ref_params = _jax_step(attention, names, shape, seq_axis,
                                     trees[attention], tokens)
    got = [r[case] for r in ranks]
    for r in got:
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=TOL_LOSS,
                                   atol=TOL_LOSS)
    # The params are replicated: every process holds the same update.
    first = _leaves(_to_numpy(got[0]["params"]))
    for r in got[1:]:
        for a, b in zip(first, _leaves(_to_numpy(r["params"]))):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(first, _leaves(ref_params)):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("case", ["ring/1x4", "ring/2x2",
                                  "ring_ulysses_flash/1x2x2"])
def test_targets_roll_over_the_global_sequence(world, case):
    """Each process holds its block of the tokens, and its targets are
    that block of ``roll(tokens, -1, axis=1)``: the last target of a
    sequence shard is the next shard's first token, and the last shard's
    is global token 0."""
    tokens, _, ranks = world
    _, names, shape, _ = STEPS[case]
    dp = shape[0]
    sp = 4 // dp
    rolled = np.roll(tokens, -1, axis=1)
    for rank, r in enumerate(ranks):
        data, seq = divmod(rank, sp)
        b, s = BATCH // dp, tokens.shape[1] // sp
        block = (slice(data * b, (data + 1) * b), slice(seq * s, (seq + 1) * s))
        np.testing.assert_array_equal(r[case]["tokens"].numpy(),
                                      tokens[block])
        np.testing.assert_array_equal(r[case]["targets"].numpy(),
                                      rolled[block])


def test_one_shard_loss_is_the_mean_nll_of_the_rolled_targets():
    cfg = longctx.LongContextConfig(**BASE)
    params = longctx.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_tokens())
    logits = longctx.forward(params, tokens, cfg)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab), tokens.roll(-1, 1).reshape(-1))
    torch.testing.assert_close(longctx.loss_fn(params, tokens, cfg), want)


def test_params_from_jax_takes_the_longctx_tree():
    cfg = longctx.LongContextConfig(**BASE)
    _, tree = _jax_params(cfg)
    params = params_from_jax(tree, cfg, "cpu")
    for a, b in zip(_leaves(_to_numpy(params)), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert params["pos"].shape == (cfg.seq_len, cfg.d_model)
    with pytest.raises(ValueError, match="pos"):
        params_from_jax(tree, longctx.LongContextConfig(
            **{**BASE, "seq_len": 32}), "cpu")
    with pytest.raises(TypeError, match="LongContextConfig"):
        params_from_jax(tree, dict(BASE), "cpu")


def test_init_params_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = longctx.LongContextConfig(**BASE)
    if torch.cuda.is_available():
        assert longctx.init_params(cfg, seed=0)["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            longctx.init_params(cfg, seed=0)
    params = longctx.init_params(cfg, seed=0, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert len(params["layers"]) == cfg.n_layers
