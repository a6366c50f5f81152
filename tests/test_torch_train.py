"""The port's burn-in loss and SGD train step against the JAX package's.

Parameters are drawn by ``jax.random`` and carried across with
``params_from_jax``; tokens are seeded numpy. The JAX side is jitted, as
bench.py jits its step, with the flash path's Pallas kernels in interpret
mode; the port runs on CPU tensors, where attention's forward and
backward are the kernels' plain versions behind the autograd Function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import burnin as jax_burnin
from kubeflow_tpu_torch.models import burnin, params_from_jax

# The shapes are tiny: one intra-op thread keeps torch's OpenMP pool
# from spinning on cores that the other test workers share.
torch.set_num_threads(1)

# seq_len 65: the loss trains on tokens[:, :-1], 64 positions.
BASE = dict(vocab=64, d_model=128, n_layers=2, d_ff=256, seq_len=65)
# f32 isolates semantics: the sides differ in summation order only
# (measured: loss 4.8e-7, each gradient leaf 1.2e-6 of its largest
# magnitude). bf16 rounds at the same points, but XLA's fused ops and
# torch's round in other places: measured loss 1.5e-4, gradient leaves
# 1.7e-2 of their largest magnitude.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# Parameters after SGD steps at lr 1e-3 (updates ~1e-5..1e-3 against
# weights ~0.1..1): measured 1.5e-8 (f32) and 2.4e-6 (bf16).
PARAM_TOL = {"float32": 1e-6, "bfloat16": 2e-5}


def _configs(**overrides):
    kw = {**BASE, **overrides}
    return jax_burnin.BurninConfig(**kw), burnin.BurninConfig(**kw)


def _jax_params(cfg):
    return jax.device_get(jax_burnin.init_params(jax.random.key(0), cfg))


def _tokens(batch=2, seed=0):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (batch, BASE["seq_len"])).astype(np.int32)


def _as_jax_leaves(tree) -> list:
    """Copies of the port tree's leaves as numpy, in jax.tree's
    (sorted-key) order."""
    return jax.tree.leaves(burnin.map_params(
        lambda t: t.detach().float().clone().numpy(), tree))


def _grad_tree(params, grads):
    it = iter(grads)
    return burnin.map_params(lambda _: next(it), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_loss_and_gradients_match_jax(attention, dtype):
    jcfg, cfg = _configs(n_heads=2, attention=attention, dtype=dtype)
    jparams = _jax_params(jcfg)
    tokens = _tokens()
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_burnin.loss_fn),
                                  static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg)
    params = params_from_jax(jparams, cfg, device="cpu")
    loss, grads = burnin.value_and_grad(
        burnin.loss_fn, params, torch.from_numpy(tokens).long(), cfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL[dtype]
    got = _as_jax_leaves(_grad_tree(params, grads))
    for g, r in zip(got, jax.tree.leaves(ref_grads)):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL[dtype] * np.abs(r).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_heads,d_model", [(1, 128), (2, 128), (1, 256)],
                         ids=["head_dim128", "head_dim64", "head_dim256"])
def test_one_and_two_sgd_steps_match_jax(n_heads, d_model, dtype):
    jcfg, cfg = _configs(n_heads=n_heads, d_model=d_model, attention="flash",
                         dtype=dtype)
    jparams = _jax_params(jcfg)
    tokens = _tokens()
    jstep = jax.jit(jax_burnin.make_train_step(jcfg))
    j1, jloss1 = jstep(jparams, jnp.asarray(tokens))
    j2, jloss2 = jstep(j1, jnp.asarray(tokens))

    step = burnin.make_train_step(cfg)
    params = params_from_jax(jparams, cfg, device="cpu")
    t = torch.from_numpy(tokens).long()
    params, loss1 = step(params, t)
    after_one = _as_jax_leaves(params)
    params, loss2 = step(params, t)

    for got, ref in ((loss1, jloss1), (loss2, jloss2)):
        assert abs(float(got) - float(ref)) <= LOSS_TOL[dtype]
    for got, ref in ((after_one, j1), (_as_jax_leaves(params), j2)):
        for g, r in zip(got, jax.tree.leaves(ref)):
            np.testing.assert_allclose(g, np.asarray(r), rtol=0,
                                       atol=PARAM_TOL[dtype])
    # Mirrors test_burnin_model_flash_config_trains: the loss falls.
    assert np.isfinite(float(loss1)) and float(loss2) < float(loss1)


def test_train_step_updates_the_params_in_place():
    _, cfg = _configs(n_heads=2, attention="flash")
    params = burnin.init_params(cfg, seed=1, device="cpu")
    before = [t.clone() for t in burnin.leaves(params)]
    tensors = burnin.leaves(params)
    new, loss = burnin.make_train_step(cfg)(
        params, torch.from_numpy(_tokens()).long())
    assert new is params
    assert all(a is b for a, b in zip(burnin.leaves(new), tensors))
    assert not loss.requires_grad
    assert not any(t.requires_grad for t in tensors)
    assert all(not torch.equal(a, b) for a, b in zip(before, tensors))


def test_gradient_traps_f32_grads_tied_embedding_unused_position():
    """Grads of bf16 compute land in f32 on the f32 weights; the tied
    embedding gets its head gradient on every row, also rows no input
    token gathers; the position row past the trained length gets none."""
    _, cfg = _configs(n_heads=2, attention="flash")
    params = burnin.init_params(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(_tokens()).long()
    tokens[:, :-1] %= 32                 # inputs use the first 32 ids only
    _, grads = burnin.value_and_grad(burnin.loss_fn, params, tokens, cfg)
    tree = _grad_tree(params, grads)
    assert all(g.dtype == torch.float32 for g in grads)
    assert bool((tree["embed"][32:].abs().sum(-1) > 0).all())
    assert bool((tree["pos"][-1] == 0).all())
    assert bool((tree["pos"][:-1].abs().sum(-1) > 0).all())
    assert all(bool((layer["qkv"] != 0).any()) for layer in tree["layers"])


def test_loss_is_cross_entropy_of_the_shifted_tokens():
    _, cfg = _configs(n_heads=2, dtype="float32")
    params = burnin.init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(_tokens(seed=5)).long()
    logits = burnin.forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None]).squeeze(-1)
    torch.testing.assert_close(burnin.loss_fn(params, tokens, cfg),
                               nll.mean(), rtol=1e-6, atol=1e-6)
