"""The port's burn-in forward against the JAX package's.

Parameters are drawn by ``jax.random`` and carried across with
``params_from_jax``, so both sides compute with the same numbers on the
same numpy token ids. The JAX flash path runs its Pallas kernel in
interpret mode; the port's, on CPU tensors, the kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.models import burnin as jax_burnin
from kubeflow_tpu_torch.models import burnin, params_from_jax
from kubeflow_tpu_torch.serving.engine import ModelRegistry

# The shapes are tiny: one intra-op thread keeps torch's OpenMP pool
# from spinning on cores that the other test workers share.
torch.set_num_threads(1)

SMALL = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             seq_len=64)
# f32 isolates semantics: the two sides differ only in summation order
# (measured max |Δlogit| 3.7e-7 at |logit| < 0.65). bf16 rounds at the
# same points in both, but XLA's fused ops and torch's round in other
# places: measured max 7.8e-3, one to two bf16 ulps (2**-8 at 0.5).
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


# One XLA program per config and shape, as the JAX engine jits its fns
# (op-by-op dispatch would compile every op on its own).
_jax_forward = jax.jit(jax_burnin.forward, static_argnums=2)


def _configs(**overrides):
    kw = {**SMALL, **overrides}
    return jax_burnin.BurninConfig(**kw), burnin.BurninConfig(**kw)


@pytest.fixture(scope="module")
def jax_params():
    cfg, _ = _configs()
    return jax.device_get(jax_burnin.init_params(jax.random.key(0), cfg))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab"], shape).astype(np.int32)


def test_params_from_jax_carries_every_leaf(jax_params):
    _, cfg = _configs()
    params = params_from_jax(jax_params, cfg, device="cpu")
    jax_leaves, jax_tree = jax.tree.flatten(jax_params)
    port_leaves, port_tree = jax.tree.flatten(
        burnin.map_params(lambda t: t.numpy(), params))
    assert port_tree == jax_tree
    shapes = jax.tree.leaves(burnin.param_shapes(cfg),
                             is_leaf=lambda x: isinstance(x, tuple))
    for ref, got, shape in zip(jax_leaves, port_leaves, shapes):
        assert got.shape == ref.shape == shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_params_from_jax_rejects_a_wrong_shape(jax_params):
    _, cfg = _configs(d_ff=256)
    with pytest.raises(ValueError, match="ff1"):
        params_from_jax(jax_params, cfg, device="cpu")


def test_init_params_has_the_jax_tree_and_scales():
    jcfg, cfg = _configs()
    params = burnin.init_params(cfg, seed=0, device="cpu")
    ref = jax.eval_shape(
        lambda: jax_burnin.init_params(jax.random.key(0), jcfg))
    assert jax.tree.structure(burnin.map_params(lambda t: 0, params)) \
        == jax.tree.structure(jax.tree.map(lambda t: 0, ref))
    for got, want in zip(jax.tree.leaves(burnin.map_params(
            lambda t: (tuple(t.shape), t.dtype), params),
            is_leaf=lambda x: isinstance(x, tuple)), jax.tree.leaves(ref)):
        assert got == (want.shape, torch.float32)
    assert abs(params["embed"].std().item() - 0.02) < 2e-3
    assert abs(params["layers"][0]["ff2"].std().item()
               - SMALL["d_ff"] ** -0.5) < 1e-2
    assert torch.equal(params["out_norm"], torch.ones(SMALL["d_model"]))
    again = burnin.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["qkv"], params["layers"][1]["qkv"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_forward_logits_match_jax(jax_params, attention, dtype):
    jcfg, cfg = _configs(attention=attention, dtype=dtype)
    tokens = _tokens((2, SMALL["seq_len"]))
    ref = np.asarray(_jax_forward(jax_params, jnp.asarray(tokens), jcfg))
    params = params_from_jax(jax_params, cfg, device="cpu")
    got = burnin.forward(params, torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_forward_is_causal(attention):
    _, cfg = _configs(attention=attention, dtype="float32")
    params = burnin.init_params(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(_tokens((1, SMALL["seq_len"]))).long()
    changed = tokens.clone()
    changed[0, -1] = (changed[0, -1] + 1) % SMALL["vocab"]
    a = burnin.forward(params, tokens, cfg)
    b = burnin.forward(params, changed, cfg)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=0)
    assert not torch.equal(a[:, -1], b[:, -1])


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, ref, rtol=0, atol=2e-6)
    assert np.abs(exact - ref).max() > 1e-4   # the torch default is wrong


def test_rmsnorm_in_f32_with_eps_inside_the_rsqrt():
    rng = np.random.default_rng(4)
    # Rows at the 1e-3 scale make mean(x²) ≈ eps, so eps placement shows.
    x = (rng.standard_normal((8, 64)) * 1e-3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = burnin._rmsnorm(xb, torch.from_numpy(gamma))
    ref = jax_burnin._rmsnorm(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(gamma))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -8, atol=0)
    x64 = xb.double().numpy()
    inside = x64 / np.sqrt((x64 ** 2).mean(-1, keepdims=True) + 1e-6) * gamma
    outside = x64 / (np.sqrt((x64 ** 2).mean(-1, keepdims=True)) + 1e-6) * gamma
    np.testing.assert_allclose(got.double().numpy(), inside, rtol=2 ** -7)
    assert np.abs(outside - inside).max() > 0.1


@pytest.mark.parametrize("shape,seed", [((4, 64), 5), ((1, 32), 2)],
                         ids=["decode_max_batch_x_seq", "prefill_chunk"])
def test_score_argmax_matches_jax_where_the_margin_is_clear(jax_params, shape,
                                                            seed):
    """The engine's ``score`` (last position's argmax) at its two static
    shapes, on the serving path's flash + bf16 config. bf16 logits have
    near-ties, so tokens are held equal only where JAX's top-2 margin
    exceeds the stated bf16 logit tolerance; logits are held everywhere
    by test_forward_logits_match_jax."""
    jcfg, cfg = _configs(attention="flash", dtype="bfloat16")
    tokens = _tokens(shape, seed=seed)   # a seed with clear margins
    ref_logits = np.asarray(
        _jax_forward(jax_params, jnp.asarray(tokens), jcfg))[:, -1]
    params = params_from_jax(jax_params, cfg, device="cpu")
    decode_fn, prefill_fn = ModelRegistry._build_fns(cfg)
    fn = decode_fn if shape[1] == SMALL["seq_len"] else prefill_fn
    got = fn(params, torch.from_numpy(tokens).long()).numpy()
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL["bfloat16"]
    assert clear.any()
    np.testing.assert_array_equal(got[clear],
                                  ref_logits.argmax(-1)[clear])
