"""The port's tied head (``burnin.tied_head``) at vocabularies that are no
multiple of ``burnin.HEAD_PAD``, where it computes over the padded
vocabulary and drops the pad columns.

The unpadded head, today's ``(x @ embed.T.to(dtype)).float()``, is the
same function with ``HEAD_PAD`` set to 1 (every vocabulary a multiple):
against it the logits are equal bit for bit and the gradients within the
compute dtype's rounding; against the JAX package the forward, the loss
and its gradients are within tests/test_torch_burnin.py's and
tests/test_torch_train.py's tolerances. The MoE, long-context and
pipelined models route their heads through the same function. JAX is
imported only inside the functions that need it, so the spawned process
of the one-shard step loads torch and the port alone.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models import (burnin, longctx, moe, params_from_jax,
                                       pipelined)
from kubeflow_tpu_torch.models.tree import leaves, map_params, value_and_grad
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh

torch.set_num_threads(1)

# tests/test_torch_burnin.py's SMALL widths; the vocabulary varies.
SMALL = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=64)
ODD = (250, 257, 1000)
DTYPES = ("float32", "bfloat16")
# tests/test_torch_burnin.py's LOGIT_TOL and tests/test_torch_train.py's
# LOSS_TOL and GRAD_TOL (the sides round at the same points, in other
# orders).
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# tests/test_torch_sharded.py's step: f32, lr 1e-2, parameters after it.
LR = 1e-2
PARAM_TOL = 1e-6


@pytest.fixture
def unpadded(monkeypatch):
    """Runs the head as the unpadded expression while in force."""
    def enter():
        monkeypatch.setattr(burnin, "HEAD_PAD", 1)
    return enter


def _cfg(vocab, dtype="bfloat16", attention="xla", **kw):
    return burnin.BurninConfig(**{**SMALL, **kw}, vocab=vocab, dtype=dtype,
                               attention=attention)


def _tokens(vocab, shape=(2, 65), seed=0):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


def _head_inputs(vocab, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, SMALL["d_model"], generator=gen).to(dtype)
    embed = torch.randn(vocab, SMALL["d_model"], generator=gen) * 0.02
    return x.requires_grad_(), embed.requires_grad_()


def _head_grads(vocab, dtype):
    """The head's f32 logits and the gradients of a cross entropy over
    them, for ``x`` and ``embed``."""
    x, embed = _head_inputs(vocab, dtype)
    logits = burnin.tied_head(x, embed, dtype)
    targets = torch.from_numpy(_tokens(vocab, (32,))).long()
    loss = F.cross_entropy(logits.reshape(-1, vocab), targets)
    return logits, torch.autograd.grad(loss, (x, embed))


def _rounding(dtype):
    """The gradients' tolerance against the unpadded head's, relative to
    a leaf's largest magnitude: 4 units of the compute dtype's rounding.
    ``dx`` sums over the padded vocabulary, in another order: measured at
    most 1.5 units (f32, vocab 1000), 0 elsewhere."""
    return 4 * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vocab", ODD)
def test_padded_head_logits_equal_the_unpadded_head(vocab, dtype, unpadded):
    dt = getattr(torch, dtype)
    x, embed = _head_inputs(vocab, dt)
    got = burnin.tied_head(x, embed, dt)
    assert got.shape == (2, 16, vocab) and got.dtype == torch.float32
    assert got.is_contiguous()
    unpadded()
    assert torch.equal(got, burnin.tied_head(x, embed, dt))
    assert torch.equal(got, (x @ embed.T.to(dt)).float())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vocab", ODD)
def test_padded_head_gradients_match_the_unpadded_head(vocab, dtype,
                                                       unpadded):
    dt = getattr(torch, dtype)
    _, got = _head_grads(vocab, dt)
    unpadded()
    _, want = _head_grads(vocab, dt)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=_rounding(dt) * w.abs().max())


def _graph_nodes(root):
    seen, todo = [], [root]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.append(node)
            todo.extend(fn for fn, _ in node.next_functions)
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vocab", ODD)
def test_the_pad_columns_hold_zeros_and_take_zero_gradient(vocab, dtype):
    """The padded operand's pad rows are zeros, and the gradients of the
    padded logits and of the operand are exactly zero there."""
    dt = getattr(torch, dtype)
    vp = -(-vocab // burnin.HEAD_PAD) * burnin.HEAD_PAD
    x, embed = _head_inputs(vocab, dt)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        logits = burnin.tied_head(x, embed, dt)
    (operand_t,) = [t for t in saved if t.shape == (SMALL["d_model"], vp)]
    assert torch.equal(operand_t[:, :vocab], embed.detach().T.to(dt))
    assert not operand_t[:, vocab:].any()
    seen = {}
    nodes = _graph_nodes(logits.grad_fn)
    operand = [n for n in nodes if "PaddedOperand" in n.name()]
    assert len(operand) == 1
    logits.grad_fn.register_hook(
        lambda grad_in, grad_out: seen.update(logits=grad_in[0]))
    operand[0].register_hook(
        lambda grad_in, grad_out: seen.update(operand=grad_out[0]))
    logits.backward(torch.randn(logits.shape))
    assert seen["logits"].shape == (2, 16, vp)
    assert seen["logits"].dtype == dt
    assert not seen["logits"][..., vocab:].any()
    assert seen["logits"][..., :vocab].any()
    assert seen["operand"].shape == (vp, SMALL["d_model"])
    assert not seen["operand"][vocab:].any()


@pytest.mark.parametrize("vocab,padded", [(64, 0), (256, 0), (257, 1),
                                          (1000, 1)])
def test_the_counter_counts_the_head_calls_that_padded(vocab, padded):
    cfg = _cfg(vocab)
    params = burnin.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_tokens(vocab)).long()
    start = burnin.PADDED_HEAD_CALLS
    burnin.forward(params, tokens[:, :-1], cfg)
    assert burnin.PADDED_HEAD_CALLS - start == padded
    burnin.value_and_grad(burnin.loss_fn, params, tokens, cfg)
    burnin.make_train_step(cfg)(params, tokens)
    assert burnin.PADDED_HEAD_CALLS - start == 3 * padded


@pytest.mark.parametrize("vocab", (64, 256, 4096))
def test_an_aligned_vocab_runs_the_unpadded_expression(vocab):
    x, embed = _head_inputs(vocab, torch.bfloat16)
    start = burnin.PADDED_HEAD_CALLS
    logits = burnin.tied_head(x, embed, torch.bfloat16)
    assert burnin.PADDED_HEAD_CALLS == start
    assert torch.equal(logits, (x @ embed.T.to(torch.bfloat16)).float())
    names = {n.name() for n in _graph_nodes(logits.grad_fn)}
    assert not any("Pad" in name for name in names)


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_leaf_gradient_matches_the_unpadded_model(dtype, unpadded):
    cfg = _cfg(257, dtype)
    params = burnin.init_params(cfg, seed=4, device="cpu")
    tokens = torch.from_numpy(_tokens(257, seed=4)).long()
    loss, got = burnin.value_and_grad(burnin.loss_fn, params, tokens, cfg)
    unpadded()
    want_loss, want = burnin.value_and_grad(burnin.loss_fn, params, tokens,
                                            cfg)
    eps = _rounding(getattr(torch, dtype))
    torch.testing.assert_close(loss, want_loss, rtol=eps, atol=0)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=eps * w.abs().max())


def _jax_configs(vocab, dtype, attention="xla"):
    from kubeflow_tpu.models import burnin as jax_burnin

    kw = {**SMALL, "vocab": vocab, "dtype": dtype, "attention": attention}
    return jax_burnin.BurninConfig(**kw), burnin.BurninConfig(**kw)


def _jax_params(jcfg, seed=0):
    import jax

    from kubeflow_tpu.models import burnin as jax_burnin

    return jax.device_get(jax_burnin.init_params(jax.random.key(seed), jcfg))


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax_at_an_odd_vocab(dtype, attention):
    import jax

    from kubeflow_tpu.models import burnin as jax_burnin

    jcfg, cfg = _jax_configs(257, dtype, attention)
    tree = _jax_params(jcfg)
    tokens = _tokens(257, (2, 64))
    ref = np.asarray(jax.jit(jax_burnin.forward, static_argnums=2)(
        tree, tokens, jcfg))
    got = burnin.forward(params_from_jax(tree, cfg, device="cpu"),
                         torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=LOGIT_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_jax_at_an_odd_vocab(dtype):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import burnin as jax_burnin

    jcfg, cfg = _jax_configs(257, dtype)
    tree = _jax_params(jcfg, seed=1)
    tokens = _tokens(257, seed=1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_burnin.loss_fn),
                                  static_argnums=2)(
        tree, jnp.asarray(tokens), jcfg)
    params = params_from_jax(tree, cfg, device="cpu")
    loss, grads = burnin.value_and_grad(
        burnin.loss_fn, params, torch.from_numpy(tokens).long(), cfg)
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL[dtype]
    it = iter(grads)
    got = jax.tree.leaves(map_params(
        lambda _: next(it).numpy(), params))
    for g, r in zip(got, jax.tree.leaves(ref_grads)):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL[dtype] * np.abs(r).max())


def _moe_logits(vocab):
    cfg = moe.MoEConfig(**SMALL, vocab=vocab)
    params = moe.init_params(cfg, seed=5, device="cpu")
    return moe.forward(params, torch.from_numpy(
        _tokens(vocab, (2, 64), seed=5)).long(), cfg)[0]


def _longctx_logits(vocab):
    cfg = longctx.LongContextConfig(**SMALL, vocab=vocab)
    params = longctx.init_params(cfg, seed=6, device="cpu")
    return longctx.forward(params, torch.from_numpy(
        _tokens(vocab, (2, 64), seed=6)).long(), cfg)


def _pipelined_loss_and_grad(vocab):
    cfg = pipelined.PipelinedConfig(**{**SMALL, "n_layers": 4}, vocab=vocab,
                                    n_micro=2)
    params = pipelined.init_params(cfg, seed=7, device="cpu")
    tokens = torch.from_numpy(_tokens(vocab, (2, 65), seed=7)).long()
    loss, grads = value_and_grad(pipelined.loss_fn, params, tokens, cfg)
    return loss, grads[0]                   # embed's


MODELS = {"moe": _moe_logits, "longctx": _longctx_logits,
          "pipelined": _pipelined_loss_and_grad}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_other_models_pad_their_heads(model, unpadded):
    start = burnin.PADDED_HEAD_CALLS
    got = MODELS[model](257)
    assert burnin.PADDED_HEAD_CALLS == start + 1
    unpadded()
    want = MODELS[model](257)
    assert burnin.PADDED_HEAD_CALLS == start + 1
    if model == "pipelined":
        (loss, grad), (want_loss, want_grad) = got, want
        eps = _rounding(torch.bfloat16)
        torch.testing.assert_close(loss, want_loss, rtol=eps, atol=0)
        assert grad.shape == (257, SMALL["d_model"])
        torch.testing.assert_close(grad, want_grad, rtol=0,
                                   atol=eps * want_grad.abs().max())
    else:
        assert got.shape[-1] == 257
        assert torch.equal(got, want)


def _world_one_shard(rank, tree, tokens, cfg):
    mesh = make_mesh(MeshPlan(1, 1), "cpu")
    params = burnin.shard_params(params_from_jax(tree, cfg, "cpu"), mesh,
                                 cfg)
    start = burnin.PADDED_HEAD_CALLS
    params, loss = burnin.make_train_step(cfg, mesh, lr=LR)(
        params, torch.from_numpy(tokens).long())
    return {"loss": float(loss), "padded": burnin.PADDED_HEAD_CALLS - start,
            "params": burnin.unshard_params(params, mesh, cfg)}


def test_a_one_shard_sharded_step_at_an_odd_vocab():
    """At one shard of a ("data", "model") mesh, an odd vocabulary's step
    pads the head once, equals the mesh-free step and matches JAX's."""
    import jax

    from kubeflow_tpu.models import burnin as jax_burnin

    jcfg, cfg = _jax_configs(257, "float32")
    tree = _jax_params(jcfg, seed=2)
    tokens = _tokens(257, (4, 33), seed=2)
    (got,) = run_world(_world_one_shard, 1, tree, tokens, cfg, timeout=120)
    assert got["padded"] == 1

    alone, loss = burnin.make_train_step(cfg, lr=LR)(
        params_from_jax(tree, cfg, "cpu"), torch.from_numpy(tokens).long())
    assert got["loss"] == float(loss)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got["params"]),
                                                 leaves(alone)))

    new, ref_loss = jax.jit(jax_burnin.make_train_step(jcfg, lr=LR))(
        tree, tokens)
    ref = jax.tree.leaves(new)
    assert abs(got["loss"] - float(ref_loss)) <= LOSS_TOL["float32"]
    mine = jax.tree.leaves(map_params(lambda t: t.numpy(), got["params"]))
    for a, b in zip(mine, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=PARAM_TOL)
