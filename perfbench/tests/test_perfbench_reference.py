"""The plain reference against the port at a tiny size on the CPU (the
attention kernels' plain versions), in f32 on both sides: the loss, the
gradients, one AdamW update with the clip and one SGD step."""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import burnin, trainer
from kubeflow_tpu_torch.models.tree import leaves, value_and_grad

from perfbench import inputs
from perfbench.reference import gpt, order

MODEL = {"vocab": 97, "d_model": 32, "n_heads": 2, "n_layers": 2,
         "d_ff": 48, "seq_len": 17, "attention": "flash", "dtype": "float32"}
SEED = 2 ** 31 + 7


def _setup(model=MODEL, batch=3):
    weights = inputs.make_weights(model, SEED, "cpu")
    rows = inputs.token_rows({"rows": 12, "zipf_exponent": 1.0,
                              "zipf_offset": 2.7}, model["vocab"],
                             model["seq_len"], SEED)
    tokens = torch.from_numpy(order.first_batches(rows, batch, SEED, 1)[0])
    return weights, tokens


def _program(weights, model=MODEL):
    return inputs.as_tree({n: w.clone() for n, w in weights.items()}, model)


def test_loss_and_gradients():
    weights, tokens = _setup()
    cfg = burnin.BurninConfig(**MODEL)
    loss, grads = value_and_grad(burnin.loss_fn, _program(weights), tokens,
                                 cfg)
    with gpt.f32_exact():
        ref_loss, ref_grads = gpt.loss_and_grads(weights, tokens, MODEL)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    for name, g in zip(inputs.leaf_names(MODEL), grads):
        torch.testing.assert_close(g, ref_grads[name], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("clip", [1e-3, 1e3])  # the clip active, idle
def test_one_adamw_update(clip):
    weights, tokens = _setup()
    cfg = burnin.BurninConfig(**MODEL)
    opt = {"optimizer": "adamw", "lr": 3e-3, "weight_decay": 0.01,
           "warmup_steps": 0, "decay_steps": 10_000, "grad_clip": clip}
    params = _program(weights)
    optimizer = trainer.make_optimizer(trainer.TrainerConfig(**opt))
    state = trainer.init_state(params, optimizer)
    step = trainer.make_train_step(
        lambda p, b: burnin.loss_fn(p, b, cfg), optimizer)
    state, loss = step(state, tokens)
    with gpt.f32_exact():
        got = gpt.train(weights, [tokens], MODEL, opt)
    assert float(loss) == pytest.approx(got["losses"][0], rel=1e-6)
    # Adam's first update is lr * g / |g| elementwise: where g is near 0,
    # f32 rounding in the gradient moves it by up to ~1e-4 of lr.
    for name, p in zip(inputs.leaf_names(MODEL), leaves(state["params"])):
        torch.testing.assert_close(p, weights[name], rtol=1e-5, atol=1e-6)


def test_one_sgd_step():
    weights, tokens = _setup()
    step = burnin.make_train_step(burnin.BurninConfig(**MODEL), lr=0.1)
    params, loss = step(_program(weights), tokens)
    with gpt.f32_exact():
        got = gpt.train(weights, [tokens], MODEL,
                        {"optimizer": "sgd", "lr": 0.1})
    assert float(loss) == pytest.approx(got["losses"][0], rel=1e-6)
    for name, p in zip(inputs.leaf_names(MODEL), leaves(params)):
        torch.testing.assert_close(p, weights[name], rtol=1e-5, atol=1e-7)


def test_blocked_attention_matches_dense():
    # Query blocks of ATTENTION_BLOCK rows: a sequence over two blocks.
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 2, 1500, 8, dtype=torch.float64)
               for _ in range(3))
    scores = (q @ k.transpose(-1, -2)) / 8 ** 0.5
    scores = scores.masked_fill(torch.ones(1500, 1500).triu(1).bool(),
                                float("-inf"))
    dense = torch.softmax(scores, -1) @ v
    torch.testing.assert_close(gpt._attention(q, k, v), dense)


def test_loader_order_is_the_programs():
    from kubeflow_tpu_torch import data

    rows = np.arange(40).reshape(20, 2)
    loader = data.ShardedLoader(data.ArraySource(rows), 3, seed=SEED,
                                process_id=0, num_processes=1)
    got = [b for b, _ in zip(loader, range(3))]
    want = order.first_batches(rows, 3, SEED, 3)
    assert all((g[0] == w).all() for g, w in zip(got, want))


def test_fp8_control_rounds_every_product():
    a = torch.randn(4, 8, dtype=torch.float64, requires_grad=True)
    b = torch.randn(8, 3, dtype=torch.float64, requires_grad=True)
    out = gpt.fp8_matmul(a, b)
    exact = a @ b
    assert not torch.equal(out, exact)
    torch.testing.assert_close(out, exact, rtol=0.2, atol=0.3)
    out.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
