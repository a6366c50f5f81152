"""The port's vision model against the JAX package's.

The parameters are the JAX init's, converted with ``params_from_jax``
(conv weights stay HWIO); images and labels come from numpy; f32, where
the sides differ in summation order only. The logits and one SGD step at
a small config; XLA's "SAME" padding at stride 2 on its own (even sizes
pad one row and column after and none before, odd sizes one each side);
the space-to-depth fold; the odd-size refusal.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import vision
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.tree import map_params

torch.set_num_threads(1)

SMALL = dict(image_size=16, channels=3, widths=(16, 32, 64),
             blocks_per_stage=1, num_classes=10, dtype="float32")
BATCH = 4
LR = 1e-2
# f32, summation order only (a conv sums 9 * cin products in another
# order on each side). Measured: logits 4.8e-7, loss 0, params 6e-8.
TOL_LOGITS = 2e-5
TOL_LOSS = 1e-5
TOL_PARAM = 2e-6
TOL_CONV = 2e-5


def _jax_cfg(cfg):
    from kubeflow_tpu.models import vision as jax_vision

    return jax_vision.VisionConfig(**cfg.__dict__)


def _jax_params(cfg, seed=51):
    import jax

    from kubeflow_tpu.models import vision as jax_vision

    return jax.device_get(jax_vision.init_params(jax.random.key(seed),
                                                 _jax_cfg(cfg)))


def _batch(cfg, seed=52):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (BATCH, cfg.image_size, cfg.image_size, cfg.channels)).astype(
            np.float32)
    labels = rng.integers(0, cfg.num_classes, (BATCH,))
    return images, labels


def _leaves(tree):
    import jax

    return [np.asarray(t) for t in jax.tree.leaves(tree)]


def _to_numpy(tree):
    return map_params(lambda t: t.detach().numpy().copy(), tree)


def test_logits_and_one_step_match_jax():
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import vision as jax_vision

    cfg = vision.VisionConfig(**SMALL)
    jcfg = _jax_cfg(cfg)
    tree = _jax_params(cfg)
    images, labels = _batch(cfg)
    ref_logits = jax.jit(lambda p, x: jax_vision.forward(p, x, jcfg))(
        tree, images)
    ref_params, ref_loss = jax.jit(jax_vision.make_train_step(jcfg, lr=LR))(
        tree, (jnp.asarray(images), jnp.asarray(labels)))

    params = params_from_jax(tree, cfg, "cpu")
    batch = (torch.from_numpy(images), torch.from_numpy(labels))
    logits = vision.forward(params, batch[0], cfg)
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 10)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=TOL_LOGITS,
                               atol=TOL_LOGITS)
    params, loss = vision.make_train_step(cfg, lr=LR)(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL_LOSS,
                               atol=TOL_LOSS)
    for a, b in zip(_leaves(_to_numpy(params)), _leaves(ref_params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_PARAM)


@pytest.mark.parametrize("size,stride", [(8, 2), (7, 2), (6, 1), (5, 1),
                                         (9, 3)])
def test_conv_pads_as_xla_same(size, stride):
    import jax

    rng = np.random.default_rng(53)
    x = rng.standard_normal((2, size, size + 2, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = vision.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL_CONV,
                               atol=TOL_CONV)


def test_space_to_depth_matches_jax():
    from kubeflow_tpu.models import vision as jax_vision

    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    np.testing.assert_array_equal(
        vision.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jax_vision._space_to_depth(x)))
    with pytest.raises(ValueError, match="divisible by 2"):
        vision.space_to_depth(torch.zeros((1, 5, 4, 3)))


def test_odd_image_size_is_refused():
    with pytest.raises(ValueError, match="must be even"):
        vision.VisionConfig(image_size=63)


def test_params_from_jax_takes_the_vision_tree():
    cfg = vision.VisionConfig(**SMALL)
    tree = _jax_params(cfg)
    params = params_from_jax(tree, cfg, "cpu")
    for a, b in zip(_leaves(_to_numpy(params)), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert params["stem"].shape == (3, 3, 12, 16)         # HWIO
    assert params["stages"][1]["down"].shape == (3, 3, 16, 32)
    with pytest.raises(ValueError, match="stem"):
        params_from_jax(tree, vision.VisionConfig(**{**SMALL,
                                                     "channels": 1}), "cpu")


def test_init_params_has_the_jax_tree_and_steps_lower_the_loss():
    cfg = vision.VisionConfig(**SMALL)
    params = vision.init_params(cfg, seed=0, device="cpu")
    assert [a.shape for a in _leaves(_to_numpy(params))] == [
        b.shape for b in _leaves(_jax_params(cfg))]
    conv = params["stages"][2]["blocks"][0]["conv1"]
    assert abs(float(conv.std()) - (2 / (9 * 64)) ** 0.5) < 0.01
    images, labels = _batch(cfg, seed=54)
    batch = (torch.from_numpy(images), torch.from_numpy(labels))
    step = vision.make_train_step(cfg, lr=0.05)
    losses = []
    for _ in range(5):
        params, loss = step(params, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vision.init_params(cfg, seed=0)
