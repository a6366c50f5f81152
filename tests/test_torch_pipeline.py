"""The port's GPipe schedule (``parallel/pipeline.py``) against the JAX
package's.

``pipeline_spans`` and ``stage_ring_perm`` are copies; ``pipeline_apply``
runs on both one-stage paths (the microbatches folded into one batch, and
the tick schedule under ``force_schedule``) against the JAX function
inside ``shard_map`` on a one-device ("stage",) mesh, on the same stage
function, params and inputs (numpy, f32): the outputs and the gradients
of a weighted sum of them. The multi-stage schedule runs in
``tests/test_torch_pipelined.py``'s gloo world.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel import pipeline

# f32, summation order only.
TOL = 2e-5
N_MICRO, MB, SEQ, WIDTH, LAYERS = 3, 2, 5, 8, 2


@pytest.mark.parametrize("n_layers,n_stages", [(8, 4), (4, 1), (6, 3),
                                               (2, 2)])
def test_spans_match_jax(n_layers, n_stages):
    from kubeflow_tpu.parallel import pipeline as jax_pipeline

    assert pipeline.pipeline_spans(n_layers, n_stages) == \
        jax_pipeline.pipeline_spans(n_layers, n_stages)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
def test_ring_perm_matches_jax(n_stages):
    from kubeflow_tpu.parallel import pipeline as jax_pipeline

    assert pipeline.stage_ring_perm(n_stages) == \
        jax_pipeline.stage_ring_perm(n_stages)


def test_spans_refuse_uneven_stages():
    with pytest.raises(ValueError, match="divisible"):
        pipeline.pipeline_spans(7, 2)


def _inputs(seed=41):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((LAYERS, WIDTH, WIDTH)).astype(np.float32) / 3
    x = rng.standard_normal((N_MICRO, MB, SEQ, WIDTH)).astype(np.float32)
    weights = rng.standard_normal(x.shape).astype(np.float32)
    return w, x, weights


def _jax_apply(w, x, weights, force_schedule):
    """(outputs, d/dw, d/dx) of sum(pipeline_apply(...) * weights) by the
    JAX package inside shard_map over one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from kubeflow_tpu.parallel import pipeline as jax_pipeline
    from kubeflow_tpu.parallel.mesh import shard_map_compat

    def stage_fn(layers, h):
        for i in range(layers.shape[0]):
            h = jnp.tanh(h @ layers[i]) + h
        return h

    def local(w, x):
        return jax_pipeline.pipeline_apply(
            stage_fn, w, x, n_stages=1, mesh_axes=("stage",),
            force_schedule=force_schedule)

    mesh = Mesh(np.array(jax.devices()[:1]), ("stage",))
    # The output varies over "stage" by type; on one device its "stage"
    # blocks are the whole.
    run = shard_map_compat(local, mesh=mesh, in_specs=(P(), P()),
                           out_specs=P("stage"))

    def weighted(w, x):
        return (run(w, x) * weights).sum()

    out = jax.jit(run)(w, x)
    dw, dx = jax.jit(jax.grad(weighted, argnums=(0, 1)))(w, x)
    return [np.asarray(t) for t in (out, dw, dx)]


@pytest.mark.parametrize("force_schedule", [False, True],
                         ids=["fused", "schedule"])
def test_one_stage_pipeline_apply_matches_jax(force_schedule):
    w, x, weights = _inputs()
    ref = _jax_apply(w, x, weights, force_schedule)

    def stage_fn(layers, h):
        for layer in layers.unbind(0):
            h = torch.tanh(h @ layer) + h
        return h

    tw = torch.from_numpy(w).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out = pipeline.pipeline_apply(stage_fn, tw, tx, n_stages=1,
                                  force_schedule=force_schedule)
    assert out.shape == tx.shape
    (out * torch.from_numpy(weights)).sum().backward()
    for got, want in zip((out.detach(), tw.grad, tx.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_stage_axis_needs_a_group_past_one_stage():
    assert pipeline.stage_axis(None, 1).size == 1
    with pytest.raises(ValueError, match="process group"):
        pipeline.stage_axis(None, 2)
    x = torch.zeros((2, 1, 3))
    with pytest.raises(ValueError, match="process group"):
        pipeline.pipeline_apply(lambda p, h: h, None, x, n_stages=2)


def test_the_hop_is_a_registered_section():
    from kubeflow_tpu_torch.telemetry import sections

    assert pipeline.SECTION in sections.SECTION_NAMES
