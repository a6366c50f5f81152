"""The port's mesh planning against the JAX package's.

``plan_mesh`` is pure arithmetic; the port keeps a copy of it, which must
give the JAX function's factoring for every device count and cap.
``make_mesh`` builds a ``DeviceMesh`` over a process group; its world-4
run is in ``test_torch_moe_model.py``.
"""

import pytest

from kubeflow_tpu.parallel import mesh as jax_mesh
from kubeflow_tpu_torch.parallel import mesh


@pytest.mark.parametrize("max_model", [1, 2, 4, 8])
def test_plan_mesh_matches_jax(max_model):
    for n in range(1, 17):
        got = mesh.plan_mesh(n, max_model=max_model)
        want = jax_mesh.plan_mesh(n, max_model=max_model)
        assert (got.data, got.model) == (want.data, want.model), n
        assert got.n_devices == want.n_devices == n


def test_plan_mesh_default_cap_and_refusal():
    assert mesh.plan_mesh(16) == mesh.MeshPlan(data=2, model=8)
    assert mesh.plan_mesh(7) == mesh.MeshPlan(data=1, model=7)
    with pytest.raises(ValueError, match="at least one device"):
        mesh.plan_mesh(0)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(device_type="cpu")
