"""Device-mesh planning: a (data, model) factoring of the world and the
``torch.distributed`` mesh over it.

The port of ``kubeflow_tpu/parallel/mesh.py``. ``MeshPlan`` and
``plan_mesh`` are its arithmetic, copied; ``make_mesh`` builds a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
over the processes of the current process group (one process a card),
where the JAX package lays ``jax.devices()`` out as a ``Mesh``;
``world_size`` checks that a mesh spans that whole group. The JAX
module's ``shard_map_compat`` has no counterpart: each process runs its
own shard, and the collectives are explicit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class MeshPlan:
    """A chosen factoring of devices into named parallelism axes."""

    data: int
    model: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def plan_mesh(n_devices: int, max_model: int = 8) -> MeshPlan:
    """Factor ``n_devices`` into (data, model) with the largest model axis
    that divides the device count and stays <= ``max_model`` (one host's
    cards, whose links are the fastest); the rest is data parallel."""
    if n_devices < 1:
        raise ValueError("need at least one device")
    model = 1
    for cand in range(min(max_model, n_devices), 0, -1):
        if n_devices % cand == 0:
            model = cand
            break
    return MeshPlan(data=n_devices // model, model=model)


def make_mesh(plan: MeshPlan | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the world of the current process
    group, ranks laid out data-major (default plan: ``plan_mesh`` of the
    world size). Needs ``torch.distributed.init_process_group`` first."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if plan is None:
        plan = plan_mesh(world)
    if plan.n_devices != world:
        raise ValueError(f"plan {plan} does not cover {world} processes")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(plan.data, plan.model),
                      mesh_dim_names=("data", "model"))


def world_size(mesh) -> int:
    """Processes in ``mesh`` (``None``: 1), which must be the whole world
    of the default process group when more than one."""
    size = 1 if mesh is None else mesh.size()
    if size > 1 and size != dist.get_world_size():
        raise ValueError(f"the mesh holds {size} processes of a world of "
                         f"{dist.get_world_size()}")
    return size
