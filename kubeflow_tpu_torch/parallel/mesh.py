"""Device-mesh planning, the ``torch.distributed`` mesh over it, and the
tensor-parallel pieces the sharded models share.

The port of ``kubeflow_tpu/parallel/mesh.py``. ``MeshPlan`` and
``plan_mesh`` are its arithmetic, copied; ``make_mesh`` builds a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
over the processes of the current process group (one process a card),
where the JAX package lays ``jax.devices()`` out as a ``Mesh``;
``world_size`` checks that a mesh spans that whole group. The JAX
module's ``shard_map_compat`` has no counterpart: each process runs its
own shard, and the collectives are explicit.

What GSPMD derives from ``PartitionSpec``s in the JAX package, the models
do here with these pieces. A sharding rule is a tuple of mesh axis names
(or None) by dim, as a ``PartitionSpec``; ``()`` is replicated.
``shard`` cuts this process's block of a leaf, ``unshard`` gathers the
global leaf back, ``grad_groups`` names the process groups a leaf's
gradient is summed over (the axes its rule leaves it replicated on), and
``model_sum`` sums a row-parallel product's shares over the model axis.

The convention of every sharded step (as the JAX steps' transposes leave
it): each process's loss is its share, the local mean over the processes
that split the batch or replicate the loss, so the shares sum over the
world to the loss. The cotangents of activations that the model axis
replicates are then shares too, one per model process, so the backward of
the model-axis sum sums them (:class:`ModelSum`), and each leaf's gradient
is summed once over the axes its rule leaves it replicated on.
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


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this process sees it: its process group (None for
    one shard), its size, this process's index on it, and the global rank
    of each index (``dist.P2POp`` takes global ranks)."""

    group: object = None
    size: int = 1
    index: int = 0
    ranks: tuple = (0,)

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        """Axis ``name`` of a ``DeviceMesh`` (``None``: one shard)."""
        if mesh is None:
            return cls()
        names = mesh.mesh_dim_names or ()
        if name not in names:
            raise ValueError(f"mesh has no axis {name!r}; its axes are "
                             f"{names}")
        size = mesh.size(names.index(name))
        if size == 1:
            return cls()
        group = mesh.get_group(name)
        return cls(group, size, mesh.get_local_rank(name),
                   tuple(dist.get_global_rank(group, i) for i in range(size)))


def axis(mesh, name) -> Axis:
    """Axis ``name`` of ``mesh``; one shard where the mesh lacks it (or
    ``name`` is None)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return Axis()
    return Axis.of(mesh, name)


class Spec(tuple):
    """A sharding rule that cuts its split dim by whole units: the dim
    holds ``parts`` equal blocks, each of ``units`` units (the burn-in's
    fused qkv columns: q, k and v, each of ``n_heads`` heads), and a
    process's shard is its run of whole units from every part. Where the
    axis does not divide ``units``, the leaf stays whole on every process
    of it. It equals the plain tuple of its axis names, the JAX rule."""

    def __new__(cls, dims, parts: int = 1, units: int | None = None):
        spec = super().__new__(cls, dims)
        spec.parts, spec.units = parts, units
        return spec


def cuts(spec, mesh) -> tuple:
    """What ``spec`` cuts on ``mesh``: by dim, the axis name where the dim
    is split into more than one shard, else None."""
    sizes = [axis(mesh, name).size for name in spec]
    units = getattr(spec, "units", None)
    return tuple(name if size > 1 and not (units and units % size) else None
                 for name, size in zip(spec, sizes))


def _blocks(p, dim: int, spec, shards: int = 1):
    """``p``, a leaf or one of ``shards`` blocks of it, with dim ``dim``
    viewed as [parts, units, unit width]."""
    parts = getattr(spec, "parts", 1)
    units = getattr(spec, "units", None)
    units = units // shards if units else p.shape[dim] // parts
    return p.reshape(*p.shape[:dim], parts, units, -1, *p.shape[dim + 1:])


def shard(p, spec, mesh):
    """This process's block of the global leaf ``p`` under ``spec``, a
    contiguous copy (``p`` itself where nothing is cut). A dim that does
    not divide into its axis's shards raises ``ValueError``, as the JAX
    package's ``device_put`` does."""
    for dim, name in enumerate(spec):
        size = axis(mesh, name).size
        if size > 1 and p.shape[dim] % size:
            raise ValueError(
                f"dim {dim} of a {tuple(p.shape)} leaf does not divide into "
                f"{size} shards of mesh axis {name!r}")
    cut = False
    for dim, name in enumerate(cuts(spec, mesh)):
        if name is None:
            continue
        ax = axis(mesh, name)
        view = _blocks(p, dim, spec)
        n = view.shape[dim + 1] // ax.size
        p = view.narrow(dim + 1, ax.index * n, n).reshape(
            *p.shape[:dim], -1, *p.shape[dim + 1:])
        cut = True
    return p.clone(memory_format=torch.contiguous_format) if cut else p


def unshard(p, spec, mesh):
    """The global leaf of this process's block ``p`` (as :func:`shard`
    cut it): an ``all_gather`` over each axis that ``spec`` cuts, the
    blocks put back in place. Every process of the axis gets it."""
    for dim, name in enumerate(cuts(spec, mesh)):
        if name is None:
            continue
        ax = axis(mesh, name)
        blocks = [torch.empty_like(p) for _ in range(ax.size)]
        dist.all_gather(blocks, p.contiguous(), group=ax.group)
        p = torch.cat([_blocks(b, dim, spec, ax.size) for b in blocks],
                      dim=dim + 1).reshape(*p.shape[:dim], -1,
                                           *p.shape[dim + 1:])
    return p


def grad_groups(spec, mesh) -> list:
    """The process groups that a leaf's gradient under ``spec`` is summed
    over, in turn: one per mesh axis of size > 1 that ``spec`` leaves it
    replicated on, or the whole world in one sum where that is every such
    axis of a mesh with more than one."""
    split = cuts(spec, mesh)
    names = [name for name in mesh.mesh_dim_names
             if axis(mesh, name).size > 1]
    summed = [name for name in names if name not in split]
    if len(summed) > 1 and summed == names:
        return [dist.group.WORLD]
    return [axis(mesh, name).group for name in summed]


def reduce_grads(grads: list, groups: list) -> None:
    """Sum each gradient in place over its groups (:func:`grad_groups`,
    one list a leaf)."""
    for g, leaf_groups in zip(grads, groups):
        for group in leaf_groups:
            dist.all_reduce(g, group=group)


def _all_reduced(x, group):
    """A sum of ``x`` over ``group``, into a copy (autograd may hold ``x``
    elsewhere)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class ModelSum(torch.autograd.Function):
    """The sum of a row-parallel product's shares over the model axis. Its
    backward sums the cotangent's shares too: each model process holds a
    share of the replicated activation's cotangent (see the module's
    docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduced(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduced(grad, ctx.group), None


def model_sum(x, model: Axis):
    """:class:`ModelSum` over ``model``; ``x`` itself at one shard."""
    return x if model.size == 1 else ModelSum.apply(x, model.group)
