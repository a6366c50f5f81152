"""What a restore builds: the port's counterpart of an abstract pytree.

The JAX package restores onto ``jax.ShapeDtypeStruct`` leaves (from
``jax.eval_shape``), optionally carrying a ``NamedSharding``, and
``device_put`` places each leaf. Here a :class:`LeafSpec` says the same of
one leaf: its global shape and dtype, the device it lands on and,
optionally, a sharding rule and the mesh it cuts over
(:mod:`kubeflow_tpu_torch.parallel.mesh`). :func:`place` walks a restored
tree and its abstract together. The abstract's containers win: a dict
comes back in the abstract's key order and a sequence as the abstract's
type, so a tree stored with sorted keys is rebuilt in the order the
caller's live state uses. A leaf with a rule is cut to this process's
shard with ``parallel.mesh.shard``, the counterpart of ``device_put`` onto
a ``NamedSharding``.

A spec naming a CUDA device raises where there is none: a restore never
lands on the CPU instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubeflow_tpu_torch.parallel.mesh import shard


@dataclass(frozen=True)
class LeafSpec:
    """One leaf of an abstract tree: the global ``shape`` and ``dtype``
    stored in the checkpoint, the ``device`` it is placed on and, for a
    sharded leaf, the ``rule`` (a sharding rule as ``parallel.mesh``
    takes it) and the ``mesh`` it is cut over."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    rule: tuple = ()
    mesh: object = None

    @classmethod
    def of(cls, tensor, rule: tuple = (), mesh=None) -> "LeafSpec":
        """The spec of a live (global) ``tensor``."""
        return cls(tuple(tensor.shape), tensor.dtype, tensor.device, rule,
                   mesh)

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and any(
            name is not None for name in self.rule)


def target_device(spec: LeafSpec) -> torch.device:
    """``spec.device``, refusing a CUDA device on a machine without one."""
    device = torch.device(spec.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: the abstract places a leaf on {device}; "
            "restore onto device='cpu' specs to read it on the host")
    return device


def place_leaf(x: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
    """A restored host leaf ``x`` (the global leaf) on ``spec``'s device,
    in its dtype, cut to this process's shard where ``spec`` has a rule."""
    if tuple(x.shape) != tuple(spec.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(x.shape)}, the "
                         f"abstract wants {tuple(spec.shape)}")
    device = target_device(spec)
    if spec.sharded:
        x = shard(x, spec.rule, spec.mesh)
    return x.to(device=device, dtype=spec.dtype).contiguous()


def place(tree, abstract, leaf_fn=place_leaf):
    """``tree`` rebuilt on ``abstract``'s containers, each leaf through
    ``leaf_fn(leaf, spec)``; a ``None`` in the abstract keeps the leaf as
    restored."""
    if isinstance(abstract, LeafSpec):
        return leaf_fn(tree, abstract)
    if abstract is None:
        return tree
    if isinstance(abstract, dict):
        if not isinstance(tree, dict) or set(tree) != set(abstract):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"checkpoint keys {got} do not match the "
                             f"abstract's {sorted(abstract)}")
        return {key: place(tree[key], spec, leaf_fn)
                for key, spec in abstract.items()}
    if isinstance(abstract, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(abstract):
            raise ValueError(f"checkpoint sequence {tree!r:.80} does not "
                             f"match the abstract's {len(abstract)} items")
        items = [place(t, a, leaf_fn) for t, a in zip(tree, abstract)]
        return items if isinstance(abstract, list) else tuple(items)
    raise TypeError(f"abstract leaf {abstract!r} is not a LeafSpec")


def leaf_specs(abstract) -> list:
    """The abstract's :class:`LeafSpec` leaves, depth first."""
    if isinstance(abstract, LeafSpec):
        return [abstract]
    if isinstance(abstract, dict):
        return [s for value in abstract.values() for s in leaf_specs(value)]
    if isinstance(abstract, (list, tuple)):
        return [s for value in abstract for s in leaf_specs(value)]
    return []
