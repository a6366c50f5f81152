"""Parameter-tree helpers shared by the models and the trainer.

A parameter tree is a nest of dicts and lists with tensors at its leaves,
as the JAX package's pytrees are.
"""

from __future__ import annotations

import torch


def map_params(fn, tree):
    """``tree`` with ``fn`` applied to every leaf tensor."""
    if isinstance(tree, dict):
        return {key: map_params(fn, value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, value) for value in tree]
    return fn(tree)


def leaves(tree) -> list:
    """The tree's tensors in a fixed order (dict order, then list order)."""
    if isinstance(tree, dict):
        return [t for value in tree.values() for t in leaves(value)]
    if isinstance(tree, list):
        return [t for value in tree for t in leaves(value)]
    return [tree]


def map_with(fn, tree, rules):
    """``tree`` with ``fn(leaf, rule)`` applied to every leaf, ``rules`` a
    tree of the same structure (a sharding rule a leaf)."""
    specs = iter(leaves(rules))
    return map_params(lambda p: fn(p, next(specs)), tree)


def value_and_grad(fn, params: dict, *args):
    """``(fn(params, *args), grads)``, the grads a list in
    :func:`leaves` order. The gradient is taken through aliases of the
    parameters, so their own ``requires_grad`` is left as it is."""
    live = map_params(lambda p: p.detach().requires_grad_(), params)
    loss = fn(live, *args)
    return loss.detach(), list(torch.autograd.grad(loss, leaves(live)))
