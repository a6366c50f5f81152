"""The benchmark's inputs, made from ``--seed``: the weights (on the
device) and the token rows (on the host, for the program's loader).

Both sides get the same inputs from here: the program its parameter tree,
the plain reference the same numbers by name. Nothing here comes from the
program.

Weights are drawn in groups, one ``torch.randn`` call a group on the
device from a generator seeded by ``(seed, group)``: the embeddings, then
one group a layer. A group can be drawn again alone (the first-step and
change readings need the starting weights of one group at a time), and
the whole tree takes ``n_layers + 1`` calls. Scales are the burn-in
model's init: normal x 0.02 for the embeddings, x 1/sqrt(fan_in) for the
dense layers, ones for the norms.
"""

from __future__ import annotations

import numpy as np
import torch

_GROUP_SEED_STRIDE = 1_000_003


def layer_specs(model: dict) -> list:
    """(name, shape, scale) of one layer's leaves, in the program's tree
    order; scale None is a norm's ones."""
    d, ff = model["d_model"], model["d_ff"]
    return [("ln1", (d,), None), ("ln2", (d,), None),
            ("qkv", (d, 3 * d), d ** -0.5), ("attn_out", (d, d), d ** -0.5),
            ("ff1", (d, ff), d ** -0.5), ("ff2", (ff, d), ff ** -0.5)]


def group_specs(model: dict, group: int) -> list:
    """(leaf name, shape, scale) of weight group ``group``: 0 the
    embeddings and the final norm, ``i + 1`` layer ``i``."""
    d = model["d_model"]
    if group == 0:
        return [("embed", (model["vocab"], d), 0.02),
                ("pos", (model["seq_len"], d), 0.02),
                ("out_norm", (d,), None)]
    return [(f"layers.{group - 1}.{name}", shape, scale)
            for name, shape, scale in layer_specs(model)]


def n_groups(model: dict) -> int:
    return model["n_layers"] + 1


def leaf_names(model: dict) -> list:
    """Every leaf's name, in the program's ``tree.leaves`` order."""
    return [name for g in range(n_groups(model))
            for name, _, _ in group_specs(model, g)]


def make_group(model: dict, seed: int, group: int, device) -> dict:
    """Group ``group``'s f32 weights by leaf name, views of one buffer
    drawn in one call."""
    specs = group_specs(model, group)
    total = sum(int(np.prod(shape)) for _, shape, scale in specs
                if scale is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * _GROUP_SEED_STRIDE + group) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape, scale in specs:
        if scale is None:
            out[name] = torch.ones(shape, device=device)
            continue
        n = int(np.prod(shape))
        out[name] = flat[offset:offset + n].view(shape).mul_(scale)
        offset += n
    return out


def make_weights(model: dict, seed: int, device) -> dict:
    """Every leaf's f32 weights by name."""
    out = {}
    for g in range(n_groups(model)):
        out.update(make_group(model, seed, g, device))
    return out


def as_tree(weights: dict, model: dict) -> dict:
    """The program's parameter tree (``models.burnin``'s layout) over the
    same tensors."""
    layers = [{name: weights[f"layers.{i}.{name}"]
               for name, _, _ in layer_specs(model)}
              for i in range(model["n_layers"])]
    return {"embed": weights["embed"], "pos": weights["pos"],
            "out_norm": weights["out_norm"], "layers": layers}


def token_rows(tokens: dict, vocab: int, seq_len: int, seed: int) -> np.ndarray:
    """``tokens["rows"]`` int64 rows of ``seq_len`` ids: each id drawn
    from a Zipf-Mandelbrot law over the vocabulary (p(rank) ~ 1 / (rank +
    offset) ** exponent, as word frequencies in text), ranks mapped to
    ids by a permutation from the seed. Every seed draws the same number
    of rows of the same length under the same law."""
    rng = np.random.default_rng([seed, 0x70b5])
    ranks = np.arange(vocab, dtype=np.float64)
    weights = (ranks + tokens["zipf_offset"]) ** -tokens["zipf_exponent"]
    cdf = np.cumsum(weights / weights.sum())
    draws = rng.random((tokens["rows"], seq_len))
    rank = np.minimum(np.searchsorted(cdf, draws), vocab - 1)
    return rng.permutation(vocab)[rank].astype(np.int64)
