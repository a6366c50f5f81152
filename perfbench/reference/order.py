"""Which rows a training job's loader hands out, worked out again from the
seed.

The loader's order is a documented contract: for epoch ``e`` the rows are
``numpy.random.default_rng((seed, e)).permutation(n_rows)``, cut to whole
batches, and a world of one process takes batches 0, 1, 2, ... of it in
turn. The reference reads the rows of the first batches by that rule from
the benchmark's own token rows.
"""

from __future__ import annotations

import numpy as np


def first_batches(rows: np.ndarray, batch: int, seed: int, count: int) -> list:
    """The first ``count`` batches (each ``[batch, seq]``) of epoch 0."""
    usable = len(rows) // batch * batch
    if count * batch > usable:
        raise ValueError(f"{count} batches of {batch} need more than "
                         f"{len(rows)} rows")
    order = np.random.default_rng((seed, 0)).permutation(len(rows))[:usable]
    return [rows[order[i * batch:(i + 1) * batch]] for i in range(count)]
