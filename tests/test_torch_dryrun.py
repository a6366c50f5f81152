"""The port's ``dryrun_multichip``, as tests/test_graft_entry.py runs the
JAX package's on the conftest's virtual CPU devices: every block's train
step finishes with a finite loss over 4 and 8 gloo processes on the CPU,
and inside an initialized world the blocks run on its processes. With no
card and ``device=None`` it raises instead of running on the CPU.
"""

import math

import pytest
import torch

from kubeflow_tpu_torch.entry import dryrun_multichip
from kubeflow_tpu_torch.parallel.launch import run_world

# The blocks of the JAX package's gate that the port runs at each size
# (its DCN and ICI probes are not ported).
BLOCKS = {1: {"burnin"},
          2: {"burnin", "longctx", "pipelined", "moe"},
          4: {"burnin", "longctx", "pipelined", "multislice", "moe"},
          8: {"burnin", "longctx", "pipelined", "multislice", "moe"}}


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_processes(n):
    losses = dryrun_multichip(n, device="cpu")
    assert set(losses) == BLOCKS[n]
    assert all(math.isfinite(loss) for loss in losses.values()), losses


def _in_world(rank, n):
    return dryrun_multichip(n, device="cpu")


def test_dryrun_runs_on_the_processes_of_an_initialized_world():
    ranks = run_world(_in_world, 2, 2, timeout=90)
    assert set(ranks[0]) == BLOCKS[2]
    # Every block's loss is the global one, the same on each process.
    assert ranks[0] == ranks[1]
    assert all(math.isfinite(loss) for loss in ranks[0].values())


def test_dryrun_needs_a_card_a_process_and_never_falls_back_to_the_cpu():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this host has the cards; the refusal needs fewer")
    with pytest.raises(RuntimeError, match="device_count"):
        dryrun_multichip(2)
    with pytest.raises(ValueError, match="device"):
        dryrun_multichip(2, device="meta")
