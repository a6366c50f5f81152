"""The port's ``dryrun_multichip``, as tests/test_graft_entry.py runs the
JAX package's on the conftest's virtual CPU devices: every block's train
step finishes with a finite loss over 4 and 8 gloo processes on the CPU,
the all-reduce probe (n >= 2) and the DCN ring probe (n >= 4 and even)
report and score, and inside an initialized world the blocks run on its
processes. With no card and ``device=None`` it raises instead of running
on the CPU.
"""

import math

import pytest
import torch

from kubeflow_tpu_torch.entry import PROBE_ACCELERATOR, dryrun_multichip
from kubeflow_tpu_torch.gpu.topology import GpuSlice, MultiSlice
from kubeflow_tpu_torch.parallel.launch import run_world

# The blocks of the JAX package's gate that the port runs at each size,
# the probes' reports among them.
BLOCKS = {1: {"burnin"},
          2: {"burnin", "longctx", "pipelined", "ici", "moe"},
          4: {"burnin", "longctx", "pipelined", "multislice", "dcn", "ici",
              "moe"},
          8: {"burnin", "longctx", "pipelined", "multislice", "dcn", "ici",
              "moe"}}
REPORTS = ("ici", "dcn")


def _losses(blocks: dict) -> list:
    return [v for k, v in blocks.items() if k not in REPORTS]


def _check_reports(blocks: dict, n: int) -> None:
    ici = blocks["ici"]
    assert ici["devices"] == n and ici["backend"] == "gloo"
    assert ici["algo_bandwidth_gbps"] > 0
    peak = GpuSlice.parse(PROBE_ACCELERATOR,
                          "2x8").allreduce_algo_bandwidth_gbps()
    assert ici["peak_estimate_gbps"] == peak
    assert math.isclose(ici["fraction_of_peak"],
                        ici["algo_bandwidth_gbps"] / peak, abs_tol=1e-4)
    if n >= 4:
        dcn = blocks["dcn"]
        assert dcn["world"] == 2 and dcn["min_gbps"] > 0
        assert dcn["peak_estimate_gbps"] == MultiSlice.parse(
            PROBE_ACCELERATOR, "1x8", 2).dcn_ring_bandwidth_gbps()
        assert dcn["fraction_of_peak"] > 0


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_processes(n):
    losses = dryrun_multichip(n, device="cpu")
    assert set(losses) == BLOCKS[n]
    assert all(math.isfinite(loss) for loss in _losses(losses)), losses
    _check_reports(losses, n)


def _in_world(rank, n):
    return dryrun_multichip(n, device="cpu")


def test_dryrun_runs_on_the_processes_of_an_initialized_world():
    ranks = run_world(_in_world, 2, 2, timeout=90)
    assert set(ranks[0]) == BLOCKS[2]
    # Every block's loss is the global one, the same on each process, and
    # so is the probe's report (the slowest rank's time).
    assert ranks[0] == ranks[1]
    assert all(math.isfinite(loss) for loss in _losses(ranks[0]))
    _check_reports(ranks[0], 2)


def test_dryrun_needs_a_card_a_process_and_never_falls_back_to_the_cpu():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this host has the cards; the refusal needs fewer")
    with pytest.raises(RuntimeError, match="device_count"):
        dryrun_multichip(2)
    with pytest.raises(ValueError, match="device"):
        dryrun_multichip(2, device="meta")
