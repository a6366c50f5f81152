"""The GPU node env bootstraps a ``torch.distributed`` world: one process
per card across nodes and slices.

Spawns real worker subprocesses whose env is exactly what the controller
and the per-ordinal webhook inject (``GpuSlice.worker_env`` /
``MultiSlice.worker_env``, localhost standing in for the headless-Service
names, a free port for torchrun's), plus ``LOCAL_RANK`` where a node runs
a process per card, and holds each worker's line to the one the JAX
package's worker prints for a world of the same size
(``kubeflow_tpu.testing.distributed_worker`` under
``TpuSlice.worker_env``: the lines tests/test_distributed_bootstrap.py
holds it to). The worlds are small: nodes of one or two cards (a table
row patched in for the test; the H100 rows have 8).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import pytest

from kubeflow_tpu.tpu.topology import MultiSlice as JaxMultiSlice
from kubeflow_tpu.tpu.topology import TpuSlice
from kubeflow_tpu_torch import sdk
from kubeflow_tpu_torch.gpu import topology
from kubeflow_tpu_torch.gpu.topology import GpuSlice, MultiSlice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def small_nodes(monkeypatch):
    """Node types of one and of two cards, for worlds the CPU can hold."""
    h100 = topology.ACCELERATORS["nvidia-h100-80gb"]
    for name, cards in (("one-card", 1), ("two-card", 2)):
        monkeypatch.setitem(topology.ACCELERATORS, name, dataclasses.replace(
            h100, name=name, gpus_per_node=cards))


def _base_env() -> dict:
    env = dict(os.environ)
    for key in list(env):
        if key.startswith(("PET_", "TPU_", "JAX_", "MEGASCALE_")) or key in (
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "KFTPU_WORKER_MESH", "KFTPU_SLICE_PEERS"):
            del env[key]  # never inherit from the shell
    # The pytest parent forces an 8-device virtual host; a JAX worker is
    # one host = one process = one device.
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    return env


def _spawn(module: str, envs: list, argv=()) -> list:
    return [subprocess.Popen([sys.executable, "-m", *argv, module], env=env,
                             cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for env in envs]


def _communicate_all(procs) -> list:
    """Reap every worker even when an early one fails: a dead rank 0
    otherwise leaves the rest blocked in the collective until timeout."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _torch_envs(node_envs: list, per_node: int, extra=None) -> list:
    """One env a process: each node's env, on a free rendezvous port, with
    ``LOCAL_RANK`` where the node runs more than one process."""
    port = str(_free_port())
    envs = []
    for node_env in node_envs:
        for local in range(per_node):
            env = _base_env()
            env.update(node_env, PET_MASTER_ADDR="localhost",
                       PET_MASTER_PORT=port, **(extra or {}))
            if per_node > 1:
                env["LOCAL_RANK"] = str(local)
            envs.append(env)
    return envs


def _lines(out: str, *prefixes) -> list:
    return [line for line in out.splitlines() if line.startswith(prefixes)]


def _run(envs: list) -> list:
    return _communicate_all(_spawn(
        "kubeflow_tpu_torch.testing.distributed_worker", envs))


def _ranks(outs: list) -> list:
    return sorted(int(_lines(out, "RANK ")[0].split()[1]) for out in outs)


# The JAX workers' lines for these worlds (2 and 4 processes, and 4 on a
# 2x2 mesh), as tests/test_distributed_bootstrap.py holds them.
JAX_LINES = {2: ["PSUM_RESULT 3.0 NPROC 2"], 4: ["PSUM_RESULT 10.0 NPROC 4"],
             "2x2": ["PSUM_RESULT 10.0 NPROC 4", "MESH2D_RESULT 5.0"]}


def test_two_nodes_of_one_card_give_the_jax_workers_psum(small_nodes):
    gpu = GpuSlice.parse("one-card", "2x1")
    outs = _run(_torch_envs([gpu.worker_env(i, ["localhost"] * 2)
                             for i in range(2)], 1))
    want = JAX_LINES[2]
    for out in outs:
        assert _lines(out, "PSUM_RESULT") == want, out
    assert _ranks(outs) == [0, 1]


def test_two_nodes_of_two_cards_form_a_world_of_four(small_nodes):
    gpu = GpuSlice.parse("two-card", "2x2")
    mesh = {"KFTPU_WORKER_MESH": "2x2"}
    # The JAX worker's world of 4 is v5e 4x8: 4 hosts.
    assert TpuSlice.parse("v5e", "4x8").num_hosts == 4
    outs = _run(_torch_envs([gpu.worker_env(i, ["localhost"] * 2)
                             for i in range(2)], 2, mesh))
    want = JAX_LINES["2x2"]
    for out in outs:
        assert _lines(out, "PSUM_RESULT", "MESH2D") == want, out
    assert _ranks(outs) == [0, 1, 2, 3]


def test_two_slices_of_two_nodes_share_one_rank_space(small_nodes):
    ms = MultiSlice.parse("one-card", "2x1", 2)
    ref = JaxMultiSlice.parse("v5e", "4x4", 2)
    hosts = ms.worker_hostnames("nb", "nb-workers", "ns")
    node_envs = [ms.worker_env(s, w, hosts) for s in range(2)
                 for w in range(2)]
    # The node ranks are the JAX_PROCESS_IDs of the same two slices.
    assert [e["PET_NODE_RANK"] for e in node_envs] == [
        ref.worker_env(s, w, hosts)["JAX_PROCESS_ID"] for s in range(2)
        for w in range(2)]
    outs = _run(_torch_envs(node_envs, 1))
    want = JAX_LINES[4]
    for out in outs:
        assert _lines(out, "PSUM_RESULT") == want, out
    assert _ranks(outs) == [0, 1, 2, 3]


def test_torchrun_with_no_flags_forms_the_world_from_the_node_env(
        small_nodes):
    """Each node runs ``torchrun`` with no arguments: it reads the PET_*
    env, starts a process per card and serves the rendezvous from node 0;
    the SDK joins the agent's store."""
    gpu = GpuSlice.parse("two-card", "2x2")
    port = str(_free_port())
    envs = []
    for node in range(2):
        env = _base_env()
        env.update(gpu.worker_env(node, ["localhost"] * 2),
                   PET_MASTER_ADDR="localhost", PET_MASTER_PORT=port,
                   KFTPU_WORKER_MESH="2x2")
        envs.append(env)
    outs = _communicate_all(_spawn(
        "kubeflow_tpu_torch.testing.distributed_worker", envs,
        argv=("torch.distributed.run", "-m")))
    lines = [line for out in outs for line in _lines(out, "PSUM", "MESH2D")]
    assert sorted(lines) == ["MESH2D_RESULT 5.0"] * 4 + \
        ["PSUM_RESULT 10.0 NPROC 4"] * 4
    assert sorted(int(line.split()[1]) for out in outs
                  for line in _lines(out, "RANK ")) == [0, 1, 2, 3]


# ---- the SDK's reading of the contract, without processes ----------------------------


def test_slice_info_reads_one_process_per_card(small_nodes):
    gpu = GpuSlice.parse("two-card", "2x2")
    node = gpu.worker_env(1, ["n0", "n1"])
    infos = [sdk.SliceInfo.from_env(dict(node, LOCAL_RANK=str(local)))
             for local in range(2)]
    assert [i.process_id for i in infos] == [2, 3]
    assert {i.num_processes for i in infos} == {4}
    assert {i.coordinator_address for i in infos} == {"n0:29500"}
    assert infos[0].worker_id == 1 and infos[0].num_workers == 2
    assert infos[0].topology == "2x2"
    with pytest.raises(ValueError, match="LOCAL_RANK 2"):
        sdk.SliceInfo.from_env(dict(node, LOCAL_RANK="2"))


def test_a_pod_without_local_rank_is_its_nodes_one_rank():
    """A pod of one card, or a pod's own process, keeps one rank a node,
    as the env of the JAX names gives it."""
    gpu = GpuSlice.parse("nvidia-h100-80gb", "2x8")
    info = sdk.SliceInfo.from_env(gpu.worker_env(1, ["n0", "n1"]))
    assert (info.process_id, info.num_processes) == (1, 2)
    assert info.coordinator_address == "n0:29500"
    jax_env = TpuSlice.parse("v5e", "4x4").worker_env(1, ["n0", "n1"])
    ref = sdk.SliceInfo.from_env(jax_env)
    assert (ref.process_id, ref.num_processes) == (1, 2)


def test_a_torchrun_childs_rank_comes_first():
    gpu = GpuSlice.parse("nvidia-h100-80gb", "2x8")
    env = dict(gpu.worker_env(1, ["n0", "n1"]), LOCAL_RANK="5", RANK="13",
               WORLD_SIZE="16", MASTER_ADDR="n0", MASTER_PORT="29400")
    info = sdk.SliceInfo.from_env(env)
    assert (info.process_id, info.num_processes,
            info.coordinator_address) == (13, 16, "n0:29400")
