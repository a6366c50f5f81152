"""The port's slice burn-in probes (``kubeflow_tpu_torch.probe``) against
the JAX package's (``kubeflow_tpu.probe``): the same report fields and
JSON, the same bus-bandwidth formula and bytes a device at the same world
size and size, the same scoring of ring reports and the same env configs.
The all-reduce runs on gloo here (world 1 in this process, world 4 in
spawned CPU processes): only the plumbing means anything on the CPU. The
DCN ring runs the repo's native binary over loopback on free ports."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import pytest
import torch

from kubeflow_tpu.probe import dcn as jax_dcn
from kubeflow_tpu.probe import ici as jax_ici
from kubeflow_tpu_torch.gpu.topology import GpuSlice, MultiSlice
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.probe import dcn, ici

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "nvidia-h100-80gb"
MBYTES = 1.0


def test_ici_report_fields_and_json_equal_the_reference():
    assert [f.name for f in dataclasses.fields(ici.IciReport)] == \
        [f.name for f in dataclasses.fields(jax_ici.IciReport)]
    for values in ((4, 250000, 2, 1e-3, 1.5, 450.0, 0.0033, "gloo"),
                   (1, 1000000, 2, 2e-5, float("inf"), None, None, "nccl")):
        assert ici.IciReport(*values).to_dict() == \
            jax_ici.IciReport(*values).to_dict()
    assert ici.IciReport(*values).to_dict()["algo_bandwidth_gbps"] is None


def test_dcn_report_fields_and_json_equal_the_reference():
    assert [f.name for f in dataclasses.fields(dcn.DcnReport)] == \
        [f.name for f in dataclasses.fields(jax_dcn.DcnReport)]
    for values in ((2, 4.0, 2, 3.5, 4.0, 100.0, 0.035),
                   (1, 0.0, 0, float("inf"), float("inf"), None, None)):
        assert dcn.DcnReport(*values).to_dict() == \
            jax_dcn.DcnReport(*values).to_dict()


REPORTS = [
    [{"rank": 0, "world": 2, "mbytes": 4.0, "iters": 2, "seconds": 0.01,
      "gbps": 5.0},
     {"rank": 1, "world": 2, "mbytes": 4.0, "iters": 2, "seconds": 0.01,
      "gbps": 4.0}],
    [{"rank": 0, "world": 1, "gbps": None}],
    [{"rank": 0, "world": 3, "mbytes": 2.0, "iters": 3, "gbps": 1.23456},
     {"rank": 2, "world": 3, "gbps": 7.0}],
]


@pytest.mark.parametrize("reports", REPORTS, ids=range(len(REPORTS)))
def test_score_reports_equals_the_reference(reports):
    assert dataclasses.asdict(dcn.score_reports(reports)) == \
        dataclasses.asdict(jax_dcn.score_reports(reports))
    scored = dcn.score_reports(reports,
                               multi=MultiSlice.parse(H100, "1x8", 2))
    if scored.min_gbps != float("inf"):
        assert scored.peak_estimate_gbps == 100.0
        raw = min(r["gbps"] for r in reports if r["gbps"] is not None)
        assert scored.fraction_of_peak == round(raw / 100.0, 4)
    with pytest.raises(dcn.DcnProbeError):
        dcn.score_reports([])


def test_a_single_slice_scores_no_peak():
    scored = dcn.score_reports([{"rank": 0, "world": 1, "gbps": None}],
                               multi=MultiSlice.parse(H100, "2x8", 1))
    assert scored.fraction_of_peak is None
    assert scored.to_dict()["min_gbps"] is None
    assert scored.to_dict()["peak_estimate_gbps"] is None


def test_the_formula_is_the_references():
    """The reference's own report, refolded through the port's formula,
    gives the reference's bandwidth; both put the same bytes on a
    device."""
    for k in (2, 4, 8):
        ref = jax_ici.run_ici_probe(mbytes=MBYTES, iters=2, warmup=1,
                                    devices=jax.devices()[:k])
        assert round(ici.algo_bandwidth_gbps(k, ref.bytes_per_device,
                                             ref.mean_seconds), 3) == \
            ref.algo_bandwidth_gbps
    assert ici.algo_bandwidth_gbps(1, 100, 1.0) == float("inf")


def test_world_of_one_on_gloo_matches_the_reference_at_one_device():
    got = ici.run_ici_probe(mbytes=MBYTES, iters=2, warmup=1,
                            accelerator=H100, topology="1x1", device="cpu")
    ref = jax_ici.run_ici_probe(mbytes=MBYTES, iters=2, warmup=1,
                                devices=jax.devices()[:1])
    assert got.devices == ref.devices == 1
    assert got.bytes_per_device == ref.bytes_per_device
    assert got.algo_bandwidth_gbps == ref.algo_bandwidth_gbps == float("inf")
    assert got.to_dict()["algo_bandwidth_gbps"] is None
    assert got.peak_estimate_gbps == float("inf")
    assert got.fraction_of_peak is None
    assert got.backend == "gloo" and got.mean_seconds > 0
    assert not torch.distributed.is_initialized()  # its world is gone


def _probe_world(rank: int) -> dict:
    import torch.distributed as dist

    whole = ici.run_ici_probe(mbytes=MBYTES, iters=3, warmup=1,
                              accelerator=H100, topology="1x4",
                              device="cpu").to_dict()
    pair = dist.new_group([0, 1])
    half = None
    if rank < 2:
        half = ici.run_ici_probe(mbytes=MBYTES, iters=2, warmup=1,
                                 group=pair, device="cpu").to_dict()
    return {"whole": whole, "half": half}


@pytest.fixture(scope="module")
def world_4():
    return run_world(_probe_world, 4, timeout=120)


def test_world_of_four_on_gloo(world_4):
    reports = [r["whole"] for r in world_4]
    # The slowest rank's mean: every rank reports the same.
    assert all(r == reports[0] for r in reports)
    got = reports[0]
    ref = jax_ici.run_ici_probe(mbytes=MBYTES, iters=3, warmup=1,
                                devices=jax.devices()[:4])
    assert got["devices"] == ref.devices == 4
    assert got["bytes_per_device"] == ref.bytes_per_device
    assert got["backend"] == "gloo" and got["iters"] == 3
    assert got["algo_bandwidth_gbps"] == round(ici.algo_bandwidth_gbps(
        4, got["bytes_per_device"], got["mean_seconds"]), 3) > 0
    peak = GpuSlice.parse(H100, "1x4").allreduce_algo_bandwidth_gbps()
    assert got["peak_estimate_gbps"] == peak == 450.0
    assert math.isclose(got["fraction_of_peak"],
                        got["algo_bandwidth_gbps"] / peak, abs_tol=1e-4)


def test_a_group_probes_its_own_ranks(world_4):
    halves = [r["half"] for r in world_4]
    assert halves[2] is None and halves[3] is None
    assert halves[0] == halves[1]
    assert halves[0]["devices"] == 2
    assert halves[0]["bytes_per_device"] == int(MBYTES * 1e6 / 2) // 2 * 2
    assert halves[0]["fraction_of_peak"] is None


def test_the_probe_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ici.run_ici_probe(mbytes=MBYTES, iters=1)
    assert not torch.distributed.is_initialized()


# ---- the DCN ring ----------------------------------------------------------------------


def test_the_binary_builds_into_the_library_dir_not_native():
    binary = dcn.find_or_build_binary()
    assert binary == dcn.binary_path()
    assert binary.parent == _build.BUILD_DIR
    assert binary.name.startswith("dcn_probe-") and os.access(binary, os.X_OK)
    assert dcn.NATIVE_DIR not in binary.parents
    # Built once: a second call finds it.
    assert dcn.find_or_build_binary() == binary


@pytest.mark.parametrize("world", [2, 3])
def test_loopback_ring(world):
    reports = dcn.run_local_ring(world=world, mbytes=2.0, iters=2,
                                 base_port=dcn.free_base_port(world))
    assert sorted(r["rank"] for r in reports) == list(range(world))
    assert all(r["world"] == world and r["gbps"] > 0.1 and r["iters"] == 2
               for r in reports)
    scored = dcn.score_reports(reports, multi=MultiSlice.parse(H100, "1x8",
                                                               world))
    assert scored.min_gbps > 0 and scored.fraction_of_peak > 0


ENVS = [
    {},
    {"TPU_WORKER_HOSTNAMES": "a.svc,b.svc", "TPU_WORKER_ID": "1"},
    {"TPU_WORKER_HOSTNAMES": "a.svc,b.svc", "TPU_WORKER_ID": "x"},
    {"KFTPU_SLICE_PEERS": "s0.svc,s1.svc,s2.svc", "MEGASCALE_SLICE_ID": "2",
     "TPU_WORKER_ID": "0"},
    {"KFTPU_SLICE_PEERS": "s0.svc,s1.svc", "MEGASCALE_SLICE_ID": "1",
     "TPU_WORKER_ID": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_env_configs_equal_the_reference(env, monkeypatch):
    for key in ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID", "KFTPU_SLICE_PEERS",
                "MEGASCALE_SLICE_ID", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert dcn.worker_env_config() == jax_dcn.worker_env_config()
    assert dcn.slice_env_config() == jax_dcn.slice_env_config()
    # Of a node's per-card processes only the first joins a ring.
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert dcn.worker_env_config() == jax_dcn.worker_env_config()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert dcn.worker_env_config() is None
    assert dcn.slice_env_config() is None


def test_the_node_env_configures_both_rings(monkeypatch):
    ms = MultiSlice.parse(H100, "2x8", 2)
    hosts = ms.worker_hostnames("nb", "nb-w", "ns")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for key, value in ms.worker_env(1, 0, hosts).items():
        monkeypatch.setenv(key, value)
    assert dcn.worker_env_config() == (0, 2, hosts[1])
    assert dcn.slice_env_config() == (1, 2, [hosts[0][0], hosts[1][0]])


# ---- the CLI ---------------------------------------------------------------------------


def _cli(module: str, accelerator: str, topology: str) -> dict:
    env = {**os.environ, "TPU_WORKER_HOSTNAMES": "127.0.0.1",
           "TPU_WORKER_ID": "0", "KFTPU_SLICE_PEERS": "127.0.0.1",
           "MEGASCALE_SLICE_ID": "0"}
    env.pop("LOCAL_RANK", None)
    argv = [sys.executable, "-m", module, "--mbytes", str(MBYTES),
            "--iters", "2", "--accelerator", accelerator,
            "--topology", topology]
    if module.startswith("kubeflow_tpu_torch"):
        argv += ["--device", "cpu"]
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_cli_prints_the_references_keys():
    got = _cli("kubeflow_tpu_torch.probe", H100, "1x8")
    want = _cli("kubeflow_tpu.probe", "v5e", "2x2")
    assert set(got) == set(want) == {"ici", "dcn", "dcn_cross_slice",
                                     "dcn_cross_slice_scored"}
    for key in want:
        assert set(got[key]) == set(want[key]), key
    assert got["ici"]["backend"] == "gloo" and got["ici"]["devices"] == 1
    assert got["ici"]["peak_estimate_gbps"] == 450.0
    assert got["dcn"] == want["dcn"]  # the same binary's world-1 report


def test_the_cli_under_torchrun_runs_in_its_world():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PET_", "TPU_", "KFTPU_", "MEGASCALE_"))}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "kubeflow_tpu_torch.probe",
         "--device", "cpu", "--skip-dcn", "--mbytes", str(MBYTES),
         "--iters", "2", "--accelerator", H100, "--topology", "1x2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    docs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(docs) == 1  # the node's first process prints
    got = docs[0]["ici"]
    assert got["devices"] == 2 and got["backend"] == "gloo"
    assert got["algo_bandwidth_gbps"] > 0
    assert got["fraction_of_peak"] is not None
