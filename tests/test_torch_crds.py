"""The port's CRDs (``kubeflow_tpu_torch/manifests/crds``) against the
reference's (``manifests/crds``): the Notebook and InferenceService CRDs'
``spec.gpu`` block is the reference's ``spec.tpu`` block with the
accelerator enum taken from ``gpu/topology.ACCELERATORS``, and the Profile
CRD's ``spec.gpuQuota`` is its ``spec.tpuQuota``. Everything else is
equal, property for property; the Tensorboard and PVCViewer CRDs, which
name no accelerator, are the reference's.
"""

from pathlib import Path

import pytest
import yaml

from kubeflow_tpu_torch.api import inferenceservice as isvcapi
from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.gpu.topology import ACCELERATORS

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "manifests" / "crds"
PORT = REPO / "kubeflow_tpu_torch" / "manifests" / "crds"

# The port's names, mapped back to the reference's.
RENAMES = {"gpu": "tpu", "gpuQuota": "tpuQuota", ".spec.gpu.accelerator":
           ".spec.tpu.accelerator", ".spec.gpu.topology": ".spec.tpu.topology",
           ".status.gpu.hosts": ".status.tpu.hosts",
           ".spec.gpuQuota": ".spec.tpuQuota", "GPU-Quota": "TPU-Quota"}


def _load(path: Path) -> dict:
    return yaml.safe_load(path.read_text())


def _spec_props(crd: dict, version: int = 0) -> dict:
    return crd["spec"]["versions"][version]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]["properties"]


def _renamed(node):
    if isinstance(node, dict):
        return {RENAMES.get(k, k): _renamed(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_renamed(v) for v in node]
    return RENAMES.get(node, node) if isinstance(node, str) else node


def _without_enum(crd: dict, block: str) -> dict:
    for version in crd["spec"]["versions"]:
        props = version["schema"]["openAPIV3Schema"]["properties"]["spec"][
            "properties"][block]["properties"]
        props["accelerator"].pop("enum", None)  # versions share one schema
    return crd


def test_the_notebook_gpu_enum_is_the_node_type_table():
    crd = _load(PORT / "notebooks.yaml")
    for version in range(len(crd["spec"]["versions"])):
        gpu = _spec_props(crd, version)["gpu"]
        assert gpu["properties"]["accelerator"]["enum"] == list(ACCELERATORS)
        assert "tpu" not in _spec_props(crd, version)


def test_the_notebook_crd_is_the_reference_outside_the_gpu_block():
    port = _without_enum(_load(PORT / "notebooks.yaml"), "gpu")
    ref = _without_enum(_load(REFERENCE / "notebooks.yaml"), "tpu")
    assert _renamed(port) == ref
    # The four fields of the block, as nbapi.new writes them.
    nb = nbapi.new("nb", "ns", accelerator="nvidia-h100-80gb",
                   topology="2x8", num_slices=2, queued=True)
    assert set(nb["spec"]["gpu"]) == set(
        _spec_props(_load(PORT / "notebooks.yaml"))["gpu"]["properties"])


def test_the_profile_crd_is_the_reference_with_gpu_quota():
    port, ref = _load(PORT / "profiles.yaml"), _load(REFERENCE / "profiles.yaml")
    assert "gpuQuota" in _spec_props(port) and "tpuQuota" not in _spec_props(port)
    assert _renamed(port) == ref
    profile = profileapi.new("ns", "alice@example.com", gpu_quota=16)
    assert set(profile["spec"]) <= set(_spec_props(port))


def test_the_inference_service_crd_is_the_reference_with_spec_gpu():
    port = _load(PORT / "inferenceservices.yaml")
    gpu = _spec_props(port)["gpu"]
    assert gpu["properties"]["accelerator"]["enum"] == list(ACCELERATORS)
    assert "tpu" not in _spec_props(port)
    columns = {c["name"]: c["jsonPath"] for c in
               port["spec"]["versions"][0]["additionalPrinterColumns"]}
    assert (columns["Accelerator"], columns["Topology"]) == (
        ".spec.gpu.accelerator", ".spec.gpu.topology")
    ref = _without_enum(_load(REFERENCE / "inferenceservices.yaml"), "tpu")
    assert _renamed(_without_enum(port, "gpu")) == ref
    # The blocks isvcapi.new writes are the schema's.
    isvc = isvcapi.new("svc", "ns", num_slices=2, min_replicas=1,
                       target_rate=2.0, scale_to_zero_after=60.0,
                       checkpoint_path="/models/svc")
    props = _spec_props(_load(PORT / "inferenceservices.yaml"))
    assert set(isvc["spec"]["gpu"]) == set(props["gpu"]["properties"])
    assert set(isvc["spec"]["scaling"]) <= set(props["scaling"]["properties"])
    assert set(isvc["spec"]) <= set(props)


@pytest.mark.parametrize("name", ["notebooks.yaml", "profiles.yaml"])
def test_every_served_version_shares_one_schema(name):
    crd = _load(PORT / name)
    schemas = [v["schema"] for v in crd["spec"]["versions"]]
    assert len(schemas) > 1 and all(s == schemas[0] for s in schemas)


@pytest.mark.parametrize("name", ["tensorboards.yaml", "pvcviewers.yaml"])
def test_the_crds_without_an_accelerator_are_the_references(name):
    port = _load(PORT / name)
    assert port == _load(REFERENCE / name)
    # What the APIs write is the schema's.
    from kubeflow_tpu_torch.api import pvcviewer as pvcapi
    from kubeflow_tpu_torch.api import tensorboard as tbapi

    obj = (tbapi.new("tb", "ns", "pvc://logs/run1", profiler=True)
           if name == "tensorboards.yaml"
           else pvcapi.new("view", "ns", "logs"))
    assert obj["kind"] == port["spec"]["names"]["kind"]
    assert obj["apiVersion"].split("/")[1] in [
        v["name"] for v in port["spec"]["versions"]]
    assert set(obj["spec"]) <= set(_spec_props(port))
