"""The port stands alone: ``kubeflow_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``kubeflow_tpu``, nor
``ml_dtypes`` (the card machine has none: bf16 checkpoints go through
their raw bits)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "kubeflow_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "kubeflow_tpu", "ml_dtypes")


def _forbidden(module: str) -> bool:
    # Exact top-level name: kubeflow_tpu_torch starts with kubeflow_tpu.
    return module.split(".")[0] in FORBIDDEN


def _imports(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            found.append(str(node.args[0].value))
    return found


def test_the_scan_covers_the_package_and_the_smoke_script():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "kubeflow_tpu_torch/serving/engine.py" in names
    assert "kubeflow_tpu_torch/ops/flash_attention.py" in names
    assert "kubeflow_tpu_torch/models/trainer.py" in names
    assert "kubeflow_tpu_torch/entry.py" in names
    # The long-context slice.
    assert {"kubeflow_tpu_torch/models/longctx.py",
            "kubeflow_tpu_torch/models/tree.py",
            "kubeflow_tpu_torch/parallel/ring.py",
            "kubeflow_tpu_torch/parallel/ulysses.py",
            "kubeflow_tpu_torch/telemetry/sections.py"} <= names
    # The MoE slice.
    assert {"kubeflow_tpu_torch/models/moe.py",
            "kubeflow_tpu_torch/parallel/moe.py",
            "kubeflow_tpu_torch/parallel/mesh.py"} <= names
    # The pipelined and vision slice.
    assert {"kubeflow_tpu_torch/parallel/pipeline.py",
            "kubeflow_tpu_torch/models/pipelined.py",
            "kubeflow_tpu_torch/models/vision.py"} <= names
    # The step telemetry slice.
    assert {"kubeflow_tpu_torch/telemetry/__init__.py",
            "kubeflow_tpu_torch/telemetry/profiler.py",
            "kubeflow_tpu_torch/telemetry/publisher.py",
            "kubeflow_tpu_torch/telemetry/ledger.py"} <= names
    # The checkpoint, data and SDK slice, and the trimmed copies the SDK
    # needs.
    assert {"kubeflow_tpu_torch/checkpoint/__init__.py",
            "kubeflow_tpu_torch/checkpoint/abstract.py",
            "kubeflow_tpu_torch/checkpoint/fabric.py",
            "kubeflow_tpu_torch/checkpoint/manager.py",
            "kubeflow_tpu_torch/checkpoint/store.py",
            "kubeflow_tpu_torch/utils/checkpoint.py",
            "kubeflow_tpu_torch/data.py",
            "kubeflow_tpu_torch/sdk.py",
            "kubeflow_tpu_torch/api/keys.py",
            "kubeflow_tpu_torch/api/notebook.py",
            "kubeflow_tpu_torch/migration/protocol.py",
            "kubeflow_tpu_torch/runtime/objects.py"} <= names
    # The kernels' CUDA sources, which ops/flash_attention.py builds (the
    # ring hop's partial kernel shares the forward's source; heads wider
    # than 128 columns run the wide source's four kernels).
    csrc = REPO / "kubeflow_tpu_torch" / "ops" / "csrc"
    assert {"flash_attention_fwd.cu", "flash_attention_bwd.cu",
            "flash_attention_wide.cu"} <= {p.name for p in csrc.glob("*.cu")}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_kubeflow_tpu_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_matcher_tells_the_packages_apart():
    assert _forbidden("kubeflow_tpu.serving.engine")
    assert _forbidden("jax.numpy")
    assert not _forbidden("kubeflow_tpu_torch.serving.engine")


def test_importing_the_engine_loads_no_jax():
    code = ("import sys, kubeflow_tpu_torch.serving.engine, "
            "kubeflow_tpu_torch.serving.loadgen, kubeflow_tpu_torch.models, "
            "kubeflow_tpu_torch.models.trainer, kubeflow_tpu_torch.entry, "
            "kubeflow_tpu_torch.models.longctx, "
            "kubeflow_tpu_torch.models.pipelined, "
            "kubeflow_tpu_torch.models.vision, kubeflow_tpu_torch.telemetry, "
            "kubeflow_tpu_torch.checkpoint, kubeflow_tpu_torch.data, "
            "kubeflow_tpu_torch.sdk, kubeflow_tpu_torch.utils.checkpoint; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'kubeflow_tpu', 'ml_dtypes')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
