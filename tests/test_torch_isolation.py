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
    # The slice burn-in on GPU nodes: node shapes and env, the per-ordinal
    # webhook, the bootstrap worker, the probes and the kernel cache.
    assert {"kubeflow_tpu_torch/gpu/__init__.py",
            "kubeflow_tpu_torch/gpu/topology.py",
            "kubeflow_tpu_torch/webhooks/__init__.py",
            "kubeflow_tpu_torch/webhooks/gpu.py",
            "kubeflow_tpu_torch/testing/__init__.py",
            "kubeflow_tpu_torch/testing/distributed_worker.py",
            "kubeflow_tpu_torch/probe/__init__.py",
            "kubeflow_tpu_torch/probe/__main__.py",
            "kubeflow_tpu_torch/probe/ici.py",
            "kubeflow_tpu_torch/probe/dcn.py",
            "kubeflow_tpu_torch/utils/compilecache.py"} <= names
    # The notebook spawn path on GPU nodes: the controller runtime, the
    # fake apiserver and pod simulator, the Notebook, Profile and
    # PodDefault APIs, the admission chain and the notebook controller.
    assert {f"kubeflow_tpu_torch/runtime/{m}.py" for m in (
        "errors", "aiotasks", "scheme", "queue", "informer", "apply",
        "events", "timeline", "manager", "sharding", "deployment",
        "leaderelection", "metrics", "objects", "tracing", "slo")} <= names
    assert {"kubeflow_tpu_torch/testing/fakekube.py",
            "kubeflow_tpu_torch/testing/podsim.py",
            "kubeflow_tpu_torch/api/profile.py",
            "kubeflow_tpu_torch/api/poddefault.py",
            "kubeflow_tpu_torch/api/convert.py",
            "kubeflow_tpu_torch/webhooks/notebook.py",
            "kubeflow_tpu_torch/webhooks/poddefault.py",
            "kubeflow_tpu_torch/webhooks/register.py",
            "kubeflow_tpu_torch/controllers/__init__.py",
            "kubeflow_tpu_torch/controllers/common.py",
            "kubeflow_tpu_torch/controllers/notebook.py",
            "kubeflow_tpu_torch/migration/__init__.py"} <= names
    # The fleet scheduler in GPU units, the profile controller and the
    # warm pod pools, with the trimmed copies they need.
    assert {f"kubeflow_tpu_torch/scheduler/{m}.py" for m in (
        "__init__", "fleet", "policy", "elastic", "runtime")} <= names
    assert {"kubeflow_tpu_torch/controllers/profile.py",
            "kubeflow_tpu_torch/controllers/warmpool.py",
            "kubeflow_tpu_torch/cmd/__init__.py",
            "kubeflow_tpu_torch/cmd/envconfig.py",
            "kubeflow_tpu_torch/api/inferenceservice.py",
            "kubeflow_tpu_torch/utils/fswatch.py"} <= names
    # The culling controller and the serving workload class.
    assert {"kubeflow_tpu_torch/controllers/culling.py",
            "kubeflow_tpu_torch/serving/autoscaler.py",
            "kubeflow_tpu_torch/serving/controller.py",
            "kubeflow_tpu_torch/webhooks/inferenceservice.py"} <= names
    # Tensorboard and PVCViewer, the wire (the HTTP client, its flow
    # control, the admission server and its JSONPatch engine) and the
    # entry points.
    assert {"kubeflow_tpu_torch/api/tensorboard.py",
            "kubeflow_tpu_torch/api/pvcviewer.py",
            "kubeflow_tpu_torch/controllers/tensorboard.py",
            "kubeflow_tpu_torch/controllers/pvcviewer.py",
            "kubeflow_tpu_torch/runtime/flowcontrol.py",
            "kubeflow_tpu_torch/runtime/httpclient.py",
            "kubeflow_tpu_torch/webhooks/jsonpatch.py",
            "kubeflow_tpu_torch/webhooks/server.py",
            "kubeflow_tpu_torch/cmd/controller_manager.py",
            "kubeflow_tpu_torch/cmd/webhook.py"} <= names
    # The web apps (their backends, SPAs' servers and entry points), the
    # JS runtime and the harness the frontend tests drive them with.
    assert {f"kubeflow_tpu_torch/web/{m}.py" for m in (
        "__init__", "common/__init__", "common/app", "common/auth",
        "common/serving", "common/status", "jupyter/__init__", "jupyter/app",
        "jupyter/form", "jupyter/spawner_config", "volumes/__init__",
        "volumes/app", "tensorboards/__init__", "tensorboards/app",
        "kfam/__init__", "kfam/app", "dashboard/__init__", "dashboard/app",
        "dashboard/kfam", "dashboard/metrics")} <= names
    assert {f"kubeflow_tpu_torch/testing/jsrt/{m}.py" for m in (
        "__init__", "lexer", "jsparser", "interp", "dom", "stdlib",
        "browser")} <= names
    assert {"kubeflow_tpu_torch/testing/jsweb.py",
            "kubeflow_tpu_torch/testing/rbac.py",
            "kubeflow_tpu_torch/cmd/webapp.py",
            "kubeflow_tpu_torch/cmd/devserver.py"} <= names
    web = REPO / "kubeflow_tpu_torch" / "web"
    assert {p.relative_to(web).as_posix()
            for p in web.glob("*/static/*")} == {
        "common/static/kubeflow.css", "common/static/kubeflow.js",
        *(f"{app}/static/{f}" for app in (
            "jupyter", "volumes", "tensorboards", "dashboard")
          for f in ("index.html", "app.js"))}
    # The kernels' CUDA sources, which ops/flash_attention.py builds (the
    # ring hop's partial kernel shares the forward's source; heads wider
    # than 128 columns run the wide source's four kernels).
    # The notebook's live profiler server and its capture client.
    assert {"kubeflow_tpu_torch/profiler/__init__.py",
            "kubeflow_tpu_torch/profiler/h2.py",
            "kubeflow_tpu_torch/profiler/server.py",
            "kubeflow_tpu_torch/profiler/wire.py",
            "kubeflow_tpu_torch/profiler/xspace.py",
            "kubeflow_tpu_torch/testing/profiler_client.py"} <= names
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
            "kubeflow_tpu_torch.sdk, kubeflow_tpu_torch.utils.checkpoint, "
            "kubeflow_tpu_torch.gpu, kubeflow_tpu_torch.webhooks.gpu, "
            "kubeflow_tpu_torch.probe.dcn, kubeflow_tpu_torch.probe.__main__, "
            "kubeflow_tpu_torch.testing.distributed_worker, "
            "kubeflow_tpu_torch.utils.compilecache, "
            "kubeflow_tpu_torch.controllers.notebook, "
            "kubeflow_tpu_torch.webhooks.register, "
            "kubeflow_tpu_torch.testing.fakekube, "
            "kubeflow_tpu_torch.testing.podsim, "
            "kubeflow_tpu_torch.runtime.sharding, "
            "kubeflow_tpu_torch.api.convert, kubeflow_tpu_torch.migration, "
            "kubeflow_tpu_torch.scheduler, kubeflow_tpu_torch.cmd.envconfig, "
            "kubeflow_tpu_torch.controllers.profile, "
            "kubeflow_tpu_torch.controllers.warmpool, "
            "kubeflow_tpu_torch.api.inferenceservice, "
            "kubeflow_tpu_torch.utils.fswatch, "
            "kubeflow_tpu_torch.controllers.culling, "
            "kubeflow_tpu_torch.serving.autoscaler, "
            "kubeflow_tpu_torch.serving.controller, "
            "kubeflow_tpu_torch.webhooks.inferenceservice, "
            "kubeflow_tpu_torch.api.tensorboard, "
            "kubeflow_tpu_torch.api.pvcviewer, "
            "kubeflow_tpu_torch.controllers.tensorboard, "
            "kubeflow_tpu_torch.controllers.pvcviewer, "
            "kubeflow_tpu_torch.profiler.server, "
            "kubeflow_tpu_torch.testing.profiler_client, "
            "kubeflow_tpu_torch.runtime.flowcontrol, "
            "kubeflow_tpu_torch.runtime.httpclient, "
            "kubeflow_tpu_torch.webhooks.jsonpatch, "
            "kubeflow_tpu_torch.webhooks.server, "
            "kubeflow_tpu_torch.cmd.controller_manager, "
            "kubeflow_tpu_torch.cmd.webhook, "
            "kubeflow_tpu_torch.cmd.webapp, kubeflow_tpu_torch.cmd.devserver, "
            "kubeflow_tpu_torch.web.jupyter, kubeflow_tpu_torch.web.volumes, "
            "kubeflow_tpu_torch.web.tensorboards, kubeflow_tpu_torch.web.kfam, "
            "kubeflow_tpu_torch.web.dashboard, "
            "kubeflow_tpu_torch.testing.jsweb, "
            "kubeflow_tpu_torch.testing.rbac, "
            "kubeflow_tpu_torch.testing.jsrt; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'kubeflow_tpu', 'ml_dtypes')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
