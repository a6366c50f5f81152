"""Zero-cluster dev server: every web app on the in-memory control plane.

``python -m kubeflow_tpu_torch.cmd.devserver [--port 8000]`` boots FakeKube with
the admission chain, the notebook/tensorboard/pvcviewer/profile controllers,
the kubelet simulator, and seeded demo data — then serves the dashboard at
``/`` with JWA/VWA/TWA path-prefixed like the reference's Istio routing.
The SPAs run against live reconcilers: create a notebook in the UI and the
simulated slice actually comes up (or crashes, if you ask the simulator to).

The reference needs a KinD cluster + istio + kustomize for the same loop
(components/testing/gh-actions); this is the buildless equivalent.

The port of ``kubeflow_tpu/cmd/devserver.py``: the port's controllers,
kubelet simulator and admission chain, and a demo notebook on one whole
H100 node (``nvidia-h100-80gb`` ``1x8``) where the JAX package seeds a
``v5e`` ``2x4`` slice.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os

from aiohttp import web


async def seed(kube) -> None:
    from kubeflow_tpu_torch.api import notebook as nbapi
    from kubeflow_tpu_torch.api import profile as profileapi

    user = os.environ.get("DEV_DEFAULT_USER", "dev@example.com")
    ns = user.split("@")[0].replace(".", "-").lower()
    await kube.create("Profile", profileapi.new(ns, user))
    # Let the profile controller materialize the namespace before pods land.
    await asyncio.sleep(0.2)
    await kube.create(
        "Notebook",
        nbapi.new("demo-h100", ns, accelerator="nvidia-h100-80gb",
                  topology="1x8"),
    )
    await kube.create("Notebook", nbapi.new("demo-cpu", ns))
    await kube.create(
        "PersistentVolumeClaim",
        {
            "apiVersion": "v1",
            "kind": "PersistentVolumeClaim",
            "metadata": {"name": "demo-workspace", "namespace": ns},
            "spec": {
                "accessModes": ["ReadWriteOnce"],
                "resources": {"requests": {"storage": "10Gi"}},
            },
        },
    )


async def amain(port: int) -> None:
    from kubeflow_tpu_torch.cmd.webapp import build_app
    from kubeflow_tpu_torch.controllers.culling import setup_culling_controller
    from kubeflow_tpu_torch.controllers.notebook import setup_notebook_controller
    from kubeflow_tpu_torch.controllers.profile import setup_profile_controller
    from kubeflow_tpu_torch.controllers.pvcviewer import setup_pvcviewer_controller
    from kubeflow_tpu_torch.controllers.tensorboard import setup_tensorboard_controller
    from kubeflow_tpu_torch.runtime.manager import Manager
    from kubeflow_tpu_torch.testing.fakekube import FakeKube
    from kubeflow_tpu_torch.testing.podsim import PodSimulator
    from kubeflow_tpu_torch.testing.rbac import register_sar_evaluator
    from kubeflow_tpu_torch.webhooks import register_all

    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    os.environ.setdefault("DEV_DEFAULT_USER", "dev@example.com")
    os.environ.setdefault("APP_SECURE_COOKIES", "false")  # plain http

    kube = FakeKube()
    register_all(kube)
    register_sar_evaluator(kube)
    mgr = Manager(kube)
    setup_notebook_controller(mgr)
    setup_profile_controller(mgr)
    setup_tensorboard_controller(mgr)
    setup_pvcviewer_controller(mgr)
    setup_culling_controller(mgr)
    sim = PodSimulator(kube, start_latency=1.0)
    await mgr.start()
    await sim.start()
    await seed(kube)

    app = build_app(kube, "all")
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    print(f"dev server: http://127.0.0.1:{port}/dashboard/  "
          f"(jupyter/volumes/tensorboards prefixed likewise)")
    try:
        await asyncio.Event().wait()
    finally:
        await runner.cleanup()
        await sim.stop()
        await mgr.stop()
        kube.close_watches()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args()
    asyncio.run(amain(args.port))


if __name__ == "__main__":
    main()
