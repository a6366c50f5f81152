"""Web-app entrypoint: serve one backend (or all, path-prefixed).

``WEBAPP=jupyter|volumes|tensorboards|kfam|dashboard|all`` selects what to
serve; ``all`` mounts each app under its dashboard path prefix the way the
reference's Istio routing exposes them (/jupyter/, /volumes/, ...).

The port of ``kubeflow_tpu/cmd/webapp.py``, on the port's ``HttpKube``
(the in-cluster ServiceAccount, else ``http://127.0.0.1:8001``)::

    WEBAPP=all PORT=5000 python -m kubeflow_tpu_torch.cmd.webapp
"""

from __future__ import annotations

import asyncio
import logging
import os

from aiohttp import web

from kubeflow_tpu_torch.runtime.httpclient import HttpKube
from kubeflow_tpu_torch.web.common.auth import SarAuthorizer


def build_app(kube, which: str) -> web.Application:
    from kubeflow_tpu_torch.web.dashboard import create_app as dashboard
    from kubeflow_tpu_torch.web.jupyter import create_app as jupyter
    from kubeflow_tpu_torch.web.kfam import create_app as kfam
    from kubeflow_tpu_torch.web.tensorboards import create_app as tensorboards
    from kubeflow_tpu_torch.web.volumes import create_app as volumes

    kwargs = dict(
        authorizer=SarAuthorizer(kube),
        userid_header=os.environ.get("USERID_HEADER", "kubeflow-userid"),
        userid_prefix=os.environ.get("USERID_PREFIX", ""),
        dev_default_user=os.environ.get("DEV_DEFAULT_USER"),
        csrf_protect=os.environ.get("CSRF_PROTECT", "true").lower() != "false",
        secure_cookies=(
            os.environ.get("APP_SECURE_COOKIES", "true").lower() != "false"
        ),
    )
    factories = {
        "jupyter": lambda: jupyter(
            kube, config_path=os.environ.get("SPAWNER_CONFIG"), **kwargs
        ),
        "volumes": lambda: volumes(kube, **kwargs),
        "tensorboards": lambda: tensorboards(kube, **kwargs),
        "kfam": lambda: kfam(kube, **kwargs),
        "dashboard": lambda: dashboard(kube, **kwargs),
    }
    if which in factories:
        return factories[which]()
    if which == "all":
        root = web.Application()

        async def healthz(_request):
            return web.json_response({"status": "ok"})

        root.router.add_get("/healthz", healthz)
        root.router.add_get("/readyz", healthz)
        for prefix, factory in factories.items():
            root.add_subapp(f"/{prefix}", factory())
        return root
    raise SystemExit(f"unknown WEBAPP {which!r}; options: {sorted(factories)} or all")


async def amain() -> None:
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    kube = HttpKube()
    app = build_app(kube, os.environ.get("WEBAPP", "all"))
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "0.0.0.0", int(os.environ.get("PORT", "5000")))
    await site.start()
    try:
        await asyncio.Event().wait()
    finally:
        await runner.cleanup()
        await kube.close()


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
