"""Admission webhook server entrypoint (HTTPS, AdmissionReview v1): the
port of ``kubeflow_tpu/cmd/webhook.py``.

TLS from ``TLS_CERT_FILE`` / ``TLS_KEY_FILE`` (reloaded in place when
renewed), on ``WEBHOOK_PORT`` (8443); plaintext only under
``ALLOW_INSECURE_HTTP=true``, else it refuses to start::

    TLS_CERT_FILE=tls.crt TLS_KEY_FILE=tls.key \
        python -m kubeflow_tpu_torch.cmd.webhook
"""

from __future__ import annotations

import asyncio
import logging
import os

from aiohttp import web

from kubeflow_tpu_torch.runtime.httpclient import HttpKube
from kubeflow_tpu_torch.webhooks.server import (
    create_webhook_app,
    rotate_certs,
    ssl_context,
)


async def amain() -> None:
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    kube = HttpKube()
    app = create_webhook_app(kube)
    runner = web.AppRunner(app)
    await runner.setup()
    cert = os.environ.get("TLS_CERT_FILE", "/etc/webhook/certs/tls.crt")
    key = os.environ.get("TLS_KEY_FILE", "/etc/webhook/certs/tls.key")
    if os.path.exists(cert):
        ctx = ssl_context(cert, key)
    elif os.environ.get("ALLOW_INSECURE_HTTP") == "true":
        ctx = None  # local development only
    else:
        # The apiserver only speaks HTTPS to webhooks; serving plaintext
        # here would "work" while every admission call fails its TLS
        # handshake (and failurePolicy:Fail then blocks Notebook creates
        # cluster-wide). Fail fast instead.
        raise SystemExit(
            f"TLS cert not found at {cert}; refusing to serve the admission "
            "webhook over plaintext (set ALLOW_INSECURE_HTTP=true for local dev)"
        )
    site = web.TCPSite(
        runner, "0.0.0.0", int(os.environ.get("WEBHOOK_PORT", "8443")),
        ssl_context=ctx,
    )
    await site.start()
    # cert-manager/service-ca renew the mounted certs in place; reload
    # them into the live context so admission never needs a pod restart.
    rotator = (asyncio.create_task(rotate_certs(ctx, cert, key))
               if ctx is not None else None)
    if rotator is not None:
        def _rotator_died(task):
            if task.cancelled():
                return
            # An unexpected failure must not silently end rotation — the
            # cert would quietly age out and admission would start
            # failing cluster-wide. Crash loudly; the pod restarts with
            # fresh certs and a fresh rotator.
            exc = task.exception()
            if exc is not None:
                logging.getLogger(__name__).critical(
                    "cert rotator died: %s", exc)
                raise SystemExit(1)
        rotator.add_done_callback(_rotator_died)
    try:
        await asyncio.Event().wait()
    finally:
        if rotator is not None:
            rotator.cancel()
        await runner.cleanup()
        await kube.close()


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
