"""SPA serving: static assets + index (reference: crud_backend/serving.py —
serve the bundle and set the CSRF cookie on index loads; the cookie here is
set by the CSRF middleware on any safe request)."""

from __future__ import annotations

from pathlib import Path

from aiohttp import web

COMMON_STATIC = Path(__file__).resolve().parent / "static"


def add_spa(app: web.Application, module_file: str) -> None:
    """Mount the caller's ``static/`` sibling dir: shared assets at
    /static/common, app assets at /static/app, index.html at /.
    Call as ``add_spa(app, __file__)``."""
    app_static = Path(module_file).resolve().parent / "static"

    async def index(_request: web.Request) -> web.FileResponse:
        return web.FileResponse(app_static / "index.html")

    app.router.add_get("/", index)
    app.router.add_static("/static/common", COMMON_STATIC)
    app.router.add_static("/static/app", app_static)
