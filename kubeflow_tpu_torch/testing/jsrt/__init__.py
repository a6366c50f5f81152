"""Vendored JavaScript runtime for executing the shipped frontend in CI
(the port's own copy of ``kubeflow_tpu/testing/jsrt``, unchanged but for
its imports).

The reference runs its Angular frontends under Karma/Jasmine + Cypress
(`crud-web-apps/jupyter/frontend/cypress/e2e/`, `*.spec.ts`). This image
ships no node/bun/quickjs — so "execute the frontend" means bringing our
own engine: a tree-walking interpreter for the ES2017 subset the
buildless SPAs use (arrow functions, async/await, template
literals, destructuring, spread, accessors — no classes/generators/
proxies, enforced by failing loudly on anything outside the subset), plus
a headless DOM, virtual timers and a fetch bridge into the real aiohttp
backends.

Semantics note: ``await`` resolves by synchronously draining the runtime's
microtask queue and I/O pump. Apps that await genuinely-future events
(a dialog button) would deadlock — ours ``.then()`` those, and the
interpreter raises a clear error rather than hanging.

Layout: lexer.py → jsparser.py (AST) → interp.py (evaluator + stdlib),
dom.py (document/elements/events), browser.py (page harness: HTML → DOM,
script loading, fetch/cookies, timers).
"""

from kubeflow_tpu_torch.testing.jsrt.browser import Browser, BrowserError  # noqa: F401
from kubeflow_tpu_torch.testing.jsrt.interp import Interpreter, JSException  # noqa: F401
