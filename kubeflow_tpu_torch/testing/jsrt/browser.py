"""Browser harness: page loading, fetch bridge, cookies, virtual timers.

``Browser(http)`` takes a synchronous transport:
``http(method, path, headers, body) -> (status, reason, resp_headers, text)``
— tests adapt an aiohttp ``TestClient`` to this (testing/jsweb.py), so the
JS runs against the real backend handlers, CSRF cookies and all.

Time is virtual: ``setTimeout``/``setInterval`` park callbacks on a heap
that only ``advance(ms)`` drains — polling loops are stepped
deterministically, never slept through.
"""

from __future__ import annotations

import itertools

from kubeflow_tpu_torch.testing.jsrt import dom
from kubeflow_tpu_torch.testing.jsrt.interp import (
    HostClass,
    HostFunction,
    Interpreter,
    JSArray,
    JSException,
    JSObject,
    Promise,
    is_truthy,
    null,
    python_to_js,
    to_js_string,
    to_number,
    undefined,
)


class BrowserError(RuntimeError):
    pass


class Browser:
    def __init__(self, http, base_path: str = ""):
        self.http = http
        self.base_path = base_path.rstrip("/")
        self.interp = Interpreter()
        self.interp.io_pump = lambda: False
        self.clock_ms = 1_700_000_000_000.0
        self.interp._now = lambda: self.clock_ms / 1000.0
        self.cookies: dict[str, str] = {}
        self.timers: list[dict] = []
        self._timer_ids = itertools.count(1)
        self.local_storage: dict[str, str] = {}
        self.window_listeners: dict[str, list] = {}
        self.location_path = "/"
        self.location_hash = ""
        self.document = dom.Document(self)
        self.blobs: list = []
        self._install_globals()

    # ---- unhandled rejections --------------------------------------------------

    def observe_rejection(self, value) -> None:
        """Attach a last-resort rejection observer to a promise returned by
        an event/timer callback: if nothing else handles it, it lands in
        ``interp.unhandled_rejections`` and the next harness step raises."""
        if not isinstance(value, Promise):
            return

        def record(reason):
            if not value.handled:
                self.interp.unhandled_rejections.append(reason)
        value.callbacks.append((None, record, None))
        if value.state == Promise.REJECTED:
            value._schedule()

    def check_rejections(self) -> None:
        pending = self.interp.unhandled_rejections
        if pending:
            self.interp.unhandled_rejections = []
            from kubeflow_tpu_torch.testing.jsrt.interp import to_js_string_safe

            raise BrowserError(
                "unhandled promise rejection(s) in event/timer callbacks: "
                + "; ".join(to_js_string_safe(r) for r in pending))

    # ---- cookies ---------------------------------------------------------------

    def cookie_string(self) -> str:
        return "; ".join(f"{k}={v}" for k, v in self.cookies.items())

    def set_cookie_string(self, s: str) -> None:
        parts = s.split(";")
        first = parts[0]
        if "=" not in first:
            return
        k, _, v = first.partition("=")
        k = k.strip()
        # Deletion semantics: Max-Age<=0 or an already-past expires removes
        # the cookie (the logout path) instead of storing an empty value.
        for attr in parts[1:]:
            akey, _, aval = attr.strip().partition("=")
            if akey.lower() == "max-age" and aval.strip().lstrip("-").isdigit() \
                    and int(aval) <= 0:
                self.cookies.pop(k, None)
                return
            if akey.lower() == "expires" and ("1970" in aval or "1969" in aval):
                self.cookies.pop(k, None)
                return
        self.cookies[k] = v.strip()

    def _absorb_set_cookie(self, resp_headers) -> None:
        for key, value in resp_headers:
            if key.lower() == "set-cookie":
                self.set_cookie_string(value)

    # ---- page loading ----------------------------------------------------------

    def load(self, path: str = "/") -> None:
        """GET the page, build the DOM, then fetch+run its scripts in
        order — the same sequence a real browser performs."""
        status, reason, headers, text = self._request("GET", path, {}, None)
        if status != 200:
            raise BrowserError(f"page load {path} -> {status} {reason}")
        scripts, inline = dom.build_dom(self.document, text)
        for src in scripts:
            s_status, s_reason, _, js_src = self._request("GET", src, {}, None)
            if s_status != 200:
                raise BrowserError(f"script {src} -> {s_status} {s_reason}")
            self.interp.run(js_src, filename=src)
        for js_src in inline:
            self.interp.run(js_src, filename=f"{path}#inline")
        self.interp.run_microtasks()

    def _request(self, method, path, headers, body):
        if not path.startswith("/"):
            path = "/" + path
        send_headers = dict(headers)
        if self.cookies:
            send_headers["Cookie"] = self.cookie_string()
        status, reason, resp_headers, text = self.http(
            method, self.base_path + path, send_headers, body)
        self._absorb_set_cookie(resp_headers)
        return status, reason, resp_headers, text

    # ---- timers ----------------------------------------------------------------

    def advance(self, ms: float) -> int:
        """Advance the virtual clock, firing due timers in order. Returns
        the number of callbacks fired."""
        deadline = self.clock_ms + ms
        fired = 0
        while True:
            due = [t for t in self.timers if t["due"] <= deadline]
            if not due:
                break
            t = min(due, key=lambda x: (x["due"], x["id"]))
            self.clock_ms = max(self.clock_ms, t["due"])
            if t["interval"] is None:
                self.timers.remove(t)
            else:
                t["due"] += t["interval"]
            result = self.interp.call_function(
                t["fn"], undefined, list(t["args"]))
            self.observe_rejection(result)
            self.interp.run_microtasks()
            fired += 1
            if fired > 10_000:
                raise BrowserError("timer storm: >10k callbacks in one advance")
        self.clock_ms = deadline
        self.check_rejections()
        return fired

    # ---- test-facing conveniences ----------------------------------------------

    def query(self, selector: str):
        hits = dom.select(self.document, selector)
        return hits[0] if hits else None

    def query_all(self, selector: str) -> list:
        return dom.select(self.document, selector)

    def text(self, selector: str) -> str:
        el = self.query(selector)
        if el is None:
            raise BrowserError(f"no element matches {selector!r}")
        return el.text_content()

    def click(self, target) -> bool:
        el = self.query(target) if isinstance(target, str) else target
        if el is None:
            raise BrowserError(f"no element matches {target!r}")
        result = dom.activate(self.document, el)
        self.check_rejections()
        return result

    def focus(self, target) -> None:
        el = self.query(target) if isinstance(target, str) else target
        if el is None:
            raise BrowserError(f"no element matches {target!r}")
        self.document._active_element = el

    def set_value(self, selector: str, value: str, *, fire="input") -> None:
        el = self.query(selector)
        if el is None:
            raise BrowserError(f"no element matches {selector!r}")
        el._value = value
        if fire:
            self.document.dispatch(el, dom.Event(fire))

    def change(self, selector: str, value: str | None = None) -> None:
        el = self.query(selector)
        if el is None:
            raise BrowserError(f"no element matches {selector!r}")
        if value is not None:
            el._value = value
        self.document.dispatch(el, dom.Event("change"))

    def submit(self, selector: str) -> bool:
        el = self.query(selector)
        if el is None:
            raise BrowserError(f"no element matches {selector!r}")
        result = self.document.dispatch(el, dom.Event("submit"))
        self.check_rejections()
        return result

    def keydown(self, key: str, selector=None, shift: bool = False) -> None:
        target = self.document.body
        if selector is not None:
            target = (self.query(selector) if isinstance(selector, str)
                      else selector)
            if target is None:
                raise BrowserError(f"no element matches {selector!r}")
        self.document.dispatch(
            target, dom.Event("keydown", {"key": key, "shiftKey": shift}))

    def eval(self, src: str):
        """Evaluate a JS expression/program for assertions; returns the
        value of a trailing expression statement if any."""
        from kubeflow_tpu_torch.testing.jsrt.jsparser import parse

        ast = parse(src, "<eval>")
        result = undefined
        env = self.interp.global_env
        for stmt in ast:
            if stmt[0] == "expr_stmt":
                result = self.interp.eval(stmt[1], env, undefined)
            else:
                self.interp.exec_stmt(stmt, env, undefined)
        self.interp.run_microtasks()
        return result

    def fire_window(self, etype: str, props: dict | None = None) -> None:
        event = dom.Event(etype, props or {})
        for listener in list(self.window_listeners.get(etype, [])):
            self.observe_rejection(
                self.interp.call_function(listener, undefined, [event]))
        self.interp.run_microtasks()

    def fire_storage(self, key: str, new_value: str) -> None:
        """Cross-window localStorage change (iframe namespace sync)."""
        self.local_storage[key] = new_value
        self.fire_window("storage", {"key": key, "newValue": new_value})

    # ---- globals ---------------------------------------------------------------

    def _install_globals(self) -> None:
        interp = self.interp
        g = interp.global_env
        g.declare("document", self.document)

        # Node for `instanceof Node`.
        g.declare("Node", HostClass(
            "Node", lambda args: _raise(interp, "Node is not constructible"),
            lambda v: isinstance(v, dom.DomNode)))
        g.declare("Event", HostClass(
            "Event",
            lambda args: dom.Event(to_js_string(args[0], interp)),
            lambda v: isinstance(v, dom.Event)))

        # window — addEventListener + a handful of mirrors.
        window = JSObject()

        def window_add_listener(this, args):
            etype = to_js_string(args[0], interp)
            self.window_listeners.setdefault(etype, []).append(args[1])
            return undefined
        window.props["addEventListener"] = HostFunction(
            window_add_listener, "addEventListener")

        def window_remove_listener(this, args):
            etype = to_js_string(args[0], interp)
            listeners = self.window_listeners.get(etype, [])
            if args[1] in listeners:
                listeners.remove(args[1])
            return undefined
        window.props["removeEventListener"] = HostFunction(
            window_remove_listener, "removeEventListener")
        g.declare("window", window)

        # location + history
        browser = self

        class Location(JSObject):
            def js_get_prop(self, name, itp):
                if name == "hash":
                    return browser.location_hash
                if name == "pathname":
                    return browser.location_path
                if name == "href":
                    return browser.location_path + browser.location_hash
                return super().js_get_prop(name, itp)

            def js_set_prop(self, name, value, itp):
                if name == "hash":
                    new = to_js_string(value, itp)
                    if new and not new.startswith("#"):
                        new = "#" + new
                    changed = new != browser.location_hash
                    browser.location_hash = new
                    if changed:
                        browser.fire_window("hashchange")
                    return True
                return super().js_set_prop(name, value, itp)
        location = Location()
        g.declare("location", location)
        window.props["location"] = location

        history = JSObject()

        def replace_state(this, args):
            url = to_js_string(args[2], interp) if len(args) > 2 else ""
            if url.startswith("#"):
                self.location_hash = url
            elif url:
                self.location_path = url.split("#")[0]
                self.location_hash = ("#" + url.split("#", 1)[1]) \
                    if "#" in url else ""
            return undefined
        history.props["replaceState"] = HostFunction(replace_state,
                                                     "replaceState")
        history.props["pushState"] = HostFunction(replace_state, "pushState")
        g.declare("history", history)

        # localStorage
        storage = JSObject()
        storage.props["getItem"] = HostFunction(
            lambda this, args: self.local_storage.get(
                to_js_string(args[0], interp), null), "getItem")
        storage.props["setItem"] = HostFunction(
            lambda this, args: (self.local_storage.__setitem__(
                to_js_string(args[0], interp), to_js_string(args[1], interp)),
                undefined)[1], "setItem")
        storage.props["removeItem"] = HostFunction(
            lambda this, args: (self.local_storage.pop(
                to_js_string(args[0], interp), None), undefined)[1],
            "removeItem")
        g.declare("localStorage", storage)

        # timers
        def set_timer(interval: bool):
            def impl(this, args):
                fn = args[0]
                delay = to_number(args[1]) if len(args) > 1 else 0.0
                tid = float(next(self._timer_ids))
                self.timers.append({
                    "id": tid, "fn": fn, "due": self.clock_ms + delay,
                    "interval": delay if interval else None,
                    "args": list(args[2:]),
                })
                return tid
            return impl
        g.declare("setTimeout", HostFunction(set_timer(False), "setTimeout"))
        g.declare("setInterval", HostFunction(set_timer(True), "setInterval"))

        def clear_timer(this, args):
            if args and isinstance(args[0], float):
                self.timers = [t for t in self.timers if t["id"] != args[0]]
            return undefined
        g.declare("clearTimeout", HostFunction(clear_timer, "clearTimeout"))
        g.declare("clearInterval", HostFunction(clear_timer, "clearInterval"))

        # fetch
        def fetch(this, args):
            path = to_js_string(args[0], interp)
            options = args[1] if len(args) > 1 and \
                isinstance(args[1], JSObject) else JSObject()
            method = to_js_string(
                options.props.get("method", "GET"), interp).upper()
            headers = {}
            h = options.props.get("headers")
            if isinstance(h, JSObject):
                for k in h.own_keys():
                    # get_prop, not a raw props read: a getter-defined
                    # header must invoke the getter (and accessor slots
                    # never leak their placeholder).
                    headers[k] = to_js_string(interp.get_prop(h, k), interp)
            body = options.props.get("body")
            body_bytes = to_js_string(body, interp).encode() \
                if body is not None and body is not undefined else None
            promise = Promise(interp)
            try:
                status, reason, resp_headers, text = self._request(
                    method, path, headers, body_bytes)
            except Exception as e:  # network-level failure → rejected promise
                from kubeflow_tpu_torch.testing.jsrt.interp import make_error

                promise.reject(make_error("TypeError", f"fetch failed: {e}"))
                return promise
            promise.resolve(_response_object(interp, status, reason, text))
            return promise
        g.declare("fetch", HostFunction(fetch, "fetch"))

        # FormData
        def formdata_construct(args):
            form = args[0] if args else None
            data: list[tuple[str, str]] = []
            if isinstance(form, dom.Element):
                for el in form.walk():
                    if not isinstance(el, dom.Element):
                        continue
                    name = el.attrs.get("name")
                    if not name or el.disabled:
                        continue
                    if el.tag == "input":
                        itype = el.attrs.get("type", "text")
                        if itype in ("checkbox", "radio"):
                            checked = el._checked if el._checked is not None \
                                else ("checked" in el.attrs)
                            if checked:
                                data.append((name, el.get_value() or "on"))
                        else:
                            data.append((name, el.get_value()))
                    elif el.tag in ("select", "textarea"):
                        data.append((name, el.get_value()))
            fd = JSObject()
            fd.class_name = "FormData"

            def get(this, a):
                want = to_js_string(a[0], interp)
                for k, v in data:
                    if k == want:
                        return v
                return null

            def get_all(this, a):
                want = to_js_string(a[0], interp)
                return JSArray([v for k, v in data if k == want])
            fd.props["get"] = HostFunction(get, "get")
            fd.props["getAll"] = HostFunction(get_all, "getAll")
            fd.props["has"] = HostFunction(
                lambda this, a: any(
                    k == to_js_string(a[0], interp) for k, _ in data), "has")
            return fd
        g.declare("FormData", HostClass("FormData", formdata_construct))

        # Blob + URL
        def blob_construct(args):
            parts = args[0] if args else JSArray([])
            blob = JSObject()
            blob.class_name = "Blob"
            content = "".join(
                to_js_string(p, interp) for p in
                (parts.items if isinstance(parts, JSArray) else []))
            blob.props["size"] = float(len(content))
            blob.host_content = content
            self.blobs.append(blob)
            return blob
        g.declare("Blob", HostClass(
            "Blob", blob_construct,
            lambda v: isinstance(v, JSObject) and v.class_name == "Blob"))

        url_ns = JSObject()
        url_ns.props["createObjectURL"] = HostFunction(
            lambda this, args: f"blob:mock-{len(self.blobs)}",
            "createObjectURL")
        url_ns.props["revokeObjectURL"] = HostFunction(
            lambda this, args: undefined, "revokeObjectURL")
        g.declare("URL", url_ns)

        g.declare("alert", HostFunction(
            lambda this, args: undefined, "alert"))
        g.declare("requestAnimationFrame", HostFunction(
            lambda this, args: (interp.call_function(
                args[0], undefined, [self.clock_ms]), 0.0)[1],
            "requestAnimationFrame"))
        g.declare("navigator", python_to_js({"userAgent": "jsrt/1.0"}))


def _response_object(interp, status, reason, text) -> JSObject:
    resp = JSObject()
    resp.class_name = "Response"
    resp.props["ok"] = 200 <= status < 300
    resp.props["status"] = float(status)
    resp.props["statusText"] = reason or ""

    def json_method(this, args):
        import json as _json

        p = Promise(interp)
        try:
            p.resolve(python_to_js(_json.loads(text or "")))
        except ValueError as e:
            from kubeflow_tpu_torch.testing.jsrt.interp import make_error

            p.reject(make_error("SyntaxError", f"invalid JSON: {e}"))
        return p
    resp.props["json"] = HostFunction(json_method, "json")

    def text_method(this, args):
        p = Promise(interp)
        p.resolve(text or "")
        return p
    resp.props["text"] = HostFunction(text_method, "text")
    return resp


def _raise(interp, msg):
    from kubeflow_tpu_torch.testing.jsrt.interp import make_error

    raise JSException(make_error("TypeError", msg))
