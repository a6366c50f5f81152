"""Tree-walking evaluator + standard library for the frontend JS subset.

Value mapping: JS undefined/null are singletons; numbers are Python
floats; strings/bools map natively; objects/arrays/functions are the
classes below. Host integration happens through ``JSObject`` subclasses
overriding ``js_get_prop``/``js_set_prop`` (the DOM does this) and through
``HostFunction`` wrapping Python callables.

``await`` semantics: spec-faithful suspension. Each in-flight async
function body runs on a cooperative carrier thread (``_AsyncBody``) with
a strict one-at-a-time handoff: at ``await`` the body parks, schedules
its continuation as a real promise-reaction microtask, and control
returns to the caller — so ``await`` always defers at least one
microtask turn and interleaves exactly like a browser's event loop (the
round-4 differential battery pinned the old run-to-completion model as
divergent: ``async-await-sequencing``/``settimeout-zero-after-
microtasks`` in ci/jsrt_differential/corpus.json). Only one thread ever
executes JS at a time, enforced by event handoff — there is no
concurrency, just continuations carried by parked threads.

Top-level ``await`` (outside any async function) keeps the old
synchronous drain: run microtasks (and the host's I/O pump) until the
promise settles, raising JSDeadlock for promises only a future host
event can settle.
"""

from __future__ import annotations

import json as _json
import math
import re as _re
import threading as _threading
import time as _time
from collections import deque

from kubeflow_tpu_torch.testing.jsrt.jsparser import parse


class Undefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


class Null:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "null"

    def __bool__(self):
        return False


undefined = Undefined()
null = Null()


class JSException(Exception):
    """A thrown JS value."""

    def __init__(self, value):
        self.value = value
        super().__init__(to_js_string_safe(value))


class JSDeadlock(RuntimeError):
    pass


class ReturnSignal(Exception):
    def __init__(self, value):
        self.value = value


class BreakSignal(Exception):
    pass


class ContinueSignal(Exception):
    pass


class _OptShortCircuit(Exception):
    """Raised by an optional link (?.) on a nullish base; caught by the
    enclosing optchain wrapper, which yields undefined (spec: one nullish
    base short-circuits the whole chain, not just that link)."""


class JSObject:
    class_name = "Object"

    def __init__(self, props: dict | None = None):
        self.props: dict = props or {}
        self.getters: dict = {}
        self.setters: dict = {}
        self.proto = None  # [[Prototype]] — set by Object.create

    # Host-overridable hooks. Return NOT_PRESENT to fall through.
    def js_get_prop(self, name: str, interp):
        # Walk the prototype chain with the ORIGINAL receiver as `this`
        # for accessor properties (spec OrdinaryGet): shadowing = first
        # hit wins, own keys stay own (own_keys doesn't walk).
        obj = self
        while obj is not None:
            if name in obj.getters:
                return interp.call_function(obj.getters[name], self, [])
            if name in obj.props:
                value = obj.props[name]
                return undefined if value is ACCESSOR_SLOT else value
            obj = getattr(obj, "proto", None)
        return NOT_PRESENT

    def js_set_prop(self, name: str, value, interp) -> bool:
        if name in self.setters:
            interp.call_function(self.setters[name], self, [value])
            return True
        self.props[name] = value
        return True

    def js_delete_prop(self, name: str) -> None:
        self.props.pop(name, None)
        self.getters.pop(name, None)
        self.setters.pop(name, None)

    def own_keys(self) -> list:
        # Accessor properties are enumerable own properties too (spec:
        # Object.keys lists them; for-in walks them). Object literals
        # reserve an ACCESSOR_SLOT in props at definition time so the
        # insertion order interleaves exactly as written; accessors
        # installed by other means (host code) land after.
        keys = list(self.props.keys())
        keys += [k for k in self.getters if k not in self.props]
        # OrdinaryOwnPropertyKeys: canonical array indexes first in
        # ascending NUMERIC order, then string keys in insertion order —
        # Object.keys({b:1, 2:2, 1:3}) is ["1","2","b"] in every real
        # engine ("01" is not canonical and keeps insertion order).
        def is_index(k):
            return k.isdigit() and (k == "0" or not k.startswith("0"))
        ints = sorted((k for k in keys if is_index(k)), key=int)
        return ints + [k for k in keys if not is_index(k)]


NOT_PRESENT = object()
ACCESSOR_SLOT = object()  # placeholder in props holding a getter's slot
                          # in enumeration order (js_get_prop routes the
                          # actual read through the getter)


class JSArray(JSObject):
    class_name = "Array"

    def __init__(self, items: list | None = None):
        super().__init__()
        self.items: list = items if items is not None else []

    def own_keys(self) -> list:
        return [str(i) for i in range(len(self.items))]


class JSFunction(JSObject):
    class_name = "Function"

    def __init__(self, name, params, rest, body, env, *, is_async=False,
                 is_arrow=False, is_expr_body=False, this_val=NOT_PRESENT):
        super().__init__()
        self.name = name or ""
        self.params = params
        self.rest = rest
        self.body = body
        self.env = env
        self.is_async = is_async
        self.is_arrow = is_arrow
        self.is_expr_body = is_expr_body
        self.this_val = this_val  # captured lexically for arrows


class HostFunction(JSObject):
    class_name = "Function"

    def __init__(self, fn, name=""):
        super().__init__()
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "")


class HostClass(JSObject):
    """Constructible host type: ``new X(...)`` and ``instanceof`` support."""

    class_name = "Function"

    def __init__(self, name, construct, instancecheck=None):
        super().__init__()
        self.name = name
        self.construct = construct
        self.instancecheck = instancecheck or (lambda v: False)


class RegExpObject(JSObject):
    class_name = "RegExp"

    def __init__(self, source: str, flags: str = ""):
        super().__init__()
        self.source = source
        self.flags = flags
        pyflags = 0
        if "i" in flags:
            pyflags |= _re.IGNORECASE
        if "m" in flags:
            pyflags |= _re.MULTILINE
        if "s" in flags:
            pyflags |= _re.DOTALL
        self.regex = _re.compile(_js_regex_to_py(source), pyflags)
        self.is_global = "g" in flags


def _js_regex_to_py(source: str) -> str:
    """The used subset of JS regex syntax is Python-compatible except
    ``\\d`` style classes (same), ``(?:)`` (same) — only ``\\/`` needs
    unescaping."""
    return source.replace("\\/", "/")


class Environment:
    __slots__ = ("vars", "parent", "consts")

    def __init__(self, parent=None):
        self.vars: dict = {}
        self.consts: set = set()
        self.parent = parent

    def declare(self, name: str, value, *, const=False) -> None:
        self.vars[name] = value
        if const:
            self.consts.add(name)

    def lookup(self, name: str):
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        return NOT_PRESENT

    def assign(self, name: str, value) -> bool:
        env = self
        while env is not None:
            if name in env.vars:
                if name in env.consts:
                    raise JSException(make_error("TypeError",
                                                 f"Assignment to constant {name}"))
                env.vars[name] = value
                return True
            env = env.parent
        return False


class _AsyncBody:
    """One in-flight async function call, carried by a parked thread.

    Cooperative, never concurrent: exactly one thread executes JS at any
    moment. The controller (whoever called the async function, or later
    the microtask resuming it) blocks until the body YIELDS — either by
    parking at an ``await`` or by finishing. ``await`` registers the
    continuation as a promise reaction, so resumption order is exactly
    the microtask order a browser would use."""

    def __init__(self, interp, fn, env, this):
        self.interp = interp
        self.fn, self.env, self.this = fn, env, this
        self.promise = Promise(interp)
        self._resume = _threading.Event()   # body waits; controller sets
        self._yielded = _threading.Event()  # controller waits; body sets
        self._box = None                    # ("value" | "error", payload)
        self._thread = _threading.Thread(
            target=self._run, daemon=True, name="jsrt-async-body")

    # ---- controller side ----

    def start(self) -> "Promise":
        self._thread.start()
        self._wait_for_yield()
        return self.promise

    def _wait_for_yield(self) -> None:
        self._yielded.wait()
        self._yielded.clear()

    def _deliver(self, kind, payload) -> None:
        """Runs as a promise-reaction microtask: hand the settled value
        (or rejection) into the parked body and run it to its next
        yield point."""
        self.interp.parked_async.remove(self)
        self._box = (kind, payload)
        self._resume.set()
        self._wait_for_yield()

    # ---- body side (carrier thread) ----

    def _run(self) -> None:
        tls = self.interp._async_tls
        tls.body = self
        try:
            result = self.interp._run_body(self.fn, self.env, self.this)
            self.promise.resolve(result)
        except JSException as e:
            self.promise.reject(e.value)
        except BaseException as e:  # host bug — surface, don't hang
            self.promise.reject(make_error("InternalError", repr(e)))
        finally:
            tls.body = None
            self._yielded.set()  # final yield: body is done

    def await_on(self, value):
        wrapped = Promise(self.interp)
        wrapped.resolve(value)  # non-promises settle immediately; chains
        self.interp.parked_async.append(self)
        wrapped.then_callbacks(
            lambda v: self._deliver("value", v),
            lambda e: self._deliver("error", e),
        )
        # Park: control goes back to the controller …
        self._yielded.set()
        self._resume.wait()
        self._resume.clear()
        # … and a microtask brought us back with the settled value.
        kind, payload = self._box
        self._box = None
        if kind == "error":
            raise JSException(payload)
        return payload


class Promise(JSObject):
    class_name = "Promise"
    PENDING, FULFILLED, REJECTED = 0, 1, 2

    def __init__(self, interp):
        super().__init__()
        self.interp = interp
        self.state = Promise.PENDING
        self.value = undefined
        self.callbacks: list = []  # (on_ful, on_rej, next_promise)
        self.handled = False

    def resolve(self, value) -> None:
        if self.state != Promise.PENDING:
            return
        if isinstance(value, Promise):  # chain
            value.then_callbacks(self.resolve, self.reject)
            return
        self.state = Promise.FULFILLED
        self.value = value
        self._schedule()

    def reject(self, value) -> None:
        if self.state != Promise.PENDING:
            return
        self.state = Promise.REJECTED
        self.value = value
        self._schedule()

    def then_callbacks(self, on_ful, on_rej) -> None:
        """Host-level then (Python callables)."""
        self.handled = True
        self.callbacks.append((on_ful, on_rej, None))
        if self.state != Promise.PENDING:
            self._schedule()

    def _schedule(self) -> None:
        cbs, self.callbacks = self.callbacks, []
        for on_ful, on_rej, _next in cbs:
            cb = on_ful if self.state == Promise.FULFILLED else on_rej
            value = self.value
            if cb is not None:
                self.interp.microtasks.append(lambda cb=cb, v=value: cb(v))
            elif self.state == Promise.REJECTED and _next is not None:
                self.interp.microtasks.append(
                    lambda n=_next, v=value: n.reject(v))
            elif _next is not None:
                self.interp.microtasks.append(
                    lambda n=_next, v=value: n.resolve(v))


def make_error(kind: str, message: str) -> JSObject:
    err = JSObject({"name": kind, "message": message, "stack": ""})
    err.class_name = "Error"
    return err


# ---- coercions ------------------------------------------------------------------


def is_truthy(v) -> bool:
    if v is undefined or v is null or v is False:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return not (v == 0 or math.isnan(v))
    if isinstance(v, str):
        return len(v) > 0
    return True


def to_number(v) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0.0
        try:
            return float(int(s, 16)) if s.lower().startswith("0x") else float(s)
        except ValueError:
            return math.nan
    if v is null:
        return 0.0
    if v is undefined:
        return math.nan
    if isinstance(v, JSArray):
        if not v.items:
            return 0.0
        if len(v.items) == 1:
            return to_number(v.items[0])
    return math.nan


def format_number(n: float) -> str:
    if math.isnan(n):
        return "NaN"
    if n == math.inf:
        return "Infinity"
    if n == -math.inf:
        return "-Infinity"
    if n == int(n) and abs(n) < 1e21:
        return str(int(n))
    r = repr(n)
    if "e" in r:
        # JS (Number::toString) prints positionally down to 1e-6 and
        # writes exponents without zero padding: 0.000001 not 1e-06,
        # and 1e-7 not 1e-07 below that (Python repr does both).
        if 0 < abs(n) < 1e-6 or abs(n) >= 1e21:
            mant, _, exp = r.partition("e")
            e = int(exp)
            return f"{mant}e{'+' if e >= 0 else '-'}{abs(e)}"
        from decimal import Decimal
        return format(Decimal(r), "f")
    return r


def to_js_string(v, interp=None) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return format_number(v)
    if v is undefined:
        return "undefined"
    if v is null:
        return "null"
    if isinstance(v, JSArray):
        return ",".join(
            "" if (x is undefined or x is null) else to_js_string(x, interp)
            for x in v.items)
    if isinstance(v, (JSFunction, HostFunction, HostClass)):
        return f"function {getattr(v, 'name', '')}() {{ [code] }}"
    if isinstance(v, RegExpObject):
        return f"/{v.source}/{v.flags}"
    if isinstance(v, JSObject):
        if v.class_name == "Error":
            name = v.props.get("name", "Error")
            msg = v.props.get("message", "")
            return f"{name}: {msg}" if msg else str(name)
        # toString method?
        ts = v.props.get("toString")
        if interp is not None and isinstance(ts, (JSFunction, HostFunction)):
            return to_js_string(interp.call_function(ts, v, []), interp)
        return "[object Object]"
    return str(v)


def to_js_string_safe(v) -> str:
    try:
        return to_js_string(v)
    except Exception:  # pragma: no cover
        return repr(v)


def js_to_python(v):
    """JS value → plain Python (for JSON + host bridges)."""
    if v is undefined or v is null:
        return None
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        return int(v)
    if isinstance(v, (bool, float, str, int)):
        return v
    if isinstance(v, JSArray):
        return [js_to_python(x) for x in v.items]
    if isinstance(v, JSObject):
        # own_keys order (integer indexes first) so JSON.stringify and
        # host bridges see the same enumeration a real engine produces.
        out = {}
        for k in v.own_keys():
            val = v.props.get(k, NOT_PRESENT)
            if (val is NOT_PRESENT or val is undefined
                    or val is ACCESSOR_SLOT
                    or isinstance(val, (JSFunction, HostFunction))):
                continue
            out[k] = js_to_python(val)
        return out
    return None


def python_to_js(v):
    if v is None:
        return null
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return v
    if isinstance(v, (list, tuple)):
        return JSArray([python_to_js(x) for x in v])
    if isinstance(v, dict):
        return JSObject({str(k): python_to_js(x) for k, x in v.items()})
    if isinstance(v, JSObject):
        return v
    return undefined


# ---- interpreter ----------------------------------------------------------------


class Interpreter:
    def __init__(self):
        self.global_env = Environment()
        self.microtasks: deque = deque()
        self.io_pump = None          # host hook: () -> bool (made progress?)
        self.console: list = []
        self.unhandled_rejections: list = []
        self._now = _time.time       # virtual clock hook (browser overrides)
        self._async_tls = _threading.local()  # carrier-thread → _AsyncBody
        self.parked_async: list = []  # bodies parked at an await right now
        install_stdlib(self)

    # -- program entry ----------------------------------------------------------

    def run(self, src: str, filename: str = "<js>") -> None:
        ast = parse(src, filename)
        self.exec_block(ast, self.global_env, this=undefined)
        self.run_microtasks()

    def run_microtasks(self) -> None:
        guard = 0
        while self.microtasks:
            task = self.microtasks.popleft()
            task()
            guard += 1
            if guard > 100_000:
                raise JSDeadlock("microtask loop did not quiesce")

    # -- promise await ----------------------------------------------------------

    def await_value(self, v):
        body = getattr(self._async_tls, "body", None)
        if body is not None:
            # Inside an async function: park the carrier and resume via a
            # promise-reaction microtask — ALWAYS defers at least one
            # turn, even for non-promises/settled promises (spec).
            return body.await_on(v)
        # Top-level await: synchronous drain (see module docstring).
        if not isinstance(v, Promise):
            return v
        for _ in range(10_000):
            if v.state != Promise.PENDING:
                break
            if self.microtasks:
                self.run_microtasks()
                continue
            if self.io_pump is not None and self.io_pump():
                continue
            raise JSDeadlock(
                "await on a promise that only a future host event can "
                "settle — use .then() for user-gesture promises")
        if v.state == Promise.FULFILLED:
            v.handled = True
            return v.value
        v.handled = True
        raise JSException(v.value)

    # -- function calls ---------------------------------------------------------

    def call_function(self, fn, this, args: list):
        if isinstance(fn, HostFunction):
            return fn.fn(this, args)
        if isinstance(fn, HostClass):
            return fn.construct(args)
        if not isinstance(fn, JSFunction):
            raise JSException(make_error(
                "TypeError", f"{to_js_string_safe(fn)} is not a function"))
        env = Environment(fn.env)
        self.bind_params(fn, env, args)
        use_this = fn.this_val if fn.is_arrow else this
        if fn.is_async:
            return _AsyncBody(self, fn, env, use_this).start()
        return self._run_body(fn, env, use_this)

    def _run_body(self, fn: JSFunction, env: Environment, this):
        if fn.is_expr_body:
            return self.eval(fn.body, env, this)
        try:
            self.exec_stmt(fn.body, env, this)
        except ReturnSignal as r:
            return r.value
        return undefined

    def bind_params(self, fn: JSFunction, env: Environment, args: list) -> None:
        for idx, (pat, default) in enumerate(fn.params):
            val = args[idx] if idx < len(args) else undefined
            if val is undefined and default is not None:
                val = self.eval(default, env, undefined)
            self.bind_pattern(pat, val, env, "let")
        if fn.rest is not None:
            env.declare(fn.rest, JSArray(list(args[len(fn.params):])))

    def bind_pattern(self, pat, value, env: Environment, kind: str) -> None:
        const = kind == "const"
        if pat[0] == "pid":
            env.declare(pat[1], value, const=const)
            return
        if pat[0] == "parr":
            items = list(self.iterate(value))
            for idx, elem in enumerate(pat[1]):
                if elem is None:
                    continue
                sub, default = elem
                v = items[idx] if idx < len(items) else undefined
                if v is undefined and default is not None:
                    v = self.eval(default, env, undefined)
                self.bind_pattern(sub, v, env, kind)
            if pat[2] is not None:
                self.bind_pattern(
                    pat[2], JSArray(items[len(pat[1]):]), env, kind)
            return
        if pat[0] == "pobj":
            taken = set()
            for key, sub, default in pat[1]:
                v = self.get_prop(value, key)
                taken.add(key)
                if v is undefined and default is not None:
                    v = self.eval(default, env, undefined)
                self.bind_pattern(sub, v, env, kind)
            if pat[2] is not None:
                rest_obj = JSObject()
                if isinstance(value, JSObject):
                    for k in value.own_keys():
                        if k not in taken:
                            rest_obj.props[k] = self.get_prop(value, k)
                self.bind_pattern(pat[2], rest_obj, env, kind)
            return
        raise JSException(make_error("SyntaxError", f"bad pattern {pat[0]}"))

    # -- property access --------------------------------------------------------

    def get_prop(self, obj, name: str):
        from kubeflow_tpu_torch.testing.jsrt import stdlib

        if obj is undefined or obj is null:
            raise JSException(make_error(
                "TypeError",
                f"Cannot read properties of {to_js_string_safe(obj)} "
                f"(reading '{name}')"))
        if isinstance(obj, str):
            return stdlib.string_prop(self, obj, name)
        if isinstance(obj, float):
            return stdlib.number_prop(self, obj, name)
        if isinstance(obj, bool):
            return undefined
        if isinstance(obj, JSArray):
            hit = stdlib.array_prop(self, obj, name)
            if hit is not NOT_PRESENT:
                return hit
            v = obj.js_get_prop(name, self)
            return undefined if v is NOT_PRESENT else v
        if isinstance(obj, Promise):
            hit = stdlib.promise_prop(self, obj, name)
            if hit is not NOT_PRESENT:
                return hit
        if isinstance(obj, RegExpObject):
            hit = stdlib.regex_prop(self, obj, name)
            if hit is not NOT_PRESENT:
                return hit
        if isinstance(obj, JSObject):
            v = obj.js_get_prop(name, self)
            if v is not NOT_PRESENT:
                return v
            if name == "constructor":
                return undefined
            return undefined
        return undefined

    def set_prop(self, obj, name: str, value) -> None:
        if obj is undefined or obj is null:
            raise JSException(make_error(
                "TypeError", f"Cannot set properties of {to_js_string_safe(obj)}"))
        if isinstance(obj, JSArray) and name == "length":
            n = int(to_number(value))
            del obj.items[n:]
            return
        if isinstance(obj, JSObject):
            obj.js_set_prop(name, value, self)
            return
        # Setting props on primitives: silently ignored (matches sloppy mode).

    def get_index(self, obj, key):
        if isinstance(obj, JSArray) and isinstance(key, float):
            i = int(key)
            if 0 <= i < len(obj.items):
                return obj.items[i]
            return undefined
        if isinstance(obj, str) and isinstance(key, float):
            i = int(key)
            return obj[i] if 0 <= i < len(obj) else undefined
        return self.get_prop(obj, to_js_string(key, self))

    def set_index(self, obj, key, value) -> None:
        if isinstance(obj, JSArray) and isinstance(key, float):
            i = int(key)
            while len(obj.items) <= i:
                obj.items.append(undefined)
            obj.items[i] = value
            return
        self.set_prop(obj, to_js_string(key, self), value)

    # -- iteration --------------------------------------------------------------

    def iterate(self, v):
        if isinstance(v, JSArray):
            return list(v.items)
        if isinstance(v, str):
            return list(v)
        if isinstance(v, JSObject):
            it = getattr(v, "js_iter", None)
            if it is not None:
                return list(it())
        raise JSException(make_error(
            "TypeError", f"{to_js_string_safe(v)} is not iterable"))

    # -- statements -------------------------------------------------------------

    def exec_block(self, stmts: list, env: Environment, this) -> None:
        # Function-declaration hoisting within the block.
        for stmt in stmts:
            if stmt[0] == "func_decl":
                _, name, params, rest, body, is_async = stmt
                env.declare(name, JSFunction(
                    name, params, rest, body, env, is_async=is_async))
        for stmt in stmts:
            if stmt[0] != "func_decl":
                self.exec_stmt(stmt, env, this)

    def exec_stmt(self, node, env: Environment, this) -> None:
        op = node[0]
        if op == "expr_stmt":
            self.eval(node[1], env, this)
        elif op == "var":
            _, kind, decls = node
            for pat, init in decls:
                value = undefined if init is None else self.eval(init, env, this)
                self.bind_pattern(pat, value, env, kind)
        elif op == "block":
            self.exec_block(node[1], Environment(env), this)
        elif op == "if":
            _, cond, then, other = node
            if is_truthy(self.eval(cond, env, this)):
                self.exec_stmt(then, env, this)
            elif other is not None:
                self.exec_stmt(other, env, this)
        elif op == "return":
            raise ReturnSignal(
                undefined if node[1] is None else self.eval(node[1], env, this))
        elif op == "while":
            _, cond, body = node
            while is_truthy(self.eval(cond, env, this)):
                try:
                    self.exec_stmt(body, Environment(env), this)
                except BreakSignal:
                    break
                except ContinueSignal:
                    continue
        elif op == "dowhile":
            _, body, cond = node
            while True:
                try:
                    self.exec_stmt(body, Environment(env), this)
                except BreakSignal:
                    break
                except ContinueSignal:
                    pass
                if not is_truthy(self.eval(cond, env, this)):
                    break
        elif op == "for":
            _, init, cond, update, body = node
            loop_env = Environment(env)
            if init is not None:
                self.exec_stmt(init, loop_env, this)
            # let/const loop heads get a FRESH binding per iteration
            # (CreatePerIterationEnvironment): closures made in the body
            # capture that iteration's value — `for (let i …) push(() => i)`
            # yields 0,1,2, not the final value like `var`.
            per_iter = (init is not None and init[0] == "var"
                        and init[1] in ("let", "const"))
            while True:
                if cond is not None and not is_truthy(
                        self.eval(cond, loop_env, this)):
                    break
                try:
                    self.exec_stmt(body, Environment(loop_env), this)
                except BreakSignal:
                    break
                except ContinueSignal:
                    pass
                if per_iter:
                    # Copy AFTER the body, BEFORE the update: closures
                    # made this iteration keep this iteration's values;
                    # the update mutates only the next iteration's env.
                    fresh = Environment(env)
                    fresh.vars.update(loop_env.vars)
                    fresh.consts |= loop_env.consts
                    loop_env = fresh
                if update is not None:
                    self.eval(update, loop_env, this)
        elif op == "forof":
            _, kind, pat, iterable, body = node
            for item in self.iterate(self.eval(iterable, env, this)):
                iter_env = Environment(env)
                self.bind_pattern(pat, item, iter_env, kind)
                try:
                    self.exec_stmt(body, iter_env, this)
                except BreakSignal:
                    break
                except ContinueSignal:
                    continue
        elif op == "forin":
            _, kind, pat, obj_expr, body = node
            obj = self.eval(obj_expr, env, this)
            keys = obj.own_keys() if isinstance(obj, JSObject) else []
            for key in keys:
                iter_env = Environment(env)
                self.bind_pattern(pat, key, iter_env, kind)
                try:
                    self.exec_stmt(body, iter_env, this)
                except BreakSignal:
                    break
                except ContinueSignal:
                    continue
        elif op == "try":
            _, block, param, catch_block, final = node
            # Python's finally gives exact JS ordering: the finalizer runs
            # on normal exit, on a caught/propagating throw, AND on
            # return/break/continue control-flow signals escaping the try.
            try:
                try:
                    self.exec_stmt(block, env, this)
                except JSException as e:
                    if catch_block is None:
                        raise
                    catch_env = Environment(env)
                    if param is not None:
                        self.bind_pattern(param, e.value, catch_env, "let")
                    self.exec_stmt(catch_block, catch_env, this)
            finally:
                if final is not None:
                    self.exec_stmt(final, env, this)
        elif op == "throw":
            raise JSException(self.eval(node[1], env, this))
        elif op == "break":
            raise BreakSignal()
        elif op == "continue":
            raise ContinueSignal()
        elif op == "switch":
            _, disc_expr, cases = node
            disc = self.eval(disc_expr, env, this)
            sw_env = Environment(env)
            matched = False
            try:
                for test, body in cases:
                    if not matched and test is not None and \
                            strict_equals(disc, self.eval(test, sw_env, this)):
                        matched = True
                    if matched:
                        for stmt in body:
                            self.exec_stmt(stmt, sw_env, this)
                if not matched:
                    hit_default = False
                    for test, body in cases:
                        if test is None:
                            hit_default = True
                        if hit_default:
                            for stmt in body:
                                self.exec_stmt(stmt, sw_env, this)
            except BreakSignal:
                pass
        elif op == "func_decl":
            _, name, params, rest, body, is_async = node
            env.declare(name, JSFunction(
                name, params, rest, body, env, is_async=is_async))
        elif op == "empty":
            pass
        else:
            raise JSException(make_error("SyntaxError", f"bad statement {op}"))

    # -- expressions ------------------------------------------------------------

    def eval(self, node, env: Environment, this):
        op = node[0]
        if op == "num":
            return node[1]
        if op == "str":
            return node[1]
        if op == "bool":
            return node[1]
        if op == "null":
            return null
        if op == "undef":
            return undefined
        if op == "this":
            return this
        if op == "ident":
            v = env.lookup(node[1])
            if v is NOT_PRESENT:
                raise JSException(make_error(
                    "ReferenceError", f"{node[1]} is not defined"))
            return v
        if op == "template":
            out = []
            for kind, payload in node[1]:
                if kind == "str":
                    out.append(payload)
                else:
                    out.append(to_js_string(self.eval(payload, env, this), self))
            return "".join(out)
        if op == "regex":
            return RegExpObject(node[1], node[2])
        if op == "array":
            items = []
            for elem in node[1]:
                if elem == ("hole",):
                    items.append(undefined)
                elif elem[0] == "spread":
                    items.extend(self.iterate(self.eval(elem[1], env, this)))
                else:
                    items.append(self.eval(elem, env, this))
            return JSArray(items)
        if op == "object":
            obj = JSObject()
            for prop in node[1]:
                kind = prop[0]
                if kind == "prop":
                    obj.props[prop[1]] = self.eval(prop[2], env, this)
                elif kind == "shorthand":
                    obj.props[prop[1]] = self.eval(("ident", prop[1]), env, this)
                elif kind == "method":
                    _, key, params, rest, body, is_async = prop
                    obj.props[key] = JSFunction(
                        key, params, rest, body, env, is_async=is_async)
                elif kind == "getter":
                    obj.getters[prop[1]] = JSFunction(
                        prop[1], [], None, prop[2], env)
                    # Accessor keys enumerate interleaved with data keys
                    # in DEFINITION order (Object.keys/for-in): reserve
                    # the slot now, tombstoned so reads still hit the
                    # getter via js_get_prop's precedence.
                    obj.props.setdefault(prop[1], ACCESSOR_SLOT)
                elif kind == "setter":
                    obj.setters[prop[1]] = JSFunction(
                        prop[1], [(prop[2], None)], None, prop[3], env)
                elif kind == "spread":
                    src = self.eval(prop[1], env, this)
                    if isinstance(src, JSObject):
                        for k in src.own_keys():
                            obj.props[k] = self.get_prop(src, k)
            return obj
        if op == "func":
            _, name, params, rest, body, is_async = node
            return JSFunction(name, params, rest, body, env, is_async=is_async)
        if op == "arrow":
            _, params, rest, body, is_expr, is_async = node
            return JSFunction("", params, rest, body, env, is_async=is_async,
                              is_arrow=True, is_expr_body=is_expr,
                              this_val=this)
        if op == "assign":
            return self.eval_assign(node, env, this)
        if op == "cond":
            _, c, a, b = node
            return self.eval(a if is_truthy(self.eval(c, env, this)) else b,
                             env, this)
        if op == "logic":
            _, sym, l, r = node
            lv = self.eval(l, env, this)
            if sym == "&&":
                return self.eval(r, env, this) if is_truthy(lv) else lv
            if sym == "??":
                return (self.eval(r, env, this)
                        if lv is null or lv is undefined else lv)
            return lv if is_truthy(lv) else self.eval(r, env, this)
        if op == "binop":
            _, sym, l, r = node
            return self.binop(sym, self.eval(l, env, this),
                              self.eval(r, env, this))
        if op == "unary":
            _, sym, operand = node
            if sym == "typeof":
                if operand[0] == "ident":
                    v = env.lookup(operand[1])
                    if v is NOT_PRESENT:
                        return "undefined"
                else:
                    v = self.eval(operand, env, this)
                return js_typeof(v)
            if sym == "delete":
                if operand[0] == "member":
                    obj = self.eval(operand[1], env, this)
                    if isinstance(obj, JSObject):
                        obj.js_delete_prop(operand[2])
                    return True
                if operand[0] == "index":
                    obj = self.eval(operand[1], env, this)
                    key = self.eval(operand[2], env, this)
                    if isinstance(obj, JSObject):
                        obj.js_delete_prop(to_js_string(key, self))
                    return True
                return True
            v = self.eval(operand, env, this)
            if sym == "!":
                return not is_truthy(v)
            if sym == "-":
                return -to_number(v)
            if sym == "+":
                return to_number(v)
            if sym == "~":
                return float(~_to_int32(v))
            if sym == "void":
                return undefined
        if op == "update":
            _, sym, prefix, target = node
            old = to_number(self.eval(target, env, this))
            new = old + (1 if sym == "++" else -1)
            self.assign_to(target, new, env, this)
            return new if prefix else old
        if op == "member":
            obj = self.eval(node[1], env, this)
            return self.get_prop(obj, node[2])
        if op == "index":
            obj = self.eval(node[1], env, this)
            key = self.eval(node[2], env, this)
            return self.get_index(obj, key)
        if op == "call":
            return self.eval_call(node, env, this)
        if op == "optchain":
            try:
                return self.eval(node[1], env, this)
            except _OptShortCircuit:
                return undefined
        if op == "optmember":
            obj = self.eval(node[1], env, this)
            if obj is null or obj is undefined:
                raise _OptShortCircuit()
            return self.get_prop(obj, node[2])
        if op == "optindex":
            obj = self.eval(node[1], env, this)
            if obj is null or obj is undefined:
                raise _OptShortCircuit()
            return self.get_index(obj, self.eval(node[2], env, this))
        if op == "optcall":
            return self.eval_call(node, env, this, optional=True)
        if op == "new":
            _, callee_node, arg_nodes = node
            callee = self.eval(callee_node, env, this)
            args = self.eval_args(arg_nodes, env, this)
            if isinstance(callee, HostClass):
                return callee.construct(args)
            if isinstance(callee, JSFunction):
                obj = JSObject()
                result = self.call_function(callee, obj, args)
                return result if isinstance(result, JSObject) else obj
            raise JSException(make_error(
                "TypeError", f"{to_js_string_safe(callee)} is not a constructor"))
        if op == "await":
            v = self.eval(node[1], env, this)
            return self.await_value(v)
        if op == "seq":
            result = undefined
            for e in node[1]:
                result = self.eval(e, env, this)
            return result
        if op == "spread":
            raise JSException(make_error("SyntaxError", "unexpected spread"))
        raise JSException(make_error("SyntaxError", f"bad expression {op}"))

    def eval_args(self, arg_nodes, env, this) -> list:
        args = []
        for a in arg_nodes:
            if a[0] == "spread":
                args.extend(self.iterate(self.eval(a[1], env, this)))
            else:
                args.append(self.eval(a, env, this))
        return args

    def eval_call(self, node, env, this, optional=False):
        _, callee_node, arg_nodes = node
        if callee_node[0] in ("member", "optmember"):
            obj = self.eval(callee_node[1], env, this)
            if callee_node[0] == "optmember" and (obj is null or obj is undefined):
                raise _OptShortCircuit()
            fn = self.get_prop(obj, callee_node[2])
            bind_this = obj
        elif callee_node[0] in ("index", "optindex"):
            obj = self.eval(callee_node[1], env, this)
            if callee_node[0] == "optindex" and (obj is null or obj is undefined):
                raise _OptShortCircuit()
            key = self.eval(callee_node[2], env, this)
            fn = self.get_index(obj, key)
            bind_this = obj
        else:
            fn = self.eval(callee_node, env, this)
            bind_this = undefined
        if optional and (fn is null or fn is undefined):
            raise _OptShortCircuit()
        args = self.eval_args(arg_nodes, env, this)
        return self.call_function(fn, bind_this, args)

    def eval_assign(self, node, env, this):
        _, sym, target, value_node = node
        if sym == "=":
            value = self.eval(value_node, env, this)
            self.assign_to(target, value, env, this)
            return value
        # compound: a op= b
        current = self.eval(target, env, this)
        rhs = self.eval(value_node, env, this)
        value = self.binop(sym[:-1], current, rhs)
        self.assign_to(target, value, env, this)
        return value

    def assign_to(self, target, value, env, this) -> None:
        if target[0] == "ident":
            if not env.assign(target[1], value):
                self.global_env.declare(target[1], value)  # implicit global
            return
        if target[0] == "member":
            obj = self.eval(target[1], env, this)
            self.set_prop(obj, target[2], value)
            return
        if target[0] == "index":
            obj = self.eval(target[1], env, this)
            key = self.eval(target[2], env, this)
            self.set_index(obj, key, value)
            return
        if target[0] == "array":
            # [a, b] = expr — assignment destructuring over existing names.
            items = list(self.iterate(value))
            for idx, elem in enumerate(target[1]):
                if elem == ("hole",):
                    continue
                self.assign_to(elem, items[idx] if idx < len(items)
                               else undefined, env, this)
            return
        raise JSException(make_error("SyntaxError", "invalid assignment target"))

    # -- operators --------------------------------------------------------------

    def binop(self, sym: str, l, r):
        if sym == "+":
            # ToPrimitive both sides first (spec 13.15.3): a custom
            # valueOf makes `({valueOf: () => 1}) + 1` numeric 2, while
            # objects without one still stringify ("[object Object]",
            # array join) exactly as before.
            lp = to_primitive(l, self)
            rp = to_primitive(r, self)
            if isinstance(lp, str) or isinstance(rp, str):
                return to_js_string(lp, self) + to_js_string(rp, self)
            return to_number(lp) + to_number(rp)
        if sym == "-":
            return to_number(l) - to_number(r)
        if sym == "*":
            return to_number(l) * to_number(r)
        if sym == "/":
            rn = to_number(r)
            ln = to_number(l)
            if rn == 0:
                if math.isnan(ln) or ln == 0:
                    return math.nan
                # Sign of ±Infinity follows the signs of BOTH operands
                # (x / -0 is -Infinity for positive x).
                positive = (ln > 0) == (math.copysign(1.0, rn) > 0)
                return math.inf if positive else -math.inf
            return ln / rn
        if sym == "%":
            rn = to_number(r)
            ln = to_number(l)
            if rn == 0 or math.isnan(ln) or math.isnan(rn):
                return math.nan
            return math.fmod(ln, rn)
        if sym == "===":
            return strict_equals(l, r)
        if sym == "!==":
            return not strict_equals(l, r)
        if sym == "==":
            return loose_equals(l, r, self)
        if sym == "!=":
            return not loose_equals(l, r, self)
        if sym in ("<", ">", "<=", ">="):
            if isinstance(l, str) and isinstance(r, str):
                if sym == "<":
                    return l < r
                if sym == ">":
                    return l > r
                if sym == "<=":
                    return l <= r
                return l >= r
            ln, rn = to_number(l), to_number(r)
            if math.isnan(ln) or math.isnan(rn):
                return False
            if sym == "<":
                return ln < rn
            if sym == ">":
                return ln > rn
            if sym == "<=":
                return ln <= rn
            return ln >= rn
        if sym == "&":
            return float(_to_int32(l) & _to_int32(r))
        if sym == "|":
            return float(_to_int32(l) | _to_int32(r))
        if sym == "^":
            return float(_to_int32(l) ^ _to_int32(r))
        if sym == "<<":
            return float(_to_int32(l) << (_to_int32(r) & 31))
        if sym == ">>":
            return float(_to_int32(l) >> (_to_int32(r) & 31))
        if sym == "instanceof":
            if isinstance(r, HostClass):
                return bool(r.instancecheck(l))
            raise JSException(make_error(
                "TypeError", "Right-hand side of instanceof is not callable"))
        if sym == "in":
            key = to_js_string(l, self)
            if isinstance(r, JSArray):
                return key.isdigit() and int(key) < len(r.items)
            if isinstance(r, JSObject):
                return r.js_get_prop(key, self) is not NOT_PRESENT
            return False
        if sym == "**":
            return to_number(l) ** to_number(r)
        raise JSException(make_error("SyntaxError", f"bad operator {sym}"))


def _to_int32(v) -> int:
    n = to_number(v)
    if math.isnan(n) or math.isinf(n):
        return 0
    n = int(n) & 0xFFFFFFFF
    return n - 0x100000000 if n >= 0x80000000 else n


def js_typeof(v) -> str:
    if v is undefined:
        return "undefined"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (JSFunction, HostFunction, HostClass)):
        return "function"
    return "object"  # null, objects, arrays


def strict_equals(l, r) -> bool:
    if l is undefined and r is undefined:
        return True
    if l is null and r is null:
        return True
    if isinstance(l, bool) or isinstance(r, bool):
        return isinstance(l, bool) and isinstance(r, bool) and l == r
    if isinstance(l, float) and isinstance(r, float):
        return l == r  # NaN != NaN falls out naturally
    if isinstance(l, str) and isinstance(r, str):
        return l == r
    return l is r


def to_primitive(v, interp=None, hint="default"):
    """ToPrimitive (ES2023 §7.1.1): ``valueOf`` first for the
    default/number hints, ``toString`` first for the string hint —
    JS-defined methods run through ``interp`` so a custom
    ``{valueOf: () => 1}`` coerces the way a real engine does. Falls back
    to the engine's default stringification when neither method yields a
    primitive (plain objects → "[object Object]", arrays → join)."""
    if not isinstance(v, JSObject):
        return v
    if interp is not None:
        order = (("toString", "valueOf") if hint == "string"
                 else ("valueOf", "toString"))
        for name in order:
            m = interp.get_prop(v, name)
            if isinstance(m, (JSFunction, HostFunction)):
                res = interp.call_function(m, v, [])
                if not isinstance(res, JSObject):
                    return res
    return to_js_string(v, interp)


def loose_equals(l, r, interp=None) -> bool:
    nullish_l = l is undefined or l is null
    nullish_r = r is undefined or r is null
    if nullish_l or nullish_r:
        return nullish_l and nullish_r
    if type(l) is type(r) or (isinstance(l, JSObject) and isinstance(r, JSObject)):
        return strict_equals(l, r)
    # Booleans coerce to numbers FIRST (spec steps 9-10) — so the
    # object-vs-primitive retry below sees a number, making
    # `[] == false` / `[1] == true` come out true as in real engines.
    if isinstance(l, bool):
        return loose_equals(to_number(l), r, interp)
    if isinstance(r, bool):
        return loose_equals(l, to_number(r), interp)
    if isinstance(l, float) and isinstance(r, str):
        return l == to_number(r)
    if isinstance(l, str) and isinstance(r, float):
        return to_number(l) == r
    # object vs primitive: ToPrimitive the object, then retry —
    # `[] == ""`, `[1] == 1`, and `({valueOf: () => 2}) == 2` are true in
    # every real engine (custom valueOf/toString run via ``interp``).
    if isinstance(l, JSObject) and isinstance(r, (str, float)):
        return loose_equals(to_primitive(l, interp), r, interp)
    if isinstance(r, JSObject) and isinstance(l, (str, float)):
        return loose_equals(l, to_primitive(r, interp), interp)
    return False


def install_stdlib(interp: Interpreter) -> None:
    from kubeflow_tpu_torch.testing.jsrt import stdlib

    stdlib.install(interp)


JSON = _json  # re-export for stdlib convenience
