"""Standard library for the vendored JS runtime: global objects (Object,
Array, JSON, Math, Date, Promise, console, …) and the per-type method
tables (string/array/number/promise/regex)."""

from __future__ import annotations

import datetime as _dt
import json as _json
import math
import urllib.parse as _url

from kubeflow_tpu_torch.testing.jsrt.interp import (
    NOT_PRESENT,
    HostClass,
    HostFunction,
    Interpreter,
    JSArray,
    JSException,
    JSFunction,
    JSObject,
    Promise,
    RegExpObject,
    format_number,
    is_truthy,
    js_to_python,
    js_typeof,
    make_error,
    null,
    python_to_js,
    strict_equals,
    to_js_string,
    to_number,
    undefined,
)


def host(name=""):
    def wrap(fn):
        return HostFunction(fn, name or fn.__name__)
    return wrap


def _call(interp, fn, this, args):
    return interp.call_function(fn, this, list(args))


# ---- string methods --------------------------------------------------------------


def string_prop(interp: Interpreter, s: str, name: str):
    if name == "length":
        return float(len(s))

    def method(fn):
        return HostFunction(lambda this, args, f=fn: f(args), name)

    if name == "slice":
        return method(lambda a: _slice_str(s, a))
    if name == "substring":
        return method(lambda a: _substring(s, a))
    if name == "split":
        return method(lambda a: _split(s, a))
    if name == "toUpperCase":
        return method(lambda a: s.upper())
    if name == "toLowerCase":
        return method(lambda a: s.lower())
    if name == "trim":
        return method(lambda a: s.strip())
    if name == "startsWith":
        return method(lambda a: s.startswith(to_js_string(a[0], interp)))
    if name == "endsWith":
        return method(lambda a: s.endswith(to_js_string(a[0], interp)))
    if name == "includes":
        return method(lambda a: to_js_string(a[0], interp) in s)
    if name == "indexOf":
        return method(lambda a: float(s.find(to_js_string(a[0], interp))))
    if name == "lastIndexOf":
        return method(lambda a: float(s.rfind(to_js_string(a[0], interp))))
    if name == "charAt":
        return method(lambda a: s[int(to_number(a[0]))] if a and
                      0 <= int(to_number(a[0])) < len(s) else "")
    if name == "at":
        def str_at(a):
            i = int(to_number(a[0])) if a and a[0] is not undefined else 0
            if i < 0:
                i += len(s)
            return s[i] if 0 <= i < len(s) else undefined
        return method(str_at)
    if name == "charCodeAt":
        def char_code_at(a):
            i = _to_index(a[0], len(s)) if a and a[0] is not undefined else 0
            return float(ord(s[i])) if 0 <= i < len(s) else math.nan
        return method(char_code_at)
    if name == "repeat":
        return method(lambda a: s * int(to_number(a[0])))
    if name == "padStart":
        return method(lambda a: s.rjust(
            int(to_number(a[0])),
            to_js_string(a[1], interp) if len(a) > 1 else " "))
    if name == "padEnd":
        return method(lambda a: s.ljust(
            int(to_number(a[0])),
            to_js_string(a[1], interp) if len(a) > 1 else " "))
    if name == "localeCompare":
        return method(lambda a: float(
            (s > to_js_string(a[0], interp)) - (s < to_js_string(a[0], interp))))
    if name == "match":
        return method(lambda a: _match(s, a[0]))
    if name == "replace":
        return method(lambda a: _replace(interp, s, a))
    if name == "replaceAll":
        return method(lambda a: s.replace(
            to_js_string(a[0], interp), to_js_string(a[1], interp)))
    if name == "concat":
        return method(lambda a: s + "".join(to_js_string(x, interp) for x in a))
    if name == "toString":
        return method(lambda a: s)
    return undefined


def _to_index(v, length: int) -> int:
    """JS ToInteger for index args: NaN→0, ±Infinity clamps, else trunc."""
    n = to_number(v)
    if math.isnan(n):
        return 0
    if n == math.inf:
        return length
    if n == -math.inf:
        return -length
    return int(n)


def _slice_str(s: str, args):
    def idx(i, default):
        if i >= len(args) or args[i] is undefined:
            return default
        return _to_index(args[i], len(s))
    start, end = idx(0, 0), idx(1, len(s))
    return s[slice(*_norm_range(len(s), start, end))]


def _substring(s: str, args):
    def idx(i, default):
        if i >= len(args) or args[i] is undefined:
            return default
        return max(0, _to_index(args[i], len(s)))
    a = idx(0, 0)
    b = idx(1, len(s))
    a, b = min(a, len(s)), min(b, len(s))
    if a > b:
        a, b = b, a
    return s[a:b]


def _norm_range(n: int, start: int, end: int):
    if start < 0:
        start = max(0, n + start)
    if end < 0:
        end = max(0, n + end)
    return start, end


def _split(s: str, args):
    if not args or args[0] is undefined:
        return JSArray([s])
    sep = args[0]
    if isinstance(sep, RegExpObject):
        parts = sep.regex.split(s)
    else:
        sep = to_js_string(sep)
        parts = list(s) if sep == "" else s.split(sep)
    # Spec: the limit TRUNCATES the result (it is not Python's maxsplit —
    # 'a,b,c'.split(',', 2) is ['a','b'], never ['a','b,c']).
    if len(args) > 1 and args[1] is not undefined:
        parts = parts[:int(to_number(args[1]))]
    return JSArray(parts)


def _match(s: str, pattern):
    if isinstance(pattern, str):
        pattern = RegExpObject(pattern)
    if not isinstance(pattern, RegExpObject):
        return null
    if pattern.is_global:
        # finditer + group(0): findall would hand back capture groups, not
        # full matches, whenever the pattern has groups.
        found = [m.group(0) for m in pattern.regex.finditer(s)]
        return JSArray(found) if found else null
    m = pattern.regex.search(s)
    if not m:
        return null
    groups = JSArray([m.group(0)] + [
        g if g is not None else undefined for g in m.groups()])
    groups.props["index"] = float(m.start())
    groups.props["input"] = s
    return groups


def _replace(interp, s: str, args):
    pattern, repl = args[0], args[1]
    def do_repl(m):
        if isinstance(repl, (JSFunction, HostFunction)):
            call_args = [m.group(0)] + [
                g if g is not None else undefined for g in m.groups()]
            return to_js_string(
                interp.call_function(repl, undefined, call_args), interp)
        out = to_js_string(repl, interp)
        result = []
        i = 0
        while i < len(out):
            if out[i] == "$" and i + 1 < len(out):
                nxt = out[i + 1]
                if nxt.isdigit():
                    result.append(m.group(int(nxt)) or "")
                    i += 2
                    continue
                if nxt == "&":
                    result.append(m.group(0))
                    i += 2
                    continue
            result.append(out[i])
            i += 1
        return "".join(result)

    if isinstance(pattern, RegExpObject):
        return pattern.regex.sub(do_repl, s,
                                 count=0 if pattern.is_global else 1)
    target = to_js_string(pattern, interp)
    if isinstance(repl, (JSFunction, HostFunction)):
        idx = s.find(target)
        if idx < 0:
            return s
        replaced = to_js_string(
            interp.call_function(repl, undefined, [target]), interp)
        return s[:idx] + replaced + s[idx + len(target):]
    return s.replace(target, to_js_string(repl, interp), 1)


# ---- number methods --------------------------------------------------------------


def _num_to_radix(n: float, radix: int) -> str:
    """Number::toString(radix) — integer part exact, fraction to 20
    digits (the SPAs only format integers; hex ids, base-36 slugs)."""
    if math.isnan(n):
        return "NaN"
    if math.isinf(n):
        return "Infinity" if n > 0 else "-Infinity"
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    neg, n = n < 0, abs(n)
    i, out = int(n), ""
    while True:
        out = digits[i % radix] + out
        i //= radix
        if i == 0:
            break
    frac = n - int(n)
    if frac:
        out += "."
        for _ in range(20):
            frac *= radix
            d = int(frac)
            out += digits[d]
            frac -= d
            if not frac:
                break
    return ("-" if neg else "") + out


def number_prop(interp: Interpreter, n: float, name: str):
    if name == "toFixed":
        return HostFunction(
            lambda this, args: f"{n:.{int(to_number(args[0])) if args else 0}f}",
            "toFixed")
    if name == "toString":
        def num_to_string(this, args):
            if args and args[0] is not undefined:
                radix = int(to_number(args[0]))
                if radix != 10:
                    return _num_to_radix(n, radix)
            return format_number(n)
        return HostFunction(num_to_string, "toString")
    return undefined


# ---- array methods ---------------------------------------------------------------


def array_prop(interp: Interpreter, arr: JSArray, name: str):
    items = arr.items

    def method(fn):
        return HostFunction(lambda this, args, f=fn: f(args), name)

    if name == "length":
        return float(len(items))
    if name == "push":
        return method(lambda a: (items.extend(a), float(len(items)))[1])
    if name == "pop":
        return method(lambda a: items.pop() if items else undefined)
    if name == "at":
        def arr_at(a):
            i = int(to_number(a[0])) if a and a[0] is not undefined else 0
            if i < 0:
                i += len(items)
            return items[i] if 0 <= i < len(items) else undefined
        return method(arr_at)
    if name == "shift":
        return method(lambda a: items.pop(0) if items else undefined)
    if name == "unshift":
        return method(lambda a: (items.__setitem__(slice(0, 0), list(a)),
                                 float(len(items)))[1])
    if name == "slice":
        return method(lambda a: JSArray(items[slice(*_norm_range(
            len(items),
            int(to_number(a[0])) if a else 0,
            int(to_number(a[1])) if len(a) > 1 and a[1] is not undefined
            else len(items)))]))
    if name == "splice":
        def splice(a):
            start = int(to_number(a[0])) if a else 0
            if start < 0:
                start = max(0, len(items) + start)
            count = int(to_number(a[1])) if len(a) > 1 else len(items) - start
            removed = items[start:start + count]
            items[start:start + count] = list(a[2:])
            return JSArray(removed)
        return method(splice)
    if name == "concat":
        def concat(a):
            out = list(items)
            for x in a:
                if isinstance(x, JSArray):
                    out.extend(x.items)
                else:
                    out.append(x)
            return JSArray(out)
        return method(concat)
    if name == "join":
        return method(lambda a: (
            to_js_string(a[0], interp) if a else ",").join(
            "" if (x is undefined or x is null) else to_js_string(x, interp)
            for x in items))
    if name == "indexOf":
        def index_of(a):
            for i, x in enumerate(items):
                if strict_equals(x, a[0]):
                    return float(i)
            return -1.0
        return method(index_of)
    if name == "includes":
        return method(lambda a: any(strict_equals(x, a[0]) for x in items))
    if name == "map":
        return method(lambda a: JSArray([
            _call(interp, a[0], undefined, [x, float(i), arr])
            for i, x in enumerate(list(items))]))
    if name == "filter":
        return method(lambda a: JSArray([
            x for i, x in enumerate(list(items))
            if is_truthy(_call(interp, a[0], undefined, [x, float(i), arr]))]))
    if name == "forEach":
        def for_each(a):
            for i, x in enumerate(list(items)):
                _call(interp, a[0], undefined, [x, float(i), arr])
            return undefined
        return method(for_each)
    if name == "find":
        def find(a):
            for i, x in enumerate(list(items)):
                if is_truthy(_call(interp, a[0], undefined, [x, float(i), arr])):
                    return x
            return undefined
        return method(find)
    if name == "findIndex":
        def find_index(a):
            for i, x in enumerate(list(items)):
                if is_truthy(_call(interp, a[0], undefined, [x, float(i), arr])):
                    return float(i)
            return -1.0
        return method(find_index)
    if name == "some":
        return method(lambda a: any(
            is_truthy(_call(interp, a[0], undefined, [x, float(i), arr]))
            for i, x in enumerate(list(items))))
    if name == "every":
        return method(lambda a: all(
            is_truthy(_call(interp, a[0], undefined, [x, float(i), arr]))
            for i, x in enumerate(list(items))))
    if name == "sort":
        def sort(a):
            import functools
            if a and a[0] is not undefined:
                cmp = a[0]
                items.sort(key=functools.cmp_to_key(
                    lambda x, y: _cmp_result(
                        _call(interp, cmp, undefined, [x, y]))))
            else:
                items.sort(key=lambda x: to_js_string(x, interp))
            return arr
        return method(sort)
    if name == "reverse":
        return method(lambda a: (items.reverse(), arr)[1])
    if name == "reduce":
        def reduce(a):
            fn = a[0]
            acc_given = len(a) > 1
            acc = a[1] if acc_given else None
            seq = list(items)
            start = 0
            if not acc_given:
                if not seq:
                    raise JSException(make_error(
                        "TypeError", "Reduce of empty array with no initial value"))
                acc = seq[0]
                start = 1
            for i in range(start, len(seq)):
                acc = _call(interp, fn, undefined, [acc, seq[i], float(i), arr])
            return acc
        return method(reduce)
    if name == "flat":
        def flat(a):
            depth = to_number(a[0]) if a else 1.0
            def go(xs, d):
                out = []
                for x in xs:
                    if isinstance(x, JSArray) and d > 0:
                        out.extend(go(x.items, d - 1))
                    else:
                        out.append(x)
                return out
            return JSArray(go(items, depth))
        return method(flat)
    if name == "flatMap":
        def flat_map(a):
            out = []
            for i, x in enumerate(list(items)):
                r = _call(interp, a[0], undefined, [x, float(i), arr])
                if isinstance(r, JSArray):
                    out.extend(r.items)
                else:
                    out.append(r)
            return JSArray(out)
        return method(flat_map)
    if name == "keys":
        return method(lambda a: JSArray([float(i) for i in range(len(items))]))
    if name == "entries":
        return method(lambda a: JSArray(
            [JSArray([float(i), x]) for i, x in enumerate(items)]))
    if name == "toString":
        return method(lambda a: to_js_string(arr, interp))
    return NOT_PRESENT


def _cmp_result(v) -> int:
    n = to_number(v)
    if math.isnan(n):
        return 0
    return (n > 0) - (n < 0)


# ---- promise methods -------------------------------------------------------------


def promise_prop(interp: Interpreter, p: Promise, name: str):
    if name == "then":
        def then(this, args):
            on_ful = args[0] if args and args[0] is not undefined else None
            on_rej = args[1] if len(args) > 1 and args[1] is not undefined \
                else None
            return _chain(interp, p, on_ful, on_rej)
        return HostFunction(then, "then")
    if name == "catch":
        def catch(this, args):
            return _chain(interp, p, None, args[0] if args else None)
        return HostFunction(catch, "catch")
    if name == "finally":
        def fin(this, args):
            cb = args[0] if args else None

            def on_ful(v):
                if cb is not None:
                    _call(interp, cb, undefined, [])
                return v

            def on_rej(v):
                if cb is not None:
                    _call(interp, cb, undefined, [])
                raise JSException(v)
            return _chain_host(interp, p, on_ful, on_rej)
        return HostFunction(fin, "finally")
    return NOT_PRESENT


def _chain(interp: Interpreter, p: Promise, on_ful, on_rej) -> Promise:
    def ful(v):
        if on_ful is None:
            return v
        return _call(interp, on_ful, undefined, [v])

    def rej(v):
        if on_rej is None:
            raise JSException(v)
        return _call(interp, on_rej, undefined, [v])
    return _chain_host(interp, p, ful, rej)


def _chain_host(interp: Interpreter, p: Promise, ful, rej) -> Promise:
    nxt = Promise(interp)

    def on_fulfilled(v):
        try:
            nxt.resolve(ful(v))
        except JSException as e:
            nxt.reject(e.value)

    def on_rejected(v):
        try:
            nxt.resolve(rej(v))
        except JSException as e:
            nxt.reject(e.value)
    p.then_callbacks(on_fulfilled, on_rejected)
    return nxt


# ---- regex methods ---------------------------------------------------------------


def regex_prop(interp: Interpreter, r: RegExpObject, name: str):
    if name == "test":
        return HostFunction(
            lambda this, args: r.regex.search(
                to_js_string(args[0], interp)) is not None, "test")
    if name == "exec":
        return HostFunction(
            lambda this, args: _match(to_js_string(args[0], interp), r), "exec")
    if name == "source":
        return r.source
    return NOT_PRESENT


# ---- globals ---------------------------------------------------------------------


def install(interp: Interpreter) -> None:
    g = interp.global_env

    # console
    console = JSObject()
    for level in ("log", "warn", "error", "info", "debug"):
        def logger(this, args, lvl=level):
            interp.console.append(
                (lvl, " ".join(to_js_string(a, interp) for a in args)))
            return undefined
        console.props[level] = HostFunction(logger, level)
    g.declare("console", console)

    # Math
    m = JSObject()
    for name, fn in (
        ("floor", lambda a: float(math.floor(to_number(a[0])))),
        ("ceil", lambda a: float(math.ceil(to_number(a[0])))),
        ("round", lambda a: float(math.floor(to_number(a[0]) + 0.5))),
        ("abs", lambda a: abs(to_number(a[0]))),
        ("sqrt", lambda a: math.sqrt(to_number(a[0]))),
        ("pow", lambda a: to_number(a[0]) ** to_number(a[1])),
        ("min", lambda a: min((to_number(x) for x in a), default=math.inf)),
        ("max", lambda a: max((to_number(x) for x in a), default=-math.inf)),
        ("random", lambda a: 0.42),  # deterministic for tests
        ("trunc", lambda a: float(math.trunc(to_number(a[0])))),
        ("sign", lambda a: math.copysign(1.0, to_number(a[0]))
         if to_number(a[0]) != 0 else 0.0),
    ):
        m.props[name] = HostFunction(lambda this, args, f=fn: f(args), name)
    m.props["PI"] = math.pi
    m.props["Infinity"] = math.inf
    g.declare("Math", m)
    g.declare("Infinity", math.inf)
    g.declare("NaN", math.nan)

    # JSON
    js_on = JSObject()

    def json_stringify(this, args):
        value = js_to_python(args[0]) if args else None
        indent = None
        if len(args) > 2 and args[2] is not undefined:
            indent = int(to_number(args[2]))
        if args and args[0] is undefined:
            return undefined
        # Node emits compact separators ('{"a":1}'); Python's defaults
        # insert spaces — a cross-engine divergence the differential
        # corpus pins (json-stringify-compact).
        seps = (",", ": ") if indent is not None else (",", ":")
        return _json.dumps(value, indent=indent, separators=seps)

    def json_parse(this, args):
        try:
            return python_to_js(_json.loads(to_js_string(args[0], interp)))
        except ValueError as e:
            raise JSException(make_error("SyntaxError", f"JSON.parse: {e}"))
    js_on.props["stringify"] = HostFunction(json_stringify, "stringify")
    js_on.props["parse"] = HostFunction(json_parse, "parse")
    g.declare("JSON", js_on)

    # Object
    obj_ns = JSObject()

    def object_assign(this, args):
        target = args[0]
        for src in args[1:]:
            if isinstance(src, JSObject) and not isinstance(src, JSArray):
                for k in src.own_keys():
                    interp.set_prop(target, k, interp.get_prop(src, k))
            elif isinstance(src, JSArray):
                for i, x in enumerate(src.items):
                    interp.set_prop(target, str(i), x)
        return target
    obj_ns.props["assign"] = HostFunction(object_assign, "assign")
    obj_ns.props["keys"] = HostFunction(
        lambda this, args: JSArray(list(args[0].own_keys()))
        if isinstance(args[0], JSObject) else JSArray([]), "keys")
    obj_ns.props["values"] = HostFunction(
        lambda this, args: JSArray([
            interp.get_prop(args[0], k) for k in args[0].own_keys()])
        if isinstance(args[0], JSObject) else JSArray([]), "values")
    obj_ns.props["entries"] = HostFunction(
        lambda this, args: JSArray([
            JSArray([k, interp.get_prop(args[0], k)])
            for k in args[0].own_keys()])
        if isinstance(args[0], JSObject) else JSArray([]), "entries")
    obj_ns.props["fromEntries"] = HostFunction(
        lambda this, args: JSObject({
            to_js_string(pair.items[0], interp): pair.items[1]
            for pair in args[0].items}), "fromEntries")
    obj_ns.props["freeze"] = HostFunction(lambda this, args: args[0], "freeze")

    def object_create(this, args):
        proto = args[0] if args else undefined
        o = JSObject()
        if isinstance(proto, JSObject):
            o.proto = proto
        return o
    obj_ns.props["create"] = HostFunction(object_create, "create")
    obj_ns.props["getPrototypeOf"] = HostFunction(
        lambda this, args: (getattr(args[0], "proto", None) or null)
        if isinstance(args[0], JSObject) else null, "getPrototypeOf")
    g.declare("Object", obj_ns)

    # Array
    arr_ns = HostClass("Array", lambda args: JSArray(list(args)),
                       lambda v: isinstance(v, JSArray))
    arr_ns.props["isArray"] = HostFunction(
        lambda this, args: isinstance(args[0], JSArray) if args else False,
        "isArray")

    def array_from(this, args):
        src = args[0] if args else undefined
        mapper = args[1] if len(args) > 1 else None
        if isinstance(src, JSObject) and not isinstance(src, JSArray) and \
                hasattr(src, "js_iter"):
            seq = list(src.js_iter())
        elif isinstance(src, JSArray):
            seq = list(src.items)
        elif isinstance(src, str):
            seq = list(src)
        elif isinstance(src, JSObject) and "length" in src.props:
            n = int(to_number(src.props["length"]))
            seq = [src.props.get(str(i), undefined) for i in range(n)]
        else:
            seq = []
        if mapper is not None and mapper is not undefined:
            seq = [_call(interp, mapper, undefined, [x, float(i)])
                   for i, x in enumerate(seq)]
        return JSArray(seq)
    arr_ns.props["from"] = HostFunction(array_from, "from")
    g.declare("Array", arr_ns)

    # Date — static now()/parse(iso) plus constructible instances with the
    # UTC accessor subset (what KF.formatDate renders with).
    def date_parse(this, args):
        s = to_js_string(args[0], interp)
        try:
            dt = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            return dt.timestamp() * 1000.0
        except ValueError:
            return math.nan

    def date_construct(args):
        if not args:
            ms = float(int(interp._now() * 1000))
        elif isinstance(args[0], str):
            ms = date_parse(undefined, args)
        else:
            try:  # non-numeric (undefined/null/objects) → Invalid Date
                ms = float(args[0])
            except (TypeError, ValueError):
                ms = math.nan
        obj = JSObject()
        obj.class_name = "Date"
        if math.isnan(ms):
            dt = None
        else:
            dt = _dt.datetime.fromtimestamp(ms / 1000.0, _dt.timezone.utc)
        def acc(name, fn):
            obj.props[name] = HostFunction(
                lambda this, a: math.nan if dt is None else float(fn(dt)),
                name)
        acc("getTime", lambda d: ms)
        acc("getUTCFullYear", lambda d: d.year)
        acc("getUTCMonth", lambda d: d.month - 1)
        acc("getUTCDate", lambda d: d.day)
        acc("getUTCHours", lambda d: d.hour)
        acc("getUTCMinutes", lambda d: d.minute)
        acc("getUTCSeconds", lambda d: d.second)
        acc("getUTCDay", lambda d: (d.weekday() + 1) % 7)
        obj.props["toISOString"] = HostFunction(
            lambda this, a: ("Invalid Date" if dt is None else
                             dt.strftime("%Y-%m-%dT%H:%M:%S.") +
                             f"{dt.microsecond // 1000:03d}Z"), "toISOString")
        return obj

    date_cls = HostClass("Date", date_construct,
                         lambda v: getattr(v, "class_name", "") == "Date")
    date_cls.props["now"] = HostFunction(
        lambda this, args: float(int(interp._now() * 1000)), "now")
    date_cls.props["parse"] = HostFunction(date_parse, "parse")
    g.declare("Date", date_cls)

    # Promise
    def promise_construct(args):
        p = Promise(interp)
        executor = args[0]
        resolve_fn = HostFunction(
            lambda this, a: (p.resolve(a[0] if a else undefined), undefined)[1],
            "resolve")
        reject_fn = HostFunction(
            lambda this, a: (p.reject(a[0] if a else undefined), undefined)[1],
            "reject")
        try:
            interp.call_function(executor, undefined, [resolve_fn, reject_fn])
        except JSException as e:
            p.reject(e.value)
        return p
    promise_ns = HostClass("Promise", promise_construct,
                           lambda v: isinstance(v, Promise))

    def promise_resolve(this, args):
        v = args[0] if args else undefined
        if isinstance(v, Promise):
            return v
        p = Promise(interp)
        p.resolve(v)
        return p
    promise_ns.props["resolve"] = HostFunction(promise_resolve, "resolve")

    def promise_reject(this, args):
        p = Promise(interp)
        p.reject(args[0] if args else undefined)
        return p
    promise_ns.props["reject"] = HostFunction(promise_reject, "reject")

    def promise_all(this, args):
        out = Promise(interp)
        entries = list(interp.iterate(args[0]))
        results = [undefined] * len(entries)
        remaining = {"n": 0}
        if not entries:
            out.resolve(JSArray([]))
            return out
        for i, entry in enumerate(entries):
            if isinstance(entry, Promise):
                remaining["n"] += 1

                def on_ok(v, i=i):
                    results[i] = v
                    remaining["n"] -= 1
                    if remaining["n"] == 0:
                        out.resolve(JSArray(results))

                def on_err(v):
                    out.reject(v)
                entry.then_callbacks(on_ok, on_err)
            else:
                results[i] = entry
        if remaining["n"] == 0:
            out.resolve(JSArray(results))
        return out
    promise_ns.props["all"] = HostFunction(promise_all, "all")

    def promise_all_settled(this, args):
        out = Promise(interp)
        entries = list(interp.iterate(args[0]))
        results = [undefined] * len(entries)
        remaining = {"n": len(entries)}
        if not entries:
            out.resolve(JSArray([]))
            return out

        def settle(i, status, key, v):
            results[i] = JSObject({"status": status, key: v})
            remaining["n"] -= 1
            if remaining["n"] == 0:
                out.resolve(JSArray(results))
        for i, entry in enumerate(entries):
            if isinstance(entry, Promise):
                entry.then_callbacks(
                    lambda v, i=i: settle(i, "fulfilled", "value", v),
                    lambda v, i=i: settle(i, "rejected", "reason", v))
            else:
                settle(i, "fulfilled", "value", entry)
        return out
    promise_ns.props["allSettled"] = HostFunction(promise_all_settled,
                                                  "allSettled")

    def promise_race(this, args):
        out = Promise(interp)
        settled = {"done": False}

        def first(settle_fn):
            def cb(v):
                if not settled["done"]:
                    settled["done"] = True
                    settle_fn(v)
            return cb
        ok, err = first(out.resolve), first(out.reject)
        for entry in list(interp.iterate(args[0])):
            if isinstance(entry, Promise):
                entry.then_callbacks(ok, err)
            else:
                ok(entry)
        return out
    promise_ns.props["race"] = HostFunction(promise_race, "race")
    g.declare("Promise", promise_ns)

    # Map / Set — SameValueZero keying: primitives by (type-tagged) value,
    # objects by identity. keys()/values()/entries() return arrays (spec:
    # iterators — for-of and spread over them behave identically here).
    def _svz_key(k):
        if isinstance(k, JSObject):
            return ("o", id(k))
        if isinstance(k, bool):
            return ("b", k)
        if isinstance(k, float):
            return ("n", "NaN" if math.isnan(k) else k)
        if isinstance(k, str):
            return ("s", k)
        return ("x", id(k))  # undefined / null singletons

    class MapObject(JSObject):
        class_name = "Map"

        def __init__(self):
            super().__init__()
            self.data = {}  # svz key -> (original key, value)

        def js_iter(self):
            return (JSArray([k, v]) for k, v in self.data.values())

        def js_get_prop(self, name, itp):
            d = self.data
            if name == "size":
                return float(len(d))
            if name == "get":
                return HostFunction(
                    lambda this, a: d.get(_svz_key(a[0]), (None, undefined))[1],
                    "get")
            if name == "set":
                def mset(this, a):
                    k = a[0] if a else undefined
                    v = a[1] if len(a) > 1 else undefined
                    d[_svz_key(k)] = (k, v)
                    return self
                return HostFunction(mset, "set")
            if name == "has":
                return HostFunction(
                    lambda this, a: _svz_key(a[0]) in d, "has")
            if name == "delete":
                return HostFunction(
                    lambda this, a: d.pop(_svz_key(a[0]), NOT_PRESENT)
                    is not NOT_PRESENT, "delete")
            if name == "clear":
                return HostFunction(
                    lambda this, a: (d.clear(), undefined)[1], "clear")
            if name == "keys":
                return HostFunction(
                    lambda this, a: JSArray([k for k, _ in d.values()]), "keys")
            if name == "values":
                return HostFunction(
                    lambda this, a: JSArray([v for _, v in d.values()]),
                    "values")
            if name == "entries":
                return HostFunction(
                    lambda this, a: JSArray(list(self.js_iter())), "entries")
            if name == "forEach":
                def meach(this, a):
                    for k, v in list(d.values()):
                        itp.call_function(a[0], undefined, [v, k, self])
                    return undefined
                return HostFunction(meach, "forEach")
            return super().js_get_prop(name, itp)

    class SetObject(JSObject):
        class_name = "Set"

        def __init__(self):
            super().__init__()
            self.data = {}  # svz key -> original value

        def js_iter(self):
            return iter(list(self.data.values()))

        def js_get_prop(self, name, itp):
            d = self.data
            if name == "size":
                return float(len(d))
            if name == "add":
                def sadd(this, a):
                    v = a[0] if a else undefined
                    d.setdefault(_svz_key(v), v)
                    return self
                return HostFunction(sadd, "add")
            if name == "has":
                return HostFunction(
                    lambda this, a: _svz_key(a[0]) in d, "has")
            if name == "delete":
                return HostFunction(
                    lambda this, a: d.pop(_svz_key(a[0]), NOT_PRESENT)
                    is not NOT_PRESENT, "delete")
            if name == "clear":
                return HostFunction(
                    lambda this, a: (d.clear(), undefined)[1], "clear")
            if name == "values":
                return HostFunction(
                    lambda this, a: JSArray(list(d.values())), "values")
            if name == "forEach":
                def seach(this, a):
                    for v in list(d.values()):
                        itp.call_function(a[0], undefined, [v, v, self])
                    return undefined
                return HostFunction(seach, "forEach")
            return super().js_get_prop(name, itp)

    def map_construct(args):
        m = MapObject()
        if args and args[0] is not undefined and args[0] is not null:
            for pair in interp.iterate(args[0]):
                k = interp.get_index(pair, 0.0)
                v = interp.get_index(pair, 1.0)
                m.data[_svz_key(k)] = (k, v)
        return m

    def set_construct(args):
        s = SetObject()
        if args and args[0] is not undefined and args[0] is not null:
            for v in interp.iterate(args[0]):
                s.data.setdefault(_svz_key(v), v)
        return s

    g.declare("Map", HostClass(
        "Map", map_construct, lambda v: isinstance(v, MapObject)))
    g.declare("Set", HostClass(
        "Set", set_construct, lambda v: isinstance(v, SetObject)))

    # Error family
    def error_class(kind):
        def construct(args):
            return make_error(
                kind, to_js_string(args[0], interp) if args else "")
        return HostClass(
            kind, construct,
            lambda v: isinstance(v, JSObject) and v.class_name == "Error")
    for kind in ("Error", "TypeError", "RangeError", "SyntaxError"):
        g.declare(kind, error_class(kind))

    # RegExp
    g.declare("RegExp", HostClass(
        "RegExp",
        lambda args: RegExpObject(
            to_js_string(args[0], interp),
            to_js_string(args[1], interp) if len(args) > 1 else ""),
        lambda v: isinstance(v, RegExpObject)))

    # Primitive conversion + URI helpers
    g.declare("Number", _number_ns(interp))
    g.declare("String", HostFunction(
        lambda this, args: to_js_string(args[0], interp) if args else "",
        "String"))
    g.declare("Boolean", HostFunction(
        lambda this, args: is_truthy(args[0]) if args else False, "Boolean"))
    g.declare("parseInt", HostFunction(_parse_int, "parseInt"))
    g.declare("parseFloat", HostFunction(_parse_float, "parseFloat"))
    g.declare("isNaN", HostFunction(
        lambda this, args: math.isnan(to_number(args[0])), "isNaN"))
    g.declare("encodeURIComponent", HostFunction(
        lambda this, args: _url.quote(to_js_string(args[0], interp), safe=""),
        "encodeURIComponent"))
    g.declare("decodeURIComponent", HostFunction(
        lambda this, args: _url.unquote(to_js_string(args[0], interp)),
        "decodeURIComponent"))
    g.declare("encodeURI", HostFunction(
        lambda this, args: _url.quote(to_js_string(args[0], interp),
                                      safe=":/?#[]@!$&'()*+,;="),
        "encodeURI"))
    g.declare("globalThis", JSObject())


def _number_ns(interp):
    ns = HostFunction(
        lambda this, args: to_number(args[0]) if args else 0.0, "Number")
    ns.props["isInteger"] = HostFunction(
        lambda this, args: isinstance(args[0], float) and
        args[0].is_integer(), "isInteger")
    ns.props["isFinite"] = HostFunction(
        lambda this, args: isinstance(args[0], float) and
        math.isfinite(args[0]), "isFinite")
    ns.props["parseFloat"] = HostFunction(_parse_float, "parseFloat")
    ns.props["MAX_SAFE_INTEGER"] = float(2**53 - 1)
    return ns


def _parse_int(this, args):
    s = to_js_string(args[0]).strip()
    radix = int(to_number(args[1])) if len(args) > 1 and \
        args[1] is not undefined else 10
    m = ""
    for i, c in enumerate(s):
        if c in "+-" and i == 0:
            m += c
        elif c.isdigit() or (radix == 16 and c.lower() in "abcdef"):
            m += c
        else:
            break
    try:
        return float(int(m, radix))
    except ValueError:
        return math.nan


def _parse_float(this, args):
    s = to_js_string(args[0]).strip()
    m = ""
    seen_dot = seen_e = False
    for i, c in enumerate(s):
        if c in "+-" and (i == 0 or s[i - 1].lower() == "e"):
            m += c
        elif c.isdigit():
            m += c
        elif c == "." and not seen_dot and not seen_e:
            m += c
            seen_dot = True
        elif c.lower() == "e" and not seen_e and m:
            m += c
            seen_e = True
        else:
            break
    try:
        return float(m)
    except ValueError:
        return math.nan
