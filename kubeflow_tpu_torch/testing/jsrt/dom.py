"""Headless DOM for the vendored JS runtime.

Implements the element/event surface the shipped frontends use: element
tree + attributes/classes/styles, bubbling events, form controls with
values, a CSS-selector subset (tag/#id/.class/[attr="v"]/:checked +
descendant combinator), classList, canvas-2d call recording. Everything is
a ``JSObject`` subclass so the interpreter's property protocol applies
directly.
"""

from __future__ import annotations

from html.parser import HTMLParser

from kubeflow_tpu_torch.testing.jsrt.interp import (
    NOT_PRESENT,
    HostFunction,
    JSArray,
    JSObject,
    is_truthy,
    null,
    to_js_string,
    undefined,
)

VOID_ELEMENTS = {"br", "hr", "img", "input", "meta", "link", "area", "base",
                 "col", "embed", "source", "track", "wbr"}


def _method(name, fn):
    return HostFunction(fn, name)


class DomNode(JSObject):
    class_name = "Node"

    def __init__(self, document):
        super().__init__()
        self.document = document
        self.parent: DomNode | None = None
        self.child_nodes: list[DomNode] = []

    # -- tree ops (Python level) -------------------------------------------------

    def _append_node(self, node) -> None:
        if isinstance(node, str):
            node = TextNode(self.document, node)
        if node.parent is not None:
            node.parent.child_nodes.remove(node)
        node.parent = self
        self.child_nodes.append(node)

    def _remove_self(self) -> None:
        if self.parent is not None:
            self.parent.child_nodes.remove(self)
            self.parent = None

    def walk(self):
        for child in self.child_nodes:
            yield child
            if isinstance(child, Element):
                yield from child.walk()

    def text_content(self) -> str:
        out = []
        for node in [self] + list(self.walk()):
            if isinstance(node, TextNode):
                out.append(node.data)
        return "".join(out)

    def set_text_content(self, value: str) -> None:
        for child in list(self.child_nodes):
            child.parent = None
        self.child_nodes = []
        if value:
            self._append_node(TextNode(self.document, value))


class TextNode(DomNode):
    class_name = "Text"

    def __init__(self, document, data: str):
        super().__init__(document)
        self.data = data

    def js_get_prop(self, name, interp):
        if name == "textContent" or name == "data" or name == "nodeValue":
            return self.data
        if name == "nodeType":
            return 3.0
        return super().js_get_prop(name, interp)


def activate(doc, el) -> bool:
    """Click with the browser's pre-dispatch activation behavior: a
    checkbox toggles (a radio sets) its checked state before listeners
    see the event."""
    if isinstance(el, Element) and el.tag == "input":
        input_type = el.attrs.get("type")
        if input_type == "checkbox":
            current = el._checked if el._checked is not None \
                else ("checked" in el.attrs)
            el._checked = not current
        elif input_type == "radio":
            el._checked = True
    return doc.dispatch(el, Event("click"))


class Event(JSObject):
    class_name = "Event"

    def __init__(self, etype: str, props: dict | None = None):
        super().__init__()
        self.etype = etype
        self.target = null
        self.default_prevented = False
        self.propagation_stopped = False
        self.props.update(props or {})
        self.props["type"] = etype
        self.props["preventDefault"] = _method(
            "preventDefault",
            lambda this, args: setattr(self, "default_prevented", True) or undefined)
        self.props["stopPropagation"] = _method(
            "stopPropagation",
            lambda this, args: setattr(self, "propagation_stopped", True) or undefined)

    def js_get_prop(self, name, interp):
        if name == "target":
            return self.target
        if name == "defaultPrevented":
            return self.default_prevented
        return super().js_get_prop(name, interp)


class ClassList(JSObject):
    class_name = "DOMTokenList"

    def __init__(self, element: "Element"):
        super().__init__()
        self.element = element
        self.props["add"] = _method("add", self._add)
        self.props["remove"] = _method("remove", self._remove)
        self.props["toggle"] = _method("toggle", self._toggle)
        self.props["contains"] = _method("contains", self._contains)

    def _classes(self) -> list[str]:
        return [c for c in self.element.attrs.get("class", "").split() if c]

    def _store(self, classes: list[str]) -> None:
        self.element.attrs["class"] = " ".join(classes)

    def _add(self, this, args):
        classes = self._classes()
        for a in args:
            name = to_js_string(a)
            if name not in classes:
                classes.append(name)
        self._store(classes)
        return undefined

    def _remove(self, this, args):
        names = {to_js_string(a) for a in args}
        self._store([c for c in self._classes() if c not in names])
        return undefined

    def _toggle(self, this, args):
        name = to_js_string(args[0])
        classes = self._classes()
        if len(args) > 1:
            want = is_truthy(args[1])
        else:
            want = name not in classes
        if want and name not in classes:
            classes.append(name)
        if not want and name in classes:
            classes.remove(name)
        self._store(classes)
        return want

    def _contains(self, this, args):
        return to_js_string(args[0]) in self._classes()


class CanvasContext(JSObject):
    class_name = "CanvasRenderingContext2D"

    def __init__(self):
        super().__init__()
        self.calls: list[tuple] = []
        for name in ("clearRect", "fillText", "beginPath", "moveTo", "lineTo",
                     "stroke", "fill", "arc", "rect", "fillRect", "closePath"):
            self.props[name] = _method(
                name,
                lambda this, args, n=name: (
                    self.calls.append((n, [a for a in args])), undefined)[1])


class Element(DomNode):
    class_name = "Element"

    def __init__(self, document, tag: str):
        super().__init__(document)
        self.tag = tag.lower()
        self.attrs: dict[str, str] = {}
        self.listeners: dict[str, list] = {}
        self.style = JSObject()
        self._value: str | None = None
        self._checked: bool | None = None
        self.disabled = False
        self.scroll_top = 0.0
        self.scroll_left = 0.0
        self._sel: tuple[int, int] | None = None
        self._canvas_ctx: CanvasContext | None = None

    # -- js property protocol ----------------------------------------------------

    def js_get_prop(self, name, interp):  # noqa: PLR0911, PLR0912 — dispatch table
        if name in self.setters or name in self.getters or name in self.props:
            return super().js_get_prop(name, interp)
        if name == "tagName":
            return self.tag.upper()
        if name == "nodeType":
            return 1.0
        if name == "id":
            return self.attrs.get("id", "")
        if name == "className":
            return self.attrs.get("class", "")
        if name == "classList":
            return ClassList(self)
        if name == "style":
            return self.style
        if name == "textContent" or name == "innerText":
            return self.text_content()
        if name == "value":
            return self.get_value()
        if name == "checked":
            return self._checked if self._checked is not None \
                else ("checked" in self.attrs)
        if name == "disabled":
            return self.disabled
        if name == "name":
            return self.attrs.get("name", "")
        if name == "type":
            return self.attrs.get("type", "")
        if name == "href":
            return self.attrs.get("href", "")
        if name == "title":
            return self.attrs.get("title", "")
        if name == "children":
            return JSArray([c for c in self.child_nodes
                            if isinstance(c, Element)])
        if name == "childNodes":
            return JSArray(list(self.child_nodes))
        if name == "parentElement" or name == "parentNode":
            return self.parent if self.parent is not None else null
        if name == "firstChild":
            return self.child_nodes[0] if self.child_nodes else null
        if name in ("nextElementSibling", "previousElementSibling"):
            parent = self.parent
            if parent is None:
                return null
            sibs = [c for c in parent.child_nodes if isinstance(c, Element)]
            try:
                at = sibs.index(self)
            except ValueError:  # pragma: no cover - detached node
                return null
            at += 1 if name == "nextElementSibling" else -1
            return sibs[at] if 0 <= at < len(sibs) else null
        if name == "options":
            return JSArray([c for c in self.walk()
                            if isinstance(c, Element) and c.tag == "option"])
        if name == "scrollTop":
            return self.scroll_top
        if name == "scrollLeft":
            return self.scroll_left
        if name == "selectionStart":
            return float(self._selection()[0])
        if name == "selectionEnd":
            return float(self._selection()[1])
        if name == "setSelectionRange":
            def set_range(this, args):
                self._sel = (int(args[0]), int(args[1]))
                return undefined
            return _method(name, set_range)
        if name == "scrollHeight":
            return 1000.0
        if name == "clientWidth":
            return float(int(self.attrs.get("width", 0) or 0))
        if name == "clientHeight":
            return float(int(self.attrs.get("height", 0) or 0))
        if name == "width":
            return float(int(self.attrs.get("width", 0) or 0))
        if name == "height":
            return float(int(self.attrs.get("height", 0) or 0))
        if name == "dataset":
            data = JSObject()
            for k, v in self.attrs.items():
                if k.startswith("data-"):
                    parts = k[5:].split("-")
                    camel = parts[0] + "".join(p.title() for p in parts[1:])
                    data.props[camel] = v
            return data
        method = self._dom_method(name, interp)
        if method is not NOT_PRESENT:
            return method
        if name in self.attrs:
            return self.attrs[name]
        return undefined

    def js_set_prop(self, name, value, interp) -> bool:
        if name in self.setters:
            return super().js_set_prop(name, value, interp)
        if name == "textContent" or name == "innerText":
            self.set_text_content(to_js_string(value, interp))
            return True
        if name == "className":
            self.attrs["class"] = to_js_string(value, interp)
            return True
        if name == "value":
            self._value = to_js_string(value, interp)
            return True
        if name == "checked":
            self._checked = is_truthy(value)
            return True
        if name == "disabled":
            self.disabled = is_truthy(value)
            return True
        if name == "id":
            self.attrs["id"] = to_js_string(value, interp)
            return True
        if name == "title":
            self.attrs["title"] = to_js_string(value, interp)
            return True
        if name == "scrollTop":
            self.scroll_top = float(to_js_string(value, interp) == "" or value)
            return True
        if name == "scrollLeft":
            self.scroll_left = float(to_js_string(value, interp) == "" or value)
            return True
        if name == "selectionStart":
            self._sel = (int(value), self._selection()[1])
            return True
        if name == "selectionEnd":
            self._sel = (self._selection()[0], int(value))
            return True
        if name in ("width", "height"):
            self.attrs[name] = str(int(value)) if isinstance(value, float) \
                else to_js_string(value, interp)
            return True
        return super().js_set_prop(name, value, interp)

    # -- value semantics ---------------------------------------------------------

    def _selection(self) -> tuple[int, int]:
        """Caret range clamped to the current value (collapsed at the end
        by default, like a freshly-focused real textarea)."""
        n = len(self.get_value())
        if self._sel is None:
            return (n, n)
        return (min(self._sel[0], n), min(self._sel[1], n))

    def get_value(self) -> str:
        if self.tag == "select":
            if self._value is not None:
                options = [c for c in self.walk()
                           if isinstance(c, Element) and c.tag == "option"]
                for o in options:
                    if o.option_value() == self._value:
                        return self._value
            options = [c for c in self.walk()
                       if isinstance(c, Element) and c.tag == "option"]
            for o in options:
                if "selected" in o.attrs:
                    return o.option_value()
            return options[0].option_value() if options else ""
        if self._value is not None:
            return self._value
        return self.attrs.get("value", "")

    def option_value(self) -> str:
        return self.attrs.get("value", self.text_content())

    # -- methods -----------------------------------------------------------------

    def _dom_method(self, name, interp):
        doc = self.document

        if name == "append":
            def append(this, args):
                for a in args:
                    self._append_node(a if isinstance(a, DomNode)
                                      else to_js_string(a, interp))
                return undefined
            return _method(name, append)
        if name == "appendChild":
            def append_child(this, args):
                self._append_node(args[0])
                return args[0]
            return _method(name, append_child)
        if name == "prepend":
            def prepend(this, args):
                for a in reversed(args):
                    node = a if isinstance(a, DomNode) \
                        else TextNode(doc, to_js_string(a, interp))
                    if node.parent is not None:
                        node.parent.child_nodes.remove(node)
                    node.parent = self
                    self.child_nodes.insert(0, node)
                return undefined
            return _method(name, prepend)
        if name == "replaceChildren":
            def replace_children(this, args):
                for child in list(self.child_nodes):
                    child.parent = None
                self.child_nodes = []
                for a in args:
                    self._append_node(a if isinstance(a, DomNode)
                                      else to_js_string(a, interp))
                return undefined
            return _method(name, replace_children)
        if name == "remove":
            return _method(name, lambda this, args: (self._remove_self(),
                                                     undefined)[1])
        if name == "removeChild":
            def remove_child(this, args):
                child = args[0]
                child._remove_self()
                return child
            return _method(name, remove_child)
        if name == "addEventListener":
            def add_listener(this, args):
                etype = to_js_string(args[0], interp)
                self.listeners.setdefault(etype, []).append(args[1])
                return undefined
            return _method(name, add_listener)
        if name == "removeEventListener":
            def remove_listener(this, args):
                etype = to_js_string(args[0], interp)
                if args[1] in self.listeners.get(etype, []):
                    self.listeners[etype].remove(args[1])
                return undefined
            return _method(name, remove_listener)
        if name == "dispatchEvent":
            return _method(name, lambda this, args: doc.dispatch(self, args[0]))
        if name == "setAttribute":
            def set_attr(this, args):
                self.attrs[to_js_string(args[0], interp)] = \
                    to_js_string(args[1], interp)
                return undefined
            return _method(name, set_attr)
        if name == "getAttribute":
            def get_attr(this, args):
                key = to_js_string(args[0], interp)
                return self.attrs.get(key, null)
            return _method(name, get_attr)
        if name == "removeAttribute":
            def remove_attr(this, args):
                self.attrs.pop(to_js_string(args[0], interp), None)
                return undefined
            return _method(name, remove_attr)
        if name == "hasAttribute":
            return _method(name, lambda this, args: to_js_string(
                args[0], interp) in self.attrs)
        if name == "querySelector":
            def qs(this, args):
                hits = select(self, to_js_string(args[0], interp))
                return hits[0] if hits else null
            return _method(name, qs)
        if name == "querySelectorAll":
            def qsa(this, args):
                return NodeList(select(self, to_js_string(args[0], interp)))
            return _method(name, qsa)
        if name == "closest":
            def closest(this, args):
                selector = to_js_string(args[0], interp)
                node = self
                while node is not None and isinstance(node, Element):
                    if matches(node, selector):
                        return node
                    node = node.parent
                return null
            return _method(name, closest)
        if name == "contains":
            return _method(name, lambda this, args: args[0] is self or
                           args[0] in list(self.walk()))
        if name == "matches":
            return _method(name, lambda this, args: matches(
                self, to_js_string(args[0], interp)))
        if name == "focus":
            def do_focus(this, args):
                doc._active_element = self
                return undefined
            return _method(name, do_focus)
        if name == "blur":
            def do_blur(this, args):
                if getattr(doc, "_active_element", None) is self:
                    doc._active_element = None
                return undefined
            return _method(name, do_blur)
        if name == "click":
            def click(this, args):
                return activate(doc, self)
            return _method(name, click)
        if name == "getContext":
            def get_context(this, args):
                if self._canvas_ctx is None:
                    self._canvas_ctx = CanvasContext()
                return self._canvas_ctx
            return _method(name, get_context)
        if name == "submit" and self.tag == "form":
            def submit(this, args):
                return doc.dispatch(self, Event("submit"))
            return _method(name, submit)
        if name == "reset" and self.tag == "form":
            def reset(this, args):
                for el in self.walk():
                    if isinstance(el, Element):
                        el._value = None
                        el._checked = None
                return undefined
            return _method(name, reset)
        return NOT_PRESENT


class NodeList(JSArray):
    class_name = "NodeList"

    def js_iter(self):
        return list(self.items)


class Document(Element):
    class_name = "Document"

    def __init__(self, browser):
        super().__init__(None, "#document")
        self.document = self
        self.browser = browser
        self.body = Element(self, "body")
        self.head = Element(self, "head")
        html = Element(self, "html")
        self._append_node(html)
        html._append_node(self.head)
        html._append_node(self.body)

    # dispatch with bubbling; returns not-default-prevented like the real API.
    def dispatch(self, target, event: Event):
        event.target = target
        node = target
        while node is not None:
            listeners = list(getattr(node, "listeners", {}).get(event.etype, []))
            for listener in listeners:
                result = self.browser.interp.call_function(
                    listener, node, [event])
                # An async handler that throws yields a rejected promise no
                # one will ever .catch — record it so the harness fails
                # loudly instead of shipping the app bug green.
                self.browser.observe_rejection(result)
                if event.propagation_stopped:
                    break
            if event.propagation_stopped:
                break
            node = getattr(node, "parent", None)
        self.browser.interp.run_microtasks()
        return not event.default_prevented

    def js_get_prop(self, name, interp):
        if name == "body":
            return self.body
        if name == "head":
            return self.head
        if name == "activeElement":
            # Tracked by Element.focus()/blur(); components use it for
            # modal focus restore (confirmDialog/drawer opener capture).
            active = getattr(self, "_active_element", None)
            return active if active is not None else self.body
        if name == "cookie":
            return self.browser.cookie_string()
        if name == "createElement":
            return _method(name, lambda this, args: Element(
                self, to_js_string(args[0], interp)))
        if name == "createTextNode":
            return _method(name, lambda this, args: TextNode(
                self, to_js_string(args[0], interp)))
        if name == "getElementById":
            def by_id(this, args):
                want = to_js_string(args[0], interp)
                for node in self.walk():
                    if isinstance(node, Element) and \
                            node.attrs.get("id") == want:
                        return node
                return null
            return _method(name, by_id)
        if name == "documentElement":
            return self.child_nodes[0]
        return super().js_get_prop(name, interp)

    def js_set_prop(self, name, value, interp) -> bool:
        if name == "cookie":
            self.browser.set_cookie_string(to_js_string(value, interp))
            return True
        if name == "title":
            self.attrs["title"] = to_js_string(value, interp)
            return True
        return super().js_set_prop(name, value, interp)


# ---- selector engine -------------------------------------------------------------


def _parse_compound(compound: str):
    """tag?(#id)?(.class)*([attr="v"])*(:checked)? → matcher parts."""
    import re

    tag = None
    ident = None
    classes = []
    attrs = []
    pseudo = []
    pattern = re.compile(
        r"""
        (?P<tag>^[a-zA-Z][\w-]*)
        |\#(?P<id>[\w-]+)
        |\.(?P<cls>[\w-]+)
        |\[(?P<attr>[\w-]+)(?:=(?P<q>["']?)(?P<val>[^\]"']*)(?P=q))?\]
        |:(?P<pseudo>[\w-]+)
        """,
        re.VERBOSE,
    )
    pos = 0
    while pos < len(compound):
        m = pattern.match(compound, pos)
        if not m:
            raise ValueError(f"unsupported selector {compound!r}")
        if m.group("tag"):
            tag = m.group("tag").lower()
        elif m.group("id"):
            ident = m.group("id")
        elif m.group("cls"):
            classes.append(m.group("cls"))
        elif m.group("attr"):
            attrs.append((m.group("attr"), m.group("val")))
        elif m.group("pseudo"):
            pseudo.append(m.group("pseudo"))
        pos = m.end()
    return tag, ident, classes, attrs, pseudo


def _matches_compound(el: Element, compound: str) -> bool:
    tag, ident, classes, attrs, pseudo = _parse_compound(compound)
    if tag is not None and el.tag != tag:
        return False
    if ident is not None and el.attrs.get("id") != ident:
        return False
    el_classes = el.attrs.get("class", "").split()
    for c in classes:
        if c not in el_classes:
            return False
    for key, val in attrs:
        if val is None:
            if key not in el.attrs:
                return False
        elif el.attrs.get(key) != val:
            return False
    for p in pseudo:
        if p == "checked":
            checked = el._checked if el._checked is not None \
                else ("checked" in el.attrs)
            if not checked:
                return False
        elif p == "disabled":
            if not el.disabled:
                return False
        else:
            raise ValueError(f"unsupported pseudo-class :{p}")
    return True


def matches(el: Element, selector: str) -> bool:
    parts = selector.strip().split()
    if not parts:
        return False
    if not _matches_compound(el, parts[-1]):
        return False
    node = el.parent
    remaining = parts[:-1]
    while remaining:
        if node is None or not isinstance(node, Element):
            return False
        if _matches_compound(node, remaining[-1]):
            remaining.pop()
        node = node.parent
    return True


def select(root: DomNode, selector: str) -> list:
    out = []
    for part in selector.split(","):
        for node in root.walk():
            if isinstance(node, Element) and matches(node, part) and \
                    node not in out:
                out.append(node)
    return out


# ---- HTML parsing ----------------------------------------------------------------


class _DomBuilder(HTMLParser):
    def __init__(self, document: Document):
        super().__init__(convert_charrefs=True)
        self.document = document
        self.stack: list[Element] = []
        self.scripts: list[str] = []   # external script srcs, in order
        self._in_inline_script = False
        self.inline_scripts: list[str] = []

    def current(self) -> Element:
        return self.stack[-1] if self.stack else self.document.body

    def handle_starttag(self, tag, attrs):
        if tag == "script":
            src = dict(attrs).get("src")
            if src:
                self.scripts.append(src)
            else:
                self._in_inline_script = True
                self.inline_scripts.append("")
            return
        if tag in ("html", "head", "body", "meta", "link", "title"):
            return
        el = Element(self.document, tag)
        for key, value in attrs:
            el.attrs[key] = value if value is not None else ""
        self.current()._append_node(el)
        if tag not in VOID_ELEMENTS:
            self.stack.append(el)

    def handle_endtag(self, tag):
        if tag == "script":
            self._in_inline_script = False
            return
        if self.stack and self.stack[-1].tag == tag:
            self.stack.pop()

    def handle_data(self, data):
        if self._in_inline_script:
            self.inline_scripts[-1] += data
            return
        if data.strip():
            self.current()._append_node(TextNode(self.document, data))


def build_dom(document: Document, html: str):
    builder = _DomBuilder(document)
    builder.feed(html)
    return builder.scripts, builder.inline_scripts
