"""End-to-end reconcile tracing: span trees, correlation IDs, flight recorder.

The reference stack has no distributed tracing at all (SURVEY.md §5: "No
OpenTelemetry anywhere") — when a Notebook sticks in ``Waiting`` there is
no way to see which phase (queue wait, cache read, child apply, status
patch, admission) ate the time or which API call failed. This module is
the rebuilt answer, always on and cheap enough to stay on:

- **Span trees.** :func:`span` opens a named span as a child of whatever
  span the current ``contextvars`` context carries; ``trace_id`` is shared
  down the tree, every span gets its own ``span_id``. Spans record wall
  duration, attributes, and ok/error status. When the ``opentelemetry``
  SDK is importable AND ``ENABLE_TRACING=true``, real OTel spans mirror
  the tree; otherwise the tree itself is the trace (plus the existing
  per-controller latency histogram, which stays — dashboards carry over).

- **Correlation IDs.** :func:`current_trace_id` exposes the active trace
  id so API clients stamp it onto every request (``X-Request-Id`` header:
  ``runtime/httpclient.py`` on the wire, ``testing/fakekube.py`` in its
  request log) and the web apps' request-ID middleware joins the same
  header space — one id follows a reconcile from queue pop to apiserver
  audit log.

- **Flight recorder.** A bounded per-object ring buffer of the last N
  completed reconcile traces per key — outcome, duration, span tree, API
  verbs issued, events emitted, error — retained *after* the reconcile
  ends, so ``GET /debug/traces`` on the manager answers "what did the
  last reconcile of team/nb actually do" hours later. controller-runtime's
  pprof/zpages idiom rebuilt for this stack.

Overhead is bench-gated: ``bench.py tracing_overhead`` proves the
always-on path costs <5% of reconcile throughput (acceptance criterion);
:func:`set_enabled` is the kill switch the probe flips to measure it.

The port's copy of ``kubeflow_tpu/runtime/tracing.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import os
import random
import threading
import time
from collections import OrderedDict, deque

from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import fmt_iso

log = logging.getLogger("kubeflow_tpu_torch.trace")

_otel_tracer = None
if os.environ.get("ENABLE_TRACING") == "true":  # pragma: no cover
    try:
        from opentelemetry import trace as _otel_trace

        _otel_tracer = _otel_trace.get_tracer("kubeflow_tpu_torch")
    except ImportError:
        _otel_tracer = None

# Process-wide kill switch (the tracing_overhead bench probe measures the
# difference; operators never need it — that's the point of the bench gate).
_enabled = True


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


# Correlation ids need uniqueness, not cryptographic randomness — and the
# hot path opens several spans per reconcile. A process-local PRNG (seeded
# from the OS once) is ~100× cheaper than uuid4, whose per-call
# os.urandom syscall alone can cost ~0.1 ms.
_rand = random.Random(int.from_bytes(os.urandom(16), "big"))


def new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


class Span:
    """One node of a trace tree. Cheap by construction — the reconcile
    hot path opens ~a dozen of these, so ids are generated lazily (only
    the root's trace id is eager: API clients stamp it on every request)
    and nothing is serialized until the flight recorder or a /debug
    handler asks."""

    __slots__ = (
        "name", "_trace_id", "_span_id", "parent", "attrs", "status",
        "error", "children", "root", "api_calls", "events",
        "_start", "duration", "_token", "_otel",
    )

    def __init__(self, name: str, *, trace_id: str | None = None,
                 parent: "Span | None" = None, attrs: dict | None = None):
        self.name = name
        self.parent = parent
        self._span_id: str | None = None
        self.attrs = attrs or {}
        self.status = "ok"
        self.error: str | None = None
        self.children: list[Span] = []
        self._token = None
        if parent is None:
            self._trace_id = trace_id or new_trace_id()
            self.root = self
            # Root-only bookkeeping: API verbs and emitted events
            # aggregate here so the flight-recorder entry answers "what
            # did this reconcile DO" without walking the tree.
            self.api_calls: dict[tuple[str, str], int] = {}
            self.events: list[str] = []
        else:
            self._trace_id = None
            self.root = parent.root
            self.api_calls = self.root.api_calls
            self.events = self.root.events
        self._start = time.perf_counter()
        self.duration: float | None = None

    # Span doubles as its own context manager — the reconcile hot path
    # opens ~a dozen spans, and a separate contextmanager object (let
    # alone contextlib's generator machinery) costs real throughput.
    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        if _otel_tracer is not None:  # pragma: no cover - needs the SDK
            self._otel = _otel_tracer.start_as_current_span(self.name)
            otel_span = self._otel.__enter__()
            if hasattr(otel_span, "set_attribute"):
                for key, value in self.attrs.items():
                    otel_span.set_attribute(key, str(value))
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.finish("error", repr(exc))
        elif self.status == "error":
            # fail() was called inside the block (handled error — e.g. an
            # admission deny whose exception never escapes): keep it.
            self.finish("error", self.error)
        else:
            self.finish()
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if _otel_tracer is not None and getattr(self, "_otel", None) is not None:
            self._otel.__exit__(exc_type, exc, tb)  # pragma: no cover
        return False

    @property
    def trace_id(self) -> str:
        return self.root._trace_id  # the root always generated one

    @property
    def span_id(self) -> str:
        if self._span_id is None:
            self._span_id = new_span_id()
        return self._span_id

    @property
    def parent_id(self) -> str | None:
        return self.parent.span_id if self.parent is not None else None

    def set_attribute(self, key: str, value) -> None:
        self.attrs[key] = value

    def child(self, name: str, /, **attrs) -> "Span":
        s = Span(name, parent=self, attrs=attrs)
        self.children.append(s)
        return s

    def add_synthetic(self, name: str, duration: float, /, **attrs) -> "Span":
        """A pre-measured child (e.g. queue wait — the time was spent
        before any span context existed, so the duration is injected)."""
        s = self.child(name, **attrs)
        s.duration = max(0.0, float(duration))
        return s

    def finish(self, status: str = "ok", error: str | None = None) -> None:
        if self.duration is None:
            self.duration = time.perf_counter() - self._start
        self.status = status
        self.error = error

    def fail(self, error: str) -> None:
        """Mark the span failed WITHOUT ending it — for handled errors
        that never escape the ``with`` block (a webhook deny response, a
        swallowed ApiError). __exit__ preserves the status."""
        self.status = "error"
        self.error = error

    def note_api_call(self, verb: str, kind: str | None) -> None:
        # api_calls is shared with the root — one dict per tree.
        key = (verb, kind or "")
        self.api_calls[key] = self.api_calls.get(key, 0) + 1

    def span_names(self) -> list[str]:
        """Every descendant span name, depth-first (test/debug helper)."""
        out = []
        for c in self.children:
            out.append(c.name)
            out.extend(c.span_names())
        return out

    def to_dict(self) -> dict:
        d: dict = {
            "name": self.name,
            "span_id": self.span_id,
            "duration_sec": round(self.duration, 6) if self.duration is not None else None,
            "status": self.status,
        }
        if self.error:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = {k: str(v) for k, v in self.attrs.items()}
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d


class _NoopSpan:
    """What span() yields when tracing is disabled — every method is a
    no-op so call sites never branch on the kill switch."""

    name = trace_id = span_id = parent_id = parent = None
    status, error, duration = "ok", None, None
    attrs: dict = {}
    children: list = []
    api_calls: dict = {}
    events: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attribute(self, key, value):  # noqa: D102
        pass

    def child(self, name, **attrs):
        return self

    def add_synthetic(self, name, duration, **attrs):
        return self

    def finish(self, status="ok", error=None):
        pass

    def fail(self, error):
        pass

    def note_api_call(self, verb, kind):
        pass

    def span_names(self):
        return []

    def to_dict(self):
        return {}


NOOP_SPAN = _NoopSpan()
_NoopSpan.root = NOOP_SPAN

_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "kubeflow_tpu_span", default=None
)


def current_span() -> Span | None:
    return _current.get()


def current_trace_id() -> str | None:
    s = _current.get()
    return s.trace_id if s is not None else None


def note_api_call(verb: str, kind: str | None = None) -> None:
    """Tag the active trace with an API call (kube clients call this on
    every request). No active trace → no-op."""
    s = _current.get()
    if s is not None:
        s.note_api_call(verb, kind)


def note_event(reason: str) -> None:
    """Tag the active trace with an emitted Kubernetes Event reason."""
    s = _current.get()
    if s is not None:
        s.root.events.append(reason)


def span(name: str, /, *, trace_id: str | None = None, **attrs):
    """Open a span as a child of the context's current span (or a new
    root). Works across ``await`` — contextvars follow the task.

    ``trace_id`` seeds a ROOT span's trace id (request-ID middleware
    reuses an incoming ``X-Request-Id``); ignored when a parent exists —
    a child can't change the tree it's in. With tracing disabled
    (:func:`set_enabled`), returns the shared no-op span.
    """
    if not _enabled:
        return NOOP_SPAN
    parent = _current.get()
    s = Span(name, trace_id=trace_id, parent=parent, attrs=attrs)
    if parent is not None:
        parent.children.append(s)
    return s


def format_key(key) -> str:
    """Normalize a reconcile key — (namespace, name) tuple, string,
    whatever — to the flight recorder's ``ns/name`` string form."""
    if isinstance(key, (tuple, list)):
        return "/".join("-" if part is None else str(part) for part in key)
    return str(key)


class FlightRecorder:
    """Bounded per-key ring buffer of completed trace entries.

    ``per_key`` entries are retained per object key (a deque, oldest
    evicted first) and at most ``max_keys`` keys total (LRU on record —
    deleted objects age out instead of leaking). Thread-safe: the web
    /debug handlers read while reconcile workers write.
    """

    def __init__(self, per_key: int = 8, max_keys: int = 1024):
        self.per_key = per_key
        self.max_keys = max_keys
        self._buffers: "OrderedDict[str, deque]" = OrderedDict()
        self._lock = threading.Lock()
        self._seq = itertools.count()

    def record(self, entry: dict) -> None:
        """File one completed trace. The hot path stores the live span
        tree (``_root``) plus flat metadata; serialization to JSON shape
        happens lazily in :meth:`entries` — /debug reads pay it, not
        every reconcile."""
        key = entry.get("key") or "-"
        with self._lock:
            entry["seq"] = next(self._seq)
            buf = self._buffers.get(key)
            if buf is None:
                buf = self._buffers[key] = deque(maxlen=self.per_key)
            buf.append(entry)
            self._buffers.move_to_end(key)
            while len(self._buffers) > self.max_keys:
                self._buffers.popitem(last=False)

    @staticmethod
    def _expand(entry: dict) -> dict:
        root: Span | None = entry.get("_root")
        out = {k: v for k, v in entry.items() if not k.startswith("_")}
        if "_wall" in entry:
            out["time"] = fmt_iso(entry["_wall"])
        if root is not None:
            out["trace_id"] = root.trace_id
            out["api_calls"] = [
                {"verb": verb, "kind": kind, "count": count}
                for (verb, kind), count in sorted(root.api_calls.items())
            ]
            out["events"] = list(root.events)
            out["spans"] = [c.to_dict() for c in root.children]
        return out

    def entries(self, key=None, limit: int = 50) -> list[dict]:
        """Most-recent-first entries (JSON-shaped), optionally for one key."""
        with self._lock:
            if key is not None:
                rows = list(self._buffers.get(format_key(key), ()))
            else:
                rows = [e for buf in self._buffers.values() for e in buf]
        rows.sort(key=lambda e: e.get("seq", 0), reverse=True)
        return [self._expand(e) for e in rows[: max(0, limit)]]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buffers.values())


class Tracer:
    """Root-trace factory: opens the root span, keeps the per-controller
    latency histogram (pre-existing metric name — dashboards carry over),
    and files every completed root into the flight recorder."""

    def __init__(self, registry: Registry | None = None,
                 recorder: FlightRecorder | None = None):
        registry = registry or global_registry
        self.h_duration = registry.histogram(
            "controller_reconcile_duration_seconds",
            "Reconcile latency per controller",
            ["controller"],
        )
        self.m_traces = registry.counter(
            "tracing_traces_total",
            "Completed root traces by outcome",
            ["root", "outcome"],
        )
        self.recorder = recorder or FlightRecorder()

    @contextlib.contextmanager
    def trace(self, name: str, /, *, key=None, controller: str | None = None,
              trace_id: str | None = None, **attrs):
        """Open a ROOT span; on exit (success or exception) observe the
        latency histogram and record the flight-recorder entry. Exceptions
        propagate — error handling stays the caller's business."""
        if not _enabled:
            yield NOOP_SPAN
            return
        key_str = format_key(key) if key is not None else None
        all_attrs = dict(attrs)
        if controller:
            all_attrs["controller"] = controller
        if key_str:
            all_attrs["key"] = key_str
        start_wall = time.time()
        error: str | None = None
        root: Span | None = None
        try:
            with span(name, trace_id=trace_id, **all_attrs) as root:
                yield root
        except BaseException as e:
            error = repr(e)
            raise
        finally:
            if root is not None and root is not NOOP_SPAN:
                # An escaped exception OR an in-block fail() (handled
                # error, e.g. an admission deny) both count as error.
                error = error or (root.error if root.status == "error" else None)
                outcome = "error" if error else "ok"
                self.h_duration.labels(
                    controller=str(controller or name)
                ).observe(root.duration or 0.0)
                self.m_traces.labels(root=name, outcome=outcome).inc()
                self.recorder.record({
                    "root": name,
                    "key": key_str or "-",
                    "controller": controller,
                    "outcome": outcome,
                    "error": error,
                    "duration_sec": round(root.duration or 0.0, 6),
                    "_wall": start_wall,
                    "_root": root,
                })
