"""Span trees for the serving loop.

A copy of ``span`` and what it needs from
``kubeflow_tpu/runtime/tracing.py``: contextvar-propagated span trees
(trace id shared down the tree, lazy span ids, wall duration,
attributes, ok/error status). The kill switch, the no-op span, the
flight recorder, the reconcile ``Tracer`` and the OpenTelemetry mirror
serve the control plane and are not part of the port.
"""

from __future__ import annotations

import contextvars
import os
import random
import time

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
    """One node of a trace tree. Cheap by construction: ids are
    generated lazily (only the root's trace id is eager) and nothing is
    serialized."""

    __slots__ = (
        "name", "_trace_id", "_span_id", "parent", "attrs", "status",
        "error", "children", "root",
        "_start", "duration", "_token",
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
        else:
            self._trace_id = None
            self.root = parent.root
        self._start = time.perf_counter()
        self.duration: float | None = None

    # Span doubles as its own context manager: a separate contextmanager
    # object (let alone contextlib's generator machinery) costs real
    # throughput on a hot path.
    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.finish("error", repr(exc))
        else:
            self.finish()
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
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

    def finish(self, status: str = "ok", error: str | None = None) -> None:
        if self.duration is None:
            self.duration = time.perf_counter() - self._start
        self.status = status
        self.error = error

    def span_names(self) -> list[str]:
        """Every descendant span name, depth-first (test/debug helper)."""
        out = []
        for c in self.children:
            out.append(c.name)
            out.extend(c.span_names())
        return out


_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "kubeflow_tpu_span", default=None
)


def span(name: str, /, *, trace_id: str | None = None, **attrs) -> Span:
    """Open a span as a child of the context's current span (or a new
    root). Works across ``await`` — contextvars follow the task.

    ``trace_id`` seeds a ROOT span's trace id; ignored when a parent
    exists — a child can't change the tree it's in.
    """
    parent = _current.get()
    s = Span(name, trace_id=trace_id, parent=parent, attrs=attrs)
    if parent is not None:
        parent.children.append(s)
    return s
