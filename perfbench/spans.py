"""The program's own spans in a trace: each device operation and each idle
stretch of the device booked to one ``kftpu.*`` range
(``kubeflow_tpu_torch.telemetry.sections.span``).

A device operation goes to the innermost ``kftpu.*`` range around its
launch on the launching thread (``trace.Trace.launch_of``). The program
opens its spans' ranges in the backward too, on autograd's own thread:
there, a range holds the nodes that the span's forward ops made, and the
gradient sums autograd launches after them.

An idle stretch of the device (between the first ``perfbench.step`` and
the last device operation) goes by the innermost ``kftpu.*`` range the
``perfbench.step`` thread had open at each instant of it.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass

from perfbench.trace import STEP_RANGE

PREFIX = "kftpu."

_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclass
class Booked:
    """One trace's device and idle microseconds by innermost span name
    (None: no ``kftpu.*`` range), and the span names that appear."""
    device_us: dict
    idle_us: dict
    names: frozenset


def innermost(ranges: list, times: list) -> list:
    """For each of ``times`` (sorted), the innermost of ``ranges`` (one
    thread's, nested, sorted by start and then longest first) that holds
    it, ends included, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i].ts <= t:
            r = ranges[i]
            while stack and stack[-1].end < r.ts:
                stack.pop()
            stack.append(r)
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _by_thread(items) -> dict:
    out = defaultdict(list)
    for e in items:
        out[e.tid].append(e)
    for v in out.values():
        v.sort(key=lambda e: (e.ts, -e.end))
    return out


def _lookup(ranges_by_tid: dict, queries: list) -> dict:
    """``{i: innermost range}`` for ``queries`` of ``(i, tid, ts)``."""
    found = {}
    by_tid = defaultdict(list)
    for i, tid, ts in queries:
        by_tid[tid].append((ts, i))
    for tid, qs in by_tid.items():
        qs.sort()
        hits = innermost(ranges_by_tid.get(tid, []), [ts for ts, _ in qs])
        for (_, i), r in zip(qs, hits):
            found[i] = r
    return found


def _name(r) -> str | None:
    return r.name[len(PREFIX):] if r is not None else None


def _idle_intervals(trace, start: float) -> list:
    out, prev = [], start
    for a, b in trace.busy_intervals():
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    return out


def _book_idle(trace, spans_by_tid: dict) -> dict:
    steps = trace.ranges(STEP_RANGE)
    if not steps:
        return {}
    tid = steps[0].tid
    idle = _idle_intervals(trace, min(s.ts for s in steps))
    ranges = spans_by_tid.get(tid, [])
    cuts = sorted({t for a, b in idle for t in (a, b)}
                  | {t for r in ranges for t in (r.ts, r.end)})
    pieces = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
    hits = innermost(ranges, [(a + b) / 2 for a, b in pieces])
    out: dict = defaultdict(float)
    j = 0
    for (a, b), r in zip(pieces, hits):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a:
            out[_name(r)] += b - a
    return dict(out)


def owners(trace) -> list:
    """Each of ``trace.device``'s operations' innermost span name (None:
    no ``kftpu.*`` range), in order."""
    spans = _by_thread(e for e in trace.host if e.name.startswith(PREFIX))
    sites = [(i, launch.tid, launch.ts) for i, op in enumerate(trace.device)
             if (launch := trace.launch_of(op)) is not None]
    owner = _lookup(spans, sites)
    return [_name(owner.get(i)) for i in range(len(trace.device))]


def book(trace) -> Booked:
    """The trace's device and idle time by innermost ``kftpu.*`` span
    (cached per trace)."""
    if trace in _CACHE:
        return _CACHE[trace]
    spans = [e for e in trace.host if e.name.startswith(PREFIX)]
    device: dict = defaultdict(float)
    for name, op in zip(owners(trace), trace.device):
        device[name] += op.dur
    booked = Booked(dict(device), _book_idle(trace, _by_thread(spans)),
                    frozenset(_name(e) for e in spans))
    _CACHE[trace] = booked
    return booked


def device_ms(run, *names) -> float | None:
    """Device ms a step booked to any of ``names``; None where none of
    them appears in the trace."""
    b = book(run.trace)
    if not b.names & set(names):
        return None
    return sum(b.device_us.get(n, 0.0) for n in names) / 1e3 / run.steps


def idle_ms(run, *names) -> float | None:
    """Device-idle ms a step while the step thread's innermost span was
    any of ``names``; None where none of them appears in the trace."""
    b = book(run.trace)
    if not b.names & set(names):
        return None
    return sum(b.idle_us.get(n, 0.0) for n in names) / 1e3 / run.steps
