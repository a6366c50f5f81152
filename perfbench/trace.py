"""Reading a ``torch.profiler`` trace (its Chrome trace events) of a few
steps: the device's operations and their intervals, which host range
launched each kernel, and the idle gaps.

A kernel is tied to the host by its ``correlation`` id: the CUDA runtime
or driver call that launched it carries the same id, on the host thread
and at the host time of the launch. A kernel belongs to a host range
(``record_function``) when its launch lies inside that range.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation")

# Kernels by what they do, from their names (lower case). cuBLAS's GEMMs
# on Hopper are ``nvjet_*`` or CUTLASS/xmma templates, with split-K
# reductions beside them.
GEMM_KEYS = ("nvjet", "gemm", "cutlass", "xmma", "splitkreduce", "cublas")
# The port's flash-attention kernels (ops/csrc/*.cu), by the function name
# at the start of the kernel's name.
ATTENTION_KERNELS = {
    "fwd": re.compile(r"(?<![A-Za-z_])fwd_bf16_kernel\b"),
    "dq": re.compile(r"(?<![A-Za-z_])dq_bf16_kernel\b"),
    "dkv": re.compile(r"(?<![A-Za-z_])dkv_bf16_kernel\b"),
}
FOREACH_KEY = "multi_tensor_apply"
# NCCL's kernels (``ncclDevKernel_*``, ``ncclKernel_*``): the collectives
# between the cards.
COLLECTIVE_KEY = "nccl"
STEP_RANGE = "perfbench.step"
OPTIMIZER_RANGE = "perfbench.optimizer"
INPUT_RANGE = "perfbench.input"


@dataclass(frozen=True)
class Event:
    name: str
    ts: float          # microseconds, the trace's clock
    dur: float
    tid: object = None
    correlation: int | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(key in low for key in GEMM_KEYS)


def is_collective(name: str) -> bool:
    return COLLECTIVE_KEY in name.lower()


def attention_kind(name: str) -> str | None:
    for kind, pattern in ATTENTION_KERNELS.items():
        if pattern.search(name):
            return kind
    return None


def optimizer_kernels(trace: "Trace") -> list:
    """The optimizer's kernels: those launched inside the host range
    ``perfbench.optimizer``; where no kernel is (an update inside the
    program's step, as the burn-in step's SGD), the foreach kernels each
    step launches after its last dK/dV kernel. (The backward's kernels
    are launched from autograd's own thread: a step holds the launches
    of any thread within its time.)"""
    ranged = trace.launched_in(OPTIMIZER_RANGE)
    if ranged:
        return ranged
    out = []
    for step in trace.ranges(STEP_RANGE):
        inside = [(k, launch) for k in trace.kernels
                  if (launch := trace.launch_of(k)) is not None
                  and step.ts <= launch.ts <= step.end]
        last = max((launch.ts for k, launch in inside
                    if attention_kind(k.name) == "dkv"), default=None)
        if last is not None:
            out += [k for k, launch in inside
                    if launch.ts > last and FOREACH_KEY in k.name]
    return out


class Trace:
    """The events of one traced stretch."""

    def __init__(self, trace_events: list):
        self.device: list[Event] = []
        self.kernels: list[Event] = []
        self.launches: dict[int, Event] = {}
        self.host: list[Event] = []
        for ev in trace_events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            args = ev.get("args") or {}
            item = Event(ev.get("name", ""), float(ev["ts"]),
                         float(ev.get("dur", 0.0)), ev.get("tid"),
                         args.get("correlation"))
            if cat in DEVICE_CATEGORIES:
                self.device.append(item)
                if cat == "kernel":
                    self.kernels.append(item)
            elif cat in LAUNCH_CATEGORIES and item.correlation is not None:
                self.launches[item.correlation] = item
            elif cat in HOST_CATEGORIES:
                self.host.append(item)
        self.device.sort(key=lambda e: e.ts)
        self.kernels.sort(key=lambda e: e.ts)
        self.host.sort(key=lambda e: (e.ts, -e.dur))

    def ranges(self, name: str) -> list[Event]:
        return [e for e in self.host if e.name == name]

    def launch_of(self, op: Event) -> Event | None:
        return self.launches.get(op.correlation)

    def launched_in(self, name: str) -> list[Event]:
        """Kernels whose launch lies inside a host range named ``name``
        on the launching thread."""
        spans = self.ranges(name)
        out = []
        for k in self.kernels:
            launch = self.launch_of(k)
            if launch is not None and any(
                    s.tid == launch.tid and s.ts <= launch.ts <= s.end
                    for s in spans):
                out.append(k)
        return out

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's operation intervals, merged."""
        merged: list[list[float]] = []
        for e in self.device:
            if merged and e.ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end)
            else:
                merged.append([e.ts, e.end])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def host_context(self, launch: Event | None) -> str:
        """The innermost host op around a launch, under the innermost
        ``perfbench.*`` range around it."""
        if launch is None:
            return "unknown"
        inner, outer = None, None
        i = bisect.bisect_right(self.host, launch.ts, key=lambda e: e.ts)
        for e in self.host[:i]:
            if e.tid != launch.tid or not e.ts <= launch.ts <= e.end:
                continue
            if e.name.startswith("perfbench."):
                outer = e.name
            else:
                inner = e.name
        return " > ".join(n for n in (outer, inner) if n) or "no host range"

    def idle_gaps(self, start_us: float, limit: int = 10) -> list:
        """The longest stretches with no device operation after
        ``start_us`` (the stretch's first step), each named by the host
        op that launched the operation ending it: ``[name, seconds]``."""
        gaps = []
        prev_end = start_us
        first = {e.ts: e for e in reversed(self.device)}
        for a, b in self.busy_intervals():
            if a > prev_end:
                gaps.append((a - prev_end, first[a]))
            prev_end = max(prev_end, b)
        gaps.sort(key=lambda g: -g[0])
        return [[self.host_context(self.launch_of(op)), us / 1e6]
                for us, op in gaps[:limit]]

    def top_ops(self, limit: int = 10) -> list:
        """The device operations that took most time: ``[name, seconds]``,
        summed by name."""
        total: dict[str, float] = {}
        for e in self.device:
            total[e.name] = total.get(e.name, 0.0) + e.dur
        top = sorted(total.items(), key=lambda kv: -kv[1])[:limit]
        return [[name[:160], us / 1e6] for name, us in top]
