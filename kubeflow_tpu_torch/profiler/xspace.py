"""One ``torch.profiler`` session's results as an ``XSpace``, the file the
TF profiler's capture writes and xprof (TensorBoard's profile plugin)
reads.

The source is kineto's own trace (``export_chrome_trace``), which holds
everything CUPTI delivered: its device activities are process-wide, so
kernels that another thread launched are kept whatever thread the session
ran in. Every timestamp there is microseconds after the trace's
``baseTimeNanoseconds`` on the host's wall clock (the device's clock
already mapped onto it).

- ``/host:CPU``: a line a thread (its id and kineto's name for it) with
  the ops, ``record_function`` ranges, Python frames and CUDA API calls
  the session recorded, each API call with its ``correlation_id``;
- ``/device:GPU:<ordinal>``: a line a stream (``Stream #<id>``) with the
  kernels, copies and memsets under CUPTI's names; each with its
  ``correlation_id``, a kernel with ``kernel_details`` in TSL's syntax
  (``regs:<n> grid:<x>,<y>,<z> block:<x>,<y>,<z>``, what torch reports), a
  copy or memset with its ``bytes``;
- ``Task Environment``: the session's ``profile_start_time`` and
  ``profile_stop_time`` (ns on the same clock), as TSL writes them;
- ``hostnames``: this host.

A line's ``timestamp_ns`` is its first event's start in absolute ns, the
events' ``offset_ps`` count from there, as xprof's trace viewer lays them
out.
"""

from __future__ import annotations

DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
# Spans kineto draws over other events: the session itself, and the
# record_function ranges copied onto the device's streams.
SKIPPED_CATEGORIES = frozenset({"Trace", "gpu_user_annotation"})
TASK_ENVIRONMENT = "Task Environment"


class _Plane:
    def __init__(self, name: str):
        self.id = 0                  # its place among the planes, at the end
        self.name = name
        self.lines: dict = {}        # line id -> [name, [(start ns, ...)]]
        self.event_ids: dict = {}    # event name -> metadata id
        self.stat_ids: dict = {}     # stat name -> metadata id
        self.stats: list = []

    def event_id(self, name: str) -> int:
        return self.event_ids.setdefault(name, len(self.event_ids) + 1)

    def stat_id(self, name: str) -> int:
        return self.stat_ids.setdefault(name, len(self.stat_ids) + 1)

    def add(self, line: int, line_name: str, start_ns: int, dur_ns: int,
            name: str, stats: list) -> None:
        entry = self.lines.setdefault(line, [line_name, []])
        entry[1].append((start_ns, dur_ns, self.event_id(name), stats))

    def to_message(self) -> dict:
        lines = []
        for line_id in sorted(self.lines):
            line_name, events = self.lines[line_id]
            events.sort(key=lambda e: e[0])
            first = events[0][0]
            last = max(start + dur for start, dur, _, _ in events)
            lines.append({
                "id": line_id, "display_id": line_id, "name": line_name,
                "timestamp_ns": first, "duration_ps": (last - first) * 1000,
                "events": [{"metadata_id": meta,
                            "offset_ps": (start - first) * 1000,
                            "duration_ps": dur * 1000,
                            **({"stats": stats} if stats else {})}
                           for start, dur, meta, stats in events]})
        return {
            "id": self.id, "name": self.name, "lines": lines,
            "event_metadata": {i: {"id": i, "name": name}
                               for name, i in self.event_ids.items()},
            "stat_metadata": {i: {"id": i, "name": name}
                              for name, i in self.stat_ids.items()},
            **({"stats": self.stats} if self.stats else {})}


def _kernel_details(args: dict) -> str | None:
    parts = []
    if "registers per thread" in args:
        parts.append(f"regs:{args['registers per thread']}")
    for key in ("grid", "block"):
        dims = args.get(key)
        if dims:
            parts.append(f"{key}:{','.join(str(int(d)) for d in dims)}")
    return " ".join(parts) or None


def from_chrome_trace(trace: dict, *, hostname: str, start_ns: int,
                      stop_ns: int) -> dict:
    """The ``XSpace`` (a ``wire.XSPACE`` message) of kineto's trace
    ``trace`` (its JSON, parsed), recorded on ``hostname`` between
    ``start_ns`` and ``stop_ns`` (wall-clock ns)."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    threads = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            threads[ev.get("tid")] = str(ev.get("args", {}).get("name", ""))
    host = _Plane("/host:CPU")
    devices: dict = {}
    for ev in trace.get("traceEvents", ()):
        category = ev.get("cat")
        if ev.get("ph") != "X" or category in SKIPPED_CATEGORIES:
            continue
        args = ev.get("args") or {}
        start = base + round(float(ev["ts"]) * 1000)
        dur = round(float(ev.get("dur", 0)) * 1000)
        if category in DEVICE_CATEGORIES:
            ordinal = int(args.get("device", ev.get("pid", 0)))
            plane = devices.get(ordinal)
            if plane is None:
                plane = devices[ordinal] = _Plane(f"/device:GPU:{ordinal}")
            stream = int(args.get("stream", ev.get("tid", 0)))
            stats = []
            if "correlation" in args:
                stats.append({"metadata_id": plane.stat_id("correlation_id"),
                              "int64_value": int(args["correlation"])})
            details = (_kernel_details(args) if category == "kernel"
                       else None)
            if details:
                stats.append({"metadata_id": plane.stat_id("kernel_details"),
                              "str_value": details})
            if "bytes" in args:
                stats.append({"metadata_id": plane.stat_id("bytes"),
                              "uint64_value": int(args["bytes"])})
            plane.add(stream, f"Stream #{stream}", start, dur, ev["name"],
                      stats)
        else:
            tid = ev.get("tid")
            if not isinstance(tid, int):
                continue
            stats = []
            if "correlation" in args:
                stats.append({"metadata_id": host.stat_id("correlation_id"),
                              "int64_value": int(args["correlation"])})
            host.add(tid, threads.get(tid) or str(tid), start, dur,
                     ev["name"], stats)
    env = _Plane(TASK_ENVIRONMENT)
    env.stats = [
        {"metadata_id": env.stat_id("profile_start_time"),
         "uint64_value": start_ns},
        {"metadata_id": env.stat_id("profile_stop_time"),
         "uint64_value": stop_ns}]
    planes = [host] + [devices[k] for k in sorted(devices)] + [env]
    for plane_id, plane in enumerate(planes):
        plane.id = plane_id
    return {"planes": [plane.to_message() for plane in planes],
            "hostnames": [hostname]}


def is_empty(space: dict) -> bool:
    """No event on any line of any plane (TSL's ``IsEmpty``)."""
    return not any(line.get("events") for plane in space.get("planes", ())
                   for line in plane.get("lines", ()))
