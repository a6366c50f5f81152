"""``tensorflow.ProfilerService`` over ``torch.profiler``: the target of
TensorBoard's profile-plugin capture button.

The port of what ``jax.profiler.start_server`` runs (TSL's
``ProfilerServiceImpl``, in C++ inside jaxlib), in Python on this
package's HTTP/2 (``h2``) and protobuf (``wire``) code:

- ``Profile`` takes the one session the process may have (a second
  ``Profile`` while it runs fails with INTERNAL, "Another profiling
  session active.", as TSL's does), waits for ``opts.start_timestamp_ns``
  when it lies ahead, records ``opts.duration_ms`` (else the request's
  ``duration_ms``) with ``torch.profiler`` (CPU and CUDA activities on
  the card, CPU only for ``device="cpu"``), ends early on ``Terminate``
  for its ``session_id`` or when the client cancels, turns the session
  into an ``XSpace`` (``xspace``), writes it where TSL's server writes it,
  ``<repository_root>/<session_id>/<host_name>.xplane.pb``, and answers
  ``empty_trace``;
- ``Terminate`` ends the running session of its ``session_id``;
- every other method (``Monitor``, the continuous-profiling calls)
  answers UNIMPLEMENTED.

What the planes hold. CUPTI's activity records are process-wide, so on
the card the device plane has every kernel, copy and memset of the
window and the host plane every thread's CUDA runtime calls, whatever
thread launched them. torch's op recording is per thread: on the card
the host plane has the ops of the server's own thread only, not the
notebook's ``aten`` ops. The mode that records every thread
(``_ExperimentalConfig(profile_all_threads=True)``) is used on the CPU
alone, where the ops are all there is to record: on the card (torch
2.11; PERF.md §6) a session in that mode, and every session after it in
the process, at times came back without a single device record, and
losing the card's kernels would lose what the capture is for.

The server trusts the request's paths as TSL's does: it listens on
every interface and writes to ``repository_root``, ``session_id`` and
``host_name`` as the client gives them, so any client that reaches the
port may write an ``.xplane.pb`` wherever the process may write.

Like every entry point of the port, the server runs on the card unless
asked for the CPU: ``device=None`` without a card raises.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
import time

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.profiler import h2, wire, xspace

SERVICE = "/tensorflow.ProfilerService/"
PROFILE = SERVICE + "Profile"
TERMINATE = SERVICE + "Terminate"
# TSL's ProfilerLock message.
SESSION_ACTIVE = "Another profiling session active."

# Process-wide, as what they guard is: torch.profiler (kineto) records one
# session a process, and the process has one server, as jaxlib's
# start_server allows one.
_SESSION = threading.Lock()
_SERVER_LOCK = threading.Lock()
_running: "ProfilerServer | None" = None


def _profile_session(device):
    """A ``torch.profiler.profile``, not started: the host and the card's
    activities on the card, every thread's ops on the CPU (module
    docstring)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if device.type == "cuda":
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    return profile(activities=[ProfilerActivity.CPU], experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))


def xplane_path(request: dict) -> str:
    """Where TSL's server writes a session's ``XSpace``: the client's
    ``host_name`` with ``:`` read as ``_`` (``localhost:9999`` →
    ``localhost_9999.xplane.pb``)."""
    host = request.get("host_name", "").replace(":", "_")
    return os.path.join(request.get("repository_root", ""),
                        request.get("session_id", ""), f"{host}.xplane.pb")


class ProfilerServer:
    """The profiler service on ``port`` (0: a free one, read back from
    ``port``), every interface, for the card (``device=None``) or the CPU
    (``device="cpu"``). One a process: a second raises ``ValueError``
    until the first is closed (``close()``)."""

    def __init__(self, port: int, *, device=None):
        global _running
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._stops: dict = {}
        with _SERVER_LOCK:
            if _running is not None:
                raise ValueError("a profiler server already runs in this "
                                 f"process, on port {_running.port}")
            self._server = h2.Server(port, {PROFILE: self._profile,
                                            TERMINATE: self._terminate})
            self.port = self._server.port
            _running = self

    def close(self) -> None:
        global _running
        self._server.close()
        with _SERVER_LOCK:
            if _running is self:
                _running = None

    def __enter__(self) -> "ProfilerServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _stop_signal(self, session_id: str) -> threading.Event:
        with self._lock:
            return self._stops.setdefault(session_id, threading.Event())

    def _terminate(self, body: bytes, call: h2.Call) -> bytes:
        request = _decode(wire.TERMINATE_REQUEST, body)
        self._stop_signal(request.get("session_id", "")).set()
        return wire.encode(wire.TERMINATE_RESPONSE, {})

    def _profile(self, body: bytes, call: h2.Call) -> bytes:
        request = _decode(wire.PROFILE_REQUEST, body)
        opts = request.get("opts", {})
        duration_ms = opts.get("duration_ms") or request.get("duration_ms", 0)
        session_id = request.get("session_id", "")
        if not _SESSION.acquire(blocking=False):
            raise h2.GrpcError(h2.INTERNAL, SESSION_ACTIVE)
        stop = self._stop_signal(session_id)
        try:
            ahead = opts.get("start_timestamp_ns", 0) - time.time_ns()
            if ahead > 0:
                _wait(stop, call, ahead / 1e9)
            space = self._record(duration_ms, stop, call)
        finally:
            with self._lock:
                self._stops.pop(session_id, None)
            _SESSION.release()
        path = xplane_path(request)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(wire.encode(wire.XSPACE, space))
        return wire.encode(wire.PROFILE_RESPONSE,
                           {"empty_trace": xspace.is_empty(space)})

    def _record(self, duration_ms: int, stop: threading.Event,
                call: h2.Call) -> dict:
        """``duration_ms`` of ``torch.profiler`` (less if stopped), as an
        ``XSpace``."""
        session = _profile_session(self.device)
        start_ns = time.time_ns()
        try:
            session.start()
        except RuntimeError as exc:      # another torch.profiler is running
            raise h2.GrpcError(h2.INTERNAL, str(exc)) from exc
        try:
            _wait(stop, call, duration_ms / 1e3)
        finally:
            session.stop()
            stop_ns = time.time_ns()
        if call.cancelled.is_set():
            raise h2.GrpcError(h2.CANCELLED, "the client cancelled")
        with tempfile.TemporaryDirectory(prefix="kftpu-profile-") as tmp:
            trace = os.path.join(tmp, "trace.json")
            session.export_chrome_trace(trace)
            with open(trace) as f:
                raw = json.load(f)
        return xspace.from_chrome_trace(raw, hostname=socket.gethostname(),
                                        start_ns=start_ns, stop_ns=stop_ns)


def _decode(schema: dict, body: bytes) -> dict:
    try:
        return wire.decode(schema, body)
    except (wire.DecodeError, UnicodeDecodeError) as exc:
        raise h2.GrpcError(h2.INVALID_ARGUMENT, str(exc)) from exc


def _wait(stop: threading.Event, call: h2.Call, seconds: float) -> None:
    """Sleep ``seconds``, or less once ``stop`` or the call's cancellation
    is set (checked every millisecond, as TSL's server does)."""
    deadline = time.monotonic() + seconds
    while not (stop.is_set() or call.cancelled.is_set()):
        left = deadline - time.monotonic()
        if left <= 0:
            return
        stop.wait(min(left, 1e-3))
