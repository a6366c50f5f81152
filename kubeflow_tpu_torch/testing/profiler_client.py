"""A capture client for the TF profiler's gRPC: the request xprof's
``trace()`` (TensorBoard's capture button) sends, on this package's own
HTTP/2 and protobuf code, for machines without ``grpcio`` or xprof.

``capture(addr, logdir, duration_ms)`` asks the server at ``addr``
(``host:port``) for a ``Profile`` as xprof does: the repository root
``<logdir>/plugins/profile``, a session id of the time in
``%Y_%m_%d_%H_%M_%S``, the host name ``<host>_<port>``, the same tools
and options; it retries while the server answers ``empty_trace``, and
returns the path the server wrote the session's ``.xplane.pb`` to.
"""

from __future__ import annotations

import os
import time

from kubeflow_tpu_torch.profiler import h2, wire
from kubeflow_tpu_torch.profiler.server import PROFILE, xplane_path

# What xprof's trace() asks for.
TOOLS = ("trace_viewer", "op_profile", "input_pipeline", "kernel_stats",
         "memory_viewer", "memory_profile", "overview_page", "pod_viewer",
         "tensorflow_stats", "xplane.pb")
MAX_EVENTS = 1000000
# As xprof's trace(): three tries while the server answers empty_trace.
ATTEMPTS = 3
# Seconds a call may take beyond its recording.
TIMEOUT_SEC = 120.0


def profile_request(addr: str, logdir: str, duration_ms: int) -> dict:
    """The ``ProfileRequest`` xprof's ``trace()`` sends to ``addr``."""
    host, _, port = addr.rpartition(":")
    return {
        "duration_ms": duration_ms, "max_events": MAX_EVENTS,
        "tools": list(TOOLS),
        "opts": {"include_dataset_ops": True, "host_tracer_level": 2,
                 "device_tracer_level": 1, "version": 1,
                 "enable_hlo_proto": True,
                 "start_timestamp_ns": time.time_ns(),
                 "duration_ms": duration_ms, "repository_path": logdir},
        "repository_root": os.path.join(logdir, "plugins", "profile"),
        "session_id": time.strftime("%Y_%m_%d_%H_%M_%S"),
        "host_name": f"{host}_{port}"}


def capture(addr: str, logdir: str, duration_ms: int) -> str:
    """Capture ``duration_ms`` from the server at ``addr``; the path of
    the ``.xplane.pb`` it wrote. A call's error status raises
    ``h2.GrpcError``; ``ATTEMPTS`` empty traces raise ``RuntimeError``."""
    for _ in range(ATTEMPTS):
        request = profile_request(addr, logdir, duration_ms)
        answer = wire.decode(wire.PROFILE_RESPONSE, h2.unary_call(
            addr, PROFILE, wire.encode(wire.PROFILE_REQUEST, request),
            timeout=TIMEOUT_SEC + duration_ms / 1e3))
        if not answer.get("empty_trace"):
            return xplane_path(request)
    raise RuntimeError(f"{ATTEMPTS} captures from {addr} came back empty")
