"""The port's live profiler server (``kubeflow_tpu_torch.profiler``,
``sdk.start_profiler_server``) against the reference's
(``jax.profiler.start_server``, TSL's server inside jaxlib).

The yardsticks are the real clients and formats: xprof's own C++ capture
client (``_pywrap_profiler_plugin.trace``, what TensorBoard's capture
button runs) and its converter to trace-viewer JSON, grpcio's generic
client, and tensorflow's ``xplane_pb2`` with protobuf. Each is imported
with ``pytest.importorskip``; the port itself imports none of them. The
reference's server runs in a subprocess (one JAX server a process:
``tests/test_sdk.py`` starts one in whichever worker runs it). Everything
of the port runs with ``device="cpu"``.
"""

import ast
import logging
import os
import re
import select
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import pytest
import torch

from kubeflow_tpu import sdk as jax_sdk
from kubeflow_tpu_torch import sdk
from kubeflow_tpu_torch.profiler import h2, server, wire, xspace
from kubeflow_tpu_torch.profiler.server import ProfilerServer
from kubeflow_tpu_torch.testing import profiler_client

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# <logdir>/plugins/profile/<session>/<host>_<port>.xplane.pb, as xprof's
# client and TSL's server lay a capture out.
CAPTURE_PATH = re.compile(r"plugins/profile/\d{4}_\d\d_\d\d_\d\d_\d\d_\d\d/"
                          r"localhost_(\d+)\.xplane\.pb")

JAX_SERVER = r"""
import sys, time
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
jax.profiler.start_server(int(sys.argv[1]))
print("ready", flush=True)
x = jnp.ones((32, 32))
while True:              # a little work for each capture to record
    x = (x @ x) * 1e-3
    x.block_until_ready()
    time.sleep(0.02)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_server():
    """The reference's server in a process of its own, doing JAX work."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SERVER, str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready and proc.stdout.readline().strip() == "ready"
        yield f"localhost:{port}"
    finally:
        proc.kill()
        proc.wait(30)


@pytest.fixture
def torch_work():
    """A thread doing small torch work, as a notebook's loop would."""
    stop = threading.Event()

    def run():
        a = torch.randn(16, 16)
        while not stop.is_set():
            torch.mm(a, a)
            stop.wait(0.005)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield
    stop.set()
    thread.join(10)
    assert not thread.is_alive()


@pytest.fixture
def port_server(torch_work):
    with ProfilerServer(0, device="cpu") as srv:
        yield srv


def _xprof():
    return pytest.importorskip("xprof.convert._pywrap_profiler_plugin")


def _trace_viewer(path: str) -> dict:
    import json

    data = _xprof().xspace_to_tools_data([path], "trace_viewer@", {})[0]
    return json.loads(data)


def _captures(logdir) -> list:
    return sorted(str(p.relative_to(logdir)) for p in
                  Path(logdir).rglob("*.xplane.pb"))


# ---- xprof's client, against both servers ------------------------------------


def test_xprof_trace_lands_and_converts_from_both_servers(
        jax_server, port_server, tmp_path):
    xprof = _xprof()
    for name, addr in (("jax", jax_server),
                       ("port", f"localhost:{port_server.port}")):
        logdir = tmp_path / name
        xprof.trace(addr, str(logdir), "", True, 300, 3, {})
        (found,) = _captures(logdir)
        match = CAPTURE_PATH.fullmatch(found)
        assert match and match.group(1) == addr.rpartition(":")[2], found
        trace = _trace_viewer(str(logdir / found))
        names = {ev.get("args", {}).get("name") for ev in trace["traceEvents"]
                 if ev.get("name") == "process_name"}
        assert any(n and n.endswith("/host:CPU") for n in names), names
        assert any(ev.get("ph") == "X" for ev in trace["traceEvents"])
    port_ops = {ev["name"] for ev in trace["traceEvents"]
                if ev.get("ph") == "X"}
    # The notebook thread's ops, recorded from the server's own thread.
    assert "aten::mm" in port_ops


def test_xprof_sends_what_the_port_client_sends(port_server, tmp_path):
    """The request xprof's client puts on the wire decodes with ``wire``,
    re-encodes to the same bytes (its fields are in canonical order) and
    is the request ``profiler_client`` builds, timestamps aside."""
    xprof = _xprof()
    seen = []
    handler = port_server._server.handlers[server.PROFILE]

    def recording(body, call):
        seen.append((bytes(body), dict(call.headers)))
        return handler(body, call)

    port_server._server.handlers[server.PROFILE] = recording
    addr = f"localhost:{port_server.port}"
    xprof.trace(addr, str(tmp_path), "", True, 100, 3, {})
    raw, headers = seen[0]
    got = wire.decode(wire.PROFILE_REQUEST, raw)
    assert wire.encode(wire.PROFILE_REQUEST, got) == raw
    assert headers[":path"] == server.PROFILE
    assert headers["content-type"] == "application/grpc"
    want = profiler_client.profile_request(addr, str(tmp_path), 100)
    for request in (got, want):
        request["opts"].pop("start_timestamp_ns")
        request.pop("session_id")
        request.pop("host_name")
    assert got == want


# ---- the port's client --------------------------------------------------------


def test_port_client_captures_from_the_jax_server(jax_server, tmp_path):
    xplane_pb2 = pytest.importorskip(
        "tensorflow.tsl.profiler.protobuf.xplane_pb2")
    path = profiler_client.capture(jax_server, str(tmp_path), 300)
    assert os.path.exists(path)
    assert CAPTURE_PATH.fullmatch(str(Path(path).relative_to(tmp_path)))
    raw = Path(path).read_bytes()
    got = wire.decode(wire.XSPACE, raw)
    want = xplane_pb2.XSpace.FromString(raw)
    assert [p["name"] for p in got["planes"]] == [p.name for p in want.planes]
    assert "/host:CPU" in [p["name"] for p in got["planes"]]
    assert got["hostnames"] == list(want.hostnames)
    # wire's encoding of what it decoded is the same message.
    assert xplane_pb2.XSpace.FromString(wire.encode(wire.XSPACE, got)) == want


def test_port_client_captures_from_the_port(port_server, tmp_path):
    path = profiler_client.capture(f"localhost:{port_server.port}",
                                   str(tmp_path), 200)
    space = wire.decode(wire.XSPACE, Path(path).read_bytes())
    planes = {p["name"]: p for p in space["planes"]}
    assert set(planes) == {"/host:CPU", xspace.TASK_ENVIRONMENT}
    assert space["hostnames"] == [socket.gethostname()]
    env = planes[xspace.TASK_ENVIRONMENT]
    names = {m["id"]: m["name"] for m in env["stat_metadata"].values()}
    window = {names[s["metadata_id"]]: s["uint64_value"]
              for s in env["stats"]}
    assert 0 < window["profile_stop_time"] - window["profile_start_time"]
    host = planes["/host:CPU"]
    ops = {m["name"] for m in host["event_metadata"].values()}
    assert "aten::mm" in ops
    for line in host["lines"]:
        start = line["timestamp_ns"]
        assert window["profile_start_time"] <= start + 10**6
        for ev in line["events"]:
            end = start + (ev.get("offset_ps", 0)
                           + ev.get("duration_ps", 0)) // 1000
            assert end <= window["profile_stop_time"]


# ---- wire against protobuf ----------------------------------------------------


def _service_classes():
    """``ProfileRequest`` and friends as protobuf classes, from the field
    numbers of TSL's ``profiler_service.proto`` (tensorflow ships the
    options and XPlane modules, not the service's)."""
    pytest.importorskip("google.protobuf")
    from google.protobuf import (descriptor_pb2, descriptor_pool,
                                 message_factory)
    opts_pb2 = pytest.importorskip(
        "tensorflow.tsl.profiler.protobuf.profiler_options_pb2")
    xplane_pb2 = pytest.importorskip(
        "tensorflow.tsl.profiler.protobuf.xplane_pb2")
    F = descriptor_pb2.FieldDescriptorProto
    pool = descriptor_pool.DescriptorPool()
    for module in (opts_pb2, xplane_pb2):
        proto = descriptor_pb2.FileDescriptorProto()
        module.DESCRIPTOR.CopyToProto(proto)
        pool.Add(proto)
    f = descriptor_pb2.FileDescriptorProto(
        name="profiler_service_fields.proto", package="tensorflow",
        syntax="proto3", dependency=[opts_pb2.DESCRIPTOR.name,
                                     xplane_pb2.DESCRIPTOR.name])

    def message(name, fields, nested=()):
        m = f.message_type.add(name=name)
        for fname, number, ftype, label, type_name in fields:
            m.field.add(name=fname, number=number, type=ftype, label=label,
                        **({"type_name": type_name} if type_name else {}))
        for entry in nested:
            m.nested_type.append(entry)
        return m

    one, many = F.LABEL_OPTIONAL, F.LABEL_REPEATED
    message("ToolRequestOptions", [
        ("output_formats", 2, F.TYPE_STRING, one, None),
        ("save_to_repo", 3, F.TYPE_BOOL, one, None)])
    entry = descriptor_pb2.DescriptorProto(name="ToolOptionsEntry")
    entry.options.map_entry = True
    entry.field.add(name="key", number=1, type=F.TYPE_STRING, label=one)
    entry.field.add(name="value", number=2, type=F.TYPE_MESSAGE, label=one,
                    type_name=".tensorflow.ToolRequestOptions")
    message("ProfileRequest", [
        ("duration_ms", 1, F.TYPE_UINT64, one, None),
        ("max_events", 2, F.TYPE_UINT64, one, None),
        ("tools", 3, F.TYPE_STRING, many, None),
        ("opts", 4, F.TYPE_MESSAGE, one,
         f".{opts_pb2.ProfileOptions.DESCRIPTOR.full_name}"),
        ("repository_root", 5, F.TYPE_STRING, one, None),
        ("session_id", 6, F.TYPE_STRING, one, None),
        ("host_name", 7, F.TYPE_STRING, one, None),
        ("tool_options", 8, F.TYPE_MESSAGE, many,
         ".tensorflow.ProfileRequest.ToolOptionsEntry"),
        ("emit_xspace", 9, F.TYPE_BOOL, one, None)], nested=[entry])
    message("ProfileToolData", [("name", 1, F.TYPE_STRING, one, None),
                                ("data", 2, F.TYPE_BYTES, one, None)])
    message("ProfileResponse", [
        ("tool_data", 6, F.TYPE_MESSAGE, many, ".tensorflow.ProfileToolData"),
        ("empty_trace", 7, F.TYPE_BOOL, one, None),
        ("xspace", 8, F.TYPE_MESSAGE, one,
         f".{xplane_pb2.XSpace.DESCRIPTOR.full_name}")])
    message("TerminateRequest", [("session_id", 1, F.TYPE_STRING, one,
                                  None)])
    message("TerminateResponse", [])
    pool.Add(f)
    return {name: message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"tensorflow.{name}"))
        for name in ("ProfileRequest", "ProfileResponse", "TerminateRequest",
                     "TerminateResponse")}


def _sample_space() -> dict:
    """An XSpace with every field kind: negative ids, packed repeated
    int64, maps, doubles, bytes, each XStat value, each member of
    XEvent's ``data`` oneof (``offset_ps`` at 0, which is still written)."""
    return {
        "planes": [{
            "id": 1, "name": "/device:GPU:0",
            "lines": [{"id": -2750531983681840765, "display_id": 7,
                       "name": "Stream #7", "display_name": "compute",
                       "timestamp_ns": 1792314312255724719,
                       "duration_ps": 123000,
                       "events": [{"metadata_id": 1, "num_occurrences": 2},
                                  {"metadata_id": 1, "offset_ps": 0,
                                   "duration_ps": 55552000,
                                   "stats": [
                                       {"metadata_id": 1, "int64_value": -9},
                                       {"metadata_id": 2,
                                        "str_value": "regs:224"},
                                       {"metadata_id": 3,
                                        "double_value": 0.25},
                                       {"metadata_id": 4,
                                        "uint64_value": 1 << 63},
                                       {"metadata_id": 5,
                                        "bytes_value": b"\x00\xff"},
                                       {"metadata_id": 6, "ref_value": 3}]}]}],
            "event_metadata": {1: {"id": 1, "name": "fwd_bf16_kernel",
                                   "display_name": "fwd",
                                   "metadata": b"\x01\x02",
                                   "stats": [{"metadata_id": 2,
                                              "str_value": "x"}],
                                   "child_id": [3, -4, 5]}},
            "stat_metadata": {i: {"id": i, "name": f"stat{i}",
                                  "description": "d"} for i in range(1, 7)},
            "stats": [{"metadata_id": 1, "int64_value": 1}]}],
        "errors": ["e1"], "warnings": ["w1", "w2"], "hostnames": ["vm"]}


def test_wire_xspace_round_trips_through_xplane_pb2():
    xplane_pb2 = pytest.importorskip(
        "tensorflow.tsl.profiler.protobuf.xplane_pb2")
    space = _sample_space()
    message = xplane_pb2.XSpace.FromString(wire.encode(wire.XSPACE, space))
    assert message.planes[0].lines[0].id == -2750531983681840765
    assert list(message.planes[0].event_metadata[1].child_id) == [3, -4, 5]
    assert [e.WhichOneof("data") for e in message.planes[0].lines[0].events
            ] == ["num_occurrences", "offset_ps"]
    assert wire.decode(wire.XSPACE,
                       message.SerializeToString(deterministic=True)) == space
    # Without maps, the bytes are protobuf's own.
    line = space["planes"][0]["lines"][0]
    assert (wire.encode(wire.XLINE, line)
            == message.planes[0].lines[0].SerializeToString())
    assert (wire.encode(wire.XSPACE, {**space, "planes": []})
            == xplane_pb2.XSpace(errors=["e1"], warnings=["w1", "w2"],
                                 hostnames=["vm"]).SerializeToString())


def test_wire_profile_request_matches_protobuf():
    classes = _service_classes()
    request = profiler_client.profile_request("localhost:9999", "/logs", 500)
    message = classes["ProfileRequest"]()
    message.ParseFromString(wire.encode(wire.PROFILE_REQUEST, request))
    assert message.opts.duration_ms == 500
    assert message.host_name == "localhost_9999"
    assert wire.encode(wire.PROFILE_REQUEST,
                       request) == message.SerializeToString()
    # Maps and unknown fields, as protobuf writes them.
    message.tool_options["trace_viewer"].output_formats = "json"
    message.opts.advanced_configuration["tpu_trace_mode"].string_value = "x"
    message.emit_xspace = True
    got = wire.decode(wire.PROFILE_REQUEST, message.SerializeToString())
    assert got["tool_options"] == {"trace_viewer": {"output_formats": "json"}}
    assert got["opts"]["advanced_configuration"] == {
        "tpu_trace_mode": {"string_value": "x"}}
    assert got["emit_xspace"] is True
    response = classes["ProfileResponse"](empty_trace=True)
    assert wire.encode(wire.PROFILE_RESPONSE, {"empty_trace": True}) == \
        response.SerializeToString()
    unknown = response.SerializeToString() + b"\x98\x06\x01"   # field 99
    assert wire.decode(wire.PROFILE_RESPONSE, unknown) == {
        "empty_trace": True}
    terminate = classes["TerminateRequest"](session_id="s1")
    assert wire.encode(wire.TERMINATE_REQUEST, {"session_id": "s1"}) == \
        terminate.SerializeToString()


# ---- grpcio's generic client ---------------------------------------------------


def _grpc():
    return pytest.importorskip("grpc")


def _until_recording(timeout: float = 60.0) -> None:
    """Wait until the port's server holds its session (a Profile records)."""
    deadline = time.monotonic() + timeout
    while not server._SESSION.locked():
        assert time.monotonic() < deadline, "no session started"
        time.sleep(0.01)


def _request(tmp_path, duration_ms: int, session: str) -> bytes:
    request = profiler_client.profile_request("localhost:1", str(tmp_path),
                                              duration_ms)
    request["session_id"] = session
    return wire.encode(wire.PROFILE_REQUEST, request)


def test_grpcio_calls_profile_terminate_and_an_unknown_method(
        port_server, tmp_path):
    grpc = _grpc()
    with grpc.insecure_channel(f"localhost:{port_server.port}") as channel:
        profile = channel.unary_unary(server.PROFILE)
        terminate = channel.unary_unary(server.TERMINATE)
        answer = wire.decode(wire.PROFILE_RESPONSE,
                             profile(_request(tmp_path, 100, "s1"),
                                     timeout=60))
        assert answer == {}                   # empty_trace false
        assert (tmp_path / "plugins/profile/s1/localhost_1.xplane.pb"
                ).stat().st_size > 0
        # Terminate ends a running session early, which still writes.
        with ThreadPoolExecutor(1) as pool:
            started = time.monotonic()
            running = pool.submit(profile, _request(tmp_path, 30000, "s2"),
                                  timeout=60)
            time.sleep(0.5)
            assert terminate(wire.encode(wire.TERMINATE_REQUEST,
                                         {"session_id": "s2"}),
                             timeout=10) == b""
            assert wire.decode(wire.PROFILE_RESPONSE,
                               running.result(60)) == {}
            assert time.monotonic() - started < 20
        assert (tmp_path / "plugins/profile/s2").is_dir()
        for method in ("/tensorflow.ProfilerService/Monitor",
                       "/tensorflow.ProfilerService/StartContinuousProfiling",
                       "/no.Such/Method"):
            with pytest.raises(grpc.RpcError) as err:
                channel.unary_unary(method)(b"", timeout=10)
            assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_many_calls_at_once_on_one_connection_and_many(port_server):
    """Streams multiplexed on one grpcio connection and connections of
    their own, more than the cores, with a short switch interval: every
    call answered, every connection forgotten once closed."""
    grpc = _grpc()
    addr = f"localhost:{port_server.port}"
    body = wire.encode(wire.TERMINATE_REQUEST, {"session_id": "none"})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with grpc.insecure_channel(addr) as channel:
            terminate = channel.unary_unary(server.TERMINATE)
            futures = [terminate.future(body, timeout=60) for _ in range(64)]
            with ThreadPoolExecutor(2 * (os.cpu_count() or 4)) as pool:
                own = list(pool.map(
                    lambda _: h2.unary_call(addr, server.TERMINATE, body,
                                            timeout=60), range(64)))
            assert [f.result(60) for f in futures] == [b""] * 64
        assert own == [b""] * 64
    finally:
        sys.setswitchinterval(interval)
    deadline = time.monotonic() + 10
    while port_server._server._connections and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not port_server._server._connections


@pytest.mark.parametrize("which", ["jax", "port"])
def test_a_second_concurrent_profile_is_refused(which, request, tmp_path):
    grpc = _grpc()
    if which == "jax":
        addr = request.getfixturevalue("jax_server")
    else:
        addr = f"localhost:{request.getfixturevalue('port_server').port}"
    with grpc.insecure_channel(addr) as channel:
        profile = channel.unary_unary(server.PROFILE)
        with ThreadPoolExecutor(1) as pool:
            first = pool.submit(profile, _request(tmp_path, 3000, "a"),
                                timeout=60)
            if which == "port":
                _until_recording()
            else:                    # the JAX server's state is not ours
                time.sleep(1.0)
            with pytest.raises(grpc.RpcError) as err:
                profile(_request(tmp_path, 100, "b"), timeout=30)
            first.result(60)
    assert err.value.code() == grpc.StatusCode.INTERNAL
    assert err.value.details() == server.SESSION_ACTIVE
    assert not (tmp_path / "plugins/profile/b").exists()


def test_port_client_sees_the_refusal(port_server, tmp_path):
    addr = f"localhost:{port_server.port}"
    with ThreadPoolExecutor(1) as pool:
        first = pool.submit(profiler_client.capture, addr,
                            str(tmp_path / "a"), 1500)
        _until_recording()
        with pytest.raises(h2.GrpcError) as err:
            profiler_client.capture(addr, str(tmp_path / "b"), 100)
        assert os.path.exists(first.result(60))
    assert (err.value.code, err.value.message) == (h2.INTERNAL,
                                                   server.SESSION_ACTIVE)


def test_a_future_start_timestamp_is_honoured(port_server, tmp_path):
    request = profiler_client.profile_request(
        f"localhost:{port_server.port}", str(tmp_path), 100)
    ahead = time.time_ns() + 800_000_000
    request["opts"]["start_timestamp_ns"] = ahead
    h2.unary_call(f"localhost:{port_server.port}", server.PROFILE,
                  wire.encode(wire.PROFILE_REQUEST, request))
    space = wire.decode(wire.XSPACE, Path(
        server.xplane_path(request)).read_bytes())
    env = next(p for p in space["planes"]
               if p["name"] == xspace.TASK_ENVIRONMENT)
    start = next(s["uint64_value"] for s in env["stats"]
                 if env["stat_metadata"][s["metadata_id"]]["name"]
                 == "profile_start_time")
    assert start >= ahead


# ---- HTTP/2 by hand -----------------------------------------------------------


class _RawConnection:
    """A client socket speaking frames as the test writes them."""

    def __init__(self, port: int, settings: bytes = b""):
        self.sock = socket.create_connection(("localhost", port), timeout=30)
        self.rfile = self.sock.makefile("rb")
        self.sock.sendall(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0, settings))
        self.hpack = h2.HpackDecoder()

    def send(self, *frames: bytes) -> None:
        self.sock.sendall(b"".join(frames))

    def read(self) -> tuple:
        kind, flags, sid, payload = h2.read_frame(self.rfile, 1 << 24)
        if kind == h2.SETTINGS and not flags & h2.ACK:
            self.send(h2.frame(h2.SETTINGS, h2.ACK, 0))
        return kind, flags, sid, payload

    def answer(self, sid: int, window: bool = False) -> tuple:
        """(headers, DATA payload sizes, body) of stream ``sid``'s answer."""
        headers, sizes, body = {}, [], b""
        while True:
            kind, flags, got, payload = self.read()
            if got != sid:
                continue
            if kind == h2.HEADERS:
                headers.update(self.hpack.decode(payload))
            elif kind == h2.DATA:
                sizes.append(len(payload))
                body += payload
                if window and payload:
                    self.send(h2.frame(h2.WINDOW_UPDATE, 0, sid,
                                       len(payload).to_bytes(4, "big")))
            if kind in (h2.HEADERS, h2.DATA) and flags & h2.END_STREAM:
                return headers, sizes, body

    def close(self) -> None:
        self.sock.close()


def _literal(name_index: int, value: str) -> bytes:
    """A literal with incremental indexing and an indexed name."""
    return bytes([0x40 | name_index]) + h2._string(value)


def _new_name(name: str, value: str) -> bytes:
    return b"\x40" + h2._string(name) + h2._string(value)


def test_continuation_dynamic_table_and_huffman(port_server):
    conn = _RawConnection(port_server.port)
    try:
        # A table size update, then literals the decoder must index:
        # :path (name 4), content-type (name 31), te (a new name).
        block = (b"\x3f\xe1\x1f" + b"\x83\x86"
                 + _literal(4, server.TERMINATE)
                 + _literal(31, "application/grpc")
                 + _new_name("te", "trailers"))
        empty = h2.grpc_message(b"")
        half = len(block) // 2
        conn.send(h2.frame(h2.HEADERS, 0, 1, block[:5]),
                  h2.frame(h2.CONTINUATION, 0, 1, block[5:half]),
                  h2.frame(h2.CONTINUATION, h2.END_HEADERS, 1, block[half:]),
                  h2.frame(h2.DATA, h2.END_STREAM, 1, empty))
        headers, _, body = conn.answer(1)
        assert headers["grpc-status"] == "0" and body == empty
        # The same call from the dynamic table alone: te (62),
        # content-type (63), :path (64).
        conn.send(h2.frame(h2.HEADERS, h2.END_HEADERS, 3,
                           b"\x83\x86\xc0\xbf\xbe"),
                  h2.frame(h2.DATA, h2.END_STREAM, 3, empty))
        headers, _, body = conn.answer(3)
        assert headers["grpc-status"] == "0" and body == empty
        # A Huffman-coded user-agent (name 58): an error naming it, then
        # GOAWAY, never a guess.
        conn.send(h2.frame(h2.HEADERS, h2.END_HEADERS | h2.END_STREAM, 5,
                           b"\x83\x86\xc0\xbf\xbe\x0f\x2b\x81\xff"))
        headers, _, _ = conn.answer(5)
        assert headers["grpc-status"] == str(h2.UNIMPLEMENTED)
        assert "'user-agent'" in headers["grpc-message"]
        assert "Huffman" in headers["grpc-message"]
        kind, _, _, payload = conn.read()
        while kind != h2.GOAWAY:
            kind, _, _, payload = conn.read()
        assert int.from_bytes(payload[4:8], "big") == h2.COMPRESSION_ERROR
    finally:
        conn.close()


def test_flow_control_and_pings_during_a_capture(port_server, tmp_path):
    # The client's stream window is 2 bytes: the 5-byte answer comes in
    # frames of at most 2, each after a WINDOW_UPDATE.
    conn = _RawConnection(port_server.port, settings=(
        h2.SETTINGS_INITIAL_WINDOW_SIZE.to_bytes(2, "big")
        + (2).to_bytes(4, "big")))
    headers = h2.encode_headers([
        (":method", "POST"), (":scheme", "http"),
        (":path", server.TERMINATE), ("content-type", "application/grpc")])
    try:
        conn.send(h2.frame(h2.HEADERS, h2.END_HEADERS, 1, headers),
                  h2.frame(h2.DATA, h2.END_STREAM, 1, h2.grpc_message(b"")))
        got, sizes, _ = conn.answer(1, window=True)
        assert got["grpc-status"] == "0" and sizes == [2, 2, 1]
        # A one-second capture on stream 3; PINGs are answered meanwhile.
        profile = h2.encode_headers([
            (":method", "POST"), (":scheme", "http"),
            (":path", server.PROFILE), ("content-type", "application/grpc")])
        conn.send(h2.frame(h2.HEADERS, h2.END_HEADERS, 3, profile),
                  h2.frame(h2.DATA, h2.END_STREAM, 3, h2.grpc_message(
                      _request(tmp_path, 1000, "p"))))
        _until_recording()
        conn.send(h2.frame(h2.PING, 0, 0, b"12345678"))
        kind, flags, sid, payload = conn.read()
        while kind != h2.PING:
            assert sid != 3, "the capture answered before the PING"
            kind, flags, sid, payload = conn.read()
        assert flags & h2.ACK and payload == b"12345678"
        got, _, body = conn.answer(3, window=True)
        assert got["grpc-status"] == "0"
        assert wire.decode(wire.PROFILE_RESPONSE,
                           h2.grpc_unframe(body)) == {}
    finally:
        conn.close()


# ---- the server's own rules ---------------------------------------------------


def test_one_server_a_process_and_the_card_unless_asked(monkeypatch):
    with ProfilerServer(0, device="cpu") as first:
        with pytest.raises(ValueError, match="already runs"):
            ProfilerServer(0, device="cpu")
        assert first.port > 0
    ProfilerServer(0, device="cpu").close()       # free again once closed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProfilerServer(0)
    monkeypatch.setattr(sdk, "_profiler_port", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdk.start_profiler_server(_free_port())
    assert sdk._profiler_port is None


def test_the_session_mode_follows_the_device():
    """The card's session records CPU and CUDA activities without the
    every-thread mode (which lost the card's records there); the CPU's
    records every thread, since the ops are all it has."""
    from torch.profiler import ProfilerActivity

    card = server._profile_session(torch.device("cuda"))
    cpu = server._profile_session(torch.device("cpu"))
    assert card.activities == {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    assert card.experimental_config is None
    assert cpu.activities == {ProfilerActivity.CPU}
    assert cpu.experimental_config is not None


def _drive(module, calls, caplog) -> list:
    """(the module's recorded port, its log messages) after each call."""
    steps = []
    for port in calls:
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            if module is sdk:
                module.start_profiler_server(port, device="cpu")
            else:
                module.start_profiler_server(port)
        steps.append((module._profiler_port,
                      [r.getMessage() for r in caplog.records]))
    return steps


@pytest.mark.parametrize("outside", [False, True],
                         ids=["sdk_started", "started_outside"])
def test_sdk_start_profiler_server_matches_the_reference(
        outside, monkeypatch, caplog):
    """Idempotency, the move warning and the ``-1`` sentinel, held to
    ``kubeflow_tpu.sdk`` on the same calls. The reference's server is
    ``jax.profiler.start_server`` stood in for by one that, like jaxlib,
    raises ``ValueError`` when a server already runs in the process."""
    p1, p2 = _free_port(), _free_port()
    started = []

    def jax_start_server(port):
        if outside or started:
            raise ValueError("Only one profiler server can be active.")
        started.append(port)

    monkeypatch.setattr(jax.profiler, "start_server", jax_start_server)
    monkeypatch.setattr(jax_sdk, "_profiler_port", None)
    monkeypatch.setattr(sdk, "_profiler_port", None)
    monkeypatch.setattr(sdk, "_profiler_server", None)
    other = ProfilerServer(0, device="cpu") if outside else None
    try:
        calls = [p1, p1, p2]
        got = _drive(sdk, calls, caplog)
        want = _drive(jax_sdk, calls, caplog)
    finally:
        if sdk._profiler_server is not None:
            sdk._profiler_server.close()
        if other is not None:
            other.close()
    assert got == want
    if outside:
        assert got[0] == (-1, ["profiler server already running; "
                               "reusing it"])
        assert got[1:] == [(-1, []), (-1, [])]
    else:
        assert got == [(p1, []), (p1, []), (p1, [
            f"profiler server already on port {p1}; cannot move to {p2} "
            "(one server per process)"])]


# ---- xspace from kineto's trace ---------------------------------------------


def test_xspace_from_a_card_trace():
    """kineto's trace as the card writes it (the fields of a CUPTI kernel,
    a copy and a runtime call, from another thread than the session's)
    becomes the host and device planes with absolute line times."""
    base = 1790857026000000000
    trace = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "M", "name": "thread_name", "pid": 118, "tid": 128,
         "args": {"name": "thread 128 (python3)"}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 1.0, "dur": 9e9},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 118,
         "tid": 128, "ts": 1457698952000.5, "dur": 1500.25, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "pid": 118, "tid": 128, "ts": 1457698952012.264, "dur": 1402.186,
         "args": {"cbid": 430, "correlation": 146015}},
        {"ph": "X", "cat": "kernel", "name": "fwd_bf16_kernel", "pid": 0,
         "tid": 7, "ts": 1457698953118.607, "dur": 55.552,
         "args": {"device": 0, "context": 1, "stream": 7,
                  "correlation": 146015, "registers per thread": 168,
                  "shared memory": 18816, "grid": [8, 16, 1],
                  "block": [384, 1, 1]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> "
         "Device)", "pid": 0, "tid": 13, "ts": 1457698953000.0, "dur": 2.0,
         "args": {"device": 0, "stream": 13, "correlation": 146001,
                  "bytes": 4096}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step",
         "pid": 0, "tid": 7, "ts": 1457698953000.0, "dur": 900.0,
         "args": {"device": 0, "stream": 7}},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
         "ts": 1457698953118.607, "id": 146015}]}
    space = xspace.from_chrome_trace(trace, hostname="nb-0", start_ns=5,
                                     stop_ns=6)
    planes = {p["name"]: p for p in space["planes"]}
    assert list(planes) == ["/host:CPU", "/device:GPU:0",
                            xspace.TASK_ENVIRONMENT]
    assert space["hostnames"] == ["nb-0"]
    gpu = planes["/device:GPU:0"]
    names = {m["id"]: m["name"] for m in gpu["event_metadata"].values()}
    stats = {m["id"]: m["name"] for m in gpu["stat_metadata"].values()}
    lines = {line["name"]: line for line in gpu["lines"]}
    assert set(lines) == {"Stream #7", "Stream #13"}
    (kernel,) = lines["Stream #7"]["events"]
    assert names[kernel["metadata_id"]] == "fwd_bf16_kernel"
    assert lines["Stream #7"]["timestamp_ns"] == base + 1457698953118607
    assert kernel["offset_ps"] == 0 and kernel["duration_ps"] == 55552000
    assert {stats[s["metadata_id"]]: s.get("str_value", s.get("int64_value"))
            for s in kernel["stats"]} == {
        "correlation_id": 146015,
        "kernel_details": "regs:168 grid:8,16,1 block:384,1,1"}
    (copy,) = lines["Stream #13"]["events"]
    assert {stats[s["metadata_id"]]: s.get("uint64_value", s.get(
        "int64_value")) for s in copy["stats"]} == {"correlation_id": 146001,
                                                     "bytes": 4096}
    (host_line,) = planes["/host:CPU"]["lines"]
    assert host_line["name"] == "thread 128 (python3)"
    assert host_line["timestamp_ns"] == base + 1457698952000500
    mm, launch = host_line["events"]
    assert launch["offset_ps"] == 11764 * 1000
    assert not xspace.is_empty(space)
    assert xspace.is_empty(xspace.from_chrome_trace(
        {"traceEvents": []}, hostname="h", start_ns=0, stop_ns=1))


# ---- the port stands alone ------------------------------------------------------

PROFILER_FILES = sorted((REPO / "kubeflow_tpu_torch" / "profiler")
                        .glob("*.py")) + [
    REPO / "kubeflow_tpu_torch" / "testing" / "profiler_client.py"]
NOT_ON_THE_CARD = ("grpc", "google.protobuf", "tensorflow", "xprof",
                   "tensorboard_plugin_profile", "jax", "jaxlib",
                   "kubeflow_tpu")


def _not_on_the_card(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in NOT_ON_THE_CARD)


@pytest.mark.parametrize("path", PROFILER_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_the_server_and_client_import_nothing_the_card_lacks(path):
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module or "")
    bad = [m for m in found if _not_on_the_card(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_server_loads_nothing_the_card_lacks():
    code = ("import sys, kubeflow_tpu_torch.sdk, "
            "kubeflow_tpu_torch.profiler.server, "
            "kubeflow_tpu_torch.testing.profiler_client; "
            "print('\\n'.join(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, check=True)
    loaded = out.stdout.split()
    assert "kubeflow_tpu_torch.profiler.h2" in loaded
    assert not [m for m in loaded if _not_on_the_card(m)]
