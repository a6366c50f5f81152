"""The protobuf wire format by hand, for the TF profiler's messages.

The card machine has no ``protobuf`` package, so the profiler server
speaks the format itself: varints, length-delimited fields, fixed64
doubles and maps as repeated key/value entries. A message is a dict from
field name to value and a schema a dict from field name to ``(number,
kind)`` or ``(number, kind, element)``, where ``kind`` is a scalar kind,
``"message"`` (``element`` the nested schema), ``"repeated"`` (``element``
a scalar kind or a nested schema) or ``"map"`` (``element`` a ``(key
kind, value kind or schema)`` pair); a scalar that is a member of a
``oneof`` has ``ONEOF`` for its element.

Encoding follows proto3: fields in number order, a singular scalar at
its default (0, "", b"", False) left out unless it is a ``oneof``'s
member (which has presence: given, it is written), repeated scalars
packed; so a message without maps encodes to the bytes
``SerializeToString`` gives.
Decoding skips fields the schema does not name, takes a repeated scalar
packed or not, and leaves out fields the bytes do not carry (read them
with ``.get(name, default)``).

The schemas are those of ``tsl/profiler/protobuf/profiler_service.proto``
(``ProfileRequest``, ``ProfileResponse``, ``TerminateRequest``,
``TerminateResponse``), ``profiler_options.proto`` (``ProfileOptions``)
and ``xplane.proto`` (``XSpace`` and everything below it).
"""

from __future__ import annotations

import struct

VARINT_KINDS = frozenset({"uint64", "int64", "uint32", "int32", "bool",
                          "enum"})
_MASK64 = (1 << 64) - 1
_WIRE = {**dict.fromkeys(VARINT_KINDS, 0), "double": 1, "string": 2,
         "bytes": 2}
_DOUBLE = struct.Struct("<d")
ONEOF = "oneof"

# ---- schemas -----------------------------------------------------------------

TRACE_OPTIONS = {"host_traceme_filter_mask": (1, "uint64")}
ADVANCED_CONFIG_VALUE = {
    "string_value": (1, "string", ONEOF),
    "bool_value": (2, "bool", ONEOF),
    "int64_value": (3, "int64", ONEOF),
}
PROFILE_OPTIONS = {
    "include_dataset_ops": (1, "bool"),
    "host_tracer_level": (2, "uint32"),
    "device_tracer_level": (3, "uint32"),
    "python_tracer_level": (4, "uint32"),
    "version": (5, "uint32"),
    "device_type": (6, "enum"),
    "enable_hlo_proto": (7, "bool"),
    "start_timestamp_ns": (8, "uint64"),
    "duration_ms": (9, "uint64"),
    "repository_path": (10, "string"),
    "trace_options": (11, "message", TRACE_OPTIONS),
    "advanced_configuration": (12, "map", ("string", ADVANCED_CONFIG_VALUE)),
    "raise_error_on_start_failure": (13, "bool"),
    "session_id": (14, "string"),
    "override_hostname": (15, "string"),
}
TOOL_REQUEST_OPTIONS = {
    "output_formats": (2, "string"),
    "save_to_repo": (3, "bool"),
}
PROFILE_REQUEST = {
    "duration_ms": (1, "uint64"),
    "max_events": (2, "uint64"),
    "tools": (3, "repeated", "string"),
    "opts": (4, "message", PROFILE_OPTIONS),
    "repository_root": (5, "string"),
    "session_id": (6, "string"),
    "host_name": (7, "string"),
    "tool_options": (8, "map", ("string", TOOL_REQUEST_OPTIONS)),
    "emit_xspace": (9, "bool"),
}
PROFILE_TOOL_DATA = {"name": (1, "string"), "data": (2, "bytes")}

XSTAT = {
    "metadata_id": (1, "int64"),
    "double_value": (2, "double", ONEOF),
    "uint64_value": (3, "uint64", ONEOF),
    "int64_value": (4, "int64", ONEOF),
    "str_value": (5, "string", ONEOF),
    "bytes_value": (6, "bytes", ONEOF),
    "ref_value": (7, "uint64", ONEOF),
}
XEVENT = {
    "metadata_id": (1, "int64"),
    "offset_ps": (2, "int64", ONEOF),
    "duration_ps": (3, "int64"),
    "stats": (4, "repeated", XSTAT),
    "num_occurrences": (5, "int64", ONEOF),
}
XLINE = {
    "id": (1, "int64"),
    "name": (2, "string"),
    "timestamp_ns": (3, "int64"),
    "events": (4, "repeated", XEVENT),
    "duration_ps": (9, "int64"),
    "display_id": (10, "int64"),
    "display_name": (11, "string"),
}
XEVENT_METADATA = {
    "id": (1, "int64"),
    "name": (2, "string"),
    "metadata": (3, "bytes"),
    "display_name": (4, "string"),
    "stats": (5, "repeated", XSTAT),
    "child_id": (6, "repeated", "int64"),
}
XSTAT_METADATA = {
    "id": (1, "int64"),
    "name": (2, "string"),
    "description": (3, "string"),
}
XPLANE = {
    "id": (1, "int64"),
    "name": (2, "string"),
    "lines": (3, "repeated", XLINE),
    "event_metadata": (4, "map", ("int64", XEVENT_METADATA)),
    "stat_metadata": (5, "map", ("int64", XSTAT_METADATA)),
    "stats": (6, "repeated", XSTAT),
}
XSPACE = {
    "planes": (1, "repeated", XPLANE),
    "errors": (2, "repeated", "string"),
    "warnings": (3, "repeated", "string"),
    "hostnames": (4, "repeated", "string"),
}
PROFILE_RESPONSE = {
    "tool_data": (6, "repeated", PROFILE_TOOL_DATA),
    "empty_trace": (7, "bool"),
    "xspace": (8, "message", XSPACE),
}
TERMINATE_REQUEST = {"session_id": (1, "string")}
TERMINATE_RESPONSE: dict = {}


class DecodeError(ValueError):
    """Bytes that are no valid encoding of the message asked for."""


# ---- encoding ----------------------------------------------------------------


def varint(value: int) -> bytes:
    """``value`` as a base-128 varint; a negative int64 as its 64-bit two's
    complement (ten bytes), as protobuf writes it."""
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _scalar(kind: str, value) -> bytes:
    """The payload of one scalar (after its tag)."""
    if kind in VARINT_KINDS:
        return varint(int(value))
    if kind == "double":
        return _DOUBLE.pack(value)
    if kind == "string":
        data = value.encode()
        return varint(len(data)) + data
    if kind == "bytes":
        return varint(len(value)) + bytes(value)
    raise ValueError(f"unknown scalar kind {kind!r}")


_PLANS: dict = {}


def _plan(schema: dict) -> list:
    """(name, kind, element, tag bytes) of each field, in number order;
    computed once a schema."""
    plan = _PLANS.get(id(schema))
    if plan is None:
        plan = []
        for name, spec in sorted(schema.items(), key=lambda i: i[1][0]):
            number, kind = spec[0], spec[1]
            element = spec[2] if len(spec) > 2 else None
            if kind == "map":
                key_kind, value_kind = element
                element = {"key": (1, key_kind),
                           "value": ((2, "message", value_kind)
                                     if isinstance(value_kind, dict)
                                     else (2, value_kind))}
            packed = kind in ("message", "map") or (
                kind == "repeated" and (isinstance(element, dict)
                                        or element in VARINT_KINDS))
            wire = 2 if packed else _WIRE[element if kind == "repeated"
                                          else kind]
            plan.append((name, kind, element, varint(number << 3 | wire)))
        _PLANS[id(schema)] = plan
    return plan


def encode(schema: dict, message: dict) -> bytes:
    """``message`` in the wire format, fields in number order."""
    if not message.keys() <= schema.keys():
        raise ValueError("fields not in the schema: "
                         f"{sorted(set(message) - set(schema))}")
    out = bytearray()
    for name, kind, element, tag in _plan(schema):
        value = message.get(name)
        if value is None:
            continue
        if kind == "message":
            body = encode(element, value)
            out += tag + varint(len(body)) + body
        elif kind == "repeated":
            if isinstance(element, dict):
                for item in value:
                    body = encode(element, item)
                    out += tag + varint(len(body)) + body
            elif element in VARINT_KINDS:
                if value:
                    body = b"".join(varint(int(v)) for v in value)
                    out += tag + varint(len(body)) + body
            else:
                for item in value:
                    out += tag + _scalar(element, item)
        elif kind == "map":
            for key, item in value.items():
                body = encode(element, {"key": key, "value": item})
                out += tag + varint(len(body)) + body
        elif element == ONEOF or value != _default(kind):
            out += tag + _scalar(kind, value)
    return bytes(out)


def _default(kind: str):
    if kind in ("string",):
        return ""
    if kind == "bytes":
        return b""
    if kind == "bool":
        return False
    return 0


# ---- decoding ----------------------------------------------------------------


def read_varint(data, pos: int) -> tuple:
    """(value, next position) of the varint at ``pos``."""
    result = shift = 0
    while True:
        if pos >= len(data):
            raise DecodeError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _fields_of(data):
    """(field number, wire type, value) of each field in ``data``; a
    length-delimited value is a memoryview of its bytes."""
    view = memoryview(data)
    pos, end = 0, len(view)
    while pos < end:
        tag, pos = read_varint(view, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = read_varint(view, pos)
        elif wire == 1:
            value, pos = view[pos:pos + 8], pos + 8
        elif wire == 2:
            size, pos = read_varint(view, pos)
            value, pos = view[pos:pos + size], pos + size
        elif wire == 5:
            value, pos = view[pos:pos + 4], pos + 4
        else:
            raise DecodeError(f"field {number}: unsupported wire type {wire}")
        if pos > end:
            raise DecodeError(f"field {number} runs past the message")
        yield number, wire, value


def _from_varint(kind: str, value: int):
    if kind in ("int64", "enum") and value >= 1 << 63:
        return value - (1 << 64)
    if kind == "int32":
        value &= 0xFFFFFFFF
        return value - (1 << 32) if value >= 1 << 31 else value
    if kind == "bool":
        return bool(value)
    return value


def _from_scalar(kind: str, wire: int, value):
    if kind in VARINT_KINDS and wire == 0:
        return _from_varint(kind, value)
    if kind == "double" and wire == 1:
        return _DOUBLE.unpack(value)[0]
    if kind == "string" and wire == 2:
        return bytes(value).decode()
    if kind == "bytes" and wire == 2:
        return bytes(value)
    raise DecodeError(f"wire type {wire} does not carry a {kind}")


def decode(schema: dict, data) -> dict:
    """The fields of ``data`` that ``schema`` names."""
    by_number = {number: entry
                 for number, entry in zip(
                     sorted(spec[0] for spec in schema.values()),
                     _plan(schema))}
    message: dict = {}
    for number, wire, value in _fields_of(data):
        if number not in by_number:
            continue
        name, kind, element, _tag = by_number[number]
        if kind == "message":
            message[name] = decode(element, value)
        elif kind == "repeated":
            items = message.setdefault(name, [])
            if isinstance(element, dict):
                items.append(decode(element, value))
            elif element in VARINT_KINDS and wire == 2:
                pos = 0
                while pos < len(value):
                    item, pos = read_varint(value, pos)
                    items.append(_from_varint(element, item))
            else:
                items.append(_from_scalar(element, wire, value))
        elif kind == "map":
            item = decode(element, value)
            key_kind, value_kind = element["key"][1], element["value"]
            default = ({} if value_kind[1] == "message"
                       else _default(value_kind[1]))
            message.setdefault(name, {})[
                item.get("key", _default(key_kind))] = item.get(
                    "value", default)
        else:
            message[name] = _from_scalar(kind, wire, value)
    return message
