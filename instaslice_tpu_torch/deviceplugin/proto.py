"""The kubelet device-plugin API's messages, encoded by hand.

The messages of ``instaslice_tpu/deviceplugin/proto/deviceplugin.proto``
(the public ``k8s.io/kubelet/pkg/apis/deviceplugin/v1beta1`` surface),
with their field numbers written out beside each field. The JAX package
generates them with ``protoc`` (``deviceplugin_pb2.py``) and needs
``google.protobuf``; the card's machine has neither, so this module
writes the protobuf wire format itself:

- a field is a varint key (``number << 3 | wire type``) and its value:
  varints (wire type 0) for ``bool``/``int32``/``int64``, length-
  delimited bytes (2) for strings, messages and map entries;
- proto3: a field at its default (``""``, ``False``, ``0``, an empty
  list or map, an unset message) is not written; a message field set to
  an empty message is (presence); a negative ``int32`` or ``int64`` is
  the 10-byte varint of its 64-bit two's complement;
- ``map<string, string>`` is a repeated entry message (key 1, value 2),
  and a later entry with the same key wins;
- on decode, unknown fields of wire types 0, 1, 2 and 5 (and a known
  field sent with another wire type) are skipped; groups (3, 4) are
  refused.

Each message is a dataclass with ``encode()`` and ``decode(bytes)``,
spelled as the generated classes are, so the plugin's code reads the
same (``resp.container_responses.append(...)``, ``cresp.envs[k] = v``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

STRING, BOOL, INT32, INT64, MESSAGE, MAP = "string", "bool", "int32", \
    "int64", "message", "map"


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


# ------------------------------------------------------------- varints

def encode_varint(n: int) -> bytes:
    """An unsigned varint; a negative ``n`` as its 64-bit two's
    complement (10 bytes)."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        if shift >= 64:
            raise DecodeError("varint longer than 10 bytes")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _key(number: int, wire: int) -> bytes:
    return encode_varint(number << 3 | wire)


def _delimited(number: int, payload: bytes) -> bytes:
    return _key(number, 2) + encode_varint(len(payload)) + payload


def _fields(buf: bytes):
    """(number, wire type, value) of each field: an int for wire types
    0, 1 and 5, the payload bytes for 2."""
    pos = 0
    while pos < len(buf):
        key, pos = decode_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wire == 0:
            value, pos = decode_varint(buf, pos)
        elif wire == 1 or wire == 5:
            n = 8 if wire == 1 else 4
            if pos + n > len(buf):
                raise DecodeError("truncated fixed-width field")
            value, pos = int.from_bytes(buf[pos:pos + n], "little"), pos + n
        elif wire == 2:
            n, pos = decode_varint(buf, pos)
            if pos + n > len(buf):
                raise DecodeError("length-delimited field past the end")
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise DecodeError(f"wire type {wire} (groups are not "
                              "supported)")
        yield number, wire, value


def _utf8(b: bytes) -> str:
    try:
        return bytes(b).decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"string field is not UTF-8: {e}") from e


# -------------------------------------------------------------- messages

class Message:
    """Base of the messages: ``FIELDS`` is (number, name, kind, message
    class or None) per field, in number order. A subclass is a dataclass
    whose repeated fields are lists, maps dicts, message fields None
    until set, the rest their proto3 defaults."""

    FIELDS: Tuple[tuple, ...] = ()

    def encode(self) -> bytes:
        out = bytearray()
        for number, name, kind, cls in self.FIELDS:
            value = getattr(self, name)
            if isinstance(value, list):
                for item in value:
                    out += _encode_one(number, kind, item)
            elif kind == MAP:
                for k, v in value.items():
                    entry = bytearray()
                    if k:
                        entry += _delimited(1, k.encode("utf-8"))
                    if v:
                        entry += _delimited(2, v.encode("utf-8"))
                    out += _delimited(number, bytes(entry))
            elif kind == MESSAGE:
                if value is not None:
                    out += _delimited(number, value.encode())
            elif value:
                out += _encode_one(number, kind, value)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes):
        msg = cls()
        spec = {f[0]: f for f in cls.FIELDS}
        for number, wire, value in _fields(bytes(buf)):
            f = spec.get(number)
            if f is None:
                continue                                    # unknown
            _, name, kind, sub = f
            if wire != (0 if kind in (BOOL, INT32, INT64) else 2):
                continue                       # another wire type: unknown
            current = getattr(msg, name)
            if kind == MAP:
                k = v = ""
                for en, ew, ev in _fields(value):
                    if en == 1 and ew == 2:
                        k = _utf8(ev)
                    elif en == 2 and ew == 2:
                        v = _utf8(ev)
                current[k] = v
                continue
            item = _decode_one(kind, sub, value)
            if isinstance(current, list):
                current.append(item)
            else:
                setattr(msg, name, item)
        return msg


def _encode_one(number: int, kind: str, value) -> bytes:
    if kind == STRING:
        return _delimited(number, value.encode("utf-8"))
    if kind == MESSAGE:
        return _delimited(number, value.encode())
    return _key(number, 0) + encode_varint(int(value))


def _decode_one(kind: str, sub, value):
    if kind == STRING:
        return _utf8(value)
    if kind == MESSAGE:
        return sub.decode(value)
    if kind == BOOL:
        return value != 0
    return _signed(value, 32 if kind == INT32 else 64)


# --- registration (deviceplugin.proto: DevicePluginOptions ... Empty)

@dataclasses.dataclass
class DevicePluginOptions(Message):
    pre_start_required: bool = False                         # 1
    get_preferred_allocation_available: bool = False         # 2
    FIELDS = ((1, "pre_start_required", BOOL, None),
              (2, "get_preferred_allocation_available", BOOL, None))


@dataclasses.dataclass
class RegisterRequest(Message):
    version: str = ""                                        # 1
    endpoint: str = ""                                       # 2
    resource_name: str = ""                                  # 3
    options: Optional[DevicePluginOptions] = None            # 4
    FIELDS = ((1, "version", STRING, None), (2, "endpoint", STRING, None),
              (3, "resource_name", STRING, None),
              (4, "options", MESSAGE, DevicePluginOptions))


@dataclasses.dataclass
class Empty(Message):
    FIELDS = ()


# --- inventory (ListAndWatchResponse, TopologyInfo, NUMANode, Device)

@dataclasses.dataclass
class NUMANode(Message):
    ID: int = 0                                              # 1 int64
    FIELDS = ((1, "ID", INT64, None),)


@dataclasses.dataclass
class TopologyInfo(Message):
    nodes: List[NUMANode] = dataclasses.field(default_factory=list)  # 1
    FIELDS = ((1, "nodes", MESSAGE, NUMANode),)


@dataclasses.dataclass
class Device(Message):
    ID: str = ""                                             # 1
    health: str = ""                                         # 2
    topology: Optional[TopologyInfo] = None                  # 3
    FIELDS = ((1, "ID", STRING, None), (2, "health", STRING, None),
              (3, "topology", MESSAGE, TopologyInfo))


@dataclasses.dataclass
class ListAndWatchResponse(Message):
    devices: List[Device] = dataclasses.field(default_factory=list)  # 1
    FIELDS = ((1, "devices", MESSAGE, Device),)


# --- allocation

@dataclasses.dataclass
class PreStartContainerRequest(Message):
    devicesIDs: List[str] = dataclasses.field(default_factory=list)  # 1
    FIELDS = ((1, "devicesIDs", STRING, None),)


@dataclasses.dataclass
class PreStartContainerResponse(Message):
    FIELDS = ()


@dataclasses.dataclass
class ContainerPreferredAllocationRequest(Message):
    available_deviceIDs: List[str] = dataclasses.field(
        default_factory=list)                                # 1
    must_include_deviceIDs: List[str] = dataclasses.field(
        default_factory=list)                                # 2
    allocation_size: int = 0                                 # 3 int32
    FIELDS = ((1, "available_deviceIDs", STRING, None),
              (2, "must_include_deviceIDs", STRING, None),
              (3, "allocation_size", INT32, None))


@dataclasses.dataclass
class PreferredAllocationRequest(Message):
    container_requests: List[ContainerPreferredAllocationRequest] = \
        dataclasses.field(default_factory=list)              # 1
    FIELDS = ((1, "container_requests", MESSAGE,
               ContainerPreferredAllocationRequest),)


@dataclasses.dataclass
class ContainerPreferredAllocationResponse(Message):
    deviceIDs: List[str] = dataclasses.field(default_factory=list)   # 1
    FIELDS = ((1, "deviceIDs", STRING, None),)


@dataclasses.dataclass
class PreferredAllocationResponse(Message):
    container_responses: List[ContainerPreferredAllocationResponse] = \
        dataclasses.field(default_factory=list)              # 1
    FIELDS = ((1, "container_responses", MESSAGE,
               ContainerPreferredAllocationResponse),)


@dataclasses.dataclass
class ContainerAllocateRequest(Message):
    devicesIDs: List[str] = dataclasses.field(default_factory=list)  # 1
    FIELDS = ((1, "devicesIDs", STRING, None),)


@dataclasses.dataclass
class AllocateRequest(Message):
    container_requests: List[ContainerAllocateRequest] = \
        dataclasses.field(default_factory=list)              # 1
    FIELDS = ((1, "container_requests", MESSAGE,
               ContainerAllocateRequest),)


@dataclasses.dataclass
class CDIDevice(Message):
    name: str = ""                                           # 1
    FIELDS = ((1, "name", STRING, None),)


@dataclasses.dataclass
class Mount(Message):
    container_path: str = ""                                 # 1
    host_path: str = ""                                      # 2
    read_only: bool = False                                  # 3
    FIELDS = ((1, "container_path", STRING, None),
              (2, "host_path", STRING, None), (3, "read_only", BOOL, None))


@dataclasses.dataclass
class DeviceSpec(Message):
    container_path: str = ""                                 # 1
    host_path: str = ""                                      # 2
    permissions: str = ""                                    # 3
    FIELDS = ((1, "container_path", STRING, None),
              (2, "host_path", STRING, None),
              (3, "permissions", STRING, None))


@dataclasses.dataclass
class ContainerAllocateResponse(Message):
    envs: Dict[str, str] = dataclasses.field(default_factory=dict)   # 1
    mounts: List[Mount] = dataclasses.field(default_factory=list)    # 2
    devices: List[DeviceSpec] = dataclasses.field(
        default_factory=list)                                        # 3
    annotations: Dict[str, str] = dataclasses.field(
        default_factory=dict)                                        # 4
    cdi_devices: List[CDIDevice] = dataclasses.field(
        default_factory=list)                                        # 5
    FIELDS = ((1, "envs", MAP, None), (2, "mounts", MESSAGE, Mount),
              (3, "devices", MESSAGE, DeviceSpec),
              (4, "annotations", MAP, None),
              (5, "cdi_devices", MESSAGE, CDIDevice))


@dataclasses.dataclass
class AllocateResponse(Message):
    container_responses: List[ContainerAllocateResponse] = \
        dataclasses.field(default_factory=list)              # 1
    FIELDS = ((1, "container_responses", MESSAGE,
               ContainerAllocateResponse),)

