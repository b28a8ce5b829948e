"""The port's hand-written protobuf messages
(``instaslice_tpu_torch/deviceplugin/proto.py``) against the JAX
package's generated ``deviceplugin_pb2`` (``google.protobuf``), both
ways, for every message of ``deviceplugin.proto``: the port's
``encode()`` read by ``pb.X.FromString``, and ``pb.X.SerializeToString()``
read by the port's ``decode()``, must give equal messages. Hypothesis
draws the messages: unicode strings, empty maps and lists, set-but-empty
sub-messages, negative ``int32``/``int64``, and unknown fields spliced
in before and after. The controls: a wrong field number for ``envs``
reads back empty on the reference's side, and a group is refused.
"""

import dataclasses

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from instaslice_tpu.deviceplugin import deviceplugin_pb2 as ref
from instaslice_tpu_torch.deviceplugin import proto as P

STR = st.text(max_size=12)
INT32 = st.integers(-2 ** 31, 2 ** 31 - 1)
INT64 = st.integers(-2 ** 63, 2 ** 63 - 1)
SCALAR = {P.STRING: STR, P.BOOL: st.booleans(), P.INT32: INT32,
          P.INT64: INT64}


def strategy(cls, depth=0):
    """Messages of ``cls`` with every field drawn (repeated fields up to
    3 items, message fields None or set)."""
    kw = {}
    for _, name, kind, sub in cls.FIELDS:
        f = next(f for f in dataclasses.fields(cls) if f.name == name)
        repeated = f.default_factory is list
        if kind == P.MAP:
            kw[name] = st.dictionaries(STR, STR, max_size=3)
        elif kind == P.MESSAGE:
            one = strategy(sub, depth + 1)
            kw[name] = st.lists(one, max_size=3) if repeated else \
                st.none() | one
        else:
            kw[name] = st.lists(SCALAR[kind], max_size=3) if repeated \
                else SCALAR[kind]
    return st.builds(cls, **kw)


def to_ref(msg):
    """The same message as the reference's generated class."""
    out = getattr(ref, type(msg).__name__)()
    for _, name, kind, sub in type(msg).FIELDS:
        value = getattr(msg, name)
        if kind == P.MAP:
            getattr(out, name).update(value)
        elif kind == P.MESSAGE and isinstance(value, list):
            for v in value:
                getattr(out, name).append(to_ref(v))
        elif kind == P.MESSAGE:
            if value is not None:
                getattr(out, name).CopyFrom(to_ref(value))
        elif isinstance(value, list):
            getattr(out, name).extend(value)
        else:
            setattr(out, name, value)
    return out


#: unknown fields (number 15) of wire types 0, 1, 2 and 5
UNKNOWN = (P.encode_varint(15 << 3 | 0) + P.encode_varint(2 ** 40)
           + P.encode_varint(15 << 3 | 1) + bytes(range(8))
           + P.encode_varint(15 << 3 | 2) + P.encode_varint(3) + b"xyz"
           + P.encode_varint(15 << 3 | 5) + bytes(4))

#: every message of the proto file, by name
MESSAGES = {name: cls for name, cls in vars(P).items()
            if isinstance(cls, type) and issubclass(cls, P.Message)
            and cls is not P.Message}
NAMES = sorted(MESSAGES)


def test_every_message_of_the_proto_file():
    assert set(NAMES) == set(ref.DESCRIPTOR.message_types_by_name)
    for name in NAMES:
        desc = ref.DESCRIPTOR.message_types_by_name[name]
        mine = {(n, f) for n, f, *_ in MESSAGES[name].FIELDS}
        assert mine == {(f.number, f.name) for f in desc.fields}, name


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_round_trip_both_ways(name, data):
    cls = MESSAGES[name]
    msg = data.draw(strategy(cls))
    want = to_ref(msg)
    assert getattr(ref, name).FromString(msg.encode()) == want
    wire = want.SerializeToString()
    assert cls.decode(wire) == msg
    assert cls.decode(UNKNOWN + wire + UNKNOWN) == msg


def test_negative_int32_is_a_ten_byte_varint():
    m = P.ContainerPreferredAllocationRequest(allocation_size=-1)
    assert m.encode() == bytes([3 << 3]) + b"\xff" * 9 + b"\x01"
    assert m.encode() == to_ref(m).SerializeToString()


def test_later_map_entry_wins_and_defaults_are_not_written():
    entry = lambda k, v: P._delimited(1, P._delimited(1, k.encode())
                                      + P._delimited(2, v.encode()))
    wire = entry("A", "1") + entry("B", "2") + entry("A", "3")
    got = P.ContainerAllocateResponse.decode(wire)
    assert got.envs == {"A": "3", "B": "2"}
    assert got.envs == dict(ref.ContainerAllocateResponse.FromString(
        wire).envs)
    assert P.DeviceSpec().encode() == b"" and P.Device(ID="").encode() == b""
    assert P.RegisterRequest(options=P.DevicePluginOptions()).encode() == \
        b"\x22\x00"


def test_cdi_devices_are_kept():
    m = P.ContainerAllocateResponse(cdi_devices=[P.CDIDevice("nvidia.com/"
                                                             "gpu=0")])
    assert ref.ContainerAllocateResponse.FromString(m.encode()).cdi_devices[
        0].name == "nvidia.com/gpu=0"


def test_wrong_field_number_for_envs_misses(monkeypatch):
    """The control: ``envs`` written as field 6 reads back empty on the
    reference's side."""
    m = P.ContainerAllocateResponse(envs={"CUDA_VISIBLE_DEVICES": "GPU-1"})
    assert dict(ref.ContainerAllocateResponse.FromString(
        m.encode()).envs) == m.envs
    fields = list(P.ContainerAllocateResponse.FIELDS)
    fields[0] = (6,) + fields[0][1:]
    monkeypatch.setattr(P.ContainerAllocateResponse, "FIELDS", tuple(fields))
    assert dict(ref.ContainerAllocateResponse.FromString(
        m.encode()).envs) == {}


@pytest.mark.parametrize("wire,why", [
    (b"\x0b\x0c", "group"),                 # field 1 start group, end group
    (b"\x0a\x05ab", "past the end"),
    (b"\x0a", "truncated"),
    (b"\x0a\x02\xff\xfe", "UTF-8"),
    (b"\x08" + b"\xff" * 10 + b"\x01", "longer than 10"),
])
def test_malformed_input_raises(wire, why):
    with pytest.raises(P.DecodeError, match=why):
        P.Device.decode(wire)
