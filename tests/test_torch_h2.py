"""The port's hand-written HTTP/2 and gRPC wire
(``instaslice_tpu_torch/deviceplugin/h2.py``, ``wire.py``) against
``grpc`` 1.76 on the CPU, both ways.

- The reference's grpc ``DevicePluginClient`` against the port's plugin:
  options, the initial inventory, a health flip pushed, preferred
  allocation, Allocate, the status codes as ``grpc.StatusCode``; its
  messages equal the port client's; metadata with a ``-bin`` key (grpc
  Huffman-codes its base64) reaches the port's handler as bytes.
- The port's client against a grpc server hosting the reference's
  ``device_plugin_handler`` and ``registration_handler`` over scripted
  servicers: messages and status codes equal, metadata too; the
  reference's ``RegistrationClient`` against the port's Registration
  server.
- Flow control: a ListAndWatch stream of far more than 65,535 bytes each
  way (300 health flips of a 64-GPU inventory, every update read by
  grpc's client; a grpc server's stream read by the port's client), an
  Allocate response over 16,384 bytes (DATA in several frames: the
  port's reader takes no frame over 16,384 bytes), ListAndWatch and
  Allocate at once on one connection, a cancelled stream ending its
  handler, deadlines both ways.
- Raw frames against the port's server: an unknown setting and unknown
  frame types ignored, PING answered with the same 8 bytes, HEADERS with
  PADDED and PRIORITY split over CONTINUATION, padded DATA, a compressed
  message refused with UNIMPLEMENTED, a foreign content-type with 415.

The control: with the port client's WINDOW_UPDATEs turned off, a grpc
server's stream stalls before 65,535 bytes. (A wrong field number for
``envs`` is ``test_torch_proto.py``'s control.)
"""

import os
import shutil
import socket
import tempfile
import threading
import time
from concurrent import futures

import grpc
import pytest

from instaslice_tpu.deviceplugin import deviceplugin_pb2 as ref
from instaslice_tpu.deviceplugin import wire as refwire
from instaslice_tpu_torch.device import FakeGpuBackend
from instaslice_tpu_torch.deviceplugin import h2
from instaslice_tpu_torch.deviceplugin import hpack as H
from instaslice_tpu_torch.deviceplugin import proto as pb
from instaslice_tpu_torch.deviceplugin import wire
from instaslice_tpu_torch.deviceplugin.server import GpuDevicePlugin
from test_torch_proto import to_ref

BIN = bytes(range(256)) + b"\x00\xff" * 40


@pytest.fixture()
def tmp():
    d = tempfile.mkdtemp(prefix="h2", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture()
def plugin(tmp):
    p = GpuDevicePlugin(FakeGpuBackend(gpu_count=64, mig=False),
                        plugin_dir=tmp, health_poll_seconds=0.05,
                        register_with_kubelet=False)
    p.start()
    yield p
    p.stop()


def _code(e) -> str:
    """A status code's name, from grpc or from the port."""
    return e.code().name


# ---------------------------------------------- grpc client, port server

def test_reference_client_against_the_port_plugin(plugin):
    with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch, \
            wire.Channel(plugin.socket_path) as pch:
        c, pc = refwire.DevicePluginClient(ch), wire.DevicePluginClient(pch)
        assert c.options(timeout=5) == to_ref(pc.options())
        stream = c._list_and_watch(ref.Empty(), timeout=30)
        first = next(stream)
        assert [d.ID for d in first.devices] == [f"gpu-{i}" for i in
                                                 range(64)]
        assert {d.health for d in first.devices} == {refwire.HEALTHY}
        plugin.set_chip_health(7, False)
        flipped = {d.ID: d.health for d in next(stream).devices}
        assert flipped["gpu-7"] == refwire.UNHEALTHY
        assert flipped["gpu-6"] == refwire.HEALTHY
        stream.cancel()
        want = c.preferred([f"gpu-{i}" for i in range(8)], 4, ["gpu-5"],
                           timeout=5)
        assert want == to_ref(pc.preferred([f"gpu-{i}" for i in range(8)],
                                           4, ["gpu-5"]))
        assert list(want.container_responses[0].deviceIDs) == \
            ["gpu-2", "gpu-3", "gpu-4", "gpu-5"]
        got = c.allocate(["gpu-3", "gpu-9"], timeout=5)
        assert got == to_ref(pc.allocate(["gpu-3", "gpu-9"]))
        assert got.container_responses[0].envs["TPU_KUBELET_ASSIGNED_"
                                               "CHIPS"] == "3,9"
        for ids, code in ((["gpu-99"], "NOT_FOUND"),
                          (["slice-x"], "INVALID_ARGUMENT")):
            with pytest.raises(grpc.RpcError) as ei:
                c.allocate(ids, timeout=5)
            with pytest.raises(wire.RpcError) as pi:
                pc.allocate(ids)
            assert ei.value.code() == getattr(grpc.StatusCode, code)
            assert _code(pi.value) == code
            assert ei.value.details() == pi.value.details()


class Recorder:
    """A port servicer of one method that records its metadata."""

    def __init__(self) -> None:
        self.metadata = []
        self.aborted = threading.Event()

    def Allocate(self, request, context):
        self.metadata.append(dict(context.invocation_metadata()))
        if request.container_requests[0].devicesIDs == ["slow"]:
            while context.is_active():
                time.sleep(0.01)
            self.aborted.set()
        return pb.AllocateResponse()


def _port_server(tmp, servicer, name="srv.sock"):
    srv = wire.Server()
    srv.add_handlers({"/v1beta1.DevicePlugin/Allocate": wire.unary_unary(
        servicer.Allocate, pb.AllocateRequest, pb.AllocateResponse)})
    return srv.start(os.path.join(tmp, name))


def test_bin_metadata_and_deadline_from_grpc(tmp):
    rec = Recorder()
    srv = _port_server(tmp, rec)
    try:
        with grpc.insecure_channel(f"unix://{srv.path}") as ch:
            c = refwire.DevicePluginClient(ch)
            c._allocate(ref.AllocateRequest(container_requests=[
                ref.ContainerAllocateRequest(devicesIDs=["a"])]),
                timeout=5, metadata=(("x-trace-bin", BIN),
                                     ("x-tenant", "gold")))
            assert rec.metadata[0]["x-trace-bin"] == BIN
            assert rec.metadata[0]["x-tenant"] == "gold"
            with pytest.raises(grpc.RpcError) as ei:
                c.allocate(["slow"], timeout=0.3)
            assert ei.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
            # grpc's RST_STREAM CANCEL turns the handler's context off
            assert rec.aborted.wait(5)
    finally:
        srv.stop()


def test_reference_registration_client_against_the_port(tmp):
    got = []

    class Kubelet:
        def Register(self, request, context):
            got.append(request)
            return pb.Empty()

    srv = wire.Server()
    srv.add_handlers(wire.registration_handler(Kubelet()))
    srv.start(os.path.join(tmp, "kubelet.sock"))
    try:
        with grpc.insecure_channel(f"unix://{srv.path}") as ch:
            refwire.RegistrationClient(ch).register(
                "tpuslice-3g.40gb.sock", "nvidia.com/mig-3g.40gb")
        (req,) = got
        assert (req.version, req.endpoint, req.resource_name) == (
            "v1beta1", "tpuslice-3g.40gb.sock", "nvidia.com/mig-3g.40gb")
        assert req.options == pb.DevicePluginOptions(False, True)
    finally:
        srv.stop()


def test_long_stream_to_grpc_and_allocate_alongside(plugin):
    """300 health flips of a 64-GPU inventory, each update read by grpc's
    client before the next flip (well past the 65,535-byte initial
    windows), with Allocates on the same connection between them."""
    with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
        c = refwire.DevicePluginClient(ch)
        stream = c._list_and_watch(ref.Empty(), timeout=60)
        total = len(next(stream).SerializeToString())
        for i in range(300):
            gpu = i % 64
            plugin.set_chip_health(gpu, i % 128 >= 64)
            resp = next(stream)
            total += len(resp.SerializeToString())
            health = {d.ID: d.health for d in resp.devices}[f"gpu-{gpu}"]
            assert health == (refwire.HEALTHY if i % 128 >= 64
                              else refwire.UNHEALTHY)
            if i % 50 == 0:
                assert c.allocate([f"gpu-{gpu}"], timeout=5).\
                    container_responses[0].envs["TPU_VISIBLE_CHIPS"] == "0"
        stream.cancel()
        assert total > 300_000


def test_large_allocate_both_ways(tmp):
    """An Allocate response of 256 GPUs (over 16,384 bytes): grpc's
    client reads the port's, and the port's client (whose reader refuses
    frames over 16,384 bytes) reads it in several DATA frames."""
    p = GpuDevicePlugin(FakeGpuBackend(gpu_count=256, mig=False),
                        plugin_dir=tmp, register_with_kubelet=False)
    p.start()
    try:
        ids = [f"gpu-{i}" for i in range(256)]
        with grpc.insecure_channel(f"unix://{p.socket_path}") as ch, \
                wire.Channel(p.socket_path) as pch:
            got = refwire.DevicePluginClient(ch).allocate(ids, timeout=10)
            mine = wire.DevicePluginClient(pch).allocate(ids, timeout=10)
        assert len(got.SerializeToString()) > 16384
        assert got == to_ref(mine)
        assert len(got.container_responses[0].devices) == 256
    finally:
        p.stop()


def test_cancelled_stream_ends_its_handler(plugin):
    with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
        stream = refwire.DevicePluginClient(ch)._list_and_watch(
            ref.Empty(), timeout=30)
        next(stream)
        calls = list(plugin._server._calls)
        assert any(t.is_alive() for t in calls)
        stream.cancel()
        deadline = time.monotonic() + 5
        while any(t.is_alive() for t in calls):
            assert time.monotonic() < deadline, "handler still running"
            time.sleep(0.02)


# ---------------------------------------------- port client, grpc server

def _devices(i, n=64):
    return [ref.Device(ID=f"gpu-{j}",
                       health=refwire.HEALTHY if (i + j) % 3 else
                       refwire.UNHEALTHY,
                       topology=ref.TopologyInfo(
                           nodes=[ref.NUMANode(ID=-(j % 2))]))
            for j in range(n)]


def _allocation(ids):
    return ref.AllocateResponse(container_responses=[
        ref.ContainerAllocateResponse(
            envs={f"E{i}": "é" * (i % 7) + d for i, d in enumerate(ids)},
            mounts=[ref.Mount(container_path="/m", host_path="/h",
                              read_only=True)],
            devices=[ref.DeviceSpec(container_path=f"/dev/{d}",
                                    host_path=f"/dev/{d}",
                                    permissions="rw") for d in ids],
            annotations={"a": ",".join(ids)},
            cdi_devices=[ref.CDIDevice(name="nvidia.com/gpu=all")])])


class Scripted:
    """The reference's servicer surface, answering from a script."""

    def __init__(self, n_updates=3):
        self.n_updates = n_updates
        self.metadata = []
        self.registered = []
        self.stream_ended = threading.Event()

    def GetDevicePluginOptions(self, request, context):
        return ref.DevicePluginOptions(pre_start_required=True,
                                       get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        try:
            for i in range(self.n_updates):
                yield ref.ListAndWatchResponse(devices=_devices(i))
            while context.is_active():
                time.sleep(0.02)
        finally:
            self.stream_ended.set()

    def GetPreferredAllocation(self, request, context):
        r = request.container_requests[0]
        must = list(r.must_include_deviceIDs)
        rest = [d for d in r.available_deviceIDs if d not in must]
        return ref.PreferredAllocationResponse(container_responses=[
            ref.ContainerPreferredAllocationResponse(
                deviceIDs=must + rest[:r.allocation_size - len(must)])])

    def Allocate(self, request, context):
        self.metadata.append(dict(context.invocation_metadata()))
        ids = list(request.container_requests[0].devicesIDs)
        if ids == ["nope"]:
            context.abort(grpc.StatusCode.NOT_FOUND, "no such device: "
                          "nope ü 100%")
        if ids == ["bad"]:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "bad id")
        if ids == ["slow"]:
            time.sleep(1.0)
        return _allocation(ids)

    def PreStartContainer(self, request, context):
        return ref.PreStartContainerResponse()

    def Register(self, request, context):
        self.registered.append(request)
        return ref.Empty()


@pytest.fixture()
def grpc_server(tmp):
    s = Scripted()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((refwire.device_plugin_handler(s),
                                     refwire.registration_handler(s)))
    path = os.path.join(tmp, "ref.sock")
    server.add_insecure_port(f"unix://{path}")
    server.start()
    s.path = path
    yield s
    server.stop(grace=0.5).wait(5)


def test_port_client_against_reference_handlers(grpc_server):
    s = grpc_server
    with wire.Channel(f"unix://{s.path}") as ch:
        c = wire.DevicePluginClient(ch)
        assert to_ref(c.options()) == s.GetDevicePluginOptions(None, None)
        stream = c.list_and_watch(timeout=30)
        for i in range(3):
            assert to_ref(stream.next(5)) == ref.ListAndWatchResponse(
                devices=_devices(i))
        stream.cancel()
        assert s.stream_ended.wait(5)
        avail = [f"gpu-{i}" for i in range(6)]
        assert to_ref(c.preferred(avail, 3, ["gpu-4"])) == \
            ref.PreferredAllocationResponse(container_responses=[
                ref.ContainerPreferredAllocationResponse(
                    deviceIDs=["gpu-4", "gpu-0", "gpu-1"])])
        ids = [f"gpu-{i}" for i in range(400)]
        got = c.allocate(ids, metadata=(("x-trace-bin", BIN),
                                        ("x-tenant", "gold")))
        assert to_ref(got) == _allocation(ids)
        assert len(_allocation(ids).SerializeToString()) > 16384
        assert s.metadata[-1]["x-trace-bin"] == BIN
        assert s.metadata[-1]["x-tenant"] == "gold"
        for ids, code, details in (
                (["nope"], "NOT_FOUND", "no such device: nope ü 100%"),
                (["bad"], "INVALID_ARGUMENT", "bad id")):
            with pytest.raises(wire.RpcError) as ei:
                c.allocate(ids)
            assert (_code(ei.value), ei.value.details()) == (code, details)
        with pytest.raises(wire.RpcError) as ei:
            c.allocate(["slow"], timeout=0.2)
        assert ei.value.code() == wire.StatusCode.DEADLINE_EXCEEDED
        assert c.pre_start(["gpu-0"]) == pb.PreStartContainerResponse()
        wire.RegistrationClient(ch).register("e.sock", "nvidia.com/gpu")
        assert s.registered[0] == ref.RegisterRequest(
            version="v1beta1", endpoint="e.sock",
            resource_name="nvidia.com/gpu",
            options=ref.DevicePluginOptions(
                get_preferred_allocation_available=True))


@pytest.mark.parametrize("window_updates", [True, False],
                         ids=["window_updates", "control_no_updates"])
def test_long_stream_from_grpc(grpc_server, window_updates):
    """120 updates of 64 devices from grpc's server (about 240 KB) read
    by the port's client, an Allocate on the same connection meanwhile.
    The control: without the port's WINDOW_UPDATEs the server stalls
    once the 65,535-byte windows are spent."""
    s = grpc_server
    s.n_updates = 120
    with wire.Channel(s.path) as ch:
        if not window_updates:
            # the port client's connection gives no credit back
            ch.connection()._window_update = lambda sid, n: None
        c = wire.DevicePluginClient(ch)
        stream = c.list_and_watch(timeout=60)
        got, size = 0, 0
        try:
            for i in range(s.n_updates):
                msg = stream.next(timeout=3)
                assert to_ref(msg) == ref.ListAndWatchResponse(
                    devices=_devices(i))
                got, size = got + 1, size + len(msg.encode())
                if i == 10 and window_updates:
                    assert to_ref(c.allocate(["gpu-1"])) == \
                        _allocation(["gpu-1"])
        except TimeoutError:
            pass
        stream.cancel()
    if window_updates:
        assert got == s.n_updates and size > 200_000
    else:
        assert 0 < got < s.n_updates and size < h2.DEFAULT_WINDOW


def test_unreachable_socket_is_unavailable(tmp):
    with wire.Channel(os.path.join(tmp, "none.sock")) as ch:
        with pytest.raises(wire.RpcError) as ei:
            wire.DevicePluginClient(ch).options()
    assert ei.value.code() == wire.StatusCode.UNAVAILABLE


# ------------------------------------------------------------ raw frames

class RawClient:
    """Frames written by hand to the port's server; its frames read
    back."""

    def __init__(self, path):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(5)
        self.sock.connect(path)
        self.dec = H.Decoder()
        self.frames = []

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def _exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            assert chunk, "server closed"
            buf += chunk
        return buf

    def until_end(self, sid):
        """Frames up to the one that ends stream ``sid``: its header
        blocks decoded, its DATA joined."""
        blocks, data = [], b""
        while True:
            head = self._exact(9)
            n, ftype, flags = int.from_bytes(head[:3], "big"), head[3], \
                head[4]
            fsid = int.from_bytes(head[5:], "big")
            payload = self._exact(n)
            self.frames.append((ftype, flags, fsid, payload))
            if fsid != sid:
                continue
            if ftype == h2.HEADERS:
                blocks.append(self.dec.decode(payload))
            elif ftype == h2.DATA:
                data += payload
            if ftype in (h2.HEADERS, h2.DATA) and flags & h2.END_STREAM:
                return blocks, data

    def close(self):
        self.sock.close()


REQUEST = [(":method", "POST"), (":scheme", "http"),
           (":path", "/v1beta1.DevicePlugin/Allocate"),
           (":authority", "localhost"), ("content-type", "application/grpc"),
           ("te", "trailers")]


def _alloc_body(ids, flag=0):
    msg = pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(devicesIDs=ids)]).encode()
    return bytes([flag]) + len(msg).to_bytes(4, "big") + msg


def test_raw_frames_the_server_must_take(plugin):
    c = RawClient(plugin.socket_path)
    try:
        block = H.Encoder().encode(REQUEST)
        half = len(block) // 2
        pad = 3
        body = _alloc_body(["gpu-2"])
        c.send(h2.PREFACE
               + h2.frame(h2.SETTINGS, 0, 0, h2.settings_payload(
                   {0xfe03: 1, h2.MAX_FRAME_SIZE: 4194304,
                    h2.INITIAL_WINDOW_SIZE: 4194304,
                    h2.MAX_CONCURRENT_STREAMS: 0}))
               + h2.frame(0xfa, 0, 0, b"unknown type")
               + h2.frame(h2.PING, 0, 0, b"8 bytes!")
               + h2.frame(h2.PRIORITY, 0, 1, bytes(5))
               + h2.frame(h2.HEADERS, h2.PADDED | h2.PRIORITY_FLAG, 1,
                          bytes([pad]) + bytes(4) + b"\x0f" + block[:half]
                          + bytes(pad))
               + h2.frame(h2.CONTINUATION, h2.END_HEADERS, 1, block[half:])
               + h2.frame(0xfb, 0x5, 1, b"unknown on the stream")
               + h2.frame(h2.DATA, h2.PADDED, 1, bytes([7]) + body[:4]
                          + bytes(7))
               + h2.frame(h2.DATA, h2.END_STREAM, 1, body[4:]))
        blocks, data = c.until_end(1)
        headers, trailers = dict(blocks[0]), dict(blocks[-1])
        assert headers[":status"] == "200"
        assert headers["content-type"] == "application/grpc"
        assert trailers["grpc-status"] == "0"
        (msg,) = wire.MessageReader().feed(data)
        (cresp,) = pb.AllocateResponse.decode(msg).container_responses
        assert cresp.envs["TPU_KUBELET_ASSIGNED_CHIPS"] == "2"
        kinds = [(t, f, p) for t, f, _, p in c.frames]
        assert (h2.PING, h2.ACK, b"8 bytes!") in kinds
        assert (h2.SETTINGS, h2.ACK, b"") in kinds
        # the padding of a DATA frame is credited back to the stream
        assert any(t == h2.WINDOW_UPDATE and s == 1 for t, _, s, _ in
                   c.frames)
        # a compressed message and a foreign content-type, on streams 3, 5
        c.send(h2.frame(h2.HEADERS, h2.END_HEADERS, 3,
                        H.Encoder().encode(REQUEST))
               + h2.frame(h2.DATA, h2.END_STREAM, 3,
                          _alloc_body(["gpu-1"], flag=1)))
        blocks, _ = c.until_end(3)
        assert dict(blocks[-1])["grpc-status"] == str(
            wire.StatusCode.UNIMPLEMENTED.value)
        c.send(h2.frame(h2.HEADERS, h2.END_HEADERS | h2.END_STREAM, 5,
                        H.Encoder().encode(REQUEST[:4] + [
                            ("content-type", "application/json")])))
        blocks, _ = c.until_end(5)
        assert dict(blocks[0])[":status"] == "415"
    finally:
        c.close()


def test_an_interrupted_header_block_is_a_connection_error(plugin):
    c = RawClient(plugin.socket_path)
    try:
        block = H.Encoder().encode(REQUEST)
        c.send(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0)
               + h2.frame(h2.HEADERS, 0, 1, block[:4])
               + h2.frame(h2.PING, 0, 0, bytes(8)))
        deadline = time.monotonic() + 5
        while True:
            head = c._exact(9)
            payload = c._exact(int.from_bytes(head[:3], "big"))
            if head[3] == h2.GOAWAY:
                assert int.from_bytes(payload[4:8], "big") == \
                    h2.PROTOCOL_ERROR
                break
            assert time.monotonic() < deadline
    finally:
        c.close()
