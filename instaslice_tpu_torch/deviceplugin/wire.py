"""gRPC over :mod:`.h2`, and the kubelet device-plugin API's service
surface on it.

The JAX package's ``instaslice_tpu/deviceplugin/wire.py`` declares its
services over ``grpcio``; the card's machine has no ``grpcio``, so the
port speaks gRPC itself (the "gRPC over HTTP2" protocol of the gRPC
project's ``doc/PROTOCOL-HTTP2.md``):

- a request is HEADERS (``:method POST``, ``:path /<service>/<method>``,
  ``content-type application/grpc``, ``te trailers``, ``grpc-timeout``
  where the caller has a deadline, custom metadata) and DATA; each
  message carries a 5-byte prefix, a compressed flag and its length. A
  compressed message is answered with UNIMPLEMENTED (no encoding is
  offered), a ``content-type`` that does not start with
  ``application/grpc`` with HTTP 415;
- a response is HEADERS (``:status 200``), the messages, then trailers
  with ``grpc-status`` and ``grpc-message`` (percent-encoded); an error
  is a trailers-only response;
- ``-bin`` metadata is base64 on the wire and bytes to the application.

:class:`Server` runs unary-unary and unary-stream handlers by full
method name on a unix socket; their ``context`` has ``abort(code,
msg)`` and ``is_active()``, which turns false on RST_STREAM, on GOAWAY
and on stop. :class:`Channel` makes unary calls with a deadline and
streaming calls whose ``cancel()`` sends RST_STREAM CANCEL. Errors are
:class:`RpcError` with ``.code()`` (a :class:`StatusCode`, gRPC's
numbers) and ``.details()``.

On top of these, the reference's surface, against the stable v1beta1
method names: :func:`device_plugin_handler`, :func:`registration_handler`,
:class:`RegistrationClient`, :class:`DevicePluginClient`,
:data:`API_VERSION`, :data:`KUBELET_SOCKET`, :data:`HEALTHY` and
:data:`UNHEALTHY`.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from instaslice_tpu_torch.deviceplugin import h2
from instaslice_tpu_torch.deviceplugin import proto as pb
from instaslice_tpu_torch.utils.lockcheck import named_lock

log = logging.getLogger("instaslice_tpu_torch.deviceplugin.wire")

DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"
REGISTRATION_SERVICE = "v1beta1.Registration"
API_VERSION = "v1beta1"
KUBELET_SOCKET = "kubelet.sock"

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

USER_AGENT = "instaslice-tpu-torch-grpc/1"
#: how long a server waits for a request's body, without a deadline
REQUEST_TIMEOUT = 30.0
#: how often a server's accept loop looks at its stop flag
ACCEPT_POLL = 0.1
#: how long a client waits for a unix socket's connect
CONNECT_TIMEOUT = 5.0


class StatusCode(enum.Enum):
    """gRPC status codes, by their numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(f"{code.name}: {details}")
        self._code, self._details = code, details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


#: gRPC's mapping of an HTTP status other than 200 (PROTOCOL-HTTP2.md)
_HTTP_STATUS = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                403: StatusCode.PERMISSION_DENIED,
                404: StatusCode.UNIMPLEMENTED, 429: StatusCode.UNAVAILABLE,
                502: StatusCode.UNAVAILABLE, 503: StatusCode.UNAVAILABLE,
                504: StatusCode.UNAVAILABLE}

# ------------------------------------------------------------ encodings


def frame_message(payload: bytes) -> bytes:
    """A message with its 5-byte prefix: not compressed, its length."""
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


class MessageReader:
    """Messages out of DATA payloads, which split and join them
    anywhere."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        out = []
        while len(self._buf) >= 5:
            if self._buf[0] not in (0, 1):
                raise RpcError(StatusCode.INTERNAL,
                               f"bad message flag {self._buf[0]}")
            if self._buf[0] == 1:
                raise RpcError(StatusCode.UNIMPLEMENTED,
                               "compressed messages are not supported")
            n = int.from_bytes(self._buf[1:5], "big")
            if len(self._buf) < 5 + n:
                break
            out.append(bytes(self._buf[5:5 + n]))
            del self._buf[:5 + n]
        return out

    @property
    def partial(self) -> bool:
        return bool(self._buf)


def percent_encode(text: str) -> str:
    """``grpc-message``: UTF-8, each byte outside 0x20-0x7E and ``%``
    as ``%XX``."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25
                   else f"%{b:02X}" for b in text.encode("utf-8"))


def percent_decode(text: str) -> str:
    raw, out, i = text.encode("latin-1"), bytearray(), 0
    while i < len(raw):
        hx = raw[i + 1:i + 3]
        if raw[i] == 0x25 and len(hx) == 2 and all(
                c in b"0123456789abcdefABCDEF" for c in hx):
            out.append(int(hx, 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", errors="replace")


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout`` in milliseconds (at most 8 digits)."""
    return f"{max(1, min(int(seconds * 1000), 99_999_999))}m"


_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


def decode_timeout(value: str) -> Optional[float]:
    if len(value) < 2 or value[-1] not in _UNITS or not value[:-1].isdigit():
        return None
    return int(value[:-1]) * _UNITS[value[-1]]


#: request headers that are transport, not metadata
_RESERVED = {"content-type", "te", "grpc-timeout", "grpc-encoding",
             "grpc-accept-encoding", "user-agent"}


def encode_metadata(metadata: Sequence[Tuple[str, object]]) -> List[
        Tuple[str, str]]:
    out = []
    for key, value in metadata:
        key = key.lower()
        if key.endswith("-bin"):
            value = base64.b64encode(bytes(value)).decode().rstrip("=")
        out.append((key, str(value)))
    return out


def decode_metadata(headers: Sequence[Tuple[str, str]]) -> Tuple[
        Tuple[str, object], ...]:
    out = []
    for key, value in headers:
        if key.startswith(":") or key in _RESERVED:
            continue
        if key.endswith("-bin"):
            value = base64.b64decode(value + "=" * (-len(value) % 4))
        out.append((key, value))
    return tuple(out)


def _status(headers) -> Tuple[Optional[StatusCode], str]:
    h = dict(headers or ())
    raw = h.get("grpc-status")
    if raw is None:
        return None, ""
    try:
        code = StatusCode(int(raw))
    except ValueError:
        code = StatusCode.UNKNOWN
    return code, percent_decode(h.get("grpc-message", ""))


# --------------------------------------------------------------- server

@dataclasses.dataclass(frozen=True)
class RpcMethod:
    """A handler: ``fn(request, context)`` returns the response
    (``unary``) or yields the responses (``stream``)."""

    kind: str
    fn: Callable
    request: type
    response: type


class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str) -> None:
        super().__init__(details)
        self.code, self.details = code, details


class ServicerContext:
    """What a handler sees of its call."""

    def __init__(self, server: "Server", conn: h2.Connection,
                 stream: h2.Stream) -> None:
        self._server, self._conn, self._stream = server, conn, stream
        self._metadata = decode_metadata(stream.headers)

    def abort(self, code: StatusCode, details: str) -> None:
        """End the call with ``code``: raises, so it never returns."""
        raise _Abort(code, details)

    def is_active(self) -> bool:
        """False once the peer reset the stream or sent GOAWAY, the
        connection ended, or the server stops."""
        return (self._server.running and self._conn.active
                and self._stream.reset_code is None)

    def invocation_metadata(self) -> Tuple[Tuple[str, object], ...]:
        return self._metadata


class Server:
    """gRPC handlers by full method name (``/service/Method``) on a unix
    socket; each connection has its reader thread, each call its
    handler thread."""

    def __init__(self, name: str = "grpc") -> None:
        self.name = name
        self._methods: Dict[str, RpcMethod] = {}
        self._lock = named_lock("grpc.server")
        self._conns: List[h2.Connection] = []
        self._calls: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self._accept: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.path = ""

    def add_handlers(self, methods: Dict[str, RpcMethod]) -> None:
        self._methods.update(methods)

    @property
    def running(self) -> bool:
        return self._listener is not None and not self._stop.is_set()

    def start(self, path: str) -> "Server":
        """Listen on the unix socket ``path`` (made anew)."""
        if os.path.exists(path):
            os.unlink(path)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(path)
            sock.listen(16)
        except OSError:
            sock.close()
            raise
        # a short accept timeout bounds stop(): where shutdown() does not
        # wake a blocked accept(), the loop sees the stop flag within it
        sock.settimeout(ACCEPT_POLL)
        self._listener, self.path = sock, path
        self._accept = threading.Thread(
            target=self._accept_loop, name=f"{self.name}-accept",
            daemon=True)
        self._accept.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn = h2.Connection(sock, client=False,
                                 on_stream=self._on_stream,
                                 name=f"{self.name}-conn")
            with self._lock:
                self._conns = [c for c in self._conns if not c.closed]
                self._conns.append(conn)
            try:
                conn.start()
            except h2.ConnectionClosed:
                continue

    def _on_stream(self, conn: h2.Connection, stream: h2.Stream) -> None:
        t = threading.Thread(target=self._serve, args=(conn, stream),
                             name=f"{self.name}-call-{stream.id}",
                             daemon=True)
        with self._lock:
            self._calls = [c for c in self._calls if c.is_alive()]
            self._calls.append(t)
        t.start()

    def stop(self, grace: float = 1.0) -> None:
        """Stop accepting; active calls see ``is_active()`` false and get
        ``grace`` seconds to end; then every connection gets GOAWAY and
        is closed."""
        self._stop.set()
        if self._listener is not None:
            try:
                # wakes a blocked accept() at once (close alone does not)
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        if self._accept is not None:
            self._accept.join(grace + h2.POLL)
        deadline = time.monotonic() + grace
        with self._lock:
            calls, conns = list(self._calls), list(self._conns)
        for t in calls:
            t.join(max(0.0, deadline - time.monotonic()))
        for c in conns:
            c.close()
            c.join(h2.POLL)

    # ----------------------------------------------------------- a call

    def _serve(self, conn: h2.Connection, stream: h2.Stream) -> None:
        headers = dict(stream.headers)
        sent = False
        try:
            if headers.get(":method") != "POST":
                conn.send_headers(stream, [(":status", "405")], True)
                return
            if not headers.get("content-type", "").startswith(
                    "application/grpc"):
                conn.send_headers(stream, [(":status", "415")], True)
                return
            timeout = decode_timeout(headers.get("grpc-timeout", ""))
            method = self._methods.get(headers.get(":path", ""))
            if method is None:
                raise _Abort(StatusCode.UNIMPLEMENTED,
                             f"Method not found: {headers.get(':path')}")
            request = method.request.decode(self._read_request(
                conn, stream, timeout))
            ctx = ServicerContext(self, conn, stream)
            if method.kind == "unary":
                body = frame_message(method.fn(request, ctx).encode())
                conn.send_headers(stream, _RESPONSE_HEADERS)
                sent = True
                conn.send_data(stream, body, False)
            else:
                responses = method.fn(request, ctx)
                try:
                    for response in responses:
                        if not ctx.is_active():
                            return
                        if not sent:
                            conn.send_headers(stream, _RESPONSE_HEADERS)
                            sent = True
                        conn.send_data(stream, frame_message(
                            response.encode()), False)
                finally:
                    close = getattr(responses, "close", None)
                    if close is not None:
                        close()
                if not ctx.is_active():
                    return
            self._finish(conn, stream, sent, StatusCode.OK, "")
        except _Abort as a:
            self._finish(conn, stream, sent, a.code, a.details)
        except RpcError as e:
            self._finish(conn, stream, sent, e.code(), e.details())
        except pb.DecodeError as e:
            self._finish(conn, stream, sent, StatusCode.INTERNAL,
                         f"could not parse the request: {e}")
        except (h2.StreamReset, h2.ConnectionClosed, TimeoutError):
            pass
        except Exception as e:  # noqa: BLE001 - the call's boundary
            log.exception("%s: handler of %s raised", self.name,
                          headers.get(":path"))
            self._finish(conn, stream, sent, StatusCode.UNKNOWN,
                         f"Exception calling application: {e}")

    def _read_request(self, conn: h2.Connection, stream: h2.Stream,
                      timeout: Optional[float]) -> bytes:
        reader, got = MessageReader(), []
        deadline = time.monotonic() + (REQUEST_TIMEOUT if timeout is None
                                       else timeout)
        while True:
            chunk = conn.read_data(stream, max(
                0.001, deadline - time.monotonic()))
            if not chunk:
                break
            got += reader.feed(chunk)
        if len(got) != 1 or reader.partial:
            raise _Abort(StatusCode.INTERNAL, f"a unary request carries one "
                         f"message, got {len(got)}")
        return got[0]

    @staticmethod
    def _finish(conn: h2.Connection, stream: h2.Stream, sent: bool,
                code: StatusCode, details: str) -> None:
        trailers = [("grpc-status", str(code.value))]
        if details:
            trailers.append(("grpc-message", percent_encode(details)))
        try:
            conn.send_headers(stream, trailers if sent else
                              _RESPONSE_HEADERS + trailers, True)
        except (h2.StreamReset, h2.ConnectionClosed):
            pass


_RESPONSE_HEADERS = [(":status", "200"), ("content-type", "application/grpc")]


def unary_unary(fn, request: type, response: type) -> RpcMethod:
    return RpcMethod("unary", fn, request, response)


def unary_stream(fn, request: type, response: type) -> RpcMethod:
    return RpcMethod("stream", fn, request, response)


# --------------------------------------------------------------- client

class Channel:
    """Calls over one HTTP/2 connection to ``target`` (``unix://path``
    or a path), made on first use and again after it ends."""

    def __init__(self, target: str) -> None:
        self.path = target[len("unix://"):] if target.startswith(
            "unix://") else target
        self._lock = named_lock("grpc.channel")
        self._conn: Optional[h2.Connection] = None

    def __enter__(self) -> "Channel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()
            conn.join(h2.POLL)

    def connection(self) -> h2.Connection:
        with self._lock:
            if self._conn is not None and self._conn.active:
                return self._conn
            if self._conn is not None:
                self._conn.close()          # after GOAWAY: a new one
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(CONNECT_TIMEOUT)
            try:
                sock.connect(self.path)
            except OSError as e:
                sock.close()
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"cannot connect to {self.path}: {e}") from e
            self._conn = h2.Connection(sock, client=True,
                                       name="grpc-client").start()
            return self._conn

    def unary_unary(self, method: str, response: type) -> Callable:
        def call(request, timeout: Optional[float] = None,
                 metadata: Sequence = ()):
            c = _Call(self, method, request, timeout, metadata)
            try:
                msgs = list(c)
            finally:
                c.cancel()
            if len(msgs) != 1:
                raise RpcError(StatusCode.INTERNAL, f"a unary response "
                               f"carries one message, got {len(msgs)}")
            return response.decode(msgs[0])
        return call

    def unary_stream(self, method: str, response: type) -> Callable:
        def call(request, timeout: Optional[float] = None,
                 metadata: Sequence = ()):
            return _StreamCall(_Call(self, method, request, timeout,
                                     metadata), response)
        return call


class _Call:
    """One call's stream: yields its response messages (bytes), then
    raises :class:`RpcError` unless the status is OK."""

    def __init__(self, channel: Channel, method: str, request,
                 timeout: Optional[float], metadata: Sequence) -> None:
        self.deadline = None if timeout is None else \
            time.monotonic() + timeout
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", method), (":authority", "localhost"),
                   ("te", "trailers"), ("content-type", "application/grpc"),
                   ("user-agent", USER_AGENT)]
        if timeout is not None:
            headers.append(("grpc-timeout", encode_timeout(timeout)))
        headers += encode_metadata(metadata)
        self.cancelled = False
        self._reader = MessageReader()
        self._ready: List[bytes] = []
        self._done = False
        try:
            self.conn = channel.connection()
            self.stream = self.conn.open_stream(headers)
            self.conn.send_data(self.stream, frame_message(
                request.encode()), True, self._left(h2.IO_TIMEOUT))
        except (h2.ConnectionClosed, h2.StreamReset) as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e)) from e
        except TimeoutError as e:
            raise self._expired() from e

    def _left(self, default: Optional[float]) -> Optional[float]:
        if self.deadline is None:
            return default
        return self.deadline - time.monotonic()

    def _expired(self) -> RpcError:
        self.cancel()
        return RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")

    def cancel(self) -> None:
        """RST_STREAM CANCEL, unless the call already ended."""
        if not self._done:
            self._done = self.cancelled = True
            self.conn.reset(self.stream, h2.CANCEL)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        return self.next(None)

    def next(self, timeout: Optional[float]) -> bytes:
        """The next message; ``TimeoutError`` after ``timeout`` seconds
        (the call stays usable), :class:`RpcError` at the deadline."""
        wait_until = None if timeout is None else time.monotonic() + timeout
        while not self._ready:
            if self.cancelled:
                raise RpcError(StatusCode.CANCELLED, "Locally cancelled")
            if self._done:
                raise StopIteration
            left = [t for t in (self._left(None), None if wait_until is None
                                else wait_until - time.monotonic())
                    if t is not None]
            try:
                self._pull(min(left) if left else None)
            except TimeoutError:
                if self.deadline is not None and \
                        time.monotonic() >= self.deadline:
                    raise self._expired() from None
                raise
        return self._ready.pop(0)

    def _pull(self, timeout: Optional[float]) -> None:
        """Read what the stream has next: headers, a message, trailers."""
        s, conn = self.stream, self.conn
        try:
            conn.wait(s, lambda s: s.headers is not None, timeout)
            http = dict(s.headers).get(":status", "")
            if http != "200":
                self._done = True
                raise RpcError(_HTTP_STATUS.get(
                    int(http) if http.isdigit() else 0, StatusCode.UNKNOWN),
                    f"HTTP status {http}")
            chunk = conn.read_data(s, timeout)
        except h2.StreamReset as e:
            self._done = True
            raise RpcError(StatusCode.CANCELLED if e.code == h2.CANCEL
                           else StatusCode.INTERNAL, str(e)) from e
        except h2.ConnectionClosed as e:
            self._done = True
            raise RpcError(StatusCode.UNAVAILABLE, str(e)) from e
        if chunk:
            self._ready += self._reader.feed(chunk)
            return
        # a trailers-only response ends in its one header block
        self._end(s.trailers or s.headers)

    def _end(self, trailers) -> None:
        self._done = True
        code, details = _status(trailers)
        if code is None:
            raise RpcError(StatusCode.INTERNAL, "no grpc-status in trailers")
        if code is not StatusCode.OK:
            raise RpcError(code, details)
        if self._reader.partial:
            raise RpcError(StatusCode.INTERNAL, "a message cut short")


class _StreamCall:
    """A server-streaming call: an iterator of responses with
    ``cancel()`` and ``next(timeout)``."""

    def __init__(self, call: _Call, response: type) -> None:
        self._call, self._response = call, response

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._response.decode(next(self._call))

    def next(self, timeout: Optional[float] = None):
        return self._response.decode(self._call.next(timeout))

    def cancel(self) -> None:
        self._call.cancel()


# ------------------------------------------------ the v1beta1 surface

def device_plugin_handler(servicer) -> Dict[str, RpcMethod]:
    """``servicer`` as v1beta1.DevicePlugin: GetDevicePluginOptions /
    ListAndWatch / GetPreferredAllocation / Allocate / PreStartContainer
    with the usual ``(request, context)`` signatures (ListAndWatch is a
    generator)."""
    s = f"/{DEVICE_PLUGIN_SERVICE}/"
    return {
        s + "GetDevicePluginOptions": unary_unary(
            servicer.GetDevicePluginOptions, pb.Empty,
            pb.DevicePluginOptions),
        s + "ListAndWatch": unary_stream(
            servicer.ListAndWatch, pb.Empty, pb.ListAndWatchResponse),
        s + "GetPreferredAllocation": unary_unary(
            servicer.GetPreferredAllocation, pb.PreferredAllocationRequest,
            pb.PreferredAllocationResponse),
        s + "Allocate": unary_unary(
            servicer.Allocate, pb.AllocateRequest, pb.AllocateResponse),
        s + "PreStartContainer": unary_unary(
            servicer.PreStartContainer, pb.PreStartContainerRequest,
            pb.PreStartContainerResponse),
    }


def registration_handler(servicer) -> Dict[str, RpcMethod]:
    """v1beta1.Registration, served by the kubelet (here: by a fake
    kubelet)."""
    return {f"/{REGISTRATION_SERVICE}/Register": unary_unary(
        servicer.Register, pb.RegisterRequest, pb.Empty)}


class RegistrationClient:
    """Client stub for the kubelet's Registration service."""

    def __init__(self, channel: Channel) -> None:
        self._register = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/Register", pb.Empty)

    def register(
        self, endpoint: str, resource_name: str, *,
        preferred_allocation: bool = True, timeout: float = 5.0,
    ) -> None:
        req = pb.RegisterRequest(
            version=API_VERSION,
            endpoint=endpoint,
            resource_name=resource_name,
            options=pb.DevicePluginOptions(
                pre_start_required=False,
                get_preferred_allocation_available=preferred_allocation,
            ),
        )
        self._register(req, timeout=timeout)


class DevicePluginClient:
    """Client stub for a plugin's DevicePlugin service (the kubelet's
    side of the wire)."""

    def __init__(self, channel: Channel) -> None:
        s = f"/{DEVICE_PLUGIN_SERVICE}/"
        mk = channel.unary_unary
        self._options = mk(s + "GetDevicePluginOptions",
                           pb.DevicePluginOptions)
        self._list_and_watch = channel.unary_stream(
            s + "ListAndWatch", pb.ListAndWatchResponse)
        self._preferred = mk(s + "GetPreferredAllocation",
                             pb.PreferredAllocationResponse)
        self._allocate = mk(s + "Allocate", pb.AllocateResponse)
        self._pre_start = mk(s + "PreStartContainer",
                             pb.PreStartContainerResponse)

    def options(self, timeout: float = 5.0) -> pb.DevicePluginOptions:
        return self._options(pb.Empty(), timeout=timeout)

    def list_and_watch(self, timeout: Optional[float] = None):
        """Yields ListAndWatchResponse until the stream is cancelled."""
        return self._list_and_watch(pb.Empty(), timeout=timeout)

    def preferred(self, available, size, must_include=(), timeout=5.0):
        req = pb.PreferredAllocationRequest(
            container_requests=[
                pb.ContainerPreferredAllocationRequest(
                    available_deviceIDs=list(available),
                    must_include_deviceIDs=list(must_include),
                    allocation_size=size,
                )
            ]
        )
        return self._preferred(req, timeout=timeout)

    def allocate(self, device_ids, timeout: float = 5.0,
                 metadata: Sequence = ()):
        req = pb.AllocateRequest(
            container_requests=[
                pb.ContainerAllocateRequest(devicesIDs=list(device_ids))
            ]
        )
        return self._allocate(req, timeout=timeout, metadata=metadata)

    def pre_start(self, device_ids, timeout: float = 5.0):
        return self._pre_start(
            pb.PreStartContainerRequest(devicesIDs=list(device_ids)),
            timeout=timeout,
        )
