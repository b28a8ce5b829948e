"""An HTTP/2 connection (RFC 7540) over a stream socket, by hand.

New code, the transport of the device plugin's gRPC wire (:mod:`.wire`):
the card's machine has no ``grpcio`` and no HTTP/2 library. One
:class:`Connection` serves either end (``client=True`` sends the
preface and opens odd streams; a server reads the preface and hands each
stream a peer opens to ``on_stream``):

- the preface, SETTINGS and their ACK; a setting this endpoint does not
  know is ignored (§6.5.2), and an ``INITIAL_WINDOW_SIZE`` change moves
  every stream's send window by its delta (§6.9.2);
- PING answered with ACK and the same 8 bytes (§6.7);
- flow control in both directions (§5.2, §6.9): a sender waits for the
  peer's connection and stream windows and for WINDOW_UPDATE; a receiver
  gives the connection's credit back as DATA arrives and a stream's as
  its reader consumes it (padding at once);
- the peer's MAX_FRAME_SIZE; a header block longer than it is split over
  HEADERS and CONTINUATION frames (§6.10), and one received must arrive
  whole before any other frame; the PADDED and PRIORITY flags of
  HEADERS and DATA are honoured; PRIORITY frames and frame types this
  endpoint does not know are ignored (§4.1, §5.5);
- RST_STREAM ends a stream, GOAWAY the connection (§6.4, §6.8); a
  connection error is answered with GOAWAY and its code (§5.4.1).

One reader thread per connection; every frame is written under one lock
per connection, a header block with its CONTINUATIONs in one write. The
socket has a timeout, so no read or write blocks for ever: the reader
wakes to see whether the connection was closed, a write that times out
closes it.
"""

from __future__ import annotations

import collections
import logging
import socket
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from instaslice_tpu_torch.deviceplugin.hpack import (
    Decoder,
    Encoder,
    Header,
    HpackError,
)
from instaslice_tpu_torch.utils.lockcheck import named_condition, named_lock

log = logging.getLogger("instaslice_tpu_torch.deviceplugin.h2")

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (§6)
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, \
    GOAWAY, WINDOW_UPDATE, CONTINUATION = range(10)
# flags
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20
# error codes (§7)
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, \
    SETTINGS_TIMEOUT, STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, \
    CANCEL, COMPRESSION_ERROR = range(10)
# settings (§6.5.2)
HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, \
    INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE = range(1, 7)

DEFAULT_WINDOW = 65535
DEFAULT_FRAME = 16384
MAX_WINDOW = 2 ** 31 - 1
MAX_FRAME = 2 ** 24 - 1
#: a socket write that makes no progress for this long ends the connection
IO_TIMEOUT = 10.0
#: how often a blocked reader looks whether its connection was closed
POLL = 1.0


class H2Error(Exception):
    """A connection error: GOAWAY with ``code``."""

    def __init__(self, code: int, msg: str) -> None:
        super().__init__(msg)
        self.code = code


class ConnectionClosed(Exception):
    """The connection ended (GOAWAY, EOF, an error, or close())."""


class StreamReset(Exception):
    """The stream was reset: ``code`` is the RST_STREAM error code."""

    def __init__(self, code: int) -> None:
        super().__init__(f"stream reset (error code {code})")
        self.code = code


def frame(ftype: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    """One frame (§4.1): 24-bit length, type, flags, 31-bit stream id."""
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
            + (sid & MAX_WINDOW).to_bytes(4, "big") + payload)


def settings_payload(values: Dict[int, int]) -> bytes:
    return b"".join(k.to_bytes(2, "big") + v.to_bytes(4, "big")
                    for k, v in values.items())


class Stream:
    """One stream's state; guarded by its connection's condition."""

    def __init__(self, sid: int, send_window: int) -> None:
        self.id = sid
        self.headers: Optional[List[Header]] = None
        self.trailers: Optional[List[Header]] = None
        self.data: Deque[bytes] = collections.deque()
        self.send_window = send_window
        self.recv_window = DEFAULT_WINDOW
        self.remote_closed = False
        self.local_closed = False
        #: the RST_STREAM code, once reset (by either end)
        self.reset_code: Optional[int] = None


class Connection:
    """One HTTP/2 connection over ``sock``. ``on_stream(conn, stream)``
    (a server's) is called from the reader thread with each stream the
    peer opens, its request headers read: it must not block."""

    def __init__(self, sock: socket.socket, *, client: bool,
                 on_stream: Optional[Callable] = None,
                 name: str = "h2") -> None:
        sock.settimeout(IO_TIMEOUT)
        self.sock = sock
        self.client = client
        self.on_stream = on_stream
        self.name = name
        self._wlock = named_lock("h2.write")
        self._cv = named_condition("h2.state")
        self.streams: Dict[int, Stream] = {}
        self._next_id = 1 if client else 2
        self.last_peer_id = 0
        self.send_window = DEFAULT_WINDOW
        self.recv_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_FRAME
        self.decoder = Decoder()
        self.encoder = Encoder()
        self.closed = False
        self.goaway: Optional[Tuple[int, int]] = None  # (last id, code)
        self._block: Optional[Tuple[int, int, bytearray]] = None
        self._reader: Optional[threading.Thread] = None

    # ------------------------------------------------------- lifecycle

    def start(self) -> "Connection":
        if self.client:
            self._write(PREFACE + frame(SETTINGS, 0, 0, settings_payload(
                {ENABLE_PUSH: 0})))
        else:
            self._write(frame(SETTINGS, 0, 0))
        self._reader = threading.Thread(
            target=self._read_loop, name=f"{self.name}-reader", daemon=True)
        self._reader.start()
        return self

    def close(self, code: int = NO_ERROR, msg: str = "") -> None:
        """GOAWAY (best effort), then the socket; every open stream
        ends."""
        with self._cv:
            if self.closed:
                return
        try:
            self._write(frame(GOAWAY, 0, 0, self.last_peer_id.to_bytes(
                4, "big") + code.to_bytes(4, "big") + msg.encode()[:256]))
        except ConnectionClosed:
            pass
        self._teardown()

    def _teardown(self) -> None:
        with self._cv:
            self.closed = True
            for s in self.streams.values():
                if s.reset_code is None:
                    s.reset_code = CANCEL
            self.streams.clear()
            self._cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def join(self, timeout: float) -> None:
        if self._reader is not None:
            self._reader.join(timeout)

    @property
    def active(self) -> bool:
        """Open, and no GOAWAY received."""
        return not self.closed and self.goaway is None

    # ---------------------------------------------------------- writing

    def _write(self, data: bytes) -> None:
        with self._wlock:
            if self.closed:
                raise ConnectionClosed(f"{self.name}: closed")
            try:
                self.sock.sendall(data)
            except OSError as e:
                closed = e
            else:
                return
        self._teardown()
        raise ConnectionClosed(f"{self.name}: write failed: {closed}")

    def _header_frames(self, sid: int, headers: List[Header],
                       end_stream: bool) -> bytes:
        """HEADERS, then CONTINUATION, each within the peer's
        MAX_FRAME_SIZE (callers hold the write lock: the encoder's state
        and the frames' order go together)."""
        block = self.encoder.encode(headers)
        n = self.peer_max_frame
        parts = [block[i:i + n] for i in range(0, len(block), n)] or [b""]
        out = []
        for i, part in enumerate(parts):
            flags = END_HEADERS if i == len(parts) - 1 else 0
            if i == 0:
                out.append(frame(HEADERS, flags | (
                    END_STREAM if end_stream else 0), sid, part))
            else:
                out.append(frame(CONTINUATION, flags, sid, part))
        return b"".join(out)

    def open_stream(self, headers: List[Header],
                    end_stream: bool = False) -> Stream:
        """A client's new stream, its request headers sent (ids are
        taken and sent in one write, so they ascend on the wire)."""
        with self._wlock:
            with self._cv:
                if not self.active:
                    raise ConnectionClosed(f"{self.name}: not open")
                sid = self._next_id
                self._next_id += 2
                stream = Stream(sid, self.peer_initial_window)
                stream.local_closed = end_stream
                self.streams[sid] = stream
            data = self._header_frames(sid, headers, end_stream)
            try:
                self.sock.sendall(data)
                return stream
            except OSError as e:
                failed = e
        self._teardown()
        raise ConnectionClosed(f"{self.name}: write failed: {failed}")

    def send_headers(self, stream: Stream, headers: List[Header],
                     end_stream: bool = False) -> None:
        self._check_open(stream)
        with self._wlock:
            data = self._header_frames(stream.id, headers, end_stream)
        self._write(data)
        if end_stream:
            self._local_end(stream)

    def send_data(self, stream: Stream, data: bytes, end_stream: bool,
                  timeout: float = IO_TIMEOUT) -> None:
        """DATA within the peer's windows and frame size; waits up to
        ``timeout`` for window each time it is spent."""
        view = memoryview(bytes(data))
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                while True:
                    self._check_open(stream)
                    room = min(self.send_window, stream.send_window)
                    if room > 0 or not view:
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError(
                            f"{self.name}: stream {stream.id} waited "
                            f"{timeout} s for flow-control window")
                    self._cv.wait(min(left, POLL))
                n = min(len(view), room, self.peer_max_frame)
                self.send_window -= n
                stream.send_window -= n
            last = n == len(view)
            self._write(frame(DATA, END_STREAM if end_stream and last
                              else 0, stream.id, view[:n].tobytes()))
            view = view[n:]
            if last:
                break
        if end_stream:
            self._local_end(stream)

    def reset(self, stream: Stream, code: int = CANCEL) -> None:
        with self._cv:
            if stream.reset_code is not None or self.closed:
                return
            stream.reset_code = code
            self.streams.pop(stream.id, None)
            self._cv.notify_all()
        try:
            self._write(frame(RST_STREAM, 0, stream.id,
                              code.to_bytes(4, "big")))
        except ConnectionClosed:
            pass

    def _check_open(self, stream: Stream) -> None:
        if stream.reset_code is not None:
            raise StreamReset(stream.reset_code)
        if self.closed:
            raise ConnectionClosed(f"{self.name}: closed")

    def _local_end(self, stream: Stream) -> None:
        with self._cv:
            stream.local_closed = True
            if stream.remote_closed:
                self.streams.pop(stream.id, None)

    # ---------------------------------------------------------- reading

    def wait(self, stream: Stream, what: Callable[[Stream], bool],
             timeout: Optional[float]) -> None:
        """Until ``what(stream)`` holds; raises :class:`StreamReset`,
        :class:`ConnectionClosed` or ``TimeoutError``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not what(stream):
                self._check_open(stream)
                left = POLL if deadline is None else deadline - \
                    time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{self.name}: stream {stream.id}")
                self._cv.wait(min(left, POLL))

    def read_data(self, stream: Stream,
                  timeout: Optional[float] = None) -> bytes:
        """The next DATA payload, b"" once the peer ended the stream; its
        bytes are credited back to the stream's window."""
        self.wait(stream, lambda s: s.data or s.remote_closed
                  or s.reset_code is not None, timeout)
        with self._cv:
            if not stream.data:
                if stream.reset_code is not None:
                    raise StreamReset(stream.reset_code)
                return b""
            chunk = stream.data.popleft()
            credit = not stream.remote_closed and chunk
            if credit:
                stream.recv_window += len(chunk)
        if credit:
            self._window_update(stream.id, len(chunk))
        return chunk

    def _window_update(self, sid: int, n: int) -> None:
        if n:
            try:
                self._write(frame(WINDOW_UPDATE, 0, sid, n.to_bytes(4,
                                                                    "big")))
            except ConnectionClosed:
                pass

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except socket.timeout:
                if self.closed:
                    raise ConnectionClosed(self.name)
                continue
            if not chunk:
                raise ConnectionClosed(f"{self.name}: EOF")
            buf += chunk
        return bytes(buf)

    def _read_loop(self) -> None:
        try:
            if not self.client and self._recv_exact(len(PREFACE)) \
                    != PREFACE:
                raise H2Error(PROTOCOL_ERROR, "bad client preface")
            while True:
                head = self._recv_exact(9)
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                sid = int.from_bytes(head[5:9], "big") & MAX_WINDOW
                if length > DEFAULT_FRAME:
                    raise H2Error(FRAME_SIZE_ERROR,
                                  f"frame of {length} bytes")
                self._on_frame(ftype, flags, sid, self._recv_exact(length))
        except H2Error as e:
            log.warning("%s: connection error %d: %s", self.name, e.code, e)
            self.close(e.code, str(e))
        except (ConnectionClosed, OSError):
            pass
        finally:
            self._teardown()

    # ----------------------------------------------------------- frames

    def _on_frame(self, ftype: int, flags: int, sid: int,
                  payload: bytes) -> None:
        if self._block is not None and (ftype != CONTINUATION
                                        or sid != self._block[0]):
            raise H2Error(PROTOCOL_ERROR, "header block interrupted")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            if sid == 0:
                raise H2Error(PROTOCOL_ERROR, "HEADERS on stream 0")
            body = _unpad(flags, payload)
            if flags & PRIORITY_FLAG:
                if len(body) < 5:
                    raise H2Error(FRAME_SIZE_ERROR, "short PRIORITY fields")
                body = body[5:]
            self._block = (sid, flags, bytearray(body))
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == CONTINUATION:
            if self._block is None:
                raise H2Error(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
            self._block[2].extend(payload)
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == RST_STREAM:
            if sid == 0 or len(payload) != 4:
                raise H2Error(PROTOCOL_ERROR, "bad RST_STREAM")
            with self._cv:
                s = self.streams.pop(sid, None)
                if s is not None:
                    s.reset_code = int.from_bytes(payload, "big")
                    self._cv.notify_all()
        elif ftype == SETTINGS:
            self._on_settings(flags, sid, payload)
        elif ftype == PING:
            if sid != 0 or len(payload) != 8:
                raise H2Error(PROTOCOL_ERROR, "bad PING")
            if not flags & ACK:
                self._write(frame(PING, ACK, 0, payload))
        elif ftype == GOAWAY:
            if len(payload) < 8:
                raise H2Error(FRAME_SIZE_ERROR, "short GOAWAY")
            last = int.from_bytes(payload[:4], "big") & MAX_WINDOW
            code = int.from_bytes(payload[4:8], "big")
            with self._cv:
                self.goaway = (last, code)
                for s in list(self.streams.values()):
                    if s.id > last or not self.client:
                        s.reset_code = REFUSED_STREAM if s.id > last \
                            else CANCEL
                        self.streams.pop(s.id)
                self._cv.notify_all()
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise H2Error(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
            inc = int.from_bytes(payload, "big") & MAX_WINDOW
            with self._cv:
                target = self if sid == 0 else self.streams.get(sid)
                if inc == 0 and sid == 0:
                    raise H2Error(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                if target is not None:
                    target.send_window += inc
                    if target.send_window > MAX_WINDOW:
                        raise H2Error(FLOW_CONTROL_ERROR,
                                      "window over 2^31 - 1")
                    self._cv.notify_all()
        elif ftype == PUSH_PROMISE:
            raise H2Error(PROTOCOL_ERROR, "PUSH_PROMISE (push is off)")
        # PRIORITY and frame types this endpoint does not know: ignored

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise H2Error(PROTOCOL_ERROR, "DATA on stream 0")
        if len(payload) > self.recv_window:
            raise H2Error(FLOW_CONTROL_ERROR, "DATA past the window")
        # the connection's credit goes back at once: one stream's unread
        # data never stalls the others
        self._window_update(0, len(payload))
        body = _unpad(flags, payload)
        with self._cv:
            s = self.streams.get(sid)
            if s is None or s.remote_closed:
                if sid > self.last_peer_id and not self.client:
                    raise H2Error(PROTOCOL_ERROR, f"DATA on idle stream "
                                  f"{sid}")
                return                           # a closed stream's: drop
            s.recv_window -= len(payload)
            if s.recv_window < 0:
                raise H2Error(FLOW_CONTROL_ERROR, f"stream {sid} DATA past "
                              "its window")
            pad = len(payload) - len(body)
            s.recv_window += pad
            if body:
                s.data.append(body)
            if flags & END_STREAM:
                self._remote_end(s)
            self._cv.notify_all()
        if pad and not flags & END_STREAM:
            self._window_update(sid, pad)

    def _remote_end(self, s: Stream) -> None:
        s.remote_closed = True
        if s.local_closed:
            self.streams.pop(s.id, None)

    def _end_block(self) -> None:
        sid, flags, block = self._block
        self._block = None
        try:
            # decoded whatever the stream: the table must follow the peer
            headers = self.decoder.decode(bytes(block))
        except HpackError as e:
            raise H2Error(COMPRESSION_ERROR, str(e)) from e
        new = None
        with self._cv:
            s = self.streams.get(sid)
            if s is None:
                if self.client:
                    return                         # a stream we reset
                if sid % 2 == 0 or sid <= self.last_peer_id:
                    raise H2Error(PROTOCOL_ERROR,
                                  f"HEADERS opening stream {sid}")
                self.last_peer_id = sid
                s = new = Stream(sid, self.peer_initial_window)
                self.streams[sid] = s
                s.headers = headers
            elif s.headers is None:
                s.headers = headers
            else:
                if not flags & END_STREAM:
                    raise H2Error(PROTOCOL_ERROR, "trailers without "
                                  "END_STREAM")
                s.trailers = headers
            if flags & END_STREAM:
                self._remote_end(s)
            self._cv.notify_all()
        if new is not None and self.on_stream is not None:
            self.on_stream(self, new)

    def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        if sid != 0:
            raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            if payload:
                raise H2Error(FRAME_SIZE_ERROR, "SETTINGS ACK with a body")
            return
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "SETTINGS not 6-byte entries")
        table = None
        with self._cv:
            for i in range(0, len(payload), 6):
                key = int.from_bytes(payload[i:i + 2], "big")
                value = int.from_bytes(payload[i + 2:i + 6], "big")
                if key == INITIAL_WINDOW_SIZE:
                    if value > MAX_WINDOW:
                        raise H2Error(FLOW_CONTROL_ERROR,
                                      "INITIAL_WINDOW_SIZE over 2^31 - 1")
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for s in self.streams.values():
                        s.send_window += delta
                elif key == MAX_FRAME_SIZE:
                    if not DEFAULT_FRAME <= value <= MAX_FRAME:
                        raise H2Error(PROTOCOL_ERROR,
                                      f"MAX_FRAME_SIZE {value}")
                    self.peer_max_frame = value
                elif key == HEADER_TABLE_SIZE:
                    table = value
                elif key == ENABLE_PUSH and value > 1:
                    raise H2Error(PROTOCOL_ERROR, f"ENABLE_PUSH {value}")
                # MAX_CONCURRENT_STREAMS, MAX_HEADER_LIST_SIZE and
                # settings this endpoint does not know: nothing to do
            self._cv.notify_all()
        if table is not None:
            # the encoder goes with the write lock, never taken under the
            # state condition (open_stream takes them the other way)
            with self._wlock:
                self.encoder.peer_table_size(table)
        self._write(frame(SETTINGS, ACK, 0))


def _unpad(flags: int, payload: bytes) -> bytes:
    """A PADDED frame's body without its pad length byte and padding."""
    if not flags & PADDED:
        return payload
    if not payload or payload[0] >= len(payload):
        raise H2Error(PROTOCOL_ERROR, "padding longer than the frame")
    return payload[1:len(payload) - payload[0]]
