"""HPACK, the header compression of HTTP/2 (RFC 7541), by hand.

New code (the JAX package's plugin rides ``grpcio``, which the card's
machine does not have): what the device plugin's gRPC wire
(:mod:`.h2`, :mod:`.wire`) needs to read the headers a kubelet or a gRPC
client sends and to write its own.

- prefixed integers (§5.1) and string literals (§5.2);
- the static table (Appendix A) and the dynamic table (§2.3.2, §4): an
  entry costs 32 octets plus its name and value, entries are evicted
  from the end, and a size update is legal only at the start of a block
  and within ``SETTINGS_HEADER_TABLE_SIZE`` (§4.2, §6.3);
- the Huffman code (Appendix B), stored as its 257 code lengths: the
  code is canonical (codes ascend by length, then by symbol), so the
  codes follow from the lengths. A padding longer than 7 bits or not
  all ones, and an EOS inside a string, are decoding errors (§5.2).

The :class:`Decoder` reads every representation (§6). The
:class:`Encoder` writes an indexed static entry where name and value
match one, else a literal without indexing (with the static name's
index where only the name matches), each string Huffman-coded where
that is shorter; it keeps no dynamic table, so it has no state but the
size update it owes the peer after a smaller ``HEADER_TABLE_SIZE``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Header = Tuple[str, str]


class HpackError(ValueError):
    """A header block that RFC 7541 calls a decoding error: the
    connection must end with COMPRESSION_ERROR."""


# ------------------------------------------------------- static table

#: Appendix A: index 1..61
STATIC_TABLE: Tuple[Header, ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
)
_STATIC_PAIR = {h: i + 1 for i, h in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {n: i + 1 for i, (n, _) in reversed(list(enumerate(
    STATIC_TABLE)))}

# ------------------------------------------------------------- Huffman

#: Appendix B: the code length of each symbol 0..255 and EOS (256)
CODE_LENGTHS: Tuple[int, ...] = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
)
EOS = 256


def canonical_codes(lengths: Sequence[int]) -> List[int]:
    """The canonical code of each symbol: codes ascend by length, then
    by symbol."""
    order = sorted(range(len(lengths)), key=lambda s: (lengths[s], s))
    codes = [0] * len(lengths)
    code, prev = 0, lengths[order[0]]
    for i, s in enumerate(order):
        if i:
            code = (code + 1) << (lengths[s] - prev)
        codes[s], prev = code, lengths[s]
    return codes


class Huffman:
    """The canonical code of ``lengths``: per length, the first code and
    the symbols in code order, for a decoder that reads a bit at a
    time."""

    def __init__(self, lengths: Sequence[int] = CODE_LENGTHS) -> None:
        self.lengths = tuple(lengths)
        self.codes = canonical_codes(self.lengths)
        self._first: Dict[int, int] = {}
        self._symbols: Dict[int, List[int]] = {}
        for s in sorted(range(len(self.lengths)),
                        key=lambda s: (self.lengths[s], s)):
            n = self.lengths[s]
            self._first.setdefault(n, self.codes[s])
            self._symbols.setdefault(n, []).append(s)
        self._max = max(self.lengths)

    def encoded_len(self, data: bytes) -> int:
        return (sum(self.lengths[b] for b in data) + 7) // 8

    def encode(self, data: bytes) -> bytes:
        acc = bits = 0
        for b in data:
            acc = (acc << self.lengths[b]) | self.codes[b]
            bits += self.lengths[b]
        pad = -bits % 8
        acc = (acc << pad) | ((1 << pad) - 1)      # EOS's leading ones
        return acc.to_bytes((bits + pad) // 8, "big")

    def decode(self, data: bytes) -> bytes:
        out = bytearray()
        code = n = 0
        for byte in data:
            for i in range(7, -1, -1):
                code = (code << 1) | ((byte >> i) & 1)
                n += 1
                first = self._first.get(n)
                if first is not None and code - first < len(
                        self._symbols[n]) and code >= first:
                    sym = self._symbols[n][code - first]
                    if sym == EOS:
                        raise HpackError("EOS inside a Huffman string")
                    out.append(sym)
                    code = n = 0
                elif n >= self._max:
                    raise HpackError("not a Huffman code")
        if n > 7:
            raise HpackError(f"Huffman padding of {n} bits (at most 7)")
        if code != (1 << n) - 1:
            raise HpackError("Huffman padding is not EOS's leading ones")
        return bytes(out)


HUFFMAN = Huffman()

# ------------------------------------------------ integers and strings


def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    """§5.1: ``value`` in an N-bit prefix; ``first`` holds the bits of
    the first octet above the prefix."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 127) | 128)
        value >>= 7
    out.append(value)
    return bytes(out)


#: the largest integer a decoder takes (a table size, an index, a length)
_INT_MAX = 1 << 32


def decode_int(data: bytes, pos: int, prefix: int) -> Tuple[int, int]:
    """(value, next position) of the integer at ``data[pos]``."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 127) << shift
        shift += 7
        if value > _INT_MAX:
            raise HpackError("integer overflow")
        if not b & 128:
            return value, pos


def encode_str(data: bytes, huffman: Optional[bool] = None) -> bytes:
    """§5.2; Huffman-coded where that is shorter unless ``huffman`` says."""
    if huffman is None:
        huffman = HUFFMAN.encoded_len(data) < len(data)
    if huffman:
        data = HUFFMAN.encode(data)
    return encode_int(len(data), 7, 0x80 if huffman else 0) + data


def decode_str(data: bytes, pos: int) -> Tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    coded = bool(data[pos] & 0x80)
    n, pos = decode_int(data, pos, 7)
    if pos + n > len(data):
        raise HpackError("string past the block's end")
    raw = data[pos:pos + n]
    return (HUFFMAN.decode(raw) if coded else raw), pos + n


def _text(b: bytes) -> str:
    # header bytes carried as str one to one, whatever they hold
    return b.decode("latin-1")


# --------------------------------------------------------------- tables


def entry_size(name: str, value: str) -> int:
    """§4.1: 32 octets plus the name's and the value's."""
    return 32 + len(name.encode("latin-1")) + len(value.encode("latin-1"))


class DynamicTable:
    """§2.3.2: newest entry first, evicted from the end."""

    def __init__(self, max_size: int = 4096) -> None:
        self.max_size = max_size
        self.entries: List[Header] = []
        self.size = 0

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict(0)

    def _evict(self, room: int) -> None:
        while self.entries and self.size + room > self.max_size:
            self.size -= entry_size(*self.entries.pop())

    def add(self, name: str, value: str) -> None:
        """§4.4: an entry larger than the table empties it."""
        n = entry_size(name, value)
        self._evict(n)
        if n <= self.max_size:
            self.entries.insert(0, (name, value))
            self.size += n

    def get(self, index: int) -> Header:
        """The header at HPACK ``index`` (static, then dynamic)."""
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if index < 1 or i >= len(self.entries):
            raise HpackError(f"header index {index} out of range")
        return self.entries[i]


class Decoder:
    """One direction of a connection: the dynamic table persists across
    blocks. ``max_table_size`` is the ``SETTINGS_HEADER_TABLE_SIZE`` this
    endpoint advertised (the bound of a size update)."""

    def __init__(self, max_table_size: int = 4096) -> None:
        self.max_table_size = max_table_size
        self.table = DynamicTable(max_table_size)

    def decode(self, block: bytes) -> List[Header]:
        out: List[Header] = []
        pos = 0
        while pos < len(block):
            b = block[pos]
            if b & 0x80:                              # §6.1 indexed
                index, pos = decode_int(block, pos, 7)
                if index == 0:
                    raise HpackError("header index 0")
                out.append(self.table.get(index))
            elif b & 0xE0 == 0x20:                    # §6.3 size update
                if out:
                    raise HpackError("table size update after a header")
                size, pos = decode_int(block, pos, 5)
                if size > self.max_table_size:
                    raise HpackError(
                        f"table size update to {size} over the "
                        f"SETTINGS_HEADER_TABLE_SIZE {self.max_table_size}")
                self.table.resize(size)
            else:                                     # §6.2 literals
                indexing = bool(b & 0x40)
                index, pos = decode_int(block, pos, 6 if indexing else 4)
                if index:
                    name = self.table.get(index)[0]
                else:
                    raw, pos = decode_str(block, pos)
                    name = _text(raw)
                raw, pos = decode_str(block, pos)
                value = _text(raw)
                if indexing:
                    self.table.add(name, value)
                out.append((name, value))
        return out


class Encoder:
    """Indexed static entries and literals without indexing, Huffman
    where shorter; no dynamic table."""

    def __init__(self) -> None:
        self._size_update: Optional[int] = None

    def peer_table_size(self, size: int) -> None:
        """The peer's ``SETTINGS_HEADER_TABLE_SIZE``: a size below the
        default owes it a size update (to 0: this encoder never adds an
        entry) at the start of the next block."""
        if size < 4096:
            self._size_update = 0

    def encode(self, headers: Sequence[Header]) -> bytes:
        out = bytearray()
        if self._size_update is not None:
            out += encode_int(self._size_update, 5, 0x20)
            self._size_update = None
        for name, value in headers:
            index = _STATIC_PAIR.get((name, value))
            if index is not None:
                out += encode_int(index, 7, 0x80)
                continue
            index = _STATIC_NAME.get(name, 0)
            out += encode_int(index, 4, 0x00)
            if not index:
                out += encode_str(name.encode("latin-1"))
            out += encode_str(value.encode("latin-1"))
        return bytes(out)
