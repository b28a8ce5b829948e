"""HPACK (``instaslice_tpu_torch/deviceplugin/hpack.py``) against RFC
7541.

- Appendix C.1-C.6, byte for byte: the integer examples; each header
  block of C.2-C.6 decoded by one decoder per connection into the RFC's
  headers, with the RFC's dynamic table (entries, sizes) after each,
  the evictions of C.5 and C.6 included; the C.4 blocks rebuilt byte
  for byte from the encoder's primitives;
- the Huffman code from its 257 lengths: a Kraft sum of exactly 1, the
  RFC's codes for sample symbols, all 256 byte values round trip;
- decoding errors: padding over 7 bits or not all ones, EOS inside a
  string, an index past the tables, a size update over the setting or
  after a header;
- the encoder's own blocks read back by the decoder.

The control: one code length changed (a Kraft sum that is no longer 1)
no longer decodes C.4.
"""

from fractions import Fraction

import pytest

from instaslice_tpu_torch.deviceplugin import hpack as H


def _hex(s: str) -> bytes:
    return bytes.fromhex("".join(s.split()))


# ------------------------------------------------------------------- C.1

@pytest.mark.parametrize("value,prefix,first,wire", [
    (10, 5, 0, "0a"),              # C.1.1
    (1337, 5, 0, "1f9a0a"),        # C.1.2
    (42, 8, 0, "2a"),              # C.1.3
])
def test_integers(value, prefix, first, wire):
    assert H.encode_int(value, prefix, first) == _hex(wire)
    assert H.decode_int(_hex(wire), 0, prefix) == (value, len(_hex(wire)))


# --------------------------------------------------------- C.2 - C.6

C2 = [
    ("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572",
     [("custom-key", "custom-header")], [("custom-key", "custom-header")]),
    ("040c 2f73 616d 706c 652f 7061 7468",
     [(":path", "/sample/path")], []),
    ("1008 7061 7373 776f 7264 0673 6563 7265 74",
     [("password", "secret")], []),
    ("82", [(":method", "GET")], []),
]

REQ = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com"), ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
REQ_TABLES = [
    [(":authority", "www.example.com")],
    [("cache-control", "no-cache"), (":authority", "www.example.com")],
    [("custom-key", "custom-value"), ("cache-control", "no-cache"),
     (":authority", "www.example.com")],
]
REQ_SIZES = [57, 110, 164]
C3 = ["8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
      "8286 84be 5808 6e6f 2d63 6163 6865",
      "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661"
      " 6c75 65"]
C4 = ["8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
      "8286 84be 5886 a8eb 1064 9cbf",
      "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf"]

DATE1, DATE2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
LOC = "https://www.example.com"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
RESP = [
    [(":status", "302"), ("cache-control", "private"), ("date", DATE1),
     ("location", LOC)],
    [(":status", "307"), ("cache-control", "private"), ("date", DATE1),
     ("location", LOC)],
    [(":status", "200"), ("cache-control", "private"), ("date", DATE2),
     ("location", LOC), ("content-encoding", "gzip"),
     ("set-cookie", COOKIE)],
]
RESP_TABLES = [
    [("location", LOC), ("date", DATE1), ("cache-control", "private"),
     (":status", "302")],
    [(":status", "307"), ("location", LOC), ("date", DATE1),
     ("cache-control", "private")],
    [("set-cookie", COOKIE), ("content-encoding", "gzip"), ("date", DATE2)],
]
RESP_SIZES = [222, 222, 215]
C5 = [
    "4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420"
    " 3230 3133 2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77"
    " 7777 2e65 7861 6d70 6c65 2e63 6f6d",
    "4803 3330 37c1 c0bf",
    "88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32"
    " 3220 474d 54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a"
    " 584f 5157 454f 5049 5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33"
    " 3630 303b 2076 6572 7369 6f6e 3d31",
]
C6 = [
    "4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81"
    " 66e0 82a6 2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3",
    "4883 640e ffc1 c0bf",
    "88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a"
    " 839b d9ab 77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36"
    " 72c1 ab27 0fb5 291f 9587 3160 65c0 03ed 4ee5 b106 3d50 07",
]


@pytest.mark.parametrize("wire,headers,table", C2)
def test_c2_one_block_each(wire, headers, table):
    d = H.Decoder()
    assert d.decode(_hex(wire)) == headers
    assert d.table.entries == table
    assert d.table.size == sum(H.entry_size(*e) for e in table)


@pytest.mark.parametrize("blocks,headers,tables,sizes,max_size", [
    (C3, REQ, REQ_TABLES, REQ_SIZES, 4096),
    (C4, REQ, REQ_TABLES, REQ_SIZES, 4096),
    (C5, RESP, RESP_TABLES, RESP_SIZES, 256),
    (C6, RESP, RESP_TABLES, RESP_SIZES, 256),
], ids=["C.3", "C.4", "C.5", "C.6"])
def test_blocks_of_one_connection(blocks, headers, tables, sizes, max_size):
    """Three blocks through one decoder: the table carries over, and at
    256 octets (C.5, C.6) entries are evicted from the end."""
    d = H.Decoder(max_size)
    d.table.resize(max_size)
    for wire, want, table, size in zip(blocks, headers, tables, sizes):
        assert d.decode(_hex(wire)) == want
        assert d.table.entries == table
        assert d.table.size == size


def test_c4_blocks_from_the_encoders_primitives():
    s = lambda v: H.encode_str(v.encode(), huffman=True)
    assert _hex(C4[0]) == _hex("828684") + b"\x41" + s("www.example.com")
    assert _hex(C4[1]) == _hex("828684be") + b"\x58" + s("no-cache")
    assert _hex(C4[2]) == _hex("828785bf") + b"\x40" + s("custom-key") + \
        s("custom-value")
    # and without Huffman, C.3
    r = lambda v: H.encode_str(v.encode(), huffman=False)
    assert _hex(C3[2]) == _hex("828785bf") + b"\x40" + r("custom-key") + \
        r("custom-value")


# --------------------------------------------------------------- Huffman

def test_code_lengths_are_a_complete_prefix_code():
    assert len(H.CODE_LENGTHS) == 257
    assert sum(Fraction(1, 2 ** n) for n in H.CODE_LENGTHS) == 1


@pytest.mark.parametrize("sym,code,bits", [
    (0, 0x1ff8, 13), (ord(" "), 0x14, 6), (ord("0"), 0x0, 5),
    (ord("a"), 0x3, 5), (ord("\\"), 0x7fff0, 19), (127, 0xffffffc, 28),
    (199, 0x1ffffec, 25), (255, 0x3ffffee, 26), (H.EOS, 0x3fffffff, 30),
])
def test_canonical_codes_are_the_rfcs(sym, code, bits):
    assert (H.HUFFMAN.codes[sym], H.HUFFMAN.lengths[sym]) == (code, bits)


def test_every_byte_round_trips():
    for b in range(256):
        one = bytes([b])
        assert H.HUFFMAN.decode(H.HUFFMAN.encode(one)) == one
    every = bytes(range(256)) * 3
    assert H.HUFFMAN.decode(H.HUFFMAN.encode(every)) == every
    assert H.HUFFMAN.encoded_len(every) == len(H.HUFFMAN.encode(every))


@pytest.mark.parametrize("wire,why", [
    (b"\xff\xff\xff\xff", "EOS inside"),          # 30 ones: EOS, then 2
    (H.HUFFMAN.encode(b"a") + b"\xff", "padding of"),  # 11 bits of pad
    (bytes([0b00011000]), "not EOS's"),           # 'a' then 000 padding
])
def test_padding_and_eos_errors(wire, why):
    with pytest.raises(H.HpackError, match=why):
        H.HUFFMAN.decode(wire)


def test_one_changed_code_length_fails_c4():
    """The control: 'w' one bit longer is another code (its Kraft sum is
    no longer 1), and C.4.1's authority no longer reads as
    www.example.com."""
    lengths = list(H.CODE_LENGTHS)
    lengths[ord("w")] += 1
    assert sum(Fraction(1, 2 ** n) for n in lengths) != 1
    authority = _hex(C4[0])[5:]              # C.4.1's Huffman string
    assert H.HUFFMAN.decode(authority) == b"www.example.com"
    try:
        got = H.Huffman(lengths).decode(authority)
    except H.HpackError:
        return
    assert got != b"www.example.com"


# ----------------------------------------------------------- the decoder

@pytest.mark.parametrize("wire,why", [
    (b"\x80", "index 0"),
    (b"\xbf\x01", "out of range"),                 # index 64, empty table
    (b"\x3f\xe2\x1f", "over the"),                 # size update to 4097
    (b"\x82\x20", "after a header"),
    (b"\x41\x85", "past the block"),
])
def test_decoding_errors(wire, why):
    with pytest.raises(H.HpackError, match=why):
        H.Decoder().decode(wire)


def test_size_update_evicts_and_bounds():
    d = H.Decoder()
    d.decode(_hex(C3[0]))
    assert d.table.size == 57
    d.decode(b"\x20")                             # size update to 0
    assert d.table.entries == [] and d.table.max_size == 0
    d.decode(b"\x3f\xe1\x1f")                     # back to 4096
    assert d.table.max_size == 4096


def test_encoder_blocks_read_back():
    headers = [(":status", "200"), ("content-type", "application/grpc"),
               ("grpc-status", "0"), ("grpc-message", "a%20b"),
               ("x-trace-bin", "AAECAwQFBgcICQ"), ("te", "trailers"),
               (":path", "/v1beta1.DevicePlugin/Allocate")]
    enc = H.Encoder()
    block = enc.encode(headers)
    assert block[0] == 0x88                       # :status 200, indexed
    d = H.Decoder()
    assert d.decode(block) == headers
    assert d.table.entries == []                  # no incremental indexing
    enc.peer_table_size(0)
    again = enc.encode(headers)
    assert again[0] == 0x20 and d.decode(again) == headers
    assert enc.encode(headers) == block           # the update is sent once
