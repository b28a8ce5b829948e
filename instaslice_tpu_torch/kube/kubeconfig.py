"""A kubeconfig reader that needs no YAML package.

``instaslice_tpu/kube/real.py`` reads a kubeconfig with PyYAML, which
the port does not import (a node's image need not carry it). A
kubeconfig is JSON or block-style YAML, and what kubectl and
``yaml.safe_dump`` write of one uses a small part of YAML: block
mappings, block sequences (the ``- `` of a list may sit at its key's
indent), plain scalars (folded over more-indented continuation lines),
single- and double-quoted scalars, ``{}``/``[]``, comments and a leading
``---``. :func:`load_kubeconfig` reads JSON, and that subset with the
values ``yaml.safe_load`` gives it (null, booleans, integers and floats
of YAML 1.1's plain forms, strings). Anything else (anchors, aliases,
tags, block scalars ``|``/``>``, non-empty flow collections, complex
keys, a second document, tabs in the indentation) raises
:class:`KubeconfigError` naming its line: nothing is guessed.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple


class KubeconfigError(ValueError):
    """The file is neither JSON nor the block YAML a kubeconfig uses."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON",
         "y", "Y"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF",
          "n", "N"}
# YAML 1.1 resolvers of the plain forms safe_load turns into numbers
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def load_kubeconfig(text: str):
    """The kubeconfig ``text`` (JSON or the block YAML subset) as plain
    Python data."""
    if text.lstrip().startswith("{"):
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise KubeconfigError(f"kubeconfig JSON: {e}") from None
    return _Reader(text).document()


class _Reader:
    def __init__(self, text: str) -> None:
        #: (line number, indent, content) of every line that holds more
        #: than a comment
        self.lines: List[Tuple[int, int, str]] = []
        #: line number -> the empty lines just before it (a folded
        #: scalar keeps each as a line break)
        self.blanks: Dict[int, int] = {}
        started, blank = False, 0
        # YAML breaks lines at \n, \r\n and \r only (str.splitlines
        # also splits at \u2028 and the like, which a scalar may hold)
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        self.raw = text.split("\n")
        for no, raw in enumerate(self.raw, 1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if not stripped:
                blank += 1
                continue
            if stripped.startswith("#"):
                continue
            self.blanks[no], blank = blank, 0
            if stripped.startswith("\t") or "\t" in body[:len(body) -
                                                        len(stripped)]:
                raise KubeconfigError(f"line {no}: a tab in the indentation")
            if stripped in ("---", "...") or stripped.startswith("--- "):
                if started or stripped.startswith("--- "):
                    raise KubeconfigError(
                        f"line {no}: more than one document, or content "
                        "after '---'")
                continue
            if stripped.startswith("%"):
                raise KubeconfigError(f"line {no}: YAML directives")
            started = True
            self.lines.append((no, len(body) - len(stripped), stripped))
        self.i = 0

    def document(self):
        if not self.lines:
            return None
        value = self.block(self.lines[0][1])
        if self.i < len(self.lines):
            no, _, text = self.lines[self.i]
            raise KubeconfigError(f"line {no}: unexpected {text!r}")
        return value

    # ---------------------------------------------------------- blocks

    def block(self, indent: int):
        """The mapping, sequence or scalar whose first line is the next,
        at ``indent``."""
        no, ind, text = self.lines[self.i]
        if ind != indent:
            raise KubeconfigError(f"line {no}: bad indentation")
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _split_key(text, no) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.scalar_with_continuation(text, indent - 1, no)

    def mapping(self, indent: int, first: Optional[str] = None) -> dict:
        """A block mapping at ``indent``; ``first`` is its first entry's
        text when it opened on a ``- `` line."""
        out: dict = {}
        while True:
            if first is not None:
                text, no, first = first, self.lines[self.i - 1][0], None
            else:
                if self.i >= len(self.lines):
                    break
                no, ind, text = self.lines[self.i]
                if ind < indent:
                    break
                if ind > indent:
                    raise KubeconfigError(f"line {no}: bad indentation")
                if text == "-" or text.startswith("- "):
                    break
                self.i += 1
            kv = _split_key(text, no)
            if kv is None:
                raise KubeconfigError(
                    f"line {no}: want 'key: value', got {text!r}")
            key, rest = kv
            if key in out:
                raise KubeconfigError(f"line {no}: duplicate key {key!r}")
            out[key] = self.value_after(rest, indent, no)
        return out

    def value_after(self, rest: str, indent: int, no: int):
        """The value of a key at ``indent`` whose line went on with
        ``rest``: inline, or the block on the lines below."""
        if rest:
            return self.scalar_with_continuation(rest, indent, no)
        if self.i < len(self.lines):
            nno, nind, ntext = self.lines[self.i]
            seq = ntext == "-" or ntext.startswith("- ")
            if nind > indent or (nind == indent and seq):
                return self.block(nind)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise KubeconfigError(f"line {no}: bad indentation")
                break
            self.i += 1
            item = text[1:].lstrip(" ")
            if not item:
                deeper = (self.i < len(self.lines)
                          and self.lines[self.i][1] > indent)
                out.append(self.block(self.lines[self.i][1]) if deeper
                           else None)
                continue
            inner = indent + len(text) - len(item)
            if item == "-" or item.startswith("- "):
                raise KubeconfigError(f"line {no}: nested inline sequences")
            if _split_key(item, no) is not None:
                out.append(self.mapping(inner, first=item))
            else:
                out.append(self.scalar_with_continuation(item, indent, no))
        return out

    # --------------------------------------------------------- scalars

    def scalar_with_continuation(self, text: str, indent: int, no: int):
        """A scalar starting with ``text`` on line ``no``, folded over
        the following lines indented deeper than ``indent`` (a quoted
        one over every line up to its closing quote)."""
        if _open_quote(text):
            return _scalar(self.quoted_rest(text, no), no)
        out = text
        while self.i < len(self.lines) and self.lines[self.i][1] > indent:
            nno, _, ntext = self.lines[self.i]
            if _split_key(ntext, nno) is not None:
                break
            self.i += 1
            out += "\n" * self.blanks[nno] or " "
            out += ntext
        return _scalar(out, no)

    def quoted_rest(self, text: str, no: int) -> str:
        """``text``, a quoted scalar opened on line ``no``, with the raw
        lines that follow folded in up to its closing quote (a line
        starting with ``#`` there is text, not a comment)."""
        out, last, blanks = text, no, 0
        while _open_quote(out):
            if last >= len(self.raw):
                raise KubeconfigError(
                    f"line {no}: unterminated quoted scalar")
            line = self.raw[last].strip(" \t")
            last += 1
            if not line:
                blanks += 1
                continue
            tail = len(out) - len(out.rstrip("\\"))
            if out[0] == '"' and tail % 2:
                out = out[:-1] + line   # an escaped line break
            else:
                out += ("\n" * blanks or " ") + line
            blanks = 0
        while self.i < len(self.lines) and self.lines[self.i][0] <= last:
            self.i += 1
        return out


def _open_quote(text: str) -> bool:
    """True when ``text`` opens a quoted scalar it does not close."""
    if not text or text[0] not in "'\"":
        return False
    try:
        _, end = _quoted(text, 0)
    except KubeconfigError:
        return True
    return False


def _split_key(text: str, no: int) -> Optional[Tuple[str, str]]:
    """(key, rest of the line) of a ``key: value`` line, or None."""
    if text.startswith("? "):
        raise KubeconfigError(f"line {no}: complex mapping keys")
    if text[0] in "'\"":
        try:
            key, end = _quoted(text, no)
        except KubeconfigError:
            return None
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, _strip_comment(rest[1:].strip())
        return None
    m = re.match(r"([^#'\"{}\[\],&*!|>%@`][^#]*?)\s*:(\s|$)", text)
    if m is None:
        return None
    key = m.group(1)
    if ": " in key:
        return None
    return key, _strip_comment(text[m.end():].strip())


def _strip_comment(text: str) -> str:
    """``text`` without a trailing `` # comment`` (outside quotes)."""
    if not text or text[0] in "'\"":
        return text
    m = re.search(r"\s#", text)
    return text[:m.start()].rstrip() if m else text


def _quoted(text: str, no: int) -> Tuple[str, int]:
    """The quoted scalar at the start of ``text`` and the index after
    its closing quote."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _HEX_LEN:
                n = _HEX_LEN[e]
                digits = text[i + 2:i + 2 + n]
                if not re.fullmatch(r"[0-9a-fA-F]{%d}" % n, digits):
                    raise KubeconfigError(f"line {no}: bad escape")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            if e not in _ESCAPES:
                raise KubeconfigError(f"line {no}: bad escape \\{e}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise KubeconfigError(f"line {no}: unterminated quoted scalar")


def _scalar(text: str, no: int):
    text = _strip_comment(text)
    if text[:1] in "'\"":
        value, end = _quoted(text, no)
        if text[end:].strip():
            raise KubeconfigError(
                f"line {no}: text after a quoted scalar: {text[end:]!r}")
        return value
    if text in ("{}", "[]"):
        return {} if text == "{}" else []
    if text[:1] in "{[&*!|>%@`":
        raise KubeconfigError(
            f"line {no}: {text[:1]!r} (flow collections, anchors, aliases, "
            "tags and block scalars are not read)")
    if ": " in text or text.endswith(":"):
        raise KubeconfigError(f"line {no}: a mapping inside a plain scalar")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    plain = text.replace("_", "")
    if _INT.match(text):
        return int(plain)
    if _HEX.match(text):
        return int(plain, 16)
    if _OCT.match(text):
        return int(plain, 8)
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(plain)
    if text in (".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"):
        return float("inf")
    if text in ("-.inf", "-.Inf", "-.INF"):
        return float("-inf")
    if text in (".nan", ".NaN", ".NAN"):
        return float("nan")
    return text
