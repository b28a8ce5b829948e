"""Render the port's deploy plane to YAML:
``python -m instaslice_tpu_torch.deploy.gen_manifests [--check]``.

Writes ``deploy/config/`` (the kustomize tree) and ``deploy/samples/``
from :mod:`.manifests`, the port's counterpart of
``tools/gen_manifests.py``. With ``--check`` it writes nothing and exits
1 when a checked-in file differs from the rendering (or is missing, or
is left over), naming each.

The YAML is block style in the subset the port's own reader takes
(:func:`~instaslice_tpu_torch.kube.kubeconfig.load_kubeconfig`): block
mappings and sequences, ``{}``/``[]`` for empty ones, a letters-first
name plain, every other string double-quoted as JSON quotes it, and a
file's documents split by ``---`` lines. So no YAML library is needed
to write it or to read it back (:func:`load_documents`).
"""

from __future__ import annotations

import json
import os
import re
import sys
from pathlib import Path
from typing import Dict, List

from instaslice_tpu_torch.deploy.manifests import File, samples, tree

HERE = Path(__file__).resolve().parent
CONFIG = HERE / "config"
SAMPLES = HERE / "samples"

_PLAIN = re.compile(r"[A-Za-z][A-Za-z0-9_./-]*")
#: plain words YAML reads as something other than a string
_RESERVED = {"y", "yes", "n", "no", "on", "off", "true", "false", "null"}


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    if not isinstance(v, str):
        raise TypeError(f"no YAML for {type(v).__name__} {v!r}")
    if _PLAIN.fullmatch(v) and v.lower() not in _RESERVED:
        return v
    return json.dumps(v)


def _block(v, indent: int) -> List[str]:
    """Lines of the collection ``v`` at ``indent`` spaces."""
    pad = " " * indent
    out: List[str] = []
    if isinstance(v, dict):
        for key, val in v.items():
            k = _scalar(key)
            if isinstance(val, (dict, list)) and val:
                out.append(f"{pad}{k}:")
                out += _block(val, indent + 2)
            else:
                out.append(f"{pad}{k}: {_inline(val)}")
        return out
    for item in v:
        if isinstance(item, dict) and item:
            first, *rest = _block(item, indent + 2)
            out.append(f"{pad}- {first.lstrip()}")
            out += rest
        elif isinstance(item, list) and item:
            raise TypeError("no YAML for a list of lists")
        else:
            out.append(f"{pad}- {_inline(item)}")
    return out


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def to_yaml(file: File) -> str:
    """A file's text: its header as comments, its documents."""
    header, docs = file
    lines: List[str] = []
    words, line = header.split(), "#"
    for w in words:
        if len(line) + 1 + len(w) > 72:
            lines.append(line)
            line = "#"
        line += " " + w
    if words:
        lines.append(line)
    for i, doc in enumerate(docs):
        if i or words:
            lines.append("---")
        lines += _block(doc, 0)
    return "\n".join(lines) + "\n"


def load_documents(text: str) -> List[dict]:
    """The documents of a rendered file, read back by the port's own
    YAML reader."""
    from instaslice_tpu_torch.kube.kubeconfig import load_kubeconfig

    docs, chunk = [], []
    for line in text.splitlines() + ["---"]:
        if line == "---":
            body = "\n".join(chunk)
            if any(x.strip() and not x.lstrip().startswith("#")
                   for x in chunk):
                docs.append(load_kubeconfig(body + "\n"))
            chunk = []
        else:
            chunk.append(line)
    return docs


def rendered() -> Dict[Path, str]:
    """Every file of ``deploy/config`` and ``deploy/samples``, by path."""
    out = {CONFIG / rel: to_yaml(f) for rel, f in tree().items()}
    out.update({SAMPLES / rel: to_yaml(f) for rel, f in samples().items()})
    return out


def stale() -> List[str]:
    """The files that differ from the rendering, are missing, or are
    left over from an older one."""
    want = rendered()
    bad = [str(p) for p, text in want.items()
           if not p.exists() or p.read_text() != text]
    for root in (CONFIG, SAMPLES):
        for p in sorted(root.rglob("*.yaml")) if root.exists() else ():
            if p not in want:
                bad.append(f"{p} (not rendered)")
    return bad


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--check" in argv:
        bad = stale()
        for p in bad:
            print(f"{p} is stale; run python -m "
                  "instaslice_tpu_torch.deploy.gen_manifests",
                  file=sys.stderr)
        return 1 if bad else 0
    for path, text in rendered().items():
        os.makedirs(path.parent, exist_ok=True)
        path.write_text(text)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
