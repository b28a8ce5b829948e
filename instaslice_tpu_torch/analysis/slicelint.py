#!/usr/bin/env python
"""slicelint — project-invariant static analysis for instaslice_tpu_torch.

Generic linters check style; this one checks the *contracts the operator's
survival depends on* (PAPER.md: gate → allocate → realize → ungate must
never wedge), which no off-the-shelf tool knows about:

==================  =====================================================
rule id             invariant
==================  =====================================================
raw-http            HTTP round-trips go through a sanctioned transport
                    (``kube/real.py``'s retry+breaker wrapper for the
                    kube API; the allowlisted clients elsewhere). A raw
                    ``urllib.request.urlopen`` in a reconciler bypasses
                    retries, the circuit breaker, and tracing.
name-literal        Gate / finalizer / resource / annotation names are
                    spelled ONLY in ``instaslice_tpu_torch/api/constants.py``.
                    A name inlined twice drifts twice (the reference
                    shipped — and could never fix — a misspelled gate).
broad-except        ``except Exception`` / bare ``except`` must log,
                    print, or re-raise. A handler that silently swallows
                    turns an injected fault into a wedged reconcile.
sleep-in-loop       No ``time.sleep()`` lexically inside a loop: loops
                    must pace on a stop event's ``.wait(timeout)`` so
                    drain/SIGTERM interrupts the nap (a sleeping
                    reconcile loop stretches every shutdown by its
                    period).
span-leak           ``tracer.span(...)`` is only sound as a ``with``
                    context manager — any other use can leave the span
                    (and its ambient-trace contextvar) open forever.
mutable-default     No mutable default arguments (shared-state bugs).
raw-lock            Locks are created via the named factory in
                    ``instaslice_tpu_torch/utils/lockcheck.py`` so the runtime
                    lock-order detector sees every acquisition. A raw
                    ``threading.Lock()`` is invisible to it.
event-reason-literal  Flight-recorder ``reason=`` arguments (journal
                    ``emit``, ``emit_pod_event``) are constants from
                    ``instaslice_tpu_torch/api/constants.py`` — a reason
                    inlined at the call site drifts out of the catalog,
                    the dashboards, and ``make events-check``.
==================  =====================================================

Suppression: append ``# slicelint: disable=<rule>[,<rule>...]`` to the
offending line (the line the finding is reported on). Whole-file:
``# slicelint: disable-file=<rule>[,...]`` anywhere in the first 25
lines. Suppressions are for *justified* exceptions — pair them with a
comment saying why.

Usage::

    python -m instaslice_tpu_torch.analysis.slicelint [--list-rules] [paths...]

Default path: the ``instaslice_tpu_torch`` package this module belongs
to (the gates themselves included). Exit status 1 when findings remain,
0 on a clean tree.

A copy of ``tools/slicelint.py`` with the port's paths: the same rule
ids, suppression grammar and output lines; the allowlists name the
port's counterparts of the reference's allowed files, and the protected
names are read from the port's ``api/constants.py``. Standard library
only: the port's images run it before ``pip install``.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set

# The canonical names come from the one module allowed to spell them —
# reading them here keeps slicelint itself literal-free and means a
# renamed constant re-trains the linter automatically. Loaded straight
# from the file (constants.py is import-time pure by design) rather
# than through the package: the Dockerfiles run this gate BEFORE `pip
# install`, and going through the package's __init__ would couple the
# lint step to its import chain staying stdlib-only.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_PKG = os.path.basename(_PKG_ROOT)


def _load_constants():
    import importlib.util

    path = os.path.join(_PKG_ROOT, "api", "constants.py")
    spec = importlib.util.spec_from_file_location(
        "_slicelint_constants", path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_names = _load_constants()

RULES: Dict[str, str] = {
    "raw-http": (
        "raw urllib/http.client call outside a sanctioned transport "
        "module — kube traffic must ride "
        "instaslice_tpu_torch/kube/real.py's retry+breaker wrapper"
    ),
    "name-literal": (
        "gate/finalizer/resource/annotation name spelled inline — use "
        "instaslice_tpu_torch/api/constants.py"
    ),
    "broad-except": (
        "broad except swallows without logging or re-raising — narrow "
        "the type, or log with context / re-raise"
    ),
    "sleep-in-loop": (
        "time.sleep() inside a loop — pace on a stop event's "
        ".wait(timeout) so shutdown interrupts the nap"
    ),
    "span-leak": (
        "tracer span opened outside a with-statement — no guaranteed "
        "closing path"
    ),
    "mutable-default": "mutable default argument",
    "raw-lock": (
        "raw threading.Lock/RLock/Condition — create locks via "
        "instaslice_tpu_torch/utils/lockcheck.py's named factory so the "
        "lock-order detector sees them"
    ),
    "event-reason-literal": (
        "event reason passed as a string literal — every journal/"
        "Kubernetes event reason must be a constant from "
        "instaslice_tpu_torch/api/constants.py (the flight-recorder "
        "catalog)"
    ),
}

#: the reference's TPU resource, which the port's catalog does not carry
#: (its pods ask for NVIDIA's): still never spelled in the port's code
_TPU_RESOURCE = "google.com/tpu"  # slicelint: disable=name-literal

#: substrings that mark a string literal as a protected name
NAME_FRAGMENTS = (
    _names.GROUP,                # tpu.instaslice.dev
    _names.GPU_RESOURCE,         # nvidia.com/gpu
    _names.MIG_RESOURCE_PREFIX,  # nvidia.com/mig-
    _TPU_RESOURCE,
    _names.LEGACY_GATE_NAME.split("/")[0],  # org.instaslice
)

#: modules allowed to urlopen: the kube transport itself, the HTTP test
#: server, and the serving clients that own their OWN retry layer (the
#: reference also allows its Cloud TPU clients, which the port has no
#: counterpart of, and tools/serve_capacity.py, not ported yet)
RAW_HTTP_ALLOW = (
    "instaslice_tpu_torch/kube/real.py",
    "instaslice_tpu_torch/kube/httptest.py",
    "instaslice_tpu_torch/serving/loadgen.py",
    # the fleet router IS a transport: per-replica breaker + bounded
    # retry live in serving/router.py itself
    "instaslice_tpu_torch/serving/router.py",
    "instaslice_tpu_torch/cli/tpuslicectl.py",
    # the fleet-telemetry aggregator IS a scrape transport: per-target
    # timeout + error accounting live in obs/telemetry.py itself, and
    # a scrape failure is counted, never retried (next poll re-reads)
    "instaslice_tpu_torch/obs/telemetry.py",
    "instaslice_tpu_torch/analysis/telemetry_smoke.py",
    "instaslice_tpu_torch/analysis/profile_smoke.py",
)

RAW_LOCK_ALLOW = ("instaslice_tpu_torch/utils/lockcheck.py",)
NAME_LITERAL_ALLOW = ("instaslice_tpu_torch/api/constants.py",)

#: generated code is not ours to lint
SKIP_FILES = ("_pb2.py",)

_RAW_HTTP_CALLS = {
    "urllib.request.urlopen",
    "urllib.request.Request",
    "urllib.request.build_opener",
    "http.client.HTTPConnection",
    "http.client.HTTPSConnection",
}
_RAW_LOCK_CALLS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
}
_LOG_METHOD_ATTRS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
}
_REPORT_FUNC_NAMES = {"print", "log"}

_SUPPRESS_RE = re.compile(r"#\s*slicelint:\s*disable=([a-z\-,\s]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*slicelint:\s*disable-file=([a-z\-,\s]+)")


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"{self.message}"
        )


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for a Name/Attribute chain, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _Linter:
    def __init__(self, path: str, display_path: str, source: str) -> None:
        self.path = path
        self.display = display_path
        self.source = source
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.suppressed: Dict[int, Set[str]] = {}
        self.file_suppressed: Set[str] = set()
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppressed[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
            if i <= 25:
                m = _SUPPRESS_FILE_RE.search(line)
                if m:
                    self.file_suppressed |= {
                        r.strip() for r in m.group(1).split(",")
                        if r.strip()
                    }
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.aliases: Dict[str, str] = {}

    # ------------------------------------------------------------- core

    def _allowed(self, allowlist: Iterable[str]) -> bool:
        norm = self.display.replace(os.sep, "/")
        return any(norm.endswith(a) for a in allowlist)

    def emit(self, node: ast.AST, rule: str, message: str = "") -> None:
        line = getattr(node, "lineno", 1)
        if rule in self.file_suppressed:
            return
        if rule in self.suppressed.get(line, ()):
            return
        self.findings.append(Finding(
            self.display, line, getattr(node, "col_offset", 0) + 1,
            rule, message or RULES[rule],
        ))

    def run(self) -> List[Finding]:
        try:
            tree = ast.parse(self.source, filename=self.path)
        except SyntaxError as e:
            self.findings.append(Finding(
                self.display, e.lineno or 1, (e.offset or 0) + 1,
                "syntax-error", str(e.msg),
            ))
            return self.findings
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # type annotations reference threading.Lock legitimately (and
        # under PEP 563 they are never evaluated at all) — collect
        # their subtrees so the bare-reference rule can skip them
        self._ann_nodes: set = set()
        for node in ast.walk(tree):
            anns = []
            if isinstance(node, ast.AnnAssign):
                anns.append(node.annotation)
            elif isinstance(node, ast.arg) and node.annotation:
                anns.append(node.annotation)
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node.returns:
                anns.append(node.returns)
            for a in anns:
                for sub in ast.walk(a):
                    self._ann_nodes.add(id(sub))
        # alias map so `from threading import Lock` / `import
        # urllib.request as ur` cannot smuggle a policed call past the
        # dotted-name match: local binding -> canonical dotted origin
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}"
                    )
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif isinstance(node, (ast.Name, ast.Attribute)) and \
                    isinstance(getattr(node, "ctx", None), ast.Load):
                self._check_bare_lock_ref(node)
            elif isinstance(node, ast.ExceptHandler):
                self._check_except(node)
            elif isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                self._check_name_literal(node)
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                self._check_defaults(node)
        return self.findings

    # ------------------------------------------------------------ rules

    def _resolve(self, dotted: str) -> str:
        """Expand the leading segment through the import-alias map."""
        if not dotted:
            return dotted
        first, _, rest = dotted.partition(".")
        origin = self.aliases.get(first)
        if origin is None:
            return dotted
        return f"{origin}.{rest}" if rest else origin

    def _check_call(self, node: ast.Call) -> None:
        dotted = self._resolve(_dotted(node.func))
        if dotted in _RAW_HTTP_CALLS and not self._allowed(RAW_HTTP_ALLOW):
            self.emit(node, "raw-http")
        if dotted in _RAW_LOCK_CALLS and not self._allowed(RAW_LOCK_ALLOW):
            self.emit(node, "raw-lock")
        if dotted == "time.sleep" and self._in_loop(node):
            self.emit(node, "sleep-in-loop")
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "span"
            and self._is_tracer_expr(node.func.value)
            and not isinstance(self.parents.get(node), ast.withitem)
        ):
            self.emit(node, "span-leak")
        self._check_event_reason(node, dotted)

    def _check_bare_lock_ref(self, node) -> None:
        """An UNCALLED reference to ``threading.Lock``/``RLock``/
        ``Condition`` — ``defaultdict(threading.Lock)``, a
        ``factory=Lock`` default, ``locks = [Lock() for ...]``'s
        comprehension cousin ``map(Lock, range(n))`` — manufactures raw
        locks at a distance, past the call-site rule. Type annotations
        are exempt (naming the type is not making a lock)."""
        parent = self.parents.get(node)
        if isinstance(parent, ast.Call) and parent.func is node:
            return  # the direct-call form: _check_call owns it
        if isinstance(parent, ast.Attribute):
            return  # interior of a longer dotted chain
        if id(node) in self._ann_nodes:
            return
        dotted = self._resolve(_dotted(node))
        if dotted in _RAW_LOCK_CALLS and not self._allowed(RAW_LOCK_ALLOW):
            self.emit(node, "raw-lock")

    def _check_event_reason(self, node: ast.Call, dotted: str) -> None:
        """Journal emission (``<journal>.emit(...)`` /
        ``emit_pod_event(...)``, both with keyword-only ``reason=``)
        must name its reason via a constant, never a string literal —
        the reason catalog lives ONLY in api/constants.py."""
        is_emit = (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "emit"
            and self._is_journal_expr(node.func.value)
        ) or dotted.rsplit(".", 1)[-1] == "emit_pod_event"
        if not is_emit:
            return
        for kw in node.keywords:
            if kw.arg == "reason" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                self.emit(
                    node, "event-reason-literal",
                    f"reason literal {kw.value.value!r} — use a "
                    "constant from instaslice_tpu_torch/api/constants.py",
                )

    def _is_journal_expr(self, node: ast.AST) -> bool:
        """Does this receiver look like a journal? Scopes the rule to
        ``journal.emit`` / ``self.journal.emit`` / ``get_journal().emit``
        so unrelated ``emit()`` methods don't trip the gate."""
        if isinstance(node, ast.Call):
            return self._is_journal_expr(node.func)
        dotted = self._resolve(_dotted(node))
        if not dotted:
            return False
        return "journal" in dotted.rsplit(".", 1)[-1].lower()

    def _is_tracer_expr(self, node: ast.AST) -> bool:
        """Does this receiver look like a tracer? Scopes span-leak to
        ``tracer.span`` / ``self.tracer.span`` / ``get_tracer().span``
        so unrelated ``span()`` methods (e.g. ``re.Match.span``) don't
        trip the zero-tolerance gate."""
        if isinstance(node, ast.Call):
            return self._is_tracer_expr(node.func)
        dotted = self._resolve(_dotted(node))
        if not dotted:
            return False
        return "tracer" in dotted.rsplit(".", 1)[-1].lower()

    def _in_loop(self, node: ast.AST) -> bool:
        """Lexically inside a while/for of the SAME function scope."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.While, ast.For, ast.AsyncFor)):
                return True
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return False
            cur = self.parents.get(cur)
        return False

    def _check_except(self, node: ast.ExceptHandler) -> None:
        if not self._is_broad(node.type):
            return
        for sub in node.body:
            for n in self._walk_handler(sub):
                if isinstance(n, ast.Raise):
                    return
                if isinstance(n, ast.Call) and self._is_reporting(n):
                    return
        self.emit(node, "broad-except")

    @classmethod
    def _walk_handler(cls, node: ast.AST) -> Iterable[ast.AST]:
        """ast.walk that does NOT descend into nested function/lambda
        bodies: a raise or log call defined there runs later (if ever),
        so it cannot satisfy the handler's report-or-reraise duty."""
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return
        for child in ast.iter_child_nodes(node):
            yield from cls._walk_handler(child)

    @staticmethod
    def _is_broad(t: Optional[ast.AST]) -> bool:
        if t is None:
            return True  # bare except
        if isinstance(t, ast.Name):
            return t.id in ("Exception", "BaseException")
        if isinstance(t, ast.Tuple):
            return any(
                isinstance(e, ast.Name)
                and e.id in ("Exception", "BaseException")
                for e in t.elts
            )
        return False

    @staticmethod
    def _is_reporting(call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _LOG_METHOD_ATTRS:
            return True
        if isinstance(f, ast.Name) and f.id in _REPORT_FUNC_NAMES:
            return True
        return False

    def _check_name_literal(self, node: ast.Constant) -> None:
        if self._allowed(NAME_LITERAL_ALLOW):
            return
        if not any(frag in node.value for frag in NAME_FRAGMENTS):
            return
        # docstrings / bare string statements carry documentation, not
        # behavior — a name drifting there can't break the cluster
        parent = self.parents.get(node)
        if isinstance(parent, ast.Expr):
            return
        self.emit(
            node, "name-literal",
            f"name literal {node.value!r} — use "
            "instaslice_tpu_torch/api/constants.py",
        )

    def _check_defaults(self, node) -> None:
        args = node.args
        for default in list(args.defaults) + [
            d for d in args.kw_defaults if d is not None
        ]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                self.emit(default, "mutable-default")
            elif (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set")
            ):
                self.emit(default, "mutable-default")


# ----------------------------------------------------------------- API


def lint_file(path: str, display_path: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return _Linter(path, display_path or path, source).run()


def iter_python_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        if any(path.endswith(skip) for skip in SKIP_FILES):
            continue
        rel = os.path.relpath(path, _REPO_ROOT)
        display = rel if not rel.startswith("..") else path
        findings.extend(lint_file(path, display))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="slicelint", description=__doc__.splitlines()[0],
    )
    ap.add_argument("paths", nargs="*", help="files or directories "
                    f"(default: {_PKG})")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}: {desc}")
        return 0
    paths = args.paths or [_PKG_ROOT]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(
            f"slicelint: {len(findings)} finding(s) — fix, or suppress "
            "a justified site with '# slicelint: disable=<rule>'",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
