#!/usr/bin/env python
"""slicecheck — whole-program guarded-by + dispatch-hygiene analysis.

slicelint polices single-site contracts (one call, one literal); this
tool checks the two invariants that need a *program-wide* view, the
ones that survive runtime lockcheck (which only sees the schedules a
3-seed chaos sweep happens to explore):

concurrency (guarded-by verification)
  Shared mutable fields are declared in the class body via
  ``guarded_by("lock-name")`` annotations (``instaslice_tpu_torch/utils/
  guards.py``; names come
  from the lockcheck factory registry). slicecheck discovers thread
  entry points (``threading.Thread(target=...)``, ``Thread``
  subclasses' ``run``, HTTP handler ``do_*`` methods), builds a
  per-class field-access map across ALL analyzed files, and reports:

  ==================  ==================================================
  rule id             invariant
  ==================  ==================================================
  guarded-field       every read/write of a ``guarded_by`` field sits
                      inside ``with <its named lock>:`` (same
                      receiver), or in a ``@requires``-marked helper,
                      or in ``__init__``/``__del__``
  undeclared-shared   a field of a concurrent class (one that owns a
                      named lock or a thread entry) written outside
                      ``__init__`` and reachable from >= 2 distinct
                      thread roots must carry a ``guarded_by`` or
                      ``unguarded("why")`` declaration
  guard-unknown-lock  a declaration names a lock with no
                      ``named_lock``/``named_rlock``/
                      ``named_condition`` factory site
  unbalanced-pair     a function that both opens and closes a paired
                      resource (pool allocate/fork->release, radix
                      lock->unlock, lock acquire->release) has a
                      return/raise path between them with the close
                      not in a ``finally``
  ==================  ==================================================

dispatch hygiene (hot-path modules: serving/engine*, serving/kvcache,
serving/sampling, models/)
  The "two programs" rule is only real if nothing in the decode/prefill
  path silently syncs the host or mints a new compiled shape or graph:

  ==================  ==================================================
  host-sync-in-loop   ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                      ``.numpy()`` / ``.block_until_ready()`` /
                      ``torch.cuda.synchronize`` / ``jax.device_get`` /
                      ``np.asarray`` inside a loop, or
                      ``float``/``int``/``bool`` wrapping a jit-program
                      or ``torch.`` call — a per-iteration device
                      round-trip
  nonstatic-shape-arg jit-wrapped function has a shape-bearing Python
                      parameter (n_steps, attend_len, k, ...) missing
                      from ``static_argnames``
  unbudgeted-jit      a ``jax.jit`` site in an engine module whose
                      program is not a ``self._X = jax.jit(...)``
                      assignment accounted in ``compile_budget()``
  unbudgeted-graph    a ``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph
                      (...)`` site in an engine module outside the
                      engine's capture helper (``_capture``), or a
                      capture (``self._program``/``_warm``/``_capture``
                      with a key) whose key form is not in the module's
                      ``GRAPH_FORMS`` or not counted by
                      ``compile_budget()``
  ==================  ==================================================

  The port (PyTorch) runs no jit: ``nonstatic-shape-arg`` and
  ``unbudgeted-jit`` keep their JAX names so the reference's fixtures give
  the same findings; a captured CUDA graph is the port's compiled program,
  keyed by the form its key starts with.

catalog hygiene
  ==================  ==================================================
  dead-reason         a ``REASON_*`` constant in the reason catalog
                      (the module defining ``EVENT_REASONS``) with no
                      emit site anywhere in the analyzed program
  ==================  ==================================================

Suppression: append ``# slicecheck: disable=<rule>[,<rule>...]`` to
the reported line; whole-file ``# slicecheck: disable-file=<rule>``
within the first 25 lines — same grammar as slicelint, different tag
so the two gates can't mask each other. Suppressions are for
*justified* exceptions: pair them with a comment saying why.

Usage::

    python -m instaslice_tpu_torch.analysis.slicecheck [--list-rules] \
        [--dump-guards] [paths...]

Default path: the ``instaslice_tpu_torch`` package this module belongs
to (the gates themselves included). The path set IS the program: rules
that need whole-program knowledge (entry points, emit sites, factory
registry) see exactly these files, which is what makes the fixture corpus
under ``tests/check_fixtures/`` self-contained. Exit status 1 when
findings remain, 0 on clean.

A copy of ``tools/slicecheck.py`` for the port: the same rule ids,
suppression grammar and output lines, the torch host syncs and
``unbudgeted-graph`` added. Standard library only: the port's images run
it before ``pip install``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_PKG = os.path.basename(_PKG_ROOT)

RULES: Dict[str, str] = {
    "guarded-field": (
        "guarded_by field accessed outside a `with <named lock>` block "
        "— take the lock, mark the helper @requires, or move the "
        "access under the existing critical section"
    ),
    "undeclared-shared": (
        "field of a concurrent class written outside __init__ and "
        "reachable from >= 2 thread roots with no guarded_by/unguarded "
        "declaration — declare which lock guards it, or unguarded(why)"
    ),
    "guard-unknown-lock": (
        "guarded_by names a lock with no named_lock/named_rlock/"
        "named_condition factory site — lock names come from the "
        "lockcheck registry"
    ),
    "unbalanced-pair": (
        "paired resource (allocate/release, lock/unlock, fork/release, "
        "acquire/release) can leak on a return/raise path — close in a "
        "finally, or restructure so the open escapes the function"
    ),
    "host-sync-in-loop": (
        "device->host sync inside a hot-path loop (.item/.tolist/.cpu/"
        ".numpy/device_get/block_until_ready/torch.cuda.synchronize/"
        "np.asarray, or float/int/bool of a jit program's or a torch "
        "call's result) — hoist to one batched readback per step"
    ),
    "nonstatic-shape-arg": (
        "jit-wrapped function takes a shape-bearing Python value "
        "(n_steps, *_len, k, ...) not listed in static_argnames — a "
        "traced shape value silently degrades or retraces"
    ),
    "unbudgeted-jit": (
        "jax.jit program in an engine module not assigned to a self._X "
        "attribute accounted in compile_budget() — every compiled "
        "program must belong to the declared bounded set"
    ),
    "unbudgeted-graph": (
        "CUDA graph captured outside the engine's capture helper, or "
        "under a key form not in GRAPH_FORMS / not counted by "
        "compile_budget() — every captured graph must belong to the "
        "declared bounded set"
    ),
    "dead-reason": (
        "reason constant in the catalog with no emit site in the "
        "program — delete it or wire the emitter it was meant for"
    ),
}

_SUPPRESS_RE = re.compile(r"#\s*slicecheck:\s*disable=([a-z\-,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*slicecheck:\s*disable-file=([a-z\-,\s]+)"
)

#: hot-path module markers for the dispatch-hygiene family
HOT_PATH_MARKERS = (
    "serving/engine",
    "serving/kvcache.py",
    "serving/sampling.py",
    "/models/",
    "models/",
)

#: engine modules where every jit program must be budget-accounted
ENGINE_MARKERS = ("serving/engine",)

_FACTORY_NAMES = {"named_lock", "named_rlock", "named_condition"}

#: attribute calls that mutate a container in place — a write for the
#: purposes of guarded-by analysis even though the AST ctx is Load
_MUTATOR_ATTRS = {
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "remove", "discard", "clear", "extend", "insert", "setdefault",
    "sort", "reverse",
}

#: constructors whose values synchronize themselves — fields holding
#: one are exempt from undeclared-shared (Queue/Event/local do their
#: own locking; a Thread handle is set once before start)
_SELF_SYNC_CALLS = {
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "threading.Event", "threading.local",
    "threading.Thread", "threading.Barrier", "threading.Semaphore",
    "threading.BoundedSemaphore",
}

#: paired-resource protocol: open method -> close method (matched on
#: the same receiver expression within one function)
_PAIRS = {
    "allocate": "release",
    "fork": "release",
    "lock": "unlock",
    "acquire": "release",
}

#: explicit host-sync attribute calls (any receiver): JAX's and torch's
_SYNC_ATTRS = {"item", "tolist", "block_until_ready", "cpu", "numpy"}
#: explicit host-sync dotted calls (post alias resolution)
_SYNC_CALLS = {"jax.device_get", "numpy.asarray", "numpy.array",
               "torch.cuda.synchronize"}

#: graph constructors only the engine's capture helper may call
_GRAPH_CALLS = {"torch.cuda.CUDAGraph", "torch.cuda.graph"}
#: the engine's capture helper, and the methods that take a graph key
#: first (``_program`` captures on first use, ``_warm`` ahead of traffic)
_CAPTURE_HELPER = "_capture"
_CAPTURE_ENTRIES = ("_program", "_warm", "_capture")

#: parameter-name segments that mark a Python value as shape-bearing
_SHAPE_SEGMENTS = {
    "n", "num", "len", "length", "steps", "size", "count", "k",
    "width", "depth", "blocks", "pages", "cap", "budget",
}

SKIP_FILES = ("_pb2.py",)


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
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _recv_key(node: ast.AST) -> str:
    """Stable text for a receiver expression ('self', 'outer', 'p',
    'self.pool', ...) so `with p.lock:` can be matched to `p.done`."""
    try:
        return ast.unparse(node)
    except Exception:  # slicelint: disable=broad-except
        # pragma: no cover — any unparse failure degrades to the dump
        # form (still a stable key, just uglier); nothing to log from
        # a pure text-keying helper
        return ast.dump(node)


@dataclass
class _Decl:
    lock: Optional[str]  # None => unguarded(...)
    reason: Optional[str]
    node: ast.AST
    reads: str = "locked"  # "racy" => only writes are verified


@dataclass
class _Access:
    attr: str
    node: ast.AST
    write: bool
    recv: str           # receiver expression text
    is_self: bool
    held: List[Tuple[str, str]] = field(default_factory=list)
    # held: (lock attr name OR resolved lock name, receiver text)


@dataclass
class _MethodInfo:
    name: str
    node: ast.AST
    requires: Set[str] = field(default_factory=set)
    self_calls: Set[str] = field(default_factory=set)
    accesses: List[_Access] = field(default_factory=list)
    entry: bool = False
    roots: Set[str] = field(default_factory=set)


@dataclass
class _ClassInfo:
    name: str
    file: "_File"
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)
    lock_attrs: Dict[str, str] = field(default_factory=dict)
    decls: Dict[str, _Decl] = field(default_factory=dict)
    methods: Dict[str, _MethodInfo] = field(default_factory=dict)
    assigned: Set[str] = field(default_factory=set)
    self_sync: Set[str] = field(default_factory=set)

    @property
    def concurrent(self) -> bool:
        return bool(self.lock_attrs) or self.is_thread or any(
            m.entry for m in self.methods.values()
        )

    @property
    def is_thread(self) -> bool:
        return any(b.endswith("Thread") for b in self.bases)

    @property
    def is_handler(self) -> bool:
        return any("HTTPRequestHandler" in b for b in self.bases)


class _File:
    def __init__(self, path: str, display: str, source: str) -> None:
        self.path = path
        self.display = display
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.error: Optional[Finding] = None
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.aliases: Dict[str, str] = {}
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
        try:
            self.tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            self.error = Finding(
                display, e.lineno or 1, (e.offset or 0) + 1,
                "syntax-error", str(e.msg),
            )
            return
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.module_names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
                        self.module_names.add(a.asname)
                    else:
                        self.module_names.add(a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}"
                    )

    def resolve(self, dotted: str) -> str:
        if not dotted:
            return dotted
        first, _, rest = dotted.partition(".")
        origin = self.aliases.get(first)
        if origin is None:
            return dotted
        return f"{origin}.{rest}" if rest else origin

    def is_hot(self) -> bool:
        norm = self.display.replace(os.sep, "/")
        return any(m in norm for m in HOT_PATH_MARKERS)

    def is_engine(self) -> bool:
        norm = self.display.replace(os.sep, "/")
        return any(m in norm for m in ENGINE_MARKERS)


class Checker:
    """Whole-program analysis over one set of files."""

    def __init__(self) -> None:
        self.files: List[_File] = []
        self.classes: List[_ClassInfo] = []
        self.findings: List[Finding] = []
        self._emitted: Set[Tuple[str, int, str, str]] = set()
        #: every constant lock name passed to a factory, anywhere
        self.lock_registry: Set[str] = set()
        #: lock attr name -> set of lock names (for with-resolution)
        self.lock_attr_names: Dict[str, Set[str]] = {}
        #: field name -> classes assigning it via self (for cross-class
        #: attribution; only unique owners participate)
        self.field_owner: Dict[str, List[_ClassInfo]] = {}

    # -------------------------------------------------------- plumbing

    def add_file(self, path: str, display: str) -> None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        self.files.append(_File(path, display, source))

    def emit(self, fobj: _File, node: ast.AST, rule: str,
             message: str, tag: str = "") -> None:
        line = getattr(node, "lineno", 1)
        if rule in fobj.file_suppressed:
            return
        if rule in fobj.suppressed.get(line, ()):
            return
        key = (fobj.display, line, rule, tag or message)
        if key in self._emitted:
            return
        self._emitted.add(key)
        self.findings.append(Finding(
            fobj.display, line, getattr(node, "col_offset", 0) + 1,
            rule, message,
        ))

    # ------------------------------------------------------------- run

    def run(self) -> List[Finding]:
        for fobj in self.files:
            if fobj.error is not None:
                self.findings.append(fobj.error)
        self._collect_classes()
        self._collect_entries()
        self._propagate_roots()
        self._check_guarded_fields()
        self._check_undeclared_shared()
        self._check_unknown_locks()
        for fobj in self.files:
            if fobj.tree is None:
                continue
            self._check_pairs(fobj)
            if fobj.is_hot():
                self._check_host_sync(fobj)
                self._check_jit_shapes(fobj)
            if fobj.is_engine():
                self._check_jit_budget(fobj)
                self._check_graph_budget(fobj)
        self._check_dead_reasons()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    # ------------------------------------------------- class collection

    def _collect_classes(self) -> None:
        for fobj in self.files:
            if fobj.tree is None:
                continue
            for node in ast.walk(fobj.tree):
                if isinstance(node, ast.ClassDef):
                    self.classes.append(self._scan_class(fobj, node))
            # register factory lock names everywhere (module level too)
            for node in ast.walk(fobj.tree):
                if isinstance(node, ast.Call):
                    name = self._factory_name(fobj, node)
                    if name:
                        self.lock_registry.add(name)
        for cls in self.classes:
            for attr, lock in cls.lock_attrs.items():
                self.lock_attr_names.setdefault(attr, set()).add(lock)
            for f in cls.assigned | set(cls.decls):
                self.field_owner.setdefault(f, []).append(cls)

    def _factory_name(self, fobj: _File, call: ast.Call) -> Optional[str]:
        dotted = fobj.resolve(_dotted(call.func))
        if dotted.rsplit(".", 1)[-1] not in _FACTORY_NAMES:
            return None
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return call.args[0].value
        return None

    def _scan_class(self, fobj: _File, node: ast.ClassDef) -> _ClassInfo:
        cls = _ClassInfo(name=node.name, file=fobj, node=node)
        cls.bases = [fobj.resolve(_dotted(b)) for b in node.bases]
        # guarded_by / unguarded declarations in the class body
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ) and isinstance(stmt.annotation, ast.Call):
                fn = _dotted(stmt.annotation.func).rsplit(".", 1)[-1]
                arg = None
                if stmt.annotation.args and isinstance(
                    stmt.annotation.args[0], ast.Constant
                ):
                    arg = stmt.annotation.args[0].value
                if fn == "guarded_by" and isinstance(arg, str):
                    reads = "locked"
                    for kw in stmt.annotation.keywords:
                        if kw.arg == "reads" and isinstance(
                            kw.value, ast.Constant
                        ):
                            reads = str(kw.value.value)
                    cls.decls[stmt.target.id] = _Decl(
                        arg, None, stmt, reads,
                    )
                elif fn == "unguarded":
                    cls.decls[stmt.target.id] = _Decl(
                        None, arg if isinstance(arg, str) else "", stmt,
                    )
        # class-body fields (dataclass-style annotations, class attrs)
        # count as owned fields so cross-class attribution by name
        # lands on the right class — or goes ambiguous and is skipped
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                cls.assigned.add(stmt.target.id)
            elif isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        cls.assigned.add(tgt.id)
        # methods = FunctionDefs directly in the class body
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls.methods[stmt.name] = _MethodInfo(stmt.name, stmt)
        for m in cls.methods.values():
            self._scan_method(fobj, cls, m)
        return cls

    def _self_name(self, node: ast.AST) -> str:
        args = getattr(node, "args", None)
        if args and args.args:
            return args.args[0].arg
        return "self"

    def _scan_method(self, fobj: _File, cls: _ClassInfo,
                     m: _MethodInfo) -> None:
        selfname = self._self_name(m.node)
        for deco in m.node.decorator_list:
            if isinstance(deco, ast.Call) and _dotted(deco.func).rsplit(
                ".", 1
            )[-1] == "requires" and deco.args and isinstance(
                deco.args[0], ast.Constant
            ) and isinstance(deco.args[0].value, str):
                m.requires.add(deco.args[0].value)
        for node in ast.walk(m.node):
            # lock attribute creation: self.X = named_lock("...")
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                lock = self._factory_name(fobj, node.value)
                sync = fobj.resolve(_dotted(node.value.func))
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and isinstance(
                        tgt.value, ast.Name
                    ) and tgt.value.id == selfname:
                        if lock:
                            cls.lock_attrs[tgt.attr] = lock
                        elif sync in _SELF_SYNC_CALLS or sync.rsplit(
                            ".", 1
                        )[-1] in _FACTORY_NAMES:
                            cls.self_sync.add(tgt.attr)
            if not isinstance(node, ast.Attribute):
                continue
            if not isinstance(node.value, ast.Name) or \
                    node.value.id != selfname:
                continue
            cls_method = node.attr in cls.methods
            parent = fobj.parents.get(node)
            if cls_method:
                # self.m(...) or self.m passed around: a call edge
                m.self_calls.add(node.attr)
                continue
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            if isinstance(parent, ast.Attribute) and \
                    parent.attr in _MUTATOR_ATTRS:
                gp = fobj.parents.get(parent)
                if isinstance(gp, ast.Call) and gp.func is parent:
                    is_write = True
            if isinstance(parent, ast.Subscript) and isinstance(
                parent.ctx, (ast.Store, ast.Del)
            ) and parent.value is node:
                is_write = True
            if isinstance(node.ctx, ast.Store):
                cls.assigned.add(node.attr)
            m.accesses.append(_Access(
                node.attr, node, is_write, selfname, True,
                self._held_at(fobj, node),
            ))
        # non-self attribute accesses: collected globally later

    def _held_at(self, fobj: _File, node: ast.AST) -> List[Tuple[str, str]]:
        """(lock attr name or resolved lock name, receiver text) for
        every with-lock lexically enclosing ``node`` within its own
        function scope (a with outside a nested def does not guarantee
        anything about when the closure runs)."""
        held: List[Tuple[str, str]] = []
        cur = fobj.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Attribute):
                        held.append(
                            (expr.attr, _recv_key(expr.value))
                        )
                    elif isinstance(expr, ast.Name):
                        held.append((expr.id, "<module>"))
            cur = fobj.parents.get(cur)
        return held

    # --------------------------------------------------- entry points

    def _class_of(self, fobj: _File, node: ast.AST) -> Optional[_ClassInfo]:
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                for cls in self.classes:
                    if cls.node is cur and cls.file is fobj:
                        return cls
            cur = fobj.parents.get(cur)
        return None

    def _method_of(self, fobj: _File,
                   node: ast.AST) -> Optional[Tuple[_ClassInfo, str]]:
        cur: Optional[ast.AST] = node
        fn: Optional[str] = None
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = cur.name
                parent = fobj.parents.get(cur)
                if isinstance(parent, ast.ClassDef):
                    cls = self._class_of(fobj, parent)
                    if cls and fn in cls.methods:
                        return cls, fn
            cur = fobj.parents.get(cur)
        return None

    def _collect_entries(self) -> None:
        by_name: Dict[str, List[Tuple[_ClassInfo, str]]] = {}
        for cls in self.classes:
            for mname in cls.methods:
                by_name.setdefault(mname, []).append((cls, mname))
            if cls.is_thread and "run" in cls.methods:
                cls.methods["run"].entry = True
            if cls.is_handler:
                for mname, m in cls.methods.items():
                    if mname.startswith("do_"):
                        m.entry = True
        for fobj in self.files:
            if fobj.tree is None:
                continue
            for node in ast.walk(fobj.tree):
                if not isinstance(node, ast.Call):
                    continue
                dotted = fobj.resolve(_dotted(node.func))
                target: Optional[ast.AST] = None
                if dotted == "threading.Thread" or \
                        dotted.endswith(".Thread"):
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = kw.value
                elif dotted.rsplit(".", 1)[-1].endswith("Manager"):
                    # reconcile Manager worker bodies: the callback
                    # runs on the worker pool's threads
                    for kw in node.keywords:
                        if kw.arg == "reconcile":
                            target = kw.value
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "submit" and node.args:
                    target = node.args[0]
                if not isinstance(target, ast.Attribute):
                    continue
                mname = target.attr
                owner = self._class_of(fobj, node)
                if owner is not None and isinstance(
                    target.value, ast.Name
                ) and mname in owner.methods:
                    owner.methods[mname].entry = True
                    continue
                candidates = by_name.get(mname, [])
                if len(candidates) == 1:
                    candidates[0][0].methods[mname].entry = True

    def _propagate_roots(self) -> None:
        for cls in self.classes:
            for mname, m in cls.methods.items():
                if m.entry:
                    m.roots.add(f"{cls.name}.{mname}")
                elif not mname.startswith("_"):
                    # public API: callable from any other thread
                    m.roots.add("external")
            changed = True
            while changed:
                changed = False
                for m in cls.methods.values():
                    for callee in m.self_calls:
                        tgt = cls.methods.get(callee)
                        if tgt is None:
                            continue
                        before = len(tgt.roots)
                        tgt.roots |= m.roots
                        if len(tgt.roots) != before:
                            changed = True
            for mname, m in cls.methods.items():
                if not m.roots and mname not in ("__init__", "__del__"):
                    m.roots.add("external")

    # -------------------------------------------- cross-class accesses

    def _iter_foreign_accesses(self):
        """Attribute accesses whose receiver is not the local ``self``
        but whose attr name is owned by exactly one analyzed class:
        yields (file, owner_cls, access, context_method_or_None)."""
        for fobj in self.files:
            if fobj.tree is None:
                continue
            for node in ast.walk(fobj.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                owners = self.field_owner.get(node.attr, [])
                if len(owners) != 1:
                    continue
                owner = owners[0]
                ctx = self._method_of(fobj, node)
                if ctx is not None and ctx[0] is owner and isinstance(
                    node.value, ast.Name
                ) and node.value.id == self._self_name(
                    ctx[0].methods[ctx[1]].node
                ):
                    continue  # the owning class's own self access
                # skip module receivers (json.loads, np.float32, ...)
                recv_root = _dotted(node.value).split(".")[0]
                if recv_root and (
                    recv_root in fobj.module_names
                    or recv_root in fobj.aliases
                ):
                    continue
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                parent = fobj.parents.get(node)
                if isinstance(parent, ast.Attribute) and \
                        parent.attr in _MUTATOR_ATTRS:
                    gp = fobj.parents.get(parent)
                    if isinstance(gp, ast.Call) and gp.func is parent:
                        is_write = True
                if isinstance(parent, ast.Subscript) and isinstance(
                    parent.ctx, (ast.Store, ast.Del)
                ) and parent.value is node:
                    is_write = True
                acc = _Access(
                    node.attr, node, is_write, _recv_key(node.value),
                    False, self._held_at(fobj, node),
                )
                yield fobj, owner, acc, ctx

    # ------------------------------------------------- guarded fields

    def _satisfied(self, owner: _ClassInfo, lock: str,
                   acc: _Access, ctx) -> bool:
        if ctx is not None:
            cls, mname = ctx
            m = cls.methods[mname]
            if lock in m.requires:
                return True
            if cls is owner and mname in ("__init__", "__del__"):
                return True
        for held_name, held_recv in acc.held:
            # exact lock-name match (resolved through any class's
            # uniquely-named lock attr, or a module-level lock)
            names = self.lock_attr_names.get(held_name, set())
            if held_name == lock:
                return True
            if names == {lock}:
                return True
            # receiver-typed match: with <recv>.<attr> where <attr> is
            # the owner class's lock attr for this lock and <recv> is
            # the same expression the field is accessed through
            if owner.lock_attrs.get(held_name) == lock and \
                    held_recv == acc.recv:
                return True
        return False

    def _check_guarded_fields(self) -> None:
        for cls in self.classes:
            for mname, m in cls.methods.items():
                for acc in m.accesses:
                    decl = cls.decls.get(acc.attr)
                    if decl is None or decl.lock is None:
                        continue
                    if decl.reads == "racy" and not acc.write:
                        continue
                    if self._satisfied(cls, decl.lock, acc,
                                       (cls, mname)):
                        continue
                    self.emit(
                        cls.file, acc.node, "guarded-field",
                        f"{cls.name}.{acc.attr} "
                        f"({'write' if acc.write else 'read'}) outside "
                        f"`with <{decl.lock}>` — declared "
                        f"guarded_by({decl.lock!r})",
                        tag=acc.attr,
                    )
        for fobj, owner, acc, ctx in self._iter_foreign_accesses():
            decl = owner.decls.get(acc.attr)
            if decl is None or decl.lock is None:
                continue
            if decl.reads == "racy" and not acc.write:
                continue
            if self._satisfied(owner, decl.lock, acc, ctx):
                continue
            self.emit(
                fobj, acc.node, "guarded-field",
                f"{owner.name}.{acc.attr} "
                f"({'write' if acc.write else 'read'}) via "
                f"`{acc.recv}` outside `with <{decl.lock}>` — declared "
                f"guarded_by({decl.lock!r})",
                tag=acc.attr,
            )

    # --------------------------------------------- undeclared sharing

    def _check_undeclared_shared(self) -> None:
        # roots contributed by foreign accessors, keyed by class+field
        foreign_roots: Dict[Tuple[int, str], Set[str]] = {}
        foreign_writes: Dict[Tuple[int, str], bool] = {}
        for fobj, owner, acc, ctx in self._iter_foreign_accesses():
            key = (id(owner), acc.attr)
            roots = foreign_roots.setdefault(key, set())
            if ctx is not None:
                roots |= ctx[0].methods[ctx[1]].roots
            else:
                roots.add("external")
            if acc.write:
                foreign_writes[key] = True
        for cls in self.classes:
            if not cls.concurrent:
                continue
            fields: Dict[str, Set[str]] = {}
            writes: Set[str] = set()
            for mname, m in cls.methods.items():
                for acc in m.accesses:
                    if acc.attr in cls.lock_attrs or \
                            acc.attr in cls.self_sync:
                        continue
                    if mname == "__init__":
                        continue
                    fields.setdefault(acc.attr, set()).update(m.roots)
                    if acc.write:
                        writes.add(acc.attr)
            for attr, roots in fields.items():
                if attr in cls.decls:
                    continue
                key = (id(cls), attr)
                roots = roots | foreign_roots.get(key, set())
                written = attr in writes or foreign_writes.get(
                    key, False
                )
                if written and len(roots) >= 2:
                    node = cls.node
                    # report at the first access inside the class
                    for m in cls.methods.values():
                        for acc in m.accesses:
                            if acc.attr == attr:
                                node = acc.node
                                break
                        else:
                            continue
                        break
                    self.emit(
                        cls.file, node, "undeclared-shared",
                        f"{cls.name}.{attr} written outside __init__ "
                        f"and reachable from {len(roots)} thread roots "
                        f"({', '.join(sorted(roots))}) with no "
                        "guarded_by/unguarded declaration",
                        tag=attr,
                    )

    def _check_unknown_locks(self) -> None:
        for cls in self.classes:
            for fname, decl in cls.decls.items():
                if decl.lock is not None and \
                        decl.lock not in self.lock_registry:
                    self.emit(
                        cls.file, decl.node, "guard-unknown-lock",
                        f"{cls.name}.{fname} guarded_by({decl.lock!r}) "
                        "— no factory site registers that name",
                        tag=fname,
                    )

    # --------------------------------------------------- paired opens

    def _check_pairs(self, fobj: _File) -> None:
        for node in ast.walk(fobj.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_pairs_in(fobj, node)

    def _in_finally(self, fobj: _File, node: ast.AST,
                    stop: ast.AST) -> bool:
        cur = fobj.parents.get(node)
        while cur is not None and cur is not stop:
            if isinstance(cur, ast.Try):
                for fin in cur.finalbody:
                    for sub in ast.walk(fin):
                        if sub is node:
                            return True
            cur = fobj.parents.get(cur)
        return False

    @classmethod
    def _walk_scope(cls, node: ast.AST, root: bool = True):
        """ast.walk that stays in one function scope: nested defs and
        lambdas open their own open/close discipline."""
        if not root and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return
        yield node
        for child in ast.iter_child_nodes(node):
            yield from cls._walk_scope(child, root=False)

    def _check_pairs_in(self, fobj: _File, fn: ast.AST) -> None:
        opens: Dict[Tuple[str, str], List[ast.Call]] = {}
        closes: Dict[Tuple[str, str], List[ast.Call]] = {}
        exits: List[ast.AST] = []
        for node in self._walk_scope(fn):
            if isinstance(node, (ast.Return, ast.Raise)):
                exits.append(node)
            if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute
            ):
                continue
            attr = node.func.attr
            recv = _recv_key(node.func.value)
            if attr in _PAIRS:
                # `with lock.acquire()`-style or `with x:` handled by
                # guarded-by; skip acquire calls used as context exprs
                parent = fobj.parents.get(node)
                if isinstance(parent, ast.withitem):
                    continue
                opens.setdefault((recv, _PAIRS[attr]), []).append(node)
            if attr in set(_PAIRS.values()):
                closes.setdefault((recv, attr), []).append(node)
        for (recv, closer), open_calls in opens.items():
            close_calls = closes.get((recv, closer), [])
            if not close_calls:
                continue  # ownership transfer out of the function
            first_open = min(c.lineno for c in open_calls)
            unsafe_close = [
                c for c in close_calls
                if not self._in_finally(fobj, c, fn)
            ]
            if not unsafe_close:
                continue
            last_close = max(c.lineno for c in unsafe_close)
            leaky = [
                e for e in exits
                if first_open < e.lineno < last_close
                and not self._guards_failed_open(fobj, e, open_calls)
            ]
            if leaky:
                self.emit(
                    fobj, open_calls[0], "unbalanced-pair",
                    f"`{recv}` opened here but the matching "
                    f".{closer}() at line {last_close} is skipped by "
                    f"the return/raise at line {leaky[0].lineno} — "
                    "close in a finally",
                    tag=f"{recv}.{closer}",
                )

    def _guards_failed_open(self, fobj: _File, exit_node: ast.AST,
                            open_calls: List[ast.Call]) -> bool:
        """An exit inside the except handler of the try that contains
        the open itself runs only when the open FAILED — nothing was
        acquired, so it cannot leak."""
        cur = fobj.parents.get(exit_node)
        while cur is not None:
            if isinstance(cur, ast.ExceptHandler):
                try_node = fobj.parents.get(cur)
                if isinstance(try_node, ast.Try):
                    for stmt in try_node.body:
                        for sub in ast.walk(stmt):
                            if sub in open_calls:
                                return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return False
            cur = fobj.parents.get(cur)
        return False

    # ----------------------------------------------- dispatch hygiene

    def _in_loop(self, fobj: _File, node: ast.AST) -> bool:
        cur = fobj.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.While, ast.For, ast.AsyncFor)):
                return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return False
            cur = fobj.parents.get(cur)
        return False

    def _jit_attr_names(self, fobj: _File) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(fobj.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ) and fobj.resolve(_dotted(node.value.func)) == "jax.jit":
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute):
                        names.add(tgt.attr)
        return names

    def _check_host_sync(self, fobj: _File) -> None:
        jit_attrs = self._jit_attr_names(fobj)
        for node in ast.walk(fobj.tree):
            if not isinstance(node, ast.Call):
                continue
            if not self._in_loop(fobj, node):
                continue
            dotted = fobj.resolve(_dotted(node.func))
            if dotted in _SYNC_CALLS:
                self.emit(
                    fobj, node, "host-sync-in-loop",
                    f"{dotted.rsplit('.', 1)[-1]}() inside a loop — "
                    "one device->host sync per iteration; hoist to a "
                    "single batched readback",
                )
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_ATTRS and not node.args:
                self.emit(
                    fobj, node, "host-sync-in-loop",
                    f".{node.func.attr}() inside a loop — one "
                    "device->host sync per iteration; hoist to a "
                    "single batched readback",
                )
                continue
            if isinstance(node.func, ast.Name) and \
                    node.func.id in ("float", "int", "bool") and \
                    len(node.args) == 1 and isinstance(
                        node.args[0], ast.Call):
                inner = node.args[0]
                inner_dotted = fobj.resolve(_dotted(inner.func))
                is_jit = (
                    isinstance(inner.func, ast.Attribute)
                    and inner.func.attr in jit_attrs
                )
                if is_jit or inner_dotted.startswith("jax.numpy.") or \
                        inner_dotted.startswith("jax.") or \
                        inner_dotted.startswith("torch."):
                    self.emit(
                        fobj, node, "host-sync-in-loop",
                        f"{node.func.id}(<device value>) inside a loop "
                        "forces a blocking transfer per iteration",
                    )

    def _static_names(self, call: ast.Call) -> Optional[Set[str]]:
        for kw in call.keywords:
            if kw.arg in ("static_argnames", "static_argnums"):
                out: Set[str] = set()
                val = kw.value
                elts = val.elts if isinstance(
                    val, (ast.Tuple, ast.List, ast.Set)
                ) else [val]
                for e in elts:
                    if isinstance(e, ast.Constant):
                        out.add(str(e.value))
                return out
        return None

    def _shapeish(self, name: str) -> bool:
        return any(
            seg in _SHAPE_SEGMENTS for seg in name.lower().split("_")
        )

    def _check_jit_shapes(self, fobj: _File) -> None:
        # map function name -> def node (methods + module functions)
        defs: Dict[str, ast.AST] = {}
        for node in ast.walk(fobj.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, node)
        for node in ast.walk(fobj.tree):
            if not isinstance(node, ast.Call) or \
                    fobj.resolve(_dotted(node.func)) != "jax.jit":
                continue
            if not node.args:
                continue
            wrapped = node.args[0]
            fn_name = None
            if isinstance(wrapped, ast.Attribute):
                fn_name = wrapped.attr
            elif isinstance(wrapped, ast.Name):
                fn_name = wrapped.id
            target = defs.get(fn_name or "")
            if target is None:
                continue
            statics = self._static_names(node) or set()
            params = [a.arg for a in target.args.args][1:] \
                if target.args.args and \
                target.args.args[0].arg in ("self", "cls") \
                else [a.arg for a in target.args.args]
            params += [a.arg for a in target.args.kwonlyargs]
            for p in params:
                if self._shapeish(p) and p not in statics:
                    self.emit(
                        fobj, node, "nonstatic-shape-arg",
                        f"jit of {fn_name}(): shape-bearing parameter "
                        f"{p!r} not in static_argnames — it will be "
                        "traced (silent degrade) instead of compiled "
                        "per bounded value",
                        tag=p,
                    )

    def _check_jit_budget(self, fobj: _File) -> None:
        budget: Set[str] = set()
        budget_fns = [
            n for n in ast.walk(fobj.tree)
            if isinstance(n, ast.FunctionDef)
            and n.name == "compile_budget"
        ]
        for fn in budget_fns:
            for node in ast.walk(fn):
                if isinstance(node, ast.Constant) and isinstance(
                    node.value, str
                ):
                    budget.add(node.value)
        if not budget_fns:
            return
        for node in ast.walk(fobj.tree):
            if not isinstance(node, ast.Call) or \
                    fobj.resolve(_dotted(node.func)) != "jax.jit":
                continue
            parent = fobj.parents.get(node)
            key = None
            if isinstance(parent, ast.Assign):
                for tgt in parent.targets:
                    if isinstance(tgt, ast.Attribute):
                        key = tgt.attr.lstrip("_")
            if key is None:
                self.emit(
                    fobj, node, "unbudgeted-jit",
                    "jax.jit program not bound to a self._X attribute "
                    "— it cannot be accounted by compile_budget()",
                )
            elif key not in budget:
                self.emit(
                    fobj, node, "unbudgeted-jit",
                    f"jit program {key!r} missing from "
                    "compile_budget() — every compiled program belongs "
                    "to the declared bounded set",
                    tag=key,
                )

    def _enclosing_def(self, fobj: _File,
                       node: ast.AST) -> Optional[ast.AST]:
        cur = fobj.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = fobj.parents.get(cur)
        return None

    def _key_form(self, key: ast.AST,
                  defs: Dict[str, ast.AST]) -> Optional[str]:
        """The form (first element) of a graph key: a tuple literal's
        first string, or the first string of the tuple a ``self._X_key
        (...)`` helper returns; None when it cannot be read statically."""
        if isinstance(key, ast.Tuple) and key.elts:
            head = key.elts[0]
            if isinstance(head, ast.Constant) and isinstance(
                head.value, str
            ):
                return head.value
            return None
        if isinstance(key, ast.Call) and isinstance(
            key.func, ast.Attribute
        ):
            fn = defs.get(key.func.attr)
            if fn is None:
                return None
            forms = {
                self._key_form(r.value, {})
                for r in ast.walk(fn)
                if isinstance(r, ast.Return) and r.value is not None
            }
            if len(forms) == 1:
                return forms.pop()
        return None

    def _check_graph_budget(self, fobj: _File) -> None:
        budget: Set[str] = set()
        forms: Optional[Set[str]] = None
        defs: Dict[str, ast.AST] = {}
        for node in ast.walk(fobj.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, node)
                if node.name == "compile_budget":
                    budget |= {
                        n.value for n in ast.walk(node)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str)
                    }
        for stmt in getattr(fobj.tree, "body", []):
            if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "GRAPH_FORMS"
                for t in stmt.targets
            ):
                forms = {
                    n.value for n in ast.walk(stmt.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)
                }
        for node in ast.walk(fobj.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = self._enclosing_def(fobj, node)
            fn_name = getattr(fn, "name", "")
            dotted = fobj.resolve(_dotted(node.func))
            if dotted in _GRAPH_CALLS:
                if fn_name != _CAPTURE_HELPER:
                    self.emit(
                        fobj, node, "unbudgeted-graph",
                        f"{dotted}() outside the engine's capture helper "
                        f"{_CAPTURE_HELPER}() — no key, no budget, no "
                        "compile record",
                    )
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _CAPTURE_ENTRIES
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self" and node.args):
                continue
            if fn_name in _CAPTURE_ENTRIES:
                continue  # a helper handing its own key on
            form = self._key_form(node.args[0], defs)
            if form is None:
                self.emit(
                    fobj, node, "unbudgeted-graph",
                    f"graph key of {node.func.attr}() has no form this "
                    "gate can read (a tuple whose first element is a "
                    "string, or a self._X_key() helper returning one)",
                )
            elif forms is None or form not in forms:
                self.emit(
                    fobj, node, "unbudgeted-graph",
                    f"graph form {form!r} is not in GRAPH_FORMS",
                    tag=form,
                )
            elif form not in budget:
                self.emit(
                    fobj, node, "unbudgeted-graph",
                    f"graph form {form!r} missing from compile_budget() "
                    "— every captured graph belongs to the declared "
                    "bounded set",
                    tag=form,
                )

    # ------------------------------------------------- reason catalog

    def _check_dead_reasons(self) -> None:
        catalog: Optional[_File] = None
        catalog_tree = None
        for fobj in self.files:
            if fobj.tree is None:
                continue
            for node in ast.walk(fobj.tree):
                if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "EVENT_REASONS"
                    for t in node.targets
                ):
                    catalog, catalog_tree = fobj, fobj.tree
                    break
            if catalog:
                break
        if catalog is None:
            return
        reasons: Dict[str, ast.AST] = {}
        containers: Dict[str, Set[str]] = {}
        body = getattr(catalog_tree, "body", [])
        for stmt in body:
            if not isinstance(stmt, ast.Assign):
                continue
            tgt = stmt.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            if re.match(r"^REASON_[A-Z0-9_]+$", tgt.id) and isinstance(
                stmt.value, ast.Constant
            ):
                reasons[tgt.id] = stmt
            elif tgt.id != "EVENT_REASONS":
                refs = {
                    n.id for n in ast.walk(stmt.value)
                    if isinstance(n, ast.Name)
                    and n.id.startswith("REASON_")
                }
                if refs:
                    containers[tgt.id] = refs
        if not reasons:
            return
        used: Set[str] = set()
        container_used: Set[str] = set()
        for fobj in self.files:
            if fobj is catalog or fobj.tree is None:
                continue
            for node in ast.walk(fobj.tree):
                name = None
                if isinstance(node, ast.Name):
                    name = node.id
                elif isinstance(node, ast.Attribute):
                    name = node.attr
                if name is None:
                    continue
                if name.startswith("REASON_"):
                    used.add(name)
                elif name in containers:
                    container_used.add(name)
        for cname in container_used:
            used |= containers[cname]
        for rname, node in reasons.items():
            if rname not in used:
                self.emit(
                    catalog, node, "dead-reason",
                    f"{rname} has no emit site in the program — delete "
                    "it or wire the emitter it documents",
                    tag=rname,
                )

    # ----------------------------------------------------- guard dump

    def guard_map(self) -> Dict[str, Dict[str, Dict[str, Optional[str]]]]:
        out: Dict[str, Dict[str, Dict[str, Optional[str]]]] = {}
        for cls in self.classes:
            if not cls.decls:
                continue
            key = f"{cls.file.display}:{cls.name}"
            out[key] = {
                fname: {"lock": d.lock, "reason": d.reason,
                        "reads": d.reads}
                for fname, d in cls.decls.items()
            }
        return out


# ----------------------------------------------------------------- API


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


def check_paths(paths: Iterable[str]) -> List[Finding]:
    return build_checker(paths).findings


def build_checker(paths: Iterable[str]) -> Checker:
    checker = Checker()
    for path in iter_python_files(paths):
        if any(path.endswith(skip) for skip in SKIP_FILES):
            continue
        rel = os.path.relpath(path, _REPO_ROOT)
        display = rel if not rel.startswith("..") else path
        checker.add_file(path, display)
    checker.run()
    return checker


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="slicecheck", description=__doc__.splitlines()[0],
    )
    ap.add_argument("paths", nargs="*", help="files or directories "
                    f"(default: {_PKG})")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--dump-guards", action="store_true",
                    help="print the class -> field -> lock guard map "
                    "as JSON and exit 0")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}: {desc}")
        return 0
    paths = args.paths or [_PKG_ROOT]
    checker = build_checker(paths)
    if args.dump_guards:
        print(json.dumps(checker.guard_map(), indent=2, sort_keys=True))
        return 0
    for f in checker.findings:
        print(f)
    if checker.findings:
        print(
            f"slicecheck: {len(checker.findings)} finding(s) — fix, or "
            "suppress a justified site with "
            "'# slicecheck: disable=<rule>'",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
