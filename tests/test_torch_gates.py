"""The port's static gates (``instaslice_tpu_torch/analysis/slicelint.py``
and ``slicecheck.py``) held against the reference's (``tools/``).

- Fixture parity: ``tests/lint_fixtures/`` and ``tests/check_fixtures/``
  go through both packages' gates, the fixtures' imports mapped to the
  port's package for the port's; the lists of (rule, line, col) are equal.
- The torch rules, on fixtures written here: a ``.cpu()``, a
  ``.numpy()``, a ``torch.cuda.synchronize()`` and a ``float`` of a torch
  call in a hot-path loop, a CUDA graph made outside the engine's capture
  helper and captures under forms that ``GRAPH_FORMS`` or
  ``compile_budget()`` lack each fire; a clean twin of each does not.
- The gate itself: both report 0 findings over ``instaslice_tpu_torch``,
  every ``guarded_by`` names a lock a ``named_*`` factory creates, and
  the port's images run both before ``pip install``.
- Controls: the reference's gates over the port still report its
  allowlists' findings (they name only ``instaslice_tpu/...`` paths); a
  raw lock seeded into a copy of a port module, and the lock taken away
  from a field the port declares guarded, are each reported.
"""

from __future__ import annotations

import importlib.util
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

import pytest

from instaslice_tpu_torch.analysis import slicecheck as port_check
from instaslice_tpu_torch.analysis import slicelint as port_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "instaslice_tpu_torch")
LINT_FIX = os.path.join(REPO, "tests", "lint_fixtures")
CHECK_FIX = os.path.join(REPO, "tests", "check_fixtures")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


ref_lint = _load_tool("slicelint")
ref_check = _load_tool("slicecheck")


def _mapped_copy(src, dst):
    """``src`` (a file or a tree) copied to ``dst`` with the reference
    package's imports renamed to the port's."""
    if os.path.isfile(src):
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(src) as f:
            text = f.read()
        with open(dst, "w") as f:
            f.write(text.replace("instaslice_tpu.", "instaslice_tpu_torch."))
        return dst
    for root, dirs, files in os.walk(src):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fn in files:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, fn), src)
                _mapped_copy(os.path.join(root, fn), os.path.join(dst, rel))
    return dst


def _keyed(findings, root):
    return sorted((os.path.relpath(f.path if os.path.isabs(f.path)
                                   else os.path.join(REPO, f.path), root),
                   f.rule, f.line, f.col) for f in findings)


# ------------------------------------------------------------ fixture parity

@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(LINT_FIX) if n.endswith(".py")))
def test_lint_fixture_parity(name, tmp_path):
    src = os.path.join(LINT_FIX, name)
    dst = _mapped_copy(src, str(tmp_path / name))
    want = [(f.rule, f.line, f.col) for f in ref_lint.lint_file(src)]
    got = [(f.rule, f.line, f.col) for f in port_lint.lint_file(dst)]
    assert got == want
    if name == "seeded_violations.py":
        assert {r for r, _, _ in got} == set(ref_lint.RULES)


def _check_fixture_cases():
    out = ["."]
    for root, dirs, files in os.walk(CHECK_FIX):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.relpath(os.path.join(root, f), CHECK_FIX)
                for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("rel", _check_fixture_cases())
def test_check_fixture_parity(rel, tmp_path):
    """The corpus as one program ("."), and each file alone."""
    root = _mapped_copy(CHECK_FIX, str(tmp_path / "fixtures"))
    want = _keyed(ref_check.check_paths([os.path.join(CHECK_FIX, rel)]),
                  CHECK_FIX)
    got = _keyed(port_check.check_paths([os.path.join(root, rel)]), root)
    assert got == want
    if rel == ".":
        # every rule of the reference fires on its corpus; the port's one
        # rule more is a torch rule the corpus has no site for
        assert {r for _, r, _, _ in got} == set(ref_check.RULES)
        assert set(port_check.RULES) - set(ref_check.RULES) == {
            "unbudgeted-graph"}


def test_rule_ids_and_grammar_are_the_references():
    assert list(port_lint.RULES) == list(ref_lint.RULES)
    assert port_lint._SUPPRESS_RE.pattern == ref_lint._SUPPRESS_RE.pattern
    assert port_check._SUPPRESS_RE.pattern == ref_check._SUPPRESS_RE.pattern
    assert ref_check._SYNC_ATTRS < port_check._SYNC_ATTRS
    assert ref_check._SYNC_CALLS < port_check._SYNC_CALLS


# --------------------------------------------------------------- torch rules

HOT_LOOP = '''\
import torch


def drive(step, x, n):
    out = []
    for _ in range(n):
        x = step(x)
        {sync}
    return out
'''

#: (a sync in the loop, its clean twin hoisted past the loop)
SYNCS = {
    "cpu": ("out.append(x.cpu())", "out.append(x)"),
    "numpy": ("out.append(x.numpy())", "out.append(x)"),
    "synchronize": ("torch.cuda.synchronize()", "out.append(x)"),
    "float_of_torch": ("out.append(float(torch.sum(x)))",
                       "out.append(torch.sum(x))"),
    "item": ("out.append(x.item())", "out.append(x)"),
}


@pytest.mark.parametrize("kind", sorted(SYNCS))
def test_host_sync_in_loop_fires_on_torch(kind, tmp_path):
    bad, clean = SYNCS[kind]
    hot = tmp_path / "models"
    hot.mkdir()
    (hot / "bad.py").write_text(HOT_LOOP.format(sync=bad))
    (hot / "clean.py").write_text(HOT_LOOP.format(sync=clean))
    found = port_check.check_paths([str(hot / "bad.py")])
    assert [(f.rule, f.line) for f in found] == [("host-sync-in-loop", 8)]
    assert port_check.check_paths([str(hot / "clean.py")]) == []
    # outside the hot path the same loop is nobody's business
    cold = tmp_path / "cli"
    cold.mkdir()
    (cold / "bad.py").write_text(HOT_LOOP.format(sync=bad))
    assert port_check.check_paths([str(cold / "bad.py")]) == []


ENGINE = '''\
import functools

import torch

GRAPH_FORMS = ("decode_block", "spec_round")


class Engine:
    def compile_budget(self):
        return {{"decode_block": 2}}

    def _decode_key(self, attend):
        return ("decode_block", attend)

    def _rogue_key(self, attend):
        return ("rogue", attend)

    def _capture(self, key, fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph

    def _program(self, key, fn):
        return self._capture(key, fn)

    def _warm(self, key, fn):
        self._capture(key, fn)

    def step(self, fn, attend):
        {site}
'''

#: (a capture site the gate must refuse, its clean twin)
CAPTURES = {
    "graph_outside_helper": (
        "torch.cuda.CUDAGraph().replay()",
        "self._program(self._decode_key(attend), fn)()"),
    "graph_context_outside_helper": (
        "torch.cuda.graph(self._graph)",
        "self._warm(self._decode_key(attend), fn)"),
    "form_not_in_graph_forms": (
        'self._program(("draft_catchup", attend), fn)()',
        'self._program(("decode_block", attend), fn)()'),
    "helper_key_not_in_graph_forms": (
        "self._warm(self._rogue_key(attend), fn)",
        "self._warm(self._decode_key(attend), fn)"),
    "form_not_in_budget": (
        'self._program(("spec_round", attend), fn)()',
        'self._program(("decode_block", 0), fn)()'),
    "unreadable_key": (
        "self._program(functools.partial(tuple, attend), fn)()",
        "self._program(self._decode_key(0), fn)()"),
}


@pytest.mark.parametrize("kind", sorted(CAPTURES))
def test_unbudgeted_graph(kind, tmp_path):
    bad, clean = CAPTURES[kind]
    d = tmp_path / "serving"
    d.mkdir()
    (d / "engine_bad.py").write_text(ENGINE.format(site=bad))
    (d / "engine_clean.py").write_text(ENGINE.format(site=clean))
    found = port_check.check_paths([str(d / "engine_bad.py")])
    assert [(f.rule, f.line) for f in found] == [("unbudgeted-graph", 31)]
    assert port_check.check_paths([str(d / "engine_clean.py")]) == []


def test_the_engines_capture_sites_are_read():
    """The port's engine passes because its keys are read, not skipped:
    each capture site outside the helpers resolves to a form of
    GRAPH_FORMS that compile_budget() counts."""
    from instaslice_tpu_torch.serving.engine import GRAPH_FORMS

    import ast

    checker = port_check.Checker()
    checker.add_file(os.path.join(PKG, "serving", "engine.py"),
                     "instaslice_tpu_torch/serving/engine.py")
    fobj = checker.files[0]
    defs = {n.name: n for n in ast.walk(fobj.tree)
            if isinstance(n, ast.FunctionDef)}
    forms = []
    for node in ast.walk(fobj.tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr in (
                port_check._CAPTURE_ENTRIES) and node.args:
            fn = checker._enclosing_def(fobj, node)
            if fn.name not in port_check._CAPTURE_ENTRIES:
                forms.append(checker._key_form(node.args[0], defs))
    assert len(forms) >= 4 and set(forms) == set(GRAPH_FORMS)


# ------------------------------------------------------------------ the gate

@pytest.fixture(scope="module")
def port_checker():
    return port_check.build_checker([PKG])


def test_port_gates_report_nothing_over_the_port(port_checker):
    assert port_lint.lint_paths([PKG]) == []
    assert port_checker.findings == []


@pytest.mark.parametrize("gate", ["slicelint", "slicecheck"])
def test_port_gates_as_modules(gate):
    """``python -m`` from the repository root, default path the port."""
    proc = subprocess.run(
        [sys.executable, "-m", f"instaslice_tpu_torch.analysis.{gate}"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout == "", \
        proc.stdout + proc.stderr
    rules = subprocess.run(
        [sys.executable, "-m", f"instaslice_tpu_torch.analysis.{gate}",
         "--list-rules"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    mod = port_lint if gate == "slicelint" else port_check
    assert rules.returncode == 0 and [
        line.split(":")[0] for line in rules.stdout.splitlines()] == list(
        mod.RULES)


def test_every_guard_names_a_factory_lock(port_checker):
    checker = port_checker
    guarded = [(cls, fld, d["lock"])
               for cls, fields in checker.guard_map().items()
               for fld, d in fields.items() if d["lock"] is not None]
    assert guarded and all(lock in checker.lock_registry
                           for _, _, lock in guarded)
    unguarded = [(cls, fld, d["reason"])
                 for cls, fields in checker.guard_map().items()
                 for fld, d in fields.items() if d["lock"] is None]
    assert all(reason for _, _, reason in unguarded), unguarded
    # the declarations the repair of the hand-written gRPC wire added
    files = {cls.split(":")[0] for cls, _, _ in guarded}
    for f in ("deviceplugin/h2.py", "deviceplugin/wire.py",
              "deviceplugin/server.py"):
        assert f"instaslice_tpu_torch/{f}" in files
    assert len(guarded) >= 12 and len(files) >= 5


def test_every_suppression_states_its_reason():
    """A ``# slicelint: disable=`` / ``# slicecheck: disable=`` in the
    port carries a reason: words after the rule list, or a comment on
    the line right above it or right below it."""
    tag = re.compile(r"#\s*slice(lint|check):\s*disable(-file)?=[a-z\-,]+")
    bare = []
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                lines = f.read().splitlines()
            for i, line in enumerate(lines):
                m = tag.search(line)
                if not m or "_SUPPRESS" in line or line.lstrip().startswith(
                        ("``", "Suppression")):
                    continue
                after = line[m.end():].strip()
                above = lines[i - 1].strip() if i else ""
                below = lines[i + 1] if i + 1 < len(lines) else ""
                if not after and not above.startswith("#") and \
                        "#" not in below:
                    bare.append(f"{path}:{i + 1}")
    assert bare == []


def test_the_port_images_run_both_gates_before_pip_install():
    for name in ("agent", "controller", "deviceplugin"):
        path = os.path.join(PKG, "deploy", f"Dockerfile.{name}")
        with open(path) as f:
            text = f.read()
        runs = " ".join(re.findall(r"^RUN (.*)$", text.replace("\\\n", " "),
                                   re.M))
        lint = runs.find("-m instaslice_tpu_torch.analysis.slicelint")
        check = runs.find("-m instaslice_tpu_torch.analysis.slicecheck")
        pip = runs.find("pip install")
        assert 0 <= lint < pip and 0 <= check < pip, name
        assert "No static gate runs here yet" not in text


# ------------------------------------------------------------------ controls

def test_reference_gates_still_report_the_allowlists_over_the_port():
    """The reference's allowlists name only ``instaslice_tpu/...`` and
    ``tools/...`` files: over the port it reports exactly the port's
    counterparts of those files (and nothing else)."""
    found = ref_lint.lint_paths([PKG])
    allowed = {"raw-http": ref_lint.RAW_HTTP_ALLOW,
               "raw-lock": ref_lint.RAW_LOCK_ALLOW,
               "name-literal": ref_lint.NAME_LITERAL_ALLOW}
    counterparts = {"analysis/telemetry_smoke.py": "tools/telemetry_smoke.py",
                    "analysis/profile_smoke.py": "tools/profile_smoke.py"}
    assert found
    for f in found:
        rel = f.path.replace(os.sep, "/").split("instaslice_tpu_torch/", 1)[1]
        ref = counterparts.get(rel, f"instaslice_tpu/{rel}")
        assert f.rule in allowed and ref in allowed[f.rule], str(f)
    by_rule = Counter(f.rule for f in found)
    assert set(by_rule) == set(allowed)
    assert ref_check.check_paths([PKG]) == []


def test_control_seeded_raw_lock_is_reported(tmp_path):
    src = os.path.join(PKG, "device", "registry.py")
    dst = tmp_path / "instaslice_tpu_torch" / "device" / "registry.py"
    dst.parent.mkdir(parents=True)
    with open(src) as f:
        text = f.read()
    seeded = text.replace('named_lock("device.registry")', "threading.Lock()")
    assert seeded != text
    dst.write_text(seeded)
    line = seeded[:seeded.index("threading.Lock()")].count("\n") + 1
    found = port_lint.lint_file(str(dst))
    assert [(f.rule, f.line) for f in found] == [("raw-lock", line)]
    shutil.copy(src, dst)
    assert port_lint.lint_file(str(dst)) == []


def test_control_unlocked_guarded_read_is_reported(tmp_path):
    """The lock ``_header_frames`` takes to read the peer's frame size
    taken away: ``guarded-field`` reports the read."""
    src = os.path.join(PKG, "deviceplugin", "h2.py")
    d = tmp_path / "pkg"
    shutil.copytree(os.path.join(PKG, "deviceplugin"), d / "deviceplugin")
    shutil.copytree(os.path.join(PKG, "utils"), d / "utils")
    with open(src) as f:
        text = f.read()
    locked = ("        with self._cv:\n"
              "            n = self.peer_max_frame\n")
    assert text.count(locked) == 1
    (d / "deviceplugin" / "h2.py").write_text(text.replace(
        locked, "        n = self.peer_max_frame\n"))
    found = port_check.check_paths([str(d)])
    assert [(f.rule, os.path.basename(f.path)) for f in found] == [
        ("guarded-field", "h2.py")]
    assert "Connection.peer_max_frame (read)" in found[0].message
