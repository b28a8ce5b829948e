"""The port's JSON-lines sinks and test helpers against the reference's:
``TPUSLICE_TRACE_FILE`` (``utils/trace.py``), ``TPUSLICE_EVENT_FILE`` and
its size rotation (``obs/journal.py``), and the helpers the reference's
telemetry tests use (``current_span``, ``Tracer.clear``/``close``,
``reset_tracer``, ``Journal.tail``/``clear``/``close``, ``reset_journal``,
``Event.from_dict``, ``reset_profiler``, ``Profiler.disarm``/``clear``, and
lockcheck's ``arm``/``armed``/``disarm``, ``snapshot``/``restore``/``reset``,
``assert_clean`` and ``LockOrderError``).

The journal cases are the reference's ``TestJournalRotation``
(``tests/test_telemetry.py``), each run on both journals over the same
emits: the files each leaves behind must hold equal lines apart from each
event's own ``seq`` and ``ts``. The tracer's sink is read in a fresh
process, as a server reads its environment once at start.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from instaslice_tpu.api import constants as rc
from instaslice_tpu.obs import journal as rj
from instaslice_tpu.obs import profiler as rprof
from instaslice_tpu.utils import lockcheck as rlock
from instaslice_tpu.utils import trace as rtrace
from instaslice_tpu_torch.api import constants as pc
from instaslice_tpu_torch.cli import tpuslicectl
from instaslice_tpu_torch.obs import journal as pj
from instaslice_tpu_torch.obs import profiler as pprof
from instaslice_tpu_torch.utils import lockcheck as plock
from instaslice_tpu_torch.utils import trace as ptrace

REPO = Path(__file__).resolve().parents[1]

#: (journal module, constants module) of each side
SIDES = {"reference": (rj, rc), "port": (pj, pc)}


def _emit_n(journal, consts, n):
    for i in range(n):
        journal.emit("test", reason=consts.REASON_SLICE_UNGATED,
                     object_ref=f"alloc/{i}", message="x" * 64,
                     chips=str(i % 8))


def _lines(path):
    """A JSONL file's records without each event's own seq and ts."""
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            assert isinstance(rec.pop("seq"), int)
            assert isinstance(rec.pop("ts"), float)
            out.append(rec)
    return out


def _generations(path):
    """``{suffix: records}`` of every file the sink left: the live file
    (suffix "") and its rotated generations ``.1`` ... ``.9``."""
    return {sfx: _lines(path + sfx) for sfx in [""] + [f".{i}" for i in
                                                      range(1, 10)]
            if os.path.exists(path + sfx)}


def _journal_case(case, side, tmp_path, monkeypatch):
    """Run one rotation case on one side's journal in its own directory;
    returns what the case observed."""
    mod, consts = SIDES[side]
    d = tmp_path / side
    d.mkdir()
    path = str(d / "events.jsonl")
    clock = lambda: 1000.0  # noqa: E731 - pinned, as the reference's
    if case == "rotates_and_keeps_n":
        j = mod.Journal(event_file=path, max_mb=0.0005, keep=2,
                        clock=clock)
        _emit_n(j, consts, 40)
        j.close()
        return {"files": _generations(path),
                "ring": j.counts()[consts.REASON_SLICE_UNGATED]}
    if case == "unbounded_by_default":
        j = mod.Journal(event_file=path, clock=clock)
        _emit_n(j, consts, 40)
        j.close()
        return {"files": _generations(path)}
    if case == "env_knobs":
        monkeypatch.setenv("TPUSLICE_EVENT_FILE_MAX_MB", "2")
        monkeypatch.setenv("TPUSLICE_EVENT_FILE_KEEP", "5")
        j = mod.Journal(event_file=str(d / "e.jsonl"), clock=clock)
        knobs = [j._max_bytes, j._keep]
        j.close()
        monkeypatch.setenv("TPUSLICE_EVENT_FILE_MAX_MB", "junk")
        monkeypatch.setenv("TPUSLICE_EVENT_FILE_KEEP", "junk")
        j = mod.Journal(event_file=str(d / "e2.jsonl"), clock=clock)
        knobs += [j._max_bytes, j._keep]
        j.close()
        # the knobs rotate a sink named by TPUSLICE_EVENT_FILE alone
        monkeypatch.setenv("TPUSLICE_EVENT_FILE", path)
        monkeypatch.setenv("TPUSLICE_EVENT_FILE_MAX_MB", "0.0005")
        monkeypatch.setenv("TPUSLICE_EVENT_FILE_KEEP", "1")
        j = mod.Journal(clock=clock)
        _emit_n(j, consts, 40)
        j.close()
        return {"knobs": knobs, "files": _generations(path)}
    if case == "rotation_failure_degrades_to_ring_only":
        j = mod.Journal(event_file=path, max_mb=0.0005, keep=2,
                        clock=clock)

        def boom(*a, **k):
            raise OSError("disk broke")

        with monkeypatch.context() as m:
            m.setattr(mod.os, "replace", boom)
            _emit_n(j, consts, 40)
        out = {"sink": j._file,
               "ring": j.counts()[consts.REASON_SLICE_UNGATED],
               "files": _generations(path)}
        j.close()
        return out
    if case == "unwritable_sink_degrades_to_ring_only":
        j = mod.Journal(event_file=str(d / "missing" / "e.jsonl"),
                        clock=clock)
        _emit_n(j, consts, 3)
        out = {"sink": j._file,
               "ring": j.counts()[consts.REASON_SLICE_UNGATED],
               "files": _generations(path)}
        j.close()
        return out
    raise AssertionError(case)


JOURNAL_CASES = ("rotates_and_keeps_n", "unbounded_by_default",
                 "env_knobs", "rotation_failure_degrades_to_ring_only",
                 "unwritable_sink_degrades_to_ring_only")


@pytest.mark.parametrize("case", JOURNAL_CASES)
def test_journal_sink_equals_the_reference(case, tmp_path, monkeypatch):
    for var in ("TPUSLICE_EVENT_FILE", "TPUSLICE_EVENT_FILE_MAX_MB",
                "TPUSLICE_EVENT_FILE_KEEP"):
        monkeypatch.delenv(var, raising=False)
    got = {side: _journal_case(case, side, tmp_path, monkeypatch)
           for side in SIDES}
    assert got["port"] == got["reference"]
    port = got["port"]
    files = port["files"]
    if case == "rotates_and_keeps_n":
        # keep=2 bounds the generations; the ring kept all 40
        assert set(files) == {"", ".1", ".2"}
        assert port["ring"] == 40
        assert all(r["reason"] == pc.REASON_SLICE_UNGATED
                   for recs in files.values() for r in recs)
    elif case == "unbounded_by_default":
        assert set(files) == {""} and len(files[""]) == 40
    elif case == "env_knobs":
        assert port["knobs"] == [2 * 1024 * 1024, 5, 0, 3]
        assert set(files) == {"", ".1"}
    elif case == "rotation_failure_degrades_to_ring_only":
        # the sink is gone but the ring keeps recording
        assert port["sink"] is None and port["ring"] == 40
        assert 0 < sum(len(r) for r in files.values()) < 40
    else:
        assert port["sink"] is None and port["ring"] == 3 and not files


def test_event_from_dict_round_trips_as_the_reference():
    d = {"seq": 7, "ts": 12.5, "component": "serve",
         "reason": pc.REASON_DRAINED, "objectRef": "replica/a",
         "message": "m", "traceId": "t" * 32, "attrs": {"n": 3}}
    assert pj.Event.from_dict(d).to_dict() == rj.Event.from_dict(d).to_dict()
    assert pj.Event.from_dict({}).to_dict() == rj.Event.from_dict({}).to_dict()


@pytest.mark.parametrize("side", ["reference", "port"])
def test_journal_tail_clear_and_reset(side, monkeypatch):
    mod, consts = SIDES[side]
    j = mod.Journal(clock=lambda: 5.0)
    _emit_n(j, consts, 5)
    assert [e.object_ref for e in j.tail(2)] == ["alloc/3", "alloc/4"]
    j.clear()
    assert j.events() == [] and j.counts() == {}
    old = mod.get_journal()
    try:
        mod.reset_journal(j)
        assert mod.get_journal() is j
        mod.reset_journal()
        assert mod.get_journal() is not j
    finally:
        mod.reset_journal(old)


@pytest.mark.parametrize("side", ["reference", "port"])
def test_tracer_helpers(side, tmp_path, monkeypatch):
    """``current_span``, ``Tracer(trace_file=)``, ``clear``, ``close``
    (a span after it is dropped from the file, never an exception) and
    ``reset_tracer`` (the env var re-read, the old handle closed)."""
    mod = {"reference": rtrace, "port": ptrace}[side]
    path = tmp_path / "t.jsonl"
    t = mod.Tracer(capacity=16, trace_file=str(path))
    assert mod.current_span() is None
    with t.span("serve.request") as outer:
        assert mod.current_span() is outer
        with t.span("engine.prefill") as inner:
            assert mod.current_span() is inner
        assert mod.current_span() is outer
    t.close()
    t.close()
    with t.span("serve.late"):
        pass
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in recs] == ["engine.prefill", "serve.request"]
    assert recs[0]["parentId"] == recs[1]["spanId"]
    t.clear()
    assert t.spans() == [] and t.counts() == {}
    env = tmp_path / "env.jsonl"
    monkeypatch.setenv("TPUSLICE_TRACE_FILE", str(env))
    old = mod.get_tracer()
    try:
        mod.reset_tracer()
        with mod.get_tracer().span("router.route"):
            pass
        mod.reset_tracer()
        assert [json.loads(x)["name"] for x in
                env.read_text().splitlines()] == ["router.route"]
    finally:
        mod.reset_tracer(old)


@pytest.mark.parametrize("side", ["reference", "port"])
def test_profiler_disarm_clear_and_reset(side):
    mod = {"reference": rprof, "port": pprof}[side]
    p = mod.Profiler()
    p.arm()
    assert p.armed
    p.event("scheduler", "test", rid="r")
    assert p.events()
    p.clear()
    assert p.events() == [] and p.rounds() == []
    p.disarm()
    assert not p.armed
    old = mod.get_profiler()
    try:
        mod.reset_profiler(p)
        assert mod.get_profiler() is p
        mod.reset_profiler()
        assert mod.get_profiler() is not p
    finally:
        mod.reset_profiler(old)


def _abba(mod, tag):
    """Take two named locks in both orders (one thread, so no deadlock):
    the second order closes a cycle."""
    a, b = mod.named_lock(f"sinks.{tag}.a"), mod.named_lock(f"sinks.{tag}.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _lockcheck_run(mod):
    """The helpers' contract on one module, its state restored after."""
    was = mod.armed()
    snap = mod.snapshot()
    seen = {}
    try:
        mod.reset()
        mod.arm()
        seen["armed"] = mod.armed()
        mod.assert_clean()
        _abba(mod, "x")
        with pytest.raises(mod.LockOrderError) as ei:
            mod.assert_clean()
        assert issubclass(mod.LockOrderError, AssertionError)
        seen["chains"] = [c["chain"] for c in ei.value.report["cycles"]]
        inner = mod.snapshot()
        mod.reset()
        mod.assert_clean()
        mod.restore(inner)
        seen["restored"] = [c["chain"] for c in mod.report()["cycles"]]
        mod.disarm()
        seen["disarmed"] = mod.armed()
        mod.reset()
        _abba(mod, "y")
        seen["disarmed_cycles"] = mod.report()["cycles"]
        # a lock taken armed and released disarmed leaves no stale entry
        lk = mod.named_lock("sinks.z")
        mod.arm()
        lk.acquire()
        mod.disarm()
        lk.release()
        mod.arm()
        with lk:
            pass
        seen["after_disarm_release"] = mod.report()["cycles"]
    finally:
        mod.disarm()
        mod.reset()
        mod.restore(snap)
        if was:
            mod.arm()
    return seen


def test_lockcheck_helpers_equal_the_reference():
    got = {"reference": _lockcheck_run(rlock), "port": _lockcheck_run(plock)}
    assert got["port"] == got["reference"]
    port = got["port"]
    assert port["armed"] and not port["disarmed"]
    assert port["chains"] == port["restored"] == [
        ["sinks.x.a", "sinks.x.b", "sinks.x.a"]]
    assert port["disarmed_cycles"] == [] == port["after_disarm_release"]


# ------------------------------------------------- the sinks in a process

#: what each side's fresh process does under the two env variables: a
#: routed request's span tree under one trace id, and two journal events
#: stamped with it
_CHILD = """
import sys
pkg = sys.argv[1]
trace = __import__(pkg + ".utils.trace", fromlist=["x"])
journal = __import__(pkg + ".obs.journal", fromlist=["x"])
constants = __import__(pkg + ".api.constants", fromlist=["x"])
tracer = trace.get_tracer()
tid = "ab" * 16
with tracer.span("router.route", trace_id=tid, replica="r0"):
    with tracer.span("serve.request", rid="req-1"):
        with tracer.span("engine.prefill", rows=4):
            pass
        with tracer.span("engine.decode", steps=2):
            pass
j = journal.get_journal()
j.emit("serve", reason=constants.REASON_DRAIN_BEGIN,
       object_ref="replica/r0", message="drain", trace_id=tid, budget=30)
j.emit("serve", reason=constants.REASON_DRAIN_END,
       object_ref="replica/r0", message="drained", trace_id=tid)
"""


def _run_child(pkg, env_files, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPUSLICE_TRACE_FILE", "TPUSLICE_EVENT_FILE")}
    env.update(env_files)
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _CHILD, pkg], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def _spans_by_name(path):
    """Each span's record with its ids replaced by the names they point
    at, and its times dropped."""
    recs = [json.loads(x) for x in Path(path).read_text().splitlines()]
    names = {r["spanId"]: r["name"] for r in recs}
    out = []
    for r in recs:
        assert r.pop("durationMs") >= 0 and r.pop("start") > 0
        assert len(r.pop("traceId")) == 32
        r.pop("spanId")
        if "parentId" in r:
            r["parentId"] = names[r["parentId"]]
        out.append(r)
    return out


def test_trace_and_event_files_in_a_fresh_process(tmp_path):
    files = {}
    for side, pkg in (("reference", "instaslice_tpu"),
                      ("port", "instaslice_tpu_torch")):
        d = tmp_path / side
        d.mkdir()
        files[side] = (d / "trace.jsonl", d / "events.jsonl")
        _run_child(pkg, {"TPUSLICE_TRACE_FILE": str(files[side][0]),
                         "TPUSLICE_EVENT_FILE": str(files[side][1])},
                   tmp_path)
    ptrace_file, pevent_file = files["port"]
    assert ptrace_file.exists() and pevent_file.exists()
    # the same JSONL as the reference's, apart from ids and times
    assert _spans_by_name(ptrace_file) == _spans_by_name(files["reference"][0])
    assert len(_spans_by_name(ptrace_file)) == 4
    assert _lines(pevent_file) == _lines(files["reference"][1])
    assert [e["reason"] for e in _lines(pevent_file)] == [
        pc.REASON_DRAIN_BEGIN, pc.REASON_DRAIN_END]
    # the reference's validators accept the port's files
    for tool, path in (("validate_trace.py", ptrace_file),
                       ("validate_events.py", pevent_file)):
        res = subprocess.run(
            [sys.executable, str(REPO / "tools" / tool), str(path)],
            cwd=tmp_path, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        assert json.loads(res.stdout.strip().splitlines()[-1])["ok"] is True
    # and tpuslice-gpu trace-summary reads it: a row per span name, and
    # the trace drilled into in start order
    spans = [json.loads(x) for x in ptrace_file.read_text().splitlines()]
    rows = _ctl(["trace-summary", str(ptrace_file)])
    assert sorted(r["name"] for r in rows) == sorted(s["name"] for s in spans)
    assert all(r["count"] == 1 for r in rows)
    drill = _ctl(["trace-summary", str(ptrace_file), "--trace", "ab" * 16])
    assert [r["name"] for r in drill] == [
        "router.route", "serve.request", "engine.prefill", "engine.decode"]


def test_control_no_env_variables_no_files(tmp_path):
    for pkg in ("instaslice_tpu", "instaslice_tpu_torch"):
        _run_child(pkg, {}, tmp_path)
    assert sorted(os.listdir(tmp_path)) == []


def _ctl(argv):
    """``tpuslice-gpu`` in process: its stdout's JSON lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_ = tpuslicectl.main(argv)
    assert rc_ == 0, buf.getvalue()
    return [json.loads(x) for x in buf.getvalue().splitlines() if x]


def test_version_is_the_reference_s():
    import instaslice_tpu
    import instaslice_tpu_torch

    assert instaslice_tpu_torch.__version__ == instaslice_tpu.__version__
