"""The port's observability gates (``instaslice_tpu_torch/analysis/``
``validate_trace.py``, ``validate_events.py``, ``telemetry_smoke.py``,
``profile_smoke.py``) held against the reference's (``tools/``).

- Cross-validation: the trace file and the event file of the reference's
  ``--drive`` (JAX sim + server) and of the port's (``--device cpu``)
  each pass BOTH packages' validators: the port's formats are the
  reference's. The four drives run as processes, side by side, while the
  telemetry and profile gates run here.
- Seeded corruptions of the port's files (a negative duration, an orphan
  parent, a duplicate ``spanId``; an unknown reason, a chain out of
  order, a missing ``traceId``) get the same verdict and the same error
  classes from both validators; ``--fleet`` over files split by process
  passes and fails as the merged store says.
- The telemetry gate's both arms and the profile gate's deterministic
  checks run on the CPU. Its tok/s ratio is a wall-clock comparison: it
  runs in ``make gpu-profile-smoke`` and on the card, not here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import threading

import pytest

from instaslice_tpu_torch.analysis import validate_events as port_events
from instaslice_tpu_torch.analysis import validate_trace as port_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


ref_trace = _load_tool("validate_trace")
ref_events = _load_tool("validate_events")

#: (package, kind) -> the drive's command, its file the last argument
DRIVES = {
    ("reference", "trace"): [sys.executable, "tools/validate_trace.py",
                             "--drive"],
    ("reference", "events"): [sys.executable, "tools/validate_events.py",
                              "--drive"],
    ("port", "trace"): [sys.executable, "-m",
                        "instaslice_tpu_torch.analysis.validate_trace",
                        "--drive", "--device", "cpu"],
    ("port", "events"): [sys.executable, "-m",
                         "instaslice_tpu_torch.analysis.validate_events",
                         "--drive", "--device", "cpu"],
}


#: the reference's events drive's one known race, in its own words: the
#: granted pod's rendering taken while its allocation was still created
REFERENCE_DESCRIBE_RACE = re.compile(
    r"describe-pod rendering for the granted pod is missing expected "
    r"entries .*status=created")


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    """Start the four drives at once; ``wait()`` hands back their files."""
    d = tmp_path_factory.mktemp("drives")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    procs = {}
    for key, cmd in DRIVES.items():
        path = str(d / f"{key[0]}-{key[1]}.jsonl")
        procs[key] = (path, subprocess.Popen(
            cmd + [path], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def wait():
        out = {}
        for key, (path, p) in procs.items():
            log, _ = p.communicate(timeout=240)
            rc = p.returncode
            if key == ("reference", "events") and rc != 0 and \
                    REFERENCE_DESCRIBE_RACE.search(log):
                # the reference's drive renders describe-pod as soon as
                # the pod runs, before the controller may have persisted
                # the ungated status (seen under load); tools/ is not
                # edited, so that one failure gets a second run
                again = subprocess.run(
                    DRIVES[key] + [path], cwd=REPO, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, timeout=240)
                rc, log = again.returncode, again.stdout
            assert rc == 0, f"{key}: {log[-3000:]}"
            assert json.loads(log.strip().splitlines()[-1])["ok"]
            out[key] = path
        return out

    yield wait
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def cpu_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------- the telemetry and profile gates, on the CPU

def test_telemetry_gate_both_arms(drives, cpu_threads):
    from instaslice_tpu_torch.analysis import telemetry_smoke as ts
    from instaslice_tpu_torch.faults import FaultPlan

    clean = ts.run_scenario("clean", "cpu")
    plan = (FaultPlan(42)
            .site("engine.decode", probability=0.25, kinds=("delay",),
                  delay_s=0.02)
            .site("engine.prefill", probability=0.25, kinds=("delay",),
                  delay_s=0.02)
            .site("scheduler.round", probability=0.05, kinds=("delay",),
                  delay_s=0.02))
    chaos = ts.run_scenario("chaos-seed-42", "cpu", fault_plan=plan)
    for arm in (clean, chaos):
        assert arm["scrape_errors"] == 0
        assert len(arm["stitched_components"]) >= 3
        assert arm["attainment"]["standard"]["attainment"] == 1.0
        assert arm["attainment"]["latency"]["attainment"] == 0.0
    # delay-only faults change no counter
    assert clean["tokens"] == chaos["tokens"] and \
        clean["ok_requests"] == chaos["ok_requests"]


def test_profile_gate_deterministic_checks(drives, cpu_threads,
                                           monkeypatch):
    from instaslice_tpu_torch.analysis import profile_smoke as ps
    from instaslice_tpu_torch.analysis.drive import tiny_engine
    from instaslice_tpu_torch.obs.profiler import Profiler, reset_profiler
    from instaslice_tpu_torch.serving.api_server import ApiServer

    monkeypatch.setenv("TPUSLICE_COMPILE_GRACE", "0.5")
    eng = tiny_engine("cpu", d_model=64, d_ff=128, max_batch=8)
    eng.warm_prefill_buckets()
    prof = Profiler(armed=False)
    reset_profiler(prof)
    small = dict(ps.LOADGEN, requests=8, concurrency=4)
    try:
        with ApiServer(eng, block_size=8, request_timeout=60) as srv:
            assert srv.scheduler.profiler is prof
            ps.run_arm(srv.url, 7, small)
            ps.quiesce(srv.scheduler)
            threading.Event().wait(0.8)
            off = ps.unprofiled_arm(srv, prof, 8, small)
            on = ps.profiled_arm(srv, prof, 20, small)
            again = ps.profiled_arm(srv, prof, 21, small)
            out = ps.exports(srv, prof)
            assert off["tok_s"] > 0 and on["rounds"] > 0
            assert out["rounds_recorded"] == on["rounds"] + again["rounds"]
            assert out["waterfall_outcome"]
            # the control: a graph form counted mid-arm is refused (the
            # scheduler's compile watch journals it, or the arm's own
            # before/after reading sees it)
            real = eng.compiled_programs
            calls = []

            def grows():
                calls.append(1)
                got = dict(real())
                if len(calls) > 1:
                    got["decode_block"] = got.get("decode_block", 0) + 1
                return got

            monkeypatch.setattr(eng, "compiled_programs", grows)
            with pytest.raises(AssertionError,
                               match="CompileObserved|compiled programs"):
                ps.profiled_arm(srv, prof, 22, small)
    finally:
        reset_profiler()


def test_chrome_trace_control():
    from instaslice_tpu_torch.analysis.profile_smoke import (
        validate_chrome_trace,
    )

    lane = [{"ph": "X", "pid": 1, "tid": 0, "ts": 0, "dur": 5,
             "name": "round/decode"},
            {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 2,
             "name": "dispatch", "cat": "segment"}]
    validate_chrome_trace({"traceEvents": lane})
    with pytest.raises(AssertionError, match="dispatch"):
        validate_chrome_trace({"traceEvents": lane[:1] + [
            dict(lane[1], name="admit")]})


# ------------------------------------------------------ cross-validation

@pytest.mark.parametrize("package", ["reference", "port"])
def test_trace_files_pass_both_validators(drives, package):
    path = drives()[(package, "trace")]
    for mod in (ref_trace, port_trace):
        rep = mod.validate(path)
        mod.check_propagation(rep)
        assert rep["errors"] == [] and rep["spans"] > 0, mod.__name__


@pytest.mark.parametrize("package", ["reference", "port"])
def test_event_files_pass_both_validators(drives, package):
    path = drives()[(package, "events")]
    for mod in (ref_events, port_events):
        for strict in (True, False):
            rep = mod.validate(path, strict=strict)
            assert rep["errors"] == [] and rep["events"] > 0, mod.__name__
        assert rep["reasons"].get("SliceFailed") == 1


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _write(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _span_negative(spans):
    spans[0]["durationMs"] = -1.0


def _span_orphan(spans):
    child = next(s for s in spans if s.get("parentId"))
    child["parentId"] = "0" * 16


def _span_duplicate(spans):
    spans.append(dict(spans[0]))


SPAN_CORRUPTIONS = {
    "negative_duration": (_span_negative, r"negative duration"),
    "orphan_parent": (_span_orphan, r"orphan span"),
    "duplicate_span_id": (_span_duplicate, r"duplicate spanId"),
}


@pytest.mark.parametrize("kind", sorted(SPAN_CORRUPTIONS))
def test_seeded_trace_corruption_same_verdict(drives, kind, tmp_path):
    spans = _lines(drives()[("port", "trace")])
    corrupt, cls = SPAN_CORRUPTIONS[kind]
    corrupt(spans)
    bad = str(tmp_path / "bad.jsonl")
    _write(bad, spans)
    classes = []
    for mod in (ref_trace, port_trace):
        errors = mod.validate(bad)["errors"]
        assert errors and all(re.search(cls, e) for e in errors), errors
        classes.append(sorted(re.sub(r"'[^']*'|-?\d+(\.\d+)?", "_", e)
                              for e in errors))
    assert classes[0] == classes[1]


def _transition(events, reason):
    return next(e for e in events if e["reason"] == reason
                and e.get("objectRef", "").startswith("alloc/"))


def _event_unknown(events):
    events[0]["reason"] = "NotAReason"


def _event_out_of_order(events):
    created = _transition(events, "SliceCreated")
    ungated = next(e for e in events if e["reason"] == "SliceUngated"
                   and e["objectRef"] == created["objectRef"])
    created["seq"], ungated["seq"] = ungated["seq"], created["seq"]


def _event_no_trace(events):
    _transition(events, "SliceCreated").pop("traceId", None)


EVENT_CORRUPTIONS = {
    "unknown_reason": (_event_unknown, r"unknown reason"),
    "chain_out_of_order": (_event_out_of_order,
                           r"illegal transition|complete "
                           r"creating->created->ungated"),
    "missing_trace_id": (_event_no_trace, r"without a traceId"),
}


@pytest.mark.parametrize("kind", sorted(EVENT_CORRUPTIONS))
def test_seeded_event_corruption_same_verdict(drives, kind, tmp_path):
    events = _lines(drives()[("port", "events")])
    corrupt, cls = EVENT_CORRUPTIONS[kind]
    corrupt(events)
    bad = str(tmp_path / "bad.jsonl")
    _write(bad, events)
    classes = []
    for mod in (ref_events, port_events):
        errors = mod.validate(bad)["errors"]
        assert errors and all(re.search(cls, e) for e in errors), errors
        classes.append(sorted(
            re.sub(r"'[^']*'|\[.*\]|\d+|instaslice_tpu\S*", "_", e)
            for e in errors))
    assert classes[0] == classes[1]


def _split_by_component(spans):
    """The port's drive's spans as the processes of a deployment would
    write them: the control plane's, the node agent's, the server's."""
    parts = {"control": [], "agent": [], "serve": []}
    for s in spans:
        name = s["name"]
        part = ("agent" if name.startswith(("agent.", "device."))
                else "serve" if name.startswith(("serve.", "engine.",
                                                 "scheduler."))
                else "control")
        parts[part].append(s)
    return parts


def test_fleet_over_split_files(drives, tmp_path):
    """``--fleet`` over files split by process: the merged store has no
    orphan; an orphan seeded into one file is refused by the merged view
    (and the per-file view alone would not tell them apart)."""
    spans = _lines(drives()[("port", "trace")])
    paths = []
    for name, part in _split_by_component(spans).items():
        assert part, name
        paths.append(str(tmp_path / f"{name}.jsonl"))
        _write(paths[-1], part)
    assert port_trace.main(["--fleet", *paths]) == 0
    fleet = port_trace.check_fleet(paths)
    assert fleet["orphans"] == 0 and fleet["spans_ingested"] == len(spans)
    assert fleet == ref_trace.check_fleet(paths)
    # one grant's trace crosses the control plane's file and the agent's
    by_file = [{s.get("traceId") for s in _lines(p)} for p in paths[:2]]
    assert by_file[0] & by_file[1]
    # the control: one orphan parent in a copy of one file
    bad = _lines(paths[2])
    next(s for s in bad if s.get("parentId"))["parentId"] = "f" * 16
    _write(paths[2], bad)
    assert port_trace.main(["--fleet", *paths]) == 1
    assert port_trace.check_fleet(paths)["orphans"] == 1


def test_event_chains_over_split_journals(drives, tmp_path):
    """The controller's and the node agent's journals each hold part of a
    grant's chain: each file passes :func:`read_events` alone, and the
    chains of the merged events (by time) pass strictly; a chain cut in
    two is refused by the whole-file check."""
    events = _lines(drives()[("port", "events")])
    agent = [e for e in events if e["reason"] in (
        "SliceCreated", "SliceDeleted", "SliceRealized", "SliceTornDown",
        "SliceRealizeFailed")]
    rest = [e for e in events if e not in agent]
    paths = [str(tmp_path / "agent.jsonl"), str(tmp_path / "rest.jsonl")]
    _write(paths[0], agent)
    _write(paths[1], rest)
    merged = []
    for p in paths:
        got, errors = port_events.read_events(p)
        assert errors == []
        merged += got
    merged.sort(key=lambda e: (e["ts"], e["seq"]))
    merged = [dict(e, seq=n) for n, e in enumerate(merged, 1)]
    assert port_events.check_chains(merged, strict=True) == []
    assert port_events.validate(paths[1])["errors"]
