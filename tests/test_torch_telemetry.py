"""The port's fleet telemetry plane (``instaslice_tpu_torch/obs/telemetry.py``)
against the reference's (``instaslice_tpu/obs/telemetry.py``).

- The exposition parsers, ``span_component``, the trace stitcher, the
  chip-hours ledger and the burn-rate monitor: both packages' functions on
  the same seeded inputs give equal outputs, the cases of the reference's
  ``tests/test_telemetry.py`` included; the control is a monitor whose
  pair needs one window alone, which fires where the reference's does not.
- The fleet script of ``tools/telemetry_smoke.py`` on the port: two tiny
  fp32 port servers behind the port's router, the port's loadgen through
  clean, burn, burn and heal traffic on a pinned clock, the reference's
  aggregator and the port's polling the same fleet at the same instants:
  they agree with each other and with the client reports, and each burn
  transition is journaled once; the control drops one replica's scrape.
- The demand-to-supply link on the port's ``SimCluster`` (one H100 80GB,
  MIG on): a capacity-blocked ``1g.10gb`` pod carrying the caused-by
  annotation stitches router, serve and controller into one timeline, and
  chip-seconds are the memory slots times the seconds of the sim's events.
- The port's ``TelemetryServer`` against the reference's route by route,
  both ``fleet`` CLIs against the port's server, and the
  ``tpuslice-gpu-telemetry`` script as a process.
"""

import contextlib
import io
import json
import signal
import subprocess
import sys
import time
import tomllib
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from instaslice_tpu.cli import tpuslicectl as rctl
from instaslice_tpu.metrics.metrics import FleetMetrics as RefFleetMetrics
from instaslice_tpu.obs import journal as rj
from instaslice_tpu.obs import telemetry as rt
from instaslice_tpu_torch.api import constants as pc
from instaslice_tpu_torch.cli import tpuslicectl as pctl
from instaslice_tpu_torch.metrics.metrics import FleetMetrics
from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM, init_params
from instaslice_tpu_torch.obs import journal as pj
from instaslice_tpu_torch.obs import telemetry as pt
from instaslice_tpu_torch.serving import ServingEngine, loadgen
from instaslice_tpu_torch.serving.api_server import ApiServer
from instaslice_tpu_torch.serving.router import Router
from instaslice_tpu_torch.sim import SimCluster
from instaslice_tpu_torch.topology import mig
from instaslice_tpu_torch.utils import trace as ptrace
from torch_port_util import REPO

#: the reference test's exposition: counters, the _created companion, an
#: ``slo`` filter, a garbage line and an escaped label value
EXPOSITION = """\
# HELP tpuslice_serve_requests_total served requests
# TYPE tpuslice_serve_requests_total counter
tpuslice_serve_requests_total{outcome="ok"} 7.0
tpuslice_serve_requests_total{outcome="shed"} 2.0
tpuslice_serve_tokens_total 321.0
tpuslice_serve_tokens_created 1.7e9
tpuslice_serve_class_ttft_seconds_count{tenant_class="latency"} 4.0
tpuslice_serve_class_ttft_seconds_count{tenant_class="standard"} 3.0
tpuslice_serve_slo_missed_total{slo="ttft",tenant_class="latency"} 1.0
tpuslice_serve_slo_missed_total{slo="tpot",tenant_class="latency"} 9.0
garbage line that must be skipped
tpuslice_weird{label="quo\\"te"} 1.0
"""

NAMES = ("tpuslice_serve_requests_total", "tpuslice_serve_tokens_total",
         "tpuslice_serve_tokens_created",
         "tpuslice_serve_class_ttft_seconds_count",
         "tpuslice_serve_slo_missed_total", "tpuslice_weird")
CLASSES = ("latency", "standard", "best-effort")


def _escape(v):
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _exposition(rng) -> str:
    """A seeded exposition text: every series kind the federation sums,
    labels in any order, escaped values, timestamps, garbage lines."""
    lines = ["# HELP x y", "# TYPE x counter"]
    for _ in range(60):
        name = NAMES[rng.integers(len(NAMES))]
        labels = {}
        if rng.random() < 0.7:
            labels["tenant_class"] = CLASSES[rng.integers(3)]
        if rng.random() < 0.5:
            labels["outcome"] = ("ok", "shed", "migrated")[rng.integers(3)]
        if rng.random() < 0.4:
            labels["slo"] = ("ttft", "tpot")[rng.integers(2)]
        if rng.random() < 0.15:
            labels["note"] = 'a"b\\c\nd'[: 1 + rng.integers(7)]
        keys = list(labels)
        rng.shuffle(keys)
        body = ",".join(f'{k}="{_escape(labels[k])}"' for k in keys)
        val = ("%.6g" % (rng.integers(0, 10 ** 6) / 8.0)
               if rng.random() < 0.8 else "NaN")
        stamp = f" {rng.integers(1, 10 ** 12)}" if rng.random() < 0.1 else ""
        lines.append(f"{name}{{{body}}} {val}{stamp}" if body
                     else f"{name} {val}{stamp}")
        if rng.random() < 0.05:
            lines.append("not a sample {")
    return "\n".join(lines) + "\n"


def _queries(mod, samples):
    """Every rollup the aggregator reads of one exposition."""
    out = {}
    for name in NAMES:
        out[name] = mod.metric_sum(samples, name)
        for cls in CLASSES:
            out[name, cls] = mod.metric_sum(samples, name, tenant_class=cls)
        for label in ("tenant_class", "outcome", "slo", "note"):
            out[name, label] = mod.metric_by_label(samples, name, label)
            out[name, label, "ttft"] = mod.metric_by_label(
                samples, name, label, slo="ttft")
    return out


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_exposition_parsers_equal_the_reference(seed):
    text = EXPOSITION if seed is None else _exposition(
        np.random.default_rng(seed))
    got, want = pt.parse_exposition(text), rt.parse_exposition(text)
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] or (got[k] != got[k] and want[k] != want[k])
               for k in got)
    assert repr(_queries(pt, got)) == repr(_queries(rt, want))
    if seed is None:
        # the reference test's readings
        assert pt.metric_sum(got, "tpuslice_serve_requests_total") == 9.0
        assert pt.metric_sum(got, "tpuslice_serve_tokens") == 0.0
        assert pt.metric_by_label(
            got, "tpuslice_serve_slo_missed_total", "tenant_class",
            slo="ttft") == {"latency": 1.0}
        assert ("tpuslice_weird", frozenset({("label", 'quo"te')})) in got


def test_merge_profile_summaries_equals_the_reference():
    rng = np.random.default_rng(3)
    summaries = []
    for _ in range(5):
        summaries.append({
            seg: {"count": int(rng.integers(0, 9)),
                  "p50Ms": float(rng.random()), "p95Ms": float(rng.random()),
                  "maxMs": float(rng.random()) if rng.random() < 0.8
                  else None}
            for seg in ("round", "prefill", "decode")[: rng.integers(4)]})
    summaries.append(None)
    assert pt.merge_profile_summaries(summaries) == \
        rt.merge_profile_summaries(summaries)


@pytest.mark.parametrize("name", [
    "controller.allocate", "repacker.migrate", "device.reserve",
    "agent.realize", "engine.decode", "engine.prefill", "serve.request",
    "router.route", "telemetry.scrape", "kube.request", "nodot", "",
    "engine", ".x"])
def test_span_component_equals_the_reference(name):
    assert pt.span_component(name) == rt.span_component(name)


def _span(rng, tid, sid, parent=""):
    s = {"name": ("router.route", "serve.request", "engine.decode",
                  "controller.allocate", "device.reserve")[rng.integers(5)],
         "traceId": tid, "spanId": sid, "start": float(rng.integers(100)),
         "durationMs": 1.0}
    if parent:
        s["parentId"] = parent
    if rng.random() < 0.2:
        s["attrs"] = {"caused_by": f"t{rng.integers(4)}"}
    return s


def _stitch_script(rng, tmp_path):
    """A seeded sequence of stitcher operations: spans arriving twice (a
    debug payload and a file), parents missing or in another file, ids
    missing, caused-by stamps on spans and events, a garbage file and a
    missing one."""
    ops = []
    files = []
    for f in range(3):
        lines = []
        for i in range(12):
            tid = f"t{rng.integers(4)}"
            parent = f"s{rng.integers(30)}" if rng.random() < 0.6 else ""
            sp = _span(rng, tid, f"s{rng.integers(30)}", parent)
            if rng.random() < 0.1:
                sp.pop("spanId")
            lines.append(json.dumps(sp))
            if rng.random() < 0.3:
                ops.append(("debug", {("recent", "slowest", "spans")[
                    rng.integers(3)]: [sp]}))
        if f == 1:
            lines.insert(3, "not json")
        path = tmp_path / f"trace{f}.jsonl"
        path.write_text("\n".join(lines) + "\n")
        files.append(str(path))
        ops.append(("file", str(path)))
        ops.append(("event", {"reason": "Admitted",
                              "traceId": f"g{rng.integers(3)}",
                              "attrs": {"caused_by": f"t{rng.integers(4)}"}}))
    ops.append(("file", str(tmp_path / "missing.jsonl")))
    ops.append(("event", {"traceId": "g9"}))
    return ops


def _run_stitcher(mod, ops):
    st = mod.TraceStitcher()
    counts = []
    for kind, arg in ops:
        if kind == "debug":
            counts.append(st.ingest_debug_payload(arg))
        elif kind == "file":
            counts.append(st.ingest_file(arg))
        else:
            st.add_event(arg)
    tids = sorted(st.trace_ids())
    probes = tids + ["g0", "g1", "g2", "absent"]
    return {
        "counts": counts, "traces": tids,
        "spans": {t: st.spans(t) for t in probes},
        "links": {t: st.links_into(t) for t in probes},
        "caused_by": {t: st.caused_by(t) for t in probes},
        "components": {t: st.components(t) for t in probes},
        "timeline": {t: st.timeline(t) for t in probes},
        "orphans": sorted(json.dumps(s, sort_keys=True)
                          for s in st.orphans()),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_stitcher_equals_the_reference(seed, tmp_path):
    ops = _stitch_script(np.random.default_rng(seed), tmp_path)
    got, want = _run_stitcher(pt, ops), _run_stitcher(rt, ops)
    assert got == want
    assert got["orphans"] and any(got["links"].values())


def test_stitcher_reference_cases_on_the_port(tmp_path):
    """``tests/test_telemetry.py``'s stitcher cases, on the port."""
    st = pt.TraceStitcher()
    span = {"name": "serve.request", "traceId": "t", "spanId": "a",
            "start": 1.0}
    st.add_span(span)
    assert st.ingest_debug_payload({"recent": [dict(span)]}) == 1
    assert len(st.spans("t")) == 1
    st.add_span({"name": "router.route", "traceId": "t", "spanId": "r",
                 "start": 0.0})
    st.add_span({"name": "controller.allocate", "traceId": "g",
                 "spanId": "c", "start": 2.0, "attrs": {"caused_by": "t"}})
    st.add_event({"reason": pc.REASON_ADMITTED, "traceId": "g2",
                  "attrs": {"caused_by": "t"}})
    tl = st.timeline("t")
    assert tl["spanCount"] == 3
    assert tl["components"] == ["controller", "router", "serve"]
    assert [x["traceId"] for x in tl["linked"]] == ["g", "g2"]
    assert [s["spanId"] for s in tl["spans"]] == ["r", "a"]
    child = {"name": "a.b", "traceId": "o", "spanId": "c", "parentId": "p",
             "start": 1.0}
    f1, f2, bad = (tmp_path / n for n in ("one.jsonl", "two.jsonl",
                                          "bad.jsonl"))
    f1.write_text(json.dumps(child) + "\n")
    assert st.ingest_file(str(f1)) == 1 and len(st.orphans()) == 1
    f2.write_text(json.dumps({"name": "a.root", "traceId": "o",
                              "spanId": "p", "start": 0.0}) + "\n")
    st.ingest_file(str(f2))
    assert st.orphans() == []
    bad.write_text('not json\n{"name": "x.y", "traceId": "t", '
                   '"spanId": "s", "start": 1}\n')
    assert st.ingest_file(str(bad)) == 1
    assert st.ingest_file(str(tmp_path / "missing.jsonl")) == 0
    # a line that parses but is no object raises in both (telemetry.py
    # catches JSONDecodeError and TypeError only)
    bad.write_text("[1, 2]\n")
    for mod in (pt, rt):
        with pytest.raises(AttributeError):
            mod.TraceStitcher().ingest_file(str(bad))


def _alloc_events(rng, n=60):
    evs = []
    for i in range(n):
        ref = (f"alloc/a{rng.integers(8)}" if rng.random() < 0.85
               else f"pod/p{i}")
        reason = (pc.REASON_SLICE_UNGATED, pc.REASON_SLICE_DELETED,
                  pc.REASON_SLICE_FAILED, pc.REASON_SLICE_CREATED)[
            rng.integers(4)]
        ev = {"reason": reason, "objectRef": ref, "ts": float(i * 7)}
        roll = rng.random()
        if roll < 0.7:
            ev["attrs"] = {"chips": int(rng.integers(0, 9))}
        elif roll < 0.8:
            ev["attrs"] = {"chips": "junk"}
        evs.append(ev)
    return evs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chip_hours_equal_the_reference(seed):
    evs = _alloc_events(np.random.default_rng(seed))
    sides = [mod.ChipHoursAccountant(clock=lambda: 1000.0)
             for mod in (pt, rt)]
    for ev in evs:
        readings = []
        for acc in sides:
            acc.add_event(ev)
            readings.append((acc.chip_seconds(), acc.chip_seconds(ev["ts"]),
                             acc.chips_live()))
        assert readings[0] == readings[1]
    assert sides[0].chip_seconds() > 0


def test_chip_hours_reference_cases_on_the_port():
    ch = pt.ChipHoursAccountant(clock=lambda: 100.0)
    ch.add_event({"reason": pc.REASON_SLICE_UNGATED, "objectRef": "alloc/a",
                  "ts": 10.0, "attrs": {"chips": 4}})
    ch.add_event({"reason": pc.REASON_SLICE_UNGATED, "objectRef": "alloc/b",
                  "ts": 20.0, "attrs": {"chips": 8}})
    assert ch.chips_live() == 12
    assert ch.chip_seconds(30.0) == pytest.approx(4 * 20 + 8 * 10)
    ch.add_event({"reason": pc.REASON_SLICE_DELETED, "objectRef": "alloc/a",
                  "ts": 30.0})
    assert ch.chip_seconds(40.0) == pytest.approx(80 + 8 * 20)


def _burn_run(mod, jmod, script, windows, target=0.9):
    """Drive one monitor through ``script`` (clock steps and cumulative
    (class, missed, served) samples), evaluating after each step. Returns
    every evaluation and the journal's events."""
    clk = [1000.0]
    j = jmod.Journal(clock=lambda: clk[0])
    mon = mod.BurnRateMonitor(target=target, windows=windows,
                              clock=lambda: clk[0], journal=j)
    outs = []
    for step, samples in script:
        clk[0] += step
        for cls, missed, served in samples:
            mon.observe(cls, missed, served)
        outs.append(mon.evaluate())
    return outs, [e.to_dict() for e in j.events()], mon.burning()


def _burn_script(rng, n=40):
    cum = {c: [0, 0] for c in CLASSES}
    script = []
    for _ in range(n):
        samples = []
        for cls in CLASSES[: 1 + rng.integers(3)]:
            served = int(rng.integers(0, 50))
            missed = int(rng.integers(0, served + 1)) \
                if rng.random() < 0.4 else 0
            cum[cls][0] += missed
            cum[cls][1] += served
            samples.append((cls, *cum[cls]))
        script.append((float(rng.choice([1.0, 5.0, 30.0, 300.0, 3600.0])),
                       samples))
    return script


BURN_WINDOWS = ((10.0, 60.0, 2.0), (60.0, 600.0, 1.5))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_burn_monitor_equals_the_reference(seed):
    script = _burn_script(np.random.default_rng(seed))
    got = _burn_run(pt, pj, script, BURN_WINDOWS)
    want = _burn_run(rt, rj, script, BURN_WINDOWS)
    assert got == want
    reasons = [e["reason"] for e in got[1]]
    assert pc.REASON_SLO_BURN_HIGH in reasons


#: the reference test's scenarios: (script, windows) whose burn state the
#: reference reads as (fires then clears), (never), (never: the short
#: window burns, the long one does not)
BURN_CASES = {
    "fire_needs_both_windows_and_clear": (
        [(0.0, [("latency", 0, 100)]), (30.0, [("latency", 30, 200)]),
         (30.0, [("latency", 30, 300)]), (30.0, [("latency", 30, 400)])],
        ((10.0, 60.0, 2.0),)),
    "single_sample_cannot_fire": (
        [(0.0, [("latency", 50, 50)])], ((10.0, 60.0, 2.0),)),
    "short_window_alone_does_not_fire": (
        [(0.0, [("latency", 0, 1000)]), (990.0, [("latency", 0, 2000)]),
         (10.0, [("latency", 30, 2100)])], ((10.0, 1000.0, 2.0),)),
}


@pytest.mark.parametrize("case", sorted(BURN_CASES))
def test_burn_monitor_reference_cases(case):
    script, windows = BURN_CASES[case]
    got = _burn_run(pt, pj, script, windows)
    assert got == _burn_run(rt, rj, script, windows)
    reasons = [e["reason"] for e in got[1]]
    if case.startswith("fire"):
        assert [o["latency"]["burning"] for o in got[0]] == [
            False, True, False, False]
        assert got[0][1]["latency"]["fired"] == ["10s/1m"]
        assert reasons == [pc.REASON_SLO_BURN_HIGH,
                           pc.REASON_SLO_BURN_CLEARED]
    else:
        assert reasons == []
    if case.startswith("short"):
        rates = got[0][-1]["latency"]["rates"]
        assert rates["10s"] >= 2.0 > rates["1000s"]
    with pytest.raises(ValueError):
        pt.BurnRateMonitor(target=1.0)


def test_control_a_pair_needing_one_window_alone_fires():
    """The control: the same short burst on a monitor whose pair reads
    its short window alone (the long window cut to the short one) fires,
    where the reference's pair stays quiet."""
    script, windows = BURN_CASES["short_window_alone_does_not_fire"]
    one = ((windows[0][0], windows[0][0], windows[0][2]),)
    got = _burn_run(pt, pj, script, one)
    want = _burn_run(rt, rj, script, windows)
    assert got[2] == {"latency": True} and want[2] == {"latency": False}
    assert [e["reason"] for e in got[1]] == [pc.REASON_SLO_BURN_HIGH]


# ----------------------------------------------------------- fleet script

#: one tenant per class, so per-class (server) and per-tenant (client)
#: attainment are one number: the steady tenant's 30 s TTFT cannot miss
#: and the edge tenant's 0.1 ms cannot be met
TENANTS = "steady:1:standard:30,edge:1:latency:0.0001"
CFG = ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                  dtype=torch.float32, remat=False)


@pytest.fixture(scope="module")
def fleet():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    params = init_params(CFG, 0, device="cpu")
    servers = [
        ApiServer(ServingEngine(TpuLM(CFG), params, device="cpu",
                                max_batch=4, max_len=64, prefill_len=8),
                  block_size=4, tenants=TENANTS).start()
        for _ in range(2)]
    # eject_factor=0: no gray-failure sweep. Under a loaded host one
    # replica answers its polls slowly and the sweep would drain it with
    # migration, which counts its stream twice (ok and migrated)
    router = Router(tuple(s.url for s in servers), poll_interval=0.1,
                    eject_factor=0).start()
    try:
        for url in [router.url] + [s.url for s in servers]:
            _wait_ready(url)
        yield router, servers
    finally:
        router.stop()
        for s in servers:
            s.stop()
        torch.set_num_threads(n)


def _wait_ready(url, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url + "/readyz", timeout=2) as r:
                if r.status == 200:
                    return
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"{url} never became ready")


def _load(url, tenant, n):
    rep = loadgen.run(url, n, 2, 4, 6, CFG.vocab_size, True, 60.0,
                      tenants=tenant)
    assert rep["ok"] == n and rep["outcomes"]["hung"] == 0
    assert rep["outcomes"]["hedged-ok"] == 0
    return rep


def _own_tokens(servers):
    out = []
    for s in servers:
        with urllib.request.urlopen(s.url + "/metrics", timeout=10) as r:
            out.append(pt.metric_sum(pt.parse_exposition(r.read().decode()),
                                     "tpuslice_serve_tokens_total"))
    return out


#: the rollup keys both aggregators must agree on (``traces`` counts the
#: spans each side's own polls add to the port's in-process tracer)
AGREE = ("ts", "polls", "replicas", "requests", "ok_requests", "tokens",
         "goodput_tokens_per_sec", "attainment", "slo_target", "burn", "kv",
         "chip_hours", "scrapes", "profile")


def test_fleet_script_both_aggregators_agree_with_the_clients(fleet):
    router, servers = fleet
    clk = [time.time()]
    aggs = {
        "port": pt.FleetAggregator(
            router_url=router.url, metrics=FleetMetrics(),
            journal=pj.Journal(clock=lambda: clk[0]), clock=lambda: clk[0]),
        "reference": rt.FleetAggregator(
            router_url=router.url, metrics=RefFleetMetrics(),
            journal=rj.Journal(clock=lambda: clk[0]), clock=lambda: clk[0]),
    }
    control = pt.FleetAggregator(
        replica_urls=(servers[0].url,), metrics=FleetMetrics(),
        journal=pj.Journal(), clock=lambda: clk[0])
    journal = pj.get_journal()
    base = journal.counts()

    def poll(step):
        clk[0] += step
        got = {k: a.poll() for k, a in aggs.items()}
        assert {k: got["port"][k] for k in AGREE} == \
            {k: got["reference"][k] for k in AGREE}
        return got["port"]

    start = poll(0.0)
    tokens0, ok0 = start["tokens"], start["ok_requests"]
    own0 = _own_tokens(servers)
    c0 = control.poll()["tokens"]
    # clean: attainment exactly 1.0
    clean = _load(router.url, "steady:1:standard:30", 8)
    fleet = poll(5.0)
    assert fleet["tokens"] - tokens0 == clean["client_tokens"]
    assert fleet["ok_requests"] - ok0 == clean["ok"]
    assert fleet["attainment"]["standard"]["attainment"] == 1.0 == \
        clean["tenants"]["steady"]["slo_attainment"]
    assert not fleet["burn"]["standard"]["burning"]
    # burn, in two bursts (the monitor needs a miss delta): exactly 0.0
    b1 = _load(router.url, "edge:1:latency:0.0001", 4)
    fleet = poll(60.0)
    assert fleet["tokens"] - tokens0 == clean["client_tokens"] + \
        b1["client_tokens"]
    assert fleet["attainment"]["latency"]["attainment"] == 0.0 == \
        b1["tenants"]["edge"]["slo_attainment"]
    b2 = _load(router.url, "edge:1:latency:0.0001", 4)
    fleet = poll(60.0)
    burned = b1["ok"] + b2["ok"]
    assert fleet["ok_requests"] - ok0 == clean["ok"] + burned
    missed0 = start["attainment"].get("latency", {}).get("missed", 0)
    assert fleet["attainment"]["latency"]["missed"] - missed0 == burned == \
        journal.counts()[pc.REASON_SLO_MISSED] - \
        base.get(pc.REASON_SLO_MISSED, 0)
    assert fleet["burn"]["latency"]["burning"]
    # heal: past every window with no new miss
    fleet = poll(7 * 3600.0)
    assert not fleet["burn"]["latency"]["burning"]
    for name, agg in aggs.items():
        counts = agg._journal.counts()
        assert counts[pc.REASON_SLO_BURN_HIGH] == 1, name
        assert counts[pc.REASON_SLO_BURN_CLEARED] == 1, name
    assert fleet["scrapes"]["error"] == 0
    # every client token is some replica's, and both replicas served
    client = clean["client_tokens"] + b1["client_tokens"] + \
        b2["client_tokens"]
    own = [b - a for a, b in zip(own0, _own_tokens(servers))]
    assert min(own) > 0 and sum(own) == client == fleet["tokens"] - tokens0
    # the control: one replica's scrape dropped misses the client's tokens
    missed_control = control.poll()["tokens"] - c0
    assert missed_control == own[0] != client


# ----------------------------------------------- demand to supply, the sim

def _isolated():
    """A fresh process-wide journal and tracer for one sim test (the
    chip-hours and stitching read everything they hold); the old ones
    come back after."""
    old = pj.get_journal(), ptrace.get_tracer()
    pj.reset_journal(pj.Journal())
    ptrace.reset_tracer(ptrace.Tracer())
    return old


def _restore(old):
    pj.reset_journal(old[0])
    ptrace.reset_tracer(old[1])


def test_capacity_blocked_grant_stitches_router_serve_controller():
    old = _isolated()
    try:
        tid = ptrace.new_trace_id()
        tracer = ptrace.get_tracer()
        with tracer.span("router.route", trace_id=tid):
            with tracer.span("serve.request"):
                pass
        profiles = {"filler-a": "3g.40gb", "filler-b": "3g.40gb",
                    "blocked": "1g.10gb"}
        with SimCluster(n_nodes=1, generation=mig.H100_80GB,
                        gpus_per_node=1, mig=True,
                        deletion_grace_seconds=0.2) as c:
            c.submit("filler-a", "3g.40gb")
            c.submit("filler-b", "3g.40gb")
            assert c.wait_phase("filler-a", "Running", timeout=30)
            assert c.wait_phase("filler-b", "Running", timeout=30)
            c.submit("blocked", "1g.10gb",
                     annotations={pc.CAUSED_BY_ANNOTATION: tid})
            assert not c.wait_phase("blocked", "Running", timeout=1.0), \
                "the pod ran with the GPU full: not capacity-blocked"
            c.delete_pod("filler-a")
            assert c.wait_gone("filler-a", timeout=30)
            assert c.wait_phase("blocked", "Running", timeout=30)
        events = pj.debug_events_payload({"n": ["4000"]})["events"]
        st = pt.TraceStitcher()
        st.ingest_debug_payload(
            ptrace.debug_trace_payload({"n": ["4096"]}, tracer=tracer))
        for ev in events:
            st.add_event(ev)
    finally:
        _restore(old)
    grants = st.links_into(tid)
    assert grants, "no grant trace linked by caused-by"
    tl = st.timeline(tid)
    assert {"router", "serve", "controller"} <= set(tl["components"])
    alloc = [s for s in st.spans(grants[0])
             if s["name"] == "controller.allocate"]
    assert alloc and alloc[0]["attrs"]["caused_by"] == tid
    # chip-seconds: the memory slots of each grant times its seconds from
    # SliceUngated to SliceDeleted (or to now), from the sim's own events
    ungated = {e["objectRef"]: e for e in events
               if e["reason"] == pc.REASON_SLICE_UNGATED}
    ends = {e["objectRef"]: e["ts"] for e in events
            if e["reason"] in (pc.REASON_SLICE_DELETED,
                               pc.REASON_SLICE_FAILED)}
    slots = {p.name: p.memory_slices for p in mig.H100_80GB_PROFILES}
    assert sorted(int(e["attrs"]["chips"]) for e in ungated.values()) == \
        sorted(slots[p] for p in profiles.values())
    now = max(e["ts"] for e in events) + 1.0
    want = sum((ends.get(ref, now) - e["ts"]) * int(e["attrs"]["chips"])
               for ref, e in ungated.items())
    got = []
    for mod in (pt, rt):
        acc = mod.ChipHoursAccountant(clock=lambda: now)
        for ev in events:
            acc.add_event(ev)
        got.append(acc.chip_seconds())
    assert got[0] == got[1] == pytest.approx(want) and want > 0


def test_malformed_caused_by_is_dropped():
    bad = "zz;DROP TABLE|" + "x" * 80
    old = _isolated()
    try:
        with SimCluster(n_nodes=1, generation=mig.H100_80GB,
                        gpus_per_node=1, mig=True,
                        deletion_grace_seconds=0.2) as c:
            c.submit("sneaky", "1g.10gb",
                     annotations={pc.CAUSED_BY_ANNOTATION: bad})
            assert c.wait_phase("sneaky", "Running", timeout=30)
        st = pt.TraceStitcher()
        st.ingest_debug_payload(ptrace.debug_trace_payload(
            {"n": ["4096"]}, tracer=ptrace.get_tracer()))
        for ev in pj.debug_events_payload({"n": ["4000"]})["events"]:
            st.add_event(ev)
        admitted = pj.get_journal().events(reason=pc.REASON_ADMITTED)
    finally:
        _restore(old)
    assert admitted and st.links_into(bad) == []
    assert all("caused_by" not in e.attrs for e in admitted)


# ------------------------------------------------------- the HTTP plane

SPANS = [{"name": "serve.request", "traceId": "t", "spanId": "s",
          "start": 1.0, "durationMs": 2.0},
         {"name": "router.route", "traceId": "t", "spanId": "r",
          "start": 0.5, "durationMs": 0.1},
         {"name": "controller.allocate", "traceId": "g", "spanId": "c",
          "start": 3.0, "durationMs": 1.0, "attrs": {"caused_by": "t"}}]
EVENTS = [{"seq": 1, "ts": 10.0, "component": "allocation",
           "reason": "SliceUngated", "objectRef": "alloc/a",
           "attrs": {"chips": 4}},
          {"seq": 2, "ts": 60.0, "component": "allocation",
           "reason": "SliceDeleted", "objectRef": "alloc/a"}]

#: (path, whether both servers' bodies must be equal): the debug routes
#: read each package's own process-wide rings
ROUTES = (("/healthz", True), ("/readyz", True), ("/v1/fleet", True),
          ("/v1/fleet/trace", True), ("/v1/fleet/trace?trace_id=t", True),
          ("/v1/fleet/trace?trace_id=zzz", True), ("/metrics", False),
          ("/v1/debug/trace?n=5", False), ("/v1/debug/trace?n=0", False),
          ("/v1/debug/trace?trace_id=absent", False),
          ("/v1/debug/events?n=10", False),
          ("/v1/debug/events?n=junk", False),
          ("/v1/debug/profile", False), ("/v1/debug/profile?n=0", False),
          ("/nope", True))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture()
def planes(tmp_path):
    tf, ef = tmp_path / "trace.jsonl", tmp_path / "events.jsonl"
    tf.write_text("".join(json.dumps(s) + "\n" for s in SPANS))
    ef.write_text("".join(json.dumps(e) + "\n" for e in EVENTS))
    clk = [100.0]
    out = {}
    for name, mod, metrics, jmod in (
            ("port", pt, FleetMetrics, pj),
            ("reference", rt, RefFleetMetrics, rj)):
        agg = mod.FleetAggregator(
            trace_files=(str(tf),), event_files=(str(ef),),
            metrics=metrics(), journal=jmod.Journal(),
            clock=lambda: clk[0])
        out[name] = (agg, mod.TelemetryServer(agg).start())
    try:
        yield out
    finally:
        for _, srv in out.values():
            srv.stop()


def test_telemetry_server_routes_equal_the_reference(planes):
    before = {k: _get(srv.url + "/readyz")[0]
              for k, (_, srv) in planes.items()}
    assert before == {"port": 503, "reference": 503}
    for agg, _ in planes.values():
        agg.poll()
    for path, same_body in ROUTES:
        got = {k: _get(srv.url + path) for k, (_, srv) in planes.items()}
        assert got["port"][0] == got["reference"][0], path
        if same_body:
            assert got["port"] == got["reference"], path
    codes = {path: _get(planes["port"][1].url + path)[0]
             for path, _ in ROUTES}
    assert codes["/v1/fleet/trace"] == 400
    assert codes["/v1/fleet/trace?trace_id=zzz"] == 404
    assert codes["/v1/debug/trace?n=0"] == 400
    assert codes["/v1/debug/trace?trace_id=absent"] == 404
    assert codes["/nope"] == 404
    fleet = json.loads(_get(planes["port"][1].url + "/v1/fleet")[1])
    assert fleet["chip_hours"]["chip_seconds"] == 200.0
    samples = pt.parse_exposition(_get(planes["port"][1].url + "/metrics")[1])
    assert samples[("tpuslice_fleet_chip_seconds_total", frozenset())] == \
        200.0


def _ctl(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = mod.main(argv)
    return code, buf.getvalue()


@pytest.mark.parametrize("args", [[], ["--trace", "t"], ["--trace", "zzz"]])
def test_both_fleet_clis_print_the_same_against_the_port(planes, args):
    agg, srv = planes["port"]
    agg.poll()
    got = _ctl(pctl, ["fleet", "--url", srv.url, *args])
    assert got == _ctl(rctl, ["fleet", "--url", srv.url, *args])
    if args != ["--trace", "zzz"]:
        assert got[0] == 0
        out = json.loads(got[1])
        if args:
            assert out["spanCount"] == 3
        else:
            assert out == agg.fleet()
    else:
        assert got[0] == 1 and "404" in json.loads(got[1])["error"]


def _script_argv(name, *args):
    """The command line of a console script of ``pyproject.toml``."""
    with open(REPO / "pyproject.toml", "rb") as f:
        target = tomllib.load(f)["project"]["scripts"][name]
    mod, fn = target.split(":")
    return [sys.executable, "-c",
            f"import sys; from {mod} import {fn}; "
            f"sys.exit({fn}(sys.argv[1:]))", *args]


def test_telemetry_script_runs(tmp_path):
    import re

    tf = tmp_path / "trace.jsonl"
    tf.write_text("".join(json.dumps(s) + "\n" for s in SPANS))
    proc = subprocess.Popen(
        _script_argv("tpuslice-gpu-telemetry", "--host", "127.0.0.1",
                     "--port", "0", "--trace-file", str(tf),
                     "--interval", "0.2"),
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        url = None
        deadline = time.monotonic() + 60
        while url is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            m = re.search(r"aggregator on (http://\S+)", line)
            url = m.group(1) if m else None
        assert url, "the aggregator never said where it listens"
        _wait_ready(url)
        code, body = _get(url + "/v1/fleet/trace?trace_id=t")
        assert code == 200 and json.loads(body)["spanCount"] == 3
        assert json.loads(_get(url + "/v1/fleet")[1])["polls"] >= 1
    finally:
        proc.send_signal(signal.SIGINT)
        rc_ = proc.wait(timeout=30)
        proc.stderr.close()
    assert rc_ == 0
