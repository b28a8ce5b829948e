"""The port's crash tier (``instaslice_tpu_torch/analysis/chaos_smoke.py``)
held against the reference's (``tests/test_crash_chaos.py``).

- **Units.** ``CrashPlan``'s grammar, nth call and re-arm give the
  reference's outcomes and ``stats()`` over one seeded script; the
  agent's orphan sweep on a MIG grid (an unclaimed ``sl-`` reservation
  adopted at first boot and reaped at the next, a foreign one adopted, a
  claimed one kept across a restart); the loadgen's ``stream-truncated``
  cases as the reference classifies them; the port's ``check_epochs``
  equal to ``tools/validate_events.check_epochs`` on the reference
  test's event lists.
- **The crash arms** (controller killed mid-fan-out, agent killed
  mid-realize) run on the reference's sim at v5e, on the port's sim at
  v5e (the reference's ``FakeTpuBackend`` through ``TpuShim``, two hosts
  of one torus as the reference's ``nodes_per_group=2``) and on the
  port's at ``h100-80gb``: each pod's final phase, the arm's reasons and
  its findings (overlaps, orphans, epochs) must be equal, and empty. The
  replica kill runs over the reference's server and router (the JAX
  engine) and over the port's: the same ledger findings, none.
- **The kill loop**, one case a site of ``KILL_SITES`` (the repacker's
  on a fragmented MIG grid), and the watchdogs (stuck grant, stuck
  migration, the stall warning re-armed).
- **Controls**, each a defence patched out that the check must miss:
  the orphan sweep returning nothing (the unclaimed reservation stays,
  ``no_orphans`` reports it) and the loadgen's truncation rule put back
  to ``transport-error`` (the classification departs from the
  reference's).

Under ``TPUSLICE_LOCKCHECK=1`` (``make gpu-chaos``) a lock-order cycle
seen by the port's detector fails the module.
"""

import os
import random
import sys

import pytest

from instaslice_tpu import faults as ref_faults
from instaslice_tpu.api.types import slice_uuid_for as ref_suid
from instaslice_tpu.device.fake import FakeTpuBackend
from instaslice_tpu.obs import journal as ref_journal
from instaslice_tpu.serving import loadgen as ref_loadgen
from instaslice_tpu.sim import SimCluster as RefSim
from instaslice_tpu.topology.placement import Box as RefBox
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.agent import discovery
from instaslice_tpu_torch.analysis import chaos_smoke as cs
from instaslice_tpu_torch.analysis import validate_events as tvalidate
from instaslice_tpu_torch.api.types import slice_uuid_for
from instaslice_tpu_torch.obs import journal as tjournal
from instaslice_tpu_torch.serving import loadgen
from instaslice_tpu_torch.sim import SimCluster
from instaslice_tpu_torch.topology.placement import Box
from test_torch_agent import TpuShim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import validate_events as ref_validate  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    for f, j in ((ref_faults, ref_journal), (tfaults, tjournal)):
        f.set_crash_plan(None)
        f.set_nemesis(None)
        j.reset_journal()
    yield
    for f, j in ((ref_faults, ref_journal), (tfaults, tjournal)):
        f.set_crash_plan(None)
        f.set_nemesis(None)
        j.reset_journal()


@pytest.fixture(autouse=True, scope="module")
def _lockcheck():
    """Under ``TPUSLICE_LOCKCHECK=1`` every named lock of the port records
    its acquisition order; a cycle seen over the module fails it."""
    from instaslice_tpu_torch.utils import lockcheck

    yield
    if lockcheck.armed():
        assert not lockcheck.report()["cycles"], lockcheck.report()


class V5eSim(SimCluster):
    """The port's ``SimCluster`` with the reference sim's v5e nodes: each
    node the reference's ``FakeTpuBackend`` through ``TpuShim``, the two
    hosts of one torus (``sim-torus-0``, host offsets 0 and 2), as the
    reference's ``nodes_per_group=2`` lays them out."""

    def __init__(self, **kw):
        self._hosts = 0
        kw.pop("generation", None)
        super().__init__(generation="", **kw)

    def _new_backend(self):
        i, self._hosts = self._hosts, self._hosts + 1
        return TpuShim(FakeTpuBackend("v5e", host_offset=(2 * i, 0, 0),
                                      torus_group="sim-torus-0"))


def ref_side():
    return cs.Side(sim=RefSim, sim_kw=dict(generation="v5e",
                                           nodes_per_group=2),
                   small="v5e-1x1", big="v5e-2x1", faults=ref_faults,
                   journal=ref_journal, box=RefBox,
                   slice_uuid_for=ref_suid, validate=ref_validate)


def v5e_side():
    return cs.Side(sim=V5eSim, sim_kw={}, small="v5e-1x1", big="v5e-2x1",
                   faults=tfaults, journal=tjournal, box=Box,
                   slice_uuid_for=slice_uuid_for, validate=tvalidate)


SIDES = {"ref-v5e": ref_side, "port-v5e": v5e_side,
         "port-h100": cs.port_side}


def ref_serving():
    """The reference's server, router and loadgen over its JAX engine at
    the reference smoke's widths."""
    import jax
    import jax.numpy as jnp

    from instaslice_tpu.models.lm import ModelConfig, TpuLM
    from instaslice_tpu.serving import ServingEngine
    from instaslice_tpu.serving.api_server import ApiServer
    from instaslice_tpu.serving.router import Router

    cfg = ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, dtype=jnp.float32, remat=False)
    m = TpuLM(cfg)
    params = m.init(jax.random.key(0))
    return cs.SimpleNamespace(
        engine=lambda: ServingEngine(m, params, max_batch=4, max_len=96,
                                     prefill_len=8),
        ApiServer=ApiServer, Router=Router, loadgen=ref_loadgen,
        faults=ref_faults, journal=ref_journal)


def comparable(result):
    """What a crash arm shows beyond timing: phases, reasons, findings."""
    return {k: result[k] for k in ("phases", "reasons", "findings")}


# ------------------------------------------------------------ CrashPlan


def crash_plan_script(mod, seed):
    """Every outcome of one seeded sequence of arms and checks."""
    rng = random.Random(seed)
    out = []

    def outcome(fn):
        try:
            fn()
            return "pass"
        except mod.InjectedCrash as e:
            return f"crash {e.site}"
        except ValueError as e:
            return f"ValueError {'TPUSLICE_CRASH_AT' in str(e)}"

    for text in ("a.b, c.d:3", "", "   ", "agent.realize:2nd", "x.y:0",
                 "s:1,s:2", "p.q:7"):
        try:
            parsed = mod.CrashPlan.from_env(text)
            out.append(("env", text, parsed and parsed.sites))
        except ValueError as e:
            out.append(("env", text, "TPUSLICE_CRASH_AT" in str(e)))
    plan = mod.CrashPlan()
    sites = ["s", "t", "u"]
    for _ in range(200):
        op = rng.random()
        site = rng.choice(sites)
        if op < 0.15:
            plan.arm(site, rng.randint(1, 4))
            out.append(("arm", site))
        else:
            out.append(("check", site,
                        outcome(lambda s=site: plan.check(s))))
    out.append(("stats", plan.stats()))
    mod.set_crash_plan(None)
    out.append(("noop", outcome(lambda: mod.maybe_crash("x"))))
    mod.set_crash_plan(mod.CrashPlan().arm("x.y", 2))
    out.append(("process", [outcome(lambda: mod.maybe_crash("x.y"))
                            for _ in range(4)]))
    mod.set_crash_plan(None)
    out.append(("base", issubclass(mod.InjectedCrash, Exception)))
    return out


@pytest.mark.parametrize("seed", [0, 1, cs.CHAOS_SEED])
def test_crash_plan_equals_the_reference(seed):
    got = crash_plan_script(tfaults, seed)
    assert got == crash_plan_script(ref_faults, seed)
    assert ("base", False) in got  # passes every `except Exception`


def test_crash_plan_rearm_counts_from_arming():
    plan = tfaults.CrashPlan().arm("s", 1)
    with pytest.raises(tfaults.InjectedCrash):
        plan.check("s")
    for _ in range(5):
        plan.check("s")
    plan.arm("s", 2)
    plan.check("s")
    with pytest.raises(tfaults.InjectedCrash):
        plan.check("s")


# ------------------------------------------------- agent boot sweep (MIG)


def mig_cluster():
    return SimCluster(n_nodes=1, gpus_per_node=1, health_interval=0,
                      deletion_grace_seconds=0.2)


def test_unclaimed_reservation_adopted_then_reaped():
    c = mig_cluster()
    c.backends["node-0"].reserve("sl-dead-alloc", [0], "1g.10gb", 0)
    c.start()
    try:
        # first boot (a fresh CR): adopted as dangling, not reaped
        assert cs.wait_for(lambda: "sl-dead-alloc" in c.kube.get(
            "TpuSlice", c.namespace, "node-0")["spec"].get("prepared", {}))
        assert [r.slice_uuid for r in
                c.backends["node-0"].list_reservations()] == ["sl-dead-alloc"]
        # the next boot: the CR's epochs are the truth, nothing claims it
        c.restart_agent("node-0")
        assert cs.wait_for(
            lambda: not c.backends["node-0"].list_reservations(), 10)
        ts = c.kube.get("TpuSlice", c.namespace, "node-0")
        assert "sl-dead-alloc" not in ts["spec"].get("prepared", {})
        reaped = tjournal.get_journal().events(reason="OrphanReaped")
        assert reaped and "sl-dead-alloc" in reaped[0].message
        assert cs.no_orphans(c, slice_uuid_for) == []
    finally:
        c.stop()


def test_control_no_orphan_sweep_leaves_the_orphan(monkeypatch):
    monkeypatch.setattr(discovery, "_sweep_orphans", lambda ts, b: set())
    c = mig_cluster()
    c.backends["node-0"].reserve("sl-dead-alloc", [0], "1g.10gb", 0)
    c.start()
    try:
        assert cs.wait_for(lambda: "sl-dead-alloc" in c.kube.get(
            "TpuSlice", c.namespace, "node-0")["spec"].get("prepared", {}))
        c.restart_agent("node-0")  # its boot (and sweep) runs in start()
        found = cs.eventually(lambda: cs.no_orphans(c, slice_uuid_for), 2)
        assert found and "sl-dead-alloc" in found[0]
    finally:
        c.stop()


def test_foreign_reservation_adopted_never_released():
    c = mig_cluster()
    c.backends["node-0"].reserve("preexisting-job", [0], "3g.40gb", 0)
    c.start()
    try:
        assert cs.wait_for(lambda: "preexisting-job" in c.kube.get(
            "TpuSlice", c.namespace, "node-0")["spec"].get("prepared", {}))
        c.restart_agent("node-0")
        c.submit("after", "3g.40gb")  # the other half of the GPU
        assert c.wait_phase("after", "Running", 20)
        held = sorted(r.slice_uuid for r in
                      c.backends["node-0"].list_reservations())
        assert "preexisting-job" in held and len(held) == 2
        prep = c.kube.get("TpuSlice", c.namespace, "node-0")["spec"][
            "prepared"]["preexisting-job"]
        assert prep["podUUID"] == ""
    finally:
        c.stop()


def test_claimed_reservation_kept_across_restart():
    c = mig_cluster().start()
    try:
        c.submit("keep", "1g.10gb")
        cs.settle(cs.port_side(), c, ["keep"])
        before = [r.slice_uuid for r in
                  c.backends["node-0"].list_reservations()]
        c.restart_agent("node-0")  # its boot (and sweep) runs in start()
        c.submit("probe", "1g.10gb")
        assert c.wait_phase("probe", "Running", 20)
        after = [r.slice_uuid for r in
                 c.backends["node-0"].list_reservations()]
        assert set(before) <= set(after) and c.pod_phase("keep") == "Running"
        assert not tjournal.get_journal().events(reason="OrphanReaped")
    finally:
        c.stop()


# ------------------------------------------------ loadgen classification


TRUNCATION_CASES = [
    ("ConnectionResetError: peer", None, 5),
    ("stream ended without [DONE]", 200, 3),
    ("replica stream died: reset", 200, 3),
    ("request lost to engine recovery", 200, 3),
    ("ConnectionResetError: peer", None, 0),
    (None, 200, 7), ("x", 429, 2), ("x", 503, 2),
    ("TimeoutError: timed out", None, 2),
]


def test_stream_truncated_equals_the_reference():
    got = [loadgen._classify(*a) for a in TRUNCATION_CASES]
    assert got == [ref_loadgen._classify(*a) for a in TRUNCATION_CASES]
    assert got[:3] == ["stream-truncated"] * 3
    assert "stream-truncated" in loadgen.OUTCOMES


def test_control_truncation_as_transport_error_departs(monkeypatch):
    real = loadgen._classify

    def old_rule(err, code, toks=0, hedged=False):
        out = real(err, code, toks, hedged)
        return "transport-error" if out == "stream-truncated" else out

    monkeypatch.setattr(loadgen, "_classify", old_rule)
    got = [loadgen._classify(*a) for a in TRUNCATION_CASES]
    assert got != [ref_loadgen._classify(*a) for a in TRUNCATION_CASES]


# -------------------------------------------------- validate --epochs


def _ev(seq, reason, ref, tid="t1", epoch=None):
    rec = {"seq": seq, "ts": float(seq), "component": "allocation",
           "reason": reason, "objectRef": ref, "traceId": tid}
    if epoch is not None:
        rec["attrs"] = {"attempt_epoch": str(epoch)}
    return rec


EPOCH_LISTS = {
    "legal across restart": [
        _ev(1, "SliceCreating", "alloc/a", epoch=1),
        _ev(2, "SliceCreated", "alloc/a", epoch=1),
        {"seq": 3, "ts": 3.0, "component": "sim",
         "reason": "CrashRecovered", "objectRef": "component/controller"},
        _ev(4, "SliceUngated", "alloc/a", epoch=1)],
    "superseded": [
        _ev(1, "SliceCreating", "alloc/a", epoch=1),
        _ev(2, "SliceCreating", "alloc/a", tid="t2", epoch=2),
        _ev(3, "SliceCreated", "alloc/a", tid="t2", epoch=2),
        _ev(4, "SliceUngated", "alloc/a", tid="t2", epoch=2)],
    "superseded torn down": [
        _ev(1, "SliceCreating", "alloc/a", epoch=1),
        _ev(10, "SliceDeleted", "alloc/a", epoch=1),
        _ev(2, "SliceCreating", "alloc/a", tid="t2", epoch=2),
        _ev(3, "SliceCreated", "alloc/a", tid="t2", epoch=2),
        _ev(4, "SliceUngated", "alloc/a", tid="t2", epoch=2)],
    "abandoned": [
        _ev(1, "SliceCreating", "alloc/a", epoch=1),
        _ev(2, "SliceCreated", "alloc/a", epoch=1)],
    "illegal": [
        _ev(1, "SliceCreating", "alloc/a", epoch=1),
        _ev(2, "SliceUngated", "alloc/a", epoch=1),
        _ev(3, "SliceDeleted", "alloc/a", epoch=1)],
    "stale deleted interleaved": [
        _ev(1, "SliceCreating", "alloc/a", tid="t1", epoch=1),
        _ev(2, "SliceCreating", "alloc/a", tid="t2", epoch=2),
        _ev(3, "SliceDeleted", "alloc/a", tid="t1", epoch=1),
        _ev(4, "SliceCreated", "alloc/a", tid="t2", epoch=2),
        _ev(5, "SliceUngated", "alloc/a", tid="t2", epoch=2)],
}


@pytest.mark.parametrize("name", sorted(EPOCH_LISTS))
def test_check_epochs_equals_the_reference(name):
    events = EPOCH_LISTS[name]
    got = tvalidate.check_epochs(events)
    assert got == ref_validate.check_epochs(events)
    clean = name in ("legal across restart", "superseded torn down",
                     "stale deleted interleaved")
    assert (got == []) == clean, got


def test_epochs_cli_flag(tmp_path):
    import json

    p = tmp_path / "ev.jsonl"
    events = [_ev(1, "SliceCreating", "alloc/a", epoch=1),
              _ev(2, "SliceCreated", "alloc/a", epoch=1),
              _ev(3, "SliceUngated", "alloc/a", epoch=1)]
    p.write_text("\n".join(json.dumps(e) for e in events) + "\n")
    assert tvalidate.main([str(p), "--epochs"]) == 0
    p.write_text("\n".join(json.dumps(e) for e in events[:2]) + "\n")
    assert tvalidate.main([str(p), "--epochs"]) == 1


# ------------------------------------------------------- the crash arms


@pytest.fixture(scope="module")
def crash_results():
    """Each crash arm on each side, once for the module."""
    out = {}
    for name, make in SIDES.items():
        side = make()
        out[name] = {"controller": cs.crash_controller(side),
                     "agent": cs.crash_agent(side)}
    return out


@pytest.mark.parametrize("arm", ["controller", "agent"])
def test_crash_arm_port_at_v5e_equals_the_reference(crash_results, arm):
    want = comparable(crash_results["ref-v5e"][arm])
    assert comparable(crash_results["port-v5e"][arm]) == want
    assert want["reasons"] == {"CrashRecovered": 1}
    assert all(p == "Running" for p in want["phases"].values())
    assert all(f == [] for f in want["findings"].values())


@pytest.mark.parametrize("arm", ["controller", "agent"])
def test_crash_arm_on_h100_keeps_the_invariants(crash_results, arm):
    got = comparable(crash_results["port-h100"][arm])
    want = comparable(crash_results["ref-v5e"][arm])
    assert got["reasons"] == want["reasons"]
    assert sorted(got["phases"].values()) == sorted(want["phases"].values())
    assert got["findings"] == want["findings"]
    assert cs.findings_of(crash_results["port-h100"][arm]) == []


def test_replica_kill_ledger_equals_the_reference():
    got = cs.crash_replica(cs.port_serving("cpu"))
    want = cs.crash_replica(ref_serving())
    assert got["findings"] == want["findings"] == {"ledger": [],
                                                   "replicas": []}
    assert got["victim_stopped"] and want["victim_stopped"]
    assert set(got["outcomes"]) <= set(cs.CLASSIFIED)


def test_crash_gate_main_exits_zero(capsys):
    import json

    assert cs.main(["--crash", "--device", "cpu", "--seed", "7"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["chaos_smoke"] == "ok" and line["gates"] == ["crash"]
    assert [a["arm"] for a in line["arms"]] == [
        "crash_controller", "crash_agent", "crash_replica"]
    assert all(a["findings"] == 0 for a in line["arms"])


def test_gate_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cs.main(["--crash"])


# --------------------------------------------------------- the kill loop


@pytest.mark.parametrize("site,nth", cs.KILL_SITES,
                         ids=[f"{s}:{n}" for s, n in cs.KILL_SITES])
def test_kill_loop(site, nth):
    r = cs.kill_site(cs.port_side(), site, nth)
    assert cs.findings_of(r) == []
    assert all(p == "Running" for p in r["phases"].values())
    assert r["reasons"].get("CrashRecovered", 0) >= 1


# ------------------------------------------------------------ watchdogs


def test_stuck_grant_watchdog_fires_and_replaces():
    r = cs.stuck_grant(cs.port_side())
    assert cs.findings_of(r) == []
    assert r["reasons"]["GrantDeadlineExceeded"] >= 1
    assert r["node"] != r["dead"]


def test_stuck_migration_abort_is_bounded():
    r = cs.stuck_migration(cs.port_side())
    assert r["first"]["rollback"] and r["first"]["aborted"] == 1
    assert r["failed"] >= 1
    assert r["reasons"]["MigrationAborted"] >= 1


def test_stall_warning_rearms_on_progress():
    assert cs.stall_rearm()
