"""The port's partition tier (``instaslice_tpu_torch/analysis/
chaos_smoke.py``) held against the reference's
(``tests/test_partition_chaos.py``).

- **Units** that ``test_torch_netchaos.py``, ``test_torch_kube.py`` and
  ``test_torch_router.py`` do not hold: the informer replaying what it
  missed across a healed cut; the epoch fence failing closed when it
  cannot re-prove its lease, and open without an election; the circuit
  breaker's single half-open probe; the router's jittered poll backoff
  and Retry-After; hedged stats polls; the EWMA gray ejection cycle;
  the agent's static mode on a MIG node; ``check_nemesis`` and the
  loadgen's partition-era outcomes. Where one script runs on both
  packages (the breaker, hedging, ejection, ``check_nemesis``, the
  outcomes) the results must be equal.
- **The partition arms**: the controller and agent cuts on the
  reference's sim at v5e, the port's at v5e and the port's at
  ``h100-80gb`` (phases, reasons and findings equal, findings empty);
  the gray replica on the port's servers.
- **The op-stream nemesis** in a spawned two-process world
  (``torch_serve_tp_worker.py``, kind ``nemesis``): a partitioned
  follower is dropped as a dead one and the driver serves on.
- **Controls**, each a defence patched out that the check must miss:
  the epoch fence held open (the deposed writer's write lands),
  ``eject_factor=0`` (the gray replica is never ejected), the op-stream
  edge left whole (the follower kept).

Under ``TPUSLICE_LOCKCHECK=1`` (``make gpu-chaos``) a lock-order cycle
seen by the port's detector fails the module.
"""

import os
import sys
import time

import pytest

from conftest import free_port
from instaslice_tpu import faults as ref_faults
from instaslice_tpu.kube import real as ref_real
from instaslice_tpu.obs import journal as ref_journal
from instaslice_tpu.serving import loadgen as ref_loadgen
from instaslice_tpu.serving import router as ref_router
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.analysis import chaos_smoke as cs
from instaslice_tpu_torch.analysis import validate_events as tvalidate
from instaslice_tpu_torch.api.constants import (
    REASON_APISERVER_UNREACHABLE,
    REASON_DEGRADED_ENTERED,
    REASON_DEGRADED_EXITED,
    REASON_REPLICA_EJECTED,
    REASON_REPLICA_READMITTED,
    REASON_WRITE_FENCED,
)
from instaslice_tpu_torch.faults.netchaos import (
    NemesisKubeClient,
    NemesisPlan,
)
from instaslice_tpu_torch.kube import real as treal
from instaslice_tpu_torch.kube.client import (
    Fenced,
    stamp_writer_epoch,
    update_with_retry,
)
from instaslice_tpu_torch.kube.fake import FakeKube
from instaslice_tpu_torch.kube.informer import Informer
from instaslice_tpu_torch.obs import journal as tjournal
from instaslice_tpu_torch.serving import loadgen
from instaslice_tpu_torch.serving import router as trouter
from instaslice_tpu_torch.utils import election
from test_torch_crash_chaos import ref_side, v5e_side
from torch_port_util import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import validate_events as ref_validate  # noqa: E402

SEED = cs.CHAOS_SEED


@pytest.fixture(autouse=True)
def _clean():
    for f, j in ((ref_faults, ref_journal), (tfaults, tjournal)):
        f.set_nemesis(None)
        j.reset_journal()
    yield
    for f, j in ((ref_faults, ref_journal), (tfaults, tjournal)):
        f.set_nemesis(None)
        j.reset_journal()


@pytest.fixture(autouse=True, scope="module")
def _lockcheck():
    from instaslice_tpu_torch.utils import lockcheck

    yield
    if lockcheck.armed():
        assert not lockcheck.report()["cycles"], lockcheck.report()


def reasons():
    return [e.reason for e in tjournal.get_journal().events()]


# ------------------------------------------------- informer across a cut


def test_disconnect_then_heal_replays_missed_events():
    plan = NemesisPlan(SEED)
    kube = FakeKube()
    client = NemesisKubeClient(kube, plan, "controller")
    kube.create("TpuSlice", {"apiVersion": "v1", "kind": "TpuSlice",
                             "metadata": {"namespace": "ns", "name": "n0"},
                             "spec": {"gen": 0}})
    inf = Informer(client, "TpuSlice", namespace="ns",
                   resync_period=30.0).start()
    try:
        assert inf.wait_synced(10)
        plan.partition("controller", "apiserver", duration=0.4)
        obj = kube.get("TpuSlice", "ns", "n0")
        obj["spec"]["gen"] = 1
        kube.update("TpuSlice", obj)  # emitted while cut off
        assert cs.wait_for(lambda: (inf.get("ns", "n0") or {}).get(
            "spec", {}).get("gen") == 1, 15)
    finally:
        inf.stop()


# ---------------------------------------------------------- epoch fence


def _mk_cr(kube):
    kube.create("TpuSlice", {"apiVersion": "v1", "kind": "TpuSlice",
                             "metadata": {"namespace": "ns", "name": "n0"},
                             "spec": {"x": 0}})


def deposed_write():
    """a leads, writes, its lease lapses, b takes over; a writes again.
    What the CR and the journal hold after."""
    kube = FakeKube()
    _mk_cr(kube)
    a = election.LeaderElector(kube, "ns", "ctl", "a", lease_seconds=0.2)
    b = election.LeaderElector(kube, "ns", "ctl", "b", lease_seconds=0.2)
    assert a._try_acquire_or_renew()
    a.is_leader.set()

    def bump(obj):
        obj["spec"]["x"] += 1
        return obj

    update_with_retry(kube, "TpuSlice", "ns", "n0", bump,
                      fence=election.EpochFence(lambda: a))
    assert cs.wait_for(lambda: b._try_acquire_or_renew(), 5)
    b.is_leader.set()
    try:
        update_with_retry(kube, "TpuSlice", "ns", "n0", bump,
                          fence=election.EpochFence(lambda: a))
        refused = False
    except Fenced:
        refused = True
    return refused, kube.get("TpuSlice", "ns", "n0")["spec"]["x"], b.epoch


def test_deposed_writer_fenced():
    refused, x, epoch = deposed_write()
    assert (refused, x, epoch) == (True, 1, 1)
    assert REASON_WRITE_FENCED in reasons()


def test_control_fence_held_open_lets_the_deposed_writer_in(monkeypatch):
    monkeypatch.setattr(election.EpochFence, "__call__", lambda self: True)
    refused, x, _ = deposed_write()
    assert not refused and x == 2  # the double write the fence stops
    assert REASON_WRITE_FENCED not in reasons()


def test_fence_fails_closed_when_unverifiable():
    plan = NemesisPlan(SEED)
    kube = FakeKube()
    _mk_cr(kube)
    client = NemesisKubeClient(kube, plan, "ctl-a")
    a = election.LeaderElector(client, "ns", "ctl", "a", lease_seconds=0.2)
    assert a._try_acquire_or_renew()
    a.is_leader.set()
    fence = election.EpochFence(lambda: a)
    assert fence() and fence.epoch == 0
    # partitioned and past the freshness window: it cannot re-prove the
    # lease, so it fails closed
    plan.partition("ctl-a", "apiserver")
    assert cs.wait_for(lambda: not fence(), 2)


def test_fence_open_without_election():
    fence = election.EpochFence(lambda: None)
    assert fence() and fence.epoch is None
    obj = {"metadata": {}}
    stamp_writer_epoch(obj, fence)
    assert "annotations" not in obj["metadata"]


# ------------------------------------------- breaker half-open single probe


def breaker_script(mod):
    out = []

    def step(fn):
        try:
            fn()
            return "ok"
        except mod.CircuitOpen as e:
            return f"open {'probe already in flight' in str(e)}"

    pacer = __import__("threading").Event()
    for scenario in ("probe", "failed probe", "stale claim"):
        br = mod.CircuitBreaker(threshold=2, cooldown=0.05, name="t")
        for _ in range(br.threshold):
            br.fail()
        out.append((scenario, br.is_open(), step(br.check)))
        pacer.wait(0.06)
        out.append(step(br.check))  # this caller is the half-open probe
        if scenario == "probe":
            out.append(step(br.check))  # a concurrent caller fast-fails
            br.ok()
            out.append(step(br.check))
        elif scenario == "failed probe":
            br.fail()
            out.append(step(br.check))
        else:
            pacer.wait(0.06)  # the claim outlived a cooldown
            out.append(step(br.check))
    return out


def test_breaker_half_open_probe_equals_the_reference():
    got = breaker_script(treal)
    assert got == breaker_script(ref_real)
    assert got[:4] == [("probe", True, "open False"), "ok", "open True",
                       "ok"]


# ------------------------------------------ router poll backoff, hedging


def unstarted(mod, *reps, **kw):
    r = mod.Router(port=0, **kw)
    for rep in reps:
        r._replicas[rep.url] = rep
    r._srv.server_close()
    return r


def fed(mod, url, lat=(), **stats):
    rep = mod.Replica(url)
    rep.adopt_stats({
        "replica_id": stats.pop("replica_id", url), "uptime_seconds": 10.0,
        "queued": 0, "live_slots": 0, "parked": 0, "max_batch": 8,
        "kv": {"free": 100, "total": 100},
        "radix": {"digest": {"granule": 8, "paths": []}},
        "tenant_classes": {}})
    for dt in lat:
        rep.observe_latency(dt)
    return rep


def test_poll_backoff_jittered_and_capped():
    r = unstarted(trouter)
    prev, seen = 0.0, set()
    for _ in range(64):
        prev = r._next_backoff(prev)
        assert r.poll_backoff_base <= prev <= r.poll_backoff_cap
        seen.add(round(prev, 6))
    assert prev == r.poll_backoff_cap or len(seen) > 8
    assert r._next_backoff(0.0, retry_after=5.0) >= 5.0
    assert r._next_backoff(0.0, retry_after=3600.0) <= r.retry_after_cap
    rep = fed(trouter, "http://x:1")
    r._note_poll_failure(rep, None)
    first = rep.poll_backoff
    assert first > 0 and rep.poll_next > time.monotonic() - 0.001
    r._note_poll_failure(rep, None)
    assert rep.poll_backoff <= r.poll_backoff_cap
    ref = unstarted(ref_router)
    for name in ("poll_backoff_base", "poll_backoff_cap", "retry_after_cap"):
        assert getattr(r, name) == getattr(ref, name), name


def test_retry_after_header_parse_equals_the_reference():
    from email.message import Message

    for value in ("3", "0", "-1", "abc", None, "2.5"):
        h = Message()
        if value is not None:
            h["Retry-After"] = value
        assert trouter._retry_after_seconds(h) == \
            ref_router._retry_after_seconds(h), value


def hedge_script(mod):
    out = []
    r = unstarted(mod, hedge_after=0.05)
    calls = {"n": 0}
    gate = __import__("threading").Event()

    def slow_primary(method, rp, path, body, timeout=10.0):
        calls["n"] += 1
        if calls["n"] == 1:
            gate.wait(0.4)  # the gray primary
            return 200, {"slow": True}
        return 200, {"slow": False}

    r.http_json = slow_primary
    code, payload, _ = r._hedged_stats(fed(mod, "http://x:1"))
    out.append((code, payload, dict(r.hedges), r.requests.get("hedged-ok")))
    gate.set()
    fast = unstarted(mod, hedge_after=0.5)
    fast.http_json = lambda *a, **k: (200, {})
    code, payload, _ = fast._hedged_stats(fed(mod, "http://x:1"))
    out.append((code, payload, dict(fast.hedges)))
    return out


def test_hedged_stats_equal_the_reference():
    got = hedge_script(trouter)
    assert got == hedge_script(ref_router)
    assert got[0][2]["fired"] == 1 and got[0][2]["won"] == 1
    assert got[1][2].get("fired", 0) == 0


# ------------------------------------------------------ gray ejection


def ejection_script(mod, journal):
    out = [mod._median([1.0]), mod._median([1.0, 3.0]),
           mod._median([1.0, 2.0, 9.0])]
    rep = mod.Replica("http://x:1")
    for _ in range(16):
        rep.observe_latency(0.01)
    out.append(0.008 <= rep.lat_p95() <= 0.02)
    for _ in range(16):
        rep.observe_latency(0.2)
    out.append(rep.lat_p95() > 0.1)
    slow = fed(mod, "http://slow:1", [0.3] * 10, replica_id="s")
    fast = fed(mod, "http://fast:1", [0.004] * 10, replica_id="f")
    r = unstarted(mod, slow, fast, eject_min_samples=8)
    r.http_json = lambda *a, **k: (200, {})
    r.pin_session("conv", "http://slow:1")
    r._gray_sweep()
    out.append((slow.ejected, fast.ejected, dict(r.ejections),
                slow.alive(time.monotonic(), r.stale_after)))
    out.append([r.route([1, 2, 3], "", s)[0].url for s in ("", "conv")])
    for _ in range(32):
        slow.observe_latency(0.004)
    r._gray_sweep()
    out.append(cs.wait_for(lambda: not slow.ejected, 2.0))
    out.append([e.reason for e in journal.get_journal().events()
                if e.reason.startswith("Replica")])
    only = fed(mod, "http://only:1", [0.5] * 10)
    r1 = unstarted(mod, only)
    r1._gray_sweep()
    out.append(only.ejected)  # never below two healthy
    slow0 = fed(mod, "http://slow:1", [0.5] * 10)
    r0 = unstarted(mod, slow0, fed(mod, "http://fast:1", [0.004] * 10),
                   eject_factor=0.0)
    r0._gray_sweep()
    out.append(slow0.ejected)  # eject_factor 0: no sweep
    return out


def test_gray_ejection_units_equal_the_reference():
    got = ejection_script(trouter, tjournal)
    assert got == ejection_script(ref_router, ref_journal)
    assert got[5][:2] == (True, False)
    assert got[6] == ["http://fast:1", "http://fast:1"]
    assert got[8] == [REASON_REPLICA_EJECTED, REASON_REPLICA_READMITTED]
    assert got[9:] == [False, False]


# --------------------------------------------------- agent static mode


def static_agent():
    from instaslice_tpu_torch.agent.reconciler import NodeAgent
    from instaslice_tpu_torch.device import FakeGpuBackend

    plan = NemesisPlan(SEED)
    kube = FakeKube()
    client = NemesisKubeClient(kube, plan, "agent-n0")
    agent = NodeAgent(client, FakeGpuBackend(gpu_count=1), "n0", "ns",
                      health_interval=0)
    agent.boot()
    return plan, kube, agent


def test_partition_enters_static_mode_once():
    plan, kube, agent = static_agent()
    plan.partition("agent-n0", "apiserver")
    assert agent.reconcile("n0") == agent.degraded_retry_s
    assert agent.degraded
    agent.reconcile("n0")  # re-probe while still cut
    rs = reasons()
    assert rs.count(REASON_APISERVER_UNREACHABLE) == 1
    assert rs.count(REASON_DEGRADED_ENTERED) == 1


def test_heal_runs_boot_sweep_and_exits():
    plan, kube, agent = static_agent()
    plan.partition("agent-n0", "apiserver")
    agent.reconcile("n0")
    plan.heal()
    assert agent.reconcile("n0") is None and not agent.degraded
    assert REASON_DEGRADED_EXITED in reasons()
    assert kube.get("TpuSlice", "ns", "n0")


def test_injected_api_errors_are_not_a_partition():
    from instaslice_tpu_torch.faults import FaultPlan, FaultyKubeClient
    from instaslice_tpu_torch.kube.client import ApiError

    plan, kube, agent = static_agent()
    agent.client = FaultyKubeClient(agent.client, FaultPlan.from_env(
        "kube.request:p=1.0,kinds=http-503"))
    with pytest.raises(ApiError):
        agent.reconcile("n0")
    assert not agent.degraded


# ------------------------------------------------------- check_nemesis


def _ev(seq, component, reason, ref="", trace="", **attrs):
    rec = {"seq": seq, "ts": float(seq), "component": component,
           "reason": reason, "objectRef": ref, "traceId": trace}
    if attrs:
        rec["attrs"] = attrs
    return rec


def _grant(seq, alloc, trace="t1", deleted=False):
    evs = [_ev(seq, "allocation", "SliceCreating", f"alloc/{alloc}", trace),
           _ev(seq + 1, "allocation", "SliceUngated", f"alloc/{alloc}",
               trace)]
    if deleted:
        evs.append(_ev(seq + 2, "allocation", "SliceDeleted",
                       f"alloc/{alloc}", trace))
    return evs


NEMESIS_LISTS = {
    "clean": [
        _ev(1, "agent-n0", "ApiServerUnreachable", "node/n0"),
        _ev(2, "agent-n0", "DegradedModeEntered", "node/n0"),
        _ev(3, "agent-n0", "DegradedModeExited", "node/n0"),
        _ev(4, "controller", "Admitted", "Pod/ns/p", trace="t1"),
        _ev(5, "allocation", "SliceCreating", "alloc/a1", trace="t1"),
        _ev(6, "allocation", "SliceCreated", "alloc/a1", trace="t1"),
        _ev(7, "allocation", "SliceUngated", "alloc/a1", trace="t1")],
    "unpaired entry": [
        _ev(1, "agent-n0", "ApiServerUnreachable", "node/n0"),
        _ev(2, "agent-n0", "DegradedModeEntered", "node/n0")],
    "exit without entry": [
        _ev(1, "agent-n0", "DegradedModeExited", "node/n0")],
    "double place": [_ev(1, "controller", "Admitted", "Pod/ns/p", "t1")]
    + _grant(2, "a1") + _grant(4, "a2"),
    "retry after delete": [_ev(1, "controller", "Admitted", "Pod/ns/p",
                               "t1")]
    + _grant(2, "a1", deleted=True) + _grant(5, "a2"),
    "slice leak": [
        _ev(1, "allocation", "SliceCreating", "alloc/a1", trace="t1"),
        _ev(2, "allocation", "SliceCreated", "alloc/a1", trace="t1")],
    "fenced without component": [
        _ev(1, "", "WriteFenced", "TpuSlice/ns/n0")],
}


@pytest.mark.parametrize("name", sorted(NEMESIS_LISTS))
def test_check_nemesis_equals_the_reference(name):
    events = NEMESIS_LISTS[name]
    got = tvalidate.check_nemesis(events)
    assert got == ref_validate.check_nemesis(events)
    assert (got == []) == (name in ("clean", "retry after delete")), got


def test_loadgen_partition_era_outcomes_equal_the_reference():
    cases = [(None, 200, 5, True), (None, 200, 5, False),
             ("HTTPError 503: no replica accepted; 1 gray-ejected", 503,
              0, False), ("x", 503, 0, False)]
    got = [loadgen._classify(*a) for a in cases]
    assert got == [ref_loadgen._classify(*a) for a in cases]
    assert got == ["hedged-ok", "ok", "replica-ejected", "timeout-503"]
    assert {"hedged-ok", "replica-ejected"} <= set(loadgen.OUTCOMES)


# ------------------------------------------------- the partition arms


SIDES = {"ref-v5e": ref_side, "port-v5e": v5e_side,
         "port-h100": cs.port_side}


@pytest.fixture(scope="module")
def partition_results():
    out = {}
    for name, make in SIDES.items():
        side = make()
        out[name] = {"controller": cs.partition_controller(side, SEED),
                     "agent": cs.partition_agent(side, SEED)}
    return out


def comparable(r):
    return {k: r[k] for k in ("phases", "reasons", "findings")}


@pytest.mark.parametrize("arm", ["controller", "agent"])
def test_partition_arm_port_at_v5e_equals_the_reference(partition_results,
                                                        arm):
    want = comparable(partition_results["ref-v5e"][arm])
    assert comparable(partition_results["port-v5e"][arm]) == want
    assert all(p == "Running" for p in want["phases"].values())
    assert all(f == [] for f in want["findings"].values())


@pytest.mark.parametrize("arm", ["controller", "agent"])
def test_partition_arm_on_h100_keeps_the_invariants(partition_results, arm):
    got = comparable(partition_results["port-h100"][arm])
    want = comparable(partition_results["ref-v5e"][arm])
    assert got == want
    if arm == "controller":
        assert partition_results["port-h100"][arm]["cut_phase"] == "Pending"
    else:
        assert got["reasons"]["DegradedModeEntered"] == 1


def test_gray_replica_ejected_and_readmitted():
    r = cs.gray_replica(cs.port_serving("cpu"), tvalidate, SEED)
    assert cs.findings_of(r) == []
    assert r["reasons"]["ReplicaEjected"] >= 1
    assert r["reasons"]["ReplicaReadmitted"] >= 1
    assert r["eject_s"] > 0 and r["readmit_s"] >= 0


def test_control_gray_replica_never_ejected_without_the_sweep():
    # the sweep ejects in ~2-3.5 s here (6 polls of 0.5 s season A)
    with pytest.raises(AssertionError,
                       match="the gray replica ejected: never within"):
        cs.gray_replica(cs.port_serving("cpu"), tvalidate, SEED,
                        eject_factor=0.0, eject_timeout=8.0)


def test_partition_gate_main_exits_zero(capsys):
    import json

    assert cs.main(["--partition", "--device", "cpu", "--seed", "5"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["chaos_smoke"] == "ok" and line["gates"] == ["partition"]
    arms = {a["arm"]: a for a in line["arms"]}
    assert set(arms) == {"partition_controller", "partition_agent",
                         "gray_replica"}
    assert arms["gray_replica"]["reasons"]["ReplicaEjected"] >= 1


# ------------------------------------------------- op-stream nemesis


@pytest.fixture(scope="module")
def opstream_world(tmp_path_factory):
    from torch_port_util import encode_tree, numpy_params, configs
    from instaslice_tpu_torch import bridge
    import jax
    import jax.numpy as jnp

    cfg = dict(vocab_size=64, d_model=32, n_heads=2, n_kv_heads=2,
               n_layers=2, d_ff=64)
    jcfg, _ = configs("fp32", **cfg)
    tree = bridge.params_from_jax(jax.device_get(jax.tree.map(
        jnp.asarray, numpy_params(jcfg, 0))), device="cpu")
    out = tmp_path_factory.mktemp("opstream_nemesis")
    base = {"cfg": cfg, "params": encode_tree(tree), "kv_quant": False,
            "kind": "nemesis", "seed": SEED}
    w = spawn_world(out, [dict(base, name="cut", port=free_port()),
                          dict(base, name="whole", control=True,
                               port=free_port())])
    try:
        yield w
    finally:
        w.close()


def test_partitioned_follower_dropped_like_dead(opstream_world):
    d, f = opstream_world.result("cut", 0), opstream_world.result("cut", 1)
    assert (d["before"], d["after"]) == (1, 0)
    assert d["stats"] and d["stats"][0]["fired"] >= 1
    # the driver served on alone: the first request's token from prefill
    # and 2 + 3 decoded, the second's from prefill and 3 decoded
    assert [len(t) for t in d["tokens"]] == [6, 4]
    # the follower saw the ops before the cut, and its stream then ended
    assert f["applied"] == 2


def test_control_whole_edge_keeps_the_follower(opstream_world):
    d = opstream_world.result("whole", 0)
    assert (d["before"], d["after"]) == (1, 1)
