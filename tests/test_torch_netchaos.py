"""The port's network nemesis (``instaslice_tpu_torch/faults/netchaos.py``)
against the reference's (``instaslice_tpu/faults/netchaos.py``): one
seeded script runs through both plans and both kube wrappers (the env
grammar, symmetric and one-way partitions, seeded drops, latency with
jitter, watch dup/reorder/expire, timed heal, throttle, fire caps) and
their decisions and ``stats()`` must be equal. The port's informer
converges under duplicated, reordered and expired deliveries, and the
port's op stream drops a partitioned follower as the reference's does.
The control runs the script under another seed, which must differ.
"""

import socket
import time

import pytest

from instaslice_tpu.faults import netchaos as ref
from instaslice_tpu.kube.fake import FakeKube as RefKube
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.faults import netchaos as port
from instaslice_tpu_torch.kube.client import ResourceVersionExpired
from instaslice_tpu_torch.kube.fake import FakeKube as PortKube
from instaslice_tpu_torch.kube.informer import Informer

SEED = 1234

PLAN_TEXT = ("seed=7;controller>apiserver:kind=partition,duration=2;"
             "apiserver>agent-*:kind=dup,p=0.5;"
             "router>replica:http://x:1:kind=latency,delay=0.1,jitter=0.05")


def _outcome(fn):
    """What one consult did: "ok", or the exception's type name."""
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - the name is the decision
        return type(e).__name__


def _mk(kube, name):
    kube.create("TpuSlice", {"apiVersion": "v1", "kind": "TpuSlice",
                             "metadata": {"namespace": "ns", "name": name},
                             "spec": {}})


def plan_script(mod, seed):
    """Every decision of a plan over one seeded sequence."""
    out = []
    parsed = mod.NemesisPlan.from_env(PLAN_TEXT)
    out.append(("grammar", parsed.seed,
                [(r.src, r.dst, r.kind, r.probability, r.delay_s,
                  r.jitter_s, r.duration_s) for r in parsed.rules],
                mod.NemesisPlan.from_env("")))
    for bad in ("controller>apiserver:p=0.5", "garbage",
                "a>b:kind=partition,bogus=1"):
        out.append(("bad", _outcome(lambda b=bad: mod.NemesisPlan.from_env(b))))
    plan = mod.NemesisPlan(seed)
    plan.partition("a", "b")
    out.append(("sym", plan.is_partitioned("a", "b"),
                plan.is_partitioned("b", "a")))
    plan.heal()
    plan.partition_oneway("a", "b")
    out.append(("oneway", plan.is_partitioned("a", "b"),
                plan.is_partitioned("b", "a"),
                _outcome(lambda: plan.before_request("a", "b")),
                _outcome(lambda: plan.before_request("b", "a"))))
    plan.heal()
    plan.drop("c", "d", p=0.5)
    out.append(("drops", [_outcome(lambda: plan.before_request("c", "d"))
                          for _ in range(64)]))
    plan.latency("e", "f", delay=0.0005, jitter=0.0005)
    plan.watch_chaos("apiserver", "g", dup_p=0.4, reorder_p=0.3)
    out.append(("watch", [plan.watch_action("apiserver", "g")
                          for _ in range(48)]))
    out.append(("latency", [_outcome(lambda: plan.before_request("e", "f"))
                            for _ in range(4)]))
    plan.rule("apiserver", "h", "expire", max_fires=1)
    out.append(("expire", [plan.watch_action("apiserver", "h")
                           for _ in range(3)]))
    plan.drop("i", "j", p=1.0, max_fires=2)
    out.append(("max", [_outcome(lambda: plan.before_request("i", "j"))
                        for _ in range(4)]))
    plan.throttle("k", "l", rate_bps=1e6)
    t0 = time.monotonic()
    plan.throttle_sleep("k", "l", 50_000)   # 50 ms at 1 MB/s
    out.append(("throttle", time.monotonic() - t0 >= 0.045))
    plan.partition("m", "n", duration=0.1)
    cut = plan.is_partitioned("m", "n")
    time.sleep(0.2)
    out.append(("timed heal", cut, plan.is_partitioned("m", "n"),
                _outcome(lambda: plan.before_request("m", "n"))))
    out.append(("heal", plan.heal("c", "d"), plan.heal()))
    out.append(("stats", plan.stats()))
    return out


def client_script(mod, kube_cls, seed):
    """Every decision of the kube wrapper: one-way asymmetry (verbs cut,
    then the watch delivery cut), dup, expire, and a seeded mix of
    dup/reorder/drop over a stream of updates."""
    out = []
    plan = mod.NemesisPlan(seed)
    kube = kube_cls()
    client = mod.NemesisKubeClient(kube, plan, "controller")
    _mk(kube, "n0")
    plan.partition_oneway("controller", "apiserver")
    out.append(("verb cut", _outcome(
        lambda: client.get("TpuSlice", "ns", "n0"))))
    plan.heal()
    plan.partition_oneway("apiserver", "controller")
    out.append(("watch cut",
                client.get("TpuSlice", "ns", "n0")["metadata"]["name"],
                list(client.watch("TpuSlice", namespace="ns", timeout=0.1))))
    plan.heal()
    plan.rule("apiserver", "controller", "dup")
    out.append(("dup", [e for e, _ in client.watch(
        "TpuSlice", namespace="ns", timeout=0.1) if e != "BOOKMARK"]))
    plan.heal()
    plan.rule("apiserver", "controller", "expire", max_fires=1)
    out.append(("expire", _outcome(lambda: list(client.watch(
        "TpuSlice", namespace="ns", timeout=0.1)))))
    plan.heal()
    for i in range(1, 12):
        _mk(kube, f"n{i}")
    plan.watch_chaos("apiserver", "controller", dup_p=0.3, reorder_p=0.3)
    plan.drop("apiserver", "controller", p=0.2)
    out.append(("mix", [(e, o["metadata"]["name"]) for e, o in client.watch(
        "TpuSlice", namespace="ns", timeout=0.1) if e != "BOOKMARK"]))
    out.append(("stats", plan.stats()))
    return out


def test_plan_decisions_equal_the_reference():
    assert plan_script(port, SEED) == plan_script(ref, SEED)


def test_kube_client_decisions_equal_the_reference():
    assert client_script(port, PortKube, SEED) == \
        client_script(ref, RefKube, SEED)


def test_control_another_seed_differs():
    got = plan_script(port, SEED)
    other = plan_script(port, SEED + 1)
    assert got != other
    assert [x for x in got if x[0] == "drops"] != \
        [x for x in other if x[0] == "drops"]
    assert client_script(port, PortKube, SEED) != \
        client_script(port, PortKube, SEED + 1)


def test_faults_reexports_the_nemesis():
    for name in ("NemesisKubeClient", "NemesisPlan", "NemesisRule",
                 "PartitionError", "get_nemesis", "reset_nemesis",
                 "set_nemesis"):
        assert getattr(tfaults, name) is getattr(port, name)
    assert issubclass(port.PartitionError, ConnectionError)


def test_env_plan_is_the_process_default(monkeypatch):
    monkeypatch.setenv("TPUSLICE_NEMESIS_PLAN", PLAN_TEXT)
    try:
        port.reset_nemesis()
        got = port.get_nemesis()
        assert got is not None and got.seed == 7 and len(got.rules) == 3
    finally:
        monkeypatch.delenv("TPUSLICE_NEMESIS_PLAN")
        port.reset_nemesis()
    assert port.get_nemesis() is None


def test_informer_converges_under_dup_reorder_and_410():
    """Duplicated and reordered deliveries and an injected 410 must not
    regress the informer's resourceVersion guard or invalidate the
    index memo of an untouched bucket."""
    plan = port.NemesisPlan(SEED)
    kube = PortKube()
    client = port.NemesisKubeClient(kube, plan, "controller")

    def mk(name, group):
        kube.create("TpuSlice", {
            "apiVersion": "v1", "kind": "TpuSlice",
            "metadata": {"namespace": "ns", "name": name},
            "spec": {"group": group, "gen": 0}})

    mk("stable-0", "a")
    mk("churn-0", "b")
    inf = Informer(client, "TpuSlice", namespace="ns", resync_period=0.5,
                   indexers={"group": lambda o: [o["spec"]["group"]]}).start()
    try:
        assert inf.wait_synced(10)
        v_a = inf.index_version("group", "a")
        plan.watch_chaos("apiserver", "controller", dup_p=0.5,
                         reorder_p=0.3)
        plan.rule("apiserver", "controller", "expire", max_fires=1)
        for i in range(20):
            obj = kube.get("TpuSlice", "ns", "churn-0")
            obj["spec"]["gen"] = i + 1
            kube.update("TpuSlice", obj)
        end = time.monotonic() + 15
        while time.monotonic() < end and (inf.get("ns", "churn-0") or {}) \
                .get("spec", {}).get("gen") != 20:
            time.sleep(0.02)
        assert inf.get("ns", "churn-0")["spec"]["gen"] == 20, plan.stats()
        plan.heal()
        assert inf.index_version("group", "a") == v_a
        assert {o["metadata"]["name"] for o in inf.list()} == \
            {"stable-0", "churn-0"}
        fired = {s["kind"]: s["fired"] for s in plan.stats()}
        assert fired["dup"] and fired["expire"] == 1
    finally:
        inf.stop()


def _bcast_run(dist_mod, mod, plan):
    """``_bcast`` of one op to a follower on a socket pair under ``plan``
    (installed as the process nemesis): (followers left, what the
    follower's end read)."""
    a, b = socket.socketpair()
    b.settimeout(1.0)
    d = dist_mod.DistributedEngine.__new__(dist_mod.DistributedEngine)
    object.__setattr__(d, "engine", object())
    object.__setattr__(d, "_conns", [(a, "peer:1")])
    mod.set_nemesis(plan)
    try:
        d._bcast({"op": "noop"})
        try:
            got = b.recv(100)
        except socket.timeout:
            got = b""
        return len(d._conns), got
    finally:
        mod.set_nemesis(None)
        a.close()
        b.close()


@pytest.mark.parametrize("cut", [False, True])
def test_bcast_drops_a_partitioned_follower_as_the_reference(cut):
    from instaslice_tpu.serving import distributed as rdist
    from instaslice_tpu_torch.serving import distributed as tdist

    def plan(mod):
        if not cut:
            return None
        p = mod.NemesisPlan(SEED)
        p.partition("opstream", "follower:peer:1")
        return p

    got = _bcast_run(tdist, port, plan(port))
    assert got == _bcast_run(rdist, ref, plan(ref))
    assert got == ((0, b"") if cut else (1, b'{"op": "noop"}\n'))


def test_bcast_throttle_slows_the_send():
    from instaslice_tpu_torch.serving import distributed as tdist

    p = port.NemesisPlan(SEED)
    p.throttle("opstream", "follower:*", rate_bps=200.0)
    t0 = time.monotonic()
    left, got = _bcast_run(tdist, port, p)
    # 15 bytes at 200 bytes/s: 75 ms
    assert time.monotonic() - t0 >= 0.07
    assert (left, got) == (1, b'{"op": "noop"}\n')
    assert p.stats()[0]["fired"] == 1


def test_expire_raises_the_ports_resource_version_expired():
    plan = port.NemesisPlan(SEED)
    kube = PortKube()
    _mk(kube, "n0")
    client = port.NemesisKubeClient(kube, plan, "agent-node-0")
    plan.rule("apiserver", "agent-*", "expire", max_fires=1)
    with pytest.raises(ResourceVersionExpired):
        list(client.watch("TpuSlice", namespace="ns", timeout=0.1))
