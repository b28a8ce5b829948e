"""The port's repacker (``controller/defrag.py``) held against the
reference's, and on a GPU grid.

On ``v5e`` one node's 2x4 chips are filled with seeded 1x1 grants and
carved so that one survivor sits in each 2x2 quad; a 2x2 then waits on
capacity. The reference's ``Controller`` + ``Repacker`` + ``NodeAgent``
and the port's (over the ``TpuShim`` of ``test_torch_agent``) run on
their informer caches, stepped by hand: every repacker pass, agent
reconcile and controller reconcile in one order on both sides, the
caches settled after each write. The plans, the migrations, the CR and
pod states after each step and the journal's reasons must be equal. The
control carves another seed.

On a GPU (``FakeGpuBackend``, MIG on) a 1g.10gb at slot 0 blocks a
pending 4g.40gb (start slot 0 only): the repacker moves it to slot 4 and
the 4g.40gb is granted. The control parses profiles by the reference's
TPU rule, which takes no MIG name: no plan, and the pod waits.
"""

import time

import numpy as np
import pytest

from instaslice_tpu import faults as jfaults
from instaslice_tpu.agent import reconciler as jagent
from instaslice_tpu.api import constants as jconst
from instaslice_tpu.controller import defrag as jdefrag
from instaslice_tpu.controller import reconciler as jctl
from instaslice_tpu.device.fake import FakeTpuBackend
from instaslice_tpu.kube import fake as jfake
from instaslice_tpu.obs import journal as jjournal
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.agent import reconciler as tagent
from instaslice_tpu_torch.api import constants as tconst
from instaslice_tpu_torch.api.types import AllocationStatus, TpuSlice
from instaslice_tpu_torch.controller import defrag as tdefrag
from instaslice_tpu_torch.controller import reconciler as tctl
from instaslice_tpu_torch.device.fake import FakeGpuBackend
from instaslice_tpu_torch.kube import fake as tfake
from instaslice_tpu_torch.obs import journal as tjournal
from instaslice_tpu_torch.topology.profiles import parse_profile_name
from test_torch_agent import TpuShim
from test_torch_controller import norm, pod_manifest

NS = "instaslice-tpu-system"
NODE = "node-0"

SIDES = {
    "ref": dict(fake=jfake, ctl=jctl, defrag=jdefrag, agent=jagent,
                faults=jfaults, journal=jjournal, const=jconst,
                backend=lambda: FakeTpuBackend("v5e")),
    "port": dict(fake=tfake, ctl=tctl, defrag=tdefrag, agent=tagent,
                 faults=tfaults, journal=tjournal, const=tconst,
                 backend=lambda: TpuShim(FakeTpuBackend("v5e"))),
}


class Stepped:
    """A controller on its informer caches (the repacker reads nothing
    else), a repacker and one agent per node, all stepped by hand: the
    informers run, the reconcile workers do not."""

    def __init__(self, side, backends, policy="first-fit") -> None:
        s = SIDES[side]
        self.s, self.kube = s, s["fake"].FakeKube()
        self.agents = {}
        for node, backend in backends.items():
            self.kube.create("Node", {
                "apiVersion": "v1", "kind": "Node",
                "metadata": {"name": node},
                "status": {"capacity": {}, "allocatable": {}}})
            self.agents[node] = s["agent"].NodeAgent(
                self.kube, backend, node, NS, health_interval=0)
            self.agents[node].boot()
        self.ctl = s["ctl"].Controller(self.kube, NS, policy=policy,
                                       deletion_grace_seconds=0,
                                       use_cache=True, workers=1)
        self.infs = list(self.ctl.manager._informers.values())
        for inf in self.infs:
            inf.start()
        assert self.ctl.manager.wait_synced(10.0)
        self.repacker = s["defrag"].Repacker(
            self.ctl, interval=3600, max_concurrent=2, cooldown=0.0,
            stuck_abort_seconds=0, frag_threshold=0.0)
        self.settle()

    def close(self) -> None:
        self.ctl.manager.stop()

    def settle(self, timeout: float = 10.0) -> None:
        """Wait until every informer holds what the apiserver holds."""
        def rvs(objs):
            return {(o["metadata"].get("namespace", ""),
                     o["metadata"]["name"]):
                    o["metadata"]["resourceVersion"] for o in objs}

        end = time.monotonic() + timeout
        while not all(rvs(inf.list()) == rvs(self.kube.list(
                inf.kind, namespace=inf.namespace)) for inf in self.infs):
            assert time.monotonic() < end, "informers never caught up"
            time.sleep(0.005)

    def submit(self, manifest) -> None:
        self.kube.create("Pod", manifest)
        self.settle()

    def rec(self, *names):
        out = []
        for n in names:
            out.append(self.ctl.reconcile(f"default/{n}"))
            self.settle()
        return out

    def agents_run(self) -> None:
        for node, agent in self.agents.items():
            agent.reconcile(node)
        self.settle()

    def repack(self):
        self.repacker.run_once()
        self.settle()
        r = self.repacker
        return (r.plans, r.migrations_done, r.migrations_failed,
                sorted(r._active))

    def grant(self, manifest) -> None:
        self.submit(manifest)
        name = manifest["metadata"]["name"]
        self.rec(name)
        self.agents_run()
        self.rec(name)

    def state(self):
        pods = {p["metadata"]["name"]: p["spec"].get("schedulingGates")
                for p in self.kube.list("Pod")}
        return norm({"crs": [self.kube.get("TpuSlice", NS, n)["spec"]
                             for n in self.agents],
                     "pods": pods})


def carve(seed):
    """The fillers to delete: all but one seeded survivor per 2x2 quad
    of a 2x4 host filled first-fit (f0..f7 in first-fit order)."""
    rng = np.random.default_rng(seed)
    keep = {int(rng.integers(0, 4)), 4 + int(rng.integers(0, 4))}
    return [i for i in range(8) if i not in keep]


def repack_scenario(side, seed=0):
    c = Stepped(side, {NODE: SIDES[side]["backend"]()})
    const = c.s["const"]
    journal = c.s["journal"].get_journal()
    seq0 = journal.events()[-1].seq if journal.events() else 0
    out = []
    try:
        for i in range(8):
            c.grant(pod_manifest(const, f"f{i}", profile="v5e-1x1"))
        boxes = {a["pods"][0]["podName"]: a["box"] for a in c.kube.get(
            "TpuSlice", NS, NODE)["spec"]["allocations"].values()}
        out.append(("filled", boxes))
        for i in carve(seed):
            c.kube.delete("Pod", "default", f"f{i}")
            c.settle()
            c.rec(f"f{i}")
        c.agents_run()
        out.append(("carved", c.state()))
        c.submit(pod_manifest(const, "big", profile="v5e-2x2"))
        out.append(("pending", c.rec("big"), c.ctl.pending_requests()))
        for tick in range(6):
            out.append((f"repack{tick}", c.repack(), c.state()))
            c.agents_run()
        out.append(("granted", c.rec("big"), c.state()))
        c.agents_run()
        out.append(("big", c.rec("big"), c.state()))
    finally:
        c.close()
    out.append(("reasons", [(e.component, e.reason)
                            for e in journal.events()
                            if e.seq > seq0 and e.component != "kube"]))
    return out


def test_repacker_on_v5e_equals_the_reference():
    got, want = repack_scenario("port"), repack_scenario("ref")
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    steps = {g[0]: g[1:] for g in got}
    assert steps["pending"][1] == {"default/big": "v5e-2x2"}
    plans, done, failed, active = steps["repack5"][0]
    assert plans >= 1 and done >= 1 and failed == 0 and active == []
    final = steps["big"][1]
    assert final["pods"]["big"] == []
    (big,) = [a for a in final["crs"][0]["allocations"].values()
              if a["pods"][0]["podName"] == "big"]
    assert big["status"] == "ungated"
    reasons = [r for _, r in steps["reasons"][0]]
    for r in ("RepackPlanned", "RepackMigrating", "RepackDone"):
        assert r in reasons, r


def test_repacker_on_v5e_control_another_carve_differs():
    assert carve(0) != carve(1)
    assert repack_scenario("port", seed=1) != repack_scenario("ref")


@pytest.mark.parametrize("rules", ["port", "plain"])
def test_repacker_on_a_gpu_clears_a_start_slot(rules, monkeypatch):
    if rules == "plain":
        monkeypatch.setattr(tdefrag, "parse_profile", parse_profile_name)
    c = Stepped("port", {NODE: FakeGpuBackend(gpu_count=1)})
    try:
        def pod(name, key):
            m = pod_manifest(tconst, name)
            m["spec"]["containers"][0]["resources"]["limits"][key] = "1"
            return m

        c.grant(pod("small", "nvidia.com/mig-1g.10gb"))
        c.submit(pod("big", "nvidia.com/mig-4g.40gb"))
        c.rec("big")
        assert c.ctl.pending_requests() == {"default/big": "4g.40gb"}
        for _ in range(4):
            c.repack()
            c.agents_run()
        c.rec("big")
        c.agents_run()
        c.rec("big")
        allocs = {a.pods[0].pod_name: a for a in TpuSlice.from_manifest(
            c.kube.get("TpuSlice", NS, NODE)).spec.allocations.values()}
        gates = c.kube.get("Pod", "default", "big")["spec"][
            "schedulingGates"]
        if rules == "plain":
            assert c.repacker.plans == 0 and "big" not in allocs
            assert gates == [{"name": tconst.GATE_NAME}]
            return
        assert (c.repacker.plans, c.repacker.migrations_done) == (1, 1)
        small, big = allocs["small"], allocs["big"]
        assert (small.box, small.attempt_epoch, small.status) == (
            "4,0,0+1x1x1", 2, AllocationStatus.UNGATED)
        assert (big.box, big.parts, big.status) == (
            "0,0,0+4x1x1", {"gpu0": (0, "0,0,0+4x1x1")},
            AllocationStatus.UNGATED)
        assert gates == []
        reasons = [e["reason"] for e in c.kube.list("Event")]
        assert {"RepackPlanned", "RepackMigrating", "RepackDone"} <= set(
            reasons)
        res = sorted((r.profile, r.start) for r in c.agents[
            NODE].backend.list_reservations())
        assert res == [("1g.10gb", 4), ("4g.40gb", 0)]
    finally:
        c.close()
