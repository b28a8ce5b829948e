"""The port's controller on a node's GPU grid (``FakeGpuBackend``), with
the port's node agent: the rules of ``controller/gpugrid.py``, each
beside a control that copies the reference's rule and misses.

- A node of two GPUs with GPU 0 full (two 3g.40gb): a third lands on
  ``gpu1``, its one part keyed ``gpu1``, its record in the node's CR,
  realized and ungated. The control, the reference's grid (one host
  keyed by the CR), sees one GPU: the pod waits.
- Two GPU nodes with in-flight grants at the same anchor: each node's
  occupancy holds its own, and a grant places. The control, in-flight
  entries matched by host name, occupies both on both nodes: no
  placement.
- ``fail_chip(0)`` blocks GPU 0 and flags only GPU 0's grant;
  ``fail_chip(1)`` leaves a slot-0 grant on GPU 0 alone. The control,
  chip ids read as local memory slots, flags that grant and places on
  the failed GPU.
- A reserve that fails on one node is retried on the other: the failed
  node is avoided on all of its GPUs. The control, the reference's
  avoided tile (one GPU's slots), retries on the failed node's GPU 1.
- On a card without a MIG catalog (``generation=""``): ``nvidia.com/gpu``
  is granted a whole GPU; ``nvidia.com/mig-3g.40gb`` is never placed
  (``NoCapacity``); ``nvidia.com/mig-9g.99gb`` gets the error
  annotation. The control, the reference's generation filter, never
  grants the whole GPU there.
"""

import pytest

from instaslice_tpu_torch.agent import reconciler as tagent
from instaslice_tpu_torch.api.constants import (
    ERROR_ANNOTATION,
    FINALIZER,
    GATE_NAME,
    POD_RESOURCE_PREFIX,
    UNHEALTHY_ANNOTATION,
)
from instaslice_tpu_torch.api.types import AllocationStatus, TpuSlice
from instaslice_tpu_torch.controller import Controller, gpugrid
from instaslice_tpu_torch.device.fake import FakeGpuBackend
from instaslice_tpu_torch.kube.fake import FakeKube
from instaslice_tpu_torch.topology import mig
from instaslice_tpu_torch.topology.placement import Box, Occupancy

NS = "instaslice-tpu-system"


def plain_grid(monkeypatch):
    """The reference's grid: no GPU-grid rule anywhere."""
    monkeypatch.setattr(gpugrid, "is_gpu_grid", lambda gen: False)
    monkeypatch.setattr(gpugrid, "is_gpu_profile", lambda name: False)


def plain_inflight(monkeypatch):
    """The reference's in-flight overlay: entries matched by host name."""
    monkeypatch.setattr(gpugrid, "inflight_applies",
                        lambda group, nodes, gid: bool(nodes
                                                       & set(group.hosts)))


def plain_chips(monkeypatch):
    """The reference's chip ids: unhealthy chips read as the local chip
    ids of the part's box (memory slots here), and no GPU blocked."""
    def dead(alloc, slices):
        key = next(iter(alloc.parts))
        ids = set(alloc.local_chip_ids(key, (mig.SLOTS, 1, 1)))
        return {ts.name: sorted(set(ts.status.unhealthy_chips) & ids)
                for ts in slices if ts.name == alloc.torus_group
                and set(ts.status.unhealthy_chips) & ids}

    monkeypatch.setattr(gpugrid, "blocked_coords", lambda group, members: [])
    monkeypatch.setattr(gpugrid, "dead_chips", dead)


def plain_avoid(monkeypatch):
    """The reference's avoided node: the tile at its host offset, one
    GPU's slots here."""
    monkeypatch.setattr(gpugrid, "avoid_coords", lambda group: Box(
        (0, 0, 0), group.generation.host_bounds).coords())


def plain_filter(monkeypatch):
    """The reference's generation filter on requests."""
    monkeypatch.setattr(gpugrid, "group_profile",
                        lambda p, gen: p if p.generation == gen else None)


class Cluster:
    """Nodes of ``FakeGpuBackend`` cards with the port's agents, and the
    port's controller, driven step by step."""

    def __init__(self, **nodes) -> None:
        self.kube = FakeKube()
        self.backends, self.agents = {}, {}
        for name, backend in nodes.items():
            self.kube.create("Node", {
                "apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name},
                "status": {"capacity": {}, "allocatable": {}}})
            self.backends[name] = backend
            self.agents[name] = tagent.NodeAgent(self.kube, backend, name,
                                                 NS, health_interval=0)
            self.agents[name].boot()
        self.ctl = Controller(self.kube, NS, policy="first-fit",
                              deletion_grace_seconds=0, use_cache=False,
                              workers=1)

    def submit(self, name, key):
        self.kube.create("Pod", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"schedulingGates": [{"name": GATE_NAME}],
                     "containers": [{"name": "c", "resources": {"limits": {
                         key: "1", f"{POD_RESOURCE_PREFIX}{name}": "1"}}}]},
            "status": {"phase": "Pending"}})

    def grant(self, name, key):
        """Submit, place, realize on every node, ungate."""
        self.submit(name, key)
        self.ctl.reconcile(f"default/{name}")
        self.run_agents()
        self.ctl.reconcile(f"default/{name}")
        return self.pod(name)

    def run_agents(self):
        for name, agent in self.agents.items():
            agent.reconcile(name)

    def pod(self, name):
        return self.kube.get("Pod", "default", name)

    def cr(self, node):
        return TpuSlice.from_manifest(self.kube.get("TpuSlice", NS, node))

    def alloc(self, node, pod):
        (a,) = [a for a in self.cr(node).spec.allocations.values()
                if a.pods[0].pod_name == pod]
        return a

    def reasons(self, pod):
        """The reasons of the pod's mirrored Events, sorted."""
        return sorted(e["reason"] for e in self.kube.list("Event")
                      if e["involvedObject"]["name"] == pod)


@pytest.mark.parametrize("rules", ["port", "plain"])
def test_gpu0_full_a_third_grant_lands_on_gpu1(rules, monkeypatch):
    if rules == "plain":
        plain_grid(monkeypatch)
    c = Cluster(n0=FakeGpuBackend(gpu_count=2))
    for name in ("p0", "p1"):
        assert c.grant(name, "nvidia.com/mig-3g.40gb")["spec"][
            "schedulingGates"] == []
    pod = c.grant("p2", "nvidia.com/mig-3g.40gb")
    if rules == "plain":
        # the reference's grid is one host keyed by the CR: one GPU seen
        assert pod["spec"]["schedulingGates"] == [{"name": GATE_NAME}]
        assert "NoCapacity" in c.reasons("p2")
        assert {r.chip_ids for r in c.backends["n0"].list_reservations()} \
            == {(0,)}
        return
    a = c.alloc("n0", "p2")
    assert a.parts == {"gpu1": (0, "0,0,0+4x1x1")} and a.box == \
        "0,1,0+4x1x1"
    assert (a.torus_group, a.status, a.realized_on) == (
        "n0", AllocationStatus.UNGATED, ["gpu1"])
    assert pod["spec"]["schedulingGates"] == [] and pod["metadata"][
        "finalizers"] == [FINALIZER]
    res = {r.slice_uuid: (r.chip_ids, r.profile, r.start)
           for r in c.backends["n0"].list_reservations()}
    assert res[f"sl-{a.alloc_id}"] == ((1,), "3g.40gb", 0)
    cm = c.kube.get("ConfigMap", "default", "p2")["data"]
    assert cm["CUDA_VISIBLE_DEVICES"].startswith("MIG-")
    assert c.reasons("p2") == ["Admitted", "Placed", "SliceRealized",
                              "Ungated"]
    assert [a.parts for a in c.cr("n0").spec.allocations.values()] == [
        {"gpu0": (0, "0,0,0+4x1x1")}, {"gpu0": (0, "4,0,0+4x1x1")},
        {"gpu1": (0, "0,0,0+4x1x1")}]


@pytest.mark.parametrize("rules", ["port", "plain"])
def test_inflight_grants_on_two_nodes_at_one_anchor(rules, monkeypatch):
    if rules == "plain":
        plain_inflight(monkeypatch)
    c = Cluster(na=FakeGpuBackend(gpu_count=1),
                nb=FakeGpuBackend(gpu_count=1))
    box = mig.slot_box(0, 0, 4)
    c.ctl._inflight.update({"x": (box, frozenset({"gpu0"}), "na"),
                            "y": (box, frozenset({"gpu0"}), "nb")})
    groups = c.ctl._torus_groups(c.ctl._load_slices())
    with c.ctl._placement_lock:
        if rules == "plain":
            # node a's entry and node b's occupy one anchor on each node
            for gid, (group, members) in groups.items():
                with pytest.raises(ValueError):
                    c.ctl._occupancy(group, members)
        else:
            for gid, (group, members) in groups.items():
                occ = c.ctl._occupancy(group, members)
                assert occ.taken == set(box.coords())
    c.submit("p", "nvidia.com/mig-3g.40gb")
    c.ctl.reconcile("default/p")
    placed = [a for n in ("na", "nb")
              for a in c.cr(n).spec.allocations.values()]
    if rules == "plain":
        assert placed == [] and "NoCapacity" in c.reasons("p")
    else:
        (a,) = placed
        assert (a.torus_group, a.box) == ("na", "4,0,0+4x1x1")


@pytest.mark.parametrize("rules,failed", [("port", 0), ("port", 1),
                                          ("plain", 0), ("plain", 1)])
def test_a_failed_gpu_blocks_and_flags_only_its_grants(rules, failed,
                                                       monkeypatch):
    if rules == "plain":
        plain_chips(monkeypatch)
    backend = FakeGpuBackend(gpu_count=2)
    c = Cluster(n0=backend)
    c.grant("a", "nvidia.com/mig-3g.40gb")        # GPU 0, slot 0
    c.grant("b", "nvidia.com/mig-4g.40gb")        # start 0 only: GPU 1
    assert c.alloc("n0", "a").parts == {"gpu0": (0, "0,0,0+4x1x1")}
    assert c.alloc("n0", "b").parts == {"gpu1": (0, "0,0,0+4x1x1")}
    backend.fail_chip(failed)
    c.agents["n0"].reconcile(tagent.HEALTH_KEY)
    assert c.cr("n0").status.unhealthy_chips == [failed]
    for name in ("a", "b"):
        c.ctl.reconcile(f"default/{name}")
    flagged = {n: (c.pod(n)["metadata"].get("annotations") or {}).get(
        UNHEALTHY_ANNOTATION) for n in ("a", "b")}
    c.grant("c", "nvidia.com/mig-3g.40gb")
    where = c.alloc("n0", "c").parts
    if rules == "plain" and failed == 1:
        # GPU 1's index read as memory slot 1 of GPU 0: a is flagged
        assert flagged["a"] == "n0: chips [1] unhealthy"
        return
    if rules == "plain":
        # the failed GPU is still placeable
        assert where == {"gpu0": (0, "4,0,0+4x1x1")}
        return
    mine, other = ("a", "b") if failed == 0 else ("b", "a")
    assert flagged == {mine: f"n0: chips [{failed}] unhealthy",
                       other: None}
    assert "SliceDegraded" in c.reasons(mine)
    assert "SliceDegraded" not in c.reasons(other)
    # c goes around the failed GPU: GPU 1 slot 4, or GPU 0 slot 4
    assert where == ({"gpu1": (0, "4,0,0+4x1x1")} if failed == 0
                     else {"gpu0": (0, "4,0,0+4x1x1")})


@pytest.mark.parametrize("rules", ["port", "plain"])
def test_a_failed_reserve_is_retried_on_another_node(rules, monkeypatch):
    if rules == "plain":
        plain_avoid(monkeypatch)
    c = Cluster(na=FakeGpuBackend(gpu_count=2),
                nb=FakeGpuBackend(gpu_count=2))
    c.submit("p", "nvidia.com/mig-3g.40gb")
    c.ctl.reconcile("default/p")
    assert c.alloc("na", "p").parts == {"gpu0": (0, "0,0,0+4x1x1")}
    c.backends["na"].inject_failures("reserve")
    c.run_agents()                          # failed on na
    c.ctl.reconcile("default/p")            # Retrying: deleted, na avoided
    assert c.alloc("na", "p").status == AllocationStatus.DELETED
    c.run_agents()                          # na erases the record
    assert not c.cr("na").spec.allocations
    c.ctl.reconcile("default/p")
    c.run_agents()
    c.ctl.reconcile("default/p")
    assert "Retrying" in c.reasons("p")
    if rules == "plain":
        a = c.alloc("na", "p")
        assert a.parts == {"gpu1": (0, "0,0,0+4x1x1")}
        return
    assert not c.cr("na").spec.allocations
    a = c.alloc("nb", "p")
    assert (a.parts, a.status) == ({"gpu0": (0, "0,0,0+4x1x1")},
                                   AllocationStatus.UNGATED)
    assert c.pod("p")["spec"]["schedulingGates"] == []


@pytest.mark.parametrize("rules", ["port", "plain"])
def test_a_card_without_a_catalog_takes_a_whole_gpu_request_only(
        rules, monkeypatch):
    if rules == "plain":
        plain_filter(monkeypatch)
    backend = FakeGpuBackend(gpu_count=1, mig=False, generation="")
    c = Cluster(n0=backend)
    assert c.cr("n0").spec.generation == mig.WHOLE_GPU_GRID
    c.grant("mig", "nvidia.com/mig-3g.40gb")
    c.grant("bad", "nvidia.com/mig-9g.99gb")
    pod = c.grant("whole", "nvidia.com/gpu")
    # a MIG name is never placed on this card, and an unknown one is
    # the pod's error
    assert c.pod("mig")["spec"]["schedulingGates"] == [{"name": GATE_NAME}]
    assert c.reasons("mig") == ["Admitted", "NoCapacity"]
    bad = c.pod("bad")
    assert "9g.99gb" in bad["metadata"]["annotations"][ERROR_ANNOTATION]
    assert c.reasons("bad") == ["Rejected"] and bad["spec"][
        "schedulingGates"] == [{"name": GATE_NAME}]
    if rules == "plain":
        assert pod["spec"]["schedulingGates"] == [{"name": GATE_NAME}]
        assert backend.list_reservations() == []
        return
    a = c.alloc("n0", "whole")
    assert (a.profile, a.parts, a.status) == (
        "gpu", {"gpu0": (0, "0,0,0+8x1x1")}, AllocationStatus.UNGATED)
    assert pod["spec"]["schedulingGates"] == []
    (res,) = backend.list_reservations()
    assert (res.chip_ids, res.profile) == ((0,), "")
    assert c.kube.get("ConfigMap", "default", "whole")["data"][
        "CUDA_VISIBLE_DEVICES"] == res.device_uuids[0]


def test_gpu_rules_leave_every_tpu_generation_to_the_reference():
    from instaslice_tpu_torch.api.types import AllocationDetails, PodRef
    from instaslice_tpu_torch.topology import get_policy
    from instaslice_tpu_torch.topology.profiles import parse_profile_name

    v5e = parse_profile_name("v5e-2x2")
    assert not gpugrid.is_gpu_grid("v5e") and gpugrid.is_gpu_grid(
        mig.H100_80GB) and gpugrid.is_gpu_grid(mig.WHOLE_GPU_GRID)
    assert gpugrid.group_profile(v5e, "v5e") is v5e
    assert gpugrid.group_profile(v5e, "v5p") is None
    assert gpugrid.group_profile(v5e, mig.H100_80GB) is None
    whole = gpugrid.parse_profile("gpu")
    assert gpugrid.group_profile(whole, mig.WHOLE_GPU_GRID).generation == \
        mig.WHOLE_GPU_GRID
    assert gpugrid.group_profile(gpugrid.parse_profile("3g.40gb"),
                                 mig.WHOLE_GPU_GRID) is None
    group = mig.gpu_group(2, group_id="n0")
    pl = get_policy("first-fit").choose(
        group, gpugrid.parse_profile("3g.40gb"), Occupancy(group))
    alloc = AllocationDetails.from_placement(pl, [PodRef("u", "p", "d")])
    assert gpugrid.holders(alloc) == gpugrid.laggards(alloc) == ["n0"]
    assert list(alloc.parts) == ["gpu0"]
