"""The port's simulator (``instaslice_tpu_torch/sim.py``) on GPU nodes.

- **The lifecycle against the reference's.** One script runs on both
  sims over HTTP, the reference's on v5e and the port's on h100-80gb:
  a grant, a delete inside the grace, a device failure retried on the
  other node, ``restart_controller`` and ``restart_agent`` mid-grant, and
  a ``controller>apiserver`` partition healed. Each pod's phase sequence
  and the reasons its journal records must be equal.
- **The GPU specifics**, each rule beside a control that puts the
  reference's rule back and misses: parts keyed ``gpu<i>``; the
  ConfigMap's ``CUDA_VISIBLE_DEVICES`` the backend's ``MIG-`` UUID; 16
  3g.40gb on one node of 8 GPUs and a 17th waiting with ``NoCapacity``;
  ``fail_chip(1)`` blocking GPU 1 only; a GPU node its own group (the
  reference's shared torus places nothing); the device resource
  ``nvidia.com/mig-<profile>`` (``nvidia.com/gpu``) and the kubelet play
  over the hand-written wire (the reference's ``google.com/tpu-`` never
  reaches the plugin); fleet mode's CRs from each node's own backend
  (the reference's 8 chips a host and its reservation stand-in).
"""

import time

import pytest

from instaslice_tpu_torch.agent import discovery
from instaslice_tpu_torch.api.constants import (
    CHIPS_ANNOTATION,
    DEVICE_PATHS_ANNOTATION,
    KUBELET_ENV_CHIPS_ANNOTATION,
    REASON_NO_CAPACITY,
    SLICE_DEVICE_ANNOTATION,
)
from instaslice_tpu_torch.api.types import TpuSlice
from instaslice_tpu_torch.controller import gpugrid
from instaslice_tpu_torch.obs.journal import get_journal
from instaslice_tpu_torch.sim import SimCluster
from instaslice_tpu_torch import sim as tsim
from instaslice_tpu_torch.topology import mig
from instaslice_tpu_torch.topology.placement import Box

NS = "instaslice-tpu-system"


def _until(fn, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.02)
    return fn()


# ------------------------------------------------ lifecycle vs reference


def _awaiting_placement(journal, seq0):
    """True while some pod's last Admitted/Placed record is Admitted: the
    controller has taken the pod and not yet recorded where it put it."""
    last = {}
    for e in journal.events(since_seq=seq0):
        if e.reason in ("Admitted", "Placed"):
            last[e.object_ref] = e.reason
    return "Admitted" in last.values()


def _reserve_after_placed(backend, journal, seq0):
    """The controller records Placed only when its CR write has returned,
    while the agent reacts to the write as soon as its watch delivers it.
    A refused reserve records SliceRealizeFailed with no request in
    between, so under load it can land first. Each reserve on this node's
    device therefore waits until the placement it realizes is recorded,
    which fixes the two components' order in the journal on both sims."""
    reserve = backend.reserve

    def gated(*args, **kwargs):
        _until(lambda: not _awaiting_placement(journal, seq0), 10.0)
        return reserve(*args, **kwargs)

    backend.reserve = gated


def _deleting(c, pod):
    """The pod's deletionTimestamp while the pod is still there."""
    from instaslice_tpu.kube.client import NotFound as RefNotFound
    from instaslice_tpu_torch.kube.client import NotFound

    try:
        return c.pod(pod)["metadata"].get("deletionTimestamp")
    except (NotFound, RefNotFound):
        return None


def _cut_off(plan):
    """The partition has refused the controller at least once."""
    return any(r["link"] == "controller>apiserver" and r["fired"]
               for r in plan.stats())


def lifecycle(sim_cls, journal, plan, generation, profile, landed):
    """The script. ``landed(sim, pod)`` names the node a pod's slice is
    on. Returns {pod: (phases, journal reasons)} and the script's facts.
    Each sample waits on the state it reads, not on the clock, so the
    run holds while other processes load the machine."""
    seq0 = max([e.seq for e in journal.events()], default=0)
    phases = {}
    facts = []

    def note(pod, phase):
        phases.setdefault(pod, []).append(phase)

    with sim_cls(n_nodes=2, generation=generation, transport="http",
                 deletion_grace_seconds=2.0, policy="first-fit",
                 nemesis=plan) as c:
        for backend in c.backends.values():
            _reserve_after_placed(backend, journal, seq0)
        # grant
        note("p1", c.submit("p1", profile)["status"]["phase"])
        note("p1", "Running" if c.wait_phase("p1", "Running", 20) else "?")
        facts.append(("p1 on", landed(c, "p1")))
        # delete: the pod stays through the grace, then goes
        c.delete_pod("p1")
        note("p1", c.pod_phase("p1"))
        _until(lambda: _deleting(c, "p1"))
        note("p1", c.pod_phase("p1"))
        note("p1", "Gone" if c.wait_gone("p1", 20) else "?")
        facts.append(("erased", _until(lambda: not c.allocations())))
        # a device failure on the node the slice is placed on first
        c.backends["node-0"].inject_failures("reserve", 1)
        note("p2", c.submit("p2", profile)["status"]["phase"])
        note("p2", "Running" if c.wait_phase("p2", "Running", 20) else "?")
        facts.append(("p2 on", landed(c, "p2")))
        # the controller restarted mid-grant
        note("p3", c.submit("p3", profile)["status"]["phase"])
        c.restart_controller()
        note("p3", "Running" if c.wait_phase("p3", "Running", 20) else "?")
        # every agent restarted mid-grant
        note("p4", c.submit("p4", profile)["status"]["phase"])
        for node in ("node-0", "node-1"):
            c.restart_agent(node)
        note("p4", "Running" if c.wait_phase("p4", "Running", 20) else "?")
        # the controller cut off the apiserver, then healed
        plan.partition("controller", "apiserver")
        note("p5", c.submit("p5", profile)["status"]["phase"])
        _until(lambda: _cut_off(plan))
        note("p5", c.pod_phase("p5"))
        plan.heal()
        note("p5", "Running" if c.wait_phase("p5", "Running", 30) else "?")
        for pod in ("p2", "p3", "p4", "p5"):
            c.delete_pod(pod)
        for pod in ("p2", "p3", "p4", "p5"):
            note(pod, "Gone" if c.wait_gone(pod, 20) else "?")
        facts.append(("all erased", _until(lambda: not c.allocations())))
        facts.append(("reservations", sum(
            len(b.list_reservations()) for b in c.backends.values())))
    reasons = {}
    for e in journal.events(since_seq=seq0):
        if e.object_ref.startswith("Pod/default/"):
            reasons.setdefault(e.object_ref.split("/")[-1], []).append(
                e.reason)
    return {p: (phases[p], reasons.get(p, [])) for p in phases}, facts


def _ref_landed(c, pod):
    for a in c.allocations().values():
        if a["pods"][0]["podName"] == pod:
            return sorted(a["parts"])
    return None


def _port_landed(c, pod):
    for a in c.allocations().values():
        if a["pods"][0]["podName"] == pod:
            return [a["torusGroup"]]
    return None


def test_lifecycle_equals_the_reference():
    from instaslice_tpu.faults.netchaos import NemesisPlan as RefPlan
    from instaslice_tpu.obs.journal import get_journal as ref_journal
    from instaslice_tpu.sim import SimCluster as RefSim
    from instaslice_tpu_torch.faults import NemesisPlan

    want, want_facts = lifecycle(RefSim, ref_journal(), RefPlan(7), "v5e",
                                 "v5e-2x2", _ref_landed)
    got, facts = lifecycle(SimCluster, get_journal(), NemesisPlan(7),
                           "h100-80gb", "3g.40gb", _port_landed)
    assert got == want
    assert facts == want_facts
    assert facts == [("p1 on", ["node-0"]), ("erased", True),
                     ("p2 on", ["node-1"]), ("all erased", True),
                     ("reservations", 0)]
    assert got["p1"][0] == ["Pending", "Running", "Running", "Running",
                            "Gone"]
    assert got["p5"][0] == ["Pending", "Pending", "Running", "Gone"]
    assert {"Admitted", "Placed", "Ungated"} <= set(got["p1"][1])


# ------------------------------------------------------- GPU specifics


@pytest.fixture
def one_node():
    c = SimCluster(n_nodes=1, health_interval=0.05).start()
    yield c
    c.stop()


def _alloc(c, pod):
    for a in c.allocations().values():
        if a["pods"][0]["podName"] == pod:
            return a
    return None


def test_parts_are_gpus_and_the_configmap_names_the_mig_uuid(one_node):
    c = one_node
    for pod in ("a", "b", "c"):
        c.submit(pod, "3g.40gb")
    for pod in ("a", "b", "c"):
        assert c.wait_phase(pod, "Running", 20), pod
    res = {r.slice_uuid: r for r in c.backends["node-0"].list_reservations()}
    seen = set()
    for pod in ("a", "b", "c"):
        a = _alloc(c, pod)
        (part,) = a["parts"]
        assert part.startswith("gpu") and a["realizedOn"] == [part]
        gpu, start = mig.box_gpu_start(Box.from_key(a["box"]))
        assert part == f"gpu{gpu}" and start in (0, 4)
        seen.add((gpu, start))
        cm = c.configmap(pod)["data"]
        (r,) = [r for r in res.values() if tuple(r.chip_ids) == (gpu,)
                and r.start == start]
        assert cm["CUDA_VISIBLE_DEVICES"] == r.device_uuids[0]
        assert cm["CUDA_VISIBLE_DEVICES"].startswith("MIG-")
        assert cm["NVIDIA_VISIBLE_DEVICES"] == cm["CUDA_VISIBLE_DEVICES"]
    assert len(seen) == 3


def test_sixteen_3g40gb_on_eight_gpus_and_a_seventeenth_waits():
    with SimCluster(n_nodes=1, policy="first-fit") as c:
        pods = [f"p{i}" for i in range(17)]
        for pod in pods:
            c.submit(pod, "3g.40gb")
        # the controller's workers take the pods in any order: whichever
        # comes last waits
        assert _until(lambda: sum(c.pod_phase(p) == "Running"
                                  for p in pods) == 16, 30)
        (waiting,) = [p for p in pods if c.pod_phase(p) == "Pending"]
        running = [p for p in pods if p != waiting]
        boxes = sorted((_alloc(c, p)["box"]) for p in running)
        assert len(set(boxes)) == 16
        assert {tuple(_alloc(c, p)["parts"]) for p in running} == \
            {(f"gpu{g}",) for g in range(8)}
        ref = f"Pod/default/{waiting}"
        assert _until(lambda: get_journal().events(
            reason=REASON_NO_CAPACITY, object_ref=ref))
        assert _alloc(c, waiting) is None
        # a delete frees a slot: the waiting pod is granted
        c.delete_pod(running[0])
        assert c.wait_phase(waiting, "Running", 30)


def _fail_gpu1(c):
    c.backends["node-0"].fail_chip(1)
    assert _until(lambda: c.unhealthy_chips("node-0") == [1])
    for pod in ("h0", "h1", "h2"):
        c.submit(pod, "3g.40gb")


def test_fail_chip_blocks_that_gpu_only():
    pods = ("h0", "h1", "h2")
    with SimCluster(n_nodes=1, gpus_per_node=2, policy="first-fit",
                    health_interval=0.05) as c:
        _fail_gpu1(c)
        # the controller's workers take the pods in any order: two fill
        # GPU 0, whichever comes last waits
        assert _until(lambda: sum(c.pod_phase(p) == "Running"
                                  for p in pods) == 2)
        (waiting,) = [p for p in pods if c.pod_phase(p) == "Pending"]
        assert {tuple(_alloc(c, p)["parts"]) for p in pods
                if p != waiting} == {("gpu0",)}
        assert _until(lambda: get_journal().events(
            reason=REASON_NO_CAPACITY, object_ref=f"Pod/default/{waiting}"))
        assert _alloc(c, waiting) is None


def test_control_fail_chip_read_as_memory_slots(monkeypatch):
    """The reference's chip ids: unhealthy GPU 1 read as memory slot 1 of
    the grid, nothing of GPU 1 blocked: a pod is placed on it."""
    monkeypatch.setattr(gpugrid, "blocked_coords", lambda group, members: [])
    seq0 = max([e.seq for e in get_journal().events()], default=0)
    with SimCluster(n_nodes=1, gpus_per_node=2, policy="first-fit",
                    health_interval=0.05) as c:
        _fail_gpu1(c)
        placed = _until(lambda: [
            e for e in get_journal().events(reason="Placed", since_seq=seq0)
            if e.object_ref.startswith("Pod/default/h")
            and "gpu1" in e.message])
        assert placed


def test_a_gpu_node_is_its_own_group():
    with SimCluster(n_nodes=2) as c:
        for node in ("node-0", "node-1"):
            ts = TpuSlice.from_manifest(c.kube.get("TpuSlice", NS, node))
            assert (ts.spec.torus_group, tuple(ts.spec.host_offset)) == \
                (node, (0, 0, 0))
            assert len(ts.spec.chips) == 8
        c.submit("g", "3g.40gb")
        assert c.wait_phase("g", "Running", 20)


def test_control_shared_torus_places_nothing(monkeypatch):
    """The reference's topology: both nodes' CRs on one shared torus. A
    GPU group holds one CR, so the controller skips it and the pod
    waits."""
    real = discovery._build_gpu_grid

    def shared(node_name, namespace, inv, backend):
        ts = real(node_name, namespace, inv, backend)
        ts.spec.torus_group = "sim-torus"
        return ts

    monkeypatch.setattr(discovery, "_build_gpu_grid", shared)
    with SimCluster(n_nodes=2) as c:
        c.submit("g", "3g.40gb")
        assert not c.wait_phase("g", "Running", 2.0)


def test_pod_manifest_asks_for_nvidia_resources():
    c = SimCluster(n_nodes=1)
    try:
        for profile, key in (("3g.40gb", "nvidia.com/mig-3g.40gb"),
                             ("gpu", "nvidia.com/gpu")):
            m = c.pod_manifest("x", profile, device_resource=True)
            limits = m["spec"]["containers"][0]["resources"]["limits"]
            assert limits == {"tpu.instaslice.dev/x": "1", key: "1"}
            assert m["metadata"]["annotations"] == {
                "tpu.instaslice.dev/profile": profile}
            assert SimCluster._device_resource_profile(m) == profile
    finally:
        c.stop()


def _plugin_pods(c):
    for pod in ("dp-a", "dp-b"):
        c.submit(pod, "3g.40gb", device_resource=True)
    for pod in ("dp-a", "dp-b"):
        assert c.wait_phase(pod, "Running", 30), pod


def test_device_plugins_allocate_over_the_wire_matches_the_configmap():
    from instaslice_tpu_torch.deviceplugin.server import slice_device_id
    from instaslice_tpu_torch.deviceplugin.wire import (
        Channel,
        DevicePluginClient,
    )

    with SimCluster(n_nodes=1, device_plugins=True) as c:
        _plugin_pods(c)
        backend = c.backends["node-0"]
        inv = backend.discover()
        plugin = c.plugin_managers["node-0"].ensure_profile("3g.40gb")
        seen = {}
        for pod in ("dp-a", "dp-b"):
            ann = c.pod(pod)["metadata"]["annotations"]
            cm = c.configmap(pod)["data"]
            dev = ann[SLICE_DEVICE_ANNOTATION]
            with Channel(f"unix://{plugin.socket_path}") as ch:
                env = DevicePluginClient(ch).allocate(
                    [slice_device_id(dev)]).container_responses[0].envs
            gpu = int(ann[CHIPS_ANNOTATION])
            assert ann[KUBELET_ENV_CHIPS_ANNOTATION] == str(gpu)
            assert ann[DEVICE_PATHS_ANNOTATION].split(",")[0] == \
                inv.chip_paths[gpu]
            seen[pod] = (dev, env["CUDA_VISIBLE_DEVICES"])
        # kubelet's pick is authoritative: each pod's env names SOME
        # granted slice, the two disjoint, together every reservation,
        # and each the same device its ConfigMap would hand a pod there
        uuids = {r.slice_uuid: r.device_uuids[0]
                 for r in backend.list_reservations()}
        assert {d for d, _ in seen.values()} == set(uuids)
        assert {u for _, u in seen.values()} == set(uuids.values())
        cms = {c.configmap(p)["data"]["CUDA_VISIBLE_DEVICES"]
               for p in ("dp-a", "dp-b")}
        assert cms == set(uuids.values())
        for d, u in seen.values():
            assert uuids[d] == u
        c.delete_pod("dp-a")
        assert c.wait_gone("dp-a", 20)


def test_control_device_resource_by_the_reference_rule(monkeypatch):
    """The reference's device resource, ``google.com/tpu-<profile>``: no
    plugin serves it, so no kubelet annotations reach the pod."""
    monkeypatch.setattr(tsim, "device_resource_name",
                        lambda profile: f"google.com/tpu-{profile}")
    with SimCluster(n_nodes=1, device_plugins=True) as c:
        _plugin_pods(c)
        for pod in ("dp-a", "dp-b"):
            ann = c.pod(pod)["metadata"]["annotations"]
            assert DEVICE_PATHS_ANNOTATION not in ann


def test_fleet_mode_publishes_each_nodes_gpus_and_grants():
    with SimCluster(n_nodes=200, gpus_per_node=2, fleet_agents=True,
                    agent_workers=8, health_interval=0) as c:
        crs = c.kube.list("TpuSlice", namespace=NS)
        assert len(crs) == 200
        assert {len(m["spec"]["chips"]) for m in crs} == {2}
        assert {m["spec"]["torusGroup"] for m in crs} == \
            {m["metadata"]["name"] for m in crs}
        pods = [f"f{i}" for i in range(50)]
        for pod in pods:
            c.submit(pod, "3g.40gb")
        for pod in pods:
            assert c.wait_phase(pod, "Running", 60), pod
        assert len(c.allocations()) == 50
        # lazily built agents: only nodes with grants have one
        assert 0 < len(c.fleet._agents) <= 50


def test_control_fleet_crs_by_the_reference_rule():
    """The reference's fleet CR: a generation's chips per host (memory
    slots on a GPU grid) and a reservation stand-in that the GPU grid's
    adoption cannot read."""
    from instaslice_tpu_torch.device.backend import NodeInventory
    from instaslice_tpu_torch.topology.grid import get_generation

    class NoReservations:
        def list_reservations(self):
            return []

    n = get_generation("h100-80gb").chips_per_host
    inv = NodeInventory(generation="h100-80gb",
                        chip_paths={i: f"/dev/accel{i}" for i in range(n)},
                        source="fake")
    try:
        ts = discovery.build_tpuslice("node-0", NS, inv, NoReservations())
        assert len(ts.spec.chips) != 2
    except AttributeError:
        pass   # the stand-in lacks what the GPU grid's adoption asks


def test_control_profile_annotation_by_the_reference_rule(monkeypatch):
    """The reference's annotation rule, ``parse_profile_name``: a GPU
    grid's name is malformed there, so the pod gets the error annotation
    and is never granted."""
    from instaslice_tpu_torch.api.constants import ERROR_ANNOTATION
    from instaslice_tpu_torch.controller import gates
    from instaslice_tpu_torch.topology import parse_profile_name

    monkeypatch.setattr(gates, "parse_profile", parse_profile_name)
    with SimCluster(n_nodes=1) as c:
        c.submit("bad", "3g.40gb")
        ann = _until(lambda: c.pod("bad")["metadata"].get(
            "annotations", {}).get(ERROR_ANNOTATION))
        assert "malformed profile name" in ann
        assert c.pod_phase("bad") == "Pending" and not c.allocations()
