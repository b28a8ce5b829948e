"""The port's node agent (``instaslice_tpu_torch.agent``) held against
the reference's, and on the port's GPU grids.

On ``v5e`` the port's ``NodeAgent`` runs over a test-side shim that
presents the reference's ``FakeTpuBackend`` through the port's
``DeviceBackend``, and the reference's agent over the same kind of
backend, through one scenario driven step by step (boot, realize, a
device error -> ``failed``, teardown, a crash at ``agent.realize`` and a
restart that reaps the orphan, a ``FaultyKubeClient`` cut -> degraded
mode and its heal, a failed chip): after every step the CR manifests,
ConfigMaps, the Node's status, the mirrored Kubernetes Events and the
journal's reasons must be equal, with timestamps normalised. The
control runs the same scenario with one step left out.

On the port's GPU grids (``FakeGpuBackend``): a 3g.40gb on ``gpu1``
reserves GPU 1 at slot 0 and hands its ``MIG-`` UUID over, under the
part key ``gpu1``; a failed GPU 1 fails it while a failed GPU 0 (the
control for the memory-slot/GPU-index mix-up) leaves it alone; a
dangling MIG instance is adopted and never reaped; MIG off grants the
whole GPU; and (C5) a card without a MIG catalog is discovered, placed
and granted a whole GPU. ``tpuslice-gpu-agent --backend fake`` runs as
a subprocess against the port's HTTP apiserver and realizes an
allocation end to end.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from instaslice_tpu import faults as jfaults
from instaslice_tpu.agent import reconciler as jrec
from instaslice_tpu.api import types as jtypes
from instaslice_tpu.device import backend as jbackend
from instaslice_tpu.device.fake import FakeTpuBackend
from instaslice_tpu.kube import fake as jfake
from instaslice_tpu.obs import journal as jjournal
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.agent import reconciler as trec
from instaslice_tpu_torch.api import types as ttypes
from instaslice_tpu_torch.api.constants import POD_RESOURCE_PREFIX
from instaslice_tpu_torch.device import backend as tbackend
from instaslice_tpu_torch.device.fake import FakeGpuBackend
from instaslice_tpu_torch.kube import fake as tfake
from instaslice_tpu_torch.kube.client import update_with_retry
from instaslice_tpu_torch.kube.httptest import FakeApiServer
from instaslice_tpu_torch.obs import journal as tjournal
from instaslice_tpu_torch.topology import Occupancy, get_policy, mig
from instaslice_tpu_torch.topology.placement import Box

REPO = Path(__file__).resolve().parents[1]
NODE, NS = "node-a", "instaslice-tpu-system"
_ERRORS = {jbackend.ChipsBusy: tbackend.ChipsBusy,
           jbackend.SliceExists: tbackend.SliceExists,
           jbackend.SliceNotFound: tbackend.SliceNotFound,
           jbackend.DeviceError: tbackend.DeviceError}


class TpuShim(tbackend.DeviceBackend):
    """The reference's ``FakeTpuBackend`` through the port's
    ``DeviceBackend``: its inventory and reservations as they are, its
    errors as the port's, and ``reserve``'s ``profile``/``start`` (which
    a TPU generation never sets) refused."""

    name = "fake"

    def __init__(self, inner) -> None:
        self.inner = inner

    def __getattr__(self, name):  # fail_chip, inject_failures, ...
        return getattr(self.inner, name)

    def _call(self, fn, *args):
        try:
            return fn(*args)
        except jbackend.DeviceError as e:
            raise _ERRORS[type(e)](str(e)) from e

    def discover(self):
        return self._call(self.inner.discover)

    def reserve(self, slice_uuid, chip_ids, profile="", start=-1):
        assert (profile, start) == ("", -1), "a TPU reserve names chips only"
        return self._call(self.inner.reserve, slice_uuid, chip_ids)

    def release(self, slice_uuid):
        return self._call(self.inner.release, slice_uuid)

    def list_reservations(self):
        return self._call(self.inner.list_reservations)

    def chip_health(self):
        return self._call(self.inner.chip_health)


SIDES = {
    "ref": dict(fake=jfake, rec=jrec, types=jtypes, faults=jfaults,
                journal=jjournal, backend=lambda: FakeTpuBackend("v5e")),
    "port": dict(fake=tfake, rec=trec, types=ttypes, faults=tfaults,
                 journal=tjournal,
                 backend=lambda: TpuShim(FakeTpuBackend("v5e"))),
}
_TIMES = {"creationTimestamp", "deletionTimestamp", "ts", "firstTimestamp",
          "lastTimestamp"}


def norm(x):
    if isinstance(x, dict):
        return {k: ("T" if k in _TIMES else norm(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [norm(v) for v in x]
    return x


def alloc_dict(uid, box, local, status="creating"):
    return {"allocId": uid, "profile": "v5e-2x2", "torusGroup": NODE,
            "box": box, "parts": {NODE: {"workerId": 0, "localBox": local}},
            "pods": [{"podUUID": uid, "podName": f"pod-{uid}",
                      "namespace": "default", "workerId": 0}],
            "status": status, "createdAt": 1.0, "traceId": f"t-{uid}"}


def state(kube):
    """What the agent wrote: the CR, ConfigMaps, the Node and the
    mirrored Events (their random names dropped)."""
    events = [{k: v for k, v in e.items() if k != "metadata"}
              for e in kube.list("Event")]
    return norm({
        "cr": kube.get("TpuSlice", NS, NODE),
        "configmaps": kube.list("ConfigMap"),
        "node": kube.get("Node", "", NODE)["status"],
        "events": sorted(events, key=json.dumps),
    })


def scenario(side, skip=""):
    """The v5e scenario on ``side``'s agent, step by step; the state
    after each step and the journal's (component, reason) sequence.
    ``skip`` leaves one step out (the control)."""
    s = SIDES[side]
    kube = s["fake"].FakeKube()
    kube.create("Node", {"apiVersion": "v1", "kind": "Node",
                         "metadata": {"name": NODE},
                         "status": {"capacity": {}, "allocatable": {}}})
    backend = s["backend"]()
    journal = s["journal"].get_journal()
    seq0 = journal.events()[-1].seq if journal.events() else 0
    agent = s["rec"].NodeAgent(kube, backend, NODE, NS, health_interval=0)
    T = s["types"]
    out = []

    def step(name, fn):
        if name != skip:
            fn()
        out.append((name, state(kube)))

    def write(fn):
        def mut(obj):
            ts = T.TpuSlice.from_manifest(obj)
            fn(ts)
            return ts.to_manifest()
        update_with_retry(kube, "TpuSlice", NS, NODE, mut)

    def add(uid, box, local):
        write(lambda ts: ts.spec.allocations.__setitem__(
            uid, T.AllocationDetails.from_dict(alloc_dict(uid, box, local))))

    def set_status(uid, status):
        write(lambda ts: ts.spec.allocations[uid].set_status(
            T.AllocationStatus(status)))

    step("boot", agent.boot)
    step("realize", lambda: (add("a", "0,0,0+2x2x1", "0,0,0+2x2x1"),
                             add("b", "0,2,0+2x2x1", "0,2,0+2x2x1"),
                             agent.reconcile(NODE)))
    step("device_error", lambda: (backend.inject_failures("reserve"),
                                  add("c", "0,2,0+2x2x1", "0,2,0+2x2x1"),
                                  agent.reconcile(NODE)))
    step("teardown", lambda: (set_status("a", "created"),
                              set_status("a", "deleted"),
                              agent.reconcile(NODE)))

    def crash():
        s["faults"].set_crash_plan(s["faults"].CrashPlan(
            {"agent.realize": 1}))
        try:
            add("d", "0,0,0+2x2x1", "0,0,0+2x2x1")
            with pytest.raises(s["faults"].InjectedCrash):
                agent.reconcile(NODE)
        finally:
            s["faults"].set_crash_plan(None)
        write(lambda ts: ts.spec.allocations.pop("d"))

    step("crash", crash)
    restarted = s["rec"].NodeAgent(kube, backend, NODE, NS,
                                   health_interval=0)
    step("restart", restarted.boot)

    plan = s["faults"].FaultPlan(seed=0).site(
        "kube.request", probability=1.0, kinds=("conn-reset",))
    cut = s["rec"].NodeAgent(s["faults"].FaultyKubeClient(kube, plan),
                             backend, NODE, NS, health_interval=0)

    def partition():
        out.append(("retry", cut.reconcile(NODE), cut.degraded))

    def heal():
        plan.sites.clear()
        out.append(("healed", cut.reconcile(NODE), cut.degraded))

    step("partition", partition)
    step("heal", heal)
    step("chip_fails", lambda: (backend.fail_chip(5),
                                cut.reconcile(trec.HEALTH_KEY)))
    reasons = [(e.component, e.reason) for e in journal.events()
               if e.seq > seq0 and e.component != "kube"]
    out.append(("reasons", reasons))
    out.append(("reservations", sorted(
        (r.slice_uuid, tuple(r.chip_ids))
        for r in backend.list_reservations())))
    return out


def test_agent_on_v5e_equals_the_reference():
    got, want = scenario("port"), scenario("ref")
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    steps = dict((g[0], g[1:]) for g in got)
    cr = steps["realize"][0]["cr"]
    assert sorted(cr["spec"]["prepared"]) == ["sl-a", "sl-b"]
    assert steps["device_error"][0]["cr"]["spec"]["allocations"]["c"][
        "status"] == "failed"
    assert "a" not in steps["teardown"][0]["cr"]["spec"]["allocations"]
    assert steps["retry"] == (1.0, True) and steps["healed"] == (None,
                                                                 False)
    assert steps["reservations"] == ([("sl-b", (4, 5, 6, 7))],)
    failed = steps["chip_fails"][0]["cr"]
    assert failed["status"]["unhealthyChips"] == [5]
    assert failed["spec"]["allocations"]["b"]["status"] == "failed"
    reasons = [r for _, r in steps["reasons"][0]]
    assert ("agent-node-a", "OrphanReaped") in steps["reasons"][0]
    for want_reason in ("SliceRealized", "SliceRealizeFailed",
                        "SliceTornDown", "OrphanReaped",
                        "ApiServerUnreachable", "DegradedModeEntered",
                        "DegradedModeExited", "ChipUnhealthy"):
        assert want_reason in reasons


def test_agent_on_v5e_control_one_step_left_out_differs():
    assert scenario("port", skip="chip_fails") != scenario("ref")


# ------------------------------------------------------- the GPU grid

def gpu_node(backend, health_interval=0):
    kube = tfake.FakeKube()
    kube.create("Node", {"apiVersion": "v1", "kind": "Node",
                         "metadata": {"name": NODE},
                         "status": {"capacity": {}, "allocatable": {}}})
    agent = trec.NodeAgent(kube, backend, NODE, NS,
                           health_interval=health_interval)
    agent.boot()
    return kube, agent


def cr(kube):
    return ttypes.TpuSlice.from_manifest(kube.get("TpuSlice", NS, NODE))


def place(kube, profile, uid, taken=()):
    """First-fit of ``profile`` on the CR's grid, its prepared boxes and
    ``taken`` occupied, written as a ``creating`` allocation."""
    ts = cr(kube)
    group = mig.gpu_group(len(ts.spec.chips), ts.spec.generation)
    occ = Occupancy(group)
    for p in ts.spec.prepared.values():
        occ.occupy(Box.from_key(p.box))
    for box in taken:
        occ.occupy(box)
    want = (mig.whole_gpu(ts.spec.generation) if profile == "gpu"
            else mig.parse_mig_profile(profile, ts.spec.generation))
    pl = get_policy("first-fit").choose(group, want, occ)
    assert pl is not None
    alloc = ttypes.AllocationDetails.from_placement(
        pl, [ttypes.PodRef(uid, f"pod-{uid}", "default")])

    def mut(obj):
        t = ttypes.TpuSlice.from_manifest(obj)
        t.spec.allocations[uid] = alloc
        return t.to_manifest()

    update_with_retry(kube, "TpuSlice", NS, NODE, mut)
    return alloc


def test_mig_grant_on_gpu1_reserves_gpu1_and_hands_over_its_uuid():
    backend = FakeGpuBackend(gpu_count=2)
    kube, agent = gpu_node(backend)
    alloc = place(kube, "3g.40gb", "u1", taken=[mig.slot_box(0, 0, 8)])
    assert alloc.parts == {"gpu1": (0, "0,0,0+4x1x1")}
    agent.reconcile(NODE)
    (res,) = backend.list_reservations()
    assert (res.slice_uuid, res.chip_ids, res.profile, res.start) == \
        ("sl-u1", (1,), "3g.40gb", 0)
    cm = kube.get("ConfigMap", "default", "pod-u1")["data"]
    assert cm["CUDA_VISIBLE_DEVICES"] == res.device_uuids[0]
    assert res.device_uuids[0].startswith("MIG-")
    a = cr(kube).spec.allocations["u1"]
    assert a.realized_on == ["gpu1"] and a.fully_realized()
    part = cr(kube).spec.prepared["sl-u1"].parts["gpu1"]
    assert (part.node_name, part.chip_ids, part.device_handle) == \
        (NODE, [1], "sl-u1")
    node = kube.get("Node", "", NODE)["status"]
    assert node["capacity"][f"{POD_RESOURCE_PREFIX}pod-u1"] == "1"
    # the local chip ids of the part's box are memory slots, not GPUs
    assert a.local_chip_ids("gpu1", (8, 1, 1)) == [0, 1, 2, 3]


def test_a_reserve_already_live_hands_over_the_live_uuids():
    backend = FakeGpuBackend(gpu_count=2)
    kube, agent = gpu_node(backend)
    place(kube, "3g.40gb", "u1")
    agent.reconcile(NODE)
    uuid = kube.get("ConfigMap", "default", "pod-u1")["data"][
        "CUDA_VISIBLE_DEVICES"]
    kube.delete("ConfigMap", "default", "pod-u1")

    def forget(obj):  # a crash between the reserve and the record
        t = ttypes.TpuSlice.from_manifest(obj)
        t.spec.allocations["u1"].realized_on = []
        return t.to_manifest()

    update_with_retry(kube, "TpuSlice", NS, NODE, forget)
    agent.reconcile(NODE)
    assert kube.get("ConfigMap", "default", "pod-u1")["data"][
        "CUDA_VISIBLE_DEVICES"] == uuid
    assert len(backend.list_reservations()) == 1


@pytest.mark.parametrize("failed_gpu,fails", [(1, True), (0, False)])
def test_a_failed_gpu_fails_only_its_allocations(failed_gpu, fails):
    backend = FakeGpuBackend(gpu_count=2)
    kube, agent = gpu_node(backend)
    place(kube, "3g.40gb", "u1", taken=[mig.slot_box(0, 0, 8)])
    agent.reconcile(NODE)
    backend.fail_chip(failed_gpu)
    agent.reconcile(trec.HEALTH_KEY)
    ts = cr(kube)
    assert ts.status.unhealthy_chips == [failed_gpu]
    status = ts.spec.allocations["u1"].status
    assert (status == ttypes.AllocationStatus.FAILED) == fails
    if fails:
        assert "chips [1] unhealthy" in ts.spec.allocations["u1"].message


def test_a_dangling_mig_instance_is_adopted_and_never_reaped():
    backend = FakeGpuBackend(gpu_count=2)
    snap = backend.snapshot()
    backend.reserve("outside", [0], "1g.10gb", 3)
    backend.restore(snap)            # the instance stays, unrecorded
    (d,) = backend.dangling()
    kube, agent = gpu_node(backend)
    prep = cr(kube).spec.prepared[d.device_uuids[0]]
    assert (prep.pod_uuid, prep.box, list(prep.parts)) == \
        ("", "3,0,0+1x1x1", ["gpu0"])
    assert prep.parts["gpu0"].chip_ids == [0]
    # a restart's boot sweep keeps it: not ours to reap
    trec.NodeAgent(kube, backend, NODE, NS, health_interval=0).boot()
    assert d.device_uuids[0] in cr(kube).spec.prepared
    assert backend.dangling() == [d]
    # and placement counts its slot occupied: a 4g.40gb (start 0 only)
    # goes to GPU 1
    assert place(kube, "4g.40gb", "u2").parts == {"gpu1": (0,
                                                           "0,0,0+4x1x1")}


def test_an_orphan_of_ours_is_reaped_at_boot():
    backend = FakeGpuBackend(gpu_count=1)
    kube, agent = gpu_node(backend)
    backend.reserve("sl-gone", [0], "3g.40gb", 4)
    trec.NodeAgent(kube, backend, NODE, NS, health_interval=0).boot()
    assert backend.list_reservations() == [] and backend.dangling() == []


def test_mig_off_grants_the_whole_gpu():
    backend = FakeGpuBackend(gpu_count=2, mig=False)
    kube, agent = gpu_node(backend)
    alloc = place(kube, "gpu", "u1")
    assert alloc.parts == {"gpu0": (0, "0,0,0+8x1x1")}
    agent.reconcile(NODE)
    (res,) = backend.list_reservations()
    assert (res.chip_ids, res.profile, res.device_uuids[0][:4]) == \
        ((0,), "", "GPU-")
    assert kube.get("ConfigMap", "default", "pod-u1")["data"][
        "CUDA_VISIBLE_DEVICES"] == res.device_uuids[0]


def test_device_faults_in_front_of_the_gpu_backend():
    plan = tfaults.FaultPlan(seed=0).site("device.reserve", at_calls=[1])
    backend = tfaults.FaultyBackend(FakeGpuBackend(gpu_count=1), plan)
    kube, agent = gpu_node(backend)
    first = place(kube, "3g.40gb", "u1")
    place(kube, "3g.40gb", "u2", taken=[first.global_box()])
    agent.reconcile(NODE)
    ts = cr(kube)
    assert ts.spec.allocations["u1"].status == \
        ttypes.AllocationStatus.FAILED
    (res,) = backend.list_reservations()
    assert (res.slice_uuid, res.profile, res.start) == ("sl-u2", "3g.40gb",
                                                        4)


def c5_grant(generation):
    """A node of one card of ``generation`` discovered, placed first-fit
    (the whole GPU) and granted by the agent."""
    backend = FakeGpuBackend(gpu_count=1, mig=False, generation=generation)
    kube, agent = gpu_node(backend)
    ts = cr(kube)
    alloc = place(kube, "gpu", "u1")
    agent.reconcile(NODE)
    return backend, kube, ts, alloc


def test_c5_a_card_without_a_mig_catalog_is_granted_a_whole_gpu():
    backend, kube, ts, alloc = c5_grant("")
    assert backend.discover().generation == ""
    assert ts.spec.generation == mig.WHOLE_GPU_GRID
    assert [p["name"] for p in ts.spec.profiles] == ["gpu"]
    assert ts.spec.chips == {"0": "/dev/nvidia0"}
    assert (ts.spec.host_offset, ts.spec.torus_group) == ((0, 0, 0), NODE)
    assert alloc.profile == "gpu" and alloc.parts == {
        "gpu0": (0, "0,0,0+8x1x1")}
    (res,) = backend.list_reservations()
    assert (res.chip_ids, res.profile) == ((0,), "")
    assert kube.get("ConfigMap", "default", "pod-u1")["data"][
        "CUDA_VISIBLE_DEVICES"] == res.device_uuids[0]
    assert mig.whole_gpu("") is mig.whole_gpu(mig.WHOLE_GPU_GRID)
    assert mig.gpu_group(2, "").generation.name == mig.WHOLE_GPU_GRID
    with pytest.raises(tbackend.DeviceError):
        backend.reserve("x", [0], "3g.40gb", 0)


def test_c5_control_an_80gb_card_still_takes_mig_profiles():
    backend = FakeGpuBackend(gpu_count=1)
    kube, agent = gpu_node(backend)
    ts = cr(kube)
    assert ts.spec.generation == mig.H100_80GB
    assert [p["name"] for p in ts.spec.profiles] == [
        p.name for p in mig.H100_80GB_PROFILES] + ["gpu"]
    place(kube, "3g.40gb", "u1")
    agent.reconcile(NODE)
    (res,) = backend.list_reservations()
    assert (res.profile, res.start) == ("3g.40gb", 0)


# --------------------------------------------- the CLI, as a process

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _until(fn, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError("timed out")


def test_agent_main_fake_backend_realizes_over_http(tmp_path):
    kube = tfake.FakeKube()
    kube.create("Node", {"apiVersion": "v1", "kind": "Node",
                         "metadata": {"name": NODE},
                         "status": {"capacity": {}, "allocatable": {}}})
    with FakeApiServer(kube) as srv:
        srv.handler.token_validator = lambda t: t == "tok"
        cfg = tmp_path / "kubeconfig.json"
        cfg.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config", "current-context": "c",
            "clusters": [{"name": "c", "cluster": {"server": srv.url}}],
            "users": [{"name": "u", "user": {"token": "tok"}}],
            "contexts": [{"name": "c", "context": {"cluster": "c",
                                                   "user": "u"}}]}))
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("TPUSLICE_CRASH_AT", None)
        proc = subprocess.Popen(
            [sys.executable, "-m", "instaslice_tpu_torch.cli.agent_main",
             "--node-name", NODE, "--namespace", NS, "--backend", "fake",
             "--kubeconfig", str(cfg), "--metrics-bind-address",
             "127.0.0.1:0", "--health-probe-bind-address",
             f"127.0.0.1:{port}"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            def published():
                assert proc.poll() is None, proc.stdout.read()
                try:
                    return cr(kube)
                except Exception:  # noqa: BLE001 - not there yet
                    return None

            ts = _until(published)
            assert ts.spec.generation == mig.H100_80GB
            place(kube, "3g.40gb", "u1")

            def configmap():
                try:
                    return kube.get("ConfigMap", "default", "pod-u1")
                except Exception:  # noqa: BLE001 - not there yet
                    return None

            cm = _until(configmap)
            assert cm["data"]["CUDA_VISIBLE_DEVICES"].startswith("MIG-")
            _until(lambda: cr(kube).spec.allocations["u1"].realized_on
                   == ["gpu0"])
        finally:
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out


def test_agent_main_refuses_backends_of_the_reference():
    from instaslice_tpu_torch.cli import agent_main

    with pytest.raises(SystemExit):
        agent_main.build_parser().parse_args(
            ["--node-name", "n", "--backend", "cloudtpu"])
    args = agent_main.build_parser().parse_args(["--node-name", "n"])
    assert args.backend == "auto"
