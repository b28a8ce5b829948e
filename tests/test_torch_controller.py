"""The port's controller (``instaslice_tpu_torch.controller``) held
against the reference's on a TPU generation, and its CRD, constants and
gates.

On ``v5e`` the reference's ``Controller`` and ``NodeAgent`` run over the
reference's ``FakeKube`` and ``FakeTpuBackend``, and the port's over the
port's ``FakeKube`` and the ``TpuShim`` of ``test_torch_agent`` over the
same backend, through one sequence of pods driven step by step on two
nodes of one torus: a grant, a multi-host group that waits on capacity,
a device failure retried on the other node, a crash at
``controller.ungate`` and a restarted controller that finishes the
grant, deletion with grace, a crash at ``controller.write_allocation``
halfway through the group's fan-out and a restarted controller that
repairs it, a restart that changes nothing, and the group's deletion.
After every step the CR manifests, the pods' gates, finalizers and
annotations, the ConfigMaps, the Nodes' resources and the mirrored
Events must be equal, with timestamps and trace ids normalised, and so
must the journal's reasons. The control leaves one step out.
"""

import json
import time

import pytest

from instaslice_tpu import faults as jfaults
from instaslice_tpu.agent import reconciler as jagent
from instaslice_tpu.api import constants as jconst
from instaslice_tpu.api import crd as jcrd
from instaslice_tpu.controller import gates as jgates
from instaslice_tpu.controller import reconciler as jctl
from instaslice_tpu.device.fake import FakeTpuBackend
from instaslice_tpu.kube import fake as jfake
from instaslice_tpu.obs import journal as jjournal
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.agent import reconciler as tagent
from instaslice_tpu_torch.api import constants as tconst
from instaslice_tpu_torch.api import crd as tcrd
from instaslice_tpu_torch.controller import gates as tgates
from instaslice_tpu_torch.controller import reconciler as tctl
from instaslice_tpu_torch.kube import fake as tfake
from instaslice_tpu_torch.obs import journal as tjournal
from instaslice_tpu_torch.topology import mig
from test_torch_agent import TpuShim

NS = "instaslice-tpu-system"
NODES = ("node-0", "node-1")
GRACE = 0.2

SIDES = {
    "ref": dict(fake=jfake, ctl=jctl, agent=jagent, faults=jfaults,
                journal=jjournal, const=jconst,
                backend=lambda **kw: FakeTpuBackend("v5e", **kw)),
    "port": dict(fake=tfake, ctl=tctl, agent=tagent, faults=tfaults,
                 journal=tjournal, const=tconst,
                 backend=lambda **kw: TpuShim(FakeTpuBackend("v5e", **kw))),
}
_TIMES = {"creationTimestamp", "deletionTimestamp", "ts", "firstTimestamp",
          "lastTimestamp", "createdAt", "deletionRequestedAt", "traceId"}


def norm(x):
    if isinstance(x, dict):
        return {k: ("T" if k in _TIMES else norm(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [norm(v) for v in x]
    return x


def requeue(r):
    """A reconcile's requeue, with the grace's remainder (a clock
    reading) as ``"grace"``."""
    return r if r in (None, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0) else "grace"


def pod_manifest(const, name, profile="", limit="", group=""):
    ann = {const.PROFILE_ANNOTATION: profile} if profile else {}
    if group:
        ann.update({const.GROUP_ANNOTATION: group,
                    const.GROUP_SIZE_ANNOTATION: "2"})
    limits = {f"{const.POD_RESOURCE_PREFIX}{name}": "1"}
    if limit:
        limits[limit] = "1"
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "annotations": ann},
            "spec": {"schedulingGates": [{"name": const.GATE_NAME}],
                     "containers": [{"name": "c", "resources": {
                         "limits": limits}}]},
            "status": {"phase": "Pending"}}


def state(kube):
    """What the controller and the agents wrote: both CRs, the pods'
    gates, finalizers and annotations, ConfigMaps, the Nodes' resources
    and the mirrored Events (their random names dropped)."""
    events = [{k: v for k, v in e.items() if k != "metadata"}
              for e in kube.list("Event")]
    pods = {p["metadata"]["name"]: {
        "gates": p["spec"].get("schedulingGates"),
        "finalizers": p["metadata"].get("finalizers"),
        "annotations": p["metadata"].get("annotations"),
        "deleting": bool(p["metadata"].get("deletionTimestamp"))}
        for p in kube.list("Pod")}
    return norm({
        "crs": {n: kube.get("TpuSlice", NS, n) for n in NODES},
        "pods": pods,
        "configmaps": kube.list("ConfigMap"),
        "nodes": {n: kube.get("Node", "", n)["status"] for n in NODES},
        "events": sorted(events, key=json.dumps),
    })


def scenario(side, skip=""):
    """The v5e sequence on ``side``'s controller and agents, step by
    step: the state and the requeues after each step, then the
    journal's (component, reason) sequence and the reservations left.
    ``skip`` leaves one step out (the control)."""
    s = SIDES[side]
    const = s["const"]
    kube = s["fake"].FakeKube()
    backends = {}
    for i, n in enumerate(NODES):
        kube.create("Node", {"apiVersion": "v1", "kind": "Node",
                             "metadata": {"name": n},
                             "status": {"capacity": {}, "allocatable": {}}})
        backends[n] = s["backend"](host_offset=(2 * i, 0, 0),
                                   torus_group="torus")
    journal = s["journal"].get_journal()
    seq0 = journal.events()[-1].seq if journal.events() else 0
    agents = {n: s["agent"].NodeAgent(kube, backends[n], n, NS,
                                      health_interval=0) for n in NODES}

    def controller():
        return s["ctl"].Controller(kube, NS, policy="first-fit",
                                   deletion_grace_seconds=GRACE,
                                   use_cache=False, workers=1)

    ctl = [controller()]
    out = []

    def step(name, fn):
        got = None if name == skip else fn()
        out.append((name, got, state(kube)))

    def rec(*names):
        return [requeue(ctl[0].reconcile(f"default/{n}")) for n in names]

    def agents_run():
        for n in NODES:
            agents[n].reconcile(n)

    def crash_at(site, nth, fn):
        s["faults"].set_crash_plan(s["faults"].CrashPlan({site: nth}))
        try:
            with pytest.raises(s["faults"].InjectedCrash):
                fn()
        finally:
            s["faults"].set_crash_plan(None)
        ctl[0] = controller()            # the restarted process

    def boot():
        for n in NODES:
            agents[n].boot()

    def grant():
        kube.create("Pod", pod_manifest(const, "a", profile="v5e-2x2"))
        got = rec("a")
        agents_run()
        return got + rec("a")

    def no_capacity():
        for n in ("big-0", "big-1"):
            kube.create("Pod", pod_manifest(const, n, profile="v5e-4x4",
                                            group="grp"))
        return rec("big-0", "big-1", "big-0")

    def device_failure():
        kube.create("Pod", pod_manifest(const, "b",
                                        limit="google.com/tpu-v5e-2x2"))
        got = rec("b")
        cr = {n: kube.get("TpuSlice", NS, n)["spec"]["allocations"]
              for n in NODES}
        (node,) = [n for n in NODES if any(
            a["pods"][0]["podName"] == "b" for a in cr[n].values())]
        backends[node].inject_failures("reserve")
        agents_run()                     # the reserve fails: failed
        got += rec("b")                  # Retrying, deleted, node avoided
        agents_run()                     # the record erased
        got += rec("b")                  # placed on the other node
        agents_run()
        return got + rec("b") + [node]

    def crash_ungate():
        kube.create("Pod", pod_manifest(const, "d", profile="v5e-2x2"))
        got = rec("d")
        agents_run()
        crash_at("controller.ungate", 1, lambda: rec("d"))
        return got + rec("d")

    def deletion():
        for n in ("a", "b", "d"):
            try:
                kube.delete("Pod", "default", n)
            except s["fake"].NotFound:   # the control left it out
                pass
        got = rec("a", "b", "d")
        time.sleep(GRACE + 0.05)
        got += rec("a", "b", "d")
        agents_run()
        return got + rec("a", "b", "d")

    def crash_write():
        crash_at("controller.write_allocation", 2, lambda: rec("big-0"))
        got = rec("big-0")               # repairs the half-landed fan-out
        agents_run()
        return got + rec("big-0", "big-1")

    def restart():
        ctl[0] = controller()
        return rec("big-0", "big-1")

    def delete_group():
        for n in ("big-0", "big-1"):
            kube.delete("Pod", "default", n)
        time.sleep(GRACE + 0.05)
        got = rec("big-0", "big-1")
        agents_run()
        return got + rec("big-0", "big-1")

    for name, fn in (("boot", boot), ("grant", grant),
                     ("no_capacity", no_capacity),
                     ("device_failure", device_failure),
                     ("crash_ungate", crash_ungate), ("deletion", deletion),
                     ("crash_write", crash_write), ("restart", restart),
                     ("delete_group", delete_group)):
        step(name, fn)
    reasons = [(e.component, e.reason) for e in journal.events()
               if e.seq > seq0 and e.component != "kube"]
    out.append(("reasons", reasons))
    out.append(("reservations", {n: sorted(
        (r.slice_uuid, tuple(r.chip_ids))
        for r in backends[n].list_reservations()) for n in NODES}))
    return out


def test_controller_on_v5e_equals_the_reference():
    got, want = scenario("port"), scenario("ref")
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    steps = {g[0]: g[1:] for g in got}
    crs = steps["grant"][1]["crs"]
    (a,) = crs["node-0"]["spec"]["allocations"].values()
    assert (a["status"], a["box"]) == ("ungated", "0,0,0+2x2x1")
    assert steps["grant"][1]["pods"]["a"]["gates"] == []
    # the group waits on capacity, once announced
    pods = steps["no_capacity"][1]["pods"]
    assert pods["big-0"]["gates"] and pods["big-1"]["gates"]
    # the failed node is avoided: the retry lands on the other one
    failed_on = steps["device_failure"][0][-1]
    crs = steps["device_failure"][1]["crs"]
    other = [n for n in NODES if n != failed_on][0]
    assert [x["pods"][0]["podName"] for x in crs[other]["spec"][
        "allocations"].values() if x["status"] == "ungated"].count("b") == 1
    # the group's fan-out, repaired by the restarted controller, reaches
    # both nodes and both pods are ungated
    crs = steps["crash_write"][1]["crs"]
    for n in NODES:
        (g,) = crs[n]["spec"]["allocations"].values()
        assert g["status"] == "ungated" and sorted(g["parts"]) == list(NODES)
    assert steps["crash_write"][1]["pods"]["big-1"]["gates"] == []
    final = steps["delete_group"][1]
    assert all(not final["crs"][n]["spec"].get("allocations")
               for n in NODES)
    assert final["pods"] == {} and steps["reservations"] == (
        {n: [] for n in NODES},)
    reasons = [r for _, r in steps["reasons"][0]]
    for want_reason in ("Admitted", "Placed", "Ungated", "NoCapacity",
                        "Retrying", "SliceRealizeFailed", "SliceTornDown"):
        assert want_reason in reasons, want_reason


def test_controller_on_v5e_control_one_step_left_out_differs():
    assert scenario("port", skip="crash_ungate") != scenario("ref")


# ------------------------------------------------------ CRD, constants

def test_crd_manifest_equals_the_reference():
    assert tcrd.crd_manifest() == jcrd.crd_manifest()
    from instaslice_tpu_torch.api import crd_manifest
    assert crd_manifest is tcrd.crd_manifest


def test_controller_constants_carry_the_reference_values():
    names = ["GATE_NAME", "LEGACY_GATE_NAME", "FINALIZER",
             "CAUSED_BY_ANNOTATION", "REPACK_OPTOUT_ANNOTATION"]
    names += [n for n in dir(jconst) if n.startswith("REASON_")
              and hasattr(tconst, n)]
    names += [n for n in dir(jconst) if n.endswith("_ANNOTATION")
              and n.split("_")[0] in ("ERROR", "GROUP", "HANDOFF",
                                      "PROFILE", "RESTART", "UNHEALTHY")]
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
    for n in ("REASON_ADMITTED", "REASON_PLACED", "REASON_UNGATED",
              "REASON_NO_CAPACITY", "REASON_REJECTED", "REASON_RETRYING",
              "REASON_GRANT_DEADLINE", "REASON_CRASH_RECOVERED",
              "REASON_DEGRADED", "REASON_HEALED", "REASON_HEALTH_EVICTED",
              "REASON_MIGRATION_ABORTED", "REASON_REPACK_PLANNED",
              "REASON_REPACK_MIGRATING", "REASON_REPACK_DONE",
              "REASON_REPACK_FAILED"):
        assert getattr(tconst, n) in tconst.EVENT_REASONS, n
    import instaslice_tpu
    import instaslice_tpu_torch
    for n in ("API_VERSION", "FINALIZER", "GATE_NAME", "GROUP", "KIND",
              "LEGACY_GATE_NAME", "PLURAL", "POD_RESOURCE_PREFIX",
              "VERSION"):
        assert getattr(instaslice_tpu_torch, n) == getattr(instaslice_tpu,
                                                           n), n


# ---------------------------------------------------------------- gates

def _pod(limits=None, annotations=None, gates=True, phase="Pending"):
    return {"metadata": {"name": "p", "namespace": "default",
                         "annotations": annotations or {}},
            "spec": {"schedulingGates": ([{"name": tconst.GATE_NAME}]
                                         if gates else []),
                     "containers": [{"name": "c", "resources": {
                         "limits": limits or {}}}]},
            "status": {"phase": phase}}


@pytest.mark.parametrize("pod", [
    _pod(annotations={tconst.PROFILE_ANNOTATION: "v5e-2x2"}),
    _pod(limits={"google.com/tpu-v5e-2x4": "1"}),
    _pod(limits={"google.com/tpu-v5p-2x2x2": "1"}),
    _pod(limits={"cpu": "1"}),
    _pod(limits={f"{tconst.POD_RESOURCE_PREFIX}p": "1"}),
    _pod(annotations={tconst.GROUP_ANNOTATION: "g",
                      tconst.GROUP_SIZE_ANNOTATION: "2"}),
    _pod(gates=False),
    _pod(phase="Running"),
])
def test_gates_on_tpu_pods_equal_the_reference(pod):
    assert tgates.is_pod_gated(pod) == jgates.is_pod_gated(pod)
    got, want = tgates.extract_profile(pod), jgates.extract_profile(pod)
    assert (got and (got.name, got.shape)) == (want and (want.name,
                                                         want.shape))
    assert tgates.pod_group(pod) == jgates.pod_group(pod)


@pytest.mark.parametrize("key,name,generation", [
    ("nvidia.com/mig-3g.40gb", "3g.40gb", mig.H100_80GB),
    ("nvidia.com/mig-1g.10gb", "1g.10gb", mig.H100_80GB),
    ("nvidia.com/gpu", "gpu", mig.H100_80GB),
])
def test_an_nvidia_request_is_read_by_instaslices_rule(key, name,
                                                       generation):
    pod = _pod(limits={key: "1", f"{tconst.POD_RESOURCE_PREFIX}p": "1"})
    got = tgates.extract_profile(pod)
    assert (got.name, got.generation) == (name, generation)
    # the control: the reference's gates read no such request, so its
    # controller leaves the pod gated with no event
    assert jgates.extract_profile(pod) is None


@pytest.mark.parametrize("key", ["nvidia.com/mig-9g.99gb",
                                 "nvidia.com/mig-1g.5gb", "nvidia.com/foo"])
def test_a_malformed_or_unknown_mig_request_raises(key):
    with pytest.raises(ValueError):
        tgates.extract_profile(_pod(limits={key: "1"}))
