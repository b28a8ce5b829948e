"""The port's deploy-plane validation as a test, as
``tests/test_deploy_plane.py`` runs the reference's.

``python -m instaslice_tpu_torch.deploy.check`` (render the port's tree,
apply it over HTTP to the port's fake API server, cross-check references
and GPU-node needs, lint the port's Dockerfiles and commands against
``pyproject.toml``) must end ``OK: 0 failures``, and each of its build
checks fails on a broken copy.

The RBAC audit: the port's pod loop (the simulator's controller and node
agents over HTTP, each with its own ``RealKubeClient``) and the
controller's Lease election run against ``FakeApiServer`` with the
operator's bearer token; every (verb, API group, resource) that token
sends must be granted by the rendered ClusterRole and leader-election
Role. The control: the same run held to the rules less one fails.
"""

from __future__ import annotations

import copy
import subprocess
import sys
import threading
from pathlib import Path
from urllib.parse import parse_qs, urlsplit

import pytest

from instaslice_tpu_torch.deploy import check as deploy_check
from instaslice_tpu_torch.deploy.kustomize import render
from instaslice_tpu_torch.deploy.manifests import NAMESPACE, PREFIX, tree

REPO = Path(__file__).resolve().parents[1]
#: the bearer token of the operator's ServiceAccount in the audit
OPERATOR_TOKEN = "operator-service-account"


def test_deploy_plane_validates():
    proc = subprocess.run(
        [sys.executable, "-m", "instaslice_tpu_torch.deploy.check"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:] + proc.stderr[-2000:]
    assert "FAIL" not in out, out[-3000:]
    assert out.strip().splitlines()[-1] == "OK: 0 failures"
    # the apply covered the whole rendered tree, samples included
    assert out.count("PASS apply ") >= 16
    assert "PASS apply sample Pod/cuda-vectoradd" in out


def test_reference_deploy_plane_still_validates():
    """The reference's tools/test_deploy.py, unchanged, beside the
    Makefile's new targets."""
    proc = subprocess.run([sys.executable, "tools/test_deploy.py"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "OK: 0 failures" in proc.stdout


def test_train_console_script():
    """``tpuslice-gpu-train`` is the counterpart of ``tpuslice-train``."""
    scripts = deploy_check.console_scripts()
    assert scripts["tpuslice-train"] == "instaslice_tpu.cli.train_main:main"
    assert scripts["tpuslice-gpu-train"] == \
        "instaslice_tpu_torch.cli.train_main:main"
    assert deploy_check.port_target(scripts["tpuslice-gpu-train"])


@pytest.mark.parametrize("breakage", [
    "entrypoint", "copy", "command", "image", "torch"])
def test_build_plane_check_fails_on_a_broken_copy(breakage, tmp_path,
                                                   monkeypatch):
    """Each build-plane check, on a copy of the Dockerfiles and workloads
    with one thing broken: that check fails, and only on that."""
    for comp in ("controller", "agent", "deviceplugin"):
        src = REPO / "instaslice_tpu_torch" / "deploy" / f"Dockerfile.{comp}"
        (tmp_path / src.name).write_text(src.read_text())
    docs = copy.deepcopy(render(tree(), "default"))
    agent = next(d for d in docs if d["metadata"]["name"] == f"{PREFIX}-agent")
    ctr = agent["spec"]["template"]["spec"]["containers"][0]
    df = tmp_path / "Dockerfile.agent"
    if breakage == "entrypoint":
        df.write_text(df.read_text().replace('["tpuslice-gpu-agent"]',
                                             '["tpuslice-agent"]'))
    elif breakage == "copy":
        df.write_text(df.read_text().replace("COPY pyproject.toml",
                                             "COPY setup.py"))
    elif breakage == "command":
        ctr["command"] = ["tpuslice-gpu-nosuch"]
    elif breakage == "image":
        ctr["image"] = f"{PREFIX}-nosuch:latest"
    elif breakage == "torch":
        df.write_text(df.read_text().replace(
            "pip install --no-cache-dir .", "pip install --no-cache-dir . torch"))
    monkeypatch.setattr(deploy_check, "HERE", tmp_path)
    monkeypatch.setattr(deploy_check, "FAILURES", [])
    deploy_check.check_build_plane(docs)
    failed = deploy_check.FAILURES
    assert len(failed) >= 1, breakage
    want = {"entrypoint": "entrypoint", "copy": "COPY source",
            "command": "command", "image": "image",
            "torch": "installs no torch"}[breakage]
    assert all(want in f for f in failed), failed


# ------------------------------------------------------------ rbac audit

class Audit:
    """Records the (verb, group, resource) of every request the fake API
    server answers for the operator's token."""

    def __init__(self) -> None:
        self.seen: set = set()
        self.lock = threading.Lock()

    def record(self, handler, method: str) -> None:
        if handler.headers.get("Authorization") != \
                f"Bearer {OPERATOR_TOKEN}":
            return
        url = urlsplit(handler.path)
        parts = [p for p in url.path.split("/") if p]
        core = parts[0] == "api"
        group = "" if core else parts[1]
        rest = parts[2 if core else 3:]
        if len(rest) >= 2 and rest[0] == "namespaces":
            rest = rest[2:]
        resource = rest[0] + (f"/{rest[2]}" if len(rest) > 2 else "")
        if method == "GET":
            watch = parse_qs(url.query).get("watch", [""])[0]
            verb = ("get" if len(rest) > 1 else
                    "watch" if watch in ("1", "true") else "list")
        else:
            verb = {"POST": "create", "PUT": "update", "PATCH": "patch",
                    "DELETE": "delete"}[method]
        with self.lock:
            self.seen.add((verb, group, resource))


def rendered_rules(drop: int = -1) -> set:
    """(verb, group, resource) granted to the operator's ServiceAccount by
    the rendered tree; ``drop`` removes that rule of the ClusterRole."""
    docs = render(tree(), "default")
    role = next(d for d in docs if d["kind"] == "ClusterRole"
                and d["metadata"]["name"] == f"{PREFIX}-manager-role")
    lease = next(d for d in docs if d["kind"] == "Role")
    rules = [r for i, r in enumerate(role["rules"]) if i != drop]
    bound = {(b["roleRef"]["kind"], b["roleRef"]["name"])
             for b in docs if b["kind"].endswith("RoleBinding")
             and any(s["name"] == f"{PREFIX}-controller-manager"
                     and s["namespace"] == NAMESPACE for s in b["subjects"])}
    assert {("ClusterRole", role["metadata"]["name"]),
            ("Role", lease["metadata"]["name"])} <= bound
    return {(v, g, r) for rule in rules + lease["rules"]
            for g in rule["apiGroups"] for r in rule["resources"]
            for v in rule["verbs"]}


@pytest.fixture(scope="module")
def audited():
    """The pod loop over HTTP and one Lease election, the operator's
    requests recorded."""
    from instaslice_tpu_torch.api.constants import (
        RESTART_ON_FAILURE_ANNOTATION,
    )
    from instaslice_tpu_torch.controller.runner import LEASE_NAME
    from instaslice_tpu_torch.kube import httptest, real
    from instaslice_tpu_torch.sim import SimCluster
    from instaslice_tpu_torch.utils.election import LeaderElector

    audit = Audit()
    mp = pytest.MonkeyPatch()
    for method in ("GET", "POST", "PUT", "PATCH", "DELETE"):
        orig = getattr(httptest._Handler, f"do_{method}")

        def wrapped(self, orig=orig, method=method):
            audit.record(self, method)
            return orig(self)
        mp.setattr(httptest._Handler, f"do_{method}", wrapped)
    made = []

    class Client(real.RealKubeClient):
        """The sim's first client is the observer (the user and the
        kubelet); every later one is an operator component's, and
        presents the ServiceAccount's token."""

        def __init__(self, url, **kw):
            made.append(url)
            if len(made) > 1:
                kw["token"] = OPERATOR_TOKEN
            super().__init__(url, **kw)

    mp.setattr(real, "RealKubeClient", Client)
    try:
        with SimCluster(n_nodes=2, transport="http",
                        deletion_grace_seconds=0.3) as c:
            c.submit("audit-pod", profile="3g.40gb")
            assert c.wait_phase("audit-pod", "Running", timeout=60)
            c.delete_pod("audit-pod")
            assert c.wait_gone("audit-pod", timeout=60)
            # the health path: a pod that opted into a restart on a
            # failed slice loses its GPU, the agent reports it in its
            # CR's status and the controller deletes the pod
            c.submit("audit-restart", profile="7g.80gb", annotations={
                RESTART_ON_FAILURE_ANNOTATION: "true"})
            assert c.wait_phase("audit-restart", "Running", timeout=60)
            (alloc,) = c.allocations().values()
            node = alloc["torusGroup"]
            for chip in range(8):
                c.backends[node].fail_chip(chip)
            assert c.wait_gone("audit-restart", timeout=60)
            elector = LeaderElector(Client(c.server.url), NAMESPACE,
                                    LEASE_NAME, "audit", lease_seconds=1,
                                    retry_seconds=0.05)
            assert elector.acquire()
            elector.release()
    finally:
        mp.undo()
    assert len(made) >= 3
    return audit.seen


def test_rbac_grants_every_request_of_the_pod_loop(audited):
    granted = rendered_rules()
    assert {("update", "", "pods"), ("delete", "", "pods"),
            ("create", "", "configmaps"), ("patch", "", "nodes/status"),
            ("patch", "tpu.instaslice.dev", "tpuslices/status"),
            ("create", "coordination.k8s.io", "leases"),
            ("watch", "tpu.instaslice.dev", "tpuslices")} <= audited
    missing = sorted(audited - granted)
    assert not missing, missing


@pytest.mark.parametrize("drop", range(6))
def test_rbac_control_one_rule_less_fails(audited, drop):
    """The control: without any one of the ClusterRole's six rules, some
    request of the same run is no longer granted (every rule is used)."""
    docs = render(tree(), "default")
    role = next(d for d in docs if d["kind"] == "ClusterRole"
                and d["metadata"]["name"] == f"{PREFIX}-manager-role")
    assert len(role["rules"]) == 6
    assert audited - rendered_rules(drop), role["rules"][drop]
