"""``tpuslice-gpu-controller`` and ``tpuslice-gpu-agent --backend fake``
as processes against the port's HTTP apiserver (``kube/httptest``): a
gated pod that asks for ``nvidia.com/mig-3g.40gb`` is placed, realized
and ungated, and once deleted is torn down and gone; the controller
holds its Lease and answers its probes. The control, a pod without the
gate, is left alone.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from instaslice_tpu_torch.api.constants import (
    FINALIZER,
    GATE_NAME,
    POD_RESOURCE_PREFIX,
)
from instaslice_tpu_torch.api.types import AllocationStatus, TpuSlice
from instaslice_tpu_torch.controller.runner import LEASE_NAME
from instaslice_tpu_torch.kube.client import NotFound
from instaslice_tpu_torch.kube.fake import FakeKube
from instaslice_tpu_torch.kube.httptest import FakeApiServer

REPO = Path(__file__).resolve().parents[1]
NODE, NS = "node-a", "instaslice-tpu-system"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _until(fn, procs, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        for p in procs:
            assert p.poll() is None, p.stdout.read()
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError("timed out")


def _get(kube, kind, ns, name):
    try:
        return kube.get(kind, ns, name)
    except NotFound:
        return None


def _status(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status
    except Exception:  # noqa: BLE001 - not listening yet
        return 0


def _pod(name, gated=True):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"schedulingGates": ([{"name": GATE_NAME}] if gated
                                         else []),
                     "containers": [{"name": "c", "resources": {"limits": {
                         "nvidia.com/mig-3g.40gb": "1",
                         f"{POD_RESOURCE_PREFIX}{name}": "1"}}}]},
            "status": {"phase": "Pending"}}


def test_controller_and_agent_processes_grant_and_tear_down(tmp_path):
    kube = FakeKube()
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
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("TPUSLICE_CRASH_AT", None)
        probe = _free_port()
        common = ["--namespace", NS, "--kubeconfig", str(cfg),
                  "--metrics-bind-address", "127.0.0.1:0"]
        procs = []
        try:
            for argv in (
                ["instaslice_tpu_torch.cli.agent_main", "--node-name", NODE,
                 "--backend", "fake", "--health-probe-bind-address",
                 f"127.0.0.1:{_free_port()}"],
                ["instaslice_tpu_torch.cli.controller_main", "--leader-elect",
                 "--deletion-grace-seconds", "0.3",
                 "--health-probe-bind-address", f"127.0.0.1:{probe}"],
            ):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", *argv, *common], cwd=tmp_path,
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            _until(lambda: _get(kube, "TpuSlice", NS, NODE), procs)
            lease = _until(lambda: _get(kube, "Lease", NS, LEASE_NAME), procs)
            assert lease["spec"]["holderIdentity"]
            _until(lambda: all(_status(f"http://127.0.0.1:{probe}/{p}") == 200
                               for p in ("healthz", "readyz")), procs)
            kube.create("Pod", _pod("plain", gated=False))
            kube.create("Pod", _pod("p"))

            def ungated():
                ts = TpuSlice.from_manifest(kube.get("TpuSlice", NS, NODE))
                pod = kube.get("Pod", "default", "p")
                done = [a for a in ts.spec.allocations.values()
                        if a.status == AllocationStatus.UNGATED]
                return done and pod["spec"]["schedulingGates"] == [] and \
                    (done[0], pod)

            alloc, pod = _until(ungated, procs)
            assert (alloc.profile, alloc.parts, alloc.realized_on) == (
                "3g.40gb", {"gpu0": (0, "0,0,0+4x1x1")}, ["gpu0"])
            assert pod["metadata"]["finalizers"] == [FINALIZER]
            cm = kube.get("ConfigMap", "default", "p")["data"]
            assert cm["CUDA_VISIBLE_DEVICES"].startswith("MIG-")
            # the control: a pod without the gate is not the controller's
            plain = kube.get("Pod", "default", "plain")
            assert not plain["metadata"].get("finalizers")
            assert [a.pods[0].pod_name for a in TpuSlice.from_manifest(
                kube.get("TpuSlice", NS, NODE)).spec.allocations.values()
            ] == ["p"]

            kube.delete("Pod", "default", "p")
            _until(lambda: _get(kube, "Pod", "default", "p") is None, procs)
            _until(lambda: not TpuSlice.from_manifest(kube.get(
                "TpuSlice", NS, NODE)).spec.allocations, procs)
            _until(lambda: _get(kube, "ConfigMap", "default", "p") is None,
                   procs)
            node = kube.get("Node", "", NODE)["status"]
            assert f"{POD_RESOURCE_PREFIX}p" not in node["capacity"]
        finally:
            outs = []
            for p in procs:
                p.send_signal(signal.SIGTERM)
                outs.append(p.communicate(timeout=60)[0])
        assert [p.returncode for p in procs] == [0, 0], outs
