"""The port's deploy plane (``instaslice_tpu_torch/deploy``) held to the
reference's manifest checks (``tests/test_manifests.py``) and to what
H100 nodes need.

Every YAML file parses, the checked-in tree and samples equal
``deploy/manifests.py`` (read by PyYAML and by the port's own reader),
``gen_manifests --check`` passes and fails on a drifted copy, the CRD is
``api/crd.py``'s, RBAC covers the operator's verbs, the DaemonSets run on
GPU nodes with their host paths read from the port's constants (the
control: the reference's registry path fails the check), the metrics sit
behind kube-rbac-proxy, and every sample pod is gated, finalized,
``envFrom`` its ConfigMap, requests its per-pod resource and a MIG
profile or whole GPU that the port's controller reads against the H100
80GB catalog, and is granted by the port's simulator.
"""

from __future__ import annotations

import copy
import shutil
import subprocess
import sys
import uuid
from pathlib import Path

import pytest
import yaml

from instaslice_tpu_torch.api.constants import (
    FINALIZER,
    GATE_NAME,
    GPU_RESOURCE,
    GROUP,
    GROUP_ANNOTATION,
    MIG_RESOURCE_PREFIX,
    PLURAL,
    POD_RESOURCE_PREFIX,
)
from instaslice_tpu_torch.api.crd import crd_manifest
from instaslice_tpu_torch.cli import controller_main
from instaslice_tpu_torch.controller.gates import extract_profile, is_pod_gated
from instaslice_tpu_torch.controller.gpugrid import parse_profile
from instaslice_tpu_torch.deploy import check as deploy_check
from instaslice_tpu_torch.deploy import gen_manifests
from instaslice_tpu_torch.deploy.kustomize import render
from instaslice_tpu_torch.deploy.manifests import (
    GPU_NODE_LABEL,
    samples,
    tree,
)
from instaslice_tpu_torch.device.nvml import DEFAULT_REGISTRY
from instaslice_tpu_torch.deviceplugin.server import DEFAULT_PLUGIN_DIR
from instaslice_tpu_torch.topology.mig import H100_80GB, parse_mig_profile

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "instaslice_tpu_torch" / "deploy" / "config"
SAMPLES = REPO / "instaslice_tpu_torch" / "deploy" / "samples"
#: the reference's registry path: a manifest copied from config/ mounts it
REFERENCE_REGISTRY = "/run/tpuslice"


def load_all(path: Path) -> list:
    return [d for d in yaml.safe_load_all(path.read_text()) if d is not None]


def iter_pods(doc):
    kind = doc.get("kind")
    if kind == "Pod":
        yield doc
    elif kind == "List":
        for item in doc.get("items", []):
            yield from iter_pods(item)
    elif kind in ("Deployment", "DaemonSet", "StatefulSet", "Job"):
        tmpl = doc["spec"]["template"]
        yield {"apiVersion": "v1", "kind": "Pod",
               "metadata": tmpl.get("metadata", {}),
               "spec": tmpl.get("spec", {})}


def sample_pods(name: str) -> list:
    return [p for d in load_all(SAMPLES / name) for p in iter_pods(d)]


def manager_docs() -> list:
    return load_all(CONFIG / "manager" / "manager.yaml")


def daemonset(suffix: str) -> dict:
    (ds,) = [d for d in manager_docs() if d["kind"] == "DaemonSet"
             and d["metadata"]["name"].endswith(suffix)]
    return ds


class TestYamlParses:
    def test_all_files_parse(self):
        files = sorted(CONFIG.rglob("*.yaml")) + sorted(SAMPLES.glob("*.yaml"))
        assert len(files) >= 12, files
        for path in files:
            docs = load_all(path)
            assert docs, f"{path} is empty"
            if path.name == "kustomization.yaml":
                continue  # kustomizations have no kind by design
            for d in docs:
                assert "kind" in d, f"{path}: doc without kind"

    def test_the_ports_reader_reads_what_pyyaml_reads(self):
        """The port reads its own tree without PyYAML (the card's machine
        has none): the same documents."""
        for path in sorted(CONFIG.rglob("*.yaml")) + sorted(
                SAMPLES.glob("*.yaml")):
            text = path.read_text()
            assert gen_manifests.load_documents(text) == load_all(path), path


class TestTreeInSync:
    def test_checked_in_tree_equals_the_code(self):
        want = tree()
        on_disk = {p.relative_to(CONFIG).as_posix(): load_all(p)
                   for p in CONFIG.rglob("*.yaml")}
        assert set(on_disk) == set(want)
        for rel, (_, docs) in want.items():
            assert on_disk[rel] == docs, rel

    def test_checked_in_samples_equal_the_code(self):
        want = samples()
        on_disk = {p.name: load_all(p) for p in SAMPLES.glob("*.yaml")}
        assert on_disk == {k: v for k, (_, v) in want.items()}

    def test_checked_in_crd_matches_code(self):
        (on_disk,) = load_all(CONFIG / "crd" / "bases"
                              / f"{PLURAL}.{GROUP}.yaml")
        assert on_disk == crd_manifest()

    def test_gen_manifests_check_mode(self):
        r = subprocess.run(
            [sys.executable, "-m", "instaslice_tpu_torch.deploy.gen_manifests",
             "--check"], cwd=REPO, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr

    def test_check_mode_sees_drift(self, tmp_path, monkeypatch):
        """The control: a copy with one file edited, one removed and one
        left over is stale on exactly those three."""
        shutil.copytree(CONFIG, tmp_path / "config")
        shutil.copytree(SAMPLES, tmp_path / "samples")
        monkeypatch.setattr(gen_manifests, "CONFIG", tmp_path / "config")
        monkeypatch.setattr(gen_manifests, "SAMPLES", tmp_path / "samples")
        assert gen_manifests.stale() == []
        role = tmp_path / "config" / "rbac" / "role.yaml"
        role.write_text(role.read_text().replace("- delete\n", ""))
        (tmp_path / "samples" / "test-pod.yaml").unlink()
        (tmp_path / "config" / "extra.yaml").write_text("kind: X\n")
        bad = gen_manifests.stale()
        assert len(bad) == 3, bad
        assert gen_manifests.main(["--check"]) == 1


class TestRbacCoversClientVerbs:
    def rules(self):
        (role,) = load_all(CONFIG / "rbac" / "role.yaml")
        (lease,) = load_all(CONFIG / "rbac" / "leader_election_role.yaml")
        out = {}
        for rule in role["rules"] + lease["rules"]:
            for g in rule["apiGroups"]:
                for res in rule["resources"]:
                    out.setdefault((g, res), set()).update(rule["verbs"])
        return out

    def test_role_covers_operator_surface(self):
        rules = self.rules()
        # controller: pod watch, gate removal (update), events
        assert {"get", "list", "watch", "update"} <= rules[("", "pods")]
        assert {"create"} <= rules[("", "events")]
        # agent: per-pod ConfigMap CRUD, node capacity patch
        assert {"create", "delete", "patch"} <= rules[("", "configmaps")]
        assert {"patch"} <= rules[("", "nodes/status")]
        # both: TpuSlice CRUD and status
        assert {"get", "list", "watch", "create", "update"} <= rules[
            (GROUP, PLURAL)]
        assert {"patch"} <= rules[(GROUP, f"{PLURAL}/status")]
        # the controller's --leader-elect Lease
        assert {"get", "create", "update"} <= rules[
            ("coordination.k8s.io", "leases")]


class TestManagerManifests:
    def test_agent_daemonset_has_node_name_downward_api(self):
        ctr = daemonset("agent")["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e for e in ctr.get("env", [])}
        assert env["NODE_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == \
            "spec.nodeName"
        assert ctr["securityContext"]["privileged"] is True
        assert ctr["command"] == ["tpuslice-gpu-agent"]
        assert "--backend=auto" in ctr["args"]
        # upstream InstaSlice's env for NVIDIA's container runtime
        assert {k: env[k]["value"] for k in (
            "NVIDIA_VISIBLE_DEVICES", "NVIDIA_DRIVER_CAPABILITIES",
            "NVIDIA_MIG_CONFIG_DEVICES")} == {
            "NVIDIA_VISIBLE_DEVICES": "all",
            "NVIDIA_DRIVER_CAPABILITIES": "utility",
            "NVIDIA_MIG_CONFIG_DEVICES": "all"}

    def test_agent_registry_is_the_ports(self):
        spec = daemonset("agent")["spec"]["template"]["spec"]
        paths = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"]}
        mounts = {m["name"]: m["mountPath"]
                  for m in spec["containers"][0]["volumeMounts"]}
        assert paths["registry"] == mounts["registry"] == DEFAULT_REGISTRY

    @pytest.mark.parametrize("registry", [DEFAULT_REGISTRY,
                                          REFERENCE_REGISTRY])
    def test_registry_check_and_its_control(self, registry, monkeypatch):
        """The deploy check holds the registry to DEFAULT_REGISTRY: the
        reference's /run/tpuslice (a manifest copied from config/) fails
        it, for the agent and for the plugin."""
        docs = copy.deepcopy(render(tree(), "default"))
        for d in docs:
            if d["kind"] != "DaemonSet":
                continue
            spec = d["spec"]["template"]["spec"]
            for v in spec["volumes"]:
                if v["name"] == "registry":
                    v["hostPath"]["path"] = registry
            for m in spec["containers"][0]["volumeMounts"]:
                if m["name"] == "registry":
                    m["mountPath"] = registry
        monkeypatch.setattr(deploy_check, "FAILURES", [])
        deploy_check.check_gpu_nodes(docs)
        failed = deploy_check.FAILURES
        if registry == DEFAULT_REGISTRY:
            assert failed == []
        else:
            assert len([f for f in failed if "registry" in f]) == 2, failed

    def test_deviceplugin_daemonset_mounts_kubelet_socket_dir(self):
        dp = daemonset("deviceplugin")
        spec = dp["spec"]["template"]["spec"]
        paths = [v["hostPath"]["path"] for v in spec["volumes"]]
        assert DEFAULT_PLUGIN_DIR in paths and "/dev" in paths
        assert DEFAULT_REGISTRY in paths
        ctr = spec["containers"][0]
        assert ctr["command"] == ["tpuslice-gpu-deviceplugin"]
        # privileged: /dev, and /proc/driver/nvidia-caps readable for the
        # MIG minors Allocate returns
        assert ctr["securityContext"]["privileged"] is True

    def test_the_plugin_clis_default_dir_is_the_mount(self):
        from instaslice_tpu_torch.cli import deviceplugin_main

        args = deviceplugin_main.build_parser().parse_args(
            daemonset("deviceplugin")["spec"]["template"]["spec"][
                "containers"][0]["args"])
        assert args.plugin_dir == DEFAULT_PLUGIN_DIR
        assert args.backend == "auto"

    def test_daemonsets_select_gpu_nodes(self):
        for suffix in ("agent", "deviceplugin"):
            spec = daemonset(suffix)["spec"]["template"]["spec"]
            assert spec["nodeSelector"] == {GPU_NODE_LABEL: "true"}
            assert {"key": GPU_RESOURCE, "operator": "Exists"} in \
                spec["tolerations"]
            assert "tpu" not in str(spec["nodeSelector"]).replace(
                "instaslice", "")

    def test_manager_runs_the_ports_controller(self):
        (dep,) = [d for d in manager_docs() if d["kind"] == "Deployment"]
        spec = dep["spec"]["template"]["spec"]
        (ctr,) = spec["containers"]
        assert ctr["command"] == ["tpuslice-gpu-controller"]
        # the reference's args, and the grace at the CLI's default
        assert ctr["args"] == ["--leader-elect",
                               "--metrics-bind-address=:8080",
                               "--health-probe-bind-address=:8081",
                               "--deletion-grace-seconds=30"]
        parser = controller_main.build_parser()
        assert parser.parse_args(ctr["args"]).deletion_grace_seconds == \
            parser.parse_args([]).deletion_grace_seconds
        assert ctr["readinessProbe"]["httpGet"]["port"] == 8081
        assert spec["securityContext"]["runAsNonRoot"] is True
        assert ctr["image"] == "instaslice-tpu-gpu-controller:latest"

    def test_kustomizations_reference_existing_files(self):
        for kfile in CONFIG.rglob("kustomization.yaml"):
            (k,) = load_all(kfile)
            for res in k.get("resources", []):
                assert (kfile.parent / res).resolve().exists(), (kfile, res)
            for patch in k.get("patches", []):
                assert (kfile.parent / patch["path"]).exists(), (kfile, patch)


class TestMetricsAuthn:
    def test_auth_proxy_patch_wires_sidecar_and_localhost_bind(self):
        (patch,) = load_all(CONFIG / "default"
                            / "manager_auth_proxy_patch.yaml")
        ctrs = {c["name"]: c
                for c in patch["spec"]["template"]["spec"]["containers"]}
        proxy = ctrs["kube-rbac-proxy"]
        assert any("--upstream=http://127.0.0.1:8080/" in a
                   for a in proxy["args"])
        assert any(p.get("name") == "https" for p in proxy["ports"])
        assert any("--metrics-bind-address=127.0.0.1:8080" in a
                   for a in ctrs["manager"]["args"])

    def test_default_kustomization_applies_the_patch(self):
        (k,) = load_all(CONFIG / "default" / "kustomization.yaml")
        assert "manager_auth_proxy_patch.yaml" in [
            p.get("path", "") for p in k.get("patches", [])]

    def test_rbac_grants_token_and_access_review(self):
        (role,) = load_all(CONFIG / "rbac" / "auth_proxy_role.yaml")
        resources = {r for rule in role["rules"]
                     for r in rule.get("resources", [])}
        assert {"tokenreviews", "subjectaccessreviews"} <= resources

    def test_service_monitor_scrapes_https_with_token(self):
        (mon,) = load_all(CONFIG / "prometheus" / "monitor.yaml")
        (ep,) = mon["spec"]["endpoints"]
        assert ep["scheme"] == "https"
        assert "serviceaccount/token" in ep["bearerTokenFile"]


SAMPLE_FILES = sorted(samples())


def device_request(pod: dict) -> str:
    """The pod's one NVIDIA resource."""
    limits = pod["spec"]["containers"][0]["resources"]["limits"]
    (key,) = [k for k in limits if k.startswith("nvidia.com/")]
    return key


class TestSamplePods:
    def test_the_reference_samples_with_a_gpu_meaning_are_here(self):
        assert SAMPLE_FILES == sorted([
            "test-pod.yaml", "native-serve.yaml",
            "native-serve-multihost.yaml", "multihost.yaml",
            "multi-lora-serve.yaml", "reshard-preempt.yaml",
            "stress-binpack.yaml"])

    @pytest.mark.parametrize("fname", SAMPLE_FILES)
    def test_pods_are_gated_with_finalizer(self, fname):
        pods = sample_pods(fname)
        assert pods
        for pod in pods:
            name = pod["metadata"]["name"]
            assert [g["name"] for g in pod["spec"]["schedulingGates"]] == \
                [GATE_NAME], name
            assert pod["metadata"]["finalizers"] == [FINALIZER], name
            assert is_pod_gated(pod)
            (ctr,) = pod["spec"]["containers"]
            assert [e["configMapRef"]["name"]
                    for e in ctr["envFrom"]] == [name]
            assert ctr["resources"]["limits"][
                f"{POD_RESOURCE_PREFIX}{name}"] == "1"
            # a GPU pod group is refused by the port's controller
            assert GROUP_ANNOTATION not in pod["metadata"].get(
                "annotations", {}), name

    @pytest.mark.parametrize("fname", SAMPLE_FILES)
    def test_requests_parse_against_the_h100_catalog(self, fname):
        for pod in sample_pods(fname):
            key = device_request(pod)
            assert key == GPU_RESOURCE or key.startswith(MIG_RESOURCE_PREFIX)
            prof = extract_profile(pod)
            assert prof is not None
            # the controller's name rule and the H100 80GB's catalog
            assert parse_profile(prof.name) == prof
            assert parse_mig_profile(key, H100_80GB) == prof

    def test_multi_worker_samples_name_their_roster(self):
        for fname, app in (("multihost.yaml", "trainer-2gpu"),
                           ("native-serve-multihost.yaml", "serve-2gpu")):
            docs = load_all(SAMPLES / fname)
            services = {d["metadata"]["name"]: d for d in docs
                        if d["kind"] == "Service"}
            pods = sample_pods(fname)
            hosts = [f"{p['spec']['hostname']}.{p['spec']['subdomain']}"
                     for p in pods]
            for i, p in enumerate(pods):
                env = {e["name"]: e["value"]
                       for e in p["spec"]["containers"][0]["env"]}
                assert env == {"TPU_WORKER_ID": str(i),
                               "TPU_WORKER_HOSTNAMES": ",".join(hosts)}
                assert services[p["spec"]["subdomain"]]["spec"][
                    "clusterIP"] == "None"
                assert p["metadata"]["labels"]["app"] == app

    @pytest.mark.parametrize("fname", SAMPLE_FILES)
    def test_sim_grants_the_sample(self, fname):
        """The port's controller and agents (the simulator, fake H100
        backends) grant every pod of the sample: MIG on for MIG
        requests, off for whole GPUs. The reshard sample's claimants
        wait until the batch pod is deleted."""
        from instaslice_tpu_torch.sim import SimCluster

        pods = sample_pods(fname)
        whole = all(device_request(p) == GPU_RESOURCE for p in pods)
        claimants = [p["metadata"]["name"] for p in pods
                     if p["spec"].get("priorityClassName") == "gpu-serve-high"]
        with SimCluster(n_nodes=2, gpus_per_node=2, mig=not whole) as c:
            if claimants:
                # fill both nodes' other GPUs first, so the claimants
                # can only use the batch pod's GPU
                for i in range(3):
                    c.submit(f"fill-{i}", profile="7g.80gb")
                    assert c.wait_phase(f"fill-{i}", "Running", timeout=30)
            def create(pod):
                p = copy.deepcopy(pod)
                # what the apiserver adds on create
                p["metadata"].update(namespace="default",
                                     uid=f"uid-{uuid.uuid4().hex[:8]}")
                p["status"] = {"phase": "Pending"}
                c.kube.create("Pod", p)

            names = [p["metadata"]["name"] for p in pods]
            for pod in pods:
                if pod["metadata"]["name"] not in claimants:
                    create(pod)
            for n in names:
                if n not in claimants:
                    assert c.wait_phase(n, "Running", timeout=30), (
                        n, c.pod_phase(n))
            if claimants:
                for pod in pods:
                    if pod["metadata"]["name"] in claimants:
                        create(pod)
                # no free slot anywhere: each claimant waits, ungranted
                assert not any(c.wait_phase(n, "Running", timeout=0.5)
                               for n in claimants)
                c.delete_pod("batch-7g")
                assert c.wait_gone("batch-7g", timeout=30)
                for n in claimants:
                    assert c.wait_phase(n, "Running", timeout=30), n
            for n in names:
                if n != "batch-7g":
                    cm = c.configmap(n)["data"]
                    assert cm["CUDA_VISIBLE_DEVICES"], n
