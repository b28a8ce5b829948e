"""The port's deploy plane as data: every manifest of a cluster of H100
nodes, and the sample pods, as plain dicts.

This module is the single source of ``deploy/config/`` (the kustomize
tree ``kubectl apply -k instaslice_tpu_torch/deploy/config/default``
installs) and of ``deploy/samples/``: :mod:`.gen_manifests` renders both
to YAML and ``--check`` fails when a checked-in file drifts. It needs no
YAML library. Each document is the counterpart of the reference's file
of the same name under ``config/`` and ``samples/``, with what differs
on GPU nodes:

- **images** ``instaslice-tpu-gpu-{controller,agent,deviceplugin}``,
  built by ``deploy/Dockerfile.*`` (no PyTorch in any of them: the
  control plane imports none);
- **commands** the port's console scripts (``tpuslice-gpu-controller``,
  ``-agent``, ``-deviceplugin``) with the reference's args;
- **node selection** GPU nodes by NVIDIA's ``nvidia.com/gpu.present``
  label, tolerating the ``nvidia.com/gpu`` taint;
- **the agent** privileged, ``NODE_NAME`` from the downward API, the env
  upstream InstaSlice's DaemonSet carries for NVIDIA's container runtime
  (every GPU visible, the ``utility`` capability that maps NVML in, MIG
  configuration on every device), ``/dev`` and the reservation registry
  mounted from the host at :data:`~instaslice_tpu_torch.device.nvml.DEFAULT_REGISTRY`,
  so that a restarted agent pod finds every reservation it made;
- **the device plugin** the kubelet's socket directory
  (:data:`~instaslice_tpu_torch.deviceplugin.server.DEFAULT_PLUGIN_DIR`),
  ``/dev`` and the same registry; privileged, which also leaves the
  host's ``/proc/driver/nvidia-caps`` readable, where Allocate reads the
  MIG capability minors it hands a container
  (:data:`~instaslice_tpu_torch.deviceplugin.server.MIG_MINORS`; a
  container runtime refuses a mount under ``/proc``);
- **RBAC** exactly the verbs the port's controller and agent send,
  Leases included.

Every host path is read from the constant the code reads, never written
here as a literal.

Which of NVIDIA's device-plugin resources the port serves: the
DaemonSet's ``tpuslice-gpu-deviceplugin`` advertises ``nvidia.com/gpu``,
each GPU whose MIG mode is off (a GPU with MIG on is granted only by MIG
slices). ``nvidia.com/mig-<profile>`` stays with NVIDIA's device plugin
(MIG strategy ``mixed``), which advertises the MIG devices the agent
creates, as in upstream InstaSlice. Where both plugins run on a node,
the kubelet serves each resource name from the plugin that registered
it last, so NVIDIA's plugin must not also advertise whole GPUs there
(every GPU in MIG mode, or its ``nvidia.com/gpu`` left to the port).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

from instaslice_tpu_torch.api.constants import (
    FINALIZER,
    GATE_NAME,
    GPU_NODE_LABEL,
    GPU_RESOURCE,
    GROUP,
    MIG_RESOURCE_PREFIX,
    PLURAL,
    POD_RESOURCE_PREFIX,
)
from instaslice_tpu_torch.api.crd import crd_manifest
from instaslice_tpu_torch.device.nvml import DEFAULT_REGISTRY
from instaslice_tpu_torch.deviceplugin.server import DEFAULT_PLUGIN_DIR

#: the operator's namespace (the port's CLIs' ``--namespace`` default)
NAMESPACE = "instaslice-tpu-system"
#: every object, image and label the port installs starts with this
PREFIX = "instaslice-tpu-gpu"
IMAGE_TAG = "latest"
SERVICE_ACCOUNT = f"{PREFIX}-controller-manager"
#: the components, each an image built by ``deploy/Dockerfile.<name>``
COMPONENTS = ("controller", "agent", "deviceplugin")
#: the image of the metrics sidecar, the reference's
RBAC_PROXY_IMAGE = "gcr.io/kubebuilder/kube-rbac-proxy:v0.16.0"

#: the controller's args: the reference's, and the deletion grace at
#: InstaSlice's default (the CLI's too), carried so that a deployer sees
#: and sets it
MANAGER_ARGS = ["--leader-elect", "--metrics-bind-address=:8080",
                "--health-probe-bind-address=:8081",
                "--deletion-grace-seconds=30"]

#: a Document is (kind-bearing dict); a File is (header comment, docs)
File = Tuple[str, List[dict]]


def image(component: str) -> str:
    return f"{PREFIX}-{component}:{IMAGE_TAG}"


def _meta(name: str, namespaced: bool = True, **labels) -> dict:
    md = {"name": name}
    if namespaced:
        md["namespace"] = NAMESPACE
    if labels:
        md["labels"] = dict(labels)
    return md


def _host_volume(name: str, path: str, create: bool = False) -> dict:
    host = {"path": path}
    if create:
        host["type"] = "DirectoryOrCreate"
    return {"name": name, "hostPath": host}


def _gpu_nodes() -> dict:
    """The pod spec fields that put a DaemonSet on GPU nodes only."""
    return {"nodeSelector": {GPU_NODE_LABEL: "true"},
            "tolerations": [{"key": GPU_RESOURCE, "operator": "Exists"}]}


# ------------------------------------------------------------- manager

def namespace() -> dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": NAMESPACE,
                         "labels": {"control-plane": "controller-manager"}}}


def manager_deployment() -> dict:
    """The controller: ``tpuslice-gpu-controller`` with
    :data:`MANAGER_ARGS`, probes on 8081, metrics on 8080, non-root."""
    labels = {"control-plane": "controller-manager"}
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": _meta(f"{PREFIX}-controller-manager", **labels),
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "serviceAccountName": SERVICE_ACCOUNT,
                    "terminationGracePeriodSeconds": 10,
                    "securityContext": {"runAsNonRoot": True},
                    "containers": [{
                        "name": "manager",
                        "image": image("controller"),
                        "command": ["tpuslice-gpu-controller"],
                        "args": list(MANAGER_ARGS),
                        "ports": [{"containerPort": 8080,
                                   "name": "metrics"}],
                        "livenessProbe": {
                            "httpGet": {"path": "/healthz", "port": 8081},
                            "initialDelaySeconds": 15,
                            "periodSeconds": 20},
                        "readinessProbe": {
                            "httpGet": {"path": "/readyz", "port": 8081},
                            "initialDelaySeconds": 5,
                            "periodSeconds": 10},
                        "resources": {
                            "limits": {"cpu": "500m", "memory": "256Mi"},
                            "requests": {"cpu": "10m", "memory": "64Mi"}},
                        "securityContext": {
                            "allowPrivilegeEscalation": False,
                            "capabilities": {"drop": ["ALL"]}},
                    }],
                },
            },
        },
    }


def agent_daemonset() -> dict:
    """The node agent on every GPU node: NVML through NVIDIA's container
    runtime, privileged for MIG changes, the registry on the host."""
    labels = {"app": f"{PREFIX}-agent"}
    spec = {
        "serviceAccountName": SERVICE_ACCOUNT,
        **_gpu_nodes(),
        "containers": [{
            "name": "agent",
            "image": image("agent"),
            "command": ["tpuslice-gpu-agent"],
            "args": ["--backend=auto",
                     "--metrics-bind-address=:8084",
                     "--health-probe-bind-address=:8085"],
            "ports": [{"containerPort": 8084, "name": "metrics"}],
            "env": [
                {"name": "NODE_NAME",
                 "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}}},
                {"name": "NVIDIA_VISIBLE_DEVICES", "value": "all"},
                {"name": "NVIDIA_DRIVER_CAPABILITIES", "value": "utility"},
                {"name": "NVIDIA_MIG_CONFIG_DEVICES", "value": "all"},
            ],
            "securityContext": {"privileged": True},
            "volumeMounts": [
                {"name": "dev", "mountPath": "/dev"},
                {"name": "registry", "mountPath": DEFAULT_REGISTRY},
            ],
        }],
        "volumes": [_host_volume("dev", "/dev"),
                    _host_volume("registry", DEFAULT_REGISTRY, create=True)],
    }
    return {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": _meta(f"{PREFIX}-agent", **labels),
        "spec": {"selector": {"matchLabels": dict(labels)},
                 "template": {"metadata": {"labels": dict(labels)},
                              "spec": spec}},
    }


def deviceplugin_daemonset() -> dict:
    """The device plugin on every GPU node: the kubelet's socket
    directory, ``/dev``, the agent's registry."""
    labels = {"app": f"{PREFIX}-deviceplugin"}
    spec = {
        "serviceAccountName": SERVICE_ACCOUNT,
        **_gpu_nodes(),
        "priorityClassName": "system-node-critical",
        "containers": [{
            "name": "deviceplugin",
            "image": image("deviceplugin"),
            "command": ["tpuslice-gpu-deviceplugin"],
            "args": ["--backend=auto"],
            "env": [
                {"name": "NVIDIA_VISIBLE_DEVICES", "value": "all"},
                {"name": "NVIDIA_DRIVER_CAPABILITIES", "value": "utility"},
            ],
            "securityContext": {"privileged": True},
            "volumeMounts": [
                {"name": "device-plugins", "mountPath": DEFAULT_PLUGIN_DIR},
                {"name": "dev", "mountPath": "/dev"},
                {"name": "registry", "mountPath": DEFAULT_REGISTRY},
            ],
        }],
        "volumes": [_host_volume("device-plugins", DEFAULT_PLUGIN_DIR),
                    _host_volume("dev", "/dev"),
                    _host_volume("registry", DEFAULT_REGISTRY, create=True)],
    }
    return {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": _meta(f"{PREFIX}-deviceplugin", **labels),
        "spec": {"selector": {"matchLabels": dict(labels)},
                 "template": {"metadata": {"labels": dict(labels)},
                              "spec": spec}},
    }


def metrics_service() -> dict:
    return {
        "apiVersion": "v1", "kind": "Service",
        "metadata": _meta(f"{PREFIX}-metrics",
                          **{"control-plane": "controller-manager"}),
        "spec": {"selector": {"control-plane": "controller-manager"},
                 "ports": [{"name": "https", "port": 8443,
                            "targetPort": "https"}]},
    }


def auth_proxy_patch() -> dict:
    """``/metrics`` behind kube-rbac-proxy: the manager binds its
    metrics to localhost, the sidecar serves TLS on 8443."""
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": _meta(f"{PREFIX}-controller-manager"),
        "spec": {"template": {"spec": {"containers": [
            {"name": "kube-rbac-proxy",
             "image": RBAC_PROXY_IMAGE,
             "args": ["--secure-listen-address=0.0.0.0:8443",
                      "--upstream=http://127.0.0.1:8080/",
                      "--logtostderr=true", "--v=0"],
             "ports": [{"containerPort": 8443, "protocol": "TCP",
                        "name": "https"}],
             "securityContext": {"allowPrivilegeEscalation": False,
                                 "capabilities": {"drop": ["ALL"]}},
             "resources": {"limits": {"cpu": "500m", "memory": "128Mi"},
                           "requests": {"cpu": "5m", "memory": "64Mi"}}},
            {"name": "manager",
             # the same args, metrics on localhost behind the proxy
             "args": [a.replace("=:8080", "=127.0.0.1:8080")
                      for a in MANAGER_ARGS]},
        ]}}},
    }


def service_monitor() -> dict:
    return {
        "apiVersion": "monitoring.coreos.com/v1", "kind": "ServiceMonitor",
        "metadata": _meta(f"{PREFIX}-metrics-monitor",
                          **{"control-plane": "controller-manager"}),
        "spec": {
            "selector": {"matchLabels": {
                "control-plane": "controller-manager"}},
            "endpoints": [{
                "port": "https", "scheme": "https", "path": "/metrics",
                "interval": "15s",
                "bearerTokenFile":
                    "/var/run/secrets/kubernetes.io/serviceaccount/token",
                "tlsConfig": {"insecureSkipVerify": True}}],
        },
    }


# ---------------------------------------------------------------- rbac

def _rule(group: str, resources: List[str], verbs: List[str]) -> dict:
    return {"apiGroups": [group], "resources": resources, "verbs": verbs}


def manager_role() -> dict:
    """What the controller and the agent send: the controller reads and
    ungates pods (update), annotates them (patch) and deletes a pod that
    opted into a restart on a failed slice, and mirrors its decisions as
    Events; the agent writes the handoff ConfigMaps (create, patch when
    one exists, delete), the Node's per-pod resource (nodes/status
    patch), its CR (create, update) and the CR's unhealthy GPUs
    (tpuslices/status patch); both list and watch pods and CRs."""
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
        "metadata": _meta(f"{PREFIX}-manager-role", namespaced=False),
        "rules": [
            _rule("", ["pods"],
                  ["get", "list", "watch", "update", "patch", "delete"]),
            _rule("", ["nodes/status"], ["patch"]),
            _rule("", ["configmaps"], ["get", "create", "patch", "delete"]),
            _rule("", ["events"], ["create"]),
            _rule(GROUP, [PLURAL],
                  ["get", "list", "watch", "create", "update"]),
            _rule(GROUP, [f"{PLURAL}/status"], ["patch"]),
        ],
    }


def _binding(kind: str, name: str, role_kind: str, role: str) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1", "kind": kind,
        "metadata": _meta(name, namespaced=kind == "RoleBinding"),
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                    "kind": role_kind, "name": role},
        "subjects": [{"kind": "ServiceAccount", "name": SERVICE_ACCOUNT,
                      "namespace": NAMESPACE}],
    }


def leader_election_role() -> dict:
    """The controller's Lease (``--leader-elect``): read, take, renew."""
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
        "metadata": _meta(f"{PREFIX}-leader-election-role"),
        "rules": [_rule("coordination.k8s.io", ["leases"],
                        ["get", "create", "update"])],
    }


def service_account() -> dict:
    return {"apiVersion": "v1", "kind": "ServiceAccount",
            "metadata": _meta(SERVICE_ACCOUNT)}


def auth_proxy_role() -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
        "metadata": _meta(f"{PREFIX}-proxy-role", namespaced=False),
        "rules": [
            _rule("authentication.k8s.io", ["tokenreviews"], ["create"]),
            _rule("authorization.k8s.io", ["subjectaccessreviews"],
                  ["create"]),
        ],
    }


def metrics_reader_role() -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
        "metadata": _meta(f"{PREFIX}-metrics-reader", namespaced=False),
        "rules": [{"nonResourceURLs": ["/metrics"], "verbs": ["get"]}],
    }


# ---------------------------------------------------------------- tree

def _kustomization(resources: List[str], patches=()) -> dict:
    k = {"resources": list(resources)}
    if patches:
        k["patches"] = [{"path": p} for p in patches]
    return k


def tree() -> Dict[str, File]:
    """``deploy/config/``: path -> (header comment, documents), in the
    layout of the reference's ``config/``."""
    crd_file = f"bases/{PLURAL}.{GROUP}.yaml"
    return {
        f"crd/{crd_file}": (
            "The TpuSlice CRD, from instaslice_tpu_torch.api.crd "
            "(crd_manifest).", [crd_manifest()]),
        "crd/kustomization.yaml": ("", [_kustomization([crd_file])]),
        "default/kustomization.yaml": (
            "kubectl apply -k installs the CRD, RBAC and the workloads; "
            "add ../prometheus where the prometheus-operator CRDs are "
            "present. The patch puts /metrics behind kube-rbac-proxy.",
            [_kustomization(["../crd", "../rbac", "../manager"],
                            ["manager_auth_proxy_patch.yaml"])]),
        "default/manager_auth_proxy_patch.yaml": (
            "/metrics behind kube-rbac-proxy: the manager binds its "
            "metrics to localhost; the sidecar terminates TLS on 8443 "
            "and authorizes scrapers (TokenReview, SubjectAccessReview "
            "against the metrics-reader ClusterRole).",
            [auth_proxy_patch()]),
        "manager/kustomization.yaml": (
            "", [_kustomization(["manager.yaml", "metrics_service.yaml"])]),
        "manager/manager.yaml": (
            "The operator's workloads on H100 nodes: the controller "
            "Deployment, the node agent and device plugin DaemonSets on "
            f"nodes labelled {GPU_NODE_LABEL}.",
            [namespace(), manager_deployment(), agent_daemonset(),
             deviceplugin_daemonset()]),
        "manager/metrics_service.yaml": (
            "The metrics Service the ServiceMonitor scrapes, through "
            "kube-rbac-proxy's https port.", [metrics_service()]),
        "prometheus/kustomization.yaml": (
            "", [_kustomization(["monitor.yaml"])]),
        "prometheus/monitor.yaml": (
            "ServiceMonitor: https through kube-rbac-proxy with the "
            "scraper's ServiceAccount token (bind it to the "
            f"{PREFIX}-metrics-reader ClusterRole).", [service_monitor()]),
        "rbac/kustomization.yaml": ("", [_kustomization([
            "role.yaml", "role_binding.yaml", "leader_election_role.yaml",
            "service_account.yaml", "auth_proxy_role.yaml",
            "auth_proxy_role_binding.yaml",
            "auth_proxy_client_clusterrole.yaml"])]),
        "rbac/role.yaml": (
            "The operator's ClusterRole: the verbs the port's controller "
            "and node agent send, and no other.", [manager_role()]),
        "rbac/role_binding.yaml": ("", [
            _binding("ClusterRoleBinding", f"{PREFIX}-manager-rolebinding",
                     "ClusterRole", f"{PREFIX}-manager-role"),
            _binding("RoleBinding",
                     f"{PREFIX}-leader-election-rolebinding", "Role",
                     f"{PREFIX}-leader-election-role")]),
        "rbac/leader_election_role.yaml": (
            "The controller's leader-election Lease.",
            [leader_election_role()]),
        "rbac/service_account.yaml": ("", [service_account()]),
        "rbac/auth_proxy_role.yaml": (
            "kube-rbac-proxy reviews scrapers' tokens and authorizes "
            "them.", [auth_proxy_role()]),
        "rbac/auth_proxy_role_binding.yaml": ("", [
            _binding("ClusterRoleBinding", f"{PREFIX}-proxy-rolebinding",
                     "ClusterRole", f"{PREFIX}-proxy-role")]),
        "rbac/auth_proxy_client_clusterrole.yaml": (
            "Grant this role to scrapers so kube-rbac-proxy lets them "
            "read /metrics.", [metrics_reader_role()]),
    }


def workload(name: str) -> dict:
    """The rendered tree's workload ``name`` (``controller``, ``agent``
    or ``deviceplugin``) after every patch of ``config/default``, as
    ``kubectl apply -k`` would create it."""
    from instaslice_tpu_torch.deploy.kustomize import render

    want = {"controller": f"{PREFIX}-controller-manager",
            "agent": f"{PREFIX}-agent",
            "deviceplugin": f"{PREFIX}-deviceplugin"}[name]
    (doc,) = [d for d in render(tree(), "default")
              if d.get("kind") in ("Deployment", "DaemonSet")
              and d["metadata"]["name"] == want]
    return doc


# ------------------------------------------------------------- samples

#: a public CUDA image with the sample's binary; the serving samples
#: need an image of their own (see their headers)
CUDA_SAMPLE_IMAGE = "nvcr.io/nvidia/k8s/cuda-sample:vectoradd-cuda12.5.0"
#: PyTorch with the CUDA toolkit (the port builds its kernels with nvcc
#: at run time); the port's wheel is installed on top
SERVE_IMAGE = "pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel"


def gated_pod(name: str, request: str, container: dict,
              labels=None, annotations=None, priority_class: str = "",
              volumes=None, **spec) -> dict:
    """A pod the controller grants: the scheduling gate, the finalizer,
    ``request`` (``nvidia.com/mig-<profile>`` or ``nvidia.com/gpu``) and
    the per-pod resource in its limits, ``envFrom`` its handoff
    ConfigMap (named after the pod)."""
    ctr = copy.deepcopy(container)
    ctr.setdefault("resources", {})["limits"] = {
        request: "1", f"{POD_RESOURCE_PREFIX}{name}": "1"}
    ctr["envFrom"] = [{"configMapRef": {"name": name}}]
    md = {"name": name}
    if labels:
        md["labels"] = dict(labels)
    if annotations:
        md["annotations"] = dict(annotations)
    md["finalizers"] = [FINALIZER]
    pod_spec = dict(spec)
    if priority_class:
        pod_spec["priorityClassName"] = priority_class
    pod_spec["schedulingGates"] = [{"name": GATE_NAME}]
    pod_spec.setdefault("restartPolicy", "Never")
    pod_spec["containers"] = [ctr]
    if volumes:
        pod_spec["volumes"] = volumes
    return {"apiVersion": "v1", "kind": "Pod", "metadata": md,
            "spec": pod_spec}


def mig(profile: str) -> str:
    return f"{MIG_RESOURCE_PREFIX}{profile}"


_MODELS = [{"name": "models", "emptyDir": {}}]
_MODELS_MOUNT = [{"name": "models", "mountPath": "/models",
                  "readOnly": True}]


def _server(name: str, args: List[str], http: bool = True) -> dict:
    ctr = {"name": name, "image": SERVE_IMAGE,
           "command": ["tpuslice-gpu-serve", *args],
           "volumeMounts": copy.deepcopy(_MODELS_MOUNT)}
    if http:
        ctr["ports"] = [{"containerPort": 8000}]
        ctr["readinessProbe"] = {"httpGet": {"path": "/healthz",
                                             "port": 8000}}
    return ctr


def _headless(name: str, ports: List[dict], **extra) -> dict:
    spec = {"clusterIP": "None", **extra, "selector": {"app": name},
            "ports": ports}
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": name}, "spec": spec}


def _workers(app: str, n: int, request: str, container, service: str,
             driver_label: bool = False) -> List[dict]:
    """``n`` worker pods of one job, each its own single-GPU grant. The
    port's controller grants a GPU request on one GPU of one node and
    refuses a pod group over GPUs, so each pod's own env (which wins
    over ``envFrom``) names its rank and the roster the rendezvous
    reads; the handoff ConfigMap still gives each its granted device."""
    hosts = ",".join(f"{app}-w{i}.{service}" for i in range(n))
    pods = []
    for i in range(n):
        ctr = container(i)
        ctr["env"] = [{"name": "TPU_WORKER_ID", "value": str(i)},
                      {"name": "TPU_WORKER_HOSTNAMES", "value": hosts}]
        labels = {"app": app}
        if driver_label and i == 0:
            labels["role"] = "driver"
        pods.append(gated_pod(
            f"{app}-w{i}", request, ctr, labels=labels,
            hostname=f"{app}-w{i}", subdomain=service,
            volumes=copy.deepcopy(_MODELS) if driver_label else None))
    return pods


def samples() -> Dict[str, File]:
    """``deploy/samples/``: file -> (header comment, documents)."""
    serve_args = ["--from-env", "--quantize", "--port", "8000",
                  "--checkpoint", "/models/ckpt"]
    stress = [("3g", "3g.40gb"), ("2g-a", "2g.20gb"), ("2g-b", "2g.20gb"),
              ("2g-c", "2g.20gb"), ("1g-a", "1g.10gb"), ("1g-b", "1g.10gb"),
              ("1g-c", "1g.10gb"), ("1g-d", "1g.10gb")]
    sleeper = {"name": "work", "image": CUDA_SAMPLE_IMAGE,
               "command": ["sh", "-c",
                           "nvidia-smi -L; echo $CUDA_VISIBLE_DEVICES; "
                           "sleep 600"]}

    def priority(name: str, value: int) -> dict:
        return {"apiVersion": "scheduling.k8s.io/v1",
                "kind": "PriorityClass", "metadata": {"name": name},
                "value": value,
                "preemptionPolicy": "PreemptLowerPriority"}

    def holder(name: str) -> dict:
        return {"name": name, "image": CUDA_SAMPLE_IMAGE,
                "command": ["sh", "-c", "nvidia-smi -L; sleep 3600"]}

    return {
        "test-pod.yaml": (
            "Upstream InstaSlice's sample on an H100 profile: a gated pod "
            "with the finalizer, a MIG slice and the per-pod resource the "
            "agent adds to the chosen node (what makes the scheduler bind "
            "it there), envFrom the ConfigMap the agent writes "
            "(CUDA_VISIBLE_DEVICES and NVIDIA_VISIBLE_DEVICES name the "
            "granted MIG device).",
            [gated_pod("cuda-vectoradd", mig("1g.10gb"), {
                "name": "cuda-vectoradd", "image": CUDA_SAMPLE_IMAGE,
                "command": ["sh", "-c", "nvidia-smi -L; "
                            "/cuda-samples/vectorAdd && sleep 1800"]},
                restartPolicy="OnFailure")]),
        "native-serve.yaml": (
            "The port's server on a granted MIG slice: continuous "
            "batching, int8 weights and KV cache, the hand-written Hopper "
            "kernels, an OpenAI-style HTTP endpoint. The image needs "
            "PyTorch with the CUDA toolkit and the port's wheel.",
            [gated_pod("native-serve", mig("3g.40gb"),
                       _server("server", serve_args),
                       volumes=copy.deepcopy(_MODELS))]),
        "native-serve-multihost.yaml": (
            "One tpuslice-gpu-serve command in two worker pods, each on a "
            "whole GPU granted on its own: worker 0 rendezvouses, serves "
            "HTTP and broadcasts the engine's op stream, worker 1 replays "
            "it (tensor parallelism across the two). The headless Service "
            "resolves the workers before worker 0 is Ready; clients use "
            "serve-2gpu-http, which selects worker 0 alone.",
            [_headless("serve-2gpu",
                       [{"port": 8476, "name": "coordinator"},
                        {"port": 8478, "name": "oplog"}],
                       publishNotReadyAddresses=True),
             {"apiVersion": "v1", "kind": "Service",
              "metadata": {"name": "serve-2gpu-http"},
              "spec": {"selector": {"app": "serve-2gpu", "role": "driver"},
                       "ports": [{"port": 8000, "name": "http"}]}},
             *_workers("serve-2gpu", 2, GPU_RESOURCE,
                       lambda i: _server(
                           "server" if i == 0 else "follower",
                           serve_args + ["--oplog-port", "8478"],
                           http=i == 0),
                       "serve-2gpu", driver_label=True)]),
        "multihost.yaml": (
            "The rendezvous smoke of a two-worker job, each worker on a "
            "whole GPU granted on its own: both meet at worker 0 over the "
            "headless Service and all-reduce (parallel.dcn_smoke prints "
            "psum_total 3.0 on each).",
            [_headless("trainer-2gpu", [{"port": 8476,
                                         "name": "coordinator"}]),
             *_workers("trainer-2gpu", 2, GPU_RESOURCE,
                       lambda i: {"name": "trainer", "image": SERVE_IMAGE,
                                  "command": ["python", "-m",
                                              "instaslice_tpu_torch."
                                              "parallel.dcn_smoke"]},
                       "trainer-2gpu")]),
        "multi-lora-serve.yaml": (
            "One base model and several LoRA adapters on one granted MIG "
            "slice, each request naming its adapter (POST "
            "/v1/completions with \"adapter\"; GET /v1/models lists "
            "them). Adapters come from tpuslice-gpu-train --lora-rank; "
            "a :ALPHA suffix overrides --lora-alpha.",
            [gated_pod("multi-lora-serve", mig("3g.40gb"), _server(
                "server", ["--from-env", "--quantize", "--port", "8000",
                           "--checkpoint", "/models/base",
                           "--lora", "/models/adapters/billing",
                           "--lora", "/models/adapters/support:32"]),
                volumes=copy.deepcopy(_MODELS))]),
        "reshard-preempt.yaml": (
            "Reshard without an agent restart: a low-priority batch pod "
            "holds a whole GPU as a 7g.80gb slice; four high-priority "
            "1g.10gb pods wait with NoCapacity. Delete the batch pod "
            "(its owner preempting it, or kubectl delete): after the "
            "grace its slice is torn down and the GPU is granted again "
            "as four 1g.10gb slices.",
            [priority("gpu-batch-low", 100), priority("gpu-serve-high", 1000),
             gated_pod("batch-7g", mig("7g.80gb"), holder("batch"),
                       priority_class="gpu-batch-low"),
             *[gated_pod(f"serve-1g-{c}", mig("1g.10gb"), holder("serve"),
                         priority_class="gpu-serve-high") for c in "abcd"]]),
        "stress-binpack.yaml": (
            "Bin-packing stress: 8 concurrent pods of mixed MIG profiles "
            "(one 3g.40gb, three 2g.20gb, four 1g.10gb), 14 of the 16 "
            "memory slices of two H100s.",
            [{"apiVersion": "v1", "kind": "List", "items": [
                gated_pod(f"stress-{n}", mig(p), sleeper)
                for n, p in stress]}]),
    }
