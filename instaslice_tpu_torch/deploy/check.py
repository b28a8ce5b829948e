"""Deploy-plane validation of the port without a cluster or a container
runtime: ``python -m instaslice_tpu_torch.deploy.check`` (``make
gpu-test-deploy``), the port's counterpart of ``tools/test_deploy.py``.

1. **Manifest apply**: read the checked-in ``deploy/config`` with the
   port's own YAML reader (it must equal :func:`.manifests.tree`), render
   ``config/default`` (:mod:`.kustomize`) and APPLY every document through
   the port's ``RealKubeClient`` to its ``FakeApiServer`` over HTTP. Then
   the cross-checks ``kubectl`` would make server-side: selectors against
   template labels, ServiceAccount and role references, Service
   ``targetPort`` names, the auth-proxy patch landed. And what GPU nodes
   need: each DaemonSet on ``nvidia.com/gpu.present`` nodes tolerating
   ``nvidia.com/gpu``, every hostPath one of the port's constants
   (the agent's and the plugin's registry at ``DEFAULT_REGISTRY``, the
   plugin's socket directory at ``DEFAULT_PLUGIN_DIR``), the agent
   privileged with ``NODE_NAME`` from the downward API and NVIDIA's
   runtime env.
2. **Image build plan**: every ``deploy/Dockerfile.*`` ``COPY`` source
   exists (the repository root is the build context), its ``ENTRYPOINT``
   is a console script of ``pyproject.toml`` that points into the port,
   and it installs no torch; every image a workload names has its
   Dockerfile and is built by ``make gpu-docker-build``; every command is
   a port console script (its module and function present) or ``python
   -m`` of a port module.
3. **Samples**: every document of ``deploy/samples`` equals
   :func:`.manifests.samples`, and its pods, Services and ConfigMaps apply
   over HTTP.

Prints ``PASS``/``FAIL`` per check and ends with ``OK: 0 failures`` or
``FAILED: <n> failures`` (exit 1).
"""

from __future__ import annotations

import ast
import copy
import re
import sys
import tomllib
from pathlib import Path
from typing import List

from instaslice_tpu_torch.deploy import gen_manifests
from instaslice_tpu_torch.deploy.kustomize import render
from instaslice_tpu_torch.deploy.manifests import (
    COMPONENTS,
    GPU_NODE_LABEL,
    PREFIX,
    samples,
    tree,
)

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
PACKAGE = "instaslice_tpu_torch"

FAILURES: List[str] = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what)
    if not ok:
        FAILURES.append(what)


def read_tree(root: Path) -> dict:
    """The checked-in files under ``root``, read by the port's reader,
    as the tree's (header, documents) pairs."""
    return {p.relative_to(root).as_posix():
            ("", gen_manifests.load_documents(p.read_text()))
            for p in sorted(root.rglob("*.yaml"))}


def iter_pod_specs(doc: dict):
    kind = doc.get("kind")
    if kind in ("Deployment", "DaemonSet", "StatefulSet", "Job"):
        yield doc["spec"]["template"]
    elif kind == "Pod":
        yield doc
    elif kind == "List":
        for item in doc.get("items", []):
            yield from iter_pod_specs(item)


def console_scripts() -> dict:
    """``[project.scripts]`` of ``pyproject.toml``: name -> target."""
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def port_target(target: str) -> bool:
    """True when ``module:function`` names a function defined in a module
    of the port (read from its source: importing it might load torch)."""
    module, _, func = target.partition(":")
    if not module.startswith(PACKAGE + "."):
        return False
    path = REPO / Path(*module.split("."))
    src = path.with_suffix(".py")
    if not src.exists():
        return False
    names = {n.name for n in ast.parse(src.read_text()).body
             if isinstance(n, ast.FunctionDef)}
    return func in names


def port_module(module: str) -> bool:
    return (module.startswith(PACKAGE + ".")
            and (REPO / Path(*module.split("."))).with_suffix(".py").exists())


def check_apply(docs: List[dict], what: str = "apply") -> None:
    """Create every document over real HTTP against the fake server."""
    from instaslice_tpu_torch.kube import FakeKube
    from instaslice_tpu_torch.kube.httptest import FakeApiServer
    from instaslice_tpu_torch.kube.real import RealKubeClient

    with FakeApiServer(FakeKube()) as srv:
        client = RealKubeClient(srv.url)
        for doc in docs:
            kind = doc.get("kind", "?")
            name = doc.get("metadata", {}).get("name", "?")
            try:
                client.create(kind, doc)
                check(True, f"{what} {kind}/{name}")
            except Exception as e:  # slicelint: disable=broad-except
                # not swallowed: check() tallies and prints the failure
                check(False, f"{what} {kind}/{name}: {e}")


def check_cross_references(docs: List[dict]) -> None:
    by_kind: dict = {}
    for d in docs:
        by_kind.setdefault(d.get("kind"), []).append(d)
    for doc in docs:
        kind = doc.get("kind")
        name = doc.get("metadata", {}).get("name")
        if kind in ("Deployment", "DaemonSet"):
            sel = doc["spec"]["selector"]["matchLabels"]
            labels = doc["spec"]["template"]["metadata"]["labels"]
            check(all(labels.get(k) == v for k, v in sel.items()),
                  f"{kind}/{name}: selector matches template labels")
            sa = doc["spec"]["template"]["spec"].get("serviceAccountName")
            sas = {s["metadata"]["name"]
                   for s in by_kind.get("ServiceAccount", [])}
            check(sa in sas, f"{kind}/{name}: serviceAccount {sa} exists")
        if kind == "Service":
            sel = doc["spec"].get("selector", {})
            port_names = set()
            for d in docs:
                for tpl in iter_pod_specs(d):
                    tlabels = tpl.get("metadata", {}).get("labels", {})
                    if sel and all(tlabels.get(k) == v
                                   for k, v in sel.items()):
                        for c in tpl["spec"].get("containers", []):
                            port_names |= {p["name"]
                                           for p in c.get("ports", [])
                                           if p.get("name")}
            for p in doc["spec"].get("ports", []):
                tp = p.get("targetPort")
                if isinstance(tp, str):
                    check(tp in port_names,
                          f"Service/{name}: targetPort {tp!r} resolves "
                          f"(have {sorted(port_names)})")
        if kind in ("ClusterRoleBinding", "RoleBinding"):
            ref = doc["roleRef"]
            names = {r["metadata"]["name"]
                     for r in by_kind.get(ref["kind"], [])}
            check(ref["name"] in names,
                  f"{kind}/{name}: roleRef {ref['name']} exists")
    for doc in by_kind.get("Deployment", []):
        for tpl in iter_pod_specs(doc):
            for c in tpl["spec"]["containers"]:
                if c["name"] == "manager":
                    check(any("--metrics-bind-address=127.0.0.1" in a
                              for a in c.get("args", [])),
                          "manager metrics bound to localhost "
                          "(kube-rbac-proxy fronting)")


def check_gpu_nodes(docs: List[dict]) -> None:
    """What a DaemonSet on an H100 node needs, its host paths read from
    the port's constants."""
    from instaslice_tpu_torch.api.constants import GPU_RESOURCE
    from instaslice_tpu_torch.device.nvml import DEFAULT_REGISTRY
    from instaslice_tpu_torch.deviceplugin.server import DEFAULT_PLUGIN_DIR

    known = {DEFAULT_REGISTRY, DEFAULT_PLUGIN_DIR, "/dev"}
    for doc in docs:
        if doc.get("kind") != "DaemonSet":
            continue
        name = doc["metadata"]["name"]
        spec = doc["spec"]["template"]["spec"]
        (ctr,) = spec["containers"]
        check(spec.get("nodeSelector") == {GPU_NODE_LABEL: "true"}
              and {"key": GPU_RESOURCE, "operator": "Exists"}
              in spec.get("tolerations", []),
              f"DaemonSet/{name}: on GPU nodes, tolerating {GPU_RESOURCE}")
        hosts = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"]}
        mounts = {m["name"]: m["mountPath"] for m in ctr["volumeMounts"]}
        check(set(hosts.values()) <= known,
              f"DaemonSet/{name}: host paths {sorted(hosts.values())} are "
              "the port's constants")
        check(set(mounts) == set(hosts) and all(
            mounts[n] == hosts[n] for n in hosts),
            f"DaemonSet/{name}: each host path mounted where the code "
            "reads it")
        check(hosts.get("registry") == DEFAULT_REGISTRY,
              f"DaemonSet/{name}: the registry at {DEFAULT_REGISTRY}")
        check(ctr.get("securityContext", {}).get("privileged") is True,
              f"DaemonSet/{name}: privileged")
        env = {e["name"]: e for e in ctr.get("env", [])}
        check(env.get("NVIDIA_DRIVER_CAPABILITIES", {}).get("value")
              == "utility"
              and env.get("NVIDIA_VISIBLE_DEVICES", {}).get("value")
              == "all", f"DaemonSet/{name}: NVML through NVIDIA's runtime")
        if name.endswith("-agent"):
            check(env["NODE_NAME"]["valueFrom"]["fieldRef"]["fieldPath"]
                  == "spec.nodeName"
                  and env.get("NVIDIA_MIG_CONFIG_DEVICES", {}).get("value")
                  == "all", f"DaemonSet/{name}: NODE_NAME and "
                  "NVIDIA_MIG_CONFIG_DEVICES")
        if name.endswith("-deviceplugin"):
            check(hosts.get("device-plugins") == DEFAULT_PLUGIN_DIR,
                  f"DaemonSet/{name}: the kubelet's {DEFAULT_PLUGIN_DIR}")


def makefile_images() -> set:
    """Images ``make gpu-docker-build`` tags, its variables expanded."""
    mk = (REPO / "Makefile").read_text()
    mkvars = dict(re.findall(r"^(\w+)\s*\?=\s*(\S+)", mk, re.M))
    m = re.search(r"^gpu-docker-build:.*?\n((?:\t.*\n)+)", mk, re.M)
    out = set()
    for t in re.findall(r"-t\s+(\S+)\s", m.group(1) if m else ""):
        img = re.sub(r"\$\((\w+)\)", lambda v: mkvars.get(v.group(1), ""), t)
        out.add(img.split(":")[0])
    return out


def check_build_plane(docs: List[dict]) -> None:
    scripts = console_scripts()
    ours = {k: v for k, v in scripts.items() if v.startswith(PACKAGE + ".")}
    check(bool(ours), f"port console scripts declared: {sorted(ours)}")
    for name, target in sorted(ours.items()):
        check(port_target(target), f"console script {name} -> {target} "
              "is defined")
    built = makefile_images()
    for comp in COMPONENTS:
        df = HERE / f"Dockerfile.{comp}"
        check(df.exists(), f"{df.name} exists")
        if not df.exists():
            continue
        text = df.read_text()
        for line in text.splitlines():
            m = re.match(r"^\s*COPY\s+(?!--from)(\S+)\s+\S+", line)
            if m:
                check((REPO / m.group(1)).exists(),
                      f"{df.name}: COPY source {m.group(1)} exists")
            m = re.match(r'^\s*ENTRYPOINT\s+\["([^"]+)"', line)
            if m:
                check(m.group(1) in ours,
                      f"{df.name}: entrypoint {m.group(1)} is a port "
                      "console script")
        # a RUN's continuation lines are one command with it
        runs = text.replace("\\\n", " ")
        check(not re.search(r"^\s*RUN\b.*\btorch\b", runs, re.M),
              f"{df.name}: installs no torch")
    for doc in docs:
        for tpl in iter_pod_specs(doc):
            for c in tpl["spec"].get("containers", []):
                img = c.get("image", "").split(":")[0]
                if img.startswith(PREFIX):
                    comp = img[len(PREFIX) + 1:]
                    check((HERE / f"Dockerfile.{comp}").exists(),
                          f"image {img} has Dockerfile.{comp}")
                    check(img in built, f"image {img} is built by `make "
                          f"gpu-docker-build` (builds {sorted(built)})")
                cmd = c.get("command") or []
                if not cmd:
                    continue
                who = tpl.get("metadata", {}).get("name") \
                    or doc["metadata"]["name"]
                if cmd[0].startswith("tpuslice"):
                    check(cmd[0] in ours, f"{who}: command {cmd[0]} is a "
                          "port console script")
                elif cmd[:2] == ["python", "-m"]:
                    check(port_module(cmd[2]),
                          f"{who}: python -m {cmd[2]} is a port module")


def namespaced(doc: dict) -> dict:
    """``doc`` in the ``default`` namespace, as ``kubectl apply`` puts a
    sample without one."""
    out = copy.deepcopy(doc)
    if out.get("kind") in ("Pod", "Service", "ConfigMap"):
        out["metadata"].setdefault("namespace", "default")
    return out


def main() -> int:
    on_disk = read_tree(gen_manifests.CONFIG)
    want = tree()
    check(set(on_disk) == set(want)
          and all(on_disk[k][1] == want[k][1] for k in want),
          "deploy/config equals instaslice_tpu_torch.deploy.manifests "
          "(run python -m instaslice_tpu_torch.deploy.gen_manifests)")
    docs = render(on_disk, "default")
    check(len(docs) >= 10, f"rendered {len(docs)} manifests")
    check_apply(docs)
    check_cross_references(docs)
    check_gpu_nodes(docs)
    sample_files = read_tree(gen_manifests.SAMPLES)
    check({k: v[1] for k, v in sample_files.items()}
          == {k: v[1] for k, v in samples().items()},
          "deploy/samples equals instaslice_tpu_torch.deploy.manifests")
    sample_docs = [d for _, ds in sample_files.values() for d in ds]
    check_build_plane(docs + sample_docs)
    pods = [d for doc in sample_docs for d in (
        doc.get("items", []) if doc.get("kind") == "List" else [doc])]
    check_apply([namespaced(d) for d in pods
                 if d.get("kind") in ("Pod", "ConfigMap", "Service")],
                "apply sample")
    print(f"\n{'FAILED' if FAILURES else 'OK'}: {len(FAILURES)} failures")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
