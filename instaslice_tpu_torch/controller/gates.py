"""Pod inspection: gate detection, profile extraction, group membership.

Reference analogs:
- ``checkIfPodGated`` (``instaslice_controller.go:386-395``) — which
  indexes ``pod.Status.Conditions[0]`` unguarded (SURVEY.md §7 quirk);
  guarded here.
- ``extractProfileName`` (``:265-280``) — regex ``(\\d+g\\.\\d+gb)`` over
  limits keys containing "nvidia"; silently returns "" on no match. Here
  malformed profile requests raise, and the error lands on the pod as an
  event/annotation rather than being swallowed.

A copy of ``instaslice_tpu/controller/gates.py`` (the port imports
nothing of the JAX package). :func:`extract_profile` keeps its
annotation and ``tpu`` rules and takes InstaSlice's for limit keys that
contain "nvidia": ``nvidia.com/mig-3g.40gb`` is a MIG profile by the
``(\\d+g\\.\\d+gb)`` rule and ``nvidia.com/gpu`` the whole GPU
(:func:`~instaslice_tpu_torch.topology.mig.parse_mig_profile` on the
H100 80GB's catalog; each GPU group reads it against its own,
:func:`~instaslice_tpu_torch.controller.gpugrid.group_profile`). A malformed or unknown
MIG name raises, where InstaSlice's returns "". The profile annotation
also takes a GPU grid's names (``3g.40gb``, ``gpu``:
:func:`~instaslice_tpu_torch.controller.gpugrid.parse_profile`), as the
sim's pods carry them.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

# Annotation names live in api/constants.py (the one literal-bearing
# module — slicelint's name-literal rule); re-exported here because this
# module is their established import path for the control plane.
# HANDOFF_ANNOTATION: stable handoff name for template-managed pods
# (Deployment/Job pods get generated names; their template's envFrom +
# per-pod resource limit need a fixed name — see samples/vllm-tpu.yaml).
# UNHEALTHY/RESTART_ON_FAILURE: slice health (no reference analog —
# SURVEY.md §5 gap). The agent stamps UNHEALTHY_ANNOTATION on a running
# pod whose granted chips fail; pods opting in with
# RESTART_ON_FAILURE_ANNOTATION="true" are deleted instead so their
# managing controller respawns them onto a fresh slice.
from instaslice_tpu_torch.api.constants import (  # noqa: F401 (re-exports)
    ERROR_ANNOTATION,
    GATE_NAME,
    GROUP_ANNOTATION,
    GROUP_SIZE_ANNOTATION,
    HANDOFF_ANNOTATION,
    LEGACY_GATE_NAME,
    PROFILE_ANNOTATION,
    RESTART_ON_FAILURE_ANNOTATION,
    UNHEALTHY_ANNOTATION,
)
from instaslice_tpu_torch.controller.gpugrid import parse_profile
from instaslice_tpu_torch.topology.mig import parse_mig_profile
from instaslice_tpu_torch.topology.profiles import TopologyProfile, parse_profile_name

_RESOURCE_RE = re.compile(r"tpu-(v\d+[a-z]*-\d+x\d+(?:x\d+)?)$")


def is_pod_gated(pod: dict) -> bool:
    """True when the pod carries our scheduling gate and is not yet
    scheduled. Phase may be missing entirely on a just-created pod —
    everything is .get-guarded (the reference crashes on pods with empty
    Conditions)."""
    if pod.get("metadata", {}).get("deletionTimestamp"):
        return False
    gates = pod.get("spec", {}).get("schedulingGates", []) or []
    # LEGACY_GATE_NAME: pods gated by a reference-era webhook carry the
    # original (misspelled) org.instaslice gate; honoring it keeps a
    # migration from stranding them Pending forever
    if not any(g.get("name") in (GATE_NAME, LEGACY_GATE_NAME)
               for g in gates):
        return False
    phase = pod.get("status", {}).get("phase", "Pending")
    return phase in ("", "Pending")


def extract_profile(pod: dict) -> Optional[TopologyProfile]:
    """Profile from (in priority order):

    1. annotation ``tpu.instaslice.dev/profile: v5e-2x2`` (or a GPU
       grid's ``3g.40gb``, ``gpu``)
    2. a resource limit key like ``google.com/tpu-v5e-2x2``, or one that
       contains "nvidia": ``nvidia.com/mig-3g.40gb``, ``nvidia.com/gpu``

    Returns None when the pod requests no TPU or GPU profile; raises
    ValueError for a malformed one.
    """
    meta = pod.get("metadata", {})
    ann = (meta.get("annotations") or {}).get(PROFILE_ANNOTATION)
    if ann:
        return parse_profile(ann)
    for ctr in pod.get("spec", {}).get("containers", []) or []:
        limits = (ctr.get("resources") or {}).get("limits") or {}
        for key in limits:
            if "tpu" not in key:
                if "nvidia" in key:
                    return parse_mig_profile(key)
                continue
            m = _RESOURCE_RE.search(key)
            if m:
                return parse_profile_name(m.group(1))
    return None


def pod_group(pod: dict) -> Tuple[str, int]:
    """(group id, expected size) for multi-host pod groups; ("", 1) for
    singletons. Group pods share one allocation: one pod per host of a
    multi-host slice, worker ids assigned by sorted pod name."""
    ann = pod.get("metadata", {}).get("annotations") or {}
    gid = ann.get(GROUP_ANNOTATION, "")
    if not gid:
        return "", 1
    try:
        size = int(ann.get(GROUP_SIZE_ANNOTATION, "0"))
    except ValueError:
        raise ValueError(
            f"pod {pod['metadata'].get('name')}: malformed "
            f"{GROUP_SIZE_ANNOTATION}"
        )
    if size < 1:
        raise ValueError(
            f"pod group {gid!r} needs {GROUP_SIZE_ANNOTATION} >= 1"
        )
    return gid, size
