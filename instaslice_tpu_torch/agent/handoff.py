"""Device handoff: the env a granted pod consumes via ``envFrom``.

Reference analog: ``createConfigMap`` publishing ``NVIDIA_VISIBLE_DEVICES``
/ ``CUDA_VISIBLE_DEVICES`` in a ConfigMap named after the pod
(``instaslice_daemonset.go:796-818``; consumer side
``samples/test-pod.yaml:17-19``).

A copy of ``instaslice_tpu/agent/handoff.py`` (the port imports nothing
of the JAX package), which computes the TPU topology environment: the
local chips a pod may open, where its host sits in the slice mesh, and
who its peer workers are. The port adds InstaSlice's own keys back: the
UUIDs a reservation grants (``GPU-…`` for whole GPUs, ``MIG-…`` for a
MIG instance) go in ``NVIDIA_VISIBLE_DEVICES`` and
``CUDA_VISIBLE_DEVICES``. On a TPU generation every other key is the
reference's; on a MIG grid (:mod:`~instaslice_tpu_torch.topology.mig`)
the slice is the devices it grants, one CUDA device each, so
``TPU_VISIBLE_CHIPS`` counts them (``0..n-1``, as CUDA numbers what it
sees) and the chip bounds are ``n,1,1``: what
``SliceTopology.from_env`` (``parallel/meshenv.py``) reads to build the
workload's mesh.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from instaslice_tpu_torch.api.constants import POD_UID_LABEL
from instaslice_tpu_torch.api.types import AllocationDetails, PodRef
from instaslice_tpu_torch.topology.grid import (
    Shape,
    coord_to_id,
    get_generation,
)
from instaslice_tpu_torch.topology.mig import mig_catalog
from instaslice_tpu_torch.topology.placement import Box


def _csv(vals) -> str:
    return ",".join(str(v) for v in vals)


def slice_env(
    alloc: AllocationDetails,
    pod: PodRef,
    node_name: str,
    generation: str,
    device_uuids: Sequence[str] = (),
) -> Dict[str, str]:
    """Env for ``pod`` (worker ``pod.worker_id``) of ``alloc``;
    ``device_uuids`` are the UUIDs the node's reservation grants (a MIG
    grid needs them).

    Multi-host note: peer addressing uses pod names; multi-host sample
    manifests set ``hostname:`` + ``subdomain:`` with a headless Service so
    these resolve over DCN (see samples/).
    """
    gen = get_generation(generation)
    node = alloc.node_for_worker(pod.worker_id)
    if node is None:
        raise ValueError(
            f"allocation {alloc.alloc_id} has no part serving worker "
            f"{pod.worker_id}"
        )
    wid, local_key = alloc.parts[node]
    local_box = Box.from_key(local_key)
    global_box = alloc.global_box()
    part_shape = local_box.shape
    # All parts share one shape (alignment guarantees whole-tile splits):
    # hosts along each axis = global extent / per-host extent.
    host_bounds: Shape = tuple(
        global_box.shape[i] // part_shape[i] for i in range(3)
    )  # type: ignore[assignment]
    if mig_catalog(generation) is None:
        chip_ids = _local_ids(local_box, gen.host_bounds)
        chips_shape = part_shape
    else:
        if not device_uuids:
            raise ValueError(
                f"allocation {alloc.alloc_id} is on a MIG grid: its env "
                "needs the device UUIDs the reservation grants")
        chip_ids = list(range(len(device_uuids)))
        chips_shape = (len(device_uuids), 1, 1)
    workers = sorted(alloc.pods, key=lambda p: p.worker_id)
    hostnames = _csv(p.pod_name for p in workers)

    env = {
        # --- libtpu topology (what jax.distributed / libtpu read) ---
        "TPU_WORKER_ID": str(pod.worker_id),
        "TPU_WORKER_HOSTNAMES": hostnames,
        "TPU_VISIBLE_CHIPS": _csv(chip_ids),
        "TPU_CHIPS_PER_HOST_BOUNDS": _csv(chips_shape),
        "TPU_HOST_BOUNDS": _csv(host_bounds),
        # newer libtpu spellings of the same facts
        "TPU_CHIPS_PER_PROCESS_BOUNDS": _csv(chips_shape),
        "TPU_PROCESS_BOUNDS": _csv(host_bounds),
        "CLOUD_TPU_TASK_ID": str(pod.worker_id),
        "TPU_SKIP_MDS_QUERY": "true",
        "TPU_ACCELERATOR_TYPE": f"{generation}-{alloc.profile.split('-', 1)[1]}"
        if "-" in alloc.profile
        else alloc.profile,
        # --- slice identity (observability + tpuslicectl) ---
        "TPU_SLICE_NAME": alloc.alloc_id,
        "TPU_SLICE_PROFILE": alloc.profile,
        "TPU_SLICE_BOX": alloc.box,
        "TPU_SLICE_NODE": node_name,
    }
    if device_uuids:
        # --- InstaSlice's handoff: the granted devices, by UUID ---
        env["NVIDIA_VISIBLE_DEVICES"] = _csv(device_uuids)
        env["CUDA_VISIBLE_DEVICES"] = _csv(device_uuids)
    return env


def _local_ids(local_box: Box, host_bounds: Shape) -> List[int]:
    return sorted(coord_to_id(c, host_bounds) for c in local_box.coords())


def configmap_manifest(
    name: str, namespace: str, env: Dict[str, str], owner_pod_uid: str = ""
) -> dict:
    """ConfigMap named after the pod (reference convention), labeled for
    garbage collection and discovery."""
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {
                "app.kubernetes.io/managed-by": "instaslice-tpu",
                POD_UID_LABEL: owner_pod_uid,
            },
        },
        "data": dict(env),
    }
