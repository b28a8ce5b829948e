"""The port's rendezvous smoke (``instaslice_tpu_torch/parallel/dcn_smoke.py``)
in two CPU processes over gloo, each with its worker's env of a two-host
grant built by the port's own pipeline (placement engine ->
``AllocationDetails`` -> ``agent/handoff.py``'s ``slice_env``), as the
reference's ``tests/test_distributed.py::TestDcnRendezvous`` builds its
own. Both print the reference's keys and ``psum_total`` 3.0 (1 + 2, one
local device each). The control: a worker given the wrong
``TPU_WORKER_ID`` (both claim 0) never makes a world of two, and fails
within its timeout.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import free_port
from instaslice_tpu_torch.agent.handoff import slice_env
from instaslice_tpu_torch.api.types import AllocationDetails, PodRef
from instaslice_tpu_torch.topology.grid import (
    NodeGrid,
    TorusGroup,
    get_generation,
)
from instaslice_tpu_torch.topology.placement import legal_placements
from instaslice_tpu_torch.topology.profiles import parse_profile_name

REPO = Path(__file__).resolve().parents[1]
KEYS = {"worker_id", "num_workers", "processes_seen", "global_devices",
        "local_devices", "psum_total"}


def worker_envs():
    """The handoff env of both workers of a two-host v5e-4x4 grant."""
    gen = get_generation("v5e")
    hosts = {
        "node-0": NodeGrid(gen, host_offset=(0, 0, 0), torus_group="g"),
        "node-1": NodeGrid(gen, host_offset=(2, 0, 0), torus_group="g"),
    }
    group = TorusGroup("g", gen, (4, 4, 1), hosts)
    placement = legal_placements(group, parse_profile_name("v5e-4x4"))[0]
    pods = [PodRef(f"uid-{p.worker_id}", f"worker-{p.worker_id}",
                   "default", worker_id=p.worker_id)
            for p in placement.parts]
    alloc = AllocationDetails.from_placement(placement, pods)
    return [slice_env(alloc, pod, placement.parts[i].node_name, "v5e")
            for i, pod in enumerate(pods)]


def spawn(envs, timeout):
    port = free_port()
    procs = []
    for env in envs:
        child = dict(os.environ, **env)
        # pod names resolve over the cluster's headless Service; here
        # both workers are this host
        child["TPU_WORKER_HOSTNAMES"] = "127.0.0.1,127.0.0.1"
        child["TPUSLICE_SMOKE_PORT"] = str(port)
        child["TPUSLICE_SMOKE_DEVICE"] = "cpu"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "instaslice_tpu_torch.parallel.dcn_smoke"],
            cwd=REPO, env=child, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        outs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


def test_two_workers_meet_and_sum():
    envs = worker_envs()
    assert [e["TPU_WORKER_ID"] for e in envs] == ["0", "1"]
    outs = spawn(envs, timeout=120)
    assert None not in outs
    lines = []
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
        lines.append(json.loads(out.strip().splitlines()[-1]))
    for line in lines:
        assert set(line) == KEYS
        assert (line["num_workers"], line["processes_seen"],
                line["global_devices"], line["local_devices"]) == (2, 2, 2, 1)
        assert line["psum_total"] == 3.0
    assert sorted(line["worker_id"] for line in lines) == [0, 1]


def test_a_wrong_worker_id_misses():
    envs = worker_envs()
    envs[1]["TPU_WORKER_ID"] = "0"        # both claim rank 0
    outs = spawn(envs, timeout=10)
    totals = [json.loads(o[1].strip().splitlines()[-1])["psum_total"]
              for o in outs if o is not None and o[0] == 0 and o[1].strip()]
    assert None in outs or any(o[0] != 0 for o in outs) or \
        totals != [3.0, 3.0]
