"""The port's device handoff (``agent/handoff.py``) and allocation records
(``api/types.py``) against the JAX package's.

For the same ``PodRef`` and allocation (placed by each package's own
engine), every key the reference's ``slice_env`` writes is equal in the
port's, on each TPU generation, one host and two; the port adds
``NVIDIA_VISIBLE_DEVICES``/``CUDA_VISIBLE_DEVICES`` when a reservation
grants UUIDs. For a MIG slice and a whole GPU (a fake reservation) the
env holds the granted UUIDs and the port's ``SliceTopology.from_env``
reads one device back. Tolerance: exact.
"""

import dataclasses

import pytest

from instaslice_tpu.agent import handoff as jhand
from instaslice_tpu.api import types as jtypes
from instaslice_tpu.topology import grid as jgrid
from instaslice_tpu.topology import placement as jplace
from instaslice_tpu.topology import policy as jpolicy
from instaslice_tpu.topology import profiles as jprof
from instaslice_tpu_torch.agent import handoff as thand
from instaslice_tpu_torch.api import types as ttypes
from instaslice_tpu_torch.device import FakeGpuBackend
from instaslice_tpu_torch.parallel.meshenv import SliceTopology
from instaslice_tpu_torch.topology import grid as tgrid
from instaslice_tpu_torch.topology import mig
from instaslice_tpu_torch.topology import placement as tplace
from instaslice_tpu_torch.topology import policy as tpolicy
from instaslice_tpu_torch.topology import profiles as tprof

J = (jgrid, jplace, jpolicy, jprof, jtypes, jhand)
T = (tgrid, tplace, tpolicy, tprof, ttypes, thand)
#: (generation, profile, hosts along x)
CASES = [("v5e", "v5e-2x2", 1), ("v5e", "v5e-2x4", 1), ("v5e", "v5e-4x4", 2),
         ("v6e", "v6e-1x1", 1), ("v4", "v4-2x2x1", 1), ("v4", "v4-4x2x1", 2),
         ("v5p", "v5p-2x2x1", 1), ("v5p", "v5p-4x2x1", 2)]


def _alloc(pkg, gen_name, profile, hosts):
    """The allocation of ``profile`` first-fit in a group of ``hosts``
    hosts along x, one pod a host, and its pods."""
    grid, place, policy, prof, types, _ = pkg
    gen = grid.get_generation(gen_name)
    hb = gen.host_bounds
    group = grid.TorusGroup("g", gen, (hb[0] * hosts, hb[1], hb[2]), {
        f"node-{h}": grid.NodeGrid(gen, (h * hb[0], 0, 0), "g")
        for h in range(hosts)})
    pl = policy.get_policy("first-fit").choose(
        group, prof.parse_profile_name(profile), place.Occupancy(group))
    pods = [types.PodRef(f"uid-{w}", f"worker-{w}", "ns", worker_id=w)
            for w in range(len(pl.parts))]
    return types.AllocationDetails.from_placement(
        pl, pods, alloc_id="grp-1", now=0.0, trace_id="t1"), pods


@pytest.mark.parametrize("gen,profile,hosts", CASES)
def test_reference_keys_equal(gen, profile, hosts):
    aj, pods_j = _alloc(J, gen, profile, hosts)
    at, pods_t = _alloc(T, gen, profile, hosts)
    dj, dt = aj.to_dict(), at.to_dict()
    for d in (dj, dt):
        for tr in d["transitions"]:
            tr.pop("ts")
    assert dj == dt
    for pj, pt in zip(pods_j, pods_t):
        node = aj.node_for_worker(pj.worker_id)
        want = jhand.slice_env(aj, pj, node, gen)
        assert thand.slice_env(at, pt, node, gen) == want
        got = thand.slice_env(at, pt, node, gen, ("GPU-a", "GPU-b"))
        assert {k: got[k] for k in want} == want
        assert got["CUDA_VISIBLE_DEVICES"] == \
            got["NVIDIA_VISIBLE_DEVICES"] == "GPU-a,GPU-b"
        topo = SliceTopology.from_env(want)
        assert (topo.worker_id, topo.num_workers, topo.profile) == \
            (pj.worker_id, hosts, aj.profile)
        assert thand.configmap_manifest(pj.handoff, "ns", want, "uid") == \
            jhand.configmap_manifest(pj.handoff, "ns", want, "uid")


def test_missing_worker_raises_alike():
    aj, _ = _alloc(J, "v5e", "v5e-2x2", 1)
    at, _ = _alloc(T, "v5e", "v5e-2x2", 1)
    with pytest.raises(ValueError) as ej:
        jhand.slice_env(aj, jtypes.PodRef("u", "p", "ns", worker_id=3),
                        "node-0", "v5e")
    with pytest.raises(ValueError) as et:
        thand.slice_env(at, ttypes.PodRef("u", "p", "ns", worker_id=3),
                        "node-0", "v5e")
    assert str(ej.value) == str(et.value)


def test_transitions_and_slice_uuids_equal():
    statuses = list(jtypes.AllocationStatus)
    for old in statuses:
        for new in statuses:
            outs = []
            for types in (jtypes, ttypes):
                try:
                    types.check_transition(types.AllocationStatus(old.value),
                                           types.AllocationStatus(new.value))
                    outs.append("ok")
                except ValueError as e:
                    outs.append(str(e))
            assert outs[0] == outs[1]
    for mh in (False, True):
        assert ttypes.slice_uuid_for("a-1", mh) == \
            jtypes.slice_uuid_for("a-1", mh)
    pr = jtypes.PodRef("u", "p", "ns", 2, "h")
    assert dataclasses.asdict(ttypes.PodRef.from_dict(pr.to_dict())) == \
        dataclasses.asdict(pr)


def _mig_alloc(profile_name):
    """First-fit ``profile_name`` on a fake node of 2 GPUs, reserved
    there: (allocation, pod, reservation)."""
    group = mig.gpu_group(2)
    occ = tplace.Occupancy(group)
    occ.occupy(mig.slot_box(0, 0, 8))               # GPU 0 is taken
    pl = tpolicy.get_policy("first-fit").choose(
        group, mig.parse_mig_profile(profile_name), occ)
    pod = ttypes.PodRef("uid-m", "pod-m", "ns")
    alloc = ttypes.AllocationDetails.from_placement(pl, [pod], now=0.0)
    gpu, start = mig.box_gpu_start(pl.box)
    fake = FakeGpuBackend(gpu_count=2, mig=profile_name != "gpu")
    res = fake.reserve(ttypes.slice_uuid_for(alloc.alloc_id), [gpu],
                       "" if profile_name == "gpu" else profile_name, start)
    return alloc, pod, res


@pytest.mark.parametrize("profile", ["3g.40gb", "1g.10gb", "gpu"])
def test_gpu_slice_env_reads_back_one_device(profile):
    alloc, pod, res = _mig_alloc(profile)
    env = thand.slice_env(alloc, pod, "node-a", mig.H100_80GB,
                          res.device_uuids)
    (uuid,) = res.device_uuids
    assert uuid.startswith("MIG-" if profile != "gpu" else "GPU-")
    assert env["CUDA_VISIBLE_DEVICES"] == env["NVIDIA_VISIBLE_DEVICES"] \
        == uuid
    assert (env["TPU_SLICE_PROFILE"], env["TPU_SLICE_NAME"],
            env["TPU_SLICE_NODE"]) == (profile, "uid-m", "node-a")
    assert env["TPU_VISIBLE_CHIPS"] == "0"
    topo = SliceTopology.from_env(env)
    assert (topo.num_chips, topo.num_workers, topo.worker_id,
            topo.profile) == (1, 1, 0, profile)
    assert res.chip_ids == (1,)                      # GPU 0 was taken
    with pytest.raises(ValueError, match="device UUIDs"):
        thand.slice_env(alloc, pod, "node-a", mig.H100_80GB)
