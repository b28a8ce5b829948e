"""The port's device layer (``instaslice_tpu_torch.device``) on the CPU.

The reference's backend contract (``tests/test_device.py``: discover,
the reserve/release cycle, overlap, duplicate, unknown, empty, unknown
chip, concurrent reserves never double-granted) runs over three
backends (with MIG mode off: a GPU with MIG on is granted only by MIG
slices): the fake, the fake over the crash-safe registry, and the NVML
backend over a stub ``libnvidia-ml.so.1`` built with ``g++`` from
``tests/nvml_stub.c`` at test time (as the reference's tests build
``native/`` and point it at a synthetic ``/dev`` tree). The stub scripts
GPUs, MIG mode, placements, lost GPUs and refused creates, and keeps its
instances in a file, so spawned processes see them: restart survival and
cross-process exclusivity are held there. Then MIG slices on every
backend, selection without a device, and the registry's own files.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from instaslice_tpu_torch.device import (
    ChipsBusy,
    DeviceError,
    FakeGpuBackend,
    NvmlBackend,
    NvmlError,
    Registry,
    Reservation,
    SliceExists,
    SliceNotFound,
    TracedBackend,
    select_backend,
)
from instaslice_tpu_torch.topology import mig

REPO = Path(__file__).resolve().parents[1]
STUB = Path(__file__).resolve().parent / "nvml_stub.c"


@pytest.fixture(scope="session")
def stub_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("nvml") / "libnvidia-ml.so.1"
    subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-o", str(out),
                    str(STUB)], check=True, capture_output=True)
    return str(out)


@pytest.fixture
def stub(tmp_path, monkeypatch, stub_lib):
    """Write the stub's state file (8 GPUs, MIG on unless ``lines`` say
    otherwise) and point the stub at it; returns a function that builds
    an NVML backend over a registry in ``tmp_path``."""
    state = tmp_path / "nvml_state"
    monkeypatch.setenv("NVML_STUB_STATE", str(state))
    reg = tmp_path / "registry"

    def make(lines="gpus 8\n", **kw):
        state.write_text(lines)
        return NvmlBackend(library_path=stub_lib, registry_dir=str(reg),
                           **kw)

    make.state, make.registry, make.lib = state, reg, stub_lib
    return make


def make_backend(kind, tmp_path, stub, mig=False):
    """8 GPUs; ``mig``: MIG mode on every GPU (True), none (False) or
    the GPUs listed."""
    if kind == "fake":
        return FakeGpuBackend(gpu_count=8, mig=mig)
    if kind == "registry":
        return FakeGpuBackend(gpu_count=8, mig=mig,
                              registry_dir=str(tmp_path / "r"))
    on = range(8) if mig is True else () if mig is False else mig
    return stub("gpus 8\n" + "".join(
        f"mig {g} 0 0\n" for g in range(8) if g not in on))


@pytest.fixture(params=["fake", "registry", "nvml"])
def node(request, tmp_path, stub):
    """A function of ``mig`` that builds the backend of this kind."""
    return lambda mig: make_backend(request.param, tmp_path, stub, mig)


@pytest.fixture
def backend(node):
    """MIG off on every GPU: the reference's contract of whole chips."""
    return node(False)


@pytest.fixture
def mig_backend(node):
    return node(True)


class TestBackendContract:
    def test_discover(self, backend):
        inv = backend.discover()
        assert inv.generation == mig.H100_80GB
        assert inv.chip_count == 8
        assert inv.chip_paths[0].endswith("nvidia0")
        assert [g.index for g in inv.gpus] == list(range(8))
        g = inv.gpus[3]
        assert g.uuid.startswith("GPU-") and "H100 80GB" in g.name
        assert g.memory_bytes >= 80 * 10 ** 9 and g.power_limit_w == 700.0
        assert (g.mig_current, g.mig_pending) == (0, 0)
        assert (g.profiles, g.profiles_error) == \
            ((), "NVML_ERROR_NOT_SUPPORTED")

    def test_reserve_release_cycle(self, backend):
        r = backend.reserve("s-1", [0, 1, 2, 3])
        assert r.chip_ids == (0, 1, 2, 3)
        inv = backend.discover()
        assert r.device_uuids == tuple(inv.gpus[i].uuid for i in range(4))
        assert [x.slice_uuid for x in backend.list_reservations()] == ["s-1"]
        backend.release("s-1")
        assert backend.list_reservations() == []

    def test_overlap_rejected(self, backend):
        backend.reserve("s-1", [0, 1])
        with pytest.raises(ChipsBusy):
            backend.reserve("s-2", [1, 2])
        backend.reserve("s-2", [2, 3])  # disjoint is fine

    def test_duplicate_uuid_rejected(self, backend):
        backend.reserve("s-1", [0])
        with pytest.raises(SliceExists):
            backend.reserve("s-1", [4])

    def test_release_unknown(self, backend):
        with pytest.raises(SliceNotFound):
            backend.release("nope")

    def test_empty_args_rejected(self, backend):
        with pytest.raises(DeviceError):
            backend.reserve("", [0])
        with pytest.raises(DeviceError):
            backend.reserve("s", [])

    def test_unknown_chip_rejected(self, backend):
        with pytest.raises(DeviceError, match="not on this host"):
            backend.reserve("s", [99])

    def test_concurrent_reserves_no_double_grant(self, backend):
        """16 threads race for 8 GPUs; every GPU granted once."""
        granted, busy, errs = [], [], []

        def worker(i):
            try:
                granted.append(backend.reserve(f"c-{i}", [i % 8]).chip_ids)
            except ChipsBusy:
                busy.append(i)
            except DeviceError as e:  # pragma: no cover
                errs.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in ts)
        assert not errs and len(busy) == 8
        assert sorted(c for ids in granted for c in ids) == list(range(8))


class TestMigSlices:
    def test_discover_reads_the_catalog(self, mig_backend):
        for g in mig_backend.discover().gpus:
            assert (g.mig_current, g.mig_pending) == (1, 1)
            assert mig.compare_catalog(g.profiles) == []

    def test_slices_side_by_side_and_release(self, mig_backend):
        backend = mig_backend
        a = backend.reserve("a", [0], "4g.40gb", 0)
        b = backend.reserve("b", [0], "3g.40gb", 4)
        assert a.device_uuids[0].startswith("MIG-") and a.gpu == 0
        assert a.gpu_instance != b.gpu_instance
        assert a.device_uuids != b.device_uuids
        with pytest.raises(ChipsBusy):
            backend.reserve("c", [0], "1g.10gb", 6)
        with pytest.raises(ChipsBusy):    # the whole GPU holds every slot
            backend.reserve("d", [0])
        backend.release("a")
        backend.reserve("c", [0], "2g.20gb", 2)
        assert [r.slice_uuid for r in backend.list_reservations()] == \
            ["b", "c"]
        assert backend.dangling() == []

    def test_illegal_requests(self, mig_backend):
        backend = mig_backend
        with pytest.raises(DeviceError, match="cannot start"):
            backend.reserve("s", [0], "4g.40gb", 4)
        with pytest.raises(DeviceError, match="one GPU"):
            backend.reserve("s", [0, 1], "1g.10gb", 0)
        with pytest.raises(DeviceError, match="not in the h100-80gb"):
            backend.reserve("s", [0], "nvidia.com/mig-9g.90gb", 0)
        assert backend.list_reservations() == []

    def test_whole_gpu_then_mig_refused(self, node):
        backend = node({3})     # MIG on GPU 3 alone
        backend.reserve("w", [2])
        with pytest.raises(ChipsBusy):
            backend.reserve("m", [2], "1g.10gb", 3)
        backend.reserve("m", [3], "1g.10gb", 3)

    def test_whole_gpu_refused_where_mig_is_on(self, node):
        backend = node({3})
        with pytest.raises(DeviceError, match="MIG mode on") as e:
            backend.reserve("w", [2, 3])
        assert not isinstance(e.value, ChipsBusy)
        assert backend.list_reservations() == []
        # control: the same request without the MIG GPU is granted
        assert backend.reserve("w", [1, 2]).chip_ids == (1, 2)


class TestChipHealth:
    def test_all_healthy_by_default(self, backend):
        h = backend.chip_health()
        assert len(h) == 8 and all(h.values())

    def test_fake_fail_and_heal(self):
        b = FakeGpuBackend(gpu_count=8, mig=False)
        b.fail_chip(3)
        h = b.chip_health()
        assert h[3] is False and h[0] is True
        with pytest.raises(DeviceError, match="unhealthy"):
            b.reserve("s", [2, 3])
        b.heal_chip(3)
        assert b.chip_health()[3] is True
        b.reserve("s", [2, 3])

    def test_nvml_lost_and_vanished_gpus(self, stub):
        b = stub("gpus 4\nmig 3 0 0\n")
        b.discover()
        b.reserve("s", [3])
        # GPU 1 falls off the bus; GPU 3 (reserved) leaves the count
        stub.state.write_text("gpus 3\nlost 1\n")
        b2 = NvmlBackend(library_path=stub.lib,
                         registry_dir=str(stub.registry))
        assert b2.chip_health() == {0: True, 1: False, 2: True, 3: False}
        with pytest.raises(NvmlError, match="NVML_ERROR_GPU_IS_LOST"):
            b2.reserve("t", [1])


class TestRefusals:
    def test_fake_refused_create_leaves_nothing(self):
        b = FakeGpuBackend(gpu_count=2)
        b.inject_failures("create", nvml_error="NVML_ERROR_NO_PERMISSION")
        with pytest.raises(DeviceError, match="NVML_ERROR_NO_PERMISSION"):
            b.reserve("s", [0], "3g.40gb", 0)
        assert b.list_reservations() == [] and b._instances == {}
        b.reserve("s", [0], "3g.40gb", 0)     # one failure injected

    def test_fake_mig_off(self):
        b = FakeGpuBackend(gpu_count=1, mig=False)
        g = b.discover().gpus[0]
        assert (g.mig_current, g.profiles, g.profiles_error) == \
            (0, (), "NVML_ERROR_NOT_SUPPORTED")
        with pytest.raises(DeviceError, match="NVML_ERROR_INVALID_STATE"):
            b.reserve("s", [0], "1g.10gb", 0)
        assert b.reserve("s", [0]).device_uuids[0].startswith("GPU-")

    def test_nvml_refused_gpu_instance(self, stub):
        b = stub("gpus 1\nrefuse 4\n")
        with pytest.raises(NvmlError) as e:
            b.reserve("s", [0], "3g.40gb", 4)
        assert e.value.code_name == "NVML_ERROR_NO_PERMISSION"
        assert e.value.call == "nvmlDeviceCreateGpuInstanceWithPlacement"
        assert b.list_reservations() == [] and b.instances() == []

    def test_nvml_refused_compute_instance_rolls_back(self, stub):
        b = stub("gpus 1\nrefuse_ci 23\n")
        with pytest.raises(NvmlError, match="INSUFFICIENT_RESOURCES"):
            b.reserve("s", [0], "2g.20gb", 2)
        assert b.list_reservations() == [] and b.instances() == []
        assert "gi " not in stub.state.read_text()

    def test_nvml_mig_off_and_not_supported(self, stub):
        b = stub("gpus 2\nmig 0 0 0\nmig 1 -1 -1\n")
        gpus = b.discover().gpus
        assert (gpus[0].mig_current, gpus[0].profiles_error) == \
            (0, "NVML_ERROR_NOT_SUPPORTED")
        assert gpus[1].mig_current is None and gpus[1].profiles == ()
        with pytest.raises(NvmlError, match="NVML_ERROR_NOT_SUPPORTED"):
            b.reserve("m", [0], "1g.10gb", 0)
        assert b.reserve("w", [1]).chip_ids == (1,)
        assert b.instances() == []


class TestDangling:
    def test_nvml_unrecorded_instance_reported_never_reaped(self, stub):
        # a 3g.40gb at slot 4 of GPU 0 that no record holds
        b = stub("gpus 2\nnext 7\ngi 0 6 9 4 4 0\n")
        (d,) = b.dangling()
        assert (d.slice_uuid, d.gpu, d.profile, d.start, d.gpu_instance) \
            == ("", 0, "3g.40gb", 4, 6)
        assert d.device_uuids[0] in {
            m["uuid"] for m in b.discover().gpus[0].mig_devices}
        assert b.list_reservations() == []
        with pytest.raises(ChipsBusy, match="unrecorded"):
            b.reserve("x", [0], "1g.10gb", 5)
        with pytest.raises(ChipsBusy, match="unrecorded"):
            b.reserve("y", [0])
        b.reserve("x", [0], "4g.40gb", 0)      # beside it: free
        b.reserve("z", [1], "3g.40gb", 4)
        assert {(i.slice_uuid, i.gpu, i.start) for i in b.instances()} == \
            {("", 0, 4), ("x", 0, 0), ("z", 1, 4)}
        assert "gi 0 6 9 4 4 0" in stub.state.read_text()

    def test_nvml_instance_outside_the_catalog(self, stub):
        # a 1g.10gb+me (NVML profile id 20, not in the catalog) at slot 3
        b = stub("gpus 2\nnext 7\ngi 0 6 20 3 1 0\n")
        (d,) = b.dangling()
        assert (d.profile, d.start, d.size, d.slots) == \
            ("profile-20", 3, 1, (3, 1))
        with pytest.raises(ChipsBusy, match="unrecorded"):
            b.reserve("x", [0], "1g.10gb", 3)
        with pytest.raises(ChipsBusy, match="unrecorded"):
            b.reserve("y", [0], "3g.40gb", 0)
        # control: the slots beside it are granted
        assert b.reserve("x", [0], "3g.40gb", 4).slots == (4, 4)
        assert b.reserve("z", [0], "1g.10gb", 2).slots == (2, 1)
        assert b.dangling() == [d]

    @pytest.mark.parametrize("ci", [-1, 0])
    def test_nvml_gpu_instance_without_compute_instance(self, stub, ci):
        # a 3g.40gb at slot 4 of GPU 0, left without a compute instance
        # (a crash between the two creates, or nvidia-smi mig -cgi
        # without -C); the control has its compute instance 0
        b = stub(f"gpus 2\nnext 7\ngi 0 5 9 4 4 {ci}\n")
        (d,) = b.dangling()
        assert (d.slice_uuid, d.gpu, d.profile, d.start, d.size,
                d.gpu_instance, d.compute_instance) == \
            ("", 0, "3g.40gb", 4, 4, 5, ci)
        assert len(d.device_uuids) == (0 if ci < 0 else 1)
        with pytest.raises(ChipsBusy, match="unrecorded"):
            b.reserve("x", [0], "3g.40gb", 4)
        with pytest.raises(ChipsBusy, match="unrecorded"):
            b.reserve("y", [0], "1g.10gb", 6)
        # the slots beside it are free, on both
        assert b.reserve("x", [0], "3g.40gb", 0).slots == (0, 4)
        assert {(i.slice_uuid, i.gpu_instance, i.compute_instance)
                for i in b.instances()} == {("", 5, ci), ("x", 7, 0)}
        b.release("x")
        assert b.dangling() == [d] and f"gi 0 5 9 4 4 {ci}" in \
            stub.state.read_text()

    def test_fake_restore_leaves_a_dangling_instance(self):
        b = FakeGpuBackend(gpu_count=2)
        b.reserve("a", [0], "1g.10gb", 0)
        snap = b.snapshot()
        b.reserve("b", [1], "7g.80gb", 0)
        b.restore(snap)
        assert [r.slice_uuid for r in b.list_reservations()] == ["a"]
        (d,) = b.dangling()
        assert (d.gpu, d.profile) == (1, "7g.80gb")
        with pytest.raises(ChipsBusy):
            b.reserve("c", [1], "1g.10gb", 0)

    def test_fake_seed_dangling_is_listed(self):
        b = FakeGpuBackend(gpu_count=2)
        b.seed_dangling("old", [1], "3g.40gb", 0)
        b.seed_dangling("old-w", [0])
        assert [r.slice_uuid for r in b.list_reservations()] == \
            ["old", "old-w"]
        assert b.dangling() == []
        with pytest.raises(ChipsBusy):
            b.reserve("x", [1], "3g.40gb", 0)
        b.release("old")
        assert b._instances == {} and b.calls["destroy"] == 1


_CHILD = """
import json, sys
from instaslice_tpu_torch.device import ChipsBusy, FakeGpuBackend, NvmlBackend
kind, lib, reg, uuid, chip = sys.argv[1:6]
b = (NvmlBackend(library_path=lib, registry_dir=reg) if kind == "nvml"
     else FakeGpuBackend(gpu_count=8, mig=False, registry_dir=reg))
out = {"list": [(r.slice_uuid, r.profile, list(r.device_uuids))
                for r in b.list_reservations()]}
if kind == "nvml":
    out["instances"] = [(r.slice_uuid, r.profile) for r in b.instances()]
try:
    b.reserve(uuid, [int(chip)])
    out["reserve"] = "ok"
except ChipsBusy:
    out["reserve"] = "ChipsBusy"
print(json.dumps(out))
"""


def _child(kind, lib, reg, uuid, chip):
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD, kind, lib, str(reg), uuid, str(chip)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _read(p):
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err
    return json.loads(out)


class TestAcrossProcesses:
    def test_nvml_restart_lists_and_excludes(self, stub):
        b = stub("gpus 2\nmig 1 0 0\n")      # MIG on GPU 0 alone
        r = b.reserve("mine", [0], "3g.40gb", 0)
        got = _read(_child("nvml", stub.lib, stub.registry, "theirs", 0))
        assert got["list"] == [["mine", "3g.40gb", list(r.device_uuids)]]
        assert got["instances"] == [["mine", "3g.40gb"]]
        assert got["reserve"] == "ChipsBusy"
        # the other GPU is free to the other process
        assert _read(_child("nvml", stub.lib, stub.registry, "theirs",
                            1))["reserve"] == "ok"
        assert {x.slice_uuid for x in b.list_reservations()} == \
            {"mine", "theirs"}
        b.release("mine")
        assert b.instances() == []

    @pytest.mark.parametrize("kind", ["registry", "nvml"])
    def test_racing_processes_one_winner(self, kind, tmp_path, stub):
        if kind == "nvml":
            stub("gpus 8\nmig 5 0 0\n")
        reg = stub.registry if kind == "nvml" else tmp_path / "r"
        procs = [_child(kind, stub.lib, reg, f"p{i}", 5) for i in range(4)]
        wins = [_read(p)["reserve"] for p in procs]
        assert sorted(wins) == ["ChipsBusy"] * 3 + ["ok"]
        b = (NvmlBackend(library_path=stub.lib, registry_dir=str(reg))
             if kind == "nvml" else
             FakeGpuBackend(gpu_count=8, mig=False, registry_dir=str(reg)))
        (res,) = b.list_reservations()
        assert res.chip_ids == (5,)


class TestSelect:
    def test_auto_raises_without_library(self, tmp_path):
        with pytest.raises(DeviceError, match="did not load"):
            select_backend("auto", library_path=str(tmp_path / "none.so"),
                           registry_dir=str(tmp_path / "r"))

    def test_auto_raises_with_no_gpu(self, stub):
        stub.state.write_text("gpus 0\n")
        with pytest.raises(DeviceError, match="no GPU"):
            select_backend("auto", library_path=stub.lib,
                           registry_dir=str(stub.registry))

    def test_auto_is_nvml_with_a_gpu(self, stub):
        stub.state.write_text("gpus 1\n")
        b = select_backend("auto", library_path=stub.lib,
                           registry_dir=str(stub.registry))
        assert isinstance(b, NvmlBackend) and b.discover().chip_count == 1

    @pytest.mark.parametrize("kind", ["native", "cloudtpu", "tpu"])
    def test_other_kinds_raise(self, kind):
        with pytest.raises(DeviceError, match="NVIDIA|unknown"):
            select_backend(kind)

    def test_fake_only_by_name(self, monkeypatch):
        # the reference's TPU topology hints mean nothing on a GPU node
        monkeypatch.setenv("TPUSLICE_GENERATION", "v5e")
        b = select_backend("fake", gpu_count=2)
        assert isinstance(b, FakeGpuBackend)
        assert b.discover().generation == mig.H100_80GB

    def test_nvml_generation_is_the_card(self, stub, monkeypatch):
        monkeypatch.setenv("TPUSLICE_GENERATION", "v5e")
        b = stub("gpus 2\n")
        assert b.generation == b.discover().generation == mig.H100_80GB
        assert b.reserve("m", [1], "3g.40gb", 4).slots == (4, 4)


class TestGeneration:
    """The MIG catalog goes to an H100 80GB alone: an H100 NVL (94 GB,
    profiles 1g.12gb ... 7g.94gb) gets none, and is granted whole GPUs
    only."""

    NVL = "name NVIDIA H100 NVL\nmemory 100485038080\ntable nvl\n"

    def test_h100_nvl_gets_no_catalog(self, stub):
        b = stub("gpus 2\n" + self.NVL)
        assert b.generation == b.discover().generation == ""
        assert [p["name"] for p in b.discover().gpus[0].profiles][:2] == \
            ["MIG 1g.12gb", "MIG 2g.24gb"]
        with pytest.raises(DeviceError, match="catalog"):
            b.reserve("m", [0], "3g.40gb", 4)
        assert b.list_reservations() == [] and b.instances() == []

    def test_h100_80gb_gets_the_catalog(self, stub):
        # the control: the 80 GB card's own name, memory and table
        b = stub("gpus 2\nname NVIDIA H100 80GB HBM3\n"
                 "memory 85520809984\n")
        assert b.generation == mig.H100_80GB
        assert b.reserve("m", [0], "3g.40gb", 4).slots == (4, 4)

    def test_a_table_that_disagrees_withholds_the_catalog(self, stub):
        # an 80 GB name and memory whose NVML table is another card's:
        # the table decides; with MIG off it cannot be read, and the
        # name and memory decide
        assert stub("gpus 1\ntable nvl\n").generation == ""
        assert stub("gpus 1\ntable nvl\nmig 0 0 0\n").generation == \
            mig.H100_80GB

    @pytest.mark.parametrize("name,gib,want", [
        ("NVIDIA H100 80GB HBM3", 79.6, mig.H100_80GB),
        ("NVIDIA H100 PCIe", 79.6, mig.H100_80GB),
        ("NVIDIA H100 NVL", 93.6, ""),
        ("NVIDIA H100 80GB HBM3", 70.0, ""),
        ("NVIDIA A100-SXM4-80GB", 79.2, ""),
    ])
    def test_generation_of(self, name, gib, want):
        from instaslice_tpu_torch.device.nvml import generation_of

        assert generation_of(name, int(gib * 2 ** 30)) == want


class TestRegistryFiles:
    def test_records_are_files_written_by_rename(self, tmp_path):
        reg = Registry(tmp_path)
        res = reg.reserve(Reservation("s-1", (0,), ("GPU-x",)))
        assert json.loads((tmp_path / "s-1.res").read_text())[
            "device_uuids"] == ["GPU-x"]
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            [".lock", "s-1.res"]
        # a torn temporary and an unreadable record are skipped
        (tmp_path / "s-2.res.tmp").write_text("{")
        (tmp_path / "s-3.res").write_text("not json")
        assert Registry(tmp_path).list() == [res]
        with pytest.raises(DeviceError, match="invalid slice uuid"):
            reg.reserve(Reservation("a/b", (1,)))

    def test_realize_failure_writes_nothing(self, tmp_path):
        reg = Registry(tmp_path)

        def refuse(res, live):
            raise DeviceError("refused")

        with pytest.raises(DeviceError, match="refused"):
            reg.reserve(Reservation("s", (0,)), refuse)
        assert reg.list() == []

    def test_traced_backend_spans_reserve(self):
        from instaslice_tpu_torch.utils.trace import get_tracer

        b = TracedBackend(FakeGpuBackend(gpu_count=2))
        b.reserve("t-1", [1], "1g.10gb", 0)
        b.release("t-1")
        spans = get_tracer().spans("device.reserve")
        assert spans and spans[-1].attrs["profile"] == "1g.10gb"
        assert b.calls["create"] == 1       # helpers pass through
