"""The port's device plugin (``instaslice_tpu_torch/deviceplugin/server.py``)
on the CPU, over its own hand-written gRPC wire and ``FakeGpuBackend``.

The reference's test classes (``tests/test_deviceplugin.py``:
registration and re-registration after a kubelet restart, ListAndWatch
with health pushes, Allocate's nodes, envs and status codes, preferred
allocation, slice mode with the multihost exclusion) run here against a
fake kubelet on the port's wire, with socket paths under a short
``/tmp`` dir (gRPC's unix sockets refuse paths over 107 characters,
which is why the reference's ``TestSliceMode`` fails under xdist's
temporary dirs). Then what the GPU plugin adds: MIG-on GPUs left out of
chips mode, the control nodes and a MIG slice's capability nodes (read
from a fake ``mig-minors`` file), the Allocate env against
``agent/handoff.py``'s ``slice_env`` on every key they share, the slice
manager's per-profile resources, ``preferred_rectangle`` against the
reference's on seeded inputs over ``(n, 1, 1)``, and the CLI's refusal to
fall back from NVML.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from instaslice_tpu.deviceplugin.server import (
    preferred_rectangle as ref_preferred_rectangle,
)
from instaslice_tpu_torch.agent.handoff import slice_env
from instaslice_tpu_torch.api import types as ttypes
from instaslice_tpu_torch.device import FakeGpuBackend
from instaslice_tpu_torch.deviceplugin import proto as pb
from instaslice_tpu_torch.deviceplugin.server import (
    GpuDevicePlugin,
    SlicePluginManager,
    chip_of,
    device_id,
    preferred_rectangle,
    read_mig_minors,
)
from instaslice_tpu_torch.deviceplugin.wire import (
    HEALTHY,
    KUBELET_SOCKET,
    UNHEALTHY,
    Channel,
    DevicePluginClient,
    RpcError,
    Server,
    StatusCode,
    registration_handler,
)
from instaslice_tpu_torch.topology import mig
from instaslice_tpu_torch.topology import placement as tplace
from instaslice_tpu_torch.topology import policy as tpolicy

REPO = Path(__file__).resolve().parents[1]


class FakeKubelet:
    """Serves v1beta1.Registration on the port's wire and records
    registrations."""

    def __init__(self, plugin_dir: str) -> None:
        self.registrations = []
        self.event = threading.Event()
        self._server = Server(name="fake-kubelet")
        self._server.add_handlers(registration_handler(self))
        self._server.start(os.path.join(plugin_dir, KUBELET_SOCKET))

    def Register(self, request, context):
        self.registrations.append(request)
        self.event.set()
        return pb.Empty()

    def stop(self) -> None:
        self._server.stop(grace=0.5)


@pytest.fixture()
def plugin_dir():
    d = tempfile.mkdtemp(prefix="dp", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture()
def kubelet(plugin_dir):
    k = FakeKubelet(plugin_dir)
    yield k
    k.stop()


@pytest.fixture()
def dev_root(plugin_dir):
    """A /dev with the control nodes nvidiactl and nvidia-uvm (and no
    nvidia-uvm-tools)."""
    d = os.path.join(plugin_dir, "dev")
    os.makedirs(d)
    for name in ("nvidiactl", "nvidia-uvm"):
        Path(d, name).touch()
    return d


@pytest.fixture()
def plugin(plugin_dir, kubelet, dev_root):
    p = GpuDevicePlugin(FakeGpuBackend(gpu_count=8, mig=False),
                        plugin_dir=plugin_dir, health_poll_seconds=0.1,
                        dev_root=dev_root)
    p.start()
    yield p
    p.stop()


@pytest.fixture()
def client(plugin):
    with Channel(f"unix://{plugin.socket_path}") as ch:
        yield DevicePluginClient(ch)


def _next(stream, timeout=5.0):
    return stream.next(timeout=timeout)


class TestRegistration:
    def test_registers_with_kubelet(self, plugin, kubelet):
        assert kubelet.event.wait(5)
        (reg,) = kubelet.registrations
        assert reg.version == "v1beta1"
        assert reg.resource_name == "nvidia.com/gpu"
        assert reg.endpoint == "tpuslice.sock"
        assert reg.options.get_preferred_allocation_available

    def test_reregisters_after_kubelet_restart(self, plugin, kubelet):
        assert kubelet.event.wait(5)
        kubelet.event.clear()
        # kubelet restart wipes the plugin's socket
        os.unlink(plugin.socket_path)
        assert kubelet.event.wait(5), "plugin did not re-register"
        assert len(kubelet.registrations) == 2
        deadline = time.monotonic() + 5
        while not os.path.exists(plugin.socket_path):
            assert time.monotonic() < deadline, "socket not re-created"
            time.sleep(0.05)
        with Channel(f"unix://{plugin.socket_path}") as ch:
            assert DevicePluginClient(ch).options().\
                get_preferred_allocation_available


class TestListAndWatch:
    def test_initial_inventory(self, plugin, client):
        stream = client.list_and_watch(timeout=30)
        resp = _next(stream)
        assert [d.ID for d in resp.devices] == [device_id(i) for i in
                                                range(8)]
        assert all(d.health == HEALTHY for d in resp.devices)
        stream.cancel()

    def test_health_transition_pushes_update(self, plugin, client):
        stream = client.list_and_watch(timeout=30)
        _next(stream)
        plugin.set_chip_health(3, healthy=False)
        by_id = {d.ID: d.health for d in _next(stream).devices}
        assert by_id[device_id(3)] == UNHEALTHY
        assert by_id[device_id(0)] == HEALTHY
        plugin.set_chip_health(3, healthy=True)
        assert {d.health for d in _next(stream).devices} == {HEALTHY}
        stream.cancel()

    def test_backend_failure_marks_all_unhealthy(self, plugin, client):
        stream = client.list_and_watch(timeout=30)
        _next(stream)
        plugin.backend.inject_failures("list", count=2)
        plugin.notify_health()
        assert all(d.health == UNHEALTHY for d in _next(stream).devices)
        stream.cancel()

    def test_an_event_before_the_wait_is_not_lost(self, plugin_dir):
        """A health mark that lands between ListAndWatch's inventory read
        and its wait is answered at once, not after the poll period."""
        from instaslice_tpu_torch.deviceplugin.server import (
            GpuDevicePluginServicer,
        )

        p = GpuDevicePlugin(FakeGpuBackend(gpu_count=2, mig=False),
                            plugin_dir=plugin_dir, health_poll_seconds=5,
                            register_with_kubelet=False)
        p._stop_evt.clear()                         # running, not serving

        class Ctx:
            def is_active(self):
                return True

        gen = GpuDevicePluginServicer(p).ListAndWatch(pb.Empty(), Ctx())
        assert {d.health for d in next(gen).devices} == {HEALTHY}
        p.set_chip_health(1, False)                 # before the wait
        t0 = time.monotonic()
        second = next(gen)
        assert time.monotonic() - t0 < 1.0
        assert [d.health for d in second.devices] == [HEALTHY, UNHEALTHY]
        p._stop_evt.set()
        gen.close()

    def test_mig_on_gpus_are_not_advertised(self, plugin_dir):
        p = GpuDevicePlugin(FakeGpuBackend(gpu_count=4, mig={2}),
                            plugin_dir=plugin_dir,
                            register_with_kubelet=False)
        p.start()
        try:
            assert [d.ID for d in p.device_list()] == \
                ["gpu-0", "gpu-1", "gpu-3"]
            with Channel(f"unix://{p.socket_path}") as ch:
                with pytest.raises(RpcError) as ei:
                    DevicePluginClient(ch).allocate(["gpu-2"])
            assert ei.value.code() == StatusCode.NOT_FOUND
        finally:
            p.stop()


class TestAllocate:
    def test_injects_device_nodes_and_env(self, plugin, client, dev_root):
        resp = client.allocate([device_id(1), device_id(2)])
        (cresp,) = resp.container_responses
        assert [d.host_path for d in cresp.devices] == [
            "/dev/nvidia1", "/dev/nvidia2",
            os.path.join(dev_root, "nvidiactl"),
            os.path.join(dev_root, "nvidia-uvm")]
        assert all(d.container_path == d.host_path for d in cresp.devices)
        assert all(d.permissions == "rw" for d in cresp.devices)
        uuids = [g.uuid for g in plugin.backend.discover().gpus[1:3]]
        assert cresp.envs["CUDA_VISIBLE_DEVICES"] == \
            cresp.envs["NVIDIA_VISIBLE_DEVICES"] == ",".join(uuids)
        assert cresp.envs["TPU_VISIBLE_CHIPS"] == "0,1"
        assert cresp.envs["TPU_KUBELET_ASSIGNED_CHIPS"] == "1,2"
        assert cresp.envs["TPU_PLATFORM"] == "h100-80gb"
        assert cresp.annotations["tpu.instaslice.dev/chips"] == "1,2"
        assert plugin.metrics_allocations == 1

    def test_unknown_device_rejected(self, plugin, client):
        with pytest.raises(RpcError) as ei:
            client.allocate([device_id(99)])
        assert ei.value.code() == StatusCode.NOT_FOUND

    def test_non_gpu_id_rejected(self, plugin, client):
        for bad in ("tpu-0", "slice-x"):
            with pytest.raises(RpcError) as ei:
                client.allocate([bad])
            assert ei.value.code() == StatusCode.INVALID_ARGUMENT


class TestPreferredAllocation:
    def test_prefers_contiguous_run(self, plugin, client):
        resp = client.preferred([device_id(i) for i in range(8)], size=4)
        (cresp,) = resp.container_responses
        assert sorted(chip_of(d) for d in cresp.deviceIDs) == [0, 1, 2, 3]

    def test_honours_must_include(self, client):
        resp = client.preferred([device_id(i) for i in range(8)], size=2,
                                must_include=[device_id(5)])
        chips = sorted(chip_of(d) for d in
                       resp.container_responses[0].deviceIDs)
        assert chips in ([4, 5], [5, 6])

    def test_fragmented_falls_back_to_fill(self, client):
        avail = [device_id(i) for i in (0, 3, 5, 6)]
        resp = client.preferred(avail, size=3)
        (cresp,) = resp.container_responses
        assert len(cresp.deviceIDs) == 3 and set(cresp.deviceIDs) <= \
            set(avail)

    def test_options_advertise_preferred_allocation(self, client):
        opts = client.options()
        assert opts.get_preferred_allocation_available
        assert not opts.pre_start_required

    def test_preferred_rectangle_is_the_references(self):
        rng = np.random.default_rng(0)
        for _ in range(300):
            n = int(rng.integers(1, 17))
            avail = sorted(rng.choice(n, int(rng.integers(0, n + 1)),
                                      replace=False).tolist())
            size = int(rng.integers(0, n + 2))
            must = sorted(rng.choice(avail, min(len(avail), int(
                rng.integers(0, 3))), replace=False).tolist()) if avail \
                else []
            hb = (n, 1, 1)
            assert preferred_rectangle(avail, size, hb, must) == \
                ref_preferred_rectangle(avail, size, hb, must), \
                (n, avail, size, must)


def _minors(path, res_list):
    lines = ["config 1", "monitor 2"]
    m = 10
    for r in res_list:
        lines += [f"gpu{r.gpu}/gi{r.gpu_instance}/access {m}",
                  f"gpu{r.gpu}/gi{r.gpu_instance}/ci{r.compute_instance}"
                  f"/access {m + 1}"]
        m += 2
    Path(path).write_text("\n".join(lines) + "\n")


class TestSliceMode:
    """Slice-mode plugin: realized reservations as per-profile devices."""

    def _plugin(self, backend, plugin_dir, profile, **kw):
        p = GpuDevicePlugin(
            backend, plugin_dir=plugin_dir,
            resource_name=f"nvidia.com/mig-{profile}",
            socket_name=f"tpuslice-{profile}.sock",
            register_with_kubelet=False, mode="slices", profile=profile,
            **kw)
        p.start()
        return p

    def test_advertises_only_matching_profile(self, plugin_dir):
        backend = FakeGpuBackend(gpu_count=2)
        backend.reserve("sl-a", [0], "3g.40gb", 0)
        backend.reserve("sl-b", [0], "1g.10gb", 4)
        backend.reserve("sl-c", [1], "3g.40gb", 4)
        p = self._plugin(backend, plugin_dir, "3g.40gb")
        try:
            assert [d.ID for d in p.device_list()] == ["slice-sl-a",
                                                       "slice-sl-c"]
        finally:
            p.stop()

    def test_multihost_parts_never_advertised(self, plugin_dir):
        """A node-local part of a multi-host allocation belongs to
        another job: advertising it would let kubelet grant it."""
        backend = FakeGpuBackend(gpu_count=2, mig=False)
        backend.reserve("sl-mh-group1", [0, 1])
        p = self._plugin(backend, plugin_dir, "gpu")
        try:
            assert p.device_list() == []
            backend.release("sl-mh-group1")
            backend.reserve("sl-solo", [0, 1])
            assert [d.ID for d in p.device_list()] == ["slice-sl-solo"]
        finally:
            p.stop()

    def test_allocate_injects_the_mig_slice(self, plugin_dir, dev_root):
        backend = FakeGpuBackend(gpu_count=2)
        other = backend.reserve("sl-o", [0], "1g.10gb", 0)
        res = backend.reserve("sl-x", [1], "3g.40gb", 4)
        minors = os.path.join(plugin_dir, "mig-minors")
        _minors(minors, [other, res])
        p = self._plugin(backend, plugin_dir, "3g.40gb", dev_root=dev_root,
                         mig_minors=minors)
        try:
            with Channel(f"unix://{p.socket_path}") as ch:
                resp = DevicePluginClient(ch).allocate(["slice-sl-x"])
            (cresp,) = resp.container_responses
            caps = os.path.join(dev_root, "nvidia-caps")
            assert [d.host_path for d in cresp.devices] == [
                "/dev/nvidia1", os.path.join(dev_root, "nvidiactl"),
                os.path.join(dev_root, "nvidia-uvm"),
                os.path.join(caps, "nvidia-cap12"),
                os.path.join(caps, "nvidia-cap13")]
            (uuid,) = res.device_uuids
            assert cresp.envs["CUDA_VISIBLE_DEVICES"] == uuid
            assert cresp.envs["TPU_VISIBLE_CHIPS"] == "0"
            assert cresp.envs["TPU_KUBELET_ASSIGNED_CHIPS"] == "1"
            assert cresp.annotations["tpu.instaslice.dev/slice-device"] == \
                "sl-x"
        finally:
            p.stop()

    def test_allocate_unknown_reservation_rejected(self, plugin_dir):
        p = self._plugin(FakeGpuBackend(gpu_count=2), plugin_dir, "3g.40gb")
        try:
            with Channel(f"unix://{p.socket_path}") as ch:
                c = DevicePluginClient(ch)
                with pytest.raises(RpcError) as ei:
                    c.allocate(["slice-nope"])
                assert ei.value.code() == StatusCode.NOT_FOUND
                with pytest.raises(RpcError) as ei:
                    c.allocate(["gpu-0"])
                assert ei.value.code() == StatusCode.INVALID_ARGUMENT
        finally:
            p.stop()

    def test_mig_minors_file(self, plugin_dir):
        path = os.path.join(plugin_dir, "m")
        Path(path).write_text("config 1\nmonitor 2\ngpu0/gi3/access 30\n"
                              "gpu0/gi3/ci0/access 31\nnot a line\n")
        assert read_mig_minors(path) == {
            "config": 1, "monitor": 2, "gpu0/gi3/access": 30,
            "gpu0/gi3/ci0/access": 31}
        assert read_mig_minors(os.path.join(plugin_dir, "none")) == {}


@pytest.mark.parametrize("profile", ["3g.40gb", "gpu"])
def test_allocate_env_agrees_with_slice_env(plugin_dir, profile):
    """The kubelet overlays Allocate's envs on the pod's ``envFrom``
    (the handoff ConfigMap): on every key they share the two agree, so
    the overlay changes nothing ``SliceTopology.from_env`` reads."""
    group = mig.gpu_group(2)
    want = mig.whole_gpu() if profile == "gpu" else \
        mig.parse_mig_profile(profile)
    pl = tpolicy.get_policy("first-fit").choose(group, want,
                                                tplace.Occupancy(group))
    pod = ttypes.PodRef("uid-p", "pod-p", "ns")
    alloc = ttypes.AllocationDetails.from_placement(pl, [pod], now=0.0)
    gpu, start = mig.box_gpu_start(pl.box)
    backend = FakeGpuBackend(gpu_count=2, mig=profile != "gpu")
    res = backend.reserve(ttypes.slice_uuid_for(alloc.alloc_id), [gpu],
                          "" if profile == "gpu" else profile, start)
    env = slice_env(alloc, pod, "node-a", mig.H100_80GB, res.device_uuids)
    p = GpuDevicePlugin(backend, plugin_dir=plugin_dir,
                        register_with_kubelet=False, mode="slices",
                        profile=profile, socket_name="s.sock")
    p.start()
    try:
        with Channel(f"unix://{p.socket_path}") as ch:
            (cresp,) = DevicePluginClient(ch).allocate(
                [f"slice-{res.slice_uuid}"]).container_responses
    finally:
        p.stop()
    shared = set(env) & set(cresp.envs)
    assert shared >= {"CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                      "TPU_VISIBLE_CHIPS"}
    assert {k: cresp.envs[k] for k in shared} == {k: env[k] for k in shared}


def test_slice_manager_runs_one_plugin_per_profile(plugin_dir, kubelet):
    backend = FakeGpuBackend(gpu_count=2, mig={0})
    backend.reserve("sl-m", [0], "3g.40gb", 0)
    mgr = SlicePluginManager(backend, plugin_dir=plugin_dir,
                             poll_seconds=0.05).start()
    try:
        deadline = time.monotonic() + 5
        while len(kubelet.registrations) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        backend.reserve("sl-w", [1])
        while len(kubelet.registrations) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        # the manager records a plugin once its start() has registered
        while "gpu" not in mgr.plugins:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        got = {(r.resource_name, r.endpoint) for r in kubelet.registrations}
        assert got == {("nvidia.com/mig-3g.40gb", "tpuslice-3g.40gb.sock"),
                       ("nvidia.com/gpu", "tpuslice-gpu.sock")}
        assert [d.ID for d in mgr.plugins["gpu"].device_list()] == \
            ["slice-sl-w"]
        assert mgr.ensure_profile("nvidia.com/mig-3g.40gb") is \
            mgr.plugins["3g.40gb"]
    finally:
        mgr.stop()


def test_cli_refuses_to_fall_back_without_nvml(plugin_dir):
    from instaslice_tpu_torch.cli import deviceplugin_main

    args = deviceplugin_main.build_parser().parse_args([])
    assert (args.backend, args.resource, args.plugin_dir) == \
        ("auto", "nvidia.com/gpu", "/var/lib/kubelet/device-plugins")
    env = dict(os.environ, LD_LIBRARY_PATH=plugin_dir)
    run = subprocess.run(
        [sys.executable, "-m", "instaslice_tpu_torch.cli.deviceplugin_main",
         "--plugin-dir", plugin_dir], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "no NVML device backend" in run.stderr
    assert not os.path.exists(os.path.join(plugin_dir, "tpuslice.sock"))
