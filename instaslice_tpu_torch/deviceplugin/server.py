"""Kubelet device plugin advertising NVIDIA GPUs and MIG slices.

A port of ``instaslice_tpu/deviceplugin/server.py`` for a node of NVIDIA
cards, on the port's own gRPC wire (:mod:`.wire`). InstaSlice leaves
this to NVIDIA's device plugin, which it kicks through a node label
(``instaslice_daemonset.go:474-497``); here it is in the tree, as in the
JAX package:

- serves ``v1beta1.DevicePlugin`` on a unix socket under the kubelet
  plugin dir and registers with ``kubelet.sock``;
- chips mode advertises one device per GPU (IDs ``gpu-<index>``) under
  ``nvidia.com/gpu``, except a GPU with MIG mode on: CUDA then
  enumerates its MIG devices, not the GPU, so it is granted only by MIG
  slices;
- slices mode (:class:`SlicePluginManager`, one plugin per profile
  present) advertises each realized reservation as one device
  (``slice-<slice uuid>``): a MIG reservation under
  ``nvidia.com/mig-<profile>``, a whole-GPU one under ``nvidia.com/gpu``
  (the resources InstaSlice's pods request, ``samples/test-pod.yaml``);
- ``Allocate`` gives the container the device nodes a CUDA process
  opens: each granted GPU's ``/dev/nvidia<minor>``, the control nodes
  that exist (``/dev/nvidiactl``, ``/dev/nvidia-uvm``,
  ``/dev/nvidia-uvm-tools``) and, for a MIG slice, the capability nodes
  of its GPU instance and compute instance
  (``/dev/nvidia-caps/nvidia-cap<minor>``, the minors read from
  ``/proc/driver/nvidia-caps/mig-minors``); its env names the granted
  devices by UUID (``NVIDIA_VISIBLE_DEVICES``, ``CUDA_VISIBLE_DEVICES``)
  and sets ``TPU_VISIBLE_CHIPS`` as the handoff's ``slice_env`` does
  (``agent/handoff.py``), so the kubelet's overlay of these envs on the
  pod's ``envFrom`` changes nothing a workload reads;
- ``GetPreferredAllocation`` prefers a compact box of GPU indices (the
  reference's ``preferred_rectangle``, over the ``(n, 1, 1)`` line of
  GPUs);
- re-registers when the kubelet restarts (its restart wipes the plugin
  socket dir).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from instaslice_tpu_torch.api.constants import (
    CHIPS_ANNOTATION,
    GPU_RESOURCE,
    MIG_RESOURCE_PREFIX,
    REASON_CHIP_HEALED,
    REASON_CHIP_UNHEALTHY,
    SLICE_DEVICE_ANNOTATION,
)
from instaslice_tpu_torch.api.types import is_multihost_slice_uuid
from instaslice_tpu_torch.device.backend import (
    DeviceBackend,
    DeviceError,
    Reservation,
)
from instaslice_tpu_torch.deviceplugin import proto as pb
from instaslice_tpu_torch.deviceplugin.wire import (
    HEALTHY,
    KUBELET_SOCKET,
    UNHEALTHY,
    Channel,
    RegistrationClient,
    RpcError,
    Server,
    StatusCode,
    device_plugin_handler,
)
from instaslice_tpu_torch.obs.journal import get_journal
from instaslice_tpu_torch.topology.grid import Shape, id_to_coord
from instaslice_tpu_torch.topology.mig import WHOLE_GPU, parse_mig_profile
from instaslice_tpu_torch.utils.guards import guarded_by, requires
from instaslice_tpu_torch.utils.lockcheck import named_condition, named_lock

log = logging.getLogger("instaslice_tpu_torch.deviceplugin")

DEFAULT_RESOURCE = GPU_RESOURCE
DEFAULT_PLUGIN_DIR = "/var/lib/kubelet/device-plugins"
SOCKET_NAME = "tpuslice.sock"
DEVICE_ID_PREFIX = "gpu-"
SLICE_ID_PREFIX = "slice-"
#: what a CUDA process opens besides its GPUs' nodes, where they exist
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")
MIG_MINORS = "/proc/driver/nvidia-caps/mig-minors"


def device_id(chip_id: int) -> str:
    return f"{DEVICE_ID_PREFIX}{chip_id}"


def chip_of(dev_id: str) -> int:
    if not dev_id.startswith(DEVICE_ID_PREFIX):
        raise ValueError(f"not a gpu device id: {dev_id!r}")
    return int(dev_id[len(DEVICE_ID_PREFIX):])


def slice_device_id(slice_uuid: str) -> str:
    return f"{SLICE_ID_PREFIX}{slice_uuid}"


def slice_of(dev_id: str) -> str:
    if not dev_id.startswith(SLICE_ID_PREFIX):
        raise ValueError(f"not a slice device id: {dev_id!r}")
    return dev_id[len(SLICE_ID_PREFIX):]


def reservation_profile(r: Reservation) -> str:
    """The reservation's MIG profile, or ``gpu`` for whole GPUs."""
    return r.profile or WHOLE_GPU


def profile_resource(profile: str) -> str:
    """``nvidia.com/gpu`` for whole GPUs, else
    ``nvidia.com/mig-<profile>``."""
    return GPU_RESOURCE if profile == WHOLE_GPU else \
        f"{MIG_RESOURCE_PREFIX}{profile}"


def preferred_rectangle(
    available: Sequence[int], size: int, host_bounds: Shape,
    must_include: Sequence[int] = (),
) -> List[int]:
    """Pick ``size`` chips from ``available`` forming the most compact
    axis-aligned box on the host grid (max ICI locality), honouring
    ``must_include``. Falls back to lowest-id fill when no whole box fits.
    """
    avail: Set[int] = set(available)
    must: Set[int] = set(must_include)
    if size <= 0 or size > len(avail) or not must <= avail:
        return sorted(avail)[:size]
    coords = {c: id_to_coord(c, host_bounds) for c in avail}
    # candidate box shapes of exactly `size` chips, most-compact first
    # (minimal surface ⇒ minimal max-dimension on the ICI mesh)
    shapes = sorted(
        (
            (x, y, z)
            for x in range(1, host_bounds[0] + 1)
            for y in range(1, host_bounds[1] + 1)
            for z in range(1, host_bounds[2] + 1)
            if x * y * z == size
        ),
        key=lambda s: (max(s), s[0] * s[1] + s[1] * s[2] + s[0] * s[2]),
    )
    for sx, sy, sz in shapes:
        for ox, oy, oz in itertools.product(
            range(host_bounds[0] - sx + 1),
            range(host_bounds[1] - sy + 1),
            range(host_bounds[2] - sz + 1),
        ):
            box = {
                (ox + dx, oy + dy, oz + dz)
                for dx in range(sx) for dy in range(sy) for dz in range(sz)
            }
            ids = {c for c, xyz in coords.items() if xyz in box}
            if len(ids) == size and ids <= avail and must <= ids:
                return sorted(ids)
    # no whole rectangle free: deterministic lowest-id fill, must first
    rest = sorted(avail - must)
    return sorted(must) + rest[: size - len(must)]


def read_mig_minors(path: str = MIG_MINORS) -> Dict[str, int]:
    """The driver's MIG capability minors: ``gpu0/gi1/access`` and
    ``gpu0/gi1/ci0/access`` (and ``config``, ``monitor``) -> minor; empty
    where the file is missing."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return {}
    out = {}
    for line in lines:
        parts = line.split()
        if len(parts) == 2 and parts[1].isdigit():
            out[parts[0]] = int(parts[1])
    return out


def _spec(path: str) -> pb.DeviceSpec:
    return pb.DeviceSpec(container_path=path, host_path=path,
                         permissions="rw")


class GpuDevicePluginServicer:
    """The v1beta1.DevicePlugin implementation."""

    def __init__(self, plugin: "GpuDevicePlugin") -> None:
        self._p = plugin

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=True,
        )

    def ListAndWatch(self, request, context):
        """Initial inventory, then an update on every health change."""
        p = self._p
        last: Optional[Tuple[Tuple[str, str], ...]] = None
        while p.running and context.is_active():
            # the event count before the read: an event that lands
            # between the read and the wait is not lost (the reference's
            # loop waits a whole poll for it)
            seen = p.health_events()
            devs = p.device_list()
            key = tuple((d.ID, d.health) for d in devs)
            if key != last:
                last = key
                yield pb.ListAndWatchResponse(devices=devs)
            p.wait_health_event(timeout=p.health_poll_seconds, seen=seen)

    def GetPreferredAllocation(self, request, context):
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            if self._p.mode == "slices":
                # slice devices are already carved: any available one
                # will do; must_include first (kubelet contract), then
                # deterministic lowest-id fill
                must_ids = sorted(creq.must_include_deviceIDs)
                rest = sorted(
                    set(creq.available_deviceIDs) - set(must_ids)
                )
                chosen_ids = (must_ids + rest)[: creq.allocation_size]
                resp.container_responses.append(
                    pb.ContainerPreferredAllocationResponse(
                        deviceIDs=chosen_ids
                    )
                )
                continue
            try:
                avail = [chip_of(d) for d in creq.available_deviceIDs]
                must = [chip_of(d) for d in creq.must_include_deviceIDs]
            except ValueError as e:
                context.abort(StatusCode.INVALID_ARGUMENT, str(e))
            chosen = preferred_rectangle(
                avail, creq.allocation_size, self._p.host_bounds, must
            )
            resp.container_responses.append(
                pb.ContainerPreferredAllocationResponse(
                    deviceIDs=[device_id(c) for c in chosen]
                )
            )
        return resp

    def Allocate(self, request, context):
        if self._p.mode == "slices":
            return self._allocate_slices(request, context)
        p = self._p
        resp = pb.AllocateResponse()
        for creq in request.container_requests:
            try:
                chips = sorted(chip_of(d) for d in creq.devicesIDs)
            except ValueError as e:
                context.abort(StatusCode.INVALID_ARGUMENT, str(e))
            advertised = p.advertised_gpus()
            unknown = [c for c in chips if c not in advertised]
            if unknown:
                context.abort(
                    StatusCode.NOT_FOUND,
                    f"unknown GPUs {unknown} (advertised "
                    f"{sorted(advertised)})",
                )
            resp.container_responses.append(p.container_response(
                chips, [p.gpu_uuids[c] for c in chips], []))
            p.metrics_allocations += 1
        return resp

    def _allocate_slices(self, request, context):
        """Slice-mode Allocate: each device ID is a realized reservation;
        the container gets exactly that reservation's devices (the
        MIG-device-plugin strategy)."""
        p = self._p
        resp = pb.AllocateResponse()
        reservations = {
            r.slice_uuid: r for r in p.backend.list_reservations()
        }
        for creq in request.container_requests:
            chips: List[int] = []
            uuids: List[str] = []
            suids: List[str] = []
            migs: List[Reservation] = []
            for dev in creq.devicesIDs:
                try:
                    suid = slice_of(dev)
                except ValueError as e:
                    context.abort(StatusCode.INVALID_ARGUMENT, str(e))
                res = reservations.get(suid)
                if res is None:
                    context.abort(
                        StatusCode.NOT_FOUND,
                        f"no live reservation {suid!r} "
                        f"(have {sorted(reservations)})",
                    )
                missing = [c for c in res.chip_ids
                           if c not in p.chip_paths]
                if missing:
                    context.abort(
                        StatusCode.NOT_FOUND,
                        f"reservation {suid} GPUs {missing} not on this "
                        "host",
                    )
                chips += res.chip_ids
                uuids += res.device_uuids
                suids.append(suid)
                if res.profile:
                    migs.append(res)
            cresp = p.container_response(chips, uuids, migs)
            cresp.annotations[SLICE_DEVICE_ANNOTATION] = ",".join(suids)
            resp.container_responses.append(cresp)
            p.metrics_allocations += 1
        return resp

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()


class GpuDevicePlugin:
    """Plugin lifecycle: serve, register, watch health, re-register."""

    registered_count: guarded_by("deviceplugin.state")
    _server: guarded_by("deviceplugin.state")
    _health_seq: guarded_by("deviceplugin.health")

    def __init__(
        self,
        backend: DeviceBackend,
        plugin_dir: str = DEFAULT_PLUGIN_DIR,
        resource_name: str = DEFAULT_RESOURCE,
        socket_name: str = SOCKET_NAME,
        health_poll_seconds: float = 5.0,
        register_with_kubelet: bool = True,
        mode: str = "chips",
        profile: str = "",
        dev_root: str = "/dev",
        mig_minors: str = MIG_MINORS,
    ) -> None:
        """``mode="chips"`` advertises whole GPUs; ``mode="slices"``
        advertises realized reservations of ``profile`` (a MIG profile,
        or ``gpu`` for whole GPUs) as devices. ``dev_root`` is where the
        control nodes are looked for, ``mig_minors`` the driver's list
        of MIG capability minors."""
        if mode not in ("chips", "slices"):
            raise ValueError(f"unknown plugin mode {mode!r}")
        if mode == "slices" and not profile:
            raise ValueError("slice mode requires a profile")
        inv = backend.discover()
        self.mode = mode
        self.profile = profile
        self.backend = backend
        self.generation = inv.generation
        self.chip_paths: Dict[int, str] = dict(inv.chip_paths)
        #: GPUs on the ``(n, 1, 1)`` line of indices
        self.host_bounds: Shape = (max(1, len(self.chip_paths)), 1, 1)
        self.gpu_uuids: Dict[int, str] = {g.index: g.uuid for g in inv.gpus}
        self.mig_on: Set[int] = {g.index for g in inv.gpus
                                 if g.mig_current == 1}
        self.plugin_dir = plugin_dir
        self.resource_name = resource_name
        self.socket_name = socket_name
        self.health_poll_seconds = health_poll_seconds
        self.register_with_kubelet = register_with_kubelet
        self.dev_root = dev_root
        self.mig_minors = mig_minors
        #: set on stop(): every retry/poll loop paces on .wait(timeout)
        #: instead of time.sleep so shutdown interrupts the nap; also
        #: the single source of truth behind the ``running`` property
        self._stop_evt = threading.Event()
        self._stop_evt.set()  # not running until start()
        #: the registration count and the live gRPC server: the owner's
        #: thread and the kubelet watcher (its re-registration) both
        #: start and stop the plugin
        self._state_lock = named_lock("deviceplugin.state")
        self.registered_count = 0
        self.metrics_allocations = 0
        self._unhealthy: Set[int] = set()
        self._health_cv = named_condition("deviceplugin.health")
        #: health events so far (marks set or cleared, notify_health)
        self._health_seq = 0
        self._server: Optional[Server] = None
        self._watch_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- inventory

    def advertised_gpus(self) -> List[int]:
        """Chips mode's devices: every GPU but those with MIG on."""
        return [c for c in sorted(self.chip_paths) if c not in self.mig_on]

    def device_list(self) -> List[pb.Device]:
        unhealthy = self.unhealthy_chips()
        if self.mode == "slices":
            try:
                reservations = self.backend.list_reservations()
            except DeviceError:
                return []
            return [
                pb.Device(
                    ID=slice_device_id(r.slice_uuid),
                    health=(
                        UNHEALTHY
                        if any(c in unhealthy for c in r.chip_ids)
                        else HEALTHY
                    ),
                )
                for r in sorted(reservations, key=lambda r: r.slice_uuid)
                # a node-local part of a multi-host slice belongs to
                # another job: never advertise it as allocatable
                if not is_multihost_slice_uuid(r.slice_uuid)
                and reservation_profile(r) == self.profile
            ]
        return [
            pb.Device(
                ID=device_id(c),
                health=UNHEALTHY if c in unhealthy else HEALTHY,
            )
            for c in self.advertised_gpus()
        ]

    def container_response(self, chips: Sequence[int], uuids: Sequence[str],
                           migs: Sequence[Reservation]
                           ) -> pb.ContainerAllocateResponse:
        """The granted GPUs' device nodes, the control nodes that exist
        and the MIG slices' capability nodes; the env that names the
        devices (CUDA numbers what it sees 0..n-1, as ``slice_env``)."""
        cresp = pb.ContainerAllocateResponse()
        for c in sorted(set(chips)):
            cresp.devices.append(_spec(self.chip_paths[c]))
        for name in CONTROL_NODES:
            path = os.path.join(self.dev_root, name)
            if os.path.exists(path):
                cresp.devices.append(_spec(path))
        if migs:
            minors = read_mig_minors(self.mig_minors)
            for r in migs:
                for cap in (f"gpu{r.gpu}/gi{r.gpu_instance}/access",
                            f"gpu{r.gpu}/gi{r.gpu_instance}/ci"
                            f"{r.compute_instance}/access"):
                    if cap in minors:
                        cresp.devices.append(_spec(os.path.join(
                            self.dev_root, "nvidia-caps",
                            f"nvidia-cap{minors[cap]}")))
        chips_csv = ",".join(str(c) for c in sorted(chips))
        cresp.envs["NVIDIA_VISIBLE_DEVICES"] = ",".join(uuids)
        cresp.envs["CUDA_VISIBLE_DEVICES"] = ",".join(uuids)
        cresp.envs["TPU_VISIBLE_CHIPS"] = ",".join(
            str(i) for i in range(len(uuids)))
        # what the kubelet assigned, by GPU index
        cresp.envs["TPU_KUBELET_ASSIGNED_CHIPS"] = chips_csv
        cresp.envs["TPU_PLATFORM"] = self.generation
        cresp.annotations[CHIPS_ANNOTATION] = chips_csv
        return cresp

    def unhealthy_chips(self) -> Set[int]:
        """Backend-level failure marks every GPU unhealthy (the agent
        can't realize slices either); per-GPU marks come from
        :meth:`set_chip_health` (agent health loop / tests)."""
        if not self.backend.healthy():
            return set(self.chip_paths)
        with self._health_cv:
            return set(self._unhealthy)

    def set_chip_health(self, chip_id: int, healthy: bool) -> None:
        with self._health_cv:
            flipped = healthy == (chip_id in self._unhealthy)
            if healthy:
                self._unhealthy.discard(chip_id)
            else:
                self._unhealthy.add(chip_id)
            self._health_seq += 1
            self._health_cv.notify_all()
        if flipped:
            # journal outside the condition: emission must not add a
            # health-cv → journal-ring lock-order edge
            get_journal().emit(
                "deviceplugin",
                reason=(REASON_CHIP_HEALED if healthy
                        else REASON_CHIP_UNHEALTHY),
                object_ref=f"chip/{chip_id}",
                message=(f"GPU {chip_id} "
                         f"{'healthy' if healthy else 'unhealthy'} "
                         f"({self.resource_name})"),
            )

    def health_events(self) -> int:
        with self._health_cv:
            return self._health_seq

    def wait_health_event(self, timeout: float,
                          seen: Optional[int] = None) -> None:
        """Until a health event after the ``seen``-th (any new one when
        None), or ``timeout`` seconds."""
        with self._health_cv:
            if seen is None:
                seen = self._health_seq
            self._health_cv.wait_for(lambda: self._health_moved(seen),
                                     timeout)

    @requires("deviceplugin.health")
    def _health_moved(self, seen: int) -> bool:
        return self._health_seq != seen

    def notify_health(self) -> None:
        with self._health_cv:
            self._health_seq += 1
            self._health_cv.notify_all()

    # ----------------------------------------------------------- lifecycle

    @property
    def socket_path(self) -> str:
        return os.path.join(self.plugin_dir, self.socket_name)

    @property
    def kubelet_socket_path(self) -> str:
        return os.path.join(self.plugin_dir, KUBELET_SOCKET)

    def start(self) -> None:
        with self._state_lock:
            self._stop_evt.clear()  # running = True
        self._serve()

    def _serve(self) -> None:
        """Serve, register and watch the kubelet. The watcher's restart
        comes here without start(): a stop() by the owner in the
        meantime is final, so a server that comes up after it is shut
        again and the restart gives up."""
        os.makedirs(self.plugin_dir, exist_ok=True)
        server = Server(name="tpuslice-dp")
        server.add_handlers(device_plugin_handler(
            GpuDevicePluginServicer(self)))
        server.start(self.socket_path)
        with self._state_lock:
            stopped = self._stop_evt.is_set()
            if not stopped:
                self._server = server
        if stopped:
            self._shut(server)
            raise DeviceError("plugin stopped while it started")
        log.info(
            "device plugin serving %s at %s (%d GPUs, %s)",
            self.resource_name, self.socket_path,
            len(self.chip_paths), self.generation or "no MIG catalog",
        )
        if self.register_with_kubelet:
            self.register(wait=True)
            self._watch_thread = threading.Thread(
                target=self._watch_kubelet, name="tpuslice-dp-watch",
                daemon=True,
            )
            self._watch_thread.start()

    def register(self, wait: bool = True, timeout: float = 60.0) -> None:
        """Register with kubelet; retries until its socket appears."""
        deadline = time.monotonic() + timeout
        while self.running:
            if os.path.exists(self.kubelet_socket_path):
                try:
                    with Channel(f"unix://{self.kubelet_socket_path}") as ch:
                        RegistrationClient(ch).register(
                            endpoint=self.socket_name,
                            resource_name=self.resource_name,
                        )
                    with self._state_lock:
                        self.registered_count += 1
                    log.info(
                        "registered %s with kubelet (endpoint %s)",
                        self.resource_name, self.socket_name,
                    )
                    return
                except RpcError as e:
                    log.warning("kubelet registration failed: %s", e)
            if not wait or time.monotonic() >= deadline:
                raise DeviceError(
                    f"kubelet not reachable at {self.kubelet_socket_path}"
                )
            if self._stop_evt.wait(0.2):
                raise DeviceError(
                    "plugin stopped during kubelet registration"
                )

    def _watch_kubelet(self) -> None:
        """Kubelet restart wipes the plugin dir: when our socket vanishes,
        re-serve and re-register (the standard plugin liveness dance).
        Keeps retrying while kubelet is down — a node upgrade can exceed
        any single registration timeout, and giving up would leave the
        node without GPU capacity until a manual restart."""
        while self.running:
            if not os.path.exists(self.socket_path):
                log.warning("plugin socket removed (kubelet restart?); "
                            "re-registering")
                try:
                    self.stop(keep_running_flag=True)
                    self._serve()
                    return  # _serve() spawned a fresh watcher
                except (DeviceError, OSError) as e:
                    log.error("re-registration failed (will retry): %s", e)
                    if self._stop_evt.wait(self.health_poll_seconds):
                        return
                    continue
            if self._stop_evt.wait(self.health_poll_seconds):
                return

    def wait_stopped(self, timeout: float) -> bool:
        """Block until stop() (or ``timeout``); True once stopping."""
        return self._stop_evt.wait(timeout)

    @property
    def running(self) -> bool:
        """Derived from the stop event — one source of truth, so a
        loop's pacing (.wait on the event) and its continue-condition
        can never disagree."""
        return not self._stop_evt.is_set()

    def stop(self, keep_running_flag: bool = False) -> None:
        """Stop serving. The flag and the swap of the server are one
        step under ``deviceplugin.state``, so a restart by the watcher
        either hands its server over to be shut here or sees the flag
        and shuts it itself."""
        with self._state_lock:
            if not keep_running_flag:
                self._stop_evt.set()
            server, self._server = self._server, None
        self.notify_health()  # unblock ListAndWatch streams
        self._shut(server)

    def _shut(self, server: Optional[Server]) -> None:
        if server is not None:
            server.stop(grace=1.0)
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass


class SlicePluginManager:
    """One slice-mode plugin per profile present on the node.

    Kubelet's registration model is one resource name per plugin
    endpoint, so per-profile resources (``nvidia.com/mig-3g.40gb``) need
    one plugin each, and whole-GPU reservations one under
    ``nvidia.com/gpu``. The manager polls the backend's reservations and
    brings up a plugin for every profile it sees; plugins for vanished
    profiles stay registered with an empty inventory (capacity 0) —
    kubelet handles that gracefully, and the next same-profile slice
    reuses the endpoint. (NVIDIA's device plugin exposes the same
    per-profile resources, which InstaSlice kicks through a node label,
    ``instaslice_daemonset.go:474-497``.)
    """

    plugins: guarded_by("deviceplugin.manager")

    def __init__(
        self,
        backend: DeviceBackend,
        plugin_dir: str = DEFAULT_PLUGIN_DIR,
        poll_seconds: float = 0.5,
        register_with_kubelet: bool = True,
    ) -> None:
        inv = backend.discover()
        self.backend = backend
        self.plugin_dir = plugin_dir
        self.poll_seconds = poll_seconds
        self.register_with_kubelet = register_with_kubelet
        self.generation = inv.generation
        self.plugins: Dict[str, GpuDevicePlugin] = {}   # profile → plugin
        self._lock = named_lock("deviceplugin.manager")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def profiles_present(self) -> Set[str]:
        try:
            reservations = self.backend.list_reservations()
        except DeviceError:
            return set()
        return {reservation_profile(r) for r in reservations}

    def ensure_profile(self, profile: str) -> GpuDevicePlugin:
        # canonicalize (nvidia.com/mig-3g.40gb → 3g.40gb) so any legal
        # spelling of the resource matches the reservation's profile
        if profile not in (WHOLE_GPU, GPU_RESOURCE):
            profile = parse_mig_profile(profile, self.generation).name
        else:
            profile = WHOLE_GPU
        with self._lock:
            plugin = self.plugins.get(profile)
            if plugin is None:
                plugin = GpuDevicePlugin(
                    self.backend,
                    plugin_dir=self.plugin_dir,
                    resource_name=profile_resource(profile),
                    socket_name=f"tpuslice-{profile}.sock",
                    health_poll_seconds=self.poll_seconds,
                    register_with_kubelet=self.register_with_kubelet,
                    mode="slices",
                    profile=profile,
                )
                plugin.start()
                self.plugins[profile] = plugin
            return plugin

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                for profile in self.profiles_present():
                    self.ensure_profile(profile)
                # wake existing plugins so ListAndWatch streams re-derive
                # their inventory from the current reservations
                with self._lock:
                    for p in self.plugins.values():
                        p.notify_health()
            except Exception:           # pragma: no cover - defensive
                log.exception("slice plugin manager sweep failed")
            self._stop.wait(self.poll_seconds)

    def start(self) -> "SlicePluginManager":
        self._thread = threading.Thread(
            target=self._loop, name="tpuslice-plugin-mgr", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        with self._lock:
            for p in self.plugins.values():
                p.stop()
            self.plugins.clear()


def serve(args) -> int:
    """CLI entry (``tpuslice-gpu-deviceplugin``): serve until
    signalled."""
    from instaslice_tpu_torch.device.select import select_backend

    logging.basicConfig(level=logging.INFO)
    backend = select_backend(getattr(args, "backend", "auto"))
    plugin = GpuDevicePlugin(
        backend,
        plugin_dir=getattr(args, "plugin_dir", DEFAULT_PLUGIN_DIR),
        resource_name=getattr(args, "resource", DEFAULT_RESOURCE),
    )
    plugin.start()
    try:
        while plugin.running:
            plugin.wait_stopped(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        plugin.stop()
    return 0
