"""Device layer: how the node agent touches (or fakes) NVIDIA GPUs.

A port of ``instaslice_tpu/device/`` for a node with H100 cards
(reference analog: InstaSlice's go-nvml / go-nvlib layer,
``instaslice_daemonset.go:62-65``, SURVEY.md §2a). Backends implement
one interface so the agent is unit-testable against the fake and
identical in production:

- :class:`FakeGpuBackend` — synthetic GPUs and MIG slices from the fixed
  H100 catalog, failure injection, dangling-slice seeding;
- :class:`NvmlBackend` — ctypes over ``libnvidia-ml.so.1``: discovery,
  whole-GPU reservations and MIG instances, over the crash-safe
  reservation registry (:mod:`.registry`);
- ``auto`` selection: NVML, or an error naming what was missing.
"""

from instaslice_tpu_torch.device.backend import (
    ChipsBusy,
    DeviceBackend,
    DeviceError,
    GpuInfo,
    NodeInventory,
    Reservation,
    SliceExists,
    SliceNotFound,
    TracedBackend,
)
from instaslice_tpu_torch.device.fake import FakeGpuBackend
from instaslice_tpu_torch.device.nvml import NvmlBackend, NvmlError
from instaslice_tpu_torch.device.registry import Registry
from instaslice_tpu_torch.device.select import select_backend
