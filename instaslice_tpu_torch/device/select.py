"""Backend selection for the node agent and device plugin.

A port of ``instaslice_tpu/device/select.py`` without its fall back:
the reference's ``auto`` takes the fake backend when it finds no device,
and a node would then grant slices of hardware it does not have. Here
``auto`` is the NVML backend or an error naming what was missing; the
fake is used only when asked for by name.
"""

from __future__ import annotations

from instaslice_tpu_torch.device.backend import DeviceBackend, DeviceError
from instaslice_tpu_torch.device.fake import FakeGpuBackend
from instaslice_tpu_torch.device.nvml import NvmlBackend

#: the reference's other kinds, which have nothing on a node with NVIDIA
#: cards
_NOT_HERE = {
    "native": "the reference's libtpuslice.so over /dev/accel* TPU chips",
    "cloudtpu": "Cloud TPU queued resources, provisioned over REST",
}


def select_backend(kind: str = "auto", **kwargs) -> DeviceBackend:
    """``kind``: auto | nvml | fake.

    ``auto`` returns the NVML backend when ``libnvidia-ml.so.1`` (or
    ``library_path=``) loads and reports at least one GPU, and raises
    :class:`DeviceError` otherwise. ``fake`` is H100 80GB cards with the
    fixed MIG catalog.
    """
    if kind == "nvml":
        return NvmlBackend(**kwargs)
    if kind == "fake":
        return FakeGpuBackend(**kwargs)
    if kind in _NOT_HERE:
        raise DeviceError(
            f"backend {kind!r} drives {_NOT_HERE[kind]}: nothing of it is "
            "on a node with NVIDIA cards (auto|nvml|fake)")
    if kind == "auto":
        try:
            backend = NvmlBackend(**kwargs)
        except DeviceError as e:
            raise DeviceError(f"auto: no NVML device backend: {e}") from e
        if backend.gpu_count() < 1:
            backend.close()
            raise DeviceError(
                "auto: NVML loaded but reports no GPU (nvmlDeviceGetCount "
                "is 0)")
        return backend
    raise DeviceError(f"unknown backend kind {kind!r} (auto|nvml|fake)")
