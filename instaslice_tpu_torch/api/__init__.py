"""Constants and the ``TpuSlice`` CR data model of the port, copied from
``instaslice_tpu/api`` (its ``crd.py`` comes with the controller)."""

from instaslice_tpu_torch.api.types import (  # noqa: F401
    AllocationDetails,
    AllocationStatus,
    PodRef,
    PreparedDetails,
    PreparedPart,
    TpuSlice,
    TpuSliceSpec,
    TpuSliceStatus,
    slice_uuid_for,
)
