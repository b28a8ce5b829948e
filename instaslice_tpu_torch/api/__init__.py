"""Constants, the ``TpuSlice`` CR data model and its CRD manifest of the
port, copied from ``instaslice_tpu/api``."""

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
from instaslice_tpu_torch.api.crd import crd_manifest  # noqa: F401,E402
