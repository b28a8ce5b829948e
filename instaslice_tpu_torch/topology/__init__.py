"""Topology core: pure chip-grid model, profile catalog, placement engine.

No Kubernetes, no device access — everything here is deterministic and
unit-testable. This layer is the TPU generalization of the reference's MIG
placement machinery: where InstaSlice scans a 1-D 8-slot occupancy array per
GPU against a profile's legal start indexes
(``internal/controller/instaslice_controller.go:303-384``),
we place axis-aligned contiguous boxes on a 2/3-D chip mesh so every granted
sub-slice has full internal ICI connectivity.

A copy of ``instaslice_tpu/topology/__init__.py`` (the port imports
nothing of the JAX package).
"""

from instaslice_tpu_torch.topology.grid import (
    Generation,
    GENERATIONS,
    NodeGrid,
    TorusGroup,
)
from instaslice_tpu_torch.topology.profiles import (
    TopologyProfile,
    parse_profile_name,
    profile_catalog,
)
from instaslice_tpu_torch.topology.placement import (
    Box,
    Placement,
    Occupancy,
    find_placements,
    legal_placements,
)
from instaslice_tpu_torch.topology.policy import (
    AllocationPolicy,
    FirstFitPolicy,
    BestFitPolicy,
    FragAwarePolicy,
    get_policy,
    policy_names,
)
from instaslice_tpu_torch.topology.frag import (
    FragMetrics,
    frag_metrics,
    free_fit_boxes,
    weighted_free_capacity,
)
from instaslice_tpu_torch.topology.mig import (
    MigProfile,
    gpu_group,
    mig_catalog,
    parse_mig_profile,
    whole_gpu,
)
