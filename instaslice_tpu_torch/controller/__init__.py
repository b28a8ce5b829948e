"""Cluster controller — reference analog:
InstaSlice's ``internal/controller/instaslice_controller.go``.

Watches scheduling-gated pods, chooses a placement on some torus group,
writes allocation records into the involved nodes' ``TpuSlice`` CRs,
ungates pods once agents realize the slice, and drives graceful teardown
on pod deletion.

A copy of ``instaslice_tpu/controller/`` (the port imports nothing of
the JAX package): the gates (``gates.py``), the reconciler
(``reconciler.py``), the repacker (``defrag.py``), the process runner
(``runner.py``) and, the port's own, its rules on a GPU grid
(``gpugrid.py``).
"""

from instaslice_tpu_torch.controller.gates import (  # noqa: F401
    extract_profile,
    is_pod_gated,
    pod_group,
)
from instaslice_tpu_torch.controller.reconciler import Controller  # noqa: F401
from instaslice_tpu_torch.controller.defrag import Repacker  # noqa: F401
