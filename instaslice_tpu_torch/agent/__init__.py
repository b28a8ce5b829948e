"""The node agent, copied from ``instaslice_tpu/agent/``: the device
handoff (``handoff.py``), boot discovery (``discovery.py``), the
reconciler (``reconciler.py``), the process runner (``runner.py``) and,
the port's own, its rules on a GPU grid (``gpugrid.py``)."""

from instaslice_tpu_torch.agent.handoff import (  # noqa: F401
    configmap_manifest,
    slice_env,
)
from instaslice_tpu_torch.agent.discovery import discover_node  # noqa: F401
from instaslice_tpu_torch.agent.reconciler import NodeAgent  # noqa: F401
