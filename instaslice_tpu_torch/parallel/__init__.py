"""The parallel layer (port of ``instaslice_tpu/parallel``): the slice's
device mesh (:mod:`.meshenv`), the collectives the parallel steps issue
over its axes (:mod:`.collectives`), ring attention over ``seq``
(:mod:`.ring`) and GPipe over ``pipe`` (:mod:`.pipeline`).
"""

from instaslice_tpu_torch.parallel.meshenv import (
    SliceTopology,
    initialize_distributed,
    slice_mesh,
)
from instaslice_tpu_torch.parallel.pipeline import pipeline_blocks
from instaslice_tpu_torch.parallel.ring import ring_attention

__all__ = ["SliceTopology", "initialize_distributed", "pipeline_blocks",
           "ring_attention", "slice_mesh"]
