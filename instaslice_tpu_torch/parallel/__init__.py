"""The parallel layer (port of ``instaslice_tpu/parallel``): the slice's
device mesh (:mod:`.meshenv`) and the collectives the parallel train step
issues over its axes (:mod:`.collectives`).

Not ported yet, and raising ``NotImplementedError`` when imported from
here: ``pipeline_blocks`` (GPipe, ``parallel/pipeline.py``) and
``ring_attention`` (``parallel/ring.py``); ROADMAP queue A lists them.
"""

from instaslice_tpu_torch.parallel.meshenv import (
    SliceTopology,
    initialize_distributed,
    slice_mesh,
)

__all__ = ["SliceTopology", "initialize_distributed", "slice_mesh"]

_UNPORTED = {
    "pipeline_blocks": "GPipe pipeline parallelism",
    "ring_attention": "ring attention over the seq axis",
}


def __getattr__(name: str):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"{name} ({_UNPORTED[name]}) is not ported yet: ROADMAP "
            "queue A")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
