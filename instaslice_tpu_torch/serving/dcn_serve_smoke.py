"""The driver script and the state fingerprint of the op-stream checks
(port of ``run_script`` and ``state_digest``,
``instaslice_tpu/serving/dcn_serve_smoke.py:121-152``).

:func:`run_script` drives an engine (a
:class:`~instaslice_tpu_torch.serving.distributed.DistributedEngine` on
the driver, or a plain engine replaying the same ops in one process)
through ragged admissions, block decodes, one speculative round where
the engine has a draft, and an external budget cut; :func:`state_digest`
is what every rank of a mesh must agree on afterwards. The tests and
``chip_smoke.py`` compare the follower's digest (with ``finished``
emptied: followers drain it) with the driver's, and the driver's with a
reference engine's after the same script.
"""

from __future__ import annotations


def run_script(eng) -> None:
    """The dynamic driver script: ragged admissions, block decodes, a
    speculative round (when the engine carries a draft), an external
    budget cut."""
    eng.add_request([5, 9, 2, 7])
    eng.decode_block(3)
    eng.add_request([11, 3], stop=None)        # admitted mid-flight
    eng.decode_block(3)
    if eng.draft_model is not None:
        eng.spec_step()                        # one speculative round
    # external budget cut of the first slot (slot 0), keep 4 tokens
    eng.finish_slot(0, n_keep=4)
    eng.decode_block(2)


def state_digest(eng) -> dict:
    """Engine-state fingerprint that must agree across all ranks."""
    return {
        "finished": [
            [r.request_id, r.tokens, r.finished_reason]
            for r in eng.finished
        ],
        "live": {
            str(slot): req.generated
            for slot, req in sorted(eng.slots.items())
        },
        "tokens_generated": eng.tokens_generated,
    }
