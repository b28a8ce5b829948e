"""Multi-worker serving smoke: the engine over a mesh that spans the
workers of a grant (port of ``instaslice_tpu/serving/dcn_serve_smoke.py``).

Run as ``python -m instaslice_tpu_torch.serving.dcn_serve_smoke`` inside
every worker pod of a multi-worker grant (or from the two-process CPU
test in ``tests/test_torch_dcn_serve_smoke.py``). Each worker:

1. parses the node agent's handoff env (:class:`SliceTopology.from_env`)
   and rendezvouses through :func:`initialize_distributed` at worker 0's
   hostname (``tcp://<TPU_WORKER_HOSTNAMES[0]>:$TPUSLICE_SMOKE_PORT``,
   default 8477), one rank per worker, as ``parallel/dcn_smoke`` does;
2. builds ONE ``("data", "seq", "model")`` mesh of ``(1, 1, world)`` over
   every rank: tensor parallelism across the workers;
3. builds the same :class:`ServingEngine` (seeded weights) over that mesh
   and runs the same op sequence (admit, block decode). Every rank must
   issue the same collectives in the same order, which the
   driver/follower op stream (:mod:`.distributed`) guarantees for live
   traffic; this smoke runs the static equivalent, or with
   ``TPUSLICE_SMOKE_MODE=oplog`` :func:`run_script` through
   :class:`DistributedEngine` on worker 0 and :func:`run_follower` on the
   others (at worker 0's hostname, port ``$TPUSLICE_OPLOG_PORT``).

Every worker prints one JSON line with the reference's keys: the SAME
greedy tokens, equal to a one-process engine's for the same seed (or,
in oplog mode, its :func:`state_digest`). A wrong collective, a diverged
op stream or a rank that reads only its shard give other tokens (or a
distributed-runtime error).

It runs on the card (each worker's ``cuda:0``, the device its
``CUDA_VISIBLE_DEVICES`` grants; NCCL) unless the caller asks for the
CPU (``TPUSLICE_SMOKE_DEVICE=cpu``); ``TPUSLICE_SMOKE_BACKEND`` names
the backend instead (``gloo``, where two workers share one card). The
reference's ``utils/tpulock`` claim has no counterpart: several
processes may share a CUDA card.

:func:`run_script` drives an engine (a :class:`DistributedEngine` on the
driver, or a plain engine replaying the same ops in one process) through
ragged admissions, block decodes, one speculative round where the engine
has a draft, and an external budget cut; :func:`state_digest` is what
every rank of a mesh must agree on afterwards. The tests and
``chip_smoke.py`` compare the follower's digest (with ``finished``
emptied: followers drain it) with the driver's, and the driver's with a
reference engine's after the same script.
"""

from __future__ import annotations

import json
import os
import sys

#: the smoke model: the reference's (vocab 64, d_model 32, 2 layers,
#: d_ff 64, fp32), one query head a rank
SMOKE_CONFIG = dict(vocab_size=64, d_model=32, n_layers=2, d_ff=64,
                    remat=False)
#: the engine's shape, the reference's
SMOKE_ENGINE = dict(max_batch=2, max_len=64, prefill_len=8, spec_k=3)
#: the static sequence: one prompt, one block of this many tokens
SMOKE_PROMPT = [5, 9, 2, 7]
SMOKE_BLOCK = 8


def smoke_engine(world: int, mesh=None, device="cuda", oplog=False):
    """The smoke's engine: the smoke model with ``world`` query heads
    (seeded weights), over ``mesh`` (None: one process), with itself as
    the draft in oplog mode (the script replays a speculative round)."""
    import torch

    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.serving import ServingEngine

    model = TpuLM(ModelConfig(n_heads=world, dtype=torch.float32,
                              **SMOKE_CONFIG))
    return ServingEngine(model, mesh=mesh, device=device,
                         draft_model=model if oplog else None,
                         **SMOKE_ENGINE)


def main() -> int:
    import torch
    import torch.distributed as dist

    from instaslice_tpu_torch.parallel.meshenv import (
        SliceTopology,
        initialize_distributed,
        slice_mesh,
    )

    topo = SliceTopology.from_env()
    device = os.environ.get("TPUSLICE_SMOKE_DEVICE", "cuda")
    backend = os.environ.get("TPUSLICE_SMOKE_BACKEND") or None
    host = topo.hostnames[0] if topo.hostnames else "127.0.0.1"
    port = int(os.environ.get("TPUSLICE_SMOKE_PORT", "8477"))
    initialize_distributed(topo, backend=backend, device=device,
                           init_method=f"tcp://{host}:{port}")
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device == "cuda" else torch.device(device)
        world = dist.get_world_size()
        mesh = slice_mesh(axes=("data", "seq", "model"),
                          axis_sizes=(1, 1, -1), device=dev.type, topo=topo)
        oplog = os.environ.get("TPUSLICE_SMOKE_MODE") == "oplog"
        eng = smoke_engine(world, mesh, dev, oplog)
        seen = [None] * world
        dist.all_gather_object(seen, topo.worker_id)
        result = {
            "worker_id": topo.worker_id,
            "processes_seen": len(set(seen)),
            "global_devices": mesh.size(),
        }
        if oplog:
            # dynamic traffic through the driver/follower op stream
            from instaslice_tpu_torch.serving.distributed import (
                DistributedEngine,
                run_follower,
            )

            oplog_port = int(os.environ["TPUSLICE_OPLOG_PORT"])
            if topo.worker_id == 0:
                deng = DistributedEngine(eng, n_followers=world - 1,
                                         port=oplog_port)
                try:
                    run_script(deng)
                finally:
                    deng.shutdown()
            else:
                # worker 0's hostname is the driver, as for the
                # rendezvous (on a grant, its pod over the headless
                # Service)
                run_follower(eng, host, oplog_port)
            result["digest"] = state_digest(eng)
        else:
            # the static op stream: every worker runs the same sequence
            rid = eng.add_request(SMOKE_PROMPT)
            out = eng.decode_block(SMOKE_BLOCK)
            result["tokens"] = [int(t) for t in out[rid]]
    finally:
        dist.destroy_process_group()
    print(json.dumps(result))
    return 0


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


if __name__ == "__main__":
    sys.exit(main())
