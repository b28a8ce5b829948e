"""Rendezvous smoke: prove the workers of a granted slice can meet (port
of ``instaslice_tpu/parallel/dcn_smoke.py``).

Run as ``python -m instaslice_tpu_torch.parallel.dcn_smoke`` inside
every worker of a multi-worker grant. Each worker:

1. parses the node agent's handoff env (:class:`SliceTopology.from_env`),
2. calls :func:`initialize_distributed` at worker 0's hostname
   (``tcp://<TPU_WORKER_HOSTNAMES[0]>:$TPUSLICE_SMOKE_PORT``, default
   8476), one rank per worker,
3. builds the slice mesh over every rank (:func:`slice_mesh`, one axis),
   and
4. all-reduces ``worker_id + 1`` over it.

Every worker must print the same total, ``sum_{w<W} (w+1)`` times its
one local device: a wrong rank wiring, a mesh that covers one process,
or a broken rendezvous give another number (or a hang, which the caller
bounds with a timeout). The output is one JSON line with the
reference's keys.

It runs on the card (each worker's ``cuda:0``, the device its
``CUDA_VISIBLE_DEVICES`` grants; NCCL) unless the caller asks for the
CPU (``TPUSLICE_SMOKE_DEVICE=cpu``); ``TPUSLICE_SMOKE_BACKEND`` names
the backend instead (``gloo``, where two workers share one card). The
reference's ``utils/tpulock`` claim has no counterpart: several
processes may share a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys


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
    port = int(os.environ.get("TPUSLICE_SMOKE_PORT", "8476"))
    print(f"[smoke w{topo.worker_id}] initializing distributed",
          file=sys.stderr, flush=True)
    initialize_distributed(topo, backend=backend, device=device,
                           init_method=f"tcp://{host}:{port}")
    try:
        print(f"[smoke w{topo.worker_id}] rendezvous done",
              file=sys.stderr, flush=True)
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device == "cuda" else torch.device(device)
        mesh = slice_mesh(axes=("d",), axis_sizes=(-1,), device=dev.type,
                          topo=topo)
        group = mesh.get_group("d")
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, topo.worker_id)
        local = 1                      # one device per process
        contrib = torch.full((local,), float(topo.worker_id + 1),
                             dtype=torch.float32, device=dev)
        total = contrib.sum()
        dist.all_reduce(total, group=group)
        out = {
            "worker_id": topo.worker_id,
            "num_workers": topo.num_workers,
            "processes_seen": len(set(seen)),
            "global_devices": mesh.size(),
            "local_devices": local,
            "psum_total": float(total.item()),
        }
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
