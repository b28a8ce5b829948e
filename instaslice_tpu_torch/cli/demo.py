"""One-process demo of the whole operator on GPU nodes:
``python -m instaslice_tpu_torch.cli.demo``.

Boots a :class:`~instaslice_tpu_torch.sim.SimCluster` (fake kube API +
controller + node agents + fake H100 backends + scheduler emulator — or
the same over real HTTP with ``--transport http``), then walks the
reference's README demo flow (InstaSlice's README shows the same story
via ``kubectl``/``nvidia-smi`` transcripts) without needing a cluster:

1. submit a gated pod requesting a MIG profile (``3g.40gb``),
2. watch allocation → realization → handoff ConfigMap → ungate → Running,
3. print the env the pod would consume: the slice's ``TPU_*`` facts and
   the granted device, ``CUDA_VISIBLE_DEVICES`` and
   ``NVIDIA_VISIBLE_DEVICES`` (its ``MIG-``/``GPU-`` UUID),
4. delete the pod and watch the slice tear down.

A copy of ``instaslice_tpu/cli/demo.py`` (the port imports nothing of the
JAX package): its flags, steps and last line
(``{"demo": "ok", "grant_seconds": ...}``) are the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the handoff keys a pod on a GPU consumes besides the slice's TPU_* facts
_DEVICE_ENV = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="instaslice-tpu demo")
    ap.add_argument("--profile", default="3g.40gb")
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--transport", choices=("inproc", "http"),
                    default="inproc")
    ap.add_argument("--keep", action="store_true",
                    help="skip the teardown half")
    args = ap.parse_args(argv)

    from instaslice_tpu_torch.sim import SimCluster

    def say(msg):
        print(f"[demo] {msg}")

    say(f"booting {args.nodes}-node h100-80gb sim cluster "
        f"(transport={args.transport})")
    with SimCluster(n_nodes=args.nodes, generation="h100-80gb",
                    deletion_grace_seconds=0.5,
                    transport=args.transport) as c:
        name = "demo-pod"
        say(f"submitting gated pod {name!r} requesting {args.profile}")
        t0 = time.monotonic()
        c.submit(name, profile=args.profile)
        if not c.wait_phase(name, "Running", timeout=60):
            say(f"FAILED: pod stuck in {c.pod_phase(name)}")
            return 1
        dt = time.monotonic() - t0
        say(f"pod Running after {dt:.2f}s "
            "(gate→place→realize→handoff→ungate→bind)")

        allocs = c.allocations()
        for alloc in allocs.values():
            say(f"allocation: profile={alloc['profile']} "
                f"box={alloc['box']} status={alloc['status']} "
                f"nodes={sorted(alloc['parts'])}")
        cm = c.configmap(name)
        say("handoff env (what the pod's envFrom sees):")
        for k in sorted(cm["data"]):
            if k.startswith("TPU_") or k in _DEVICE_ENV:
                print(f"    {k}={cm['data'][k]}")

        if args.keep:
            say("--keep: leaving the slice granted")
            return 0

        say(f"deleting {name!r} (grace 0.5s)")
        t0 = time.monotonic()
        c.delete_pod(name)
        if not c.wait_gone(name, timeout=60):
            say("FAILED: pod never finalized")
            return 1
        deadline = time.monotonic() + 30
        while c.allocations() and time.monotonic() < deadline:
            # CLI observer poll, deadline-bounded; ^C interrupts sleep
            time.sleep(0.05)  # slicelint: disable=sleep-in-loop
        if c.allocations():
            say(f"FAILED: allocation not erased: {c.allocations()}")
            return 1
        say(f"teardown complete after {time.monotonic() - t0:.2f}s "
            "(finalizer → agent release → CR erase)")
        say("demo OK")
        print(json.dumps({"demo": "ok", "grant_seconds": round(dt, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
