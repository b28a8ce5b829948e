"""Cluster-controller entry point (reference: ``cmd/controller/main.go:55-168``).

A port of ``instaslice_tpu/cli/controller_main.py`` for a cluster of
NVIDIA cards: the reference's flags, ``--policy`` over the port's
registered policies."""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuslice-gpu-controller",
        description="instaslice_tpu_torch cluster controller: watches "
        "gated pods, allocates MIG slices or whole GPUs (and TPU "
        "sub-slices), ungates.",
    )
    from instaslice_tpu_torch.topology.policy import policy_names

    def policy_arg(value: str) -> str:
        # validate at parse time (clean exit-2 usage error, like the
        # old choices= did) while leaving the default to the env-var
        # resolution in ControllerRunner
        if value not in policy_names():
            raise argparse.ArgumentTypeError(
                f"unknown policy {value!r}; registered: "
                + ", ".join(policy_names())
            )
        return value

    p.add_argument("--namespace", default="instaslice-tpu-system",
                   help="namespace for operator-owned objects")
    p.add_argument("--policy", default=None, type=policy_arg,
                   help="allocation policy (default: the "
                   "TPUSLICE_PLACEMENT_POLICY env var, else first-fit); "
                   "registered: " + ", ".join(policy_names()))
    p.add_argument("--repack", action="store_true",
                   help="run the live-defragmentation loop: migrate "
                   "relocatable slices (drain->teardown->re-grant) when "
                   "a pending profile is blocked only by stranded "
                   "capacity (docs/SCALING.md; opt pods out with the "
                   "no-repack annotation)")
    p.add_argument("--repack-interval", type=float, default=5.0,
                   help="seconds between repacker passes")
    p.add_argument("--repack-max-concurrent", type=int, default=2,
                   help="max in-flight slice migrations")
    p.add_argument("--repack-cooldown", type=float, default=300.0,
                   help="per-pod seconds between migrations (thrash "
                   "brake)")
    p.add_argument("--repack-frag-threshold", type=float, default=None,
                   help="proactive repacking: also plan when a group's "
                   "stranded-capacity fraction (topology/frag.py) "
                   "exceeds this, not only on a starved pod (default: "
                   "TPUSLICE_REPACK_FRAG_THRESHOLD env var, else off)")
    p.add_argument("--metrics-bind-address", default=":8080")
    p.add_argument("--health-probe-bind-address", default=":8081")
    p.add_argument("--leader-elect", action="store_true")
    p.add_argument("--workers", type=int, default=None,
                   help="sharded reconcile workers (default: "
                   "TPUSLICE_RECONCILE_WORKERS or 4; per-key ordering "
                   "is preserved — docs/SCALING.md)")
    p.add_argument("--shard-leases", action="store_true",
                   help="active-active scale-out: each reconcile shard "
                   "holds its own Lease, so multiple controller "
                   "replicas split the shards (docs/SCALING.md)")
    p.add_argument("--kubeconfig", default="")
    p.add_argument("--deletion-grace-seconds", type=float, default=30.0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from instaslice_tpu_torch.cli.runtime import run_controller

    return run_controller(args)


if __name__ == "__main__":
    sys.exit(main())
