"""Per-node agent entry point (reference: ``cmd/daemonset/main.go:55-168``).

A port of ``instaslice_tpu/cli/agent_main.py`` for a node of NVIDIA
cards: ``--backend`` is ``auto`` (the NVML backend, or an error: nothing
falls back to the fake), ``nvml`` or ``fake``."""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuslice-gpu-agent",
        description="instaslice_tpu_torch node agent: discovers GPUs, "
        "realizes allocations (MIG slices or whole GPUs), injects slice env.",
    )
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""),
                   help="this node's name (downward API NODE_NAME)")
    p.add_argument("--namespace", default="instaslice-tpu-system")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "nvml", "fake"],
                   help="device backend (see instaslice_tpu_torch.device.select)")
    p.add_argument("--metrics-bind-address", default=":8084")
    p.add_argument("--health-probe-bind-address", default=":8085")
    p.add_argument("--kubeconfig", default="")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.node_name:
        print("error: --node-name or NODE_NAME env required", file=sys.stderr)
        return 2
    from instaslice_tpu_torch.cli.runtime import run_agent

    return run_agent(args)


if __name__ == "__main__":
    sys.exit(main())
