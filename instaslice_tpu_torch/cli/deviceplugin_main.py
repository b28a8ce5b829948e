"""Kubelet device-plugin entry point advertising ``nvidia.com/gpu``
(port of ``instaslice_tpu/cli/deviceplugin_main.py``).

InstaSlice leaves this to NVIDIA's device plugin and kicks it through a
node label (``instaslice_daemonset.go:474-497``); here it is in the
tree. ``--backend auto`` (the default) is the NVML backend or an error:
the fake backend is taken only by name.
"""

from __future__ import annotations

import argparse
import sys

from instaslice_tpu_torch.api.constants import GPU_RESOURCE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuslice-gpu-deviceplugin",
        description=f"kubelet device plugin advertising {GPU_RESOURCE}",
    )
    p.add_argument("--plugin-dir", default="/var/lib/kubelet/device-plugins")
    p.add_argument("--backend", default="auto")
    p.add_argument("--resource", default=GPU_RESOURCE)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from instaslice_tpu_torch.cli.runtime import run_deviceplugin

    return run_deviceplugin(args)


if __name__ == "__main__":
    sys.exit(main())
