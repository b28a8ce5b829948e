"""Runtime wiring for the port's CLI entry points (a copy of
``run_deviceplugin``, ``instaslice_tpu/cli/runtime.py:31-37``; the
controller and the agent are not ported yet)."""

from __future__ import annotations

import sys


def run_deviceplugin(args) -> int:
    try:
        from instaslice_tpu_torch.deviceplugin.server import serve
    except ImportError as e:
        print(f"device plugin unavailable: {e}", file=sys.stderr)
        return 1
    return serve(args)
