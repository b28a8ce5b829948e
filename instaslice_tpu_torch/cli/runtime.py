"""Runtime wiring for the port's CLI entry points (a copy of
``instaslice_tpu/cli/runtime.py``)."""

from __future__ import annotations

import sys


def run_controller(args) -> int:
    try:
        from instaslice_tpu_torch.controller.runner import ControllerRunner
    except ImportError as e:
        print(f"controller unavailable: {e}", file=sys.stderr)
        return 1
    return ControllerRunner.from_args(args).run()


def run_agent(args) -> int:
    try:
        from instaslice_tpu_torch.agent.runner import AgentRunner
    except ImportError as e:
        print(f"agent unavailable: {e}", file=sys.stderr)
        return 1
    return AgentRunner.from_args(args).run()


def run_deviceplugin(args) -> int:
    try:
        from instaslice_tpu_torch.deviceplugin.server import serve
    except ImportError as e:
        print(f"device plugin unavailable: {e}", file=sys.stderr)
        return 1
    return serve(args)
