"""``python -m instaslice_tpu_torch.cli.demo`` against the reference's
demo (``instaslice_tpu/cli/demo.py``): over both transports the port's
steps are the reference's, step for step, and its last line has the
reference's keys. The handoff block names the granted device, the
``MIG-`` UUID a pod's CUDA reads (``CUDA_VISIBLE_DEVICES``,
``NVIDIA_VISIBLE_DEVICES``); the control, the reference's filter (keys
that start with ``TPU_``), prints no device.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from instaslice_tpu.cli import demo as rdemo
from instaslice_tpu_torch.cli import demo as tdemo

REPO = Path(__file__).resolve().parents[1]


def _steps(out: str) -> list:
    """Each ``[demo]`` line's step, its numbers, names and profile cut."""
    steps = []
    for line in out.splitlines():
        if not line.startswith("[demo] "):
            continue
        text = line[len("[demo] "):]
        text = re.sub(r"\d+(\.\d+)?s\b", "<s>", text)
        text = re.sub(r"profile=\S+|box=\S+|nodes=\[.*\]|requesting \S+|"
                      r"v5e|h100-80gb", "<x>", text)
        steps.append(text)
    return steps


def _env(out: str) -> dict:
    return dict(line.strip().split("=", 1) for line in out.splitlines()
                if line.startswith("    "))


@pytest.mark.parametrize("transport", ["inproc", "http"])
def test_demo_steps_equal_the_reference(capsys, transport):
    assert rdemo.main(["--transport", transport,
                       "--profile", "v5e-2x2"]) == 0
    want = capsys.readouterr().out
    assert tdemo.main(["--transport", transport]) == 0
    got = capsys.readouterr().out
    assert _steps(got) == _steps(want)
    assert len(_steps(got)) == 8
    last, ref_last = (json.loads(o.strip().splitlines()[-1])
                      for o in (got, want))
    assert set(last) == set(ref_last) == {"demo", "grant_seconds"}
    assert last["demo"] == "ok" and last["grant_seconds"] > 0
    env = _env(got)
    assert env["CUDA_VISIBLE_DEVICES"].startswith("MIG-")
    assert env["NVIDIA_VISIBLE_DEVICES"] == env["CUDA_VISIBLE_DEVICES"]
    assert env["TPU_SLICE_PROFILE"] == "3g.40gb"
    assert {k for k in _env(want)} <= set(env)


def test_control_the_reference_filter_prints_no_device(capsys, monkeypatch):
    monkeypatch.setattr(tdemo, "_DEVICE_ENV", ())
    assert tdemo.main(["--keep"]) == 0
    env = _env(capsys.readouterr().out)
    assert "TPU_SLICE_PROFILE" in env and "CUDA_VISIBLE_DEVICES" not in env


def test_demo_module_in_a_fresh_process():
    res = subprocess.run(
        [sys.executable, "-m", "instaslice_tpu_torch.cli.demo",
         "--transport", "http", "--nodes", "1", "--profile", "1g.10gb"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["demo"] == "ok"
    assert "CUDA_VISIBLE_DEVICES=MIG-" in res.stdout
