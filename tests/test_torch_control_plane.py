"""The port's control plane loads neither torch nor numpy.

The controller, the node agent, the device plugin, the telemetry
aggregator and the operator CLI (``tpuslice-gpu-controller``,
``-agent``, ``-deviceplugin``, ``-telemetry``, ``tpuslice-gpu``), the
runtime each one starts, and the simulator with its demo import only
the standard library and the port's control-plane modules, as the
reference's counterparts import neither JAX nor numpy. So their images
install no PyTorch, and their processes start in a fraction of a second
instead of the seconds a torch import takes.

Each case imports its module in a fresh interpreter and reads
``sys.modules``; the demo runs its whole pod loop over HTTP to ``demo
OK`` with an import hook that refuses torch and numpy. The control: the
port's HTTP server (``serving.api_server``, the data plane) does load
torch.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

#: refuses torch and numpy (and their submodules) before anything runs
REFUSE = """
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy"):
            raise ImportError(f"{name} refused: the control plane "
                              "loads no torch or numpy")
        return None

sys.meta_path.insert(0, Refuse())
"""

#: the port's control-plane entry modules (console scripts, the runtime
#: each starts, the simulator and its demo), each beside the reference's
#: counterpart
CONTROL_PLANE = [
    ("cli.controller_main", "cli.controller_main"),
    ("cli.agent_main", "cli.agent_main"),
    ("cli.deviceplugin_main", "cli.deviceplugin_main"),
    ("obs.telemetry", "obs.telemetry"),
    ("cli.tpuslicectl", "cli.tpuslicectl"),
    ("cli.runtime", "cli.runtime"),
    ("controller.runner", "controller.runner"),
    ("agent.runner", "agent.runner"),
    ("deviceplugin.server", "deviceplugin.server"),
    ("device.select", "device.select"),
    ("sim", "sim"),
    ("cli.demo", "cli.demo"),
]


def loaded(module: str, hook: bool = False) -> list:
    """The heavy packages in ``sys.modules`` after importing ``module``
    in a fresh interpreter (with the refusing hook: the import must
    succeed all the same)."""
    code = (REFUSE if hook else "") + (
        f"import {module}\n"
        "print(sorted(k for k in ('torch', 'numpy', 'jax') "
        "if k in sys.modules))\n")
    if not hook:
        code = "import sys\n" + code
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return eval(r.stdout.strip().splitlines()[-1])


def test_package_root_loads_no_torch():
    assert loaded("instaslice_tpu_torch") == []


@pytest.mark.parametrize("port,ref", CONTROL_PLANE,
                         ids=[p for p, _ in CONTROL_PLANE])
def test_entry_point_loads_no_torch(port, ref):
    assert loaded(f"instaslice_tpu_torch.{port}") == []
    # and it imports with torch and numpy refused outright
    assert loaded(f"instaslice_tpu_torch.{port}", hook=True) == []
    # the reference's counterpart loads neither JAX nor numpy either
    assert loaded(f"instaslice_tpu.{ref}") == []


@pytest.mark.parametrize("module", ["deploy.manifests",
                                    "deploy.gen_manifests", "deploy.check"])
def test_deploy_plane_loads_no_torch(module):
    """The deploy plane renders and checks the tree from a control-plane
    image too."""
    assert loaded(f"instaslice_tpu_torch.{module}", hook=True) == []


def test_console_scripts_parse_without_torch():
    """Each control-plane console script's parser, as its ``main`` builds
    it, under the refusing hook."""
    code = REFUSE + """
from instaslice_tpu_torch.cli import agent_main, controller_main
from instaslice_tpu_torch.cli import deviceplugin_main
from instaslice_tpu_torch.obs import telemetry
from instaslice_tpu_torch.cli import tpuslicectl

a = controller_main.build_parser().parse_args(["--leader-elect"])
b = agent_main.build_parser().parse_args(["--backend=auto"])
c = deviceplugin_main.build_parser().parse_args(["--backend=auto"])
assert a.leader_elect and b.backend == c.backend == "auto"
for main in (telemetry.main, tpuslicectl.main):
    try:
        main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
print("parsed")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("parsed"), \
        r.stderr[-3000:]


def test_demo_runs_without_torch():
    """The whole pod loop (controller, agents, fake H100 backends,
    scheduler emulator) over HTTP, torch and numpy refused."""
    code = REFUSE + """
from instaslice_tpu_torch.cli import demo
sys.exit(demo.main(["--transport", "http"]))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "[demo] demo OK" in r.stdout
    assert '"demo": "ok"' in r.stdout.strip().splitlines()[-1]


def test_resolve_device_imports_torch_when_called():
    """``resolve_device`` keeps its behaviour: the CPU as asked, and on a
    host without a card a CUDA device raises (never the CPU instead)."""
    code = """
import sys
import instaslice_tpu_torch as t
assert "torch" not in sys.modules
dev = t.resolve_device("cpu")
assert "torch" in sys.modules and str(dev) == "cpu", dev
import torch
if torch.cuda.is_available():
    print("card", t.resolve_device("cuda"))
else:
    try:
        t.resolve_device("cuda")
    except RuntimeError as e:
        print("raised", e)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.strip()
    assert out.startswith("card cuda:") or (
        out.startswith("raised") and "is_available() is False" in out), out


def test_control_data_plane_loads_torch():
    """The control: the port's HTTP server is the data plane, and it
    does import torch (so the check above can see a torch import)."""
    assert "torch" in loaded("instaslice_tpu_torch.serving.api_server")
