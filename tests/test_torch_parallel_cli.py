"""The port's training CLI under ``python -m torch.distributed.run`` on
the CPU (gloo): ``--tp 2`` and ``--zero1`` at dp 2, two processes each,
against ``--tp 1`` in one process; a checkpoint the two-process run wrote
resumed by one process; the flags still refused.

Losses are the CLI's JSON ``losses`` ([step, loss] per logged step,
unrounded), held within 1e-5 relative (fp32; the partitioned sums run in
another order). The torchrun launches rendezvous on a free port
(``--standalone``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from instaslice_tpu_torch.cli import train_main

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--synthetic", "20000", "--seq-len", "15",
        "--global-batch", "8", "--d-model", "32", "--n-heads", "4",
        "--n-kv-heads", "2", "--n-layers", "2", "--d-ff", "64",
        "--vocab-size", "64", "--log-every", "1"]
REL = 1e-5


def _json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both two-process runs at once, while this process runs the
    one-process references in turn."""
    out = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", "2", "-m",
              "instaslice_tpu_torch.cli.train_main"]
    jobs = {
        "tp2": launch + TINY + ["--steps", "3", "--tp", "2"],
        "zero1": launch + TINY + ["--steps", "3", "--zero1", "--checkpoint",
                                  str(out / "ck")],
    }
    procs = {k: subprocess.Popen(cmd, cwd=out, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in jobs.items()}
    res = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=240)
            assert p.returncode == 0, (k, e[-3000:])
            res[k] = _json(o)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    res["out"] = out
    return res


def _one_process(args, capsys) -> dict:
    assert train_main.main(TINY + args) == 0
    return _json(capsys.readouterr().out)


@pytest.mark.parametrize("job,mesh", [("tp2", (1, 2)), ("zero1", (2, 1))])
def test_two_processes_match_one(runs, capsys, job, mesh):
    """--tp 2 (vocab-parallel embedding and loss, sharded blocks) and
    --zero1 at dp 2 (each rank reads its rows) give the one-process
    losses step by step."""
    one = _one_process(["--steps", "3"], capsys)
    got = runs[job]
    assert got["mesh"] == {"data": mesh[0], "seq": 1, "model": mesh[1]}
    assert got["steps"] == 3 and got["params_m"] == one["params_m"]
    assert [s for s, _ in got["losses"]] == [1, 2, 3]
    np.testing.assert_allclose([x for _, x in got["losses"]],
                               [x for _, x in one["losses"]], rtol=REL)


def test_two_process_checkpoint_resumes_in_one_process(runs, capsys):
    """The dp 2 ZeRO-1 run's checkpoint (whole leaves, gathered moments)
    resumes in one process at the uninterrupted run's step-4 loss."""
    one = _one_process(["--steps", "4"], capsys)
    resumed = _one_process(["--steps", "4", "--checkpoint",
                            str(runs["out"] / "ck")], capsys)
    assert resumed["losses"][0][0] == 4
    np.testing.assert_allclose(resumed["losses"][0][1], one["losses"][3][1],
                               rtol=REL)


def test_tp_outside_torchrun_and_lora_zero1_exit(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        train_main.main(TINY + ["--tp", "2"])
    with pytest.raises(SystemExit, match="nothing to shard"):
        train_main.main(TINY + ["--lora-rank", "4", "--zero1"])
