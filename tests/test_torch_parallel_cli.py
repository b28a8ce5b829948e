"""The port's training CLI under ``python -m torch.distributed.run`` on
the CPU (gloo): ``--tp 2`` and ``--zero1`` at dp 2, two processes each,
against ``--tp 1`` in one process; a checkpoint the two-process run wrote
resumed by one process; ``--ring --sp 2``, ``--n-experts 4 --tp 2`` and
``--lora-rank 4 --tp 2`` against the same flags in one process; and
``--from-env`` at world 2 (two processes under the handoff env, no
torchrun) against the same run under torchrun; the flags still refused.

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

from conftest import free_port
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
    for name, (flags, mesh) in PARITY.items():
        jobs[name] = launch + TINY + ["--steps", "3"] + flags + mesh
    procs = {k: subprocess.Popen(cmd, cwd=out, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in jobs.items()}
    # --from-env: two plain processes under the handoff env
    port = free_port()
    for r in range(2):
        renv = dict(env, TPU_WORKER_ID=str(r),
                    TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                    TPUSLICE_COORDINATOR_PORT=str(port))
        procs[f"from_env{r}"] = subprocess.Popen(
            [sys.executable, "-m", "instaslice_tpu_torch.cli.train_main"]
            + TINY + ["--steps", "3", "--tp", "2", "--from-env"], cwd=out,
            env=renv, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
    res = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=240)
            assert p.returncode == 0, (k, e[-3000:])
            if k != "from_env1":        # rank 0 prints the JSON line
                res[k] = _json(o)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    res["out"] = out
    return res


#: flags held against the same flags in one process: (the flags, the
#: two-process job's mesh)
PARITY = {
    "ring_sp2": (["--ring"], ["--sp", "2"]),
    "moe_tp2": (["--n-experts", "4"], ["--tp", "2"]),
    "lora_tp2": (["--lora-rank", "4", "--lora-targets", "wq,wv,wo"],
                 ["--tp", "2"]),
}


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


@pytest.mark.parametrize("job", list(PARITY))
def test_new_mesh_flags_match_one_process(runs, capsys, job):
    """``--ring --sp 2`` (each rank a block of every 16-token row, ring
    attention, the one-shot loss), ``--n-experts 4 --tp 2`` (two experts a
    rank) and ``--lora-rank 4 --tp 2`` (adapters over the base's shards)
    give the one-process losses of the same flags step by step."""
    one = _one_process(["--steps", "3"] + PARITY[job][0], capsys)
    got = runs[job]
    sp, tp = (2, 1) if job == "ring_sp2" else (1, 2)
    assert got["mesh"] == {"data": 1, "seq": sp, "model": tp}
    assert got["params_m"] == one["params_m"]
    np.testing.assert_allclose([x for _, x in got["losses"]],
                               [x for _, x in one["losses"]], rtol=REL)


def test_from_env_matches_torchrun(runs):
    """``--from-env --tp 2`` in two processes whose group comes from the
    handoff env (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
    ``TPUSLICE_COORDINATOR_PORT``) gives the torchrun run's mesh and
    losses bit for bit."""
    got, want = runs["from_env0"], runs["tp2"]
    assert got["mesh"] == want["mesh"] == {"data": 1, "seq": 1, "model": 2}
    assert got["losses"] == want["losses"]


def test_ring_seq_len_must_divide_over_sp(monkeypatch):
    """The reference's check: dataset rows are seq_len + 1 wide and ring
    shards them over sp."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="does not divide"):
        train_main.main(TINY + ["--ring", "--sp", "3"])


def test_tp_outside_torchrun_and_lora_zero1_exit(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        train_main.main(TINY + ["--tp", "2"])
    with pytest.raises(SystemExit, match="nothing to shard"):
        train_main.main(TINY + ["--lora-rank", "4", "--zero1"])
