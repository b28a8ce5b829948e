"""The port's multi-worker serving smoke
(``instaslice_tpu_torch/serving/dcn_serve_smoke.py`` ``main``) in two CPU
processes over gloo, each with its worker's env of a two-host grant built
by the port's own pipeline (placement engine -> ``AllocationDetails`` ->
``agent/handoff.py``'s ``slice_env``), as the reference's
``tests/test_distributed.py::TestDcnRendezvous`` runs its own.

Static mode: both workers print the reference's keys and the same 8
greedy tokens, equal to the JAX package's mesh engine's on two virtual
CPU devices over the same weights (the port's seeded init, bridged bit
for bit), and to a one-process port engine's. Oplog mode: worker 0
drives ``run_script`` through ``DistributedEngine`` and worker 1 replays
it; their digests agree (``finished`` emptied: the follower drains it)
and the driver's equals the digest that the reference's ``run_script``
leaves on that JAX mesh engine, and a one-process port engine's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from conftest import free_port
from instaslice_tpu.models.lm import ModelConfig as JaxConfig
from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu.serving import dcn_serve_smoke as jax_smoke
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.serving.dcn_serve_smoke import (
    SMOKE_BLOCK,
    SMOKE_CONFIG,
    SMOKE_ENGINE,
    SMOKE_PROMPT,
    run_script,
    smoke_engine,
    state_digest,
)
from test_torch_dcn_smoke import worker_envs

REPO = Path(__file__).resolve().parents[1]
WORLD = 2


def jax_engine(oplog=False):
    """The JAX package's engine over a ``(1, 1, 2)`` mesh of virtual CPU
    devices, built as the reference's smoke builds its own, on the
    weights (and in oplog mode the self-draft's) that every worker's
    :func:`smoke_engine` seeds, bridged bit for bit."""
    port = smoke_engine(WORLD, device="cpu", oplog=oplog)

    def tree(params):
        return jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))

    model = JaxLM(JaxConfig(n_heads=WORLD, dtype=jnp.float32,
                            **SMOKE_CONFIG))
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, 1, WORLD),
                ("data", "seq", "model"))
    return JaxEngine(model, tree(port.params), mesh=mesh,
                     draft_model=model if oplog else None,
                     draft_params=tree(port.draft_params) if oplog
                     else None, **SMOKE_ENGINE)


def spawn(extra=None, timeout=240):
    """Both workers of the grant; each one's parsed last line."""
    port = free_port()
    procs = []
    for env in worker_envs():
        child = dict(os.environ, **env, **(extra or {}))
        # pod names resolve over the cluster's headless Service; here
        # both workers are this host
        child.update(TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                     TPUSLICE_SMOKE_PORT=str(port),
                     TPUSLICE_SMOKE_DEVICE="cpu", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "instaslice_tpu_torch.serving.dcn_serve_smoke"],
            cwd=REPO, env=child, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert sorted(o["worker_id"] for o in outs) == [0, 1]
    return sorted(outs, key=lambda o: o["worker_id"])


def test_two_workers_decode_the_same_tokens():
    outs = spawn()
    for o in outs:
        assert set(o) == {"worker_id", "processes_seen", "global_devices",
                          "tokens"}
        assert (o["processes_seen"], o["global_devices"]) == (2, 2)
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert len(outs[0]["tokens"]) == SMOKE_BLOCK
    # ... equal to the reference's mesh engine over the same weights
    ref = jax_engine()
    rid = ref.add_request(SMOKE_PROMPT)
    assert outs[0]["tokens"] == [int(t) for t in
                                 ref.decode_block(SMOKE_BLOCK)[rid]]
    # ... and to one port process over them
    one = smoke_engine(WORLD, device="cpu")
    rid = one.add_request(SMOKE_PROMPT)
    assert outs[0]["tokens"] == one.decode_block(SMOKE_BLOCK)[rid]


def test_oplog_driver_and_follower_agree():
    outs = spawn({"TPUSLICE_SMOKE_MODE": "oplog",
                  "TPUSLICE_OPLOG_PORT": str(free_port())})
    driver, follower = (o["digest"] for o in outs)
    assert driver["tokens_generated"] > 0 and driver["finished"]
    assert dict(follower, finished=[]) == dict(driver, finished=[])
    # the digest went through JSON: compare each reference's so too
    ref = jax_engine(oplog=True)
    jax_smoke.run_script(ref)
    assert json.loads(json.dumps(jax_smoke.state_digest(ref))) == driver
    one = smoke_engine(WORLD, device="cpu", oplog=True)
    run_script(one)
    assert json.loads(json.dumps(state_digest(one))) == driver

