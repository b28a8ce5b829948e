"""The port's driver/follower op stream (``serving/distributed.py``) held
against the reference's on the CPU.

A two-rank gloo world (``torch_serve_tp_worker.py``) serves a tp 2 engine
(the fp32 weights of ``test_torch_serve_tp.py``; each rank 2 query heads,
1 KV head): rank 0 drives through ``DistributedEngine`` and rank 1
replays through ``run_follower``. The follower's ``state_digest`` (its
``finished`` drained, as followers drain it) must equal the driver's,
and the driver's must equal the JAX package's mesh engine's on two
virtual CPU devices after the same script, as
``tests/test_distributed.py`` holds the reference's. Then the ports of
the reference's handshake and scheduler tests (in one process, meshless
engines) and ``--from-env`` in two server processes under the handoff
env.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from conftest import free_port
from instaslice_tpu.models import lm as jlm
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.serving import ServingEngine
from instaslice_tpu_torch.serving.api_server import ApiServer
from instaslice_tpu_torch.serving.dcn_serve_smoke import (
    run_script,
    state_digest,
)
from instaslice_tpu_torch.serving.distributed import (
    DistributedEngine,
    run_follower,
)
from test_distributed import _worker_envs
from test_torch_serve_tp import _trees
from torch_port_util import (
    REPO,
    SMALL,
    WORLD,
    configs,
    encode_tree,
    spawn_world,
)
from torch_serve_tp_worker import ENGINE, session_script


def _port_engine(**kw) -> ServingEngine:
    _, tcfg = configs("fp32")
    return ServingEngine(TpuLM(tcfg), _trees(None)[1], device="cpu",
                         radix_cache=False, **ENGINE, **kw)


def _jax_mesh_engine(**kw):
    jcfg, _ = configs("fp32")
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, 1, WORLD),
                ("data", "seq", "model"))
    model = jlm.TpuLM(jcfg)
    if kw.pop("self_draft", False):
        kw.update(draft_model=model, draft_params=_trees(None)[0], spec_k=3)
    return JaxEngine(model, _trees(None)[0], mesh=mesh, radix_cache=False,
                     **ENGINE, **kw)


def _blob():
    """A session parked and exported by a meshless port engine (whole
    heads in its stripe)."""
    src = _port_engine()
    src.add_request([12, 40, 7])
    src.decode_block(2)
    return src.export_session(src.preempt_slot(0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("oplog")
    params = encode_tree(_trees(None)[1])
    base = {"cfg": SMALL, "params": params, "kv_quant": False}
    cases = [dict(base, kind="oplog", name="oplog", self_draft=True,
                  port=free_port()),
             dict(base, kind="session", name="session", blob=_blob(),
                  port=free_port())]
    w = spawn_world(out, cases)
    try:
        yield w
    finally:
        w.close()


def _follower_agrees(world, name):
    d, f = world.result(name, 0), world.result(name, 1)
    assert f["applied"] > 0
    assert dict(f["digest"], finished=[]) == dict(d["digest"], finished=[])
    assert f["parked"] == d["parked"]
    return d


def test_run_script_over_the_op_stream_matches_the_jax_mesh_engine(world):
    """Ragged admissions, block decodes, one self-draft spec round and a
    budget cut driven over the op stream at tp 2: the follower lands in
    the driver's state, and the driver's digest is the JAX mesh engine's
    after the same script (and the port's meshless engine's)."""
    d = _follower_agrees(world, "oplog")
    ref = _jax_mesh_engine(self_draft=True)
    run_script(ref)
    assert d["digest"] == state_digest(ref)
    one = _port_engine(draft_model=TpuLM(configs("fp32")[1]),
                       draft_params=_trees(None)[1], spec_k=3)
    run_script(one)
    assert d["digest"] == state_digest(one)
    # the budget-cut request kept exactly 4 tokens
    assert len(d["digest"]["finished"][0][1]) == 4
    assert d["digest"]["finished"][0][2] == "max_new_tokens"


def test_preempt_resume_and_import_ride_the_op_stream(world):
    """A preempt/resume and a session exported by a meshless port engine
    imported at tp 2 (each rank keeps its head of the blob's stripes) and
    resumed, over the op stream: the follower agrees with the driver, and
    the driver's state is the one the same script leaves on the JAX mesh
    engine and on the meshless port engine. ``export_session`` at tp 2
    refuses."""
    d = _follower_agrees(world, "session")
    assert d["export"].startswith("session export over a multi-process")
    blob = _blob()
    for ref in (_jax_mesh_engine(), _port_engine()):
        assert session_script(ref, blob) == ""
        assert d["digest"] == state_digest(ref)
    assert len(d["digest"]["live"]) == 2


def test_stray_connector_rejected():
    """A prober connecting to the op-stream port must not consume a
    follower slot or receive the op stream (the reference's
    ``TestOplogHandshake``)."""
    import socket as _socket

    driver_eng, follower_eng = _port_engine(), _port_engine()
    port = free_port()
    stray_got = {}

    def stray():
        s = _socket.socket()
        deadline = time.monotonic() + 30
        while True:
            try:
                s.connect(("127.0.0.1", port))
                break
            except OSError:
                if time.monotonic() > deadline:
                    return
                time.sleep(0.05)
        s.sendall(b"GET / HTTP/1.0\r\n\r\n")
        stray_got["data"] = s.recv(4096)   # b"" == closed on us
        s.close()

    t_stray = threading.Thread(target=stray, daemon=True)
    t_stray.start()

    def follower():
        time.sleep(0.5)                    # let the stray go first
        run_follower(follower_eng, "127.0.0.1", port)

    t_follow = threading.Thread(target=follower, daemon=True)
    t_follow.start()
    deng = DistributedEngine(driver_eng, n_followers=1, port=port)
    deng.add_request([5, 9, 2, 7])
    deng.shutdown()
    t_follow.join(timeout=15)
    t_stray.join(timeout=15)
    assert not t_follow.is_alive()
    assert 0 in follower_eng.slots
    assert stray_got.get("data") == b""


def test_follower_started_before_the_driver_listens():
    """A follower whose first connects are refused (the driver is still
    building) joins once the driver listens: each attempt takes a fresh
    socket (on some Linux kernels a socket whose connect was refused
    fails every later connect with ECONNABORTED)."""
    driver_eng, follower_eng = _port_engine(), _port_engine()
    port = free_port()
    follower = threading.Thread(
        target=run_follower, args=(follower_eng, "127.0.0.1", port),
        kwargs={"connect_timeout": 30}, daemon=True)
    follower.start()
    time.sleep(1.0)                        # several refused attempts
    deng = DistributedEngine(driver_eng, n_followers=1, port=port,
                             accept_timeout=30)
    deng.add_request([5, 9, 2, 7])
    deng.shutdown()
    follower.join(timeout=15)
    assert not follower.is_alive()
    assert follower_eng.slots.keys() == driver_eng.slots.keys() == {0}


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        f"{url}/v1/completions", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_scheduler_only_mutates_via_broadcast_ops():
    """``ApiServer(DistributedEngine)`` with a same-process follower:
    after live HTTP traffic and a broadcast eviction the follower's
    replayed state equals the driver's (the reference's
    ``TestApiServerOverDistributedEngine``)."""
    driver_eng, follower_eng = _port_engine(), _port_engine()
    port = free_port()
    follower = threading.Thread(
        target=run_follower, args=(follower_eng, "127.0.0.1", port),
        daemon=True)
    follower.start()
    deng = DistributedEngine(driver_eng, n_followers=1, port=port)
    with ApiServer(deng, request_timeout=20) as srv:
        code, out = _post(srv.url, {"prompt": [5, 9, 2, 7], "max_tokens": 6})
        assert code == 200
        assert len(out["choices"][0]["token_ids"]) == 6
        code, _ = _post(srv.url, {"prompt": [11, 3], "max_tokens": 4})
        assert code == 200
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and driver_eng.slots:
            time.sleep(0.05)
    rid = deng.add_request([9, 9])
    slot = next(s for s, r in driver_eng.slots.items()
                if r.request_id == rid)
    deng.evict_slot(slot)
    deng.shutdown()
    follower.join(timeout=10)
    assert not follower.is_alive()
    assert follower_eng.slots.keys() == driver_eng.slots.keys()
    for s in driver_eng.slots:
        assert (follower_eng.slots[s].generated
                == driver_eng.slots[s].generated)
    assert follower_eng.tokens_generated == driver_eng.tokens_generated


def test_from_env_serves_from_two_processes():
    """``python -m instaslice_tpu_torch.serving.api_server --from-env
    --device cpu`` in both worker processes of a two-host grant's handoff
    env (the reference's ``TestServeCliMultiHost``): they rendezvous over
    gloo, rank 0 answers HTTP and drives, rank 1 follows; a completion
    comes back, ``/v1/stats`` shows the (1, 1, 2) mesh and the eager
    route, and on SIGTERM the driver releases the follower, which exits
    0."""
    coord, http_port, oplog_port = free_port(), free_port(), free_port()
    args = ["--from-env", "--device", "cpu", "--host", "127.0.0.1",
            "--port", str(http_port), "--oplog-port", str(oplog_port),
            "--d-model", "32", "--n-heads", "4", "--n-kv-heads", "2",
            "--n-layers", "2", "--d-ff", "64", "--vocab-size", "64",
            "--max-batch", "2", "--max-len", "64", "--prefill-len", "8"]
    procs = []
    for env in _worker_envs():
        child = dict(os.environ)
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            child.pop(k, None)
        child.update(env)
        child["TPU_WORKER_HOSTNAMES"] = "127.0.0.1,127.0.0.1"
        child["TPUSLICE_COORDINATOR_PORT"] = str(coord)
        child["PYTHONPATH"] = str(REPO)
        child["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "instaslice_tpu_torch.serving.api_server"]
            + args, env=child, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    url = f"http://127.0.0.1:{http_port}"
    try:
        deadline = time.monotonic() + 120
        up = False
        while time.monotonic() < deadline:
            if any(p.poll() is not None for p in procs):
                break
            try:
                urllib.request.urlopen(url + "/healthz", timeout=2)
                up = True
                break
            except OSError:
                time.sleep(0.5)
        assert up, [p.poll() for p in procs]
        code, out = _post(url, {"prompt": [5, 9, 2, 7], "max_tokens": 6})
        assert code == 200
        toks = out["choices"][0]["token_ids"]
        assert len(toks) == 6 and all(0 <= t < 64 for t in toks)
        with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["mesh"] == {"data": 1, "seq": 1, "model": 2}
        assert stats["engine"]["decode_graphs"]["route"].startswith(
            "eager (tensor parallel")
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=60) == 0
        assert procs[1].wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
