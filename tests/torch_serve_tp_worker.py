"""One rank of the two-rank gloo world that ``tests/test_torch_serve_tp.py``
and ``tests/test_torch_distributed.py`` spawn on the CPU: ``python
tests/torch_serve_tp_worker.py RANK WORLD DIR``.

It reads ``DIR/cases.pt`` (written by the test: each case's config, its
whole weights, its prompts), joins the world through a file store in
``DIR`` and runs every case in order over a ("data", "seq", "model")
mesh of (1, 1, 2); each rank writes what the test compares to
``DIR/<name>.rank<r>.pt``. Case kinds:

- ``forward``: the tensor-parallel cache forward (a prefill chunk and
  greedy decode steps through ``apply_with_cache(mesh=)``) and a
  tensor-parallel engine's burst admission and decode block; rank 0
  also runs the same on a meshless engine. ``swap_wq`` gives rank 1
  rank 0's ``wq`` shard (the control). A case with ``lora`` serves
  those adapters stacked (each prompt on its entry of ``adapters``, the
  cache forward's rows too), one with ``n_experts`` in its config an
  MoE model with its experts over ``model``;
- ``refusals``: what a tp 2 engine must refuse, each error's text;
- ``oplog``: ``run_script`` over ``DistributedEngine`` on rank 0 and
  ``run_follower`` on rank 1, each rank's ``state_digest`` after it;
- ``session``: preempt/resume and an ``import_session`` through the op
  stream, and ``export_session`` refused;
- ``oplog_lora``: :func:`adapter_script` over ``DistributedEngine`` on
  rank 0 and ``run_follower`` on rank 1, each rank's digest after it;
- ``recover``: :func:`recover_script`, a scheduler over
  ``DistributedEngine`` that recovers from a chip failure injected into
  the driver mid-decode; with ``control`` the driver recovers alone
  (``recover()`` kept off the op stream). Each rank's digest and slots.
- ``nemesis``: meshless engines on both ranks (no collective to hang
  on); rank 0 drives a request over the op stream, then a seeded
  nemesis partitions its ``opstream>follower:<addr>`` edge (with
  ``control``, it partitions no edge) and it drives on: the follower's
  connection count before and after, and the driver's tokens; rank 1
  follows until its stream ends, the ops it applied.

It imports the port and torch only, never JAX.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models.quant import Int4Tensor, QuantizedTensor
from instaslice_tpu_torch.parallel.collectives import (
    Axis,
    MeshAxes,
    shard_leaf,
)
from instaslice_tpu_torch.serving import ServingEngine
from instaslice_tpu_torch.serving.dcn_serve_smoke import (
    run_script,
    state_digest,
)
from instaslice_tpu_torch.serving.distributed import (
    DistributedEngine,
    run_follower,
)

ENGINE = dict(max_batch=4, max_len=64, prefill_len=8)


def decode_leaf(leaf):
    """A leaf as the test encoded it: ("t", tensor), ("q8", q, s) or
    ("q4", p, s, group, pack_axis)."""
    kind, *parts = leaf
    if kind == "q8":
        return QuantizedTensor(*parts)
    if kind == "q4":
        return Int4Tensor(*parts)
    return parts[0]


def unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = decode_leaf(leaf)
    return tree


def model_of(case) -> tlm.TpuLM:
    return tlm.TpuLM(tlm.ModelConfig(dtype=torch.float32, remat=False,
                                     **case["cfg"]))


def engine(case, mesh, **kw) -> ServingEngine:
    model = model_of(case)
    params = unflat(case["params"])
    if case.get("lora"):
        kw.update(lora_adapters=[unflat(a) for a in case["lora"]])
    if case.get("self_draft"):
        kw.update(draft_model=model, draft_params=params, spec_k=3)
    return ServingEngine(model, params, mesh=mesh, device="cpu",
                         kv_quant=case["kv_quant"], radix_cache=False,
                         **ENGINE, **kw)


def cache_forward(eng: ServingEngine, prompts, steps: int,
                  adapters=None) -> torch.Tensor:
    """(1 + steps, B, vocab) logits: one prefill chunk of ``prompts`` (B,
    P) from an empty cache, then ``steps`` greedy decode steps, through
    the engine's model, weights and mesh, over a cache in the model's
    dtype (an int8 cache's rounding steps are held at the engine); with
    the engine's adapters, row ``b`` through adapter ``adapters[b]``."""
    model, B = eng.model, len(prompts)
    kw = {}
    if eng.lora is not None:
        kw = dict(lora=eng.lora, adapter_idx=torch.tensor(adapters[:B]))
    cache = model.init_cache(B, ENGINE["max_len"], device="cpu",
                             mesh=eng.mesh)
    toks = torch.tensor(prompts, dtype=torch.int64)
    lens = torch.zeros(B, dtype=torch.int32)
    out = []
    with torch.no_grad():
        for _ in range(1 + steps):
            logits, cache = model.apply_with_cache(
                eng.params, toks, cache, lens, mesh=eng.mesh, **kw)
            out.append(logits[:, -1])
            lens = lens + toks.shape[1]
            toks = logits[:, -1].argmax(-1, keepdim=True)
    return torch.stack(out)


def serve(eng: ServingEngine, prompts, n_new: int, adapters=None) -> dict:
    """A burst admission of ``prompts`` (each on its adapter), then one
    decode block: each request's tokens and logprobs by request id."""
    from instaslice_tpu_torch.serving import AdmissionRequest

    adapters = adapters or [0] * len(prompts)
    rids = [r[0] for r in eng.add_requests(
        [AdmissionRequest(p, adapter=a) for p, a in zip(prompts, adapters)])]
    eng.decode_block(n_new)
    by_rid = {req.request_id: req for req in eng.slots.values()}
    return {"tokens": [by_rid[r].generated for r in rids],
            "logprobs": [by_rid[r].logprobs for r in rids]}


def run_forward(case, mesh, rank: int) -> dict:
    eng = engine(case, mesh)
    if case.get("swap_wq") and rank == 1:
        # the control: rank 1 holds rank 0's block of wq's columns
        whole = unflat(case["params"])["blocks"]["wq"]
        rank0 = MeshAxes(model=Axis(None, 2, 0))
        spec = (None, None, "model")
        if isinstance(whole, QuantizedTensor):
            eng.params["blocks"]["wq"] = QuantizedTensor(
                shard_leaf(whole.q, spec, rank0),
                shard_leaf(whole.s, spec, rank0))
        else:
            eng.params["blocks"]["wq"] = shard_leaf(whole, spec, rank0)
    ads = case.get("adapters")
    out = {"logits": cache_forward(eng, case["chunk"], case["steps"], ads),
           "route": eng.decode_route(),
           "cache_heads": eng.cache["k"].shape[2]}
    out.update(serve(eng, case["prompts"], case["n_new"], ads))
    out["rounds"] = (eng.fastpath_rounds, eng.gathered_rounds)
    if rank == 0:
        one = engine(case, None)
        out["meshless_logits"] = cache_forward(one, case["chunk"],
                                               case["steps"], ads)
        out["meshless"] = serve(one, case["prompts"], case["n_new"], ads)
    return out


def run_refusals(case, mesh, rank: int) -> dict:
    errs = {}

    def attempt(name, fn):
        try:
            fn()
            errs[name] = ""
        except Exception as e:  # noqa: BLE001 - the text is the result
            errs[name] = f"{type(e).__name__}: {e}"

    attempt("decode_graphs", lambda: engine(case, mesh, decode_graphs=True))
    D = case["cfg"]["d_model"]
    lora = {"blocks": {"wq": {"a": torch.zeros(2, D, 4),
                              "b": torch.zeros(2, 4, D)}}}
    attempt("lora", lambda: engine(case, mesh, lora_adapters=[lora]))
    moe = dict(case, cfg=dict(case["cfg"], n_experts=4))
    attempt("moe", lambda: ServingEngine(model_of(moe), mesh=mesh,
                                         device="cpu", **ENGINE))
    eng = engine(case, mesh)
    eng.add_request([5, 9, 2, 7])
    eng.decode_block(2)
    rid = eng.preempt_slot(0)
    attempt("export", lambda: eng.export_session(rid))
    return {"errors": errs, "route": eng.decode_route(),
            "multiproc": eng._multiproc}


def over_op_stream(case, mesh, rank: int, drive,
                   driver=DistributedEngine) -> dict:
    """``drive(deng)`` on rank 0 through a ``driver`` (a
    DistributedEngine); rank 1 follows. Each rank's digest and slots
    after, the driver's extra results too."""
    eng = engine(case, mesh)
    out = {}
    if rank == 0:
        deng = driver(eng, n_followers=1, port=case["port"])
        try:
            out.update(drive(deng) or {})
        finally:
            deng.shutdown()
    else:
        out["applied"] = run_follower(eng, "127.0.0.1", case["port"])
    out["digest"] = state_digest(eng)
    out["parked"] = sorted(eng.parked)
    out["slots"] = {s: r.request_id for s, r in sorted(eng.slots.items())}
    return out


def run_oplog(case, mesh, rank: int) -> dict:
    return over_op_stream(case, mesh, rank, run_script)


def session_script(eng, blob) -> str:
    """Preempt/resume, then an inbound session, driven through ``eng``
    (the test replays it on single-process engines); returns the text
    ``export_session`` raised between the preempt and the resume."""
    eng.add_request([5, 9, 2, 7, 1, 8, 3, 3, 6, 4])
    eng.decode_block(3)
    rid = eng.preempt_slot(0)
    try:
        eng.export_session(rid)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    eng.resume_request(rid)
    eng.decode_block(3)
    eng.resume_request(eng.import_session(blob))
    eng.decode_block(4)
    return refused


def run_session(case, mesh, rank: int) -> dict:
    return over_op_stream(
        case, mesh, rank,
        lambda deng: {"export": session_script(deng, case["blob"])})


def adapter_script(eng) -> None:
    """Admissions on adapters 1, 2 and the base, a burst, block decodes
    (gathered rounds, then the single-adapter path once only adapter 2's
    slot is live), a preempt/resume of an adapter request (the test
    replays it on the JAX mesh engine)."""
    from instaslice_tpu_torch.serving import AdmissionRequest

    eng.add_request([5, 9, 2, 7], adapter=1)
    eng.add_request([11, 3, 8], adapter=0)
    eng.decode_block(3)
    eng.add_requests([AdmissionRequest([4, 4, 6, 1, 9], adapter=2)])
    eng.decode_block(2)
    eng.finish_slot(0, n_keep=3)
    eng.finish_slot(1, n_keep=2)
    eng.decode_block(2)
    rid = eng.preempt_slot(2)
    eng.resume_request(rid)
    eng.decode_block(2)


def run_oplog_lora(case, mesh, rank: int) -> dict:
    return over_op_stream(case, mesh, rank, adapter_script)


class DriverRecoversAlone(DistributedEngine):
    """The control: ``recover()`` on the driver alone, as before the op
    stream carried it."""

    def recover(self):
        return self.engine.recover()


def recover_script(deng) -> dict:
    """Two requests served by a :class:`Scheduler` over ``deng``; a chip
    failure injected into the driver mid-decode (its cache poisoned at
    the start of a round once it has decoded, before that round's op is
    broadcast) makes the scheduler recover and fail both; then two
    admissions and a block decode through ``deng``. Returns the errors,
    the number of faults fired and the new requests' ids."""
    from instaslice_tpu_torch.faults import FaultError, poison_cache
    from instaslice_tpu_torch.serving.scheduler import Pending, Scheduler

    fired = []

    def hook():
        eng = deng.engine
        if eng.slots and eng.tokens_generated >= 4 and not fired:
            fired.append(eng.tokens_generated)
            poison_cache(eng)
            raise FaultError("injected chip failure mid-decode")

    sched = Scheduler(deng, block_size=2, fault_hook=hook, overlap=False)
    pend = [Pending(p, 16) for p in ([5, 9, 2, 7], [11, 3, 8])]
    sched.start()
    try:
        for p in pend:
            sched.submit(p)
        done = [p.done.wait(120) for p in pend]
    finally:
        sched.stop_flag.set()
        sched.join(60)
    if not all(done) or sched.is_alive():
        raise RuntimeError(f"scheduler stuck: done {done}")
    rids = [deng.add_request(p) for p in ([4, 4, 6, 1], [12, 40, 7])]
    deng.decode_block(2)
    return {"errors": [p.error for p in pend], "fired": fired,
            "new": rids}


def run_recover(case, mesh, rank: int) -> dict:
    return over_op_stream(
        case, mesh, rank, recover_script,
        DriverRecoversAlone if case.get("control") else DistributedEngine)


def nemesis_script(case):
    """The op-stream partition, driven on rank 0 (see ``nemesis``)."""
    from instaslice_tpu_torch.faults.netchaos import NemesisPlan, set_nemesis

    def drive(deng) -> dict:
        deng.add_request([3, 5, 7])
        deng.decode_block(2)
        before = len(deng._conns)
        plan = NemesisPlan(case["seed"])
        if not case.get("control"):
            plan.partition("opstream", f"follower:{deng._conns[0][1]}")
        set_nemesis(plan)
        try:
            deng.add_request([4, 6])
            after = len(deng._conns)
            deng.decode_block(3)
        finally:
            set_nemesis(None)
        return {"before": before, "after": after,
                "tokens": [list(s.generated)
                           for _, s in sorted(deng.slots.items())],
                "stats": plan.stats()}

    return drive


def run_nemesis(case, mesh, rank: int) -> dict:
    return over_op_stream(case, None, rank, nemesis_script(case))


RUN = {"forward": run_forward, "nemesis": run_nemesis, "refusals": run_refusals,
       "oplog": run_oplog, "session": run_session,
       "oplog_lora": run_oplog_lora, "recover": run_recover}


def main(rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(str(out / "store"), world))
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(1, 1, world),
                          mesh_dim_names=("data", "seq", "model"))
        for case in torch.load(out / "cases.pt", weights_only=True):
            res = RUN[case["kind"]](case, mesh, rank)
            torch.save(res, out / f"{case['name']}.rank{rank}.pt")
            dist.barrier()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
