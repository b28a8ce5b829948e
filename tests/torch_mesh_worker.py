"""One rank of the gloo worlds that the tests of the port's expert
parallelism, LoRA under a mesh, ring attention and GPipe spawn on the
CPU: ``python tests/torch_mesh_worker.py RANK WORLD DIR``.

It reads ``DIR/cases.pt`` (written by the test: each case's kind, mesh,
config, whole weights and inputs), joins the world through a file store
in ``DIR`` and runs every case in order over its mesh (``names``,
``shape``: the first ``prod(shape)`` ranks; the others sit it out); each
rank of the mesh writes what the test compares to
``DIR/<name>.rank<r>.pt``. Case kinds:

- ``train``: ``make_train_step(mesh=...)`` over the case's batches
  (``opts`` may hold ``n_micro`` for GPipe); the losses, the gathered
  params and the first step's gradient (averaged, before the clip);
- ``lora``: ``make_lora_train_step(mesh=...)`` over a whole base (int8
  leaves for QLoRA) and a given adapter tree; the losses and the
  gathered adapters;
- ``ring``: :func:`ring_attention` on the rank's blocks of q/k/v and the
  gradient of ``sum(out * dy)``; the rank's blocks of each;
- ``pipe``: ``TpuLM.apply_pipelined`` and the gradient of ``sum(out **
  2) / 1e4``; the output and the gathered gradients.

``control`` breaks one thing the case must be sensitive to: ``ring_pos0``
starts every rank's RoPE positions at 0, ``naive_router`` drops the
expert gates' ``copy_to`` and all-reduces the router's gradient over
``model`` instead, ``reversed_stages`` hands stage ``s`` the layers of
stage ``P - 1 - s``, ``swap_b`` gives each model rank the other's block
of the adapters' sharded ``b``. It imports the port and torch only,
never JAX.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import lora as tlora
from instaslice_tpu_torch.models.train import (
    Layout,
    full_params,
    leaf_paths,
    leaves,
    make_train_step,
    map_tree,
)
from instaslice_tpu_torch.parallel import collectives as coll
from instaslice_tpu_torch.parallel.collectives import mesh_axes
from torch_serve_tp_worker import unflat


def flat(tree: dict) -> dict:
    return {p: t.detach().clone()
            for p, t in zip(leaf_paths(tree), leaves(tree))}


def model_of(case) -> tlm.TpuLM:
    return tlm.TpuLM(tlm.ModelConfig(dtype=torch.float32, **case["cfg"]))


def _other_block(state, path: str, ax_name: str, rank_of) -> None:
    """Leaf ``path`` of ``state`` replaced by the block that axis
    ``ax_name``'s rank ``rank_of(r)`` holds."""
    lay = state.layout
    i = lay.paths.index(path)
    leaf = state.params
    for k in path.split("/"):
        leaf = leaf[k]
    whole = lay.gather(i, leaf)
    ax = lay.axes.of(ax_name)
    other = dataclasses.replace(lay.axes, **{
        ax_name: dataclasses.replace(ax, rank=rank_of(ax.rank, ax.size))})
    with torch.no_grad():
        leaf.copy_(coll.shard_leaf(whole, lay.specs[i], other))


def run_train(case, mesh, rank):
    model = model_of(case)
    init_fn, step_fn = make_train_step(model, device="cpu", mesh=mesh,
                                       **case["opts"])
    state = init_fn(params=unflat(case["params"]))
    axes = mesh_axes(mesh)
    if case.get("control") == "reversed_stages":
        for path in state.layout.paths:
            if path.startswith("blocks/"):
                _other_block(state, path, "pipe", lambda r, n: n - 1 - r)
    if case.get("control") == "naive_router":
        state.params["blocks"]["router"].register_hook(
            lambda g: coll.all_reduce_(g.clone(), axes.model))
    grads0, losses = None, []
    step = state.opt_state.step

    def recording_step():
        nonlocal grads0
        if grads0 is None:
            # before the clip scales the grads in place
            grads0 = {p: state.layout.gather(i, t.grad).clone()
                      for i, (p, t) in enumerate(zip(
                          leaf_paths(state.params), leaves(state.params)))}
        step()

    state.opt_state.step = recording_step
    for toks in case["batches"]:
        state, loss = step_fn(state, toks)
        losses.append(float(loss))
    return {"losses": losses, "params": flat(full_params(state)),
            "grads0": grads0}


def run_lora(case, mesh, rank):
    model = model_of(case)
    lcfg = tlora.LoraConfig(**case["lcfg"])
    init_fn, step_fn = tlora.make_lora_train_step(
        model, unflat(case["base"]), lcfg, device="cpu", mesh=mesh,
        **case["opts"])
    state = init_fn(lora=unflat(case["lora"]))
    if case.get("control") == "swap_b":
        for path in state.layout.paths:
            if path.endswith("/b") and "model" in state.layout.split_over(
                    state.layout.paths.index(path)):
                _other_block(state, path, "model", lambda r, n: n - 1 - r)
    losses = []
    for toks in case["batches"]:
        state, loss = step_fn(state, toks)
        losses.append(float(loss))
    return {"losses": losses, "params": flat(full_params(state))}


def run_ring(case, mesh, rank):
    from instaslice_tpu_torch.parallel.ring import ring_attention

    ax = mesh_axes(mesh).seq
    q, k, v, dy = (coll.shard(case[n], ax, 1).clone().requires_grad_(
        n != "dy") for n in ("q", "k", "v", "dy"))
    out = ring_attention(q, k, v, ax)
    dq, dk, dv = torch.autograd.grad((out * dy).sum(), (q, k, v))
    return {"out": out.detach(), "dq": dq, "dk": dk, "dv": dv}


def run_pipe(case, mesh, rank):
    model = model_of(case)
    axes = mesh_axes(mesh)
    whole = unflat(case["params"])
    lay = Layout(model.cfg, axes, whole, pipe_axis="pipe")
    params = map_tree(lambda p, t: lay.shard(lay.paths.index(p), t), whole)
    for p in leaves(params):
        p.requires_grad_(True)
    out = model.apply_pipelined(params, case["tokens"], mesh=mesh,
                                n_micro=case["n_micro"])
    ps = leaves(params)
    grads = torch.autograd.grad((out ** 2).sum() / 1e4, ps)
    return {"out": out.detach(),
            "grads": {p: lay.gather(i, g) for i, (p, g) in enumerate(zip(
                leaf_paths(params), grads))}}


RUN = {"train": run_train, "lora": run_lora, "ring": run_ring,
       "pipe": run_pipe}


def main(rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(str(out / "store"), world))
    try:
        for case in torch.load(out / "cases.pt", weights_only=True):
            n = math.prod(case["shape"])
            mesh = DeviceMesh("cpu", torch.arange(n).reshape(case["shape"]),
                              mesh_dim_names=tuple(case["names"]))
            if rank < n:
                saved = tlm._rope_tables, tlm._expert_gates
                if case.get("control") == "ring_pos0":
                    tlm._rope_tables = (lambda pos, hd: saved[0](
                        pos - pos.reshape(-1)[0], hd))
                if case.get("control") == "naive_router":
                    tlm._expert_gates = lambda gates, tp: gates
                try:
                    res = RUN[case["kind"]](case, mesh, rank)
                finally:
                    tlm._rope_tables, tlm._expert_gates = saved
                torch.save(res, out / f"{case['name']}.rank{rank}.pt")
            dist.barrier()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
