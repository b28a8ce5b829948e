"""One rank of the gloo world that ``tests/test_torch_parallel_train.py``
spawns on the CPU: ``python tests/torch_parallel_worker.py RANK WORLD
DIR``.

It reads ``DIR/cases.pt`` (the cases, their weights and batches, written
by the test), joins the world through a file store in ``DIR``, and runs
every case in order: all ranks build each case's mesh over the first
``dp * tp`` ranks (the others sit that case out), run the port's
``make_train_step`` on it, and the mesh's rank 0 writes what the test
compares to ``DIR/<name>.pt``. It imports the port and torch only, never
JAX.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
from instaslice_tpu_torch.models.train import (
    full_params,
    leaf_paths,
    leaves,
    make_train_step,
)


def unflat(flat: dict) -> dict:
    """{"blocks/wq": t, ...} -> the nested tree."""
    tree: dict = {}
    for path, t in flat.items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = t.clone()
    return tree


def flat(tree: dict) -> dict:
    return {p: t.detach().clone()
            for p, t in zip(leaf_paths(tree), leaves(tree))}


def run(case: dict, mesh, rank: int, out: Path) -> None:
    cfg = tlm.ModelConfig(dtype=torch.float32, **case["cfg"])
    model = tlm.TpuLM(cfg)
    init_fn, step_fn = make_train_step(model, device="cpu", mesh=mesh,
                                       **case["opts"])
    state = init_fn(params=unflat(case["params"]))
    ck = case.get("ckpt")
    if ck and ck["mode"] == "restore":
        TrainCheckpointer(ck["dir"]).restore(state)
    grads0, norms, losses = None, [], []
    step = state.opt_state.step

    def recording_step():
        nonlocal grads0
        if grads0 is None:
            # the data-averaged gradient, before the clip
            grads0 = {p: t.grad.detach().clone() for p, t in
                      zip(leaf_paths(state.params), leaves(state.params))}
        step()
        if state.opt_state.grad_norm is not None:
            norms.append(float(state.opt_state.grad_norm))

    state.opt_state.step = recording_step
    for toks in case["batches"][state.step:]:
        state, loss = step_fn(state, toks)
        losses.append(float(loss))
        if ck and ck["mode"] == "save" and state.step == ck["at"]:
            TrainCheckpointer(ck["dir"]).save(state)
    params = flat(full_params(state))
    moments = []
    lay = state.layout
    for i, st in state.opt_state.adamw.state_dict()["state"].items():
        moments.append((lay.zero_dims[i], leaves(state.params)[i].numel(),
                        st["exp_avg"].numel(), st["exp_avg_sq"].numel()))
    if mesh.get_rank() == 0 or case["dp"] * case["tp"] == 1:
        torch.save({"losses": losses, "params": params, "norms": norms,
                    "grads0": grads0, "moments": moments},
                   out / f"{case['name']}.pt")


def run_meshless(case: dict, out: Path) -> None:
    cfg = tlm.ModelConfig(dtype=torch.float32, **case["cfg"])
    opts = {k: v for k, v in case["opts"].items() if k != "zero1"}
    init_fn, step_fn = make_train_step(tlm.TpuLM(cfg), device="cpu",
                                       **opts)
    state = init_fn(params=unflat(case["params"]))
    losses = []
    for toks in case["batches"]:
        state, loss = step_fn(state, toks)
        losses.append(float(loss))
    torch.save({"losses": losses, "params": flat(state.params),
                "norm": float(state.opt_state.grad_norm)},
               out / f"{case['name']}.meshless.pt")


def main(rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(str(out / "store"), world))
    try:
        for case in torch.load(out / "cases.pt", weights_only=True):
            dp, tp = case["dp"], case["tp"]
            mesh = DeviceMesh("cpu", torch.arange(dp * tp).reshape(dp, 1, tp),
                              mesh_dim_names=("data", "seq", "model"))
            if case.get("meshless") and rank == 0:
                run_meshless(case, out)
            if rank < dp * tp:
                saved = tlm.mean_over
                if case.get("per_rank_aux"):
                    # the control: each rank's load-balance term alone
                    tlm.mean_over = lambda x, ax: x
                try:
                    run(case, mesh, rank, out)
                finally:
                    tlm.mean_over = saved
            dist.barrier()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
