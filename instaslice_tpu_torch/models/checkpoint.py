"""Checkpoint / resume for the training loop (port of
``instaslice_tpu/models/checkpoint.py``).

The reference's interface (``save``, ``latest_step``, ``restore``,
``close``, a context manager, ``max_to_keep``, ``save_interval_steps``)
over ``torch.save`` of ``{step, params, optimizer state}``, one file per
step, written to a temporary name and renamed into place (a crash mid-save
leaves the previous checkpoint as the latest). The format is the port's
own; orbax checkpoints are not read. Restoring into a freshly
initialized :class:`~instaslice_tpu_torch.models.train.TrainState`
reproduces the uninterrupted run bit for bit: batches are a pure function
of the step (:mod:`instaslice_tpu_torch.models.data`), so the step is the
loader state.

Checkpoints do not depend on the mesh. Under one (a state whose
``layout`` is set) every rank calls :meth:`TrainCheckpointer.save`: the
``model`` shards and the ZeRO-1 moment slices are gathered into whole
leaves, and rank 0 writes them in the one-process format; on restore
every rank reads the whole leaves and keeps its block. A checkpoint
written at one mesh shape restores at any other, or on one card.

Each leaf is saved with its path in the tree (``"paths"``, e.g.
``"blocks/wq/a"``), so a tree can be rebuilt from the file alone
(:meth:`TrainCheckpointer.load_tree`: the server reads a LoRA adapter's
targets and rank that way). Restoring INTO a state goes by leaf order,
as before, and checks the paths where the file has them: checkpoints
written before paths were saved still restore.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from instaslice_tpu_torch.models.train import (
    Layout,
    Params,
    TrainState,
    full_params,
    leaf_paths,
    leaves,
)

_NAME = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointer:
    """Keeps the newest ``max_to_keep`` checkpoints of a run in
    ``directory``; saves only steps that are multiples of
    ``save_interval_steps`` and newer than the latest."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> None:
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(save_interval_steps, 1)

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:09d}.pt"

    def save(self, state: TrainState, step: Optional[int] = None) -> bool:
        """Persist ``state``; False when skipped (by the interval, or
        because a checkpoint at or past ``step`` exists). ``step``
        defaults to the state's own counter. Under a mesh every rank
        calls it (the gathers are collective), rank 0 writes, and all
        ranks wait for the write, so that each takes the next decision
        from the same directory."""
        step = state.step if step is None else int(step)
        latest = self.latest_step()
        if (latest is not None and latest >= step) or \
                step % self.save_interval_steps:
            return False
        params = full_params(state)
        payload = {
            "step": state.step,
            "params": [p.detach() for p in leaves(params)],
            "paths": leaf_paths(params),
            "opt": state.opt_state.state_dict(),
        }
        if state.layout is None or (state.layout.axes.model.rank == 0
                                    and state.layout.axes.data.rank == 0):
            dst = self._path(step)
            tmp = dst.with_suffix(f".{os.getpid()}.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, dst)
            if self.max_to_keep:
                for old in self._steps()[:-self.max_to_keep]:
                    self._path(old).unlink(missing_ok=True)
        if state.layout is not None:
            # over each axis in turn: every rank of the mesh then waits
            # for rank 0's write (a mesh may hold part of the world)
            for ax in (state.layout.axes.model, state.layout.axes.data):
                if ax.size > 1:
                    dist.barrier(group=ax.group)
        return True

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]) -> Optional[dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore_params(self, params: Params, step: Optional[int] = None,
                       cast: bool = False,
                       layout: Optional[Layout] = None) -> Optional[dict]:
        """Copy the params of checkpoint ``step`` (default: the latest)
        INTO ``params`` by leaf order (paths checked where the file has
        them); with ``cast`` each tensor takes the destination's dtype,
        else dtypes must agree. With a mesh ``layout`` ``params`` are this
        rank's shards, and each takes its block of the saved leaf.
        Returns the loaded payload (its optimizer state unused here),
        None when the directory holds no checkpoint."""
        payload = self._load(step)
        if payload is None:
            return None
        dst = leaves(params)
        if len(dst) != len(payload["params"]):
            raise ValueError(f"checkpoint has {len(payload['params'])} "
                             f"tensors, the state {len(dst)}")
        paths = payload.get("paths")
        if paths is not None and paths != leaf_paths(params):
            raise ValueError(f"checkpoint leaves {paths} do not match the "
                             f"state's {leaf_paths(params)}")
        with torch.no_grad():
            for i, (p, saved) in enumerate(zip(dst, payload["params"])):
                if layout is not None:
                    saved = layout.shard(i, saved)
                if p.shape != saved.shape or (
                        p.dtype != saved.dtype and not cast):
                    raise ValueError(
                        f"checkpoint tensor {tuple(saved.shape)} "
                        f"{saved.dtype} does not fit {tuple(p.shape)} "
                        f"{p.dtype}")
                p.copy_(saved.to(p.dtype))
        return payload

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load checkpoint ``step`` (default: the latest) INTO ``state``
        (a fresh ``init_fn()`` result of the same model and optimizer
        settings: its leaves keep their device and ``requires_grad``);
        None when the directory holds no checkpoint."""
        payload = self.restore_params(state.params, step,
                                      layout=state.layout)
        if payload is None:
            return None
        state.opt_state.load_state_dict(payload["opt"])
        state.step = int(payload["step"])
        return state

    def load_tree(self, step: Optional[int] = None) -> Optional[Params]:
        """The params tree of checkpoint ``step`` (default: the latest),
        rebuilt from its leaf paths, on the CPU; None when the directory
        holds no checkpoint. Raises ``ValueError`` for a checkpoint
        written without paths (its structure is not in the file)."""
        payload = self._load(step)
        if payload is None:
            return None
        paths = payload.get("paths")
        if paths is None:
            raise ValueError(
                f"checkpoint in {self.directory} has no leaf paths (written "
                "before they were saved): its tree cannot be rebuilt from "
                "the file")
        tree: Params = {}
        for path, t in zip(paths, payload["params"]):
            *parents, name = path.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[name] = t
        return tree

    def close(self) -> None:
        """Nothing is held open between saves; kept for the reference's
        interface."""

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
