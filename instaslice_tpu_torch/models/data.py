"""Training data: memory-mapped token datasets and the one-card loader
(port of ``instaslice_tpu/models/data.py``).

:func:`write_token_file`, :class:`TokenDataset` and :class:`Prefetcher`
are copies of the reference's (numpy and threads, no JAX): a flat token
file viewed as ``seq_len + 1``-token rows, shuffled per epoch by a seeded
permutation, so batch ``i`` is a pure function of the step and a resumed
run needs no loader state. :func:`batch_for_step` is a step's whole batch
on the device; :class:`HostShardedTokens` (``data.py:132-180``) is one
rank's share of it under a ``data`` mesh axis, the rows
:func:`data_rows` gives that rank, read from the dataset alone.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["TokenDataset", "HostShardedTokens", "Prefetcher",
           "batch_for_step", "data_rows", "write_token_file"]


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a flat token array as a raw little-endian file the dataset
    mmaps back (suffix picks the width: .u16 / .u32; .npy also works
    via ``np.save``)."""
    tokens = np.asarray(tokens)
    if path.endswith(".npy"):
        np.save(path, tokens)
    elif path.endswith(".u16"):
        tokens.astype("<u2").tofile(path)
    elif path.endswith(".u32"):
        tokens.astype("<u4").tofile(path)
    else:
        raise ValueError(f"unknown token-file suffix: {path}")


class TokenDataset:
    """A flat on-disk token stream, viewed as fixed-length sequences.

    ``seq_len + 1`` tokens per row (inputs + the shifted target the
    loss derives itself), non-overlapping, tail dropped. Deterministic
    shuffling: epoch ``e`` uses ``default_rng(seed + e).permutation``,
    so any (step, batch_size) maps to exact rows with no state.
    """

    def __init__(self, path: str, seq_len: int, seed: int = 0):
        if path.endswith(".npy"):
            self._tokens = np.load(path, mmap_mode="r")
        elif path.endswith(".u16"):
            self._tokens = np.memmap(path, dtype="<u2", mode="r")
        elif path.endswith(".u32"):
            self._tokens = np.memmap(path, dtype="<u4", mode="r")
        else:
            raise ValueError(
                f"unknown token-file suffix: {path} (.npy/.u16/.u32)"
            )
        if self._tokens.ndim != 1:
            raise ValueError(
                f"token file must be a flat stream, got shape "
                f"{self._tokens.shape}"
            )
        self.seq_len = seq_len
        self.row = seq_len + 1
        self.n_rows = len(self._tokens) // self.row
        if self.n_rows == 0:
            raise ValueError(
                f"{path}: {len(self._tokens)} tokens < one "
                f"{self.row}-token row"
            )
        self.seed = seed
        self._perm_epoch: Optional[int] = None
        self._perm: Optional[np.ndarray] = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if self._perm_epoch != epoch:
            self._perm = np.random.default_rng(
                self.seed + epoch
            ).permutation(self.n_rows)
            self._perm_epoch = epoch
        return self._perm

    def row_at(self, index: int) -> np.ndarray:
        """Row ``index`` of the infinite shuffled stream (epoch wraps)."""
        epoch, i = divmod(index, self.n_rows)
        r = int(self._epoch_perm(epoch)[i])
        out = self._tokens[r * self.row:(r + 1) * self.row]
        return np.asarray(out, dtype=np.int32)

    def batch(self, step: int, batch_size: int, offset: int = 0,
              global_batch: Optional[int] = None) -> np.ndarray:
        """(batch_size, seq_len + 1) int32 for global step ``step``.

        ``offset``/``global_batch`` carve this host's data-parallel
        share out of the global batch: the global stream consumes
        ``global_batch`` rows per step, and this call returns rows
        ``[offset, offset + batch_size)`` of step's slice — pure
        indexing, so every host agrees on the global stream without
        coordination."""
        gb = global_batch if global_batch is not None else batch_size
        if offset + batch_size > gb:
            raise ValueError(
                f"offset {offset} + batch {batch_size} exceeds "
                f"global batch {gb}"
            )
        base = step * gb + offset
        return np.stack([
            self.row_at(base + i) for i in range(batch_size)
        ])


def batch_for_step(dataset: TokenDataset, step: int, global_batch: int,
                   device) -> torch.Tensor:
    """The step's ``(global_batch, seq_len + 1)`` int32 batch (the
    dataset's rows for that step, a pure function of it) on ``device``."""
    return torch.from_numpy(dataset.batch(step, global_batch)).to(device)


def data_rows(global_batch: int, dp: int, rank: int,
              grad_accum: int = 1) -> List[int]:
    """The rows of a step's global batch that rank ``rank`` of a ``data``
    axis of ``dp`` ranks owns, in the order its micro-batches take them.

    At ``grad_accum`` 1 rank ``p`` owns the contiguous block ``[p *
    global_batch / dp, (p + 1) * global_batch / dp)``, the reference's
    ``local_batch``. With ``grad_accum`` micro-batches the step splits the
    global batch into ``grad_accum`` contiguous micro-batches first (the
    reference's ``tokens.reshape(grad_accum, B / grad_accum, -1)``) and each
    rank owns its block of every one, so that micro-batch ``j`` of rank
    ``p`` is its share of the reference's micro-batch ``j``."""
    if global_batch % (dp * grad_accum):
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{dp} data ranks x {grad_accum} micro-batches")
    micro, per = global_batch // grad_accum, global_batch // (dp * grad_accum)
    return [j * micro + rank * per + i for j in range(grad_accum)
            for i in range(per)]


class HostShardedTokens:
    """One data rank's share of a globally consistent batch stream: the
    rows :func:`data_rows` gives it, read from the dataset, so the union
    over ranks is the one-process batch and no rank reads another's
    rows."""

    def __init__(self, dataset: TokenDataset, global_batch: int, dp: int,
                 rank: int, grad_accum: int = 1):
        self.dataset = dataset
        self.global_batch = global_batch
        self.rows = data_rows(global_batch, dp, rank, grad_accum)
        self.per_host = len(self.rows)
        # contiguous runs of rows: one dataset read each
        self._runs: List[Tuple[int, int]] = []
        for r in self.rows:
            if self._runs and self._runs[-1][0] + self._runs[-1][1] == r:
                self._runs[-1] = (self._runs[-1][0], self._runs[-1][1] + 1)
            else:
                self._runs.append((r, 1))

    def local_batch(self, step: int) -> np.ndarray:
        """(per_host, seq_len + 1) int32: this rank's rows of ``step``."""
        return np.concatenate([
            self.dataset.batch(step, n, offset=start,
                               global_batch=self.global_batch)
            for start, n in self._runs])

    def batch_for_step(self, step: int, device) -> torch.Tensor:
        """:meth:`local_batch` on ``device``."""
        return torch.from_numpy(self.local_batch(step)).to(device)


class Prefetcher:
    """Double-buffered background loader: while the accelerator runs
    step N, the next host batch is being assembled (and its cold pages
    faulted in) on a thread. ``depth=2`` is enough — batch assembly is
    a memmap slice, the thread exists to hide page faults, not work."""

    def __init__(self, fetch, start_step: int, depth: int = 2):
        self._fetch = fetch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None

        def run():
            step = start_step
            while not self._stop.is_set():
                try:
                    item = (step, fetch(step))
                except BaseException as e:  # slicelint: disable=broad-except
                    # not swallowed: stored, re-raised on next()
                    self._exc = e
                    self._q.put(None)
                    return
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(
            target=run, name="tpuslice-prefetch", daemon=True
        )
        self._thread.start()

    def __iter__(self) -> Iterator[Tuple[int, object]]:
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise self._exc  # type: ignore[misc]
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
