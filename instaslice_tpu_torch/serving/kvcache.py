"""Paged KV-cache accounting: a block pool with per-request block tables.

A copy of ``BlockPoolExhausted``, ``Block``, ``BlockTable`` and
``KVBlockPool`` from ``instaslice_tpu/serving/kvcache.py`` (pure host-side
bookkeeping): the port imports nothing of the JAX package, whose serving
package pulls JAX in on import. The radix prefix index and the session
wire format are not ported yet.

The engine's physical cache stays the rectangular
``(L, max_batch, Hkv, max_len, hd)`` tensor; the pool is the accounting
truth admission and utilization reason over, mapping logical blocks onto
row extents.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class BlockPoolExhausted(RuntimeError):
    """No free block: the caller must shed parked state (or refuse the
    admission) — the scheduler's headroom guard exists to make this
    unreachable on the decode path."""


@dataclasses.dataclass
class Block:
    """One fixed-size token block. ``refs`` counts the tables holding
    it (>1 = copy-on-write shared); ``pinned`` marks registered-prefix
    blocks, which live outside the allocatable pool and never return
    to the free list while their prefix is registered."""

    block_id: int
    refs: int = 1
    pinned: bool = False


class BlockTable:
    """One request's ordered block list plus its token count. Sharing
    state lives on the blocks themselves (``Block.refs``/``pinned``) —
    refcounts are the single source of truth for every copy-on-write
    decision (:meth:`KVBlockPool.ensure`), so the table carries no
    shadow counter that could drift stale when a co-sharer releases."""

    def __init__(self, blocks: Optional[List[Block]] = None,
                 tokens: int = 0) -> None:
        self.blocks: List[Block] = blocks or []
        self.tokens = tokens

    def __len__(self) -> int:
        return len(self.blocks)


class KVBlockPool:
    """Fixed pool of ``total_blocks`` blocks of ``block_size`` tokens.

    Thread model: owned by the one scheduler thread that owns the
    engine (like every other piece of engine state) — no locks.
    """

    def __init__(self, total_blocks: int, block_size: int) -> None:
        if total_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need total_blocks >= 1 and block_size >= 1, got "
                f"{total_blocks}/{block_size}"
            )
        self.total_blocks = total_blocks
        self.block_size = block_size
        self._next_id = 0
        #: blocks currently allocated from the pool (pinned excluded)
        self._allocated = 0
        #: registered-prefix blocks (outside the allocatable pool)
        self._pinned = 0
        # copy-on-write events since construction (observability)
        self.cow_copies = 0

    # ------------------------------------------------------------ internals

    def blocks_for(self, tokens: int) -> int:
        """Blocks covering ``tokens`` — THE ceiling-division everyone
        (engine admission math, scheduler headroom, stripe rounding)
        must share so accounting cannot drift from the allocator."""
        return -(-tokens // self.block_size) if tokens > 0 else 0

    def _new_block(self, pinned: bool = False) -> Block:
        if not pinned:
            if self._allocated >= self.total_blocks:
                raise BlockPoolExhausted(
                    f"kv block pool exhausted "
                    f"({self.total_blocks} blocks of {self.block_size})"
                )
            self._allocated += 1
        else:
            self._pinned += 1
        b = Block(self._next_id, pinned=pinned)
        self._next_id += 1
        return b

    def _drop_ref(self, block: Block) -> None:
        block.refs -= 1
        if block.refs == 0:
            if block.pinned:
                self._pinned -= 1
            else:
                self._allocated -= 1

    # -------------------------------------------------------------- queries

    def free_blocks(self) -> int:
        return self.total_blocks - self._allocated

    def used_blocks(self) -> int:
        return self._allocated

    def pinned_blocks(self) -> int:
        return self._pinned

    def can_allocate(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= self.free_blocks()

    # ----------------------------------------------------------- allocation

    def allocate(self, tokens: int) -> BlockTable:
        """A fresh table covering ``tokens`` (all blocks exclusive)."""
        need = self.blocks_for(tokens)
        if need > self.free_blocks():
            raise BlockPoolExhausted(
                f"need {need} blocks, {self.free_blocks()} free"
            )
        return BlockTable(
            [self._new_block() for _ in range(need)], tokens
        )

    def pin_block(self, block: Block) -> None:
        """Move an ALLOCATED block outside the allocatable pool
        (registration adopting an organically-cached radix path: its
        blocks become eviction-exempt, so leaving them counted as
        allocatable would silently shrink the capacity admission
        reasons over). No-op on already-pinned blocks; refcounts are
        untouched — only which ledger the block sits in changes."""
        if block.pinned:
            return
        block.pinned = True
        self._allocated -= 1
        self._pinned += 1

    def pin(self, tokens: int) -> BlockTable:
        """A fully-pinned table: read-only blocks outside the
        allocatable pool (pinned stripes are separate HBM arrays, not
        slot rows — charging them against the slot pool would shrink
        serving capacity they never consumed). Registered radix
        prefixes grow pinned via ``ensure(pinned=True)`` instead,
        because their tables also SHARE pool blocks with organic
        ancestors; this whole-table form remains the primitive for
        standalone pinned stripes."""
        return BlockTable(
            [self._new_block(pinned=True)
             for _ in range(self.blocks_for(tokens))],
            tokens,
        )

    def fork(self, parent: BlockTable, tokens: Optional[int] = None) \
            -> BlockTable:
        """Share ``parent``'s blocks copy-on-write: the child references
        them (refcount++, zero pool cost) and copies lazily as it grows
        past — or writes into — the shared region. ``tokens`` trims the
        share to a prefix of the parent (a prefix hit shares only the
        matched tokens)."""
        t = parent.tokens if tokens is None else tokens
        n = self.blocks_for(t)
        shared = parent.blocks[:n]
        for b in shared:
            b.refs += 1
        return BlockTable(list(shared), t)

    def ensure(self, table: BlockTable, tokens: int,
               pinned: bool = False) -> None:
        """Grow ``table`` to cover ``tokens``, copy-on-writing the
        boundary block when the growth writes into a block someone
        else still references.

        Only the boundary block ever needs copying: growth writes at
        positions >= ``table.tokens``, and every earlier block holds
        final tokens no one writes again. The check is refcount-driven
        (refs > 1, or a pinned read-only prefix block), so it covers
        both sides of a fork — the child growing past its share AND the
        parent growing while children still reference its boundary.
        Raises :class:`BlockPoolExhausted` with the table unchanged
        when the pool cannot cover the growth.

        ``pinned=True`` grows with PINNED blocks outside the
        allocatable pool (registered radix prefixes — registration
        must never shrink the capacity admission reasons over); the
        free-blocks check is skipped because nothing is drawn from the
        pool."""
        if tokens <= table.tokens:
            return
        if not pinned:
            cost = self.growth_cost(table, tokens)
            if cost > self.free_blocks():
                raise BlockPoolExhausted(
                    f"need {cost} block(s), {self.free_blocks()} free"
                )
        boundary_idx = self._cow_boundary(table)
        if boundary_idx >= 0:
            old = table.blocks[boundary_idx]
            table.blocks[boundary_idx] = self._new_block(pinned=pinned)
            self._drop_ref(old)
            self.cow_copies += 1
        for _ in range(
            max(0, self.blocks_for(tokens) - len(table.blocks))
        ):
            table.blocks.append(self._new_block(pinned=pinned))
        table.tokens = tokens

    def _cow_boundary(self, table: BlockTable) -> int:
        """Index of the boundary block a growth past ``table.tokens``
        must copy (shared or pinned, partially filled), or -1."""
        if table.tokens % self.block_size and table.blocks:
            idx = self.blocks_for(table.tokens) - 1
            b = table.blocks[idx]
            if b.refs > 1 or b.pinned:
                return idx
        return -1

    def growth_cost(self, table: BlockTable, tokens: int) -> int:
        """Blocks :meth:`ensure` will pull from the pool to grow
        ``table`` to ``tokens`` — new blocks plus the boundary
        copy-on-write when the boundary is genuinely shared. THE cost
        model, shared with the scheduler's pre-decode headroom guard
        so the guard can never under-count what ensure() charges."""
        if tokens <= table.tokens:
            return 0
        grow = max(0, self.blocks_for(tokens) - len(table.blocks))
        return grow + (1 if self._cow_boundary(table) >= 0 else 0)

    def bump(self, table: BlockTable, tokens: int) -> bool:
        """Token-count-only growth: True when covering ``tokens`` needs
        NO allocator work — no new block and no shared boundary to
        copy — in which case the table is updated in place for free.
        THE incremental fast path of the engine's per-round
        ``_sync_tables``: most decode rounds grow a slot within its
        current tail block, and charging a full :meth:`ensure` walk
        (exhaustion check, boundary scan, append loop) per slot per
        round is exactly the post-readback host time the overlap seam
        wants thin. Callers fall back to :meth:`ensure` on False."""
        if tokens <= table.tokens:
            return True
        if self.growth_cost(table, tokens) != 0:
            return False
        table.tokens = tokens
        return True

    def release(self, table: BlockTable) -> None:
        """Return every block reference; shared blocks survive while
        another table (or the pinned prefix) still holds them."""
        for b in table.blocks:
            self._drop_ref(b)
        table.blocks = []
        table.tokens = 0

    # -------------------------------------------------------- observability

    def stats(self, tables: Optional[Dict[int, BlockTable]] = None) \
            -> dict:
        """Pool gauges: ``free``/``used`` from the allocator, ``cow`` =
        blocks currently shared by more than one holder (the dedup the
        copy-on-write machinery is preserving right now).

        One relaxation of the no-locks thread model: this read path is
        also served to HTTP stats threads, so every container is
        list()-snapshotted before iteration — the counts are a
        point-in-time approximation under concurrent mutation, never a
        'changed size during iteration' crash."""
        cow = 0
        if tables:
            seen = set()
            for t in list(tables.values()):
                for b in list(t.blocks):
                    if b.refs > 1 and b.block_id not in seen:
                        seen.add(b.block_id)
                        cow += 1
        return {
            "total": self.total_blocks,
            "free": self.free_blocks(),
            "used": self.used_blocks(),
            "pinned": self._pinned,
            "cow": cow,
            "cow_copies": self.cow_copies,
            "block_size": self.block_size,
        }

    def utilization(self, live_tokens: int) -> float:
        """True block occupancy: tokens resident / capacity of the
        blocks holding them — allocated AND pinned, because resident
        tokens include prefix-covered positions whose storage is the
        pinned blocks (counting those tokens against allocated-only
        capacity would saturate the gauge at 1.0 for any prefix-hit
        traffic). High under mixed sequence lengths, where the legacy
        stripe metric divides by the whole ``max_batch x max_len``
        rectangle."""
        cap = (self.used_blocks() + self._pinned) * self.block_size
        if cap <= 0:
            return 0.0
        return min(1.0, live_tokens / cap)
