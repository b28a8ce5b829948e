"""Paged KV-cache accounting: a block pool with per-request block tables.

A copy of ``BlockPoolExhausted``, ``Block``, ``BlockTable``,
``KVBlockPool``, ``radix_granule``, ``RadixNode``, ``RadixMatch``,
``RadixIndex``, ``granule_hash`` and the session wire format
(``SESSION_WIRE_VERSION``, ``array_to_wire``, ``wire_to_array``,
``tree_to_wire``, ``wire_to_tree``) from
``instaslice_tpu/serving/kvcache.py`` (pure host-side bookkeeping): the
port imports nothing of the JAX package, whose serving package pulls JAX
in on import. A radix node's stripes are opaque here; the port's engine
hangs torch tensors on them.

The engine's physical cache stays the rectangular
``(L, max_batch, Hkv, max_len, hd)`` tensor; the pool is the accounting
truth admission and utilization reason over, mapping logical blocks onto
row extents.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


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


# --------------------------------------------------------------- radix tree


def radix_granule(prefill_len: int, block_size: int) -> int:
    """THE radix-cache sharing granularity: node boundaries land on
    prefill-chunk boundaries so the remainder prefill after a hit
    reuses the one compiled program — i.e. the granule IS the prefill
    chunk. Block alignment is NOT required: node tables are full-
    prefix forks of their parent (position-exact by construction), so
    a granule smaller than a block just means the boundary block
    copy-on-writes like any other partial share. ``block_size`` is
    accepted for signature stability (earlier designs lcm'd it in)."""
    del block_size
    return prefill_len


class RadixNode:
    """One radix-tree node: an edge of whole granules, a FULL-PREFIX
    block table covering [0, end) built by forking the parent's table
    (shared blocks refcounted once — the "store any common prefix
    once" half of the tentpole), and the per-granule KV stripes the
    engine attaches (host-opaque here; device arrays in practice).

    ``owned`` is the deepest-creator attribution: the blocks THIS
    node's creation pulled (beyond its fork share of the parent, plus
    its boundary copy-on-write) — exactly what evicting it returns,
    because a request table referencing them always locks the path
    first. ``locks`` counts live/parked request tables whose prefix
    match runs through (or ends in) this node — a locked node is never
    evicted, so a parked request's table pins its tree path.
    ``registered`` marks operator-registered prefixes
    (:meth:`ServingEngine.register_prefix`): eviction-exempt until
    dropped. ``last_used`` is a LOGICAL clock tick (never wall time —
    op-stream followers must converge on identical eviction order)."""

    __slots__ = ("granules", "start", "table", "parent", "children",
                 "stripes", "draft_stripes", "locks", "registered",
                 "last_used", "owned")

    def __init__(self, granules: List[tuple], start: int,
                 table: BlockTable,
                 parent: Optional["RadixNode"]) -> None:
        self.granules = list(granules)
        self.start = start
        self.table = table
        self.parent = parent
        self.children: Dict[tuple, "RadixNode"] = {}
        #: engine-attached per-granule KV stripes, 1:1 with granules
        self.stripes: list = []
        self.draft_stripes: Optional[list] = None
        self.locks = 0
        self.registered = False
        self.last_used = 0
        #: blocks this node introduced (see class docstring)
        self.owned: List[Block] = []

    @property
    def end(self) -> int:
        return self.table.tokens

    def pool_block_count(self) -> int:
        """Pool (non-pinned) blocks attributed to this node — what
        evicting it returns to the allocator."""
        return sum(1 for b in self.owned if not b.pinned)


@dataclasses.dataclass
class RadixMatch:
    """A prefix match: the root-to-deepest chain of nodes whose
    granules the prompt walked, and the matched token count (granule-
    aligned; may end inside the deepest node's edge)."""

    path: List[RadixNode]
    length: int


class RadixIndex:
    """Radix/trie index over token sequences, granule-keyed, whose
    nodes own refcounted segment block tables in a :class:`KVBlockPool`
    — the global prefix cache's accounting + structure half (the engine
    owns the device stripes it hangs on the nodes).

    Same thread model as the pool: owned by the one scheduler thread
    that owns the engine. :meth:`match` and the gauge reads are PURE
    (no LRU touch, no clock tick) so the scheduler may call them while
    planning without diverging op-stream followers; every mutation
    (touch/lock/insert/evict) happens only inside engine ops that
    replay identically on every replica."""

    def __init__(self, pool: KVBlockPool, granule: int) -> None:
        if granule < 1:
            raise ValueError(f"granule must be >= 1, got {granule}")
        self.pool = pool
        self.granule = granule
        self.root = RadixNode([], 0, BlockTable(), None)
        #: logical LRU clock (ticks on touch/insert, never wall time)
        self.clock = 0
        #: nodes evicted since construction (observability)
        self.evictions = 0

    # -------------------------------------------------------------- queries

    def granules_of(self, tokens: List[int], limit: int) -> List[tuple]:
        """``tokens[:limit]`` cut into whole granules (limit floored)."""
        g = self.granule
        n = (min(limit, len(tokens)) // g) * g
        return [tuple(tokens[i:i + g]) for i in range(0, n, g)]

    def match(self, tokens: List[int], limit: int) -> RadixMatch:
        """Longest cached prefix of ``tokens[:limit]``, granule-exact.
        PURE — no LRU touch (scheduler planning calls this off the op
        stream; the admission op touches)."""
        want = self.granules_of(tokens, limit)
        path: List[RadixNode] = []
        node = self.root
        i = 0
        while i < len(want):
            child = node.children.get(want[i])
            if child is None:
                break
            k = 0
            while (k < len(child.granules) and i + k < len(want)
                   and child.granules[k] == want[i + k]):
                k += 1
            if k:
                path.append(child)
            i += k
            if k < len(child.granules):
                break
            node = child
        return RadixMatch(path, i * self.granule)

    def path_of(self, node: RadixNode) -> List[RadixNode]:
        """Root-to-node chain (root excluded)."""
        out: List[RadixNode] = []
        while node is not None and node is not self.root:
            out.append(node)
            node = node.parent
        out.reverse()
        return out

    def node_count(self) -> int:
        return sum(1 for _ in self._walk())

    def tokens_cached(self) -> int:
        """Distinct cached positions (each node's own span — full-
        prefix tables share everything above ``start``)."""
        return sum(n.end - n.start for n in self._walk())

    def pool_blocks(self) -> int:
        """Pool blocks the tree currently holds (pinned registered
        segments excluded) — the ``tpuslice_kv_blocks_prefix`` gauge."""
        return sum(n.pool_block_count() for n in self._walk())

    def evictable_blocks(self) -> int:
        """Pool blocks a full reclaim could free RIGHT NOW: the summed
        segments of every subtree containing no locked or registered
        node (leaf-first eviction removes exactly those). EXACT, not an
        estimate — segment tables are disjoint and a request table
        referencing a node always holds a lock on its path, so an
        unlocked subtree's blocks free at refcount 1. can_admit and the
        scheduler's headroom guard count these as available (the engine
        reclaims deterministically inside the admission op).

        Iterative post-order — this runs on every scheduler round and
        every can_admit, and with ``radix_decoded`` a long multi-turn
        conversation grows one deep chain (recursion would hit the
        interpreter limit exactly on the serving hot path)."""
        total = 0
        clear_of: Dict[int, bool] = {}
        stack: List[Tuple[RadixNode, bool]] = [(self.root, False)]
        while stack:
            node, expanded = stack.pop()
            if not expanded:
                stack.append((node, True))
                for c in list(node.children.values()):
                    stack.append((c, False))
                continue
            clear = node.locks == 0 and not node.registered
            for c in list(node.children.values()):
                clear = clear and clear_of.pop(id(c), False)
            if clear and node is not self.root:
                total += node.pool_block_count()
            clear_of[id(node)] = clear
        return total

    def _walk(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            # list() snapshot: /v1/stats walks the tree from HTTP
            # threads while the scheduler inserts/evicts
            stack.extend(list(n.children.values()))
            if n is not self.root:
                yield n

    # ------------------------------------------------------------ mutations

    def touch(self, node: RadixNode) -> None:
        """LRU-bump the node and its ancestors (one clock tick)."""
        self.clock += 1
        while node is not None and node is not self.root:
            node.last_used = self.clock
            node = node.parent

    def lock(self, node: RadixNode) -> None:
        while node is not None and node is not self.root:
            node.locks += 1
            node = node.parent

    def pin_path(self, node: RadixNode) -> int:
        """Move every pool block the root-to-``node`` path owns outside
        the allocatable pool (registration adopting organic nodes —
        the whole path is structurally un-evictable while the
        registered descendant lives, so its blocks must stop counting
        as reclaimable capacity). Returns blocks moved."""
        moved = 0
        for nd in self.path_of(node):
            for b in nd.owned:
                if not b.pinned:
                    self.pool.pin_block(b)
                    moved += 1
        return moved

    def unlock(self, node: RadixNode) -> None:
        while node is not None and node is not self.root:
            node.locks -= 1
            node = node.parent

    def ensure_path(self, granules: List[tuple]) \
            -> Tuple[RadixNode, int]:
        """Walk ``granules`` splitting edges so the matched boundary is
        an exact node end; returns (deepest matched node — the parent a
        new suffix child hangs under, root when nothing matched,
        matched granule count). Splits are pure host bookkeeping: the
        segment table and stripe list cut at the (block-aligned)
        granule boundary, no pool traffic, no device work."""
        node = self.root
        i = 0
        while i < len(granules):
            child = node.children.get(granules[i])
            if child is None:
                return node, i
            k = 0
            while (k < len(child.granules) and i + k < len(granules)
                   and child.granules[k] == granules[i + k]):
                k += 1
            i += k
            if k < len(child.granules):
                return self._split(child, k), i
            node = child
        return node, i

    def _split(self, node: RadixNode, k: int) -> RadixNode:
        """Split ``node``'s edge after ``k`` granules; returns the new
        upper node (which forks the shared head + takes the stripes
        and owned-block attribution inside its span — ``node`` object
        identity stays with the lower half, so held references and rid
        locks keep pointing at the deeper segment they matched
        through). Pure pool bookkeeping: the fork refcounts, no block
        moves, no device work."""
        mid = node.start + k * self.granule
        upper_table = self.pool.fork(node.table, mid)
        upper = RadixNode(node.granules[:k], node.start, upper_table,
                          node.parent)
        # deepest-creator attribution follows the split: blocks inside
        # the upper span re-attribute to the upper node, so evicting
        # any full unlocked subtree still frees exactly sum(owned)
        upper_ids = {b.block_id for b in upper_table.blocks}
        upper.owned = [b for b in node.owned
                       if b.block_id in upper_ids]
        node.owned = [b for b in node.owned
                      if b.block_id not in upper_ids]
        upper.stripes = node.stripes[:k]
        if node.draft_stripes is not None:
            upper.draft_stripes = node.draft_stripes[:k]
            node.draft_stripes = node.draft_stripes[k:]
        # a lock on the lower half pins the whole path; the new
        # ancestor must carry the same count or unlock would go negative
        upper.locks = node.locks
        upper.last_used = node.last_used
        upper.parent.children[upper.granules[0]] = upper
        upper.children[node.granules[k]] = node
        node.granules = node.granules[k:]
        node.stripes = node.stripes[k:]
        node.start = mid
        node.parent = upper
        return upper

    def add_child(self, parent: RadixNode, granules: List[tuple],
                  pinned: bool = False) -> RadixNode:
        """New node under ``parent``: its table forks the parent's
        full-prefix table (shared blocks stored once, refcounted) and
        grows to cover the new granules — pool blocks (organic,
        evictable) or pinned ones (registered prefixes live outside
        the allocatable pool, exactly like the pre-radix stripe cache,
        so registration never shrinks serving capacity). Raises
        :class:`BlockPoolExhausted` when the pool cannot cover an
        organic extension (callers skip the insert)."""
        if not granules:
            raise ValueError("add_child needs at least one granule")
        end = parent.end + len(granules) * self.granule
        table = self.pool.fork(parent.table, parent.end)
        had = {b.block_id for b in table.blocks}
        try:
            self.pool.ensure(table, end, pinned=pinned)
        except BlockPoolExhausted:
            self.pool.release(table)
            raise
        node = RadixNode(granules, parent.end, table, parent)
        node.owned = [b for b in table.blocks
                      if b.block_id not in had]
        self.clock += 1
        node.last_used = self.clock
        parent.children[granules[0]] = node
        return node

    def evict(self, node: RadixNode) -> int:
        """Remove an evictable leaf; returns the pool blocks freed
        (exactly the node's owned attribution — the lock discipline
        guarantees no request table still references them). The caller
        guarantees leaf + unlocked + unregistered."""
        freed = node.pool_block_count()
        self.pool.release(node.table)
        node.parent.children.pop(node.granules[0], None)
        node.parent = None
        node.stripes = []
        node.draft_stripes = None
        node.owned = []
        self.evictions += 1
        return freed

    def _lru_evictable_leaf(self) -> Optional[RadixNode]:
        best = None
        for n in self._walk():
            if n.children or n.locks > 0 or n.registered:
                continue
            key = (n.last_used, n.start, n.granules[0])
            if best is None or key < (best.last_used, best.start,
                                      best.granules[0]):
                best = n
        return best

    def hot_paths(self, max_paths: int = 32) -> List[List[str]]:
        """The most-recently-used root-to-leaf paths as granule-hash
        chains (:func:`granule_hash`) — the "advertised prefixes" half
        of the fleet router's shadow index. Hashes, not tokens: a
        ``/v1/stats`` poll must not ship prompt content across the
        fleet, and the router only needs equality at granule
        boundaries. list()-snapshotted like every stats walk."""
        leaves = [n for n in self._walk()
                  if not list(n.children.values())]
        leaves.sort(key=lambda n: n.last_used, reverse=True)
        out: List[List[str]] = []
        for leaf in leaves[:max_paths]:
            chain: List[str] = []
            for node in self.path_of(leaf):
                chain.extend(granule_hash(g) for g in node.granules)
            if chain:
                out.append(chain)
        return out

    def reclaim(self, need_blocks: int) -> int:
        """Evict LRU leaves (leaf-first — an interior node becomes a
        leaf once its children go) until ``need_blocks`` pool blocks
        came free or nothing evictable remains; returns blocks freed.
        Deterministic given tree state: called only inside engine ops,
        so op-stream followers evict the identical nodes."""
        freed = 0
        while freed < need_blocks:
            leaf = self._lru_evictable_leaf()
            if leaf is None:
                break
            freed += self.evict(leaf)
        return freed


def granule_hash(granule) -> str:
    """Stable cross-process hash of one radix granule (a tuple of token
    ids) — the unit of the router's shadow prefix index. blake2b-8:
    Python's builtin ``hash`` is per-process salted and would make every
    replica advertise unmatchable chains."""
    raw = ",".join(str(int(t)) for t in granule).encode()
    return hashlib.blake2b(raw, digest_size=8).hexdigest()


# ------------------------------------------------------ session wire format
#
# The live-migration primitive's serialization half: a preempted
# request's parked KV stripe (plus host decode state) crosses between
# replicas as JSON, versioned, model-signature-checked at import, arrays
# carried as base64 rows. The codec is host-side: it writes numpy arrays
# and CPU tensors and reads CPU tensors; the engine moves them to and
# from its device at its own seam.
#
# numpy has no bfloat16 (the JAX package decodes one through
# ``ml_dtypes``): a bfloat16 tensor goes on the wire as its raw 2-byte
# words under the dtype name "bfloat16", the bytes the JAX package
# writes, and comes back through a 16-bit integer view, so blobs move
# between the two engines either way, byte for byte.

#: bump on ANY change to the blob layout the engine emits: import
#: REJECTS other versions outright (a half-understood session resumed
#: from a stale field set would silently corrupt the decode chain)
SESSION_WIRE_VERSION = 1


def array_to_wire(arr) -> dict:
    """One numpy array or CPU tensor -> a JSON-safe dict (dtype/shape/b64
    data)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            name, raw = str(a.dtype), a.tobytes()
        shape = list(t.shape)
    else:
        a = np.ascontiguousarray(arr)
        name, raw, shape = str(a.dtype), a.tobytes(), list(a.shape)
    return {
        "__nd__": True,
        "dtype": name,
        "shape": shape,
        "data": base64.b64encode(raw).decode("ascii"),
    }


def wire_to_array(obj: dict) -> torch.Tensor:
    """A wire dict -> a CPU tensor of its dtype and shape (bfloat16 read
    back through an int16 view of its raw words)."""
    raw = base64.b64decode(obj["data"])
    name = obj["dtype"]
    if name == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(name)).copy())
    return t.reshape(obj["shape"])


def tree_to_wire(tree):
    """A tree of arrays (dict / list / tuple nesting) -> JSON-safe
    nesting. Tuples are tagged so the reconstruction round-trips the
    exact tree STRUCTURE."""
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return array_to_wire(tree)
    if isinstance(tree, dict):
        return {k: tree_to_wire(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [tree_to_wire(v) for v in tree]}
    if isinstance(tree, list):
        return [tree_to_wire(v) for v in tree]
    return tree


def wire_to_tree(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            return wire_to_array(obj)
        if "__tuple__" in obj and len(obj) == 1:
            return tuple(wire_to_tree(v) for v in obj["__tuple__"])
        return {k: wire_to_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [wire_to_tree(v) for v in obj]
    return obj
