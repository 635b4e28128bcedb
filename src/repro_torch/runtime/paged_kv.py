"""Paged KV allocator — fixed-size blocks, refcounts, copy-on-write.

Replaces the per-slot ``[B, Cap, KV, hd]`` KV rings with one shared pool of
``n_blocks`` physical blocks of ``block_size`` tokens each.  Device storage
(owned by the model code, see ``transformer.init_paged_caches``) is a stack
of ``[P, bs, KV, hd]`` leaves; this class owns only the *host-side* mapping
state:

  * ``tables``   — ``[batch, max_blocks]`` int32: row r's logical block j
                   (token positions ``[j*bs, (j+1)*bs)``) lives in physical
                   block ``tables[r, j]``; ``-1`` means unmapped.  The engine
                   ships this array to the device as the block table every
                   paged step.
  * ``refcount`` — per-physical-block holder count.  A block's holders are
                   the row tables that map it plus the radix-tree nodes that
                   list it (``serving/prefix.py``); it returns to the free
                   list exactly when the count hits zero.
  * free list    — a LIFO stack popped deterministically, so allocation
                   order (and therefore every downstream device gather) is
                   reproducible at a fixed seed.

Copy-on-write: a row may only *write* into a block it owns exclusively
(refcount 1).  ``ensure_range`` remaps any shared block in the write range
to a fresh block and queues a ``(src, dst)`` physical copy; the engine
drains the queue (``drain_copies``) into one batched device copy before the
next scatter.  This is what makes prefix sharing safe — adopted blocks are
never mutated in place, so the radix tree's contents stay frozen.

Pool pressure: when the free list is empty, ``alloc`` invokes ``evict_cb``
(wired to the prefix tree's LRU leaf eviction) until a block frees up or
the callback gives up, then raises if the pool is genuinely exhausted.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


class PagedKVPool:
    """Host-side block allocator + per-row block tables for paged KV."""

    def __init__(self, n_blocks: int, block_size: int, batch: int,
                 max_blocks: int) -> None:
        assert n_blocks >= 1 and block_size >= 1
        assert batch >= 1 and max_blocks >= 1
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.batch = int(batch)
        self.max_blocks = int(max_blocks)
        self.refcount = np.zeros(self.n_blocks, np.int32)
        # LIFO: block 0 pops first (reversed range), keeping allocation
        # order stable run-to-run
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self.tables = np.full((self.batch, self.max_blocks), -1, np.int32)
        self._copies: List[Tuple[int, int]] = []
        # called under pool pressure; returns True if it released something
        self.evict_cb: Optional[Callable[[], bool]] = None
        self.cow_copies = 0
        self.evictions = 0

    # -- raw block ops ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self) -> int:
        """Pop a free block (refcount 1), evicting cold prefix-tree leaves
        under pressure."""
        while not self._free and self.evict_cb is not None:
            if not self.evict_cb():
                break
            self.evictions += 1
        if not self._free:
            raise RuntimeError(
                f"PagedKVPool exhausted: all {self.n_blocks} blocks of "
                f"{self.block_size} tokens are held")
        b = self._free.pop()
        assert self.refcount[b] == 0
        self.refcount[b] = 1
        return b

    def ref(self, blk: int) -> None:
        assert self.refcount[blk] > 0, "ref of a free block"
        self.refcount[blk] += 1

    def release(self, blk: int) -> None:
        assert self.refcount[blk] > 0, "release of a free block"
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            self._free.append(blk)

    # -- per-row table ops ----------------------------------------------
    def free_row(self, row: int) -> None:
        """Drop every block the row maps (idempotent)."""
        t = self.tables[row]
        for j in np.flatnonzero(t >= 0):
            self.release(int(t[j]))
        self.tables[row] = -1

    def n_mapped(self, row: int) -> int:
        return int((self.tables[row] >= 0).sum())

    def row_blocks(self, row: int, n_tokens: int) -> List[int]:
        """Physical blocks covering positions ``[0, n_tokens)`` of a row —
        all must be mapped (the row has written them)."""
        need = -(-n_tokens // self.block_size)
        out = [int(self.tables[row, j]) for j in range(need)]
        assert all(b >= 0 for b in out), "row_blocks over unmapped range"
        return out

    def adopt(self, row: int, blocks: Sequence[int]) -> None:
        """Map a shared prefix chain (block j = positions ``[j*bs,
        (j+1)*bs)``) into an empty row table, bumping refcounts.  The row
        must CoW (via ``ensure_range``) before writing any of them."""
        for j, b in enumerate(blocks):
            assert self.tables[row, j] == -1, "adopt into a mapped slot"
            self.ref(int(b))
            self.tables[row, j] = int(b)

    def ensure_range(self, row: int, start: int, end: int) -> None:
        """Make positions ``[start, end)`` writable by this row: allocate
        unmapped blocks in the range and copy-on-write shared ones (the
        adopted tail block a prefix hit will append into).  Queued device
        copies are picked up by ``drain_copies``."""
        if end <= start:
            return
        bs = self.block_size
        lo, hi = start // bs, (end - 1) // bs
        assert hi < self.max_blocks, (
            f"row {row} needs block {hi} but tables are "
            f"{self.max_blocks} wide (context overflow)")
        for j in range(lo, hi + 1):
            b = int(self.tables[row, j])
            if b < 0:
                self.tables[row, j] = self.alloc()
            elif self.refcount[b] > 1:
                nb = self.alloc()
                self._copies.append((b, nb))
                self.cow_copies += 1
                self.release(b)
                self.tables[row, j] = nb

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Pending ``(src, dst)`` physical block copies, cleared on read.
        The engine applies them to the device pool before the next write."""
        out, self._copies = self._copies, []
        return out

    # -- digests ---------------------------------------------------------
    def occupancy(self) -> dict:
        return {"n_blocks": self.n_blocks, "block_size": self.block_size,
                "used_blocks": self.used_blocks,
                "free_blocks": self.free_blocks,
                "cow_copies": self.cow_copies,
                "evictions": self.evictions}

    def check(self, extra_holders: Optional[dict] = None) -> None:
        """Invariant audit (tests): every block's refcount equals the number
        of row-table slots mapping it plus ``extra_holders`` (e.g. the radix
        tree's per-block listing counts), and the free list holds exactly
        the zero-refcount blocks, each once."""
        holders = np.zeros(self.n_blocks, np.int64)
        for b in self.tables[self.tables >= 0]:
            holders[int(b)] += 1
        for b, n in (extra_holders or {}).items():
            holders[int(b)] += int(n)
        assert (holders == self.refcount).all(), (
            "refcount drift: "
            f"{np.flatnonzero(holders != self.refcount).tolist()}")
        free = sorted(self._free)
        assert free == sorted(set(free)), "duplicate free-list entry"
        assert free == np.flatnonzero(self.refcount == 0).tolist(), (
            "free list out of sync with refcounts")
