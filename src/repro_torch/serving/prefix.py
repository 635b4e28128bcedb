"""Radix-tree prefix cache over paged KV blocks.

Maps token-id prefixes to shared chains of ``PagedKVPool`` blocks so a
request whose prompt starts with a previously-served prefix can adopt the
cached KV instead of recomputing it (``ContinuousScheduler._admit`` →
``ServeEngine.adopt_prefix``).  A full-prefix hit admits with near-zero
TTFT: chunked prefill touches only the novel suffix.

Ownership model (the part that makes mid-block divergence safe):

  * Each node's edge covers token positions ``[start, start + len(key))``
    and lists the physical blocks covering that WHOLE range — including a
    *straddling* block at a non-block-aligned ``start``.  The straddle
    block is the inserting row's own copy, which holds the shared tokens
    before ``start`` (the row adopted-then-CoW'd them) plus this branch's
    continuation after it.  On a match walk, a deeper node's listing for a
    block index supersedes its parent's: both agree on content up to the
    branch point, and only the deeper copy continues down the matched path.
  * Donated chains are trimmed to *full* blocks (``ServeEngine
    .insert_prefix`` cuts at ``floor(P / bs) * bs`` tokens): the donor keeps
    decoding into its final partial block, and a block being appended to
    can never be shared.
  * Every listed block holds one pool refcount per listing node (plus one
    per row table mapping it — see ``PagedKVPool.check``).  A node split
    re-refs the straddling block once, since it then appears in both
    halves.  Adoption bumps refcounts again (``pool.adopt``); the adopting
    row copy-on-writes before appending, so tree contents are immutable.

Eviction: under pool pressure (``PagedKVPool.evict_cb``) the
least-recently-matched *leaf* is dropped and its listings released —
interior nodes stay, so shorter shared prefixes survive longer, LRU order
refreshed by every match/insert walk.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.paged_kv import PagedKVPool


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    k = 0
    while k < n and a[k] == b[k]:
        k += 1
    return k


class _Node:
    __slots__ = ("key", "start", "blocks", "children", "parent",
                 "last_access", "order")

    def __init__(self, key: Tuple[int, ...], start: int, blocks: List[int],
                 parent: Optional["_Node"], order: int) -> None:
        self.key = key
        self.start = start          # absolute token offset of key[0]
        self.blocks = blocks        # covers block idx floor(start/bs)..
        self.children: Dict[int, _Node] = {}
        self.parent = parent
        self.last_access = order
        self.order = order

    def block_lo(self, bs: int) -> int:
        return self.start // bs


class PrefixTree:
    """Token-id radix tree whose edges carry paged-KV block chains."""

    def __init__(self, pool: PagedKVPool) -> None:
        self.pool = pool
        self.root = _Node((), 0, [], None, 0)
        self._clock = 0
        self.n_nodes = 0
        self.n_evicted = 0
        pool.evict_cb = self.evict_lru_leaf

    # -- match -----------------------------------------------------------
    def match(self, tokens: Sequence[int], cap: int) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``, capped at ``cap`` tokens
        (callers pass ``len(prompt) - 1`` so at least one token remains to
        feed).  Returns ``(m, chain)`` where ``chain`` lists the physical
        blocks covering positions ``[0, ceil(m / bs) * bs)`` — the last one
        shared mid-fill, so the adopter must CoW before writing."""
        bs = self.pool.block_size
        self._clock += 1
        found: Dict[int, int] = {}
        cur, offset = self.root, 0
        while offset < len(tokens):
            child = cur.children.get(tokens[offset])
            if child is None:
                break
            k = _common_prefix(child.key, tokens[offset:])
            if k == 0:
                break
            child.last_access = self._clock
            lo = child.block_lo(bs)
            n_cov = -(-(child.start + k) // bs) - lo
            for i in range(n_cov):
                found[lo + i] = child.blocks[i]   # deeper listing wins
            offset += k
            if k < len(child.key):
                break
            cur = child
        m = min(offset, cap)
        if m <= 0:
            return 0, []
        need = -(-m // bs)
        return m, [found[j] for j in range(need)]

    # -- insert ----------------------------------------------------------
    def insert(self, tokens: Sequence[int], row_blocks: Sequence[int]) -> int:
        """Donate a fully-prefilled prompt's block chain.  ``tokens`` and
        ``row_blocks`` must already be trimmed to full blocks (``len(tokens)
        == len(row_blocks) * bs``).  Refcounts are bumped for every new
        listing; returns the number of newly-listed blocks."""
        bs = self.pool.block_size
        assert len(tokens) == len(row_blocks) * bs, "insert not block-aligned"
        if not tokens:
            return 0
        self._clock += 1
        tokens = tuple(int(t) for t in tokens)
        cur, offset = self.root, 0
        while offset < len(tokens):
            child = cur.children.get(tokens[offset])
            if child is None:
                return self._attach(cur, tokens, offset, row_blocks)
            k = _common_prefix(child.key, tokens[offset:])
            child.last_access = self._clock
            if k < len(child.key):
                self._split(child, k)
                offset += k
                if offset < len(tokens):
                    return self._attach(child, tokens, offset, row_blocks)
                return 0
            offset += k
            cur = child
        return 0   # whole prompt already cached

    def _attach(self, parent: _Node, tokens: Tuple[int, ...], offset: int,
                row_blocks: Sequence[int]) -> int:
        bs = self.pool.block_size
        blocks = [int(b) for b in row_blocks[offset // bs:]]
        for b in blocks:
            self.pool.ref(b)
        node = _Node(tokens[offset:], offset, blocks, parent, self._clock)
        parent.children[tokens[offset]] = node
        self.n_nodes += 1
        return len(blocks)

    def _split(self, node: _Node, k: int) -> None:
        """Split ``node`` at key offset ``k``: the node keeps ``key[:k]``
        and the blocks covering it; a new child takes the rest.  A block
        straddling the cut lands in both listings and gains a ref."""
        bs = self.pool.block_size
        cut = node.start + k
        lo = node.block_lo(bs)
        n_par = -(-cut // bs) - lo           # parent listing length
        child = _Node(node.key[k:], cut, node.blocks[cut // bs - lo:],
                      node, self._clock)
        child.children = node.children
        child.last_access = node.last_access
        for gc in child.children.values():
            gc.parent = child
        if cut % bs:                          # straddle now listed twice
            self.pool.ref(node.blocks[n_par - 1])
        node.key = node.key[:k]
        node.blocks = node.blocks[:n_par]
        node.children = {child.key[0]: child}
        self.n_nodes += 1

    # -- eviction --------------------------------------------------------
    def evict_lru_leaf(self) -> bool:
        """Release the least-recently-matched leaf's listings (pool pressure
        hook).  Returns False when nothing is evictable."""
        leaf: Optional[_Node] = None
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                if leaf is None or ((n.last_access, n.order) <
                                    (leaf.last_access, leaf.order)):
                    leaf = n
            stack.extend(n.children[t] for t in sorted(n.children,
                                                       reverse=True))
        if leaf is None:
            return False
        for b in leaf.blocks:
            self.pool.release(b)
        assert leaf.parent is not None
        del leaf.parent.children[leaf.key[0]]
        self.n_nodes -= 1
        self.n_evicted += 1
        return True

    # -- digests ---------------------------------------------------------
    def block_holders(self) -> Dict[int, int]:
        """Physical block -> number of tree listings (for
        ``PagedKVPool.check``)."""
        holders: Dict[int, int] = {}
        stack = [self.root]
        while stack:
            n = stack.pop()
            for b in n.blocks:
                holders[b] = holders.get(b, 0) + 1
            stack.extend(n.children.values())
        return holders

    def stats(self) -> dict:
        listings = sum(self.block_holders().values())
        return {"nodes": self.n_nodes, "block_listings": listings,
                "evicted": self.n_evicted}
