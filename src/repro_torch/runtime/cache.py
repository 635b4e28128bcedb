"""Per-layer expert cache (the GPU-resident expert set).

Host-side structure: for each MoE layer a fixed number of slots
(capacity = cache_rate * E). Eviction policies: LRU, LFU, or a frequency
prior (EdgeMoE-style). Slots are assigned round-robin to mesh partitions so
the topology term hop(j) in Psi (Eq. 3) has real structure.

Residency states (driven by the transfer scheduler's timeline):

  resident   weights are on device and USABLE this step
  in-flight  a transfer was issued but has not arrived — the expert is NOT
             usable (the paper's late-prefetch case) and NOT evictable
  pinned     resident and in use by the layer currently computing — never
             chosen as an eviction victim mid-use
  locked     statically placed (an expert-parallel home shard) — resident
             forever, never an eviction victim. All-False until
             ``enable_mesh`` runs, so single-device behavior is unchanged.

Eviction is buddy-aware when a buddy table is attached: among the
policy-worst candidates, prefer evicting an expert that still has resident
buddies, so a future miss on it can be absorbed by substitution instead of a
synchronous PCIe fetch.

Multi-device (``enable_mesh(n_devices)``): experts are sharded
round-robin — ``owner[e] = e % D`` — and the cache becomes the view FROM
device 0, the simulated compute device. Device 0 seeds its own home shard
first (locked), spending leftover capacity on dynamic slots; each peer
device d >= 1 keeps its home shard statically resident in its own HBM
(``peer_resident[d]``), which is what the peer-borrow miss outcome reads.
Peer residency has the same per-device capacity/pin/evict discipline via
``peer_insert``/``peer_evict``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ExpertCache:
    """Device-resident expert set: per-layer boolean residency over
    ``capacity = cache_rate * E`` slots, with LRU/LFU eviction, pin/lock
    protection, an in-flight mask driven by the transfer timeline, and
    (on a mesh) per-peer-device residency views. All masks are [L, E]
    bool arrays; sizes are slot counts, not bytes."""

    def __init__(self, num_layers: int, num_experts: int, cache_rate: float,
                 policy: str = "lru", num_partitions: int = 1, seed: int = 0,
                 buddy_table: Optional[np.ndarray] = None,
                 buddy_candidates: int = 4):
        assert policy in ("lru", "lfu")
        self.num_layers = num_layers
        self.num_experts = num_experts
        # clamp to [1, E]: cache_rate > 1 just means "everything fits" (the
        # unclamped capacity made rng.choice(E, capacity, replace=False) throw)
        self.capacity = min(num_experts,
                            max(1, int(round(cache_rate * num_experts))))
        self.policy = policy
        self.num_partitions = num_partitions
        self.resident = np.zeros((num_layers, num_experts), bool)
        self.inflight = np.zeros((num_layers, num_experts), bool)
        self.pinned = np.zeros((num_layers, num_experts), bool)
        self.locked = np.zeros((num_layers, num_experts), bool)
        # reclaim-first slots: replicas the placement controller installed
        # whose expert has gone cold — evicted BEFORE any normal victim
        # (all-False unless a PlacementController marks them, so the
        # pre-placement eviction order is unchanged)
        self.reclaimable = np.zeros((num_layers, num_experts), bool)
        self.n_devices = 1
        self.owner = None               # [E] home device, set by enable_mesh
        self.peer_resident = None       # [D, L, E] bool, set by enable_mesh
        self.peer_pinned = None         # [D, L, E] bool, set by enable_mesh
        self.last_used = np.zeros((num_layers, num_experts), np.int64)
        self.freq = np.zeros((num_layers, num_experts), np.float64)
        self.partition = np.zeros((num_layers, num_experts), np.int32)
        self.clock = 0
        # [L, E, R] buddy lists (-1 padded) for buddy-aware victim choice
        self.buddy_table = buddy_table
        self.buddy_candidates = buddy_candidates
        rng = np.random.default_rng(seed)
        for l in range(num_layers):
            init = rng.choice(num_experts, self.capacity, replace=False)
            self.resident[l, init] = True
            self._assign_partitions(l)

    def _assign_partitions(self, layer: int) -> None:
        slots = np.flatnonzero(self.resident[layer])
        for s_i, e in enumerate(slots):
            self.partition[layer, e] = s_i % self.num_partitions

    # -- queries --------------------------------------------------------
    def residency_mask(self) -> np.ndarray:
        """Usable experts only — in-flight transfers have NOT arrived."""
        return self.resident.copy()

    def hop_vector(self, layer: int, origin_partition: int = 0) -> np.ndarray:
        """ICI hops from origin to each expert's slot partition (0 if
        local). Non-resident experts are -1 — a sentinel, NOT zero hops:
        the old 0 made "absent" indistinguishable from "local", so any
        consumer that forgot to mask with ``resident`` silently priced
        missing experts as free. Eligible buddy candidates are always
        resident, so substitution masks the sentinel away; direct callers
        must treat negatives as "not on device"."""
        p = self.partition[layer]
        side = max(1, int(np.sqrt(self.num_partitions)))
        dx = np.abs(p % side - origin_partition % side)
        dy = np.abs(p // side - origin_partition // side)
        hops = (dx + dy).astype(np.int32)
        return np.where(self.resident[layer], hops, np.int32(-1))

    # -- expert-parallel mesh (view from device 0) ----------------------
    def enable_mesh(self, n_devices: int) -> None:
        """Shard experts round-robin across ``n_devices`` and re-seed this
        cache as device 0's HBM: its home shard first (locked — statically
        placed experts are never eviction victims), then as many of the
        previously-seeded dynamic slots as capacity still allows. Peers
        hold their own home shards (``peer_resident``). ``n_devices <= 1``
        is a no-op, keeping the single-device build bit-identical."""
        if n_devices <= 1:
            return
        d_n = int(n_devices)
        l_n, e_n = self.num_layers, self.num_experts
        self.n_devices = d_n
        self.owner = (np.arange(e_n) % d_n).astype(np.int32)
        home0 = self.owner == 0
        for l in range(l_n):
            prev = np.flatnonzero(self.resident[l] & ~home0)
            seeded = np.flatnonzero(home0)[:self.capacity]
            self.resident[l] = False
            self.resident[l, seeded] = True
            self.locked[l, seeded] = True
            room = self.capacity - len(seeded)
            if room > 0:
                self.resident[l, prev[:room]] = True
            self._assign_partitions(l)
        self.peer_resident = np.zeros((d_n, l_n, e_n), bool)
        self.peer_pinned = np.zeros((d_n, l_n, e_n), bool)
        for d in range(1, d_n):
            self.peer_resident[d] = (self.owner == d)[None, :]

    def peer_holders(self, layer: int, expert: int) -> np.ndarray:
        """Peer device ids whose HBM holds ``expert`` right now."""
        if self.peer_resident is None:
            return np.empty(0, np.int64)
        return np.flatnonzero(self.peer_resident[:, layer, expert])

    def peer_insert(self, device: int, layer: int, expert: int) -> int:
        """Replicate an expert into peer ``device``'s HBM, evicting its
        policy-worst unpinned non-home slot when over capacity. Returns the
        evicted expert id or -1."""
        assert self.peer_resident is not None and device >= 1
        row = self.peer_resident[device, layer]
        if row[expert]:
            return -1
        row[expert] = True
        evicted = -1
        if int(row.sum()) > self.capacity:
            home = self.owner == device
            cand = np.flatnonzero(row & ~home
                                  & ~self.peer_pinned[device, layer])
            cand = cand[cand != expert]
            if len(cand):
                evicted = int(self._policy_order(layer, cand)[0])
                row[evicted] = False
        return evicted

    def peer_evict(self, device: int, layer: int, expert: int) -> bool:
        """Drop a replica from a peer's HBM; home-shard experts (the
        mesh's statically-placed copies) and pinned replicas refuse."""
        assert self.peer_resident is not None and device >= 1
        if (self.owner[expert] == device
                or self.peer_pinned[device, layer, expert]
                or not self.peer_resident[device, layer, expert]):
            return False
        self.peer_resident[device, layer, expert] = False
        return True

    # -- updates --------------------------------------------------------
    def touch(self, layer: int, experts, weight: float = 1.0) -> None:
        """Record usage (for LRU clocks / LFU frequencies)."""
        experts = np.atleast_1d(np.asarray(experts, np.int64))
        self.clock += 1
        self.last_used[layer, experts] = self.clock
        self.freq[layer, experts] += weight

    # -- pinning (mid-use protection) -----------------------------------
    def pin(self, layer: int, experts) -> None:
        """Protect residents in use by the currently-computing layer from
        eviction; released by ``unpin`` after the layer's prefetches."""
        experts = np.atleast_1d(np.asarray(experts, np.int64))
        self.pinned[layer, experts] = True

    def unpin(self, layer: int, experts=None) -> None:
        """Release pins (``experts=None``: the whole layer)."""
        if experts is None:
            self.pinned[layer] = False
        else:
            experts = np.atleast_1d(np.asarray(experts, np.int64))
            self.pinned[layer, experts] = False

    # -- reclaim-first replicas (placement controller) -------------------
    def mark_reclaimable(self, layer: int, experts) -> None:
        """Flag cold placement replicas as preferred eviction victims:
        ``_pick_victim`` evicts any flagged candidate before consulting the
        normal LRU/LFU order (runtime/placement.py's hysteresis down-edge)."""
        experts = np.atleast_1d(np.asarray(experts, np.int64))
        self.reclaimable[layer, experts] = True

    def clear_reclaimable(self, layer: int, experts) -> None:
        """Unflag replicas (the expert heated back up, or was evicted)."""
        experts = np.atleast_1d(np.asarray(experts, np.int64))
        self.reclaimable[layer, experts] = False

    # -- in-flight lifecycle (scheduler-driven) -------------------------
    def begin_inflight(self, layer: int, expert: int) -> None:
        """A transfer was submitted: the expert is arriving but NOT usable
        (and not evictable) until ``commit_inflight``."""
        if not self.resident[layer, expert]:
            self.inflight[layer, expert] = True

    def cancel_inflight(self, layer: int, expert: int) -> None:
        """The transfer was cancelled before landing: clear the mark."""
        self.inflight[layer, expert] = False

    def commit_inflight(self, layer: int, expert: int) -> int:
        """Transfer arrived: the expert becomes resident (evicting per
        policy if needed). Returns the evicted expert id or -1."""
        self.inflight[layer, expert] = False
        return self.insert(layer, expert)

    def on_transfer_event(self, kind: str, t) -> None:
        """Listener hook for runtime.transfers.TransferScheduler."""
        if kind == "submit":
            self.begin_inflight(t.layer, t.expert)
        elif kind == "complete":
            self.commit_inflight(t.layer, t.expert)
        elif kind == "cancel":
            self.cancel_inflight(t.layer, t.expert)

    # -- eviction -------------------------------------------------------
    def _policy_order(self, layer: int, cand: np.ndarray) -> np.ndarray:
        """Candidates sorted worst-first under the eviction policy."""
        score = (self.last_used if self.policy == "lru" else self.freq)
        return cand[np.argsort(score[layer, cand], kind="stable")]

    def _pick_victim(self, layer: int, exclude: int) -> int:
        """Choose an eviction victim: never pinned, never the incoming
        expert; among the policy-worst few, prefer one whose buddies are
        resident (its future misses are absorbable). Returns -1 if every
        candidate is pinned (caller tolerates transient over-capacity).
        Locked slots — an expert-parallel home shard — are never victims.
        Cold placement replicas (``reclaimable``) go first: a replica whose
        expert stopped being hot is by construction the least valuable
        slot, so it is reclaimed before any normal victim."""
        cand = np.flatnonzero(self.resident[layer] & ~self.pinned[layer]
                              & ~self.locked[layer])
        cand = cand[cand != exclude]
        if len(cand) == 0:
            return -1
        recl = cand[self.reclaimable[layer, cand]]
        if len(recl):
            return int(self._policy_order(layer, recl)[0])
        ordered = self._policy_order(layer, cand)
        pool = ordered[:max(1, self.buddy_candidates)]
        if self.buddy_table is not None and len(pool) > 1:
            for e in pool:
                buddies = self.buddy_table[layer, e]
                buddies = buddies[buddies >= 0]
                if len(buddies) and self.resident[layer, buddies].any():
                    return int(e)
        return int(pool[0])

    def preview_victim(self, layer: int, incoming: int) -> int:
        """The expert ``insert(layer, incoming)`` would evict right now, or
        -1 when a free slot (or no evictable candidate) means nothing is
        displaced. Read-only — the placement controller uses it for
        replication admission control: copying a hot expert in is only
        worth it when what it pushes out is colder."""
        if int(self.resident[layer].sum()) < self.capacity:
            return -1
        return self._pick_victim(layer, exclude=incoming)

    def insert(self, layer: int, expert: int) -> int:
        """Insert an expert (post-fetch); evicts per policy if full.
        Returns the evicted expert id or -1."""
        if self.resident[layer, expert]:
            return -1
        evicted = -1
        n_res = int(self.resident[layer].sum())
        if n_res >= self.capacity:
            evicted = self._pick_victim(layer, exclude=expert)
            if evicted >= 0:
                self.resident[layer, evicted] = False
                self.reclaimable[layer, evicted] = False
        self.resident[layer, expert] = True
        self.reclaimable[layer, expert] = False
        if evicted >= 0:
            # reuse the vacated slot so partition topology stays stable
            self.partition[layer, expert] = self.partition[layer, evicted]
        else:
            self.partition[layer, expert] = n_res % self.num_partitions
        # trim any transient over-capacity left by fully-pinned layers
        while (int(self.resident[layer].sum()) > self.capacity):
            extra = self._pick_victim(layer, exclude=expert)
            if extra < 0:
                break
            self.resident[layer, extra] = False
            self.reclaimable[layer, extra] = False
        return evicted

    def prefetch_to(self, layer: int, experts) -> list:
        """Ensure ``experts`` resident; returns list of (inserted, evicted).

        Legacy instant-arrival path (no timeline). The serving engine now
        issues prefetches through the TransferScheduler instead, so arrival
        happens at the modeled PCIe completion time."""
        out = []
        for e in experts:
            e = int(e)
            if not self.resident[layer, e]:
                ev = self.insert(layer, e)
                out.append((e, ev))
        return out
