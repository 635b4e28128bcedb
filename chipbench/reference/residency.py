"""The expert residency of every serving step, worked out again: a frozen
copy of the port's single-device serving runtime as it stood when the
benchmark was defined, for the configuration the cells run (one device,
the precedence policy with fetch as the fallback, no quantized tier, no
telemetry, no placement):

  * the expert cache: ``cache_rate * E`` slots a layer, LRU eviction that
    prefers, among the four least recently used, a victim with a resident
    buddy; pinned experts are never victims;
  * the transfer timeline: one PCIe link on a simulated clock, demand
    fetches ahead of prefetches, at most four prefetches served at once,
    the bandwidth shared fairly, a fixed cost per transfer, stale
    prefetches cancelled, an in-flight prefetch escalated when a layer
    needs it;
  * the prev-step predictor (last step's experts, back-filled from a
    decayed activation count) and the prefetch of layer l + 1 while
    layer l computes;
  * the engine's replay of each step on that timeline.

It imports nothing of the program. The step's inputs are the router's
top-k and the substitution flags of every active token, layer by layer;
a slot misses where its expert is not resident at the step's start and
no buddy stood in.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

# the runtime's hardware model that prices the simulated clock
PEAK_FLOPS = 197e12
HBM_BW = 819e9
PCIE_BW = 24e9
PCIE_FIXED_S = 0.5e-3
DTYPE_BYTES = 2
MAX_INFLIGHT_PREFETCH = 4
BUDDY_CANDIDATES = 4
FREQ_DECAY = 0.99

_PRIO_DEMAND, _PRIO_PREFETCH = 0, 10
_EPS_B, _EPS_S = 0.5, 1e-12


def expert_bytes(rc: dict) -> int:
    return 3 * rc["d_model"] * rc["expert_d_ff"] * DTYPE_BYTES


def compute_time(params: int, n_tokens: int) -> float:
    flops = 2.0 * params * n_tokens
    mem = params * DTYPE_BYTES
    return max(flops / PEAK_FLOPS, mem / HBM_BW)


def cache_capacity(num_experts: int, cache_rate: float) -> int:
    return min(num_experts, max(1, int(round(cache_rate * num_experts))))


class Cache:
    def __init__(self, l_n: int, e_n: int, cache_rate: float, table):
        self.capacity = cache_capacity(e_n, cache_rate)
        self.resident = np.zeros((l_n, e_n), bool)
        self.inflight = np.zeros((l_n, e_n), bool)
        self.pinned = np.zeros((l_n, e_n), bool)
        self.last_used = np.zeros((l_n, e_n), np.int64)
        self.clock = 0
        self.table = table
        rng = np.random.default_rng(0)
        for l in range(l_n):
            self.resident[l, rng.choice(e_n, self.capacity,
                                        replace=False)] = True

    def touch(self, layer, experts) -> None:
        experts = np.atleast_1d(np.asarray(experts, np.int64))
        self.clock += 1
        self.last_used[layer, experts] = self.clock

    def on_event(self, kind: str, t) -> None:
        if kind == "submit":
            if not self.resident[t.layer, t.expert]:
                self.inflight[t.layer, t.expert] = True
        elif kind == "complete":
            self.inflight[t.layer, t.expert] = False
            self.insert(t.layer, t.expert)
        elif kind == "cancel":
            self.inflight[t.layer, t.expert] = False

    def _victim(self, layer: int, exclude: int) -> int:
        cand = np.flatnonzero(self.resident[layer] & ~self.pinned[layer])
        cand = cand[cand != exclude]
        if len(cand) == 0:
            return -1
        ordered = cand[np.argsort(self.last_used[layer, cand],
                                  kind="stable")]
        pool = ordered[:BUDDY_CANDIDATES]
        if len(pool) > 1:
            for e in pool:
                buddies = self.table[layer, e]
                buddies = buddies[buddies >= 0]
                if len(buddies) and self.resident[layer, buddies].any():
                    return int(e)
        return int(pool[0])

    def insert(self, layer: int, expert: int) -> None:
        if self.resident[layer, expert]:
            return
        if int(self.resident[layer].sum()) >= self.capacity:
            v = self._victim(layer, expert)
            if v >= 0:
                self.resident[layer, v] = False
        self.resident[layer, expert] = True
        while int(self.resident[layer].sum()) > self.capacity:
            v = self._victim(layer, expert)
            if v < 0:
                break
            self.resident[layer, v] = False


class _Transfer:
    __slots__ = ("tid", "layer", "expert", "cause", "priority", "fixed",
                 "left", "done_s", "state")

    def __init__(self, tid, layer, expert, nbytes, cause, priority):
        self.tid, self.layer, self.expert = tid, layer, expert
        self.cause, self.priority = cause, priority
        self.fixed, self.left = PCIE_FIXED_S, float(nbytes)
        self.done_s, self.state = -1.0, "queued"

    @property
    def in_flight(self) -> bool:
        return self.state in ("queued", "active")


class Link:
    """The host-to-device link's timeline."""

    def __init__(self, listener):
        self.now = 0.0
        self._queued: list = []
        self._active: list = []
        self._by_key: dict = {}
        self._tid = 0
        self._listener = listener

    def in_flight(self, layer, expert) -> Optional[_Transfer]:
        t = self._by_key.get((layer, expert))
        return t if t is not None and t.in_flight else None

    def submit(self, layer, expert, nbytes, cause) -> _Transfer:
        old = self.in_flight(layer, expert)
        if old is not None:
            if cause == "demand" and old.priority > _PRIO_DEMAND:
                self.escalate(old)
            return old
        prio = _PRIO_DEMAND if cause == "demand" else _PRIO_PREFETCH
        t = _Transfer(self._tid, layer, expert, nbytes, cause, prio)
        self._tid += 1
        self._by_key[(layer, expert)] = t
        heapq.heappush(self._queued, (t.priority, t.tid, t))
        self._listener("submit", t)
        return t

    def escalate(self, t) -> None:
        if not t.in_flight or t.priority <= _PRIO_DEMAND:
            return
        t.priority = _PRIO_DEMAND
        if t.state == "queued":
            heapq.heappush(self._queued, (t.priority, t.tid, t))

    def cancel_stale(self, layer, keep) -> None:
        keep = set(int(e) for e in keep)
        for (l, e), t in list(self._by_key.items()):
            if l == layer and t.cause == "prefetch" and t.in_flight \
                    and e not in keep:
                t.state = "cancelled"
                if t in self._active:
                    self._active.remove(t)
                self._by_key.pop((t.layer, t.expert), None)
                self._listener("cancel", t)

    def _admit(self) -> None:
        requeue = []
        n_pre = sum(1 for t in self._active if t.priority > _PRIO_DEMAND)
        while self._queued:
            prio, _, t = heapq.heappop(self._queued)
            if t.state != "queued" or prio != t.priority:
                continue
            if t.priority > _PRIO_DEMAND and n_pre >= MAX_INFLIGHT_PREFETCH:
                requeue.append(t)
                continue
            t.state = "active"
            self._active.append(t)
            if t.priority > _PRIO_DEMAND:
                n_pre += 1
        for t in requeue:
            heapq.heappush(self._queued, (t.priority, t.tid, t))

    def _serving(self) -> list:
        if not self._active:
            return []
        best = min(t.priority for t in self._active)
        return [t for t in self._active if t.priority == best]

    def _next_dt(self) -> float:
        serving = self._serving()
        if not serving:
            return float("inf")
        streaming = [t for t in serving if t.fixed <= _EPS_S]
        share = PCIE_BW / max(1, len(streaming))
        return max(0.0, min(t.fixed if t.fixed > _EPS_S else t.left / share
                            for t in serving))

    def advance(self, to_time: float) -> None:
        while True:
            self._admit()
            if to_time <= self.now:
                return
            dt = self._next_dt()
            step = min(dt, to_time - self.now)
            serving = self._serving()
            streaming = [t for t in serving if t.fixed <= _EPS_S]
            share = PCIE_BW / max(1, len(streaming))
            for t in serving:
                if t.fixed > _EPS_S:
                    t.fixed = max(0.0, t.fixed - step)
                else:
                    t.left = max(0.0, t.left - share * step)
            self.now += step
            for t in list(serving):
                if t.fixed <= _EPS_S and t.left <= _EPS_B:
                    t.state = "done"
                    t.done_s = self.now
                    self._active.remove(t)
                    self._by_key.pop((t.layer, t.expert), None)
                    self._listener("complete", t)
            if dt == float("inf") and not self._queued:
                self.now = to_time
                return

    def run_until_done(self, t) -> float:
        if t.state == "done":
            return t.done_s
        guard = 0
        while t.in_flight:
            self._admit()
            dt = self._next_dt()
            if dt == float("inf"):
                raise RuntimeError("waiting on a transfer the link lost")
            self.advance(self.now + dt)
            guard += 1
            if guard >= 1_000_000:
                raise RuntimeError("the link's timeline failed to converge")
        return t.done_s


class Predictor:
    """Last step's experts a layer, back-filled by a decayed count."""

    def __init__(self, l_n: int, e_n: int):
        self.prev = [np.array([], np.int64) for _ in range(l_n)]
        self.freq = np.ones((l_n, e_n), np.float64)

    def observe(self, layer, experts) -> None:
        experts = np.asarray(experts, np.int64).reshape(-1)
        self.prev[layer] = np.unique(experts)
        self.freq[layer] *= FREQ_DECAY
        np.add.at(self.freq[layer], experts, 1.0)

    def predict(self, layer, k) -> list:
        p = self.prev[layer][:k]
        if len(p) < k:
            rest = [e for e in np.argsort(-self.freq[layer])[:k]
                    if e not in p]
            p = np.concatenate([p, np.asarray(rest[:k - len(p)], np.int64)])
        return [int(e) for e in np.atleast_1d(p)]


class Replay:
    """The serving state of one run, stepped as the engine steps it, over
    the configuration's MoE layers (``family.moe_layers``; the step's
    modeled compute from ``family.active_params``). ``table`` [M, E, R]
    the buddy lists (for the buddy-aware eviction); ``prefetch_k`` < 0:
    half the cache's capacity."""

    def __init__(self, family, rc: dict, cache_rate: float,
                 table: np.ndarray, prefetch_k: int = -1,
                 lookahead: int = 1):
        self.l_n, self.e_n = family.moe_layers(rc), rc["num_experts"]
        self.cache = Cache(self.l_n, self.e_n, cache_rate,
                           np.asarray(table))
        self.link = Link(self.cache.on_event)
        self.pred = Predictor(self.l_n, self.e_n)
        self.k = (max(1, self.cache.capacity // 2) if prefetch_k < 0
                  else int(prefetch_k))
        self.lookahead = int(lookahead)
        self.nbytes = expert_bytes(rc)
        self.params = family.active_params(rc)

    def residency(self) -> np.ndarray:
        return self.cache.resident.copy()

    def step(self, idx: np.ndarray, missed: np.ndarray,
             active: np.ndarray) -> None:
        """One step: idx [M, T, K] the router's top-k, missed [M, T, K]
        the slots that fetch, active [T] the tokens the step serves."""
        n_active = int(active.sum())
        if n_active == 0:
            return
        cache, link = self.cache, self.link
        per_layer = compute_time(self.params, n_active) / max(1, self.l_n)
        cursor = link.now
        for layer in range(self.l_n):
            link.advance(cursor)
            rows = idx[layer][active]
            used = rows.reshape(-1)
            cache.touch(layer, used)
            self.pred.observe(layer, used)
            res_used = np.unique(used[cache.resident[layer, used]])
            cache.pinned[layer, res_used] = True
            miss_row = np.bincount(rows[missed[layer][active]],
                                   minlength=self.e_n)
            for e in np.flatnonzero(miss_row > 0):
                e = int(e)
                if cache.resident[layer, e]:
                    continue
                t = link.in_flight(layer, e)
                if t is not None:
                    link.escalate(t)
                else:
                    t = link.submit(layer, e, self.nbytes, "demand")
                cursor = max(cursor, link.run_until_done(t))
            cursor += per_layer
            self._prefetch(layer)
            cache.pinned[layer] = False
        link.advance(cursor)

    def _prefetch(self, layer: int) -> None:
        if self.k <= 0:
            return
        tgt = (layer + self.lookahead) % self.l_n
        want = self.pred.predict(tgt, self.k)
        self.link.cancel_stale(tgt, want)
        for e in want:
            if self.cache.resident[tgt, e] or self.cache.inflight[tgt, e]:
                continue
            self.link.submit(tgt, e, self.nbytes, "prefetch")
