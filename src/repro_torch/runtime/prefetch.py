"""Expert prefetch predictors (§2.3 — the systems BuddyMoE complements).

All predictors answer: which experts should layer l's cache hold for the next
step? Their misses are exactly what BuddyMoE absorbs.

  TopFreqPredictor   — historical activation frequency (MoE-Infinity-style).
  PrevStepPredictor  — temporal locality: last step's experts per layer.
  CrossLayerPredictor— gate-signal chaining (Pre-gated/Fate-style): score
                       experts at layer l by P(e | experts used at l-1) from
                       a profiled cross-layer co-usage matrix.
  NoisyOraclePredictor — ground truth corrupted at rate (1-accuracy): the
                       controllable-miss-rate harness for Table 1/2-4 sweeps.

Lookahead API: ``predict_ahead(layer, k, lookahead)`` answers "while layer l
computes, which experts should be in flight for layer l+lookahead?" so the
transfer scheduler can overlap layer l+k prefetches with layer l compute.
The default is the same-layer temporal prediction; CrossLayerPredictor
chains its co-usage matrices ``lookahead`` hops so deeper lookahead has a
real signal (Pre-gated/Fate-style pipelining).

Probability API: ``predict_proba(layer, lookahead, context)`` returns [E]
per-expert MARGINAL P(expert used at the target step) — each entry in
[0, 1], NOT a distribution summing to 1 (a decode step uses many experts,
so the marginals sum to roughly the used-set size). The scale matters:
the serving engine multiplies by the unified miss cost (runtime/costs.py)
to rank prefetch candidates by EXPECTED STALL SAVED, compares the product
against an absolute seconds threshold, and counts worthwhile candidates
for the budget controller — predictors must agree on units or the
threshold filters them inconsistently (NoisyOraclePredictor's ``accuracy``
is the reference: a certain-reuse expert scores ~1, not ~1/k).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class LookaheadMixin:
    """Default lookahead: reuse the per-layer temporal prediction. Default
    probability: flat 0.5 marginal on the top-quarter prediction (any
    predictor gets a usable — if crude — P(use) signal in marginal units;
    concrete classes override with their real posterior)."""

    def predict_ahead(self, layer: int, k: int, lookahead: int = 1,
                      context=None, rng=None) -> np.ndarray:
        return self.predict(layer, k, rng=rng)

    def predict_proba(self, layer: int, lookahead: int = 1,
                      context=None) -> np.ndarray:
        e_n = self.num_experts
        k = max(1, e_n // 4)
        top = np.asarray(self.predict_ahead(layer, k, lookahead=lookahead,
                                            context=context), np.int64)
        p = np.zeros(e_n, np.float64)
        if len(top):
            p[top] = 0.5
        return p


class TopFreqPredictor(LookaheadMixin):
    def __init__(self, num_layers: int, num_experts: int, decay: float = 0.99):
        self.num_experts = num_experts
        self.freq = np.ones((num_layers, num_experts), np.float64)
        self.decay = decay
        # EWMA of the per-step used-set size: converts the frequency SHARE
        # into a per-expert marginal (share x experts-per-step), keeping
        # predict_proba on the same [0, 1]-marginal scale as the oracle
        self._avg_used = 1.0

    def clone_fresh(self) -> "TopFreqPredictor":
        """Same configuration, no learned state (benchmark-run resets)."""
        return TopFreqPredictor(*self.freq.shape, decay=self.decay)

    def observe(self, layer: int, experts) -> None:
        experts = np.asarray(experts, np.int64).reshape(-1)
        self.freq[layer] *= self.decay
        np.add.at(self.freq[layer], experts, 1.0)
        self._avg_used = 0.9 * self._avg_used + 0.1 * len(np.unique(experts))

    def predict(self, layer: int, k: int, rng=None) -> np.ndarray:
        return np.argsort(-self.freq[layer])[:k]

    def predict_proba(self, layer: int, lookahead: int = 1,
                      context=None) -> np.ndarray:
        f = self.freq[layer]
        share = f / max(f.sum(), 1e-30)
        return np.clip(share * self._avg_used, 0.0, 1.0)


class PrevStepPredictor(LookaheadMixin):
    """Temporal-locality blend: most of the mass on last step's experts,
    the rest on the decayed frequency prior."""

    PREV_WEIGHT = 0.7

    def __init__(self, num_layers: int, num_experts: int):
        self.num_experts = num_experts
        self.prev = [np.array([], np.int64) for _ in range(num_layers)]
        self.freq = TopFreqPredictor(num_layers, num_experts)

    def clone_fresh(self) -> "PrevStepPredictor":
        return PrevStepPredictor(*self.freq.freq.shape)

    def observe(self, layer: int, experts) -> None:
        self.prev[layer] = np.unique(np.asarray(experts, np.int64).reshape(-1))
        self.freq.observe(layer, experts)

    def predict(self, layer: int, k: int, rng=None) -> np.ndarray:
        p = self.prev[layer][:k]
        if len(p) < k:   # back-fill with frequency prior
            rest = [e for e in self.freq.predict(layer, k) if e not in p]
            p = np.concatenate([p, np.asarray(rest[:k - len(p)], np.int64)])
        return p

    def predict_proba(self, layer: int, lookahead: int = 1,
                      context=None) -> np.ndarray:
        """Marginal blend: an expert seen last step has ~PREV_WEIGHT chance
        of immediate reuse (temporal locality, NOT divided across the set —
        each prev expert independently carries the marginal); everything
        else falls back to the frequency marginal."""
        p = np.zeros(self.num_experts, np.float64)
        prev = self.prev[layer]
        w = self.PREV_WEIGHT if len(prev) else 0.0
        if len(prev):
            p[prev] = w
        return np.clip(p + (1.0 - w) * self.freq.predict_proba(layer),
                       0.0, 1.0)


class CrossLayerPredictor(LookaheadMixin):
    """P(expert j at layer l | expert i at layer l-1), profiled offline."""

    def __init__(self, num_layers: int, num_experts: int, eps: float = 1e-3):
        self.num_experts = num_experts
        self.eps = eps
        self.C = np.full((num_layers, num_experts, num_experts), eps, np.float64)
        self.prev_set: Optional[np.ndarray] = None
        self.freq = TopFreqPredictor(num_layers, num_experts)

    def clone_fresh(self) -> "CrossLayerPredictor":
        return CrossLayerPredictor(self.C.shape[0], self.C.shape[1],
                                   eps=self.eps)

    def observe_transition(self, layer: int, prev_experts, cur_experts) -> None:
        prev_experts = np.unique(np.asarray(prev_experts, np.int64).reshape(-1))
        cur_experts = np.unique(np.asarray(cur_experts, np.int64).reshape(-1))
        for i in prev_experts:
            self.C[layer, i, cur_experts] += 1.0

    def observe(self, layer: int, experts) -> None:
        self.freq.observe(layer, experts)

    def predict(self, layer: int, k: int, prev_experts=None, rng=None) -> np.ndarray:
        if prev_experts is None or len(np.atleast_1d(prev_experts)) == 0 or layer == 0:
            return self.freq.predict(layer, k)
        prev_experts = np.unique(np.asarray(prev_experts, np.int64).reshape(-1))
        score = self.C[layer, prev_experts].sum(axis=0)
        return np.argsort(-score)[:k]

    def predict_ahead(self, layer: int, k: int, lookahead: int = 1,
                      context=None, rng=None) -> np.ndarray:
        """Chain co-usage matrices ``lookahead`` hops forward: while layer
        ``layer - lookahead`` computes with experts ``context``, score layer
        ``layer``'s experts by propagating the activation indicator through
        C[layer-lookahead+1] .. C[layer] (row-normalised)."""
        s = self._chained_scores(layer, lookahead, context)
        if s is None:
            return self.predict(layer, k)
        return np.argsort(-s)[:k]

    def _chained_scores(self, layer: int, lookahead: int,
                        context) -> Optional[np.ndarray]:
        """Indicator-propagation scores, or None when there is no usable
        context / the chain would start before layer 0 (callers fall back
        to the frequency prior)."""
        if context is None or len(np.atleast_1d(context)) == 0 \
                or lookahead < 1 or layer - lookahead < 0:
            return None
        e_n = self.C.shape[1]
        s = np.zeros(e_n, np.float64)
        s[np.unique(np.asarray(context, np.int64).reshape(-1))] = 1.0
        for m in range(layer - lookahead + 1, layer + 1):
            cm = self.C[m]
            cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-30)
            s = s @ cm
        return s

    def predict_proba(self, layer: int, lookahead: int = 1,
                      context=None) -> np.ndarray:
        # the propagated indicator is already marginal-like: entry j sums
        # P(j | i) over active sources i, so clip rather than renormalize
        # (renormalizing would shrink every marginal by the used-set size)
        s = self._chained_scores(layer, lookahead, context)
        if s is None:
            return self.freq.predict_proba(layer)
        return np.clip(s, 0.0, 1.0)


@dataclasses.dataclass
class PrefetchBudget:
    """How much speculative PCIe traffic the runtime may spend per layer."""
    prefetch_k: int           # experts predicted/issued per target layer
    lookahead: int            # layers ahead the prediction targets
    max_inflight: int         # link-level concurrent-prefetch cap


class AdaptiveBudgetController:
    """Closes the loop between the serving scheduler and the transfer
    runtime: instead of a fixed ``--prefetch-k`` CLI constant, the budget is
    resized every ``window`` steps from two signals —

      * the ledger's stall-attribution DELTAS over the window
        (``stall_breakdown``: demand vs late-prefetch vs overlapped), and
      * the request-queue depth (continuous batching: deeper backlog means
        fuller batches, longer compute slices, more overlap headroom).

    Policy (each adjustment is one step on an integer ladder, so the budget
    cannot oscillate wildly):

      late-prefetch stalls dominate  -> the link cannot land speculation in
          time: SHRINK prefetch_k (fewer, better bets) and DEEPEN lookahead
          (issue earlier so the tail lands before the layer needs it);
      demand stalls dominate         -> speculation is too timid: GROW
          prefetch_k (and let the link cap follow);
      mostly overlapped / idle       -> hold.

    Queue depth sets the ceiling: an empty queue halves the allowed k (the
    speculative bytes would evict still-useful experts for no latency win);
    a deep queue restores the full configured range.

    When the engine ranks prefetches by expected stall saved (the cost
    model's P(use) x miss-cost scores), it reports how many candidates were
    actually WORTHWHILE (positive expected saving); the budget is capped at
    that count so k never pays for transfers whose misses a buddy or
    replica would absorb for free anyway.
    """

    def __init__(self, prefetch_k: int, lookahead: int = 1, *,
                 min_k: int = 1, max_k: int = 16,
                 min_lookahead: int = 1, max_lookahead: int = 4,
                 max_inflight: int = 4, window: int = 8,
                 dominance: float = 1.5, deep_queue: int = 4):
        assert min_k <= prefetch_k <= max_k
        assert min_lookahead <= lookahead <= max_lookahead
        self.budget = PrefetchBudget(prefetch_k, lookahead,
                                     max(1, min(max_inflight, prefetch_k)))
        self.max_inflight_cap = max_inflight
        self.min_k, self.max_k = min_k, max_k
        self.min_lookahead, self.max_lookahead = min_lookahead, max_lookahead
        self.window = max(1, window)
        self.dominance = dominance
        self.deep_queue = deep_queue
        self._steps = 0
        self._last = {"demand_stall_s": 0.0, "late_prefetch_stall_s": 0.0,
                      "overlapped_s": 0.0}
        self.trace: list = []

    # -- observation ----------------------------------------------------
    def observe_step(self, stall_breakdown: dict, queue_depth: int,
                     worthwhile: Optional[int] = None):
        """Call once per engine step. Returns the (possibly updated) budget.
        ``worthwhile``: number of prefetch candidates with positive expected
        stall saved at the last issue (cost-ranked prefetch only)."""
        self._steps += 1
        if self._steps % self.window == 0:
            self.update(stall_breakdown, queue_depth, worthwhile=worthwhile)
        return self.budget

    def update(self, stall_breakdown: dict, queue_depth: int,
               worthwhile: Optional[int] = None) -> PrefetchBudget:
        """Apply one feedback adjustment from cumulative stall attribution
        (deltas are taken against the previous update)."""
        d_demand = stall_breakdown["demand_stall_s"] - \
            self._last["demand_stall_s"]
        d_late = stall_breakdown["late_prefetch_stall_s"] - \
            self._last["late_prefetch_stall_s"]
        self._last = {k: stall_breakdown[k] for k in self._last}

        b = self.budget
        k, la = b.prefetch_k, b.lookahead
        if d_late > self.dominance * max(d_demand, 1e-12):
            # speculation arrives too late: spend less, issue earlier
            k = max(self.min_k, k - 1)
            la = min(self.max_lookahead, la + 1)
        elif d_demand > self.dominance * max(d_late, 1e-12):
            k = min(self._queue_cap(queue_depth), k + 1)
            # lateness is no longer the problem: walk lookahead back toward
            # shallow (prediction accuracy decays with depth)
            la = max(self.min_lookahead, la - 1)
        k = min(k, self._queue_cap(queue_depth))
        if worthwhile is not None:
            # expected-stall-saved ranking found only this many candidates
            # worth the bytes — spending k beyond it buys nothing
            k = min(k, max(self.min_k, int(worthwhile)))
        b.prefetch_k, b.lookahead = k, la
        b.max_inflight = max(1, min(self.max_inflight_cap, k))
        self.trace.append({"step": self._steps, "prefetch_k": k,
                           "lookahead": la,
                           "demand_delta_s": d_demand,
                           "late_delta_s": d_late,
                           "queue_depth": queue_depth,
                           "worthwhile": worthwhile})
        return b

    def _queue_cap(self, queue_depth: int) -> int:
        if queue_depth >= self.deep_queue:
            return self.max_k
        return max(self.min_k, self.max_k // 2)

    # -- actuation ------------------------------------------------------
    def apply(self, engine) -> PrefetchBudget:
        """Push the current budget into a ServeEngine and its transfer
        scheduler (the runtime knobs the budget governs). With a telemetry
        bundle attached to the engine, the applied budget is mirrored to
        gauges and — when it CHANGED — stamped as a trace instant on the
        "engine" track (read-only observation; telemetry=None engines run
        the identical path)."""
        changed = (engine.prefetch_k != self.budget.prefetch_k
                   or engine.lookahead != self.budget.lookahead)
        engine.prefetch_k = self.budget.prefetch_k
        engine.lookahead = self.budget.lookahead
        engine.scheduler.set_prefetch_cap(self.budget.max_inflight)
        tele = getattr(engine, "telemetry", None)
        if tele is not None:
            tele.metrics.gauge("budget_prefetch_k").set(
                self.budget.prefetch_k)
            tele.metrics.gauge("budget_lookahead").set(self.budget.lookahead)
            tele.metrics.gauge("budget_max_inflight").set(
                self.budget.max_inflight)
            if changed and tele.trace is not None:
                tele.trace.instant(
                    "engine", 0, "budget", "budget", engine.scheduler.now,
                    prefetch_k=self.budget.prefetch_k,
                    lookahead=self.budget.lookahead,
                    max_inflight=self.budget.max_inflight)
        return self.budget


class NoisyOraclePredictor(LookaheadMixin):
    """Knows the true next-step experts; corrupts each slot with prob
    (1 - accuracy). Gives direct control of the prefetch-miss rate."""

    def __init__(self, num_layers: int, num_experts: int, accuracy: float = 0.8,
                 seed: int = 0):
        self.num_experts = num_experts
        self.accuracy = accuracy
        self.seed = seed
        self.truth = [np.array([], np.int64) for _ in range(num_layers)]
        self.rng = np.random.default_rng(seed)

    def clone_fresh(self) -> "NoisyOraclePredictor":
        return NoisyOraclePredictor(len(self.truth), self.num_experts,
                                    accuracy=self.accuracy, seed=self.seed)

    def set_truth(self, layer: int, experts) -> None:
        self.truth[layer] = np.unique(np.asarray(experts, np.int64).reshape(-1))

    def observe(self, layer: int, experts) -> None:
        self.set_truth(layer, experts)

    def predict_proba(self, layer: int, lookahead: int = 1,
                      context=None) -> np.ndarray:
        """Each truth expert survives with P = accuracy; the corruption mass
        is spread uniformly (the predictor's actual noise model)."""
        p = np.full(self.num_experts, 0.0, np.float64)
        t = self.truth[layer]
        if len(t):
            p[t] = self.accuracy
            p += (1.0 - self.accuracy) * len(t) / self.num_experts
        return p

    def predict(self, layer: int, k: int, rng=None) -> np.ndarray:
        rng = rng or self.rng
        t = self.truth[layer][:k]
        out, seen, corrupted = [], set(), []
        # corrupted draws can collide with an already-emitted expert; dedup
        # them like the back-fill loop so the prediction stays a k-set
        # (duplicates silently shrank the effective prefetch set below k).
        # Accurate truth draws land first — a colliding corrupted draw must
        # displace ITSELF, not a truth expert, or the realised accuracy
        # drifts below the configured knob.
        for e in t:
            if rng.random() < self.accuracy:
                out.append(int(e))
                seen.add(int(e))          # truth is unique: never collides
            else:
                corrupted.append(int(rng.integers(0, self.num_experts)))
        for e in corrupted:
            if e not in seen:
                out.append(e)
                seen.add(e)
        while len(out) < min(k, self.num_experts):
            e = int(rng.integers(0, self.num_experts))
            if e not in seen:
                out.append(e)
                seen.add(e)
        return np.asarray(out[:k], np.int64)
