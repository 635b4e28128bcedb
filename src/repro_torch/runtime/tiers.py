"""Tiered expert store — compressed resident replicas as a third
prefetch-failure fallback.

On a prefetch miss the runtime previously had exactly two outcomes: buddy
substitution (accuracy cost, core/substitute.py) or demand fetch / drop
(latency or accuracy cliff, runtime/transfers.py). Following MoBiLE
(big-little experts) and MELINOE (compressed memory-efficient experts), this
module adds a third regime: split the per-layer HBM expert budget between

  full tier   cache slots holding full-precision experts (runtime/cache.py,
              the existing ExpertCache — fetch/evict over PCIe), and
  quant tier  an ALWAYS-RESIDENT int8/int4 per-channel-quantized replica of
              every one of the L x E experts (core/quantize.py numerics),

so a miss whose buddy search fails can be computed immediately at degraded
fidelity instead of stalling the layer or dropping the expert. The miss
decision tree becomes four-way: buddy / degraded / fetch / drop.

Degrade-vs-wait is scored per (layer, expert) each step: the expected stall
(the transfer timeline's in-flight ETA for a late prefetch, the full modeled
transfer time for a cold miss) is traded against the replica's calibrated
fidelity loss via ``stall_per_fidelity`` — the seconds of stall that justify
one unit of relative round-trip weight error. A nearly-landed prefetch is
waited for (tail < threshold); a cold miss degrades.

Budget semantics: at EQUAL total HBM budget (``cache_rate`` x E full-precision
experts per layer), the quant tier displaces full cache slots —
slots = floor((budget - n_covered * replica_bytes) / expert_bytes). When the
tier alone exceeds the budget (int8 at cache_rate 0.5 with scale overhead),
one mandatory full slot is kept and the split is reported as clamped.

Partial coverage (``coverage`` < 1.0): replicate only the top-P(use)
``ceil(coverage * E)`` experts per layer and spend the freed bytes on full
cache slots — the knee of the accuracy-vs-stall frontier sits where the
replicas cover the hot tail that the cache misses, not the cold experts the
router never picks. Which experts are covered defaults to the lowest ids
(deterministic) until ``set_coverage`` re-picks the top experts per layer
from activity statistics (profiling recorder counts or predictor
frequencies). Uncovered experts report infinite fidelity — the cost model
(runtime/costs.py) and the precedence quant_ok mask both then exclude them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.quantize import TIER_BITS  # noqa: F401  (re-export: the
#   tier-name -> bits mapping has ONE source of truth in core/quantize.py)
from repro_torch.runtime.cache import ExpertCache
from repro_torch.runtime.memory import expert_nbytes, quant_expert_nbytes


class TieredExpertStore:
    """Two-tier expert storage at one fixed HBM budget.

    The budget ``cache_rate * E * full_bytes`` per layer is split between
    a FULL tier — an ``ExpertCache`` of ``cache_slots`` full-precision
    experts, fetched/evicted over the transfer timeline — and a QUANT
    tier: always-resident int8/int4 per-channel-quantized replicas of the
    ``n_covered`` covered experts per layer (``slots = ⌊(budget −
    n_covered·replica_bytes)/full_bytes⌋``, clamped to ≥ 1 slot). A miss
    on a covered expert can be computed immediately against its replica —
    zero transfer, zero stall — at a calibrated per-expert fidelity cost
    (``fidelity``; uncovered experts report ``inf`` so no policy ever
    degrades them).

    ``covered`` starts as the lowest expert ids; ``set_coverage(activity)``
    re-points it at the per-layer top-``n_covered`` by any activity
    ranking — the profiling draw at startup, or live traffic EMAs when a
    ``PlacementController`` drives it. Note the self-inhibition this
    store creates: a covered miss is absorbed by the replica, so nothing
    ever promotes that expert into a full-precision slot — repairing that
    (replication, degraded-then-upgrade) is the caller's job.

    ``quant_ok(...)`` is the per-step degrade decision (expected stall
    saved vs ``stall_per_fidelity`` × fidelity lost); ``degraded_tokens``
    counts slots actually served degraded; ``summary()`` reports the
    budget split, coverage, and counters for
    ``ServeEngine.summary()["tier"]``."""

    def __init__(self, num_layers: int, num_experts: int, cache_rate: float,
                 *, bits: int = 8, d_model: int, d_ff: int,
                 dtype_bytes: int = 2, stall_per_fidelity: float = 0.05,
                 coverage: float = 1.0,
                 policy: str = "lru", num_partitions: int = 1, seed: int = 0,
                 buddy_table: Optional[np.ndarray] = None,
                 buddy_candidates: int = 4):
        assert bits in (4, 8)
        assert 0.0 < coverage <= 1.0, "coverage: fraction of experts " \
            "replicated per layer (top-P(use) once set_coverage is called)"
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.bits = bits
        self.stall_per_fidelity = float(stall_per_fidelity)
        self.coverage = float(coverage)
        self.n_covered = max(1, min(num_experts,
                                    int(np.ceil(coverage * num_experts))))
        self.full_bytes = expert_nbytes(d_model, d_ff, dtype_bytes)
        self.replica_bytes = quant_expert_nbytes(d_model, d_ff, bits)

        # -- budget split (per layer, equal total HBM budget) ------------
        # partial coverage replicates only n_covered experts; the freed
        # replica bytes become additional full-precision cache slots
        budget = cache_rate * num_experts * self.full_bytes
        slots = int((budget - self.n_covered * self.replica_bytes)
                    // self.full_bytes)
        self.clamped = slots < 1
        slots = max(1, min(num_experts, slots))
        self.cache_slots = slots
        self.budget_bytes = int(round(budget))
        self.quant_bytes = num_layers * self.n_covered * self.replica_bytes
        # which experts hold a replica: lowest ids until set_coverage picks
        # the top-activity set per layer (budget depends only on the COUNT)
        self.covered = np.zeros((num_layers, num_experts), bool)
        self.covered[:, :self.n_covered] = True

        self.cache = ExpertCache(num_layers, num_experts,
                                 slots / num_experts, policy=policy,
                                 num_partitions=num_partitions, seed=seed,
                                 buddy_table=buddy_table,
                                 buddy_candidates=buddy_candidates)
        # calibrated per-expert relative round-trip error; inf until the
        # engine attaches real scores = "never degrade" (conservative)
        self.fidelity = np.full((num_layers, num_experts), np.inf)
        self.degraded_tokens = 0
        # optional runtime.telemetry.Telemetry bundle: note_degraded ticks
        # a counter and set_coverage stamps a trace instant when attached;
        # None (the default) leaves every path bit-identical
        self.telemetry = None

    # -- calibration ----------------------------------------------------
    def attach_fidelity(self, fidelity: np.ndarray) -> None:
        fidelity = np.asarray(fidelity, np.float64)
        assert fidelity.shape == (self.num_layers, self.num_experts), \
            f"fidelity shape {fidelity.shape} != (L, E)"
        self.fidelity = fidelity

    def set_coverage(self, activity: np.ndarray) -> None:
        """Re-pick the covered set: the top-``n_covered`` experts per layer
        by ``activity`` [L, E] (P(use) proxy — profiling counts, predictor
        frequencies). The budget split is unchanged (it depends only on the
        count); only WHICH experts may serve degraded moves."""
        activity = np.asarray(activity, np.float64)
        assert activity.shape == (self.num_layers, self.num_experts)
        self.covered[:] = False
        top = np.argsort(-activity, axis=1)[:, :self.n_covered]
        np.put_along_axis(self.covered, top, True, axis=1)
        if self.telemetry is not None:
            self.telemetry.metrics.counter("tier_coverage_repicks").inc()

    def effective_fidelity(self, layer: Optional[int] = None) -> np.ndarray:
        """Fidelity with uncovered experts masked to inf — the form the
        cost model consumes (inf = no usable replica). [L, E], or one
        layer's [E] row when ``layer`` is given (the per-layer prefetch
        ranking must not rebuild the full matrix each call). This method is
        the single owner of the uncovered-masking rule."""
        if layer is None:
            return np.where(self.covered, self.fidelity, np.inf)
        return np.where(self.covered[layer], self.fidelity[layer], np.inf)

    # -- the degrade-vs-wait decision -----------------------------------
    def degraded_ok(self, resident: np.ndarray,
                    eta_s: np.ndarray) -> np.ndarray:
        """[L, E] bool: misses worth serving from the quant tier this step.

        resident [L, E]: the cache's usable mask (residents never degrade);
        eta_s [L, E]: expected stall of fetching each expert instead — the
        in-flight transfer's optimistic ETA (TransferScheduler.eta_s) or the
        full modeled transfer time for a cold miss. Degrade iff the stall
        saved buys the fidelity loss: eta >= fidelity * stall_per_fidelity."""
        resident = np.asarray(resident, bool)
        eta_s = np.asarray(eta_s, np.float64)
        assert eta_s.shape == resident.shape == self.fidelity.shape
        fid = self.effective_fidelity()
        worth = np.isfinite(fid) & (eta_s >= fid * self.stall_per_fidelity)
        return ~resident & worth

    # -- accounting ------------------------------------------------------
    def note_degraded(self, n_slots: int) -> None:
        self.degraded_tokens += int(n_slots)
        if self.telemetry is not None:
            self.telemetry.metrics.counter("tier_degraded_slots").inc(
                int(n_slots))

    def reset_counters(self) -> None:
        self.degraded_tokens = 0

    def budget_split(self) -> dict:
        """Where the per-layer HBM expert budget went."""
        cache_bytes = self.cache_slots * self.full_bytes
        tier_bytes = self.n_covered * self.replica_bytes
        return {
            "budget_bytes_per_layer": self.budget_bytes,
            "quant_bytes_per_layer": tier_bytes,
            "cache_bytes_per_layer": cache_bytes,
            "cache_slots_per_layer": self.cache_slots,
            "quant_frac": tier_bytes / max(1, self.budget_bytes),
            "coverage": self.coverage,
            "covered_per_layer": self.n_covered,
            "clamped": bool(self.clamped),
        }

    def summary(self) -> dict:
        return {
            "bits": self.bits,
            "stall_per_fidelity": self.stall_per_fidelity,
            "degraded_tokens": self.degraded_tokens,
            "quant_bytes": self.quant_bytes,
            "tier_budget_split": self.budget_split(),
            "mean_fidelity_loss": float(np.mean(
                self.fidelity[np.isfinite(self.fidelity)]))
            if np.isfinite(self.fidelity).any() else None,
        }
