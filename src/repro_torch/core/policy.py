"""BuddyMoE runtime policy (hashable, frozen)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuddyPolicy:
    """Deployment-time knobs (paper §3.1/§3.4, §5.1).

    tau:    TAE gate threshold — forbid substitution when TAE <= tau.
    beta:   distribution gate — bypass substitution when delta >= beta.
    rho:    max substitutions per token (paper §5's replacement budget).
    H:      max buddy search rank (Algorithm 1).
    eta:    local router-logit compatibility weight in Psi (Eq. 3).
    kappa:  cross-partition hop penalty weight in Psi (Eq. 3).
    temperature: optional TAE smoothing temperature (§3.1, T in [0.8, 1.2]).
    margin_gamma: optional probability-margin co-gate (>=1.0 disables).
    fallback: what to do on a miss with no eligible buddy:
              'fetch' — synchronous transfer of the true expert (lossless,
              slow; the paper's Original behavior), or 'drop' — skip the
              expert and renormalize (baseline MoE drop policy).
    mode:   'buddy' (the paper), 'random' (random-resident baseline),
            'none' (no substitution — Original baseline).
    quant_tier: precision of the always-resident compressed replica tier
            ('off' | 'int8' | 'int4', runtime/tiers.py). When on, a missed
            slot whose per-step quant_ok mask allows it is computed from the
            low-precision replica ('degraded') INSTEAD of falling back — the
            four-way miss decision becomes buddy / degraded / fetch / drop.
            'off' runs the exact pre-tier path.
    miss_policy: how the four miss outcomes are resolved.
            'precedence' — the fixed chain (buddy, then degraded, then the
            global ``fallback``), the pre-cost-model behavior.
            'cost' — per-slot argmin of the unified expected-cost model
            (runtime/costs.py): every outcome is scored in stall-seconds via
            ``stall_per_quality`` and the cheapest wins, so a high-q buddy
            can beat a low-fidelity replica and vice versa. The per-slot
            scorer owns the fetch/drop choice, so ``fallback`` must stay at
            its 'fetch' default (it is unused).
    stall_per_quality: the single exchange rate (seconds of stall worth one
            unit of quality loss) that puts buddy Psi loss, replica
            fidelity error, and drop renormalization loss on the same scale
            as fetch stall. Generalizes the tier's ``stall_per_fidelity``.
    drop_loss: quality units lost by dropping a routed slot and
            renormalizing (the whole slot's mixture contribution; 1.0 makes
            drop the outcome of last resort).
    use_fused_dispatch: collapse the decode step's outcome-diverse dispatch
            (full-precision expert FFN + buddy-replica einsum + separate
            degraded dequant pass) into ONE dispatch that computes every
            outcome class with the right weights exactly once — slots are
            binned by (resolved expert, class) into a single grouped launch
            (kernels/grouped_ffn.py). False (default) runs the unfused
            dispatch paths.
    """
    tau: float = 0.2
    beta: float = 0.6
    rho: int = 3
    H: int = 8
    eta: float = 0.0
    kappa: float = 0.0
    temperature: float = 1.0
    margin_gamma: float = 1.0
    fallback: str = "fetch"
    mode: str = "buddy"
    quant_tier: str = "off"
    miss_policy: str = "precedence"
    stall_per_quality: float = 0.05
    drop_loss: float = 1.0
    use_fused_dispatch: bool = False

    def __post_init__(self):
        assert self.fallback in ("fetch", "drop")
        assert self.mode in ("buddy", "random", "none")
        assert self.quant_tier in ("off", "int8", "int4")
        assert self.miss_policy in ("precedence", "cost")
        assert self.miss_policy == "precedence" or self.fallback == "fetch", \
            "miss_policy='cost' scores fetch vs drop per slot — the global " \
            "fallback knob is subsumed; leave it at 'fetch'"
        assert self.stall_per_quality > 0.0
        assert self.drop_loss >= 0.0
        assert self.rho >= 0 and self.H >= 1


ORIGINAL = BuddyPolicy(mode="none", fallback="fetch")
DROP = BuddyPolicy(mode="none", fallback="drop")
