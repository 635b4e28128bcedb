"""BuddyMoE core — the paper's primary contribution.

Offline: coactivation (profiling, Eq. 4) -> buddies (CFT lists, Eqs. 5-6).
Online:  gates (TAE Eq. 1, distribution Eq. 2) -> substitute (Alg. 1 + Psi Eq. 3),
parameterized by policy.BuddyPolicy.
"""
from repro_torch.core.buddies import (BuddyTables, alpha_schedule,
                                      build_buddy_lists, cft_prefix_size,
                                      list_size_stats, load_tables,
                                      save_tables)
from repro_torch.core.coactivation import CoactivationRecorder
from repro_torch.core.gates import (calibrate_tau, distribution_delta,
                                    distribution_gate, prob_margin,
                                    tae_from_logits, tae_from_probs,
                                    token_gate)
from repro_torch.core.policy import DROP, ORIGINAL, BuddyPolicy
from repro_torch.core.quantize import (TIER_BITS, attach_quant_tier,
                                       dequantize, expert_fidelity,
                                       quantize_expert_ffn,
                                       quantize_per_channel)
from repro_torch.core.substitute import (SubstituteResult, make_random_table,
                                         substitute)

__all__ = [
    "BuddyTables", "alpha_schedule", "build_buddy_lists", "cft_prefix_size",
    "list_size_stats", "load_tables", "save_tables", "CoactivationRecorder",
    "calibrate_tau", "distribution_delta", "distribution_gate",
    "prob_margin", "tae_from_logits", "tae_from_probs", "token_gate", "DROP",
    "ORIGINAL", "BuddyPolicy", "TIER_BITS", "attach_quant_tier",
    "dequantize", "expert_fidelity", "quantize_expert_ffn",
    "quantize_per_channel", "SubstituteResult", "make_random_table",
    "substitute"]
