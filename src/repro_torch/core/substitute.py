"""Algorithm 1 — Buddy Expert Substitution (plain PyTorch, full contract).

Counterpart of ``repro/core/substitute.py``, ported in full: precedence mode
with the degraded and peer splits, the unified cost mode (five-way argmin,
ties to buddy > degraded > peer > fetch > drop), and the eta/kappa terms of
Psi (Eq. 3):

  for each token t, for each top-k slot k (in rank order):
    e = S[t, k]
    if e not resident and token passes gates and budget rho not exhausted:
      pick the eligible buddy maximizing Psi(j | e, t) among the first H
      ranked buddies; eligible = resident AND not already in U_t.
      Psi = q_{j|e} * (1 + eta * zhat_j(t)) * (1 - kappa * hop(j))
    if no eligible buddy: degraded (quant_ok), then peer (peer_ok), then
    the caller's fetch/drop fallback.

The model's hot path runs precedence mode through the buddy_substitute
kernel (``models.moe.substitute_precedence``); this module is the reference
for every mode and the CPU path for what that kernel does not cover.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import gates
from repro_torch.core.policy import BuddyPolicy


class SubstituteResult(NamedTuple):
    indices: torch.Tensor       # [T, K] int32 — possibly rewritten expert ids
    substituted: torch.Tensor   # [T, K] bool  — slot was replaced by a buddy
    missed: torch.Tensor        # [T, K] bool  — resolved by fetch (or the
    #                             global fallback in precedence mode)
    allowed: torch.Tensor       # [T]   bool  — token passed TAE gate
    dist_ok: torch.Tensor       # []    bool  — batch passed distribution gate
    degraded: torch.Tensor = None  # [T, K] bool — served by the quant tier
    dropped: torch.Tensor = None   # [T, K] bool — dropped by the cost argmin
    peered: torch.Tensor = None    # [T, K] bool — peer-HBM borrow


def _outcome_argmin(cost_b, cost_d, cost_f, cost_r, cost_p=None):
    """Per-slot argmin over the outcome costs, ties to the EARLIER outcome;
    returns the canonical codes (runtime.costs numbering: 0 buddy,
    1 degraded, 2 peer, 3 fetch, 4 drop)."""
    if cost_p is None:
        costs = torch.stack([cost_b, cost_d, cost_f, cost_r], dim=-1)
        codes = torch.tensor([0, 1, 3, 4], dtype=torch.int32,
                             device=cost_b.device)
    else:
        costs = torch.stack([cost_b, cost_d, cost_p, cost_f, cost_r], dim=-1)
        codes = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32,
                             device=cost_b.device)
    return codes[costs.argmin(-1)]          # argmin returns the first min


def split_degraded(miss, experts, quant_ok):
    """(residual_miss, degraded): route quant_ok misses to the tier."""
    if quant_ok is None:
        return miss, torch.zeros_like(miss)
    deg = miss & quant_ok[experts.long()]
    return miss & ~deg, deg


def split_peer(miss, experts, peer_ok):
    """(residual_miss, peered): route peer-resident misses to an ICI borrow
    (after degraded in the precedence chain)."""
    if peer_ok is None:
        return miss, torch.zeros_like(miss)
    peer = miss & peer_ok[experts.long()]
    return miss & ~peer, peer


def substitute(indices: torch.Tensor,
               topk_logits: torch.Tensor,
               resident: torch.Tensor,
               buddy_table: torch.Tensor,
               buddy_q: torch.Tensor,
               policy: BuddyPolicy,
               router_logits: Optional[torch.Tensor] = None,
               hop: Optional[torch.Tensor] = None,
               quant_ok: Optional[torch.Tensor] = None,
               fid_cost: Optional[torch.Tensor] = None,
               fetch_cost: Optional[torch.Tensor] = None,
               peer_ok: Optional[torch.Tensor] = None,
               peer_cost: Optional[torch.Tensor] = None) -> SubstituteResult:
    """indices [T, K] int; topk_logits [T, K] f32; resident [E] bool;
    buddy_table [E, R] int (-1 padded, rank order); buddy_q [E, R] f32;
    router_logits [T, E] (eta term); hop [E] int (negative = not resident,
    clamped to 0); quant_ok / peer_ok [E] bool (precedence mode);
    fid_cost / fetch_cost / peer_cost [E] f32 (cost mode). Same contract as
    the reference."""
    dev = indices.device
    t_n, k_n = indices.shape
    e_n, r_n = buddy_table.shape
    h_n = min(policy.H, r_n)
    cost_mode = policy.miss_policy == "cost"
    if cost_mode and fetch_cost is None:
        raise ValueError("miss_policy='cost' requires fetch_cost [E] "
                         "(expected fetch stall per expert)")
    xr = policy.stall_per_quality
    inf_e = torch.full((e_n,), float("inf"), dtype=torch.float32, device=dev)
    d_cost = fid_cost.float() if fid_cost is not None else inf_e
    f_cost = fetch_cost.float() if fetch_cost is not None else inf_e
    p_cost = peer_cost.float() if peer_cost is not None else None
    r_cost = torch.tensor(xr * policy.drop_loss, dtype=torch.float32,
                          device=dev)
    if hop is not None:
        hop = hop.clamp(min=0)

    idx = indices.long()
    allowed = gates.token_gate(topk_logits, policy.tau, policy.temperature,
                               policy.margin_gamma)                      # [T]
    dist_ok = gates.distribution_gate(indices, resident, policy.beta)    # []

    if policy.mode == "none":
        miss = ~resident[idx]
        if cost_mode:
            out = _outcome_argmin(
                torch.full(idx.shape, float("inf"), device=dev),
                d_cost[idx], f_cost[idx], r_cost.expand(idx.shape),
                None if p_cost is None else p_cost[idx])
            return SubstituteResult(indices, torch.zeros_like(miss),
                                    miss & (out == 3), allowed, dist_ok,
                                    miss & (out == 1), miss & (out == 4),
                                    miss & (out == 2))
        miss, deg = split_degraded(miss, idx, quant_ok)
        miss, peer = split_peer(miss, idx, peer_ok)
        return SubstituteResult(indices, torch.zeros_like(miss), miss,
                                allowed, dist_ok, deg, torch.zeros_like(miss),
                                peer)

    gate = allowed & dist_ok                                             # [T]
    if policy.eta != 0.0 and router_logits is not None:
        zr = router_logits.float()
        # population std (ddof 0), as jnp.std
        zhat = (zr - zr.mean(-1, keepdim=True)) / (
            zr.std(-1, keepdim=True, correction=0) + 1e-6)
    else:
        zhat = None

    new_idx = idx.clone()
    z = torch.zeros((t_n, k_n), dtype=torch.bool, device=dev)
    substituted, missed, degraded = z.clone(), z.clone(), z.clone()
    dropped, peered = z.clone(), z.clone()
    budget = torch.where(gate, policy.rho, 0)
    cand_all = buddy_table[:, :h_n].long()
    q_all = buddy_q[:, :h_n].float()
    tie = torch.arange(h_n, dtype=torch.float32, device=dev) * 1e-7

    for k in range(k_n):
        e = new_idx[:, k]
        miss_k = ~resident[e]
        can_sub = gate & (budget > 0)
        cand = cand_all[e]                                               # [T, H]
        valid = cand >= 0
        cand_safe = cand.clamp(min=0)
        in_row = (cand_safe[:, :, None] == new_idx[:, None, :]).any(-1)
        elig = valid & resident[cand_safe] & ~in_row
        psi = q_all[e]
        if zhat is not None:
            psi = psi * (1.0 + policy.eta * zhat.gather(1, cand_safe))
        if policy.kappa != 0.0 and hop is not None:
            psi = psi * (1.0 - policy.kappa * hop[cand_safe].float())
        psi = psi - tie                  # argmax == lowest rank on equal Psi
        psi = torch.where(elig, psi, float("-inf"))
        best = psi.argmax(-1, keepdim=True)
        found = elig.gather(1, best)[:, 0]
        buddy = cand_safe.gather(1, best)[:, 0]
        psi_best = psi.gather(1, best)[:, 0]

        if cost_mode:
            cost_b = torch.where(can_sub & found,
                                 xr * (1.0 - psi_best.clamp(0.0, 1.0)),
                                 float("inf"))
            out = _outcome_argmin(cost_b, d_cost[e], f_cost[e],
                                  r_cost.expand(t_n),
                                  None if p_cost is None else p_cost[e])
            do_sub = miss_k & (out == 0)
            deg_col = miss_k & (out == 1)
            peer_col = miss_k & (out == 2)
            res_miss = miss_k & (out == 3)
            dropped[:, k] = miss_k & (out == 4)
            new_col = torch.where(do_sub, buddy, e)
        else:
            do_sub = miss_k & can_sub & found
            new_col = torch.where(do_sub, buddy, e)
            res_miss = ~resident[new_col] & ~do_sub
            res_miss, deg_col = split_degraded(res_miss, new_col, quant_ok)
            res_miss, peer_col = split_peer(res_miss, new_col, peer_ok)
        new_idx[:, k] = new_col
        substituted[:, k] = do_sub
        missed[:, k] = res_miss
        degraded[:, k] = deg_col
        peered[:, k] = peer_col
        budget = budget - do_sub.long()

    return SubstituteResult(new_idx.to(torch.int32), substituted, missed,
                            allowed, dist_ok, degraded, dropped, peered)
