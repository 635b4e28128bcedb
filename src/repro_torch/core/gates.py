"""The paper's three sequenced decision metrics (§3.1).

Counterpart of ``repro/core/gates.py``.

1. Token Activating Entropy (TAE, Eq. 1) — per-token substitution tolerance.
2. Expert Distribution gate (Eq. 2)      — batch-level CPU-residency fraction.
3. Buddy Selection Priority Psi (Eq. 3)  — computed in core/substitute.py.
"""
from __future__ import annotations

import math

import torch


def tae_from_logits(topk_logits: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """TAE over the renormalized top-k distribution (Eq. 1). [..., K] ->
    [...] in [0, 1]."""
    k = topk_logits.shape[-1]
    if k <= 1:
        return torch.zeros(topk_logits.shape[:-1], dtype=torch.float32,
                           device=topk_logits.device)
    p = torch.softmax(topk_logits.float() / temperature, dim=-1)
    ent = -(p * torch.log(p.clamp(min=1e-20))).sum(-1)
    return ent / math.log(k)


def prob_margin(topk_probs: torch.Tensor) -> torch.Tensor:
    """m = p_max - p_2nd over the renormalized top-k distribution."""
    if topk_probs.shape[-1] < 2:
        return torch.ones(topk_probs.shape[:-1], dtype=torch.float32,
                          device=topk_probs.device)
    p = torch.sort(topk_probs.float(), dim=-1).values
    return p[..., -1] - p[..., -2]


def token_gate(topk_logits: torch.Tensor, tau: float,
               temperature: float = 1.0,
               margin_gamma: float = 1.0) -> torch.Tensor:
    """True where substitution is ALLOWED (TAE > tau and margin < gamma)."""
    allow = tae_from_logits(topk_logits, temperature) > tau
    if margin_gamma < 1.0:
        p = torch.softmax(topk_logits.float() / temperature, -1)
        allow = allow & (prob_margin(p) < margin_gamma)
    return allow


def distribution_delta(indices: torch.Tensor,
                       resident: torch.Tensor) -> torch.Tensor:
    """delta_l(B) (Eq. 2): fraction of *requested* experts that are
    CPU-resident. indices [T, K]; resident [E] bool."""
    e = resident.shape[0]
    requested = torch.zeros(e, dtype=torch.bool, device=resident.device)
    requested[indices.reshape(-1).long()] = True
    n_req = requested.sum().float().clamp(min=1.0)
    n_cpu = (requested & ~resident).sum().float()
    return n_cpu / n_req


def distribution_gate(indices: torch.Tensor, resident: torch.Tensor,
                      beta: float) -> torch.Tensor:
    """True (scalar) when substitution is ALLOWED (delta < beta)."""
    return distribution_delta(indices, resident) < beta
