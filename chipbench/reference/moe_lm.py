"""What every family's plain reference shares (``chipbench/families/``):
the matmuls in exact float32 or in the TF32 control, the router's top-k
in the reference's order, the top-k softmax, the token activating
entropy, RMSNorm, Algorithm 1's buddy substitution in its precedence form
(fetch on a miss without a buddy), and the routing state the served
tokens read. None of it knows a layer's attention or how many layers
there are, and none of it imports the program.

float32 with TF32 off, or, for the control, every matmul's operands
rounded to TF32 (10 mantissa bits) and accumulated in float32, as the
tensor cores' TF32 mode computes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (round half away on the 13 low
    mantissa bits), kept in float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """The reference's matmuls: exact float32, or the TF32 control."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, t):
        return tf32_round(t.float()) if self.tf32 else t.float()

    def mm(self, a, b):
        return torch.matmul(self._r(a), self._r(b))

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self._r(a), self._r(b))


def order_key(z: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in float order with -0.0 below +0.0."""
    b = z.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def topk(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[N, E] -> [N, K] int64: descending, ties to the smaller index."""
    return torch.sort(order_key(logits.float()), dim=-1, descending=True,
                      stable=True).indices[:, :k]


def topk_probs(vals: torch.Tensor) -> torch.Tensor:
    """Renormalized softmax over the top-k logits [N, K] (rank order)."""
    p = torch.exp(vals - vals[:, :1])
    return p / p.sum(-1, keepdim=True).clamp(min=1e-20)


def tae(p: torch.Tensor) -> torch.Tensor:
    """Token activating entropy over the top-k probabilities, in [0, 1]."""
    k = p.shape[-1]
    if k <= 1:
        return torch.zeros(p.shape[0], device=p.device)
    return -(p * torch.log(p.clamp(min=1e-20))).sum(-1) / math.log(k)


def rmsnorm(x, g, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def substitute(idx, gate, resident, table, q, *, rho: int, h: int):
    """Algorithm 1, precedence form with fetch as the fallback, per token:
    idx [N, K] (rank order), gate [N] bool (token and distribution gates
    passed), resident [N, E] bool (the step's residency of each token),
    table / q [E, R] (buddy ids, -1 padded, and q_{j|i}). Returns the
    experts the slots compute, [N, K]: a missed slot without a buddy
    keeps its expert (fetched)."""
    h = min(h, table.shape[1])
    new = idx.clone()
    budget = torch.where(gate, rho, 0)
    cand_all = table[:, :h].long()
    q_all = q[:, :h].float()
    tie = torch.arange(h, dtype=torch.float32, device=idx.device) * 1e-7
    for k in range(idx.shape[1]):
        e = new[:, k]
        miss_k = ~resident.gather(1, e[:, None])[:, 0]
        can_sub = gate & (budget > 0)
        cand = cand_all[e]
        valid = cand >= 0
        cs = cand.clamp(min=0)
        in_row = (cs[:, :, None] == new[:, None, :]).any(-1)
        elig = valid & resident.gather(1, cs) & ~in_row
        psi = torch.where(elig, q_all[e] - tie, float("-inf"))
        best = psi.argmax(-1, keepdim=True)
        found = elig.gather(1, best)[:, 0]
        buddy = cs.gather(1, best)[:, 0]
        do_sub = miss_k & can_sub & found
        new[:, k] = torch.where(do_sub, buddy, e)
        budget = budget - do_sub.long()
    return new


@dataclass
class Routing:
    """What the routing of the served tokens reads from the serving state,
    per MoE layer (M of them: the family's ``moe_layers``) and token: the
    residency of the step that computed the token, the distribution gate
    of that step's batch, and the buddy tables. ``follow`` [M, N, K] is
    the router top-k to continue with (the program's, judged against the
    reference's own); None: the reference's own."""
    resident: torch.Tensor     # [M, N, E] bool
    dist_ok: torch.Tensor      # [M, N] bool
    table: torch.Tensor        # [M, E, R] int
    q: torch.Tensor            # [M, E, R] f32
    tau: float
    rho: int
    h: int
    substitute: bool = True
    follow: Optional[torch.Tensor] = None
