"""Plain PyTorch reference of the MoE transformer the cells serve: RMSNorm,
causal attention with RoPE and grouped KV heads (and a sliding window),
the router's top-k with the renormalized top-k softmax, Algorithm 1's
buddy substitution in its precedence form (fetch on a miss without a
buddy), the SwiGLU experts and shared experts, and the LM head.

It imports nothing of the program. It reads the weights by the names of
``chipbench.weights`` and the sizes from a configuration's ``as_run``
group. Tokens are a flat list of sequences; every sequence is attended
on its own. float32 with TF32 off, or, for the control, every matmul's
operands rounded to TF32 (10 mantissa bits) and accumulated in float32,
as the tensor cores' TF32 mode computes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


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


def rope(x, pos, theta):
    """x [n, heads, hd]; pos [n] absolute positions."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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
    per layer and token: the residency of the step that computed the
    token, the distribution gate of that step's batch, and the buddy
    tables. ``follow`` [L, N, K] is the router top-k to continue with (the
    program's, judged against the reference's own); None: the
    reference's own."""
    resident: torch.Tensor     # [L, N, E] bool
    dist_ok: torch.Tensor      # [L, N] bool
    table: torch.Tensor        # [L, E, R] int
    q: torch.Tensor            # [L, E, R] f32
    tau: float
    rho: int
    h: int
    substitute: bool = True
    follow: Optional[torch.Tensor] = None


class Reference:
    def __init__(self, params: dict, rc: dict, arith: Optional[Arith] = None):
        self.p = params
        self.rc = rc
        self.a = arith or Arith()

    def _g(self, name, layer=None):
        node = self.p
        keys = name.split(".")
        if keys[0] == "groups":
            node = self.p["groups"][0]
            keys = keys[1:]
        for k in keys:
            node = node[k]
        return node if layer is None else node[layer]

    # -- blocks ---------------------------------------------------------
    def attention(self, layer, xn, seqs):
        """xn [N, D]; seqs: list of (start, positions [n] tensor)."""
        rc, a = self.rc, self.a
        h, kv, hd = rc["num_heads"], rc["num_kv_heads"], rc["head_dim"]
        g = h // kv
        wq, wk, wv, wo = (self._g(f"groups.attn.{n}", layer)
                          for n in ("wq", "wk", "wv", "wo"))
        window = rc.get("sliding_window") or 0
        out = torch.empty_like(xn)
        for start, pos in seqs:
            n = pos.shape[0]
            x = xn[start:start + n]
            q = rope(a.mm(x, wq).reshape(n, h, hd), pos, rc["rope_theta"])
            k = rope(a.mm(x, wk).reshape(n, kv, hd), pos, rc["rope_theta"])
            v = a.mm(x, wv).reshape(n, kv, hd)
            s = a.einsum("qkgh,ckh->kgqc", q.reshape(n, kv, g, hd), k) \
                * (hd ** -0.5)
            qp, cp = pos[:, None], pos[None, :]
            ok = cp <= qp
            if window:
                ok = ok & (cp > qp - window)
            s = torch.where(ok, s, -1e30)
            pr = torch.softmax(s, dim=-1)
            o = a.einsum("kgqc,ckh->qkgh", pr, v).reshape(n, h * hd)
            out[start:start + n] = a.mm(o, wo)
        return out

    def ffn(self, x, w1, w3, w2):
        a = self.a
        return a.mm(F.silu(a.mm(x, w1)) * a.mm(x, w3), w2)

    def moe(self, layer, xn, route: Optional[Routing], capacity=None,
            follow=None):
        """The MoE layer over flat tokens xn [N, D]. ``route`` None: the
        profiling forward (top-k only, continued with ``follow`` [L, N, K]
        where given); ``capacity`` (rows, cap) then drops slots past cap
        per row and expert, as the program's row-local capacity dispatch.
        Returns (y, the reference's own top-k)."""
        rc = self.rc
        k_n, e_n = rc["top_k"], rc["num_experts"]
        logits = self.a.mm(xn, self._g("groups.moe.router", layer))
        own = topk(logits, k_n)
        if route is not None:
            follow = route.follow
        idx = own if follow is None else follow[layer].long()
        p = topk_probs(logits.gather(1, idx))
        new = idx
        if route is not None and route.substitute:
            gate = (tae(p) > route.tau) & route.dist_ok[layer]
            new = substitute(
                idx, gate, route.resident[layer], route.table[layer],
                route.q[layer], rho=route.rho, h=route.h)
        w = p
        if capacity is not None:
            rows, cap = capacity
            per_row = new.reshape(rows, -1)
            onehot = F.one_hot(per_row, e_n)
            pos_in = (onehot.cumsum(1) * onehot).sum(-1) - 1
            w = torch.where((pos_in < cap).reshape(new.shape), w, 0.0)
        y = torch.zeros_like(xn, dtype=torch.float32)
        w1, w3, w2 = (self._g(f"groups.moe.{n}", layer)
                      for n in ("w1", "w3", "w2"))
        for e in torch.unique(new).tolist():
            tok, slot = torch.nonzero(new == e, as_tuple=True)
            out = self.ffn(xn[tok], w1[e], w3[e], w2[e])
            y.index_add_(0, tok, out * w[tok, slot][:, None])
        if rc["num_shared_experts"]:
            y = y + self.ffn(xn, *(self._g(f"groups.moe.shared.{n}", layer)
                                   for n in ("w1", "w3", "w2")))
        return y, own

    # -- whole model ----------------------------------------------------
    def forward(self, tokens, seqs, route: Optional[Routing] = None,
                head_at=None, capacity=None, follow=None):
        """tokens [N] (flat sequences); seqs [(start, positions)];
        head_at [M] token indices whose logits to return (None: all);
        ``follow`` the top-k to continue with where ``route`` is None.
        Returns (logits [M, V], the reference's own top-k [L, N, K])."""
        rc = self.rc
        eps = rc["norm_eps"]
        x = self._g("embed")[tokens].float()
        own_topk = []
        for layer in range(rc["num_layers"]):
            x = x + self.attention(
                layer, rmsnorm(x, self._g("groups.ln1", layer), eps), seqs)
            y, own = self.moe(
                layer, rmsnorm(x, self._g("groups.ln2", layer), eps), route,
                capacity, follow)
            x = x + y
            own_topk.append(own)
        if head_at is not None:
            x = x[head_at]
        logits = self.a.mm(rmsnorm(x, self._g("final_norm"), eps),
                           self._g("lm_head"))
        return logits, torch.stack(own_topk)
