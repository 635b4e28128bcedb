"""Family ``moe_gqa``: a decoder in which every layer is causal attention
with RoPE over grouped KV heads (and a sliding window, where one is set),
then a MoE block: the router's top-k with the renormalized top-k softmax,
SwiGLU experts, and shared experts beside them. Mixtral's block.

Weights, in the port's ``params`` layout (L layers, E experts, D model
width, F expert width, H / KV heads of width hd, V vocabulary; S shared
experts of width F each), one group of L layers::

    embed [V, D]; final_norm [D]; lm_head [D, V]
    groups[0]: ln1, ln2 [L, D]; attn wq [L, D, H*hd], wk / wv [L, D, KV*hd],
               wo [L, H*hd, D]; moe router [L, D, E], w1 / w3 [L, E, D, F],
               w2 [L, E, F, D], shared w1 / w3 [L, D, S*F], w2 [L, S*F, D]

The reference imports nothing of the program; the interface is
``chipbench/families/__init__.py``'s.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from chipbench.reference.moe_lm import (Arith, Routing, rmsnorm, substitute,
                                        tae, topk, topk_probs)

# the run-time sizes the program's config must equal, per as_run key
CFG_KEYS = {"d_model": "d_model", "num_heads": "num_heads",
            "num_kv_heads": "num_kv_heads", "head_dim": "head_dim",
            "vocab_size": "vocab_size", "num_layers": "num_layers",
            "num_experts": "moe.num_experts", "top_k": "moe.top_k",
            "expert_d_ff": "moe.d_ff",
            "num_shared_experts": "moe.num_shared_experts",
            "norm_eps": "norm_eps", "rope_theta": "rope_theta",
            "sliding_window": "sliding_window", "dtype": "dtype"}

# the launcher's --reduced configs
TINY = {
    "mixtral-8x22b": {
        "d_model": 256, "num_heads": 4, "num_kv_heads": 2, "head_dim": 64,
        "vocab_size": 512, "num_layers": 2, "num_experts": 4, "top_k": 2,
        "expert_d_ff": 512, "num_shared_experts": 0, "norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 128, "dtype": "float32"},
}


def shapes(rc: dict) -> dict:
    """{leaf path: (shape, scale)}; scale None marks a norm gain."""
    d, v = rc["d_model"], rc["vocab_size"]
    n_l, e, f = rc["num_layers"], rc["num_experts"], rc["expert_d_ff"]
    hd = rc["head_dim"]
    q_w, kv_w = rc["num_heads"] * hd, rc["num_kv_heads"] * hd

    def dense(i, o):
        return (2.0 / (i + o)) ** 0.5

    out = {
        "embed": ((v, d), 0.02),
        "final_norm": ((d,), None),
        "lm_head": ((d, v), dense(d, v)),
        "groups.0.ln1": ((n_l, d), None),
        "groups.0.ln2": ((n_l, d), None),
        "groups.0.attn.wq": ((n_l, d, q_w), dense(d, q_w)),
        "groups.0.attn.wk": ((n_l, d, kv_w), dense(d, kv_w)),
        "groups.0.attn.wv": ((n_l, d, kv_w), dense(d, kv_w)),
        "groups.0.attn.wo": ((n_l, q_w, d), dense(q_w, d)),
        "groups.0.moe.router": ((n_l, d, e), dense(d, e)),
        # the scale of one [D, E*F] matrix, as the program's own init
        "groups.0.moe.w1": ((n_l, e, d, f), (2.0 / (d + e * f)) ** 0.5),
        "groups.0.moe.w3": ((n_l, e, d, f), (2.0 / (d + e * f)) ** 0.5),
        "groups.0.moe.w2": ((n_l, e, f, d), (2.0 / (d + e * f)) ** 0.5),
    }
    fs = f * rc["num_shared_experts"]
    if fs:
        out.update({
            "groups.0.moe.shared.w1": ((n_l, d, fs), dense(d, fs)),
            "groups.0.moe.shared.w3": ((n_l, d, fs), dense(d, fs)),
            "groups.0.moe.shared.w2": ((n_l, fs, d), dense(fs, d)),
        })
    return out


def moe_layers(rc: dict) -> int:
    """Every layer routes."""
    return rc["num_layers"]


def active_params(rc: dict) -> int:
    """Per-token active parameters by the runtime's count: embedding and
    head, every layer's attention, router and norms, top-k plus shared
    experts (the shared ones counted twice, as the runtime does)."""
    d, v, hd = rc["d_model"], rc["vocab_size"], rc["head_dim"]
    h, kv, l_n = rc["num_heads"], rc["num_kv_heads"], rc["num_layers"]
    e_n, k_n = rc["num_experts"], rc["top_k"]
    s_n, f = rc["num_shared_experts"], rc["expert_d_ff"]
    n = 2 * v * d
    attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
    ffn = e_n * 3 * d * f + d * e_n + s_n * 3 * d * f
    n += l_n * (attn + ffn + 2 * d)
    return n - l_n * (e_n * 3 * d * f - (k_n + s_n) * 3 * d * f)


def layer_flops(rc: dict, ctx: int, layer: int) -> float:
    """One token through one layer at context ``ctx`` (keys it attends
    to, itself included): projections, scores and values, router, its
    top-k experts and the shared experts; multiply-adds count 2. Every
    layer alike."""
    d, hd = rc["d_model"], rc["head_dim"]
    h, kv = rc["num_heads"], rc["num_kv_heads"]
    window = rc.get("sliding_window") or 0
    keys = min(ctx, window) if window else ctx
    proj = 2 * d * (h * hd + 2 * kv * hd) + 2 * h * hd * d
    attend = 4 * h * hd * keys
    router = 2 * d * rc["num_experts"]
    experts = (rc["top_k"] + rc["num_shared_experts"]) * 6 * d \
        * rc["expert_d_ff"]
    return float(proj + attend + router + experts)


def rope(x, pos, theta):
    """x [n, heads, hd]; pos [n] absolute positions."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Reference:
    """Plain PyTorch forward of the family: RMSNorm, causal attention with
    RoPE and grouped KV heads (and a sliding window), the router's top-k
    with the renormalized top-k softmax, Algorithm 1's buddy substitution
    in its precedence form (fetch on a miss without a buddy), the SwiGLU
    experts and shared experts, and the LM head. Tokens are a flat list of
    sequences; every sequence is attended on its own. Every layer is a MoE
    layer, so layer l is MoE layer l."""

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
