"""MoE layer: router top-k, BuddyMoE substitution, and expert SwiGLU
dispatch (fused grouped, tiny-batch gather, row-local capacity).

Counterpart of ``repro/models/moe.py``. The router gate, Algorithm 1 and both
grouped expert FFNs go through ``kernels.ops``: on CUDA tensors they are the
hand-written kernels, on CPU tensors their plain versions. Differences from
the reference:
  * the fused path always bins slots into the ``[2E, cap, D]`` grouped
    buffer (the reference's kernel arm); at decode cap = T*K, so nothing is
    dropped and the outputs equal the reference's jnp megastep;
  * the quant tier (degraded outcome) waits for the tier slice: a policy
    with ``quant_tier != 'off'`` raises;
  * on CUDA only precedence mode with Psi = q, temperature 1 and no margin
    co-gate runs (the kernels' contract); other policies raise there and run
    through the plain ``core.substitute`` on the CPU.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import gates
from repro_torch.core.policy import BuddyPolicy
from repro_torch.core.substitute import (SubstituteResult, split_degraded,
                                         split_peer, substitute)
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, normal, swiglu


class BuddyState(NamedTuple):
    """Per-layer runtime state for BuddyMoE (all replicated, tiny)."""
    resident: torch.Tensor   # [E] bool — device residency mask M
    table: torch.Tensor      # [E, R] int32 — buddy profile B (-1 pad)
    q: torch.Tensor          # [E, R] f32 — q_{j|i} per entry
    hop: torch.Tensor        # [E] int32 — hops to each expert's cache slot
    quant_ok: Any = None     # [E] bool — misses routed to the quant tier
    fid_cost: Any = None     # [E] f32 — cost of the degraded outcome
    fetch_cost: Any = None   # [E] f32 — expected stall of fetching
    peer_ok: Any = None      # [E] bool — experts resident in a peer's HBM
    peer_cost: Any = None    # [E] f32 — expected stall of the peer borrow


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype,
             device) -> dict:
    """Expert weights stacked [E, D, F] / [E, F, D]; router [D, E] f32."""
    e, f = cfg.num_experts, cfg.d_ff

    def stacked(shape_in, shape_out):
        # the reference draws one [D, E*F] (or [E*F, D]) dense matrix and
        # reshapes it: the scale is that of the whole matrix
        scale = (2.0 / (d_model + e * f)) ** 0.5
        return (normal(gen, (e, shape_in, shape_out), device) * scale).to(dtype)

    def upcycled(shape_in, shape_out):
        # sparse upcycling: shared base FFN + per-expert perturbation
        base = dense_init(gen, shape_in, shape_out, torch.float32, device)
        noise = normal(gen, (e, shape_in, shape_out), device) \
            * cfg.upcycle_noise * (2.0 / (shape_in + shape_out)) ** 0.5
        return (base[None] + noise).to(dtype)

    make = upcycled if cfg.upcycle_noise > 0 else stacked
    p = {"router": dense_init(gen, d_model, e, torch.float32, device),
         "w1": make(d_model, f), "w3": make(d_model, f), "w2": make(f, d_model)}
    if cfg.num_shared_experts:
        fs = cfg.d_ff * cfg.num_shared_experts
        p["shared"] = {"w1": dense_init(gen, d_model, fs, dtype, device),
                       "w3": dense_init(gen, d_model, fs, dtype, device),
                       "w2": dense_init(gen, fs, d_model, dtype, device)}
    return p


class MoEAux(NamedTuple):
    lb_loss: torch.Tensor        # scalar load-balance loss (Switch-style)
    indices: torch.Tensor        # [T, K] final assignment (post-substitution)
    orig_indices: torch.Tensor   # [T, K] router's assignment
    topk_probs: torch.Tensor     # [T, K] renormalized probs
    n_substituted: torch.Tensor  # [] substituted slots
    n_missed: torch.Tensor       # [] non-resident slots with no buddy
    n_dropped: torch.Tensor      # [] slots dropped by capacity
    miss_per_expert: torch.Tensor  # [E] miss counts
    sub_slots: torch.Tensor      # [T, K] bool
    miss_slots: torch.Tensor     # [T, K] bool
    n_degraded: torch.Tensor     # [] slots served from the quant tier
    deg_slots: torch.Tensor      # [T, K] bool
    n_miss_drop: torch.Tensor    # [] misses the cost argmin dropped
    drop_slots: torch.Tensor     # [T, K] bool
    n_peered: torch.Tensor = None  # [] misses served by a peer borrow
    peer_slots: torch.Tensor = None  # [T, K] bool


def router_topk(router_w, x_flat, top_k: int, tau: float = 0.0):
    """Returns logits [T, E], top-k indices [T, K] int32, top-k logits,
    renormalized probs and the TAE gate ``allow`` [T] (TAE > tau), all from
    one topk_gate call."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    idx, topk_logits, probs, _, allow = ops.topk_gate(logits.contiguous(),
                                                      tau, k=top_k)
    return logits, idx, topk_logits, probs, allow


def kernel_policy(policy: BuddyPolicy) -> bool:
    """True when the policy is inside the kernels' contract: precedence
    mode, Psi = q (eta = kappa = 0), temperature 1, no margin co-gate."""
    return (policy.miss_policy == "precedence" and policy.eta == 0.0
            and policy.kappa == 0.0 and policy.temperature == 1.0
            and policy.margin_gamma >= 1.0)


def substitute_precedence(idx, allow, buddy: BuddyState,
                          policy: BuddyPolicy) -> SubstituteResult:
    """Algorithm 1 in precedence mode through the buddy_substitute kernel.
    The batch-level distribution gate is a reduction computed here; the
    degraded and peer splits are applied to the kernel's miss mask, which
    is exact because they never feed back into later slots."""
    dist_ok = gates.distribution_gate(idx, buddy.resident, policy.beta)
    if policy.mode == "none":
        new_idx = idx
        substituted = torch.zeros(idx.shape, dtype=torch.bool,
                                  device=idx.device)
        missed = ~buddy.resident[idx.long()]
    else:
        new_idx, substituted, missed = ops.buddy_substitute(
            idx, allow & dist_ok, buddy.resident, buddy.table, buddy.q,
            h=policy.H, rho=policy.rho)
    missed, degraded = split_degraded(missed, new_idx, buddy.quant_ok)
    missed, peered = split_peer(missed, new_idx, buddy.peer_ok)
    return SubstituteResult(new_idx, substituted, missed, allow, dist_ok,
                            degraded, torch.zeros_like(missed), peered)


def _substitute(idx, topk_logits, allow, logits, buddy: BuddyState,
                policy: BuddyPolicy) -> SubstituteResult:
    if kernel_policy(policy):
        return substitute_precedence(idx, allow, buddy, policy)
    if idx.device.type != "cpu":
        raise NotImplementedError(
            "on CUDA only precedence mode with eta = kappa = 0, temperature "
            f"1 and margin_gamma >= 1 runs (got {policy}); the other "
            "substitution modes run on the CPU")
    return substitute(idx, topk_logits, buddy.resident, buddy.table,
                      buddy.q, policy, router_logits=logits, hop=buddy.hop,
                      fetch_cost=buddy.fetch_cost, peer_ok=buddy.peer_ok,
                      peer_cost=buddy.peer_cost)


def _capacity(t_n: int, k_n: int, e_n: int, factor: float) -> int:
    cap = int(max(k_n, t_n * k_n / e_n * factor))
    return min(t_n * k_n, -(-cap // 8) * 8)


def _bin(x_rows, flat, n_slots: int):
    """Scatter rows into a zeroed [n_slots, D] buffer at ``flat`` (index
    n_slots = dropped, into a sink row that is cut off)."""
    buf = torch.zeros((n_slots + 1, x_rows.shape[1]), dtype=x_rows.dtype,
                      device=x_rows.device)
    buf[flat] = x_rows
    return buf[:n_slots]


def _unbin(out_rows, flat, kept):
    """Gather per-slot outputs back; dropped slots read zero."""
    got = out_rows[flat.clamp(max=out_rows.shape[0] - 1)]
    return torch.where(kept[:, None], got, torch.zeros((), dtype=got.dtype,
                                                       device=got.device))


def _fused_dispatch(params: dict, x_flat, new_idx, skip, cap: int):
    """The single-dispatch path: bin slots by resolved expert into the
    [2E, cap, D] grouped buffer (skipped slots are never binned), one
    grouped_ffn call, one gather. The degraded half of the buffer stays
    empty until the quant tier is ported. Returns (y_rep [T*K, D],
    n_capacity_dropped [])."""
    d = x_flat.shape[1]
    k_n = new_idx.shape[1]
    e_n = params["w1"].shape[0]
    grp = new_idx.reshape(-1).long()
    grp = torch.where(skip.reshape(-1), 2 * e_n, grp)        # out of range
    onehot = F.one_hot(grp, 2 * e_n + 1)[:, :2 * e_n]       # [N, 2E]
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    kept = (pos >= 0) & (pos < cap)
    n_cap_dropped = (pos >= cap).sum().to(torch.int32)
    counts = onehot.sum(0).clamp(max=cap).to(torch.int32)
    flat = torch.where(kept, grp * cap + pos, 2 * e_n * cap)
    xr = x_flat.repeat_interleave(k_n, 0)                    # [N, D]
    buf = _bin(xr, flat, 2 * e_n * cap).view(2 * e_n, cap, d)
    out = ops.grouped_ffn(buf, params["w1"], params["w3"], params["w2"],
                          None, counts)
    return _unbin(out.reshape(-1, d), flat, kept), n_cap_dropped


def _load_balance(logits, new_idx, e_n: int):
    t_n, k_n = new_idx.shape
    p_mean = torch.softmax(logits, dim=-1).mean(0)
    onehot = F.one_hot(new_idx.reshape(-1).long(), e_n).float()
    f_frac = onehot.reshape(t_n, k_n, e_n).sum(1).mean(0)
    return e_n * (f_frac * p_mean).sum()


def moe_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                policy: Optional[BuddyPolicy] = None,
                buddy: Optional[BuddyState] = None,
                capacity_factor: float = 1.25,
                dropless: bool = False) -> tuple:
    """x: [B, S, D] (or [T, D]). Returns (y, MoEAux). Same branches and
    contract as the reference (see the module note for the differences)."""
    if policy is not None and policy.quant_tier != "off":
        raise NotImplementedError("the quant tier (degraded outcome) is not "
                                  "ported yet")
    if cfg.router_jitter > 0:
        raise NotImplementedError("router jitter is not ported yet")
    orig_shape = x.shape
    d = x.shape[-1]
    x_flat = x.reshape(-1, d)
    t_n = x_flat.shape[0]
    e_n, k_n = cfg.num_experts, cfg.top_k
    dev = x.device

    logits, idx, topk_logits, probs, allow = router_topk(
        params["router"], x_flat, k_n, policy.tau if policy is not None
        else 0.0)

    zeros = torch.zeros(idx.shape, dtype=torch.bool, device=dev)
    if policy is not None and buddy is not None:
        res = _substitute(idx, topk_logits, allow, logits, buddy, policy)
        new_idx, substituted, missed = res.indices, res.substituted, res.missed
        degraded, dropped, peered = res.degraded, res.dropped, res.peered
    elif buddy is not None:         # no policy: raw residency miss count
        new_idx, missed = idx, ~buddy.resident[idx.long()]
        substituted, degraded, dropped, peered = zeros, zeros, zeros, zeros
    else:
        new_idx = idx
        substituted, missed, degraded, dropped, peered = (zeros,) * 5

    weights = probs
    if policy is not None and policy.fallback == "drop":
        weights = torch.where(missed, 0.0, weights)
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    if policy is not None and policy.miss_policy == "cost":
        weights = torch.where(dropped, 0.0, weights)
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)

    decode = x.ndim == 3 and x.shape[1] == 1
    n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if policy is not None and policy.use_fused_dispatch:
        # ---- single-dispatch fused path (grouped kernel) -----------------
        skip = dropped | missed if policy.fallback == "drop" else dropped
        cap = t_n * k_n if (dropless or decode) \
            else _capacity(t_n, k_n, e_n, capacity_factor)
        y_rep, n_dropped = _fused_dispatch(params, x_flat, new_idx, skip, cap)
        yk = y_rep.reshape(t_n, k_n, d)
    elif not dropless and decode and t_n * k_n < e_n:
        # ---- active-expert gather (tiny-batch decode) ---------------------
        # reads only the selected experts' weights; plain batched matmuls,
        # as the reference leaves this branch to XLA
        e_flat = new_idx.reshape(-1).long()
        xr = x_flat.repeat_interleave(k_n, 0)[:, None, :].float()  # [N,1,D]
        h = F.silu(torch.bmm(xr, params["w1"][e_flat].float()))
        g = torch.bmm(xr, params["w3"][e_flat].float())
        hg = (h * g).to(x.dtype).float()
        y_rep = torch.bmm(hg, params["w2"][e_flat].float()).to(x.dtype)
        yk = y_rep.reshape(t_n, k_n, d)
    else:
        # ---- capacity-based dispatch (row-local) --------------------------
        rows = x.shape[0] if x.ndim == 3 else 1
        s_n = t_n // rows
        row_e = new_idx.reshape(rows, s_n * k_n).long()
        onehot = F.one_hot(row_e, e_n)                           # [B, S*K, E]
        pos = (onehot.cumsum(1) * onehot).sum(-1) - 1
        cap = s_n * k_n if dropless \
            else _capacity(s_n, k_n, e_n, capacity_factor)
        kept = pos < cap
        n_dropped = (~kept).sum().to(torch.int32)
        # buffer laid out [E, B, cap] so that it is the kernel's [E, C, D]
        b_idx = torch.arange(rows, device=dev)[:, None]
        flat = torch.where(kept, row_e * (rows * cap) + b_idx * cap + pos,
                           e_n * rows * cap).reshape(-1)
        x_rep = x_flat.repeat_interleave(k_n, 0)                 # [T*K, D]
        buf = _bin(x_rep, flat, e_n * rows * cap).view(e_n, rows * cap, d)
        out = ops.expert_ffn(buf, params["w1"], params["w3"], params["w2"])
        yk = _unbin(out.reshape(-1, d), flat, kept.reshape(-1)) \
            .reshape(t_n, k_n, d)

    y = (yk * weights[..., None].to(x.dtype)).sum(1)
    if cfg.num_shared_experts and "shared" in params:
        sh = params["shared"]
        y = y + swiglu(x_flat, sh["w1"], sh["w3"], sh["w2"])

    miss_per_expert = torch.zeros(e_n, dtype=torch.int32, device=dev) \
        .index_add_(0, idx.reshape(-1).long(),
                    missed.reshape(-1).to(torch.int32))
    aux = MoEAux(_load_balance(logits, new_idx, e_n), new_idx, idx, probs,
                 substituted.sum(), missed.sum(), n_dropped, miss_per_expert,
                 substituted, missed, degraded.sum(), degraded,
                 dropped.sum(), dropped, peered.sum(), peered)
    return y.reshape(orig_shape), aux
