"""MoE layer: router top-k, BuddyMoE substitution, and expert SwiGLU
dispatch (fused grouped, tiny-batch gather, row-local capacity).

Counterpart of ``repro/models/moe.py``. The routing and the expert FFNs go
through ``kernels.ops``: on CUDA tensors they are the hand-written kernels,
on CPU tensors their plain versions. With a policy and a buddy state a
layer's routing (router gate, token and distribution gates, Algorithm 1
and the miss outcomes, for every policy of ``BuddyPolicy``) is one
``ops.route`` call; without them the router gate alone runs
(``ops.topk_gate``). Differences from the reference:
  * the fused path always bins slots into the ``[2E, cap, D]`` grouped
    buffer (the reference's kernel arm); at decode cap = T*K, so nothing is
    dropped and the outputs equal the reference's jnp megastep (which
    dequantizes degraded slots before the matmul: at f32 the two differ by
    rounding only);
  * with the quant tier on, the gather and capacity branches compute only
    the degraded slots against the replicas (``quant_ffn``), where the
    reference computes every slot and keeps the degraded ones: the values
    on degraded slots are equal.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.policy import BuddyPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.quant_ffn import quant_operands
from repro_torch.models.common import (dense_init, is_sharded, local_call,
                                       no_partial, normal, one_hot, remap,
                                       shard, shard_dims, swiglu,
                                       with_partial)
from repro_torch.runtime import trace


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


def route_layer(logits, buddy: BuddyState, policy: BuddyPolicy, k: int,
                quant_ok=None, fid_cost=None):
    """One layer's routing in one ``ops.route`` call: the router gate, the
    token and distribution gates, Algorithm 1 and the miss outcomes, as the
    reference's ``router_topk`` plus ``core.substitute`` compute them.
    ``quant_ok`` / ``fid_cost`` are the tier's precedence mask and cost
    vector as gated by the caller (None: no degraded outcome). Returns a
    ``kernels.route.Route``."""
    return ops.route(logits, policy.tau, policy.beta, buddy.resident,
                     buddy.table, buddy.q, k=k, h=policy.H, rho=policy.rho,
                     substitute=policy.mode != "none", quant_ok=quant_ok,
                     peer_ok=buddy.peer_ok,
                     cost=policy.miss_policy == "cost", fid_cost=fid_cost,
                     fetch_cost=buddy.fetch_cost, peer_cost=buddy.peer_cost,
                     stall_per_quality=policy.stall_per_quality,
                     drop_loss=policy.drop_loss, eta=policy.eta,
                     kappa=policy.kappa, hop=buddy.hop,
                     temperature=policy.temperature,
                     margin_gamma=policy.margin_gamma)


def _capacity(t_n: int, k_n: int, e_n: int, factor: float) -> int:
    cap = int(max(k_n, t_n * k_n / e_n * factor))
    return min(t_n * k_n, -(-cap // 8) * 8)


def _bin_slots(grp, n_groups: int, cap: int):
    """Positions of slots binned by group ``grp`` [N] (index n_groups =
    never binned) into an [n_groups, cap] grid in slot order. Returns (flat
    [N] row of the grid or n_groups*cap for the sink, kept [N], counts
    [n_groups] int32 filled rows, n_capacity_dropped [] int32)."""
    onehot = one_hot(grp, n_groups + 1)[:, :n_groups]      # [N, G]
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    kept = (pos >= 0) & (pos < cap)
    n_cap_dropped = (pos >= cap).sum().to(torch.int32)
    counts = onehot.sum(0).clamp(max=cap).to(torch.int32)
    flat = torch.where(kept, grp * cap + pos, n_groups * cap)
    return flat, kept, counts, n_cap_dropped


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


def _fused_dispatch(params: dict, x_flat, new_idx, degraded, skip,
                    run_degraded: bool, cap: int):
    """The single-dispatch path: bin slots by (resolved expert, class) into
    the [2E, cap, D] grouped buffer — degraded slots at e + E, their true
    id, when the tier runs; skipped slots are never binned — one
    grouped_ffn call, one gather. Returns (y_rep [T*K, D],
    n_capacity_dropped [])."""
    d = x_flat.shape[1]
    k_n = new_idx.shape[1]
    e_n = params["w1"].shape[0]
    grp = new_idx.reshape(-1).long()
    if run_degraded:
        grp = torch.where(degraded.reshape(-1), grp + e_n, grp)
    grp = torch.where(skip.reshape(-1), 2 * e_n, grp)        # out of range
    flat, kept, counts, n_cap_dropped = _bin_slots(grp, 2 * e_n, cap)
    xr = x_flat.repeat_interleave(k_n, 0)                    # [N, D]
    buf = _bin(xr, flat, 2 * e_n * cap).view(2 * e_n, cap, d)
    quant = quant_operands(params["quant"]) if run_degraded else None
    out = ops.grouped_ffn(buf, params["w1"], params["w3"], params["w2"],
                          quant, counts)
    return _unbin(out.reshape(-1, d), flat, kept), n_cap_dropped


def _degraded_outputs(params: dict, x_flat, e_flat, deg_flat):
    """Per-slot SwiGLU against the resident replica tier, [T*K, D] in
    x.dtype, through the quant_ffn kernel: only the degraded slots are
    binned, by their true expert (``e_flat``; a degraded slot is never
    substituted), into [E, T*K, D] with row counts; other slots read zero.
    No host branch on whether any slot is degraded: an expert with no row
    reads no weight bytes, so a step without one costs the empty launch."""
    n, d = e_flat.shape[0], x_flat.shape[1]
    e_n = params["w1"].shape[0]
    grp = torch.where(deg_flat, e_flat.long(), e_n)
    flat, kept, counts, _ = _bin_slots(grp, e_n, n)
    xr = x_flat.repeat_interleave(n // x_flat.shape[0], 0)  # [N, D]
    buf = _bin(xr, flat, e_n * n).view(e_n, n, d)
    out = ops.quant_ffn(buf, *quant_operands(params["quant"]), counts=counts)
    return _unbin(out.reshape(-1, d), flat, kept)


def _capacity_bin(x_flat, new_idx, *, s_n: int, k_n: int, e_n: int,
                  cap: int):
    """The capacity branch's binning, row-local: each batch row's S*K
    slots into its own cap rows of every expert, the buffer laid out
    [E, B, cap] so that it is the kernel's [E, C, D]. Returns (buf
    [E, B*cap, D], flat [B*S*K] grid row or the sink, kept [B*S*K],
    n_capacity_dropped [] int32)."""
    d = x_flat.shape[1]
    rows = x_flat.shape[0] // s_n
    row_e = new_idx.reshape(rows, s_n * k_n).long()
    onehot = one_hot(row_e, e_n)                             # [B, S*K, E]
    pos = (onehot.cumsum(1) * onehot).sum(-1) - 1
    kept = pos < cap
    n_dropped = (~kept).sum().to(torch.int32)
    b_idx = torch.arange(rows, device=x_flat.device)[:, None]
    flat = torch.where(kept, row_e * (rows * cap) + b_idx * cap + pos,
                       e_n * rows * cap).reshape(-1)
    x_rep = x_flat.repeat_interleave(k_n, 0)                 # [T*K, D]
    buf = _bin(x_rep, flat, e_n * rows * cap).view(e_n, rows * cap, d)
    return buf, flat, kept.reshape(-1), n_dropped


def _by_rows(bin_fn, x_flat, new_idx):
    """``bin_fn(x_flat, new_idx)``, under a mesh on each device's batch
    rows (``local_map``: DTensor has no rule for the slot scatter): the
    buffer split on its rows dim as x is on its tokens, the dropped count
    a partial sum over those axes. As the reference's vmapped scatter,
    no token crosses a batch shard."""
    if not is_sharded(x_flat):
        return bin_fn(x_flat, new_idx)
    from torch.distributed.tensor import Replicate
    rows = no_partial(remap(x_flat.placements, {0: 0}))
    rep = (Replicate(),) * len(rows)
    return local_call(bin_fn, (x_flat, new_idx), (rows, rows),
                      (remap(rows, {0: 1}), rows, rows,
                       with_partial(rep, shard_dims(rows, 0))))


def _unbin_rows(out, flat, kept, k_n: int):
    """Each slot's expert output back, [T, K, D] (dropped slots zero),
    row-local as ``_by_rows``; a partial sum of ``out`` (d_ff split) stays
    one, and its gradient is the whole one."""
    d = out.shape[-1]

    def unbin(o, fl, kp):
        return _unbin(o.reshape(-1, d), fl, kp).reshape(-1, k_n, d)
    if not is_sharded(out):
        return unbin(out, flat, kept)
    rows = flat.placements
    return local_call(unbin, (out, flat, kept), (out.placements, rows, rows),
                      remap(out.placements, {1: 0}),
                      (no_partial(out.placements), rows, rows))


def _per_expert_misses(idx, missed, e_n: int):
    """[E] int32: misses by the router's expert; under a mesh counted on
    each device's rows, a partial sum over the batch axes."""
    def count(i, m):
        return torch.zeros(e_n, dtype=torch.int32, device=i.device) \
            .index_add_(0, i.reshape(-1).long(),
                        m.reshape(-1).to(torch.int32))
    if not is_sharded(idx):
        return count(idx, missed)
    from torch.distributed.tensor import Replicate
    rows = no_partial(remap(idx.placements, {0: 0}))
    rep = (Replicate(),) * len(rows)
    return local_call(count, (idx, missed), (rows, rows),
                      with_partial(rep, shard_dims(rows, 0)))


def _load_balance(logits, new_idx, e_n: int):
    t_n, k_n = new_idx.shape
    p_mean = torch.softmax(logits, dim=-1).mean(0)
    onehot = one_hot(new_idx.reshape(-1).long(), e_n).float()
    f_frac = onehot.reshape(t_n, k_n, e_n).sum(1).mean(0)
    return e_n * (f_frac * p_mean).sum()


def moe_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                policy: Optional[BuddyPolicy] = None,
                buddy: Optional[BuddyState] = None,
                capacity_factor: float = 1.25,
                dropless: bool = False,
                rng: Optional[torch.Generator] = None) -> tuple:
    """x: [B, S, D] (or [T, D]). Returns (y, MoEAux). Same branches and
    contract as the reference (see the module note for the differences).

    With ``cfg.router_jitter`` > 0 and a generator ``rng`` on x's device,
    the router logits get U(-jitter, jitter) noise before the top-k, as the
    reference's ``router_topk`` adds it with its jitter key (the draws
    differ from JAX's PRNG; the same generator state gives the same ones).

    The quant tier runs when ``policy.quant_tier`` is on and the params
    carry a ``quant`` sub-dict: a miss the tier's ``buddy.quant_ok`` mask
    (precedence) or ``buddy.fid_cost`` argmin (cost mode) sends there is
    computed against the resident replica. Otherwise the graph is the
    pre-tier one."""
    orig_shape = x.shape
    d = x.shape[-1]
    x_flat = x.reshape(-1, d)
    t_n = x_flat.shape[0]
    e_n, k_n = cfg.num_experts, cfg.top_k
    dev = x.device
    use_tier = (policy is not None and policy.quant_tier != "off"
                and "quant" in params)
    quant_ok = buddy.quant_ok if (use_tier and buddy is not None) else None
    tier_fid_cost = (buddy.fid_cost if (use_tier and buddy is not None)
                     else None)

    with trace.span("model.route"):
        logits = torch.matmul(x_flat.float(), params["router"].float())
        if rng is not None and cfg.router_jitter > 0:
            logits = logits + torch.empty_like(logits).uniform_(
                -cfg.router_jitter, cfg.router_jitter, generator=rng)
        if policy is not None and buddy is not None:
            res = route_layer(logits, buddy, policy, k_n, quant_ok,
                              tier_fid_cost)
            idx, probs, new_idx = res.idx, res.probs, res.new_idx
            substituted, missed, degraded = res.substituted, res.missed, \
                res.degraded
            dropped, peered = res.dropped, res.peered
        else:
            idx, _, probs, _, _ = ops.topk_gate(
                logits, policy.tau if policy is not None else 0.0, k=k_n)
            zeros = torch.zeros(idx.shape, dtype=torch.bool, device=dev)
            new_idx, substituted, degraded, dropped, peered = (idx,) + \
                (zeros,) * 4
            # no policy: the raw residency miss count
            missed = zeros if buddy is None else ~buddy.resident[idx.long()]
    run_degraded = use_tier and (quant_ok is not None
                                 or tier_fid_cost is not None)

    weights = probs
    if policy is not None and policy.fallback == "drop":
        weights = torch.where(missed, 0.0, weights)
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    if policy is not None and policy.miss_policy == "cost":
        weights = torch.where(dropped, 0.0, weights)
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)

    decode = x.ndim == 3 and x.shape[1] == 1
    n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    with trace.span("model.dispatch") as sp:
        if policy is not None and policy.use_fused_dispatch:
            # ---- single-dispatch fused path (grouped kernel) -------------
            skip = dropped | missed if policy.fallback == "drop" else dropped
            cap = t_n * k_n if (dropless or decode) \
                else _capacity(t_n, k_n, e_n, capacity_factor)
            y_rep, n_dropped = _fused_dispatch(params, x_flat, new_idx,
                                               degraded, skip, run_degraded,
                                               cap)
            yk = y_rep.reshape(t_n, k_n, d)
            if sp is not None:
                sp.dispatch("grouped_ffn", t_n * k_n, t_n, k_n)
        elif not dropless and decode and t_n * k_n < e_n:
            # ---- active-expert gather (tiny-batch decode) -----------------
            # reads only the selected experts' weights; plain batched
            # matmuls, as the reference leaves this branch to XLA
            e_flat = new_idx.reshape(-1).long()
            xr = x_flat.repeat_interleave(k_n, 0)[:, None, :].float()
            h = F.silu(torch.bmm(xr, params["w1"][e_flat].float()))
            g = torch.bmm(xr, params["w3"][e_flat].float())
            hg = shard((h * g).to(x.dtype), None, None, "dff").float()
            y_rep = torch.bmm(hg, params["w2"][e_flat].float()) \
                .to(x.dtype)[:, 0]
            if run_degraded:
                deg_f = degraded.reshape(-1)
                y_deg = _degraded_outputs(params, x_flat, e_flat, deg_f)
                y_rep = torch.where(deg_f[:, None], y_deg, y_rep)
            yk = y_rep.reshape(t_n, k_n, d)
            if sp is not None:
                sp.dispatch("gather", t_n * k_n, t_n, k_n)
        else:
            # ---- capacity-based dispatch (row-local) ----------------------
            rows = x.shape[0] if x.ndim == 3 else 1
            s_n = t_n // rows
            cap = s_n * k_n if dropless \
                else _capacity(s_n, k_n, e_n, capacity_factor)
            buf, flat, kept, n_dropped = _by_rows(
                functools.partial(_capacity_bin, s_n=s_n, k_n=k_n, e_n=e_n,
                                  cap=cap), x_flat, new_idx)
            buf = shard(buf, "expert", "batch", None)
            out = ops.expert_ffn(buf, params["w1"], params["w3"],
                                 params["w2"])
            yk = _unbin_rows(out, flat, kept, k_n)
            if run_degraded:
                deg_f = degraded.reshape(-1)
                y_deg = _degraded_outputs(params, x_flat,
                                          new_idx.reshape(-1), deg_f)
                yk = torch.where(deg_f.reshape(t_n, k_n, 1),
                                 y_deg.reshape(t_n, k_n, d), yk)
            if sp is not None:
                sp.dispatch("expert_ffn", e_n * rows * cap, t_n, k_n)

    y = (yk * weights[..., None].to(x.dtype)).sum(1)
    miss_per_expert = _per_expert_misses(idx, missed, e_n)
    aux = MoEAux(_load_balance(logits, new_idx, e_n), new_idx, idx, probs,
                 substituted.sum(), missed.sum(), n_dropped, miss_per_expert,
                 substituted, missed, degraded.sum(), degraded,
                 dropped.sum(), dropped, peered.sum(), peered)
    # The shared expert last: remat's recompute stops once every tensor
    # the forward saved is back, and the down product's saved inputs are
    # back before it runs, so the recompute skips that product, as XLA
    # drops it from the reference's recompute as dead code.
    if cfg.num_shared_experts and "shared" in params:
        sh = params["shared"]
        y = y + swiglu(x_flat, sh["w1"], sh["w3"], sh["w2"])
    return y.reshape(orig_shape), aux
