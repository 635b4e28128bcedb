"""Decoder stack for attention stacks (ATTN_MOE / ATTN_DENSE) and RWKV6.

Counterpart of ``repro/models/transformer.py``. Parameters are a nested dict
with the reference's keys and each group's layers stacked on a leading
``[L, ...]`` axis; each ``lax.scan`` over a group becomes a loop over that
axis. Entry points:

  forward_train(params, cfg, tokens, ...)            -> logits [B, S, V], aux
  prefill(params, cfg, tokens)                       -> logits [B, S, V]
  decode_step(params, cfg, token, caches, pos, ...)  -> logits [B, V], caches, aux
  prefill_chunk(params, cfg, tokens, caches, base_pos, tok_valid, ...)
                                                     -> logits [B, C, V], caches, aux

Serving state for MoE stacks: ``buddies`` is a BuddyState whose leaves carry
a leading MoE-layer axis [L_moe, ...]. Decode caches (ring KV, RWKV states)
are updated in place; chunked prefill writes the same ring KV caches. The
Mamba2, hybrid, VLM and audio families and paged caches arrive with later
slices.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ATTN_DENSE, ATTN_MOE, RWKV, ModelConfig
from repro_torch.core.policy import BuddyPolicy
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rw
from repro_torch.models.common import (dense_init, embed_init, resolve_device,
                                       rmsnorm, swiglu, torch_dtype,
                                       tree_leaves, tree_map)

_COUNTERS = ("lb", "n_sub", "n_miss", "n_drop", "n_degraded", "n_miss_drop",
             "n_peer", "miss_per_expert")
_RECORDED = ("indices", "probs", "n_sub", "n_miss", "miss_per_expert",
             "substituted", "missed", "degraded", "dropped", "peered")


def _check_stack(cfg: ModelConfig):
    kinds = {k for k, _ in cfg.stack()}
    if not kinds <= {ATTN_DENSE, ATTN_MOE, RWKV}:
        raise NotImplementedError(
            f"only attention and RWKV6 stacks are ported, got {cfg.stack()}")


def require_attention_stack(cfg: ModelConfig, what: str):
    """Chunked prefill and the row hooks need ring KV caches whose leaves
    are [L, B, ...]: attention stacks only (SSM states are sequential)."""
    if not all(k in (ATTN_DENSE, ATTN_MOE) for k, _ in cfg.stack()):
        raise ValueError(f"{what} supports attention stacks only, got "
                         f"{cfg.stack()}")


def _tree_assign(dst, i: int, src):
    if isinstance(dst, dict):
        for k in dst:
            _tree_assign(dst[k], i, src[k])
    else:
        dst[i].copy_(src)


# ===========================================================================
# Init
# ===========================================================================
def _init_attn_block(gen, cfg: ModelConfig, dtype, device, moe: bool):
    p = {"ln1": torch.ones(cfg.d_model, dtype=torch.float32, device=device),
         "ln2": torch.ones(cfg.d_model, dtype=torch.float32, device=device),
         "attn": attn.init_attn(gen, cfg.d_model, cfg.num_heads,
                                cfg.num_kv_heads, cfg.head_dim, dtype, device)}
    if moe:
        p["moe"] = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, dtype, device)
    else:
        p["ffn"] = {"w1": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
                    "w3": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
                    "w2": dense_init(gen, cfg.d_ff, cfg.d_model, dtype, device)}
    return p


def _init_block(gen, kind: str, cfg: ModelConfig, dtype, device):
    if kind == RWKV:
        s = cfg.ssm
        p = rw.init_rwkv(gen, cfg.d_model, s.num_heads, s.head_dim, cfg.d_ff,
                         dtype, device)
        p["ln1"] = torch.ones(cfg.d_model, dtype=torch.float32, device=device)
        p["ln2"] = torch.ones(cfg.d_model, dtype=torch.float32, device=device)
        return p
    return _init_attn_block(gen, cfg, dtype, device, kind == ATTN_MOE)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights from a torch.Generator (seed 0 when none is given),
    made on ``device``. Layers are written straight into their stacked
    [L, ...] tensors, so the peak is the model plus one layer."""
    _check_stack(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    params: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, dev)}
    groups = []
    for kind, repeat in cfg.stack():
        first = _init_block(gen, kind, cfg, dtype, dev)
        stacked = tree_map(lambda a: torch.empty((repeat, *a.shape),
                                                 dtype=a.dtype, device=dev),
                           first)
        _tree_assign(stacked, 0, first)
        del first
        for i in range(1, repeat):
            _tree_assign(stacked, i, _init_block(gen, kind, cfg, dtype, dev))
        groups.append(stacked)
    params["groups"] = tuple(groups)
    params["final_norm"] = torch.ones(cfg.d_model, dtype=torch.float32,
                                      device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype, dev)
    return params


# ===========================================================================
# Blocks
# ===========================================================================
class StepCtx(NamedTuple):
    cfg: ModelConfig
    mode: str                      # "full" | "step" | "chunk"
    window: int                    # effective attention window (0 = full)
    policy: Optional[BuddyPolicy]
    positions: Any                 # [B, S] (full), int / [B] pos (step),
    #                                or [B] per-row base positions (chunk)
    record: bool
    tok_valid: Any = None          # [B, C] prefix validity mask (chunk mode)
    plan: Optional[attn.ChunkPlan] = None   # the chunk's device indices


def _attn_kwargs(cfg: ModelConfig):
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _moe_aux_dict(aux: moe_mod.MoEAux, record: bool) -> dict:
    i32 = torch.int32
    d = {"lb": aux.lb_loss, "n_sub": aux.n_substituted.to(i32),
         "n_miss": aux.n_missed.to(i32), "n_drop": aux.n_dropped.to(i32),
         "n_degraded": aux.n_degraded.to(i32),
         "n_miss_drop": aux.n_miss_drop.to(i32),
         "n_peer": aux.n_peered.to(i32),
         "miss_per_expert": aux.miss_per_expert}
    if record:
        d.update(indices=aux.orig_indices, probs=aux.topk_probs,
                 substituted=aux.sub_slots, missed=aux.miss_slots,
                 degraded=aux.deg_slots, dropped=aux.drop_slots,
                 peered=aux.peer_slots)
    return d


def _rwkv_block(p, x, cache, ctx: StepCtx):
    """RWKV6 time mix + channel mix. "full" starts from zero state and
    drops the final one; "step" reads the layer's state from ``cache`` and
    writes the new state back into it in place."""
    cfg = ctx.cfg
    st = cache if cache is not None else rw.init_rwkv_state(
        x.shape[0], cfg.ssm.num_heads, cfg.ssm.head_dim, cfg.d_model,
        x.device)
    h, wkv, x_tm = rw.rwkv_time_mix(
        p, rmsnorm(x, p["ln1"], cfg.norm_eps), st["wkv"],
        st["x_tm"].to(x.dtype), num_heads=cfg.ssm.num_heads,
        head_dim=cfg.ssm.head_dim)
    x = x + h
    h, x_cm = rw.rwkv_channel_mix(p, rmsnorm(x, p["ln2"], cfg.norm_eps),
                                  st["x_cm"].to(x.dtype))
    if cache is not None:
        cache["wkv"].copy_(wkv)
        cache["x_tm"].copy_(x_tm)
        cache["x_cm"].copy_(x_cm)
    return x + h, cache, None


def block_forward(kind: str, p, x, cache, ctx: StepCtx, buddy=None):
    """Returns (x_out, cache, aux_dict_or_None)."""
    cfg = ctx.cfg
    if kind == RWKV:
        return _rwkv_block(p, x, cache, ctx)
    xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if ctx.mode == "full":
        h = attn.attn_forward(p["attn"], xn, ctx.positions, window=ctx.window,
                              **_attn_kwargs(cfg))
    elif ctx.mode == "chunk":
        h, cache = attn.attn_prefill_chunk(
            p["attn"], xn, cache, ctx.positions, ctx.tok_valid,
            window=ctx.window, plan=ctx.plan, **_attn_kwargs(cfg))
    else:
        h, cache = attn.attn_decode(p["attn"], xn, cache, ctx.positions,
                                    window=ctx.window, **_attn_kwargs(cfg))
    x = x + h
    xn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if kind == ATTN_MOE:
        y, moe_aux = moe_mod.moe_forward(
            p["moe"], xn, cfg.moe, policy=ctx.policy, buddy=buddy,
            capacity_factor=2.0 if ctx.mode == "step" else 1.25,
            dropless=ctx.mode == "chunk")
        aux = _moe_aux_dict(moe_aux, ctx.record)
    else:
        y = swiglu(xn, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
    return x + y, cache, aux


def _zero_moe_aux(cfg: ModelConfig, device) -> dict:
    e = cfg.moe.num_experts if cfg.is_moe else 1
    z = {k: torch.zeros((), dtype=torch.int32, device=device)
         for k in _COUNTERS}
    z["lb"] = torch.zeros((), dtype=torch.float32, device=device)
    z["miss_per_expert"] = torch.zeros(e, dtype=torch.int32, device=device)
    return z


def _run_group(kind: str, gparams, x, gcache, ctx: StepCtx, gbuddy=None):
    """One homogeneous group, layer by layer over the stacked [R, ...]
    params. Returns (x, cache, reduced aux)."""
    r = gparams["ln1"].shape[0]
    # one unbind per stacked leaf: its backward stacks the layers' gradients
    # once, where indexing would scatter each into a zero [R, ...] tensor
    layers = [a.unbind(0) for a in tree_leaves(gparams)]
    auxs = []
    for i in range(r):
        ith = iter([a[i] for a in layers])
        lp = tree_map(lambda _: next(ith), gparams)
        lc = tree_map(lambda a: a[i], gcache) if gcache is not None else None
        lb = (moe_mod.BuddyState(*[None if a is None else a[i]
                                   for a in gbuddy])
              if gbuddy is not None else None)
        x, _, aux = block_forward(kind, lp, x, lc, ctx, buddy=lb)
        auxs.append(aux if aux is not None
                    else _zero_moe_aux(ctx.cfg, x.device))
    red = {k: torch.stack([a[k] for a in auxs]).sum(0) for k in _COUNTERS}
    if ctx.record and kind == ATTN_MOE:
        red["per_layer"] = {k: torch.stack([a[k] for a in auxs])
                            for k in _RECORDED}
    return x, gcache, red


# ===========================================================================
# Caches
# ===========================================================================
def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                window: int = 0, device="cuda"):
    """Decode caches for every group, stacked on the group's layers: ring
    KV caches [L, B, C, KV, hd] for attention, RWKV6 states (wkv
    [L, B, H, dk, dv], x_tm and x_cm [L, B, 1, D], f32)."""
    _check_stack(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    cap = min(seq_len, window) if window else seq_len
    shape = (cap, cfg.num_kv_heads, cfg.head_dim)
    caches = []
    for kind, r in cfg.stack():
        if kind == RWKV:
            st = rw.init_rwkv_state(batch, cfg.ssm.num_heads,
                                    cfg.ssm.head_dim, cfg.d_model, dev)
            caches.append({k: torch.zeros((r, *a.shape), dtype=a.dtype,
                                          device=dev)
                           for k, a in st.items()})
        else:
            caches.append({"kv": {
                "k": torch.zeros((r, batch, *shape), dtype=dtype, device=dev),
                "v": torch.zeros((r, batch, *shape), dtype=dtype,
                                 device=dev)}})
    return tuple(caches)


# ===========================================================================
# Entry points
# ===========================================================================
def _logits(params, cfg: ModelConfig, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), head.float())


def _iter_groups(params, cfg, caches, buddies):
    """Yields (kind, gparams, gcache, gbuddy) with MoE buddy slices."""
    moe_off = 0
    for gi, (kind, repeat) in enumerate(cfg.stack()):
        gc = None
        if caches is not None:
            gc = caches[gi] if kind == RWKV else caches[gi]["kv"]
        gb = None
        if kind == ATTN_MOE and buddies is not None:
            gb = moe_mod.BuddyState(*[None if a is None
                                      else a[moe_off:moe_off + repeat]
                                      for a in buddies])
            moe_off += repeat
        yield kind, params["groups"][gi], gc, gb


def _accumulate(total, aux, rec, record: bool):
    for k in _COUNTERS:
        total[k] = total[k] + aux[k]
    if record and "per_layer" in aux:
        rec.append(aux["per_layer"])


def forward_train(params, cfg: ModelConfig, tokens, *,
                  policy: Optional[BuddyPolicy] = None, buddies=None,
                  record: bool = False, window: int = -1):
    """Full-sequence forward. tokens [B, S] on the params' device.
    Returns (logits [B, S, V] f32, aux)."""
    _check_stack(cfg)
    if window < 0:
        window = cfg.sliding_window
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device).expand(b, s)
    ctx = StepCtx(cfg, "full", window, policy, positions, record)
    total = _zero_moe_aux(cfg, x.device)
    rec = []
    for kind, gp, _, gb in _iter_groups(params, cfg, None, buddies):
        x, _, aux = _run_group(kind, gp, x, None, ctx, gbuddy=gb)
        _accumulate(total, aux, rec, record)
    logits = _logits(params, cfg, x)
    if record:
        total["recorded"] = rec
    return logits, total


def decode_step(params, cfg: ModelConfig, token, caches, pos, *,
                policy: Optional[BuddyPolicy] = None, buddies=None,
                window: int = -1, record: bool = False):
    """One-token decode. token [B] int tensor; pos an int (lockstep batch)
    or a [B] tensor of per-row positions; caches from init_caches (updated
    in place). Returns (logits [B, V] f32, caches, aux)."""
    _check_stack(cfg)
    if window < 0:
        window = cfg.sliding_window
    x = params["embed"][token][:, None, :]                        # [B, 1, D]
    ctx = StepCtx(cfg, "step", window, policy, pos, record)
    total = _zero_moe_aux(cfg, x.device)
    rec = []
    for kind, gp, gc, gb in _iter_groups(params, cfg, caches, buddies):
        x, _, aux = _run_group(kind, gp, x, gc, ctx, gbuddy=gb)
        _accumulate(total, aux, rec, record)
    logits = _logits(params, cfg, x[:, 0])
    if record:
        total["recorded"] = rec
    return logits, caches, total


def prefill_chunk(params, cfg: ModelConfig, tokens, caches, base_pos,
                  tok_valid, *, policy: Optional[BuddyPolicy] = None,
                  buddies=None, window: int = -1, record: bool = False):
    """Fused multi-token step for chunked prefill (continuous batching).

    tokens [B, C] int tensor on the params' device; base_pos [B] the
    absolute position of each row's first chunk token and tok_valid [B, C]
    the PREFIX validity mask, both host data (numpy): row b's tokens
    j < count(b) are live, the rest ride the fixed-shape step and write
    nothing. A decode row joins the step as a 1-valid-token chunk, so one
    step serves prefill and decode rows together. caches from init_caches
    (updated in place).

    Returns (logits [B, C, V] f32, caches, aux). aux token axes are the
    flattened [B*C] chunk (row-major): mask them with tok_valid on the host.
    MoE dispatch is dropless in this mode, so per-token outputs do not
    depend on the chunk size."""
    require_attention_stack(cfg, "chunked prefill")
    if window < 0:
        window = cfg.sliding_window
    x = params["embed"][tokens]                                   # [B, C, D]
    cap = caches[0]["kv"]["k"].shape[2]
    plan = attn.chunk_plan(base_pos, tok_valid, cap, window, x.device)
    ctx = StepCtx(cfg, "chunk", window, policy, base_pos, record,
                  tok_valid=tok_valid, plan=plan)
    total = _zero_moe_aux(cfg, x.device)
    rec = []
    for kind, gp, gc, gb in _iter_groups(params, cfg, caches, buddies):
        x, _, aux = _run_group(kind, gp, x, gc, ctx, gbuddy=gb)
        _accumulate(total, aux, rec, record)
    logits = _logits(params, cfg, x)                              # [B, C, V]
    if record:
        total["recorded"] = rec
    return logits, caches, total


def prefill(params, cfg: ModelConfig, tokens, *, window: int = -1):
    """Full-sequence forward (the prefill compute): forward_train's logits.
    The serving engine builds decode caches through decode_step or
    prefill_chunk."""
    return forward_train(params, cfg, tokens, window=window)[0]
