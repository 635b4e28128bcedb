"""Decoder stack for attention stacks (ATTN_MOE / ATTN_DENSE).

Counterpart of ``repro/models/transformer.py``. Parameters are a nested dict
with the reference's keys and each group's layers stacked on a leading
``[L, ...]`` axis; each ``lax.scan`` over a group becomes a loop over that
axis. Entry points:

  forward_train(params, cfg, tokens, ...)            -> logits [B, S, V], aux
  decode_step(params, cfg, token, caches, pos, ...)  -> logits [B, V], caches, aux

Serving state for MoE stacks: ``buddies`` is a BuddyState whose leaves carry
a leading MoE-layer axis [L_moe, ...]. The SSM, hybrid, VLM and audio
families, chunked prefill and paged caches arrive with later slices.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ATTN_DENSE, ATTN_MOE, ModelConfig
from repro_torch.core.policy import BuddyPolicy
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (dense_init, embed_init, resolve_device,
                                       rmsnorm, swiglu, torch_dtype)

_COUNTERS = ("lb", "n_sub", "n_miss", "n_drop", "n_degraded", "n_miss_drop",
             "n_peer", "miss_per_expert")
_RECORDED = ("indices", "probs", "n_sub", "n_miss", "miss_per_expert",
             "substituted", "missed", "degraded", "dropped", "peered")


def _check_stack(cfg: ModelConfig):
    kinds = {k for k, _ in cfg.stack()}
    if not kinds <= {ATTN_DENSE, ATTN_MOE}:
        raise NotImplementedError(
            f"only attention stacks are ported, got {cfg.stack()}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
        moe = kind == ATTN_MOE
        first = _init_attn_block(gen, cfg, dtype, dev, moe)
        stacked = _tree_map(lambda a: torch.empty((repeat, *a.shape),
                                                  dtype=a.dtype, device=dev),
                            first)
        _tree_assign(stacked, 0, first)
        del first
        for i in range(1, repeat):
            _tree_assign(stacked, i, _init_attn_block(gen, cfg, dtype, dev,
                                                      moe))
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
    mode: str                      # "full" | "step"
    window: int                    # effective attention window (0 = full)
    policy: Optional[BuddyPolicy]
    positions: Any                 # [B, S] (full) or int / [B] pos (step)
    record: bool


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


def block_forward(kind: str, p, x, cache, ctx: StepCtx, buddy=None):
    """Returns (x_out, cache, aux_dict_or_None)."""
    cfg = ctx.cfg
    xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if ctx.mode == "full":
        h = attn.attn_forward(p["attn"], xn, ctx.positions, window=ctx.window,
                              **_attn_kwargs(cfg))
    else:
        h, cache = attn.attn_decode(p["attn"], xn, cache, ctx.positions,
                                    window=ctx.window, **_attn_kwargs(cfg))
    x = x + h
    xn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if kind == ATTN_MOE:
        y, moe_aux = moe_mod.moe_forward(
            p["moe"], xn, cfg.moe, policy=ctx.policy, buddy=buddy,
            capacity_factor=2.0 if ctx.mode == "step" else 1.25)
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
    auxs = []
    for i in range(r):
        lp = _tree_map(lambda a: a[i], gparams)
        lc = _tree_map(lambda a: a[i], gcache) if gcache is not None else None
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
    """Ring KV caches for every group, stacked [L, B, C, KV, hd]."""
    _check_stack(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    cap = min(seq_len, window) if window else seq_len
    shape = (cap, cfg.num_kv_heads, cfg.head_dim)
    return tuple({"kv": {"k": torch.zeros((r, batch, *shape), dtype=dtype,
                                          device=dev),
                         "v": torch.zeros((r, batch, *shape), dtype=dtype,
                                          device=dev)}}
                 for _, r in cfg.stack())


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
        gc = caches[gi]["kv"] if caches is not None else None
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
