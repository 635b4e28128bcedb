"""Decoder stack for every family: attention (ATTN_DENSE / ATTN_MOE),
RWKV6, the Mamba2 hybrid, the VLM and audio.

Counterpart of ``repro/models/transformer.py``. Parameters are a nested dict
with the reference's keys and each group's layers stacked on a leading
``[L, ...]`` axis; each ``lax.scan`` over a group becomes a loop over that
axis. A super-block group nests a second stack in each of its layers:
``hybrid_super`` (Zamba2) is ``attn_every`` Mamba2 layers ``[R, attn_every,
...]``, then the ONE ``shared_attn`` block under the super's own
pre-attention norm ``ln_attn``; ``vlm_super`` (Llama-3.2-Vision) is
``cross_attn_every - 1`` self-attention layers ``[R, n_self, ...]``, then a
cross-attention block over the conditioning projected by ``cond_proj``.
The audio family (MusicGen) puts its projected conditioning in front of
the tokens as a causal prefix. Entry points:

  forward_train(params, cfg, tokens, ...)            -> logits [B, S, V], aux
  prefill(params, cfg, tokens)                       -> logits [B, S, V]
  decode_step(params, cfg, token, caches, pos, ...)  -> logits [B, V], caches, aux
  prefill_chunk(params, cfg, tokens, caches, base_pos, tok_valid, ...)
                                                     -> logits [B, C, V], caches, aux

``cond_embeds`` [B, Nc, cond_dim] go where the reference's go, and the
reference's behaviour is kept as it is: VLM decode attends over the zero
``cross_kv`` of ``init_caches`` (its cross blocks add only their FFN);
audio decode and chunked prefill shift positions by ``num_cond_tokens``,
but no entry point writes the prefix into the cache; a VLM forward without
``cond_embeds`` runs each cross block as causal self-attention with RoPE;
an audio forward without them raises.

Serving state for MoE stacks: ``buddies`` is a BuddyState whose leaves carry
a leading MoE-layer axis [L_moe, ...]. Decode caches (ring KV, RWKV6 and
Mamba2 states) are updated in place; chunked prefill writes the same ring
KV caches. With ``block_tables`` (attention stacks only) decode and chunked
prefill read and write a paged KV block pool instead
(``init_paged_caches``).
"""
from __future__ import annotations

import itertools
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_DENSE, ATTN_MOE, CROSS_DENSE,
                                      MAMBA2, RWKV, ModelConfig)
from repro_torch.core.policy import BuddyPolicy
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rw
from repro_torch.models.common import (dense_init, embed_init, fold_in,
                                       is_sharded, local_call, local_range,
                                       no_partial, remap, resolve_device,
                                       rmsnorm, settle, shard, swiglu,
                                       torch_dtype, tree_leaves, tree_map,
                                       with_partial)
from repro_torch.runtime import trace

_COUNTERS = ("lb", "n_sub", "n_miss", "n_drop", "n_degraded", "n_miss_drop",
             "n_peer", "miss_per_expert")
_RECORDED = ("indices", "probs", "n_sub", "n_miss", "miss_per_expert",
             "substituted", "missed", "degraded", "dropped", "peered")
HYBRID_SUPER = "hybrid_super"
VLM_SUPER = "vlm_super"


def require_attention_stack(cfg: ModelConfig, what: str):
    """Chunked prefill and the row hooks need ring KV caches whose leaves
    are [L, B, ...]: attention stacks only (SSM states are sequential)."""
    if not all(k in (ATTN_DENSE, ATTN_MOE) for k, _ in cfg.stack()):
        raise ValueError(f"{what} supports attention stacks only, got "
                         f"{cfg.stack()}")


def _tree_assign(dst, i, src):
    if isinstance(dst, dict):
        for k in dst:
            _tree_assign(dst[k], i, src[k])
    else:
        dst[i].copy_(src)


def _layers(stacked) -> list:
    """The layers of a stacked tree, one tree per index of its leading
    axis. One unbind per leaf: its backward stacks the layers' gradients
    once, where indexing would scatter each into a zero [R, ...] tensor."""
    leaves = [a.unbind(0) for a in tree_leaves(stacked)]
    out = []
    for i in range(len(leaves[0])):
        ith = iter([a[i] for a in leaves])
        out.append(tree_map(lambda _: next(ith), stacked))
    return out


def _at(tree, i: int):
    """Entry i of every leaf (a layer's view of a stacked cache)."""
    return None if tree is None else tree_map(lambda a: a[i], tree)


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
    if kind in (ATTN_DENSE, CROSS_DENSE, ATTN_MOE):
        return _init_attn_block(gen, cfg, dtype, device, kind == ATTN_MOE)
    if kind == RWKV:
        s = cfg.ssm
        p = rw.init_rwkv(gen, cfg.d_model, s.num_heads, s.head_dim, cfg.d_ff,
                         dtype, device)
        p["ln1"] = torch.ones(cfg.d_model, dtype=torch.float32, device=device)
        p["ln2"] = torch.ones(cfg.d_model, dtype=torch.float32, device=device)
        return p
    if kind == MAMBA2:
        return {"ln": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
                "mamba": mb.init_mamba(gen, cfg.d_model, cfg.ssm, dtype,
                                       device)}
    raise ValueError(kind)


def _init_stacked(gen, kind: str, lead: tuple, cfg: ModelConfig, dtype,
                  device):
    """Blocks of ``kind`` stacked on the leading axes ``lead``, each made
    and written straight into its place in the stacked tensors."""
    stacked = None
    for idx in itertools.product(*(range(n) for n in lead)):
        blk = _init_block(gen, kind, cfg, dtype, device)
        if stacked is None:
            stacked = tree_map(lambda a: torch.empty(
                (*lead, *a.shape), dtype=a.dtype, device=device), blk)
        _tree_assign(stacked, idx, blk)
    return stacked


def _init_group(gen, kind: str, repeat: int, cfg: ModelConfig, dtype,
                device):
    if kind == HYBRID_SUPER:
        return {"mamba": _init_stacked(gen, MAMBA2, (repeat, cfg.attn_every),
                                       cfg, dtype, device),
                "ln_attn": torch.ones(repeat, cfg.d_model,
                                      dtype=torch.float32, device=device)}
    if kind == VLM_SUPER:
        n_self = cfg.cross_attn_every - 1
        return {"self": _init_stacked(gen, ATTN_DENSE, (repeat, n_self), cfg,
                                      dtype, device),
                "cross": _init_stacked(gen, CROSS_DENSE, (repeat,), cfg,
                                       dtype, device)}
    return _init_stacked(gen, kind, (repeat,), cfg, dtype, device)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random weights from a torch.Generator (seed 0 when none is given),
    made on ``device``. Layers are written straight into their stacked
    [L, ...] (a super-block's [R, n, ...]) tensors, so the peak is the
    model plus one layer. ``cond_proj`` [cond_dim, D] where the config has
    conditioning tokens; the hybrid's one ``shared_attn`` block. On the
    meta device (shapes and dtypes only, no memory) the default generator
    is a CPU one, since there is no generator on meta; it draws nothing."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(0)
    dtype = torch_dtype(cfg.dtype)
    params: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, dev)}
    if cfg.num_cond_tokens:
        params["cond_proj"] = dense_init(gen, cfg.cond_dim, cfg.d_model,
                                         dtype, dev)
    params["groups"] = tuple(_init_group(gen, kind, repeat, cfg, dtype, dev)
                             for kind, repeat in cfg.stack())
    if cfg.family == "hybrid":
        # zamba2's shared attention block: ONE parameter set reused at
        # every application
        params["shared_attn"] = _init_attn_block(gen, cfg, dtype, dev,
                                                 moe=False)
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
    paged: Optional[attn.PagedPlan] = None  # the paged step's (None = ring)
    rng: Optional[torch.Generator] = None   # router jitter (a layer's own)
    remat: bool = False            # checkpoint each block (training)


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


def _self_attn(p, x, cache, ctx: StepCtx):
    """Self-attention of one layer in the step's mode: "full" through
    attn_forward's chunked online softmax, decode and chunks against the
    ring or paged cache ``cache`` (None in "full" mode), written in
    place."""
    kw = _attn_kwargs(ctx.cfg)
    if ctx.mode == "full":
        return attn.attn_forward(p, x, ctx.positions, window=ctx.window,
                                 **kw)
    if ctx.paged is not None and ctx.mode == "chunk":
        return attn.attn_prefill_chunk_paged(
            p, x, cache, ctx.positions, ctx.tok_valid, None, plan=ctx.paged,
            **kw)[0]
    if ctx.paged is not None:
        return attn.attn_decode_paged(p, x, cache, ctx.positions, None,
                                      plan=ctx.paged, **kw)[0]
    if ctx.mode == "chunk":
        return attn.attn_prefill_chunk(p, x, cache, ctx.positions,
                                       ctx.tok_valid, window=ctx.window,
                                       plan=ctx.plan, **kw)[0]
    return attn.attn_decode(p, x, cache, ctx.positions, window=ctx.window,
                            **kw)[0]


class _Residual(torch.autograd.Function):
    """x + h under a mesh: a partial sum in h (a product over the split
    d_ff or heads) is reduced first, so the residual stream stays whole on
    the model axis, as the reference's embedding hint leaves it; and its
    gradient is reduced the same way before it goes back to x and h (one
    all-reduce per sublayer each way, as a tensor-parallel step makes).
    Else DTensor would carry the partial sums on, through the norm and the
    next products, and gather their weights to keep them."""

    @staticmethod
    def forward(ctx, x, h):
        return x + settle(h)

    @staticmethod
    def backward(ctx, g):
        g = settle(g)
        return g, g


def _residual(x, h):
    """x + h (``_Residual`` under a mesh)."""
    if is_sharded(h):
        return _Residual.apply(x, h)
    return x + h


def _zero_state(x, make):
    """``make(batch)``: a recurrent block's zero state for x's rows. Under
    a mesh, rank 0's rows, as DTensors split by batch as x is (a state
    made whole would be taken as replicated, and the batch with it)."""
    if not is_sharded(x):
        return make(x.shape[0])
    from torch.distributed.tensor import DTensor
    pl = no_partial(remap(x.placements, {0: 0}))
    return {k: DTensor.from_local(v, x.device_mesh, pl, run_check=False)
            for k, v in make(local_range(x, 0)[1]).items()}


def _rwkv_block(p, x, cache, ctx: StepCtx):
    """RWKV6 time mix + channel mix. "full" starts from zero state and
    drops the final one; "step" reads the layer's state from ``cache`` and
    writes the new state back into it in place."""
    cfg = ctx.cfg
    st = cache if cache is not None else _zero_state(
        x, lambda b: rw.init_rwkv_state(b, cfg.ssm.num_heads,
                                        cfg.ssm.head_dim, cfg.d_model,
                                        x.device))
    h, wkv, x_tm = rw.rwkv_time_mix(
        p, rmsnorm(x, p["ln1"], cfg.norm_eps), st["wkv"],
        st["x_tm"].to(x.dtype), num_heads=cfg.ssm.num_heads,
        head_dim=cfg.ssm.head_dim)
    x = _residual(x, h)
    h, x_cm = rw.rwkv_channel_mix(p, rmsnorm(x, p["ln2"], cfg.norm_eps),
                                  st["x_cm"].to(x.dtype))
    if cache is not None:
        cache["wkv"].copy_(wkv)
        cache["x_tm"].copy_(x_tm)
        cache["x_cm"].copy_(x_cm)
    return _residual(x, h), cache, None


def _mamba_block(p, x, cache, ctx: StepCtx):
    """Mamba2 under its pre-norm. Without ``cache`` from zero state, the
    final state dropped; with it, the layer's state read and the new one
    written back in place."""
    cfg = ctx.cfg
    st = cache if cache is not None else _zero_state(
        x, lambda b: mb.init_mamba_state(b, cfg.d_model, cfg.ssm, x.device))
    h, new = mb.mamba_forward(p["mamba"], rmsnorm(x, p["ln"], cfg.norm_eps),
                              st, cfg.ssm, cfg.d_model)
    if cache is not None:
        cache["conv"].copy_(new["conv"])
        cache["ssm"].copy_(new["ssm"])
    return _residual(x, h), cache, None


def block_forward(kind: str, p, x, cache, ctx: StepCtx, buddy=None):
    """Returns (x_out, cache, aux_dict_or_None)."""
    cfg = ctx.cfg
    if kind == RWKV:
        return _rwkv_block(p, x, cache, ctx)
    if kind == MAMBA2:
        return _mamba_block(p, x, cache, ctx)
    if kind == CROSS_DENSE:
        raise ValueError("cross-attn blocks run inside vlm_super groups")
    with trace.span("model.attn"):
        x = _residual(x, _self_attn(p["attn"],
                                    rmsnorm(x, p["ln1"], cfg.norm_eps),
                                    cache, ctx))
    xn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if kind == ATTN_MOE:
        y, moe_aux = moe_mod.moe_forward(
            p["moe"], xn, cfg.moe, policy=ctx.policy, buddy=buddy,
            capacity_factor=2.0 if ctx.mode == "step" else 1.25,
            dropless=ctx.mode == "chunk", rng=ctx.rng)
        aux = _moe_aux_dict(moe_aux, ctx.record)
    else:
        with trace.span("model.ffn"):
            y = swiglu(xn, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
    return _residual(x, y), cache, aux


def _zero_moe_aux(cfg: ModelConfig, device) -> dict:
    e = cfg.moe.num_experts if cfg.is_moe else 1
    z = {k: torch.zeros((), dtype=torch.int32, device=device)
         for k in _COUNTERS}
    z["lb"] = torch.zeros((), dtype=torch.float32, device=device)
    z["miss_per_expert"] = torch.zeros(e, dtype=torch.int32, device=device)
    return z


def _hybrid_super(lp, x, lc, ctx: StepCtx, shared):
    """One Zamba2 super-block: its Mamba2 layers, then the shared
    attention block under the super's ``ln_attn`` (its FFN under the
    shared ``ln2``; the shared ``ln1`` is never read, as the reference)."""
    cfg = ctx.cfg
    for i, mp in enumerate(_layers(lp["mamba"])):
        x, _, _ = _mamba_block(mp, x, _at(lc and lc["mamba"], i), ctx)
    x = _residual(x, _self_attn(shared["attn"], rmsnorm(x, lp["ln_attn"],
                                                        cfg.norm_eps),
                                lc and lc["kv"], ctx))
    xn = rmsnorm(x, shared["ln2"], cfg.norm_eps)
    return _residual(x, swiglu(xn, shared["ffn"]["w1"], shared["ffn"]["w3"],
                               shared["ffn"]["w2"]))


def _vlm_super(lp, x, lc, ctx: StepCtx, cross_embeds):
    """One Llama-3.2-Vision super-block: its self-attention layers, then
    the cross-attention block."""
    for i, sp in enumerate(_layers(lp["self"])):
        x, _, _ = block_forward(ATTN_DENSE, sp, x,
                                _at(lc and lc["self_kv"], i), ctx)
    return _cross_block(lp["cross"], x, ctx, cross_embeds,
                        lc and lc["cross_kv"])


def _cross_block(cp, x, ctx: StepCtx, cross_embeds, cross_kv):
    """Full mode: attention to ``cross_embeds`` (None: causal
    self-attention with RoPE, window 0, as the reference's attn_forward
    without them). Step mode: the new token against ``cross_kv``."""
    cfg = ctx.cfg
    xn = rmsnorm(x, cp["ln1"], cfg.norm_eps)
    if ctx.mode == "full":
        h = attn.attn_forward(cp["attn"], xn, ctx.positions,
                              cross_embeds=cross_embeds, **_attn_kwargs(cfg))
    else:
        h, _ = attn.attn_decode(cp["attn"], xn, None, ctx.positions,
                                cross_kv=cross_kv, **_attn_kwargs(cfg))
    x = _residual(x, h)
    xn = rmsnorm(x, cp["ln2"], cfg.norm_eps)
    return _residual(x, swiglu(xn, cp["ffn"]["w1"], cp["ffn"]["w3"],
                               cp["ffn"]["w2"]))


def _run_group(kind: str, gparams, x, gcache, ctx: StepCtx, gbuddy=None,
               shared_attn=None, cross_embeds=None, layer0: int = 0):
    """One group, layer by layer over the stacked [R, ...] params; under
    ``ctx.remat`` one torch.utils.checkpoint per block, or per super-block
    (the hybrid's with ``shared_attn``, the VLM's with ``cross_embeds``),
    as the reference's jax.checkpoint of its scan body. Layer i's router
    jitter draws from ``fold_in`` of the ctx generator's seed and i, as
    the reference folds its key per layer; the generator is made inside
    the layer, so that under remat the recomputed forward draws the same
    noise and routes the same. ``layer0`` is the stack index of the
    group's first layer (the host spans' layer). Returns (x, cache,
    reduced aux)."""
    if kind in (HYBRID_SUPER, VLM_SUPER):
        body, extra = ((_hybrid_super, shared_attn) if kind == HYBRID_SUPER
                       else (_vlm_super, cross_embeds))
        for i, lp in enumerate(_layers(gparams)):
            lc = _at(gcache, i)
            if ctx.remat:
                x = checkpoint(body, lp, x, lc, ctx, extra,
                               use_reentrant=False)
            else:
                x = body(lp, x, lc, ctx, extra)
        return x, gcache, _zero_moe_aux(ctx.cfg, x.device)

    def layer(lp, x, lc, lb, i):
        lctx = ctx if ctx.rng is None else ctx._replace(
            rng=fold_in(ctx.rng.initial_seed(), i, ctx.rng.device))
        return block_forward(kind, lp, x, lc, lctx, buddy=lb)

    auxs = []
    for i, lp in enumerate(_layers(gparams)):
        lc = _at(gcache, i)
        lb = (moe_mod.BuddyState(*[None if a is None else a[i]
                                   for a in gbuddy])
              if gbuddy is not None else None)
        with trace.span("model.layer", layer0 + i):
            if ctx.remat:
                x, _, aux = checkpoint(layer, lp, x, lc, lb, i,
                                       use_reentrant=False)
            else:
                x, _, aux = layer(lp, x, lc, lb, i)
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
def effective_window(cfg: ModelConfig, seq_len: int,
                     long_context: bool = False) -> int:
    """Attention window for decode: the config's sliding window if it has
    one; long-context decode on a full-attention arch falls back to an
    8,192-token window (the reference's rule); else 0, full attention."""
    if cfg.sliding_window:
        return cfg.sliding_window
    if long_context:
        return 8192
    return 0


def _kv_capacity(cfg: ModelConfig, seq_len: int, window: int) -> int:
    total = seq_len + cfg.num_cond_tokens
    return min(total, window) if window else total


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                window: int = 0, device="cuda", cond_embeds=None,
                params=None):
    """Decode caches for every group, stacked on the group's layers (a
    super-block's on [R, n, ...]): ring KV caches [L, B, C, KV, hd] for
    attention, C = seq_len + num_cond_tokens (at most ``window``); RWKV6
    states (wkv [L, B, H, dk, dv], x_tm and x_cm [L, B, 1, D]) and Mamba2
    states (conv [L, B, W-1, inner], ssm [L, B, H, hd, N]), f32; the VLM's
    ``cross_kv`` (k, v) [R, B, Nc, KV, hd], zeros. ``cond_embeds`` and
    ``params`` are taken and not used, as the reference's."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    kv_shape = (batch, _kv_capacity(cfg, seq_len, window), cfg.num_kv_heads,
                cfg.head_dim)

    def kv(*lead):
        return {k: torch.zeros((*lead, *kv_shape), dtype=dtype, device=dev)
                for k in ("k", "v")}

    def states(st, *lead):
        return {k: torch.zeros((*lead, *a.shape), dtype=a.dtype, device=dev)
                for k, a in st.items()}

    def mamba(*lead):
        return states(mb.init_mamba_state(batch, cfg.d_model, cfg.ssm, dev),
                      *lead)

    caches = []
    for kind, r in cfg.stack():
        if kind == RWKV:
            caches.append(states(rw.init_rwkv_state(
                batch, cfg.ssm.num_heads, cfg.ssm.head_dim, cfg.d_model,
                dev), r))
        elif kind == MAMBA2:
            caches.append(mamba(r))
        elif kind == HYBRID_SUPER:
            caches.append({"mamba": mamba(r, cfg.attn_every), "kv": kv(r)})
        elif kind == VLM_SUPER:
            shape = (r, batch, cfg.num_cond_tokens, cfg.num_kv_heads,
                     cfg.head_dim)
            caches.append({"self_kv": kv(r, cfg.cross_attn_every - 1),
                           "cross_kv": tuple(torch.zeros(
                               shape, dtype=dtype, device=dev)
                               for _ in range(2))})
        else:
            caches.append({"kv": kv(r)})
    return tuple(caches)


def init_paged_caches(cfg: ModelConfig, n_blocks: int, block_size: int, *,
                      device="cuda"):
    """Paged decode caches: one shared block pool per layer, k and v
    [L, P, bs, KV, hd] stacked on the group's layers, addressed through
    the host's PagedKVPool block tables instead of a per-row ring.
    Attention stacks only (an SSM state is sequential and has no pages)."""
    require_attention_stack(cfg, "paged KV")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    shape = (n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return tuple({"kv": {k: torch.zeros((r, *shape), dtype=dtype, device=dev)
                         for k in ("k", "v")}} for _, r in cfg.stack())


# ===========================================================================
# Entry points
# ===========================================================================
def _lookup(embed, ids):
    """``embed[ids]``. Under a mesh, on rank 0's rows of ids and its block
    of the table (``local_call``): the table split by d_model keeps the
    gather local, as the reference's layout means it to (DTensor's own
    rule for the gradient's scatter fails on some torch versions); its
    gradient is a partial sum over the axes that split the ids."""
    if not is_sharded(embed):
        return embed[ids]
    from torch.distributed.tensor import Replicate, Shard
    ids_pl = ids.placements if is_sharded(ids) else \
        (Replicate(),) * embed.device_mesh.ndim
    n = len(ids.shape)
    e_pl, out_pl = [], []
    for i, e in zip(ids_pl, embed.placements):
        e = Replicate() if i.is_shard() or not e.is_shard(1) else e
        e_pl.append(e)
        out_pl.append(i if i.is_shard() else
                      (Shard(n) if e.is_shard(1) else Replicate()))
    e_pl = tuple(e_pl)
    return local_call(lambda e, i: e[i], (embed, ids), (e_pl, ids_pl),
                      tuple(out_pl),
                      (with_partial(e_pl, {m for m, p in enumerate(ids_pl)
                                           if p.is_shard()}), ids_pl))


def _embed(params, cfg: ModelConfig, tokens, cond_embeds):
    with trace.span("model.embed"):
        x = shard(_lookup(params["embed"], tokens), "batch", None, None)
    if cfg.num_cond_tokens and cfg.family == "audio":
        # audio: the stubbed codec frame embeddings as a causal prefix
        if cond_embeds is None:
            raise ValueError(
                f"{cfg.arch_id}: the audio forward needs cond_embeds "
                f"[B, {cfg.num_cond_tokens}, {cfg.cond_dim}], its "
                "conditioning prefix; none was given")
        pre = torch.matmul(cond_embeds, params["cond_proj"]).to(x.dtype)
        x = torch.cat([pre, x], dim=1)
    return x


def _project_cross(params, cfg: ModelConfig, cond_embeds):
    if cfg.family == "vlm" and cond_embeds is not None:
        return torch.matmul(cond_embeds, params["cond_proj"]).to(
            torch_dtype(cfg.dtype))
    return None


def _audio_offset(cfg: ModelConfig) -> int:
    """The positions the conditioning prefix takes before the first token
    (audio only)."""
    return cfg.num_cond_tokens if cfg.family == "audio" else 0


def _logits(params, cfg: ModelConfig, x):
    with trace.span("model.head"):
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = torch.matmul(x.float(), head.float())
        return shard(logits, "batch", *([None] * (logits.ndim - 2)),
                     "vocab")


def _iter_groups(params, cfg, caches, buddies):
    """Yields (kind, gparams, gcache, gbuddy, layer0) with MoE buddy
    slices; layer0 is the stack index of the group's first layer."""
    moe_off = layer0 = 0
    for gi, (kind, repeat) in enumerate(cfg.stack()):
        gc = None
        if caches is not None:
            gc = (caches[gi]["kv"] if kind in (ATTN_DENSE, ATTN_MOE)
                  else caches[gi])
        gb = None
        if kind == ATTN_MOE and buddies is not None:
            gb = moe_mod.BuddyState(*[None if a is None
                                      else a[moe_off:moe_off + repeat]
                                      for a in buddies])
            moe_off += repeat
        yield kind, params["groups"][gi], gc, gb, layer0
        layer0 += repeat


def _accumulate(total, aux, rec, record: bool):
    for k in _COUNTERS:
        total[k] = total[k] + aux[k]
    if record and "per_layer" in aux:
        rec.append(aux["per_layer"])


def _run(params, cfg: ModelConfig, x, caches, ctx: StepCtx, buddies,
         cross=None):
    """Every group in order. Returns (x, aux)."""
    total = _zero_moe_aux(cfg, x.device)
    rec = []
    for kind, gp, gc, gb, l0 in _iter_groups(params, cfg, caches, buddies):
        x, _, aux = _run_group(kind, gp, x, gc, ctx, gbuddy=gb,
                               shared_attn=params.get("shared_attn"),
                               cross_embeds=cross, layer0=l0)
        _accumulate(total, aux, rec, ctx.record)
    if ctx.record:
        total["recorded"] = rec
    return x, total


def forward_train(params, cfg: ModelConfig, tokens, *, cond_embeds=None,
                  policy: Optional[BuddyPolicy] = None, buddies=None,
                  rng: Optional[torch.Generator] = None,
                  record: bool = False, window: int = -1,
                  remat: bool = False):
    """Full-sequence forward. tokens [B, S] on the params' device;
    cond_embeds [B, Nc, cond_dim] (VLM: the cross blocks' keys and values;
    audio: the prefix, required); ``rng`` a generator on that device for
    the router jitter (None: no jitter); ``remat`` recomputes each block's
    (or super-block's) activations in the backward.
    Returns (logits [B, S, V] f32, aux); the audio prefix has no logits."""
    if window < 0:
        window = cfg.sliding_window
    x = _embed(params, cfg, tokens, cond_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    ctx = StepCtx(cfg, "full", window, policy, positions, record, rng=rng,
                  remat=remat)
    x, total = _run(params, cfg, x, None, ctx, buddies,
                    cross=_project_cross(params, cfg, cond_embeds))
    return _logits(params, cfg, x[:, _audio_offset(cfg):]), total


def decode_step(params, cfg: ModelConfig, token, caches, pos, *,
                cond_embeds=None, policy: Optional[BuddyPolicy] = None,
                buddies=None, window: int = -1, record: bool = False,
                block_tables=None):
    """One-token decode. token [B] int tensor; pos an int (lockstep batch)
    or a [B] tensor of per-row positions, counted from the first token
    (the audio family adds ``num_cond_tokens``); caches from init_caches
    (updated in place). block_tables [B, MB] (host data, -1 = unmapped)
    routes attention through the paged pool of init_paged_caches instead;
    pos is then per-row host data (a lockstep int is broadcast).
    ``cond_embeds`` is taken and not used, as the reference's: the VLM's
    cross blocks attend over the caches' ``cross_kv``.
    Returns (logits [B, V] f32, caches, aux)."""
    if window < 0:
        window = cfg.sliding_window
    with trace.span("model.embed"):
        x = _lookup(params["embed"], token)[:, None, :]           # [B, 1, D]
    if _audio_offset(cfg):
        pos = pos + _audio_offset(cfg)
    with trace.span("model.plan"):
        paged = (None if block_tables is None else attn.paged_plan(
            block_tables, pos, None, caches[0]["kv"]["k"].shape[2],
            x.device))
    ctx = StepCtx(cfg, "step", window, policy, pos, record, paged=paged)
    x, total = _run(params, cfg, x, caches, ctx, buddies)
    return _logits(params, cfg, x[:, 0]), caches, total


def prefill_chunk(params, cfg: ModelConfig, tokens, caches, base_pos,
                  tok_valid, *, policy: Optional[BuddyPolicy] = None,
                  buddies=None, window: int = -1, record: bool = False,
                  block_tables=None):
    """Fused multi-token step for chunked prefill (continuous batching).

    tokens [B, C] int tensor on the params' device; base_pos [B] the
    absolute position of each row's first chunk token (the audio family
    adds ``num_cond_tokens``) and tok_valid [B, C] the PREFIX validity
    mask, both host data (numpy): row b's tokens j < count(b) are live,
    the rest ride the fixed-shape step and write nothing. A decode row
    joins the step as a 1-valid-token chunk, so one step serves prefill
    and decode rows together. caches from init_caches (updated in place),
    or with block_tables [B, MB] (host data) the paged pool of
    init_paged_caches.

    Returns (logits [B, C, V] f32, caches, aux). aux token axes are the
    flattened [B*C] chunk (row-major): mask them with tok_valid on the host.
    MoE dispatch is dropless in this mode, so per-token outputs do not
    depend on the chunk size."""
    require_attention_stack(cfg, "chunked prefill")
    if window < 0:
        window = cfg.sliding_window
    with trace.span("model.embed"):
        x = shard(_lookup(params["embed"], tokens), "batch", None,
                  None)                                           # [B, C, D]
    if _audio_offset(cfg):
        base_pos = base_pos + _audio_offset(cfg)
    plan = paged = None
    width = caches[0]["kv"]["k"].shape[2]          # ring capacity, or block
    with trace.span("model.plan"):
        if block_tables is None:
            plan = attn.chunk_plan(base_pos, tok_valid, width, window,
                                   x.device)
        else:
            paged = attn.paged_plan(block_tables, base_pos, tok_valid,
                                    width, x.device)
    ctx = StepCtx(cfg, "chunk", window, policy, base_pos, record,
                  tok_valid=tok_valid, plan=plan, paged=paged)
    x, total = _run(params, cfg, x, caches, ctx, buddies)
    return _logits(params, cfg, x), caches, total                 # [B, C, V]


def prefill(params, cfg: ModelConfig, tokens, *, cond_embeds=None,
            window: int = -1):
    """Full-sequence forward (the prefill compute): forward_train's logits.
    The serving engine builds decode caches through decode_step or
    prefill_chunk."""
    return forward_train(params, cfg, tokens, cond_embeds=cond_embeds,
                         window=window)[0]
