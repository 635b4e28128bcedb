"""Attention: GQA + RoPE, causal/sliding-window full-sequence attention and
ring-buffer KV-cache decode.

Counterpart of ``repro/models/attention.py`` (``attn_forward`` and the ring
``attn_decode``). The reference's ``_flash_attend`` is plain jnp (online
softmax over kv chunks), so here the scores are explicit f32 matmuls and a
softmax. Chunked-prefill, paged and cross attention arrive with their
slices. The decode cache is updated in place (the caller's stacked cache
tensors are written at the new token's slot), which saves a copy of the
whole cache per step.

Shapes: x [B, S, D]; q [B, S, H, hd]; k, v [B, S, KV, hd]; g = H // KV.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_rope, dense_init

NEG_INF = -1e30


def init_attn(gen, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, device) -> dict:
    return {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype, device),
    }


def _project_qkv(params, x, num_heads, num_kv_heads, head_dim):
    b, s, _ = x.shape
    q = torch.matmul(x, params["wq"]).reshape(b, s, num_heads, head_dim)
    k = torch.matmul(x, params["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = torch.matmul(x, params["wv"]).reshape(b, s, num_kv_heads, head_dim)
    return q, k, v


def _out_proj(out, wo, dtype):
    b, s = out.shape[:2]
    return torch.matmul(out.reshape(b, s, -1).float(), wo.float()).to(dtype)


def _attend(q, k, v, valid):
    """q [B, Sq, H, hd] against k, v [B, Skv, KV, hd]; valid broadcastable
    to [B, Sq, Skv]. Scores and softmax in f32. Returns [B, Sq, H, hd]."""
    b, sq, h, hd = q.shape
    kv_h = k.shape[2]
    qg = q.reshape(b, sq, kv_h, h // kv_h, hd).float()
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, k.float()) * (hd ** -0.5)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attn_forward(params, x, positions, *, num_heads, num_kv_heads, head_dim,
                 rope_theta, window: int = 0):
    """Full-sequence causal self-attention (train / profiling).
    positions [B, S]; window 0 = unbounded."""
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    s = x.shape[1]
    qpos = torch.arange(s, device=x.device)[:, None]
    kpos = torch.arange(s, device=x.device)[None, :]
    valid = kpos <= qpos
    if window:
        valid = valid & (kpos > qpos - window)
    out = _attend(q, k, v, valid[None])
    return _out_proj(out, params["wo"], x.dtype)


def attn_decode(params, x_tok, cache, pos, *, num_heads, num_kv_heads,
                head_dim, rope_theta, window: int = 0):
    """One decode step. x_tok [B, 1, D]; cache k/v [B, C, KV, hd] (written
    in place); pos is the absolute position of the new token — an int (the
    whole batch in lockstep) or a [B] tensor (each row at its own position).
    Ring-buffer write at pos % C per row. Returns (y [B, 1, D], cache)."""
    b = x_tok.shape[0]
    dev = x_tok.device
    cap = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(params, x_tok, num_heads, num_kv_heads,
                                   head_dim)
    per_row = torch.is_tensor(pos) and pos.ndim == 1
    if per_row:
        pos_b = pos.to(device=dev, dtype=torch.int64)[:, None]       # [B, 1]
    else:
        pos_b = torch.full((1, 1), int(pos), dtype=torch.int64, device=dev)
    rope_pos = pos_b.expand(b, 1)
    q = apply_rope(q, rope_pos, rope_theta)
    k_new = apply_rope(k_new, rope_pos, rope_theta)
    if per_row:
        rows = torch.arange(b, device=dev)
        slots = pos_b[:, 0] % cap
        cache["k"][rows, slots] = k_new[:, 0]
        cache["v"][rows, slots] = v_new[:, 0]
    else:
        slot = int(pos) % cap
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]

    # absolute position of each slot given the ring has wrapped: the latest
    # write <= pos. [B, C] (per-row) or [1, C] (lockstep)
    idx = torch.arange(cap, device=dev)[None, :]
    abs_pos = pos_b - ((pos_b - idx) % cap)
    valid = (abs_pos >= 0) & (abs_pos <= pos_b)
    if window:
        valid = valid & (abs_pos > pos_b - window)
    out = _attend(q, cache["k"], cache["v"], valid[:, None, :])
    return _out_proj(out, params["wo"], x_tok.dtype), cache
