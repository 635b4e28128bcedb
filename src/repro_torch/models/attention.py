"""Attention: GQA + RoPE, causal/sliding-window full-sequence attention,
ring-buffer KV-cache decode and chunked prefill into the same ring.

Counterpart of ``repro/models/attention.py`` (``attn_forward``, the ring
``attn_decode`` and ``attn_prefill_chunk``). The reference's
``_flash_attend`` is plain jnp (online softmax over kv chunks), so here the
scores are explicit f32 matmuls and a softmax. Paged and cross attention
arrive with their slices. The decode and prefill caches are updated in place
(the caller's stacked cache tensors are written at the new tokens' slots),
which saves a copy of the whole cache per step.

Shapes: x [B, S, D]; q [B, S, H, hd]; k, v [B, S, KV, hd]; g = H // KV.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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


class ChunkPlan(NamedTuple):
    """Where a prefill chunk's tokens go and what each query may see, on the
    device. The same for every layer of a step, so it is built once from the
    host's masks, with one copy up. ``rows``/``cols``/``slots`` list the
    VALID tokens only: the reference aims invalid tokens at slot ``cap`` and
    drops them in its scatter, which torch's indexing cannot do."""
    pos: torch.Tensor          # [B, C] absolute position of each token
    rows: torch.Tensor         # [N] batch row of each valid token
    cols: torch.Tensor         # [N] its index in the chunk
    slots: torch.Tensor        # [N] its ring slot, pos % cap
    valid: torch.Tensor        # [B, C, cap] query x slot visibility


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def chunk_plan(base_pos, tok_valid, cap: int, window: int,
               device) -> ChunkPlan:
    """base_pos [B] and tok_valid [B, C] (the PREFIX validity mask) are host
    data (numpy, or CPU tensors); a device tensor is read back once."""
    base = _host(base_pos).astype(np.int64).reshape(-1)
    tv = _host(tok_valid).astype(bool)
    b, c = tv.shape
    pos = base[:, None] + np.arange(c)[None, :]                     # [B, C]
    rows, cols = np.nonzero(tv)
    # each row's LAST write (the chunk is fully written before any query
    # attends)
    m = base + np.maximum(tv.sum(1), 1) - 1                         # [B]
    n = rows.size
    packed = torch.from_numpy(np.concatenate(
        [pos.reshape(-1), rows, cols, pos[rows, cols] % cap, m])).to(device)
    pos_d = packed[:b * c].view(b, c)
    rows_d, cols_d, slots_d = packed[b * c:b * c + 3 * n].view(3, n)
    m_d = packed[b * c + 3 * n:, None]                              # [B, 1]
    # slot-content positions from the last write: content <= query position
    # masks out both unwritten slots and the row's own later chunk tokens
    content = m_d - ((m_d - torch.arange(cap, device=device)) % cap)
    content, q = content[:, None, :], pos_d[:, :, None]
    valid = (content >= 0) & (content <= q)                         # [B, C, cap]
    if window:
        valid = valid & (content > q - window)
    return ChunkPlan(pos_d, rows_d, cols_d, slots_d, valid)


def attn_prefill_chunk(params, x_chunk, cache, base_pos, tok_valid, *,
                       num_heads, num_kv_heads, head_dim, rope_theta,
                       window: int = 0, plan: Optional[ChunkPlan] = None):
    """Chunked prefill step: C tokens per row written into the ring cache in
    one call. x_chunk [B, C, D]; cache k/v [B, cap, KV, hd] (written in
    place); base_pos [B] the absolute position of each row's first chunk
    token; tok_valid [B, C] the PREFIX validity mask (token j live iff
    j < count(row)). Invalid tokens flow through the fixed-shape step, write
    nothing, and their outputs are garbage the caller discards. ``plan``
    (chunk_plan's, shared by the layers of a step) saves rebuilding the
    indices and the mask per layer.

    The whole chunk is scattered before any query attends, so a chunk that
    wraps the ring would let early queries see slots overwritten by later
    chunk tokens: callers keep a multi-token chunk inside the cache
    (ServeEngine.prefill_rows refuses one that wraps).

    Returns (y [B, C, D], cache). With C == 1 this computes what
    attn_decode's per-row path computes."""
    cap = cache["k"].shape[1]
    if plan is None:
        plan = chunk_plan(base_pos, tok_valid, cap, window, x_chunk.device)
    q, k_new, v_new = _project_qkv(params, x_chunk, num_heads, num_kv_heads,
                                   head_dim)
    q = apply_rope(q, plan.pos, rope_theta)
    k_new = apply_rope(k_new, plan.pos, rope_theta)
    cache["k"][plan.rows, plan.slots] = k_new[plan.rows, plan.cols]
    cache["v"][plan.rows, plan.slots] = v_new[plan.rows, plan.cols]
    out = _attend(q, cache["k"], cache["v"], plan.valid)
    return _out_proj(out, params["wo"], x_chunk.dtype), cache
