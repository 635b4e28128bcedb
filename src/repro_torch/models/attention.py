"""Attention: GQA + RoPE, causal/sliding-window full-sequence attention,
ring-buffer KV-cache decode and chunked prefill into the same ring, and
decode and chunked prefill against a paged KV block pool.

Counterpart of ``repro/models/attention.py`` (``attn_forward`` and its
``_flash_attend``, the ring ``attn_decode`` and ``attn_prefill_chunk``, the
paged ``attn_decode_paged`` and ``attn_prefill_chunk_paged``). The
reference's ``_flash_attend`` is plain jnp, an online softmax over q chunks
of 512 and kv chunks of 1024, so here it is the same recurrence in torch
ops (``_flash_attend``): every full-sequence forward (train, prefill, the
VLM's cross attention, the similarity calibration) goes through it, and no
[Sq, Skv] score matrix is built. Decode and chunked prefill, ring or
paged, attend through ``_attend``, an explicit f32 softmax over the whole
cache, as the reference's unchunked ``_attend_single`` / ``_attend_chunk``
and paged einsums are. Cross attention (the VLM's image layers) attends
from the text to projected conditioning embeddings, with no RoPE and no
mask, in ``attn_forward`` and ``attn_decode``. The decode and prefill
caches, ring or pool, are updated in place (the caller's stacked cache
tensors are written at the new tokens' slots), which saves a copy of the
whole cache per step.

Shapes: x [B, S, D]; q [B, S, H, hd]; k, v [B, S, KV, hd]; g = H // KV.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import (all_reduce, apply_rope, coordinate,
                                       dense_init, is_sharded, local_call,
                                       local_range, no_partial, padded_split,
                                       remap, reshape, settle, shard,
                                       shard_dims, unpad, ways, whole,
                                       with_partial)
from repro_torch.runtime import trace

NEG_INF = -1e30


def init_attn(gen, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, device) -> dict:
    return {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype, device),
    }


def _split_heads(t, b: int, s: int, n_heads: int, head_dim: int):
    """[B, S, n * hd] -> [B, S, n, hd]. Under a mesh, a projection whose
    feature split does not fall on head boundaries (the model axis does
    not divide the heads) is gathered first: DTensor cannot view it."""
    return whole(t, n_heads, 2).reshape(b, s, n_heads, head_dim)


def _project_qkv(params, x, x_kv, num_heads, num_kv_heads, head_dim):
    b, s, _ = x.shape
    skv = x_kv.shape[1]
    q = _split_heads(torch.matmul(x, params["wq"]), b, s, num_heads,
                     head_dim)
    k = _split_heads(torch.matmul(x_kv, params["wk"]), b, skv, num_kv_heads,
                     head_dim)
    v = _split_heads(torch.matmul(x_kv, params["wv"]), b, skv, num_kv_heads,
                     head_dim)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def _out_proj(out, wo, dtype):
    """[B, S, H, hd] @ wo -> [B, S, D]: the rows folded by hand (the fold
    torch.matmul makes on a plain tensor; on a DTensor of one token per
    row it would expand wo into a bmm)."""
    b, s = out.shape[:2]
    y = torch.matmul(reshape(out, b * s, -1).float(), wo.float())
    return settle(y).to(dtype).reshape(b, s, -1)


def _cache_out_proj(out, wo, num_kv_heads: int, dtype):
    """The output projection of the cache paths (decode, chunked prefill,
    paged). Split over more than one device, it is the reference's 4-D
    form: wo as [KV, g, hd, D] on the cache's layout, contracted with the
    attention output as [B, S, KV, g, hd], so a cache split by head dim is
    never gathered; otherwise ``_out_proj``."""
    if not is_sharded(out) or ways(out, (2, 3)) == 1:
        return _out_proj(out, wo, dtype)
    b, s, h, hd = out.shape
    g = h // num_kv_heads
    # wo's rows split by heads move to the cache's layout as [H, hd, D]
    # (an all-to-all to a head-dim split), as XLA reshards the reference's
    wo3 = shard(whole(wo, h, 0).reshape(h, hd, wo.shape[1]), "cache_heads",
                "cache_hd", None)
    wo4 = shard(wo3.reshape(num_kv_heads, g, hd, wo.shape[1]), "cache_heads",
                None, "cache_hd", None)
    out4 = whole(out, num_kv_heads, 2).reshape(b, s, num_kv_heads, g, hd)
    # the contraction over the split (kv, g, hd) on rank 0's blocks: a
    # partial sum over the axes that split them, reduced (DTensor cannot
    # fold a split dim into the einsum's batch on every torch version)
    o_pl = no_partial(out4.placements)
    w_pl = remap(o_pl, {2: 0, 3: 1, 4: 2})
    split = shard_dims(o_pl, 2) | shard_dims(o_pl, 4)
    y = local_call(
        lambda o, w: torch.einsum("bqkgh,kghd->bqd", o.float(), w.float()),
        (out4, wo4), (o_pl, w_pl),
        with_partial(remap(o_pl, {0: 0, 1: 1}), split))
    return settle(y).to(dtype)


def _attend(q, k, v, valid):
    """q [B, Sq, H, hd] against k, v [B, Skv, KV, hd]; valid broadcastable
    to [B, Sq, Skv] (None: every key). Scores and softmax in f32.
    Returns [B, Sq, H, hd]."""
    b, sq, h, hd = q.shape
    kv_h = k.shape[2]
    qg = whole(q, kv_h, 2).reshape(b, sq, kv_h, h // kv_h, hd)
    qg = shard(qg, "batch", None, "cache_heads", None, "cache_hd")
    if is_sharded(k):
        out = _attend_split(qg, k, v, valid)
    else:
        qg = qg.float()
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, k.float()) * (hd ** -0.5)
        s = shard(s, "batch", "cache_heads", None, None, "cache_seq")
        if valid is not None:
            s = torch.where(valid[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqc,bckh->bqkgh", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _attend_split(qg, k, v, valid):
    """``_attend``'s scores, softmax and p.v on rank 0's blocks of a split
    cache (``local_call``), partitioned as XLA partitions the reference's
    (its hints pin the scores to the cache's layout, [B, KV, g, Sq, C] on
    ``("batch", "cache_heads", None, None, "cache_seq")``): split by kv
    heads, nothing crosses; by head dim, the scores are partial sums,
    all-reduced; by sequence, the softmax's max and sum are all-reduced
    and p.v is a partial sum, all-reduced. qg [B, Sq, KV, g, hd] takes the
    cache's layout. Returns [B, Sq, KV, g, hd] f32."""
    mesh = k.device_mesh
    kpl = no_partial(k.placements)                   # [B, C, KV, hd]
    seq, hd_split = shard_dims(kpl, 1), shard_dims(kpl, 3)
    q_pl = remap(kpl, {0: 0, 2: 2, 3: 4})
    scale = qg.shape[-1] ** -0.5
    args, in_pl = [qg, k, v], [q_pl, kpl, kpl]
    if valid is not None:                            # [B | 1, Sq, C]
        args.append(valid)
        in_pl.append(remap(kpl, {0: 0, 1: 2} if valid.shape[0] == k.shape[0]
                           else {1: 2}))

    def local(ql, kl, vl, vd=None):
        s = torch.einsum("bqkgh,bckh->bkgqc", ql.float(), kl.float()) * scale
        s = all_reduce(s, "sum", mesh, hd_split)
        if vd is not None:
            s = torch.where(vd[:, None, None], s, NEG_INF)
        if seq:
            m = all_reduce(s.amax(-1, keepdim=True), "max", mesh, seq)
            e = (s - m).exp()
            p = e / all_reduce(e.sum(-1, keepdim=True), "sum", mesh, seq)
        else:
            p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqc,bckh->bqkgh", p, vl.float())
        return all_reduce(out, "sum", mesh, seq)
    return local_call(local, tuple(args), tuple(in_pl), q_pl)


def _flash_attend(q, k, v, q_offset: int, *, causal: bool, window: int,
                  q_chunk: int = 512, kv_chunk: int = 1024):
    """Online-softmax attention over kv chunks, the reference's
    ``_flash_attend`` (its chunk sizes, padding, masks and -1e30 fill).

    q [B, Sq, H, hd]; k, v [B, Skv, KV, hd]. Returns [B, Sq, H, hd] in
    q's dtype. ``q_offset``: the absolute position of q[0] relative to
    k[0] (prefill: 0 with Sq == Skv); ``window`` 0 = unbounded.

    q is padded to a multiple of ``min(q_chunk, Sq)`` rows and k, v to a
    multiple of ``min(kv_chunk, Skv)``: padded keys are masked by position
    (``kv_pos < Skv``), padded query rows are computed and dropped, so the
    products are the reference's, padding included. The reference maps
    over its q chunks one at a time; each q chunk's recurrence is
    independent of the others', so here all of them run together, one
    batch of every padded query row per kv step, with each row's sums in
    the reference's order: the kv chunks one after another, the running
    max ``m``, denominator ``l`` and accumulator ``acc`` in f32. One kv
    step holds the [B, KV, g, Sq_pad, kv_chunk] f32 scores and their
    exponentials (2 x 2.15 GB at 32,768 queries, 16 heads). A masked
    score is -1e30, not -inf: a row whose first chunks it cannot see
    gets m = -1e30 and p = 1 there, and the first chunk it can see
    erases them through corr = exp(-1e30 - m) = 0 (with -inf: NaN).
    Chunks the mask voids are computed, as the reference computes them.
    Autograd runs through the loop, as jax.grad runs through the
    reference's scan."""
    b, sq, h, hd = q.shape
    skv, kv_h = k.shape[1], k.shape[2]
    g = h // kv_h
    scale = hd ** -0.5
    dev = q.device

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    pad_q = (-sq) % q_chunk
    pad_kv = (-skv) % kv_chunk
    sqp, nkv = sq + pad_q, (skv + pad_kv) // kv_chunk
    # [B, KV, g * Sq_pad, hd] and [B, KV, Skv_pad, hd], f32, made once
    qt = F.pad(q, (0, 0, 0, 0, 0, pad_q)).float().reshape(
        b, sqp, kv_h, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, kv_h, g * sqp, hd)
    kt, vt = (F.pad(t, (0, 0, 0, 0, 0, pad_kv)).float().transpose(1, 2)
              .contiguous() for t in (k, v))
    q_pos = q_offset + torch.arange(sqp, device=dev)[:, None]    # [Sq_pad, 1]

    acc = torch.zeros((b, kv_h, g, sqp, hd), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, kv_h, g, sqp), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kv_h, g, sqp), dtype=torch.float32, device=dev)
    for j in range(nkv):
        blk = slice(j * kv_chunk, (j + 1) * kv_chunk)
        k_pos = torch.arange(blk.start, blk.stop, device=dev)[None, :]
        mask = k_pos < skv                                    # [1, kv_chunk]
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window:
            mask = mask & (k_pos > q_pos - window)
        s = torch.matmul(qt, kt[:, :, blk].transpose(-1, -2)).mul_(scale)
        s = s.view(b, kv_h, g, sqp, kv_chunk).masked_fill_(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = (s - m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.view(b, kv_h, g * sqp, kv_chunk), vt[:, :, blk])
        acc = acc * corr[..., None] + pv.view(b, kv_h, g, sqp, hd)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sqp, h, hd)
    return out[:, :sq].to(q.dtype)


def _by_heads(attend, q, k, v):
    """``attend(q, k, v)`` under a mesh, on rank 0's (batch, head) blocks
    through ``local_map``: attention is local to a head, and DTensor cannot
    view q's heads as (kv head, group) where the model axis does not
    divide the kv heads. q keeps its placements after its hint; k and v
    are split by batch as q and by heads where the kv heads divide as q's
    heads do, else replicated on heads and cut, inside, to the kv heads
    of rank 0's query heads (each device then holds its query heads' kv
    heads, as a tensor-parallel GQA step does)."""
    pl = no_partial(q.placements)
    mesh = q.device_mesh
    kv_h, h = k.shape[2], q.shape[2]
    g = h // kv_h
    pad = padded_split(q, 2, "heads")
    if pad is not None:
        return _by_padded_heads(attend, q, k, v, pad)
    split = kv_h % ways(q, (2,)) == 0
    kv_pl = remap(pl, {0: 0, 1: None, 2: 2 if split else None})
    rank = coordinate(mesh, shard_dims(pl, 2))[1]

    def local(ql, kl, vl):
        if not split:
            hq = ql.shape[2]
            lo, hi = rank * hq // g, ((rank + 1) * hq - 1) // g + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return attend(ql, kl, vl)
    return local_call(local, (q, k, v), (pl, kv_pl, kv_pl), pl)


def _by_padded_heads(attend, q, k, v, pad):
    """``_by_heads`` where the model axis does not divide the heads (q
    whole on heads): rank 0 attends with its share of them as XLA pads the
    split, ceil(H / ways) query heads from ``pad``'s first and their kv
    heads, its output padded to that share; the shares are then gathered
    and cut back to the H heads (``unpad``) for the output projection."""
    from torch.distributed.tensor import Shard
    dims, per, first = pad
    h, g = q.shape[2], q.shape[2] // k.shape[2]
    lo, hi = first, min(h, first + per)
    pl = remap(no_partial(q.placements), {0: 0, 1: 1, 3: 3})
    out_pl = tuple(Shard(2) if m in dims else p for m, p in enumerate(pl))

    def local(ql, kl, vl):
        out = attend(ql[:, :, lo:hi], kl[:, :, lo // g:(hi - 1) // g + 1],
                     vl[:, :, lo // g:(hi - 1) // g + 1])
        return F.pad(out, (0, 0, 0, per - (hi - lo)))
    kv_pl = remap(pl, {0: 0})
    out = local_call(local, (q, k, v), (pl, kv_pl, kv_pl), out_pl)
    return unpad(out, 2, h)


def attn_forward(params, x, positions, *, num_heads, num_kv_heads, head_dim,
                 rope_theta, window: int = 0,
                 cross_embeds: Optional[torch.Tensor] = None):
    """Full-sequence attention (train / prefill / profiling) through
    ``_flash_attend``. positions [B, S]; window 0 = unbounded: causal
    self-attention with RoPE on q and k. cross_embeds [B, Nc, D]: cross
    attention instead, from x to every row of cross_embeds, with no RoPE,
    no mask and no window."""
    cross = cross_embeds is not None
    q, k, v = _project_qkv(params, x, cross_embeds if cross else x,
                           num_heads, num_kv_heads, head_dim)
    if not cross:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    flash = functools.partial(_flash_attend, q_offset=0, causal=not cross,
                              window=0 if cross else window)
    out = _by_heads(flash, q, k, v) if is_sharded(q) else flash(q, k, v)
    return _out_proj(out, params["wo"], x.dtype)


def attn_decode(params, x_tok, cache, pos, *, num_heads, num_kv_heads,
                head_dim, rope_theta, window: int = 0,
                cross_kv: Optional[tuple] = None):
    """One decode step. x_tok [B, 1, D]; cache k/v [B, C, KV, hd] (written
    in place); pos is the absolute position of the new token — an int (the
    whole batch in lockstep) or a [B] tensor (each row at its own position).
    Ring-buffer write at pos % C per row. Returns (y [B, 1, D], cache).
    cross_kv (k, v) [B, Nc, KV, hd]: cross attention instead, the new
    token's query (no RoPE) against every row of k and v; nothing is
    written and ``cache`` is returned as given."""
    b = x_tok.shape[0]
    if cross_kv is not None:
        k, v = cross_kv
        q = torch.matmul(x_tok, params["wq"]).reshape(b, 1, num_heads,
                                                      head_dim)
        return _cache_out_proj(_attend(q, k, v, None), params["wo"],
                               num_kv_heads, x_tok.dtype), cache
    dev = x_tok.device
    cap = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(params, x_tok, x_tok, num_heads,
                                   num_kv_heads, head_dim)
    per_row = torch.is_tensor(pos) and pos.ndim == 1
    if per_row:
        pos_b = pos.to(device=dev, dtype=torch.int64)[:, None]       # [B, 1]
    else:
        pos_b = torch.full((1, 1), int(pos), dtype=torch.int64, device=dev)
    rope_pos = pos_b.expand(b, 1)
    q = apply_rope(q, rope_pos, rope_theta)
    k_new = apply_rope(k_new, rope_pos, rope_theta)
    # the cache's layout, so the write moves nothing between devices
    k_new = shard(k_new, "batch", None, "cache_heads", "cache_hd")
    v_new = shard(v_new, "batch", None, "cache_heads", "cache_hd")
    if per_row:
        rows = torch.arange(b, device=dev)
        slots = pos_b[:, 0] % cap
        cache["k"][rows, slots] = k_new[:, 0]
        cache["v"][rows, slots] = v_new[:, 0]
    else:
        slot = int(pos) % cap
        for name, new in (("k", k_new), ("v", v_new)):
            if is_sharded(cache[name]):
                _write_slot(cache[name], slot, new[:, 0])
            else:
                cache[name][:, slot] = new[:, 0]

    # absolute position of each slot given the ring has wrapped: the latest
    # write <= pos. [B, C] (per-row) or [1, C] (lockstep)
    idx = torch.arange(cap, device=dev)[None, :]
    abs_pos = pos_b - ((pos_b - idx) % cap)
    valid = (abs_pos >= 0) & (abs_pos <= pos_b)
    if window:
        valid = valid & (abs_pos > pos_b - window)
    out = _attend(q, cache["k"], cache["v"], valid[:, None, :])
    return _cache_out_proj(out, params["wo"], num_kv_heads,
                           x_tok.dtype), cache


def _write_slot(cache_t, slot: int, new) -> None:
    """``cache_t[:, slot] = new`` on rank 0's block of a split cache, in
    place: the slot is written where rank 0 holds it (a cache split by
    sequence holds one range of slots), ``new`` at the cache's layout
    after its hint. DTensor would gather a split cache to write into it."""
    lo, n = local_range(cache_t, 1)
    if lo <= slot < lo + n:
        pl = remap(cache_t.placements, {0: 0, 2: 1, 3: 2})
        cache_t.to_local()[:, slot - lo] = \
            new.redistribute(new.device_mesh, pl).to_local()


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
    q, k_new, v_new = _project_qkv(params, x_chunk, x_chunk, num_heads,
                                   num_kv_heads, head_dim)
    q = apply_rope(q, plan.pos, rope_theta)
    k_new = apply_rope(k_new, plan.pos, rope_theta)
    k_new = shard(k_new, "batch", None, "cache_heads", "cache_hd")
    v_new = shard(v_new, "batch", None, "cache_heads", "cache_hd")
    cache["k"][plan.rows, plan.slots] = k_new[plan.rows, plan.cols]
    cache["v"][plan.rows, plan.slots] = v_new[plan.rows, plan.cols]
    out = _attend(q, cache["k"], cache["v"], plan.valid)
    return _cache_out_proj(out, params["wo"], num_kv_heads,
                           x_chunk.dtype), cache


# ---------------------------------------------------------------------------
# Paged KV: block-pool storage + per-row block tables (runtime/paged_kv.py)
# ---------------------------------------------------------------------------
class PagedPlan(NamedTuple):
    """A paged step's device indices, the same for every layer, so built
    once per step from the host's block table with one copy up. The
    reference aims a token that must not write at ``P * bs`` and drops it
    in its scatter; torch's indexing cannot drop, so ``phys``/``rows``/
    ``cols`` list the WRITING tokens only."""
    pos: torch.Tensor          # [B, C] absolute position of each token
    rows: torch.Tensor         # [N] batch row of each writing token
    cols: torch.Tensor         # [N] its index in the step's tokens
    phys: torch.Tensor         # [N] its flat pool slot, blk * bs + pos % bs
    pages: torch.Tensor        # [B, MB] block table, holes (-1) at block 0
    valid: torch.Tensor        # [B, C, MB*bs] query x slot visibility


def paged_plan(block_tables, base_pos, tok_valid, block_size: int,
               device) -> PagedPlan:
    """block_tables [B, MB] (-1 = unmapped), base_pos [B] and tok_valid
    [B, C] (None: one token per row that writes wherever its block is
    mapped, the decode rule) are host data; a device tensor is read back
    once. A token writes iff it is valid and its row maps the block at
    ``pos // bs`` (clamped to the table as the reference's gather is)."""
    bt = _host(block_tables).astype(np.int64)
    b, mb = bt.shape
    base = np.broadcast_to(_host(base_pos).astype(np.int64).reshape(-1),
                           (b,))
    tv = (np.ones((b, 1), bool) if tok_valid is None
          else _host(tok_valid).astype(bool))
    c = tv.shape[1]
    pos = base[:, None] + np.arange(c)[None, :]                     # [B, C]
    blk = np.take_along_axis(bt, np.clip(pos // block_size, 0, mb - 1), 1)
    rows, cols = np.nonzero(tv & (blk >= 0))
    phys = blk[rows, cols] * block_size + pos[rows, cols] % block_size
    n = rows.size
    packed = torch.from_numpy(np.concatenate(
        [pos.reshape(-1), bt.reshape(-1), rows, cols, phys])).to(device)
    pos_d = packed[:b * c].view(b, c)
    bt_d = packed[b * c:b * c + b * mb].view(b, mb)
    rows_d, cols_d, phys_d = packed[b * c + b * mb:].view(3, n)
    # a mapped slot's content position IS its index (blocks never wrap):
    # idx <= query position masks unwritten tail slots and the row's own
    # later chunk tokens
    mapped = (bt_d >= 0).repeat_interleave(block_size, dim=1)  # [B, MB*bs]
    idx = torch.arange(mb * block_size, device=device)
    valid = mapped[:, None, :] & (idx <= pos_d[:, :, None])
    return PagedPlan(pos_d, rows_d, cols_d, phys_d, bt_d.clamp(min=0), valid)


def _gather_pages(arr, pages):
    """arr [P, bs, KV, hd], pages [B, MB] -> per-row views [B, MB*bs, KV,
    hd]. Holes gather block 0; the plan's ``valid`` masks them out."""
    b, mb = pages.shape
    return arr[pages].reshape(b, mb * arr.shape[1], *arr.shape[2:])


def _attend_paged(params, x, cache, plan: PagedPlan, *, num_heads,
                  num_kv_heads, head_dim, rope_theta):
    p_bs = cache["k"].shape[0] * cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(params, x, x, num_heads, num_kv_heads,
                                   head_dim)
    q = apply_rope(q, plan.pos, rope_theta)
    k_new = apply_rope(k_new, plan.pos, rope_theta)
    k_new = shard(k_new, "batch", None, "cache_heads", "cache_hd")
    v_new = shard(v_new, "batch", None, "cache_heads", "cache_hd")
    # the whole step is written before any query attends
    for name, new in (("k", k_new), ("v", v_new)):
        cache[name].view(p_bs, *new.shape[2:])[plan.phys] = \
            new[plan.rows, plan.cols]
    with trace.span("model.paged_gather"):
        k_rows = _gather_pages(cache["k"], plan.pages)
        v_rows = _gather_pages(cache["v"], plan.pages)
    out = _attend(q, k_rows, v_rows, plan.valid)
    return _cache_out_proj(out, params["wo"], num_kv_heads, x.dtype), cache


def attn_decode_paged(params, x_tok, cache, pos, block_tables, *, num_heads,
                      num_kv_heads, head_dim, rope_theta,
                      plan: Optional[PagedPlan] = None):
    """One decode step against paged KV. x_tok [B, 1, D]; cache k/v
    [P, bs, KV, hd] (written in place); pos [B] absolute positions (paged
    decode is always per-row: the engine broadcasts a lockstep scalar);
    block_tables [B, MB], -1 = unmapped. A row writes iff its block at
    ``pos // bs`` is mapped. ``plan`` (paged_plan's, shared by the layers
    of a step) saves rebuilding the indices per layer.
    Returns (y [B, 1, D], cache)."""
    if plan is None:
        plan = paged_plan(block_tables, pos, None, cache["k"].shape[1],
                          x_tok.device)
    return _attend_paged(params, x_tok, cache, plan, num_heads=num_heads,
                         num_kv_heads=num_kv_heads, head_dim=head_dim,
                         rope_theta=rope_theta)


def attn_prefill_chunk_paged(params, x_chunk, cache, base_pos, tok_valid,
                             block_tables, *, num_heads, num_kv_heads,
                             head_dim, rope_theta,
                             plan: Optional[PagedPlan] = None):
    """Chunked prefill into paged KV, the paged twin of attn_prefill_chunk:
    a token writes iff it is ``tok_valid`` and its block is mapped. No ring
    can wrap (a slot's index is its content position), so a chunk of any
    length works while the pool has blocks.
    Returns (y [B, C, D], cache)."""
    if plan is None:
        plan = paged_plan(block_tables, base_pos, tok_valid,
                          cache["k"].shape[1], x_chunk.device)
    return _attend_paged(params, x_chunk, cache, plan, num_heads=num_heads,
                         num_kv_heads=num_kv_heads, head_dim=head_dim,
                         rope_theta=rope_theta)
