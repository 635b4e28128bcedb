"""Mamba2 (SSD) block for the zamba2 hybrid [arXiv:2411.15242 / Mamba2].

Counterpart of ``repro/models/mamba.py``. Scalar-per-head decay SSD
recurrence with a causal depthwise conv and gating:
    h_t = a_t * h_{t-1} + dt_t * (x_t outer B_t),  a_t = exp(-softplus(A) dt_t)
    y_t = h_t @ C_t + D * x_t ;  y = y * silu(z)
State per layer: conv tail [B, conv_dim-1, inner] + SSM state [B, H, hd, N],
both f32. The reference has no kernel here: the chunked scan and the
per-token recurrence are plain jnp, so they are torch ops here, the
reference's ``lax.scan`` over chunks or tokens a loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.common import (dense_init, is_sharded, local_call,
                                       no_partial, normal, padded_split,
                                       remap, reshape, shard, shard_dims,
                                       unpad, whole, with_partial)

CHUNK = 32


def init_mamba(gen, d_model: int, cfg: SSMConfig, dtype, device) -> dict:
    inner = cfg.expand * d_model
    n_heads = inner // cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d_model,
                              2 * inner + 2 * cfg.state_dim + n_heads, dtype,
                              device),
        "conv_w": (normal(gen, (cfg.conv_dim, inner), device) * 0.1)
        .to(dtype),
        "A_log": torch.zeros(n_heads, **f32),
        "D": torch.ones(n_heads, **f32),
        "dt_bias": torch.zeros(n_heads, **f32),
        "out_proj": dense_init(gen, inner, d_model, dtype, device),
    }


def _split_proj(z, inner: int, state_dim: int):
    xz, b, c, dt = torch.split(z, [2 * inner, state_dim, state_dim,
                                   z.shape[-1] - 2 * inner - 2 * state_dim],
                               dim=-1)
    x, gate = xz.chunk(2, dim=-1)
    return x, gate, b, c, dt


def _causal_conv(x, conv_w, tail):
    """Depthwise causal conv. x [B, S, inner]; conv_w [W, inner];
    tail [B, W-1, inner] (previous inputs). Returns (silu(y), new_tail)."""
    w, s = conv_w.shape[0], x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = 0
    for i in range(w):                  # the reference's sum, in its order
        y = y + xp[:, i:i + s] * conv_w[i]
    return F.silu(y), xp[:, -(w - 1):]


def ssd_chunked(a, xh, bt, ct, dt, h0, chunk: int = CHUNK):
    """Chunkwise-parallel SSD scan (Mamba2).

    a [B,S,H] per-head scalar decay; xh [B,S,H,hd]; bt/ct [B,S,N];
    dt [B,S,H]; h0 [B,H,hd,N]; S a multiple of ``chunk``.
    Returns (y_ssm [B,S,H,hd], hN).

      la_t = cumsum log a;  c~_t = c_t exp(la_t);  b~_s = b_s dt_s exp(-la_s)
      o_t = exp(la_t) (h_0 @ c_t) + [lower_incl(c~ b~^T)] @ x
      h'  = exp(la_C) h_0 + (exp(la_C - la_s) dt_s b_s)^T x_s
    """
    b_sz, s_len, h_n = a.shape
    hd = xh.shape[-1]
    n_dim = bt.shape[-1]
    n = s_len // chunk

    ac = a.reshape(b_sz, n, chunk, h_n).permute(1, 0, 3, 2)         # [N,B,H,C]
    dtc = dt.reshape(b_sz, n, chunk, h_n).permute(1, 0, 3, 2)
    xc = xh.reshape(b_sz, n, chunk, h_n, hd).permute(1, 0, 3, 2, 4)
    bc = bt.reshape(b_sz, n, chunk, n_dim).transpose(0, 1)      # [N,B,C,Nd]
    cc = ct.reshape(b_sz, n, chunk, n_dim).transpose(0, 1)

    la = torch.cumsum(torch.log(torch.clamp(ac, min=1e-12)), dim=3)
    la_end = la[:, :, :, -1:]

    # decay-weighted b/c (b/c are head-shared; decay is per-head -> expand)
    c_dec = cc[:, :, None] * torch.exp(la)[..., None]         # [N,B,H,C,Nd]
    b_dec = bc[:, :, None] * (dtc * torch.exp(-la))[..., None]
    b_end = bc[:, :, None] * (dtc * torch.exp(la_end - la))[..., None]
    decay = torch.exp(la_end[..., 0])[..., None, None]        # [N,B,H,1,1]

    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.float32,
                                 device=a.device))             # incl diag
    h = h0
    outs = []
    for i in range(n):
        o_inter = torch.einsum("bhdn,bhcn->bhcd", h, c_dec[i])
        scores = torch.einsum("bhcn,bhsn->bhcs", c_dec[i], b_dec[i]) * mask
        o_intra = torch.einsum("bhcs,bhsd->bhcd", scores, xc[i])
        h = decay[i] * h + torch.einsum("bhsn,bhsd->bhdn", b_end[i], xc[i])
        outs.append(o_inter + o_intra)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b_sz, s_len, h_n,
                                                           hd)
    return out, h


def ssd_sequential(a, xh, bt, ct, dt, h0):
    """The per-token recurrence (the reference's scan over tokens), for
    any S: what decode runs. Same arguments and returns as ssd_chunked."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        dx = (dt[:, t, :, None] * xh[:, t])[..., None] \
            * bt[:, t, None, None, :]
        h = a[:, t, :, None, None] * h + dx
        hs.append(h)
    y = torch.einsum("sbhdn,bsn->bshd", torch.stack(hs), ct)
    return y, h


def _ssd_by_lanes(scan, a, xh, bt, ct, dt, h0):
    """``scan`` on rank 0's (batch, head) lanes, at xh's placements after
    its hint, through ``local_map``: the scan's chunk loop is local to a
    head. The head-shared b and c are split by batch only, their
    gradients partial sums over the head axes."""
    pl = no_partial(xh.placements)
    per_head = remap(pl, {0: 0, 2: 2})                        # a, dt
    shared = remap(pl, {0: 0})                                # bt, ct
    st = remap(pl, {0: 0, 2: 1})                              # h0
    pad = padded_split(xh, 2, "dff")
    if pad is not None:
        return _ssd_padded(scan, (a, xh, bt, ct, dt, h0), pad,
                           (per_head, pl, shared, shared, per_head, st))
    heads = shard_dims(pl, 2)
    return local_call(
        scan, (a, xh, bt, ct, dt, h0),
        (per_head, pl, shared, shared, per_head, st), (pl, st),
        (per_head, pl, with_partial(shared, heads),
         with_partial(shared, heads), per_head, st))


def _ssd_padded(scan, args, pad, in_pl):
    """``_ssd_by_lanes`` where the model axis does not divide the heads
    (xh whole on heads): rank 0 scans its share of them as XLA pads the
    split, ceil(H / ways) heads from ``pad``'s first, its outputs padded
    to that share, then gathered and cut back to the H heads."""
    from torch.distributed.tensor import Shard
    dims, per, first = pad
    h = args[1].shape[2]
    lo, hi = first, min(h, first + per)

    def split(pl, d):
        return tuple(Shard(d) if m in dims else p for m, p in enumerate(pl))

    def local(a, xh, bt, ct, dt, h0):
        y, hn = scan(a[:, :, lo:hi], xh[:, :, lo:hi], bt, ct, dt[:, :, lo:hi],
                     h0[:, lo:hi])
        n = per - (hi - lo)
        return (F.pad(y, (0, 0, 0, n)), F.pad(hn, (0, 0, 0, 0, 0, n)))
    y, hn = local_call(local, args, in_pl,
                       (split(in_pl[1], 2), split(in_pl[5], 1)))
    return unpad(y, 2, h), unpad(hn, 1, h)


def mamba_forward(params, x, state, cfg: SSMConfig, d_model: int):
    """x: [B, S, D]; state: dict(conv [B,W-1,inner], ssm [B,H,hd,N]).
    The chunked scan when S is a multiple of 32 (and > 1), else the
    per-token recurrence, as the reference. Returns (y [B,S,D], new_state)
    with the new state f32."""
    inner = cfg.expand * d_model
    n_heads = inner // cfg.head_dim
    b_sz, s_len, _ = x.shape

    z = torch.matmul(x, params["in_proj"])
    xi, gate, b, c, dt = _split_proj(z, inner, cfg.state_dim)
    xi, conv_tail = _causal_conv(xi, params["conv_w"], state["conv"])
    xi = shard(xi, "batch", None, "dff")

    dt = F.softplus(dt.float() + params["dt_bias"])                 # [B,S,H]
    a = torch.exp(-F.softplus(params["A_log"]) * dt)                 # [B,S,H]
    xh = whole(xi, n_heads, 2).reshape(b_sz, s_len, n_heads,
                                       cfg.head_dim).float()
    bt, ct = b.float(), c.float()                                    # [B,S,N]

    h0 = state["ssm"].float()
    scan = ssd_chunked if s_len % CHUNK == 0 and s_len > 1 \
        else ssd_sequential
    if is_sharded(xh):
        y_ssm, h_n = _ssd_by_lanes(scan, a, xh, bt, ct, dt, h0)
    else:
        y_ssm, h_n = scan(a, xh, bt, ct, dt, h0)
    # y_t = h_t @ C_t + D * x_t
    y = y_ssm + params["D"][:, None] * xh
    y = reshape(y, b_sz, s_len, inner).to(x.dtype)
    y = y * F.silu(gate).to(x.dtype)
    out = torch.matmul(y, params["out_proj"]).to(x.dtype)
    return out, {"conv": conv_tail.float(), "ssm": h_n}


def init_mamba_state(batch: int, d_model: int, cfg: SSMConfig,
                     device) -> dict:
    inner = cfg.expand * d_model
    n_heads = inner // cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros(batch, cfg.conv_dim - 1, inner, **f32),
        "ssm": torch.zeros(batch, n_heads, cfg.head_dim, cfg.state_dim,
                           **f32),
    }
