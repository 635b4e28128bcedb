"""RWKV6 ("Finch") block: attention-free time mix with data-dependent
decay [arXiv:2404.05892], plus the RWKV channel-mix FFN.

Counterpart of ``repro/models/rwkv.py``. Per head (dk = dv = head_dim),
with data-dependent per-channel decay w_t in (0, 1):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

A full sequence whose length is a multiple of the chunk runs the chunkwise
form through ``kernels.ops.wkv_chunk`` (the CUDA kernel on the card, its
plain version on the CPU, differentiable on both); anything else, decode
included, runs the per-token recurrence. State per layer: [B, H, dk, dv].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (dense_init, is_sharded, local_call,
                                       no_partial, normal, remap, rmsnorm,
                                       shard, shard_dims, with_partial)

CHUNK = 32


def init_rwkv(gen, d_model: int, num_heads: int, head_dim: int, d_ff: int,
              dtype, device) -> dict:
    dh = num_heads * head_dim

    def uniform(*shape):
        return torch.rand(*shape, generator=gen, device=device) * 0.5 + 0.25

    def dense(i, o):
        return dense_init(gen, i, o, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu": uniform(5, d_model),
        "wr": dense(d_model, dh), "wk": dense(d_model, dh),
        "wv": dense(d_model, dh), "wg": dense(d_model, dh),
        "ww": dense(d_model, dh),
        "w_bias": torch.zeros(dh, **f32),
        "u": normal(gen, (num_heads, head_dim), device) * 0.1,
        "wo": dense(dh, d_model),
        # channel mix
        "mu_c": uniform(2, d_model),
        "ck": dense(d_model, d_ff), "cr": dense(d_model, d_model),
        "cv": dense(d_ff, d_model),
        "ln_x": torch.ones(dh, **f32),
    }


def _token_shift(x, x_prev):
    """shift(x)[t] = x[t-1]; x_prev is the last token of the previous chunk
    ([B, 1, D]) or zeros."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _mm(a, w):
    """a @ w in the wider of the two dtypes, as jnp promotes: a bf16
    config's f32 token mixes times its bf16 weights multiply in f32."""
    t = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(t), w.to(t))


def _time_mix_projections(params, x, x_shift, num_heads, head_dim):
    mu = params["mu"]

    def mix(i):
        return x * mu[i] + x_shift * (1.0 - mu[i])

    b, s, _ = x.shape
    r = _mm(mix(0), params["wr"]).reshape(b, s, num_heads, head_dim)
    k = _mm(mix(1), params["wk"]).reshape(b, s, num_heads, head_dim)
    v = _mm(mix(2), params["wv"]).reshape(b, s, num_heads, head_dim)
    g = _mm(mix(3), params["wg"]).reshape(b, s, num_heads, head_dim)
    w_raw = _mm(mix(4), params["ww"]).float() + params["w_bias"]
    # data-dependent decay in (0, 1): exp(-softplus(.)), bounded and stable
    w = torch.exp(-F.softplus(w_raw)).reshape(b, s, num_heads, head_dim)
    return r, k, v, g, w


def chunk_factors(r, k, v, w, u, chunk: int = CHUNK):
    """The decay factorization of the chunkwise form, laid out as the
    kernel takes it. Within a chunk (la_t = cumulative log-decay):

        r~_t = r_t exp(la_{t-1})   k~_s = k_s exp(-la_s)
        k_end_s = k_s exp(la_C - la_s)   dg_t = r_t . (u * k_t)

    r, k, v, w [B, S, H, dk]; u [H, dk]. Returns (rt, kt, v, ke
    [B*H, N, C, dk], lae [B*H, N, dk], dg [B*H, N, C]), f32, contiguous."""
    b, s, h, dk = r.shape
    n = s // chunk

    def resh(x):                                     # -> [B, H, N, C, dk]
        return x.float().reshape(b, n, chunk, h, dk) \
            .permute(0, 3, 1, 2, 4).contiguous()

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    log_w = torch.log(torch.clamp_min(wc, 1e-8))
    la = torch.cumsum(log_w, dim=3)
    la_prev = la - log_w                             # la_{t-1}
    la_end = la[:, :, :, -1:, :]
    r_t = rc * torch.exp(la_prev)
    k_t = kc * torch.exp(-la)
    k_end = kc * torch.exp(la_end - la)              # for the state update
    dg = (rc * (u[None, :, None, None, :] * kc)).sum(-1)

    def lanes(x):
        return x.reshape(b * h, *x.shape[2:]).contiguous()

    return (lanes(r_t), lanes(k_t), lanes(vc), lanes(k_end),
            lanes(la_end[:, :, :, 0]), lanes(dg))


def random_chunk_operands(gen: torch.Generator, b: int, h: int, n: int,
                          c: int, d: int, device) -> list:
    """``wkv_chunk``'s operands as ``wkv_chunked`` makes them, from random
    r, k, v, softplus-bounded decays and u (``gen`` on the CPU): the
    ``chunk_factors`` of B x H lanes of N chunks of C, head dim d, and a
    small entering state s0 [B*H, d, d], moved to ``device``."""
    r, k, v = (torch.randn(b, n * c, h, d, generator=gen) for _ in range(3))
    w = torch.exp(-F.softplus(torch.randn(b, n * c, h, d, generator=gen)))
    u = torch.randn(h, d, generator=gen) * 0.1
    s0 = torch.randn(b * h, d, d, generator=gen) * 0.1
    return [t.to(device) for t in chunk_factors(r, k, v, w, u, c)] \
        + [s0.to(device)]


def wkv_chunked(r, k, v, w, u, state, chunk: int = CHUNK):
    """Chunkwise-parallel WKV. r, k, v, w [B, S, H, dk] with S % chunk ==
    0; u [H, dk]; state [B, H, dk, dv]. Returns (out [B, S, H, dv] f32,
    new_state [B, H, dk, dv] f32)."""
    b, s, h, dk = r.shape
    assert s % chunk == 0, f"seq {s} % chunk {chunk}"
    n = s // chunk
    out, s_fin = ops.wkv_chunk(*chunk_factors(r, k, v, w, u, chunk),
                               state.float().reshape(b * h, dk, dk)
                               .contiguous())
    out = out.reshape(b, h, n, chunk, dk).permute(0, 2, 3, 1, 4) \
        .reshape(b, s, h, dk)
    return out, s_fin.reshape(b, h, dk, dk)


def wkv_scan(r, k, v, w, u, state):
    """Sequential WKV recurrence. r, k, v, w [B, S, H, dk]; u [H, dk];
    state [B, H, dk, dv]. Returns (out [B, S, H, dv], new_state)."""
    r, k, v, w = r.float(), k.float(), v.float(), w.float()
    s = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, dk, dv]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[..., None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, 1), s


def _wkv_by_lanes(wkv, r, k, v, w, u, state):
    """``wkv`` on rank 0's (batch, head) lanes, at r's placements after its
    hint, through ``local_map``: the decay factors, the chunk loop or scan
    and its autograd Function see plain tensors (DTensor has no rule for
    them), u and the state split by heads as r is, u's gradient a partial
    sum over the batch axes."""
    pl = no_partial(r.placements)
    u_pl = remap(pl, {2: 0})
    st_pl = remap(pl, {0: 0, 2: 1})
    in_pl = (pl, pl, pl, pl, u_pl, st_pl)
    grad_pl = (pl, pl, pl, pl, with_partial(u_pl, shard_dims(pl, 0)), st_pl)
    return local_call(wkv, (r, k, v, w, u, state), in_pl, (pl, st_pl),
                      grad_pl)


def rwkv_time_mix(params, x, state, x_prev, *, num_heads, head_dim):
    """x [B, S, D]; state [B, H, dk, dv]; x_prev [B, 1, D].
    Returns (y, new_state, new_x_prev)."""
    b, s, _ = x.shape
    x_shift = _token_shift(x, x_prev)
    r, k, v, g, w = _time_mix_projections(params, x, x_shift, num_heads,
                                          head_dim)
    r = shard(r, "batch", None, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    wkv = wkv_chunked if s % CHUNK == 0 and s > 1 else wkv_scan
    if is_sharded(r):
        out, new_state = _wkv_by_lanes(wkv, r, k, v, w, params["u"], state)
    else:
        out, new_state = wkv(r, k, v, w, params["u"], state)
    out = out.reshape(b, s, num_heads * head_dim)
    out = rmsnorm(out.to(x.dtype), params["ln_x"])
    out = out * F.silu(g.reshape(b, s, -1)).to(x.dtype)
    y = (out @ params["wo"]).to(x.dtype)
    return y, new_state.float(), x[:, -1:]


def rwkv_channel_mix(params, x, x_prev):
    """RWKV channel mix: squared-relu FFN with token shift."""
    mu = params["mu_c"]
    x_shift = _token_shift(x, x_prev)
    xk = x * mu[0] + x_shift * (1.0 - mu[0])
    xr = x * mu[1] + x_shift * (1.0 - mu[1])
    k = torch.square(torch.relu(_mm(xk, params["ck"])))
    k = shard(k, "batch", None, "dff")
    y = torch.sigmoid(_mm(xr, params["cr"])) * _mm(k, params["cv"])
    return y.to(x.dtype), x[:, -1:]


def init_rwkv_state(batch: int, num_heads: int, head_dim: int, d_model: int,
                    device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wkv": torch.zeros(batch, num_heads, head_dim, head_dim, **f32),
        "x_tm": torch.zeros(batch, 1, d_model, **f32),
        "x_cm": torch.zeros(batch, 1, d_model, **f32),
    }
