"""Chunkwise-parallel RWKV6 WKV (``csrc/wkv_chunk.cu``), its plain PyTorch
version, and the autograd Function around the two.

Replaces the TPU kernel ``wkv_chunk_pallas`` (repro/kernels/wkv_chunk.py),
with its interface. Per (batch x head) lane and chunk n, the state carried
across the chunks:

    o_n = r~_n S + [lower(r~_n k~_n^T) + diag(dg_n)] v_n
    S  <- exp(laE_n) (.)_rows S + k_end_n^T v_n

rt, kt, v, ke [BH, N, C, D]; lae [BH, N, D]; dg [BH, N, C]; s0 [BH, D, D]
-> (o [BH, N, C, D], s_final [BH, D, D]), f32. Bound on the H100: bytes.
The kernel runs the chunk loop inside a block and stages each chunk's tiles
through a ring of cp.async stages: with two (head dim <= 64), chunk n + 1
loads while chunk n computes; ``stages(c, d)`` reads an instance's depth
from the built library. The depth changes no output bit; see the source
note in the .cu file for the design.

The JAX package has no backward kernel (it differentiates its jnp scan), so
the gradient here is the explicit chunked gradient in torch ops, the same
code on both devices: it recomputes the entering states S_n by the
recurrence, runs the reverse recurrence dS_n = r~_n^T do_n + exp(laE_n)
(.)_rows dS_{n+1}, and forms the rest as batched products.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CHUNKS = (16, 32)
HEAD_DIMS = (32, 64, 128)


def wkv_chunk_plain(rt, kt, v, ke, lae, dg, s0):
    """The chunk loop of the reference oracle, in the inputs' dtype."""
    outs = []
    s = s0
    for n in range(rt.shape[1]):
        r_, k_, v_ = rt[:, n], kt[:, n], v[:, n]
        scores = torch.tril(r_ @ k_.transpose(-1, -2), diagonal=-1)
        outs.append(r_ @ s + scores @ v_ + dg[:, n, :, None] * v_)
        s = torch.exp(lae[:, n])[..., None] * s \
            + ke[:, n].transpose(-1, -2) @ v_
    return torch.stack(outs, 1), s


def wkv_chunk_cost(rt, kt, v, ke, lae, dg, s0) -> tuple:
    """(flops, bytes) of one call, from shapes only. Per lane and chunk,
    four products: r~ k~^T and its [C, C] @ v (2 C^2 D each), r~ S and
    k_end^T v (2 C D^2 each); the seven operands read once, o and s_final
    written once."""
    bh, n, c, d = rt.shape
    return (4 * bh * n * c * d * (c + d),
            _build.nbytes(rt, kt, v, ke, lae, dg, s0, rt, s0))


def wkv_chunk_backward(rt, kt, v, ke, lae, dg, s0, do, ds_fin):
    """Gradients of (o, s_final) = wkv_chunk(rt, kt, v, ke, lae, dg, s0)
    with respect to its seven inputs, given do and ds_fin."""
    n = rt.shape[1]
    decay = torch.exp(lae)[..., None]                       # [BH, N, D, 1]
    kv = ke.transpose(-1, -2) @ v                           # [BH, N, D, D]
    states = [s0]                                           # S_n entering n
    for i in range(n - 1):
        states.append(decay[:, i] * states[-1] + kv[:, i])
    s_in = torch.stack(states, 1)
    rdo = rt.transpose(-1, -2) @ do
    g = ds_fin                                              # dS after n
    gs = [None] * n
    for i in reversed(range(n)):
        gs[i] = g
        g = rdo[:, i] + decay[:, i] * g
    g_out = torch.stack(gs, 1)
    p = torch.tril(do @ v.transpose(-1, -2), diagonal=-1)   # d(r~ k~^T)
    a = torch.tril(rt @ kt.transpose(-1, -2), diagonal=-1) \
        + torch.diag_embed(dg)
    drt = do @ s_in.transpose(-1, -2) + p @ kt
    dkt = p.transpose(-1, -2) @ rt
    dv = a.transpose(-1, -2) @ do + ke @ g_out
    dke = v @ g_out.transpose(-1, -2)
    dlae = decay[..., 0] * (s_in * g_out).sum(-1)
    ddg = (do * v).sum(-1)
    return drt, dkt, dv, dke, dlae, ddg, g


class WKVChunk(torch.autograd.Function):
    """(o, s_final) through ``forward_fn`` (the kernel or the plain
    version), with the chunked gradient in torch ops."""

    @staticmethod
    def forward(ctx, forward_fn, rt, kt, v, ke, lae, dg, s0):
        ctx.save_for_backward(rt, kt, v, ke, lae, dg, s0)
        return forward_fn(rt, kt, v, ke, lae, dg, s0)

    @staticmethod
    def backward(ctx, do, ds_fin):
        return (None, *wkv_chunk_backward(*ctx.saved_tensors, do, ds_fin))


def _lib():
    lib = _build.load("wkv_chunk")
    fn = lib.wkv_chunk_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return lib


def stages(c: int, d: int) -> int:
    """The ring depth of the kernel's (C, D) instance (0: not an instance)."""
    return _lib().wkv_chunk_stages(c, d)


def wkv_chunk_cuda(rt, kt, v, ke, lae, dg, s0):
    """The kernel on CUDA tensors (same contract as wkv_chunk_plain, f32)."""
    dev = rt.device
    if dev.type != "cuda":
        raise ValueError(f"wkv_chunk_cuda: rt on {dev}")
    if rt.ndim != 4:
        raise ValueError(f"wkv_chunk_cuda: rt must be [BH, N, C, D], got "
                         f"{tuple(rt.shape)}")
    bh, n, c, d = rt.shape
    if c not in CHUNKS or d not in HEAD_DIMS:
        raise ValueError(f"wkv_chunk_cuda: chunk {c} not in {CHUNKS} or head "
                         f"dim {d} not in {HEAD_DIMS}")
    shapes = {"rt": (rt, (bh, n, c, d)), "kt": (kt, (bh, n, c, d)),
              "v": (v, (bh, n, c, d)), "ke": (ke, (bh, n, c, d)),
              "lae": (lae, (bh, n, d)), "dg": (dg, (bh, n, c)),
              "s0": (s0, (bh, d, d))}
    for nm, (t, shp) in shapes.items():
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shp or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"wkv_chunk_cuda: {nm} must be contiguous, "
                             f"16-byte aligned float32 {shp} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(rt)
    s_fin = torch.empty_like(s0)
    if bh == 0:
        return out, s_fin
    p = _build.ptr
    err = _lib().wkv_chunk_launch(
        p(rt), p(kt), p(v), p(ke), p(lae), p(dg), p(s0), p(out), p(s_fin),
        bh, n, c, d, _build.stream_ptr(dev))
    _build.check(err, "wkv_chunk")
    wkv_chunk_cuda.launches += 1
    return out, s_fin


wkv_chunk_cuda.launches = 0
