"""One grouped expert launch pair for the miss outcomes
(``csrc/grouped_ffn.cu`` with ``csrc/ffn_gemm.cuh``), plus its plain
PyTorch version.

Replaces the TPU kernel ``grouped_ffn_pallas`` (repro/kernels/grouped_ffn.py).
x [2E, C, D] holds slots binned by (resolved expert, class): groups [0, E)
are full precision with expert_ffn numerics, groups [E, 2E) the degraded
class against the int8 replica (``quant`` = (w1_q, w1_s, w3_q, w3_s, w2_q,
w2_s)) with per-output-channel scales after each matmul. Unfilled rows come
back zero. ``counts`` [2E] int32 (optional) is each group's filled-row count
from the binning step: rows at or past it are treated as unfilled. Without
``quant`` the degraded half must be empty and comes back zero. Bound on the
H100: the live groups' weight bytes; see the source note in the .cu file.
One call is two launches (gate/up, then down); ``launches`` counts calls.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.expert_ffn import (DTYPE_CODES, check_ffn_operands,
                                            expert_ffn_plain)


def dequant_swiglu(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s):
    """The dequant + SwiGLU reference (all f32, scales per output channel
    applied after each matmul). x [..., C, D]; returns [..., C, D] f32."""
    xf = x.float()
    h = F.silu(torch.matmul(xf, w1_q.float()) * w1_s[..., None, :])
    g = torch.matmul(xf, w3_q.float()) * w3_s[..., None, :]
    return torch.matmul(h * g, w2_q.float()) * w2_s[..., None, :]


def grouped_ffn_plain(x, w1, w3, w2, quant=None, counts=None):
    """x [2E, C, D]; fp weights w1/w3 [E, D, F], w2 [E, F, D]; quant the
    int8 replica sextuple or None; counts [2E] or None. Returns [2E, C, D]."""
    e_n = w1.shape[0]
    if x.shape[0] != 2 * e_n:
        raise ValueError(f"grouped_ffn: expected {2 * e_n} groups, got "
                         f"{x.shape[0]}")
    if counts is not None:
        filled = torch.arange(x.shape[1], device=x.device) < counts[:, None]
        x = torch.where(filled[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    full = expert_ffn_plain(x[:e_n], w1, w3, w2).float()
    if quant is None:
        deg = torch.zeros_like(full)
    else:
        deg = dequant_swiglu(x[e_n:], *quant)
    return torch.cat([full, deg], 0).to(x.dtype)


def _lib():
    lib = _build.load("grouped_ffn")
    fn = lib.grouped_ffn_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                       i, p]
        fn.restype = ctypes.c_int
    return lib


def _check_quant(quant, e_n, d_n, f_n, dev):
    shapes = ((torch.int8, (e_n, d_n, f_n)), (torch.float32, (e_n, f_n)),
              (torch.int8, (e_n, d_n, f_n)), (torch.float32, (e_n, f_n)),
              (torch.int8, (e_n, f_n, d_n)), (torch.float32, (e_n, d_n)))
    names = ("w1_q", "w1_s", "w3_q", "w3_s", "w2_q", "w2_s")
    if len(quant) != 6:
        raise ValueError("grouped_ffn_cuda: quant is (w1_q, w1_s, w3_q, "
                         "w3_s, w2_q, w2_s)")
    for nm, t, (dt, shp) in zip(names, quant, shapes):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shp \
                or not t.is_contiguous():
            raise ValueError(f"grouped_ffn_cuda: {nm} must be contiguous {dt}"
                             f" {shp} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def grouped_ffn_cuda(x, w1, w3, w2, quant=None, counts=None):
    """The kernel on CUDA tensors (same contract as grouped_ffn_plain)."""
    e_n = w1.shape[0]
    c_n, d_n, f_n = check_ffn_operands("grouped_ffn_cuda", x, w1, w3, w2,
                                       2 * e_n)
    dev = x.device
    if counts is not None and (counts.device != dev
                               or counts.dtype != torch.int32
                               or tuple(counts.shape) != (2 * e_n,)
                               or not counts.is_contiguous()):
        raise ValueError(f"grouped_ffn_cuda: counts must be contiguous int32 "
                         f"({2 * e_n},) on {dev}")
    if quant is not None:
        _check_quant(quant, e_n, d_n, f_n, dev)
    groups = e_n if quant is None else 2 * e_n
    out = torch.zeros_like(x)                 # unfilled rows stay zero
    if c_n == 0:
        return out
    h = torch.empty((groups, c_n, f_n), dtype=torch.float32, device=dev)
    p = _build.ptr
    null = ctypes.c_void_p(None)
    qp = [null] * 6 if quant is None else [p(t) for t in quant]
    err = _lib().grouped_ffn_launch(
        DTYPE_CODES[x.dtype], p(x), p(w1), p(w3), p(w2), *qp,
        null if counts is None else p(counts), p(h), p(out),
        e_n, groups, c_n, d_n, f_n, _build.stream_ptr(dev))
    _build.check(err, "grouped_ffn")
    grouped_ffn_cuda.launches += 1
    return out


grouped_ffn_cuda.launches = 0
