"""Dequant + grouped SwiGLU against the resident replica tier
(``csrc/quant_ffn.cu`` with ``csrc/ffn_gemm.cuh``), plus its plain PyTorch
version and the dequant + SwiGLU reference both FFN wrappers share.

Replaces the TPU kernel ``quant_ffn_pallas`` (repro/kernels/quant_ffn.py):
x [E, C, D] f32 or bf16; w1_q/w3_q [E, D, F] int8 with scales [E, F] f32;
w2_q [E, F, D] int8 with scales [E, D] f32; per-output-channel scales after
each matmul, all in f32; returns [E, C, D] in x.dtype. ``counts`` [E] int32
(optional) is each expert's filled-row count from the binning step: rows at
or past it are unfilled and come back zero, and an expert with none reads no
weight bytes. Bound on the H100: the live experts' int8 weight bytes. The
launch is the shared FFN tile's int8-only instance, whose cp.async stages
are 64 deep (``launch_plan``'s ``bk``), so each stage carries the weight
bytes of a 16-deep f32 stage; with 3-4 live experts most SMs still have no
block, and that, not the depth, holds it back (see the source note in the
.cu file). One call is two launches (gate/up, then down); ``launches``
counts calls.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.expert_ffn import (DTYPE_CODES, check_counts,
                                            ffn_flops, launch_plan,
                                            plan_args)

QUANT_NAMES = ("w1_q", "w1_s", "w3_q", "w3_s", "w2_q", "w2_s")


def quant_operands(quant: dict) -> tuple:
    """The replica sextuple, in the kernels' order, from a ``quant`` dict
    (core.quantize.quantize_expert_ffn's, or params["quant"])."""
    return tuple(quant[k] for k in QUANT_NAMES)


def dequant_swiglu(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s):
    """The dequant + SwiGLU reference (all f32, scales per output channel
    applied after each matmul). x [..., C, D]; returns [..., C, D] f32."""
    xf = x.float()
    h = F.silu(torch.matmul(xf, w1_q.float()) * w1_s[..., None, :])
    g = torch.matmul(xf, w3_q.float()) * w3_s[..., None, :]
    return torch.matmul(h * g, w2_q.float()) * w2_s[..., None, :]


def mask_unfilled(x, counts):
    """Zero the rows of x [G, C, D] at or past counts [G] (None: all
    filled)."""
    if counts is None:
        return x
    filled = torch.arange(x.shape[1], device=x.device) < counts[:, None]
    return torch.where(filled[..., None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def quant_ffn_plain(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts=None):
    """x [E, C, D]; the replica sextuple; counts [E] or None. Returns
    [E, C, D] in x.dtype."""
    return dequant_swiglu(mask_unfilled(x, counts), w1_q, w1_s, w3_q, w3_s,
                          w2_q, w2_s).to(x.dtype)


def quant_ffn_cost(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s,
                   counts=None) -> tuple:
    """(flops, bytes) of one call, from shapes only (``counts`` never
    read): every row of the [E, C, D] buffer through every replica, as the
    reference's dense path computes them; x, the replica sextuple and
    counts read once, out written once. Above the work done on a step
    whose counts leave rows or experts empty."""
    e_n, c_n, d_n = x.shape
    return (ffn_flops(e_n, c_n, d_n, w1_q.shape[-1]),
            _build.nbytes(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts, x))


def _lib():
    lib = _build.load("quant_ffn")
    fn = lib.quant_ffn_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       p]
        fn.restype = ctypes.c_int
    return lib


def check_quant(name, quant, e_n, d_n, f_n, dev):
    """The replica sextuple: contiguous int8 weights and f32 scales of the
    expected shapes on ``dev``."""
    if len(quant) != 6:
        raise ValueError(f"{name}: quant is ({', '.join(QUANT_NAMES)})")
    shapes = ((torch.int8, (e_n, d_n, f_n)), (torch.float32, (e_n, f_n)),
              (torch.int8, (e_n, d_n, f_n)), (torch.float32, (e_n, f_n)),
              (torch.int8, (e_n, f_n, d_n)), (torch.float32, (e_n, d_n)))
    for nm, t, (dt, shp) in zip(QUANT_NAMES, quant, shapes):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shp \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous {dt} {shp} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def quant_ffn_cuda(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts=None):
    """The kernel on CUDA tensors (same contract as quant_ffn_plain)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quant_ffn_cuda: x on {dev}")
    if x.dtype not in DTYPE_CODES or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"quant_ffn_cuda: x must be contiguous [E, C, D] "
                         f"f32 or bf16, got {x.dtype} {tuple(x.shape)}")
    e_n, c_n, d_n = x.shape
    f_n = w1_q.shape[-1]
    quant = (w1_q, w1_s, w3_q, w3_s, w2_q, w2_s)
    check_quant("quant_ffn_cuda", quant, e_n, d_n, f_n, dev)
    check_counts("quant_ffn_cuda", counts, e_n, dev)
    out = torch.zeros_like(x)                 # unfilled rows stay zero
    if c_n == 0 or e_n == 0:
        return out
    h = torch.empty((e_n, c_n, f_n), dtype=torch.float32, device=dev)
    plan = launch_plan(x.element_size(), e_n, c_n, d_n, f_n, fp=False,
                       int8=True, ptrs=[t.data_ptr() for t in
                                        (x, w1_q, w3_q, w2_q, h)])
    p = _build.ptr
    err = _lib().quant_ffn_launch(
        DTYPE_CODES[x.dtype], p(x), *[p(t) for t in quant],
        ctypes.c_void_p(None) if counts is None else p(counts), p(h), p(out),
        e_n, c_n, d_n, f_n, *plan_args(plan), _build.stream_ptr(dev))
    _build.check(err, "quant_ffn")
    quant_ffn_cuda.launches += 1
    return out


quant_ffn_cuda.launches = 0
