"""Grouped expert SwiGLU over capacity-dispatch buffers (``csrc/expert_ffn.cu``
with ``csrc/ffn_gemm.cuh``), plus its plain PyTorch version.

Replaces the TPU kernel ``expert_ffn_pallas`` (repro/kernels/expert_ffn.py):
``out[e] = (silu(x[e] @ w1[e]) * (x[e] @ w3[e])) @ w2[e]`` with matmuls on
x.dtype inputs, f32 accumulation and the hidden product cast back to x.dtype
between the two matmuls. Bound on the H100: the weight bytes at the capacity
path's shapes; see the source note in the .cu file for the design. One call
is two launches (gate/up, then down); ``launches`` counts calls.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def expert_ffn_plain(x, w1, w3, w2):
    """x [E, C, D]; w1/w3 [E, D, F]; w2 [E, F, D]. Returns [E, C, D]."""
    h = F.silu(torch.matmul(x.float(), w1.float()))
    g = torch.matmul(x.float(), w3.float())
    hg = (h * g).to(x.dtype)
    return torch.matmul(hg.float(), w2.float()).to(x.dtype)


def _lib():
    lib = _build.load("expert_ffn")
    fn = lib.expert_ffn_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def check_ffn_operands(name, x, w1, w3, w2, groups):
    """Device, dtype, shape and contiguity checks shared by the FFN
    wrappers. Returns (C, D, F)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: x on {dev}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: x.dtype {x.dtype} not in "
                         f"{sorted(map(str, DTYPE_CODES))}")
    e_n, d_n, f_n = w1.shape
    want = {"x": (groups, x.shape[1], d_n), "w1": (e_n, d_n, f_n),
            "w3": (e_n, d_n, f_n), "w2": (e_n, f_n, d_n)}
    for nm, t in (("x", x), ("w1", w1), ("w3", w3), ("w2", w2)):
        if t.device != dev or t.dtype != x.dtype or not t.is_contiguous() \
                or tuple(t.shape) != want[nm]:
            raise ValueError(f"{name}: {nm} must be contiguous {x.dtype} "
                             f"{want[nm]} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return x.shape[1], d_n, f_n


def check_counts(name, counts, groups, dev):
    """Optional per-group filled-row counts: contiguous int32 [groups]."""
    if counts is not None and (counts.device != dev
                               or counts.dtype != torch.int32
                               or tuple(counts.shape) != (groups,)
                               or not counts.is_contiguous()):
        raise ValueError(f"{name}: counts must be contiguous int32 "
                         f"({groups},) on {dev}")


def expert_ffn_cuda(x, w1, w3, w2):
    """The kernel on CUDA tensors (same contract as expert_ffn_plain)."""
    e_n = w1.shape[0]
    c_n, d_n, f_n = check_ffn_operands("expert_ffn_cuda", x, w1, w3, w2, e_n)
    out = torch.empty_like(x)
    if c_n == 0:
        return out
    h = torch.empty((e_n, c_n, f_n), dtype=torch.float32, device=x.device)
    p = _build.ptr
    err = _lib().expert_ffn_launch(
        DTYPE_CODES[x.dtype], p(x), p(w1), p(w3), p(w2), p(h), p(out),
        e_n, c_n, d_n, f_n, _build.stream_ptr(x.device))
    _build.check(err, "expert_ffn")
    expert_ffn_cuda.launches += 1
    return out


expert_ffn_cuda.launches = 0
