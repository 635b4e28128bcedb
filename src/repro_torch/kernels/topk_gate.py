"""Fused MoE router gate: top-k, renormalized top-k softmax, TAE and the TAE
gate (``csrc/topk_gate.cu``), plus its plain PyTorch version.

Replaces the TPU kernel ``topk_gate_pallas`` (repro/kernels/topk_gate.py).
Top-k is by iterative max with ties going to the smallest expert index;
``torch.topk`` does not promise that order, so the plain version takes a
stable descending sort. Bound on the H100: launch latency (a few KB per
call); see the source note in the .cu file for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

MAX_E = 256
MAX_K = 16


def topk_gate_plain(logits: torch.Tensor, tau: float, *, k: int):
    """logits [T, E]; returns (idx [T,K] int32, vals [T,K] f32, probs [T,K]
    f32, tae [T] f32, allow [T] bool)."""
    z = logits.float()
    vals_all, idx_all = torch.sort(z, dim=-1, descending=True, stable=True)
    vals, idx = vals_all[:, :k], idx_all[:, :k]
    p = torch.exp(vals - vals[:, :1])
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-20)
    if k > 1:
        ent = -(p * torch.log(p.clamp(min=1e-20))).sum(-1)
        tae = ent / math.log(k)
    else:
        tae = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    return idx.to(torch.int32), vals, p, tae, tae > tau


def _lib():
    lib = _build.load("topk_gate")
    fn = lib.topk_gate_launch
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, i, f, f, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def topk_gate_cuda(logits: torch.Tensor, tau: float, *, k: int):
    """The kernel on a CUDA tensor (same contract as topk_gate_plain)."""
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gate_cuda: logits on {logits.device}")
    if logits.dtype != torch.float32 or logits.ndim != 2 \
            or not logits.is_contiguous():
        raise ValueError("topk_gate_cuda: logits must be contiguous f32 [T, E],"
                         f" got {logits.dtype} {tuple(logits.shape)}")
    t_n, e_n = logits.shape
    if e_n > MAX_E or not 1 <= k <= min(MAX_K, e_n):
        raise ValueError(f"topk_gate_cuda: needs E <= {MAX_E} and "
                         f"1 <= K <= min({MAX_K}, E), got E={e_n} K={k}")
    dev = logits.device
    idx = torch.empty((t_n, k), dtype=torch.int32, device=dev)
    vals = torch.empty((t_n, k), dtype=torch.float32, device=dev)
    probs = torch.empty((t_n, k), dtype=torch.float32, device=dev)
    tae = torch.empty((t_n,), dtype=torch.float32, device=dev)
    allow = torch.empty((t_n,), dtype=torch.bool, device=dev)
    p = _build.ptr
    err = _lib().topk_gate_launch(
        p(logits), t_n, e_n, k, float(tau), math.log(k) if k > 1 else 1.0,
        p(idx), p(vals), p(probs), p(tae), p(allow), _build.stream_ptr(dev))
    _build.check(err, "topk_gate")
    topk_gate_cuda.launches += 1
    return idx, vals, probs, tae, allow


topk_gate_cuda.launches = 0
