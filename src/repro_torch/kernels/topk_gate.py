"""Fused MoE router gate: top-k, renormalized top-k softmax, TAE and the TAE
gate (``csrc/topk_gate.cu``), plus its plain PyTorch version.

Replaces the TPU kernel ``topk_gate_pallas`` (repro/kernels/topk_gate.py).
Top-k is by iterative max with ties going to the smallest expert index,
on a total order of the floats that puts -0.0 below +0.0 as ``lax.top_k``
(the reference's serving path, ``models/moe.py router_topk``) does;
``torch.topk`` promises neither, so the plain version takes a stable
descending sort of ``order_key``. Bound on the H100: launch latency (a
few KB per call); see the source note in the .cu file for the design.

The JAX package has no backward kernel (it trains on ``lax.top_k`` and a
softmax), so ``TopkGate``'s gradient is torch ops, the same on both
devices: the incoming gradients of vals and of probs (through the top-k
softmax's Jacobian) scattered into [T, E] at idx.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

MAX_E = 256
MAX_K = 16


def order_key(z: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 keys in the float order with -0.0 below +0.0: the
    magnitude bits of negative floats flipped (route.cuh's order_key).
    Logits are finite on every path; NaN order is not defined here."""
    b = z.detach().view(torch.int32)
    return b ^ ((b >> 31) & 0x7fffffff)


def topk_gate_plain(logits: torch.Tensor, tau: float, *, k: int):
    """logits [T, E]; returns (idx [T,K] int32, vals [T,K] f32, probs [T,K]
    f32, tae [T] f32, allow [T] bool)."""
    z = logits.float()
    idx = torch.sort(order_key(z), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    vals = z.gather(1, idx)
    p = torch.exp(vals - vals[:, :1])
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-20)
    if k > 1:
        ent = -(p * torch.log(p.clamp(min=1e-20))).sum(-1)
        tae = ent / math.log(k)
    else:
        tae = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    return idx.to(torch.int32), vals, p, tae, tae > tau


def topk_gate_cost(logits, tau=None, *, k: int) -> tuple:
    """(flops, bytes) of one call, from shapes only: no products (a
    routing kernel); logits read once, idx / vals / probs [T, K] (4 bytes
    each), tae [T] f32 and allow [T] bool written once."""
    t_n = logits.shape[0]
    return 0, _build.nbytes(logits) + 12 * t_n * k + 5 * t_n


def topk_gate_backward(idx, probs, e_n: int, g_vals, g_probs):
    """d logits [T, E] of (vals, probs) = topk_gate(logits) given their
    incoming gradients (either may be None): the reference's gradient of
    ``softmax(lax.top_k(logits))``, scattered at idx."""
    g = torch.zeros_like(probs) if g_vals is None else g_vals.float()
    if g_probs is not None:
        gp = g_probs.float()
        g = g + probs * (gp - (gp * probs).sum(-1, keepdim=True))
    out = torch.zeros((idx.shape[0], e_n), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_(1, idx.long(), g)


class TopkGate(torch.autograd.Function):
    """topk_gate through ``forward_fn`` (the kernel or the plain version),
    differentiable in logits through vals and probs; idx, tae and allow
    carry no gradient."""

    @staticmethod
    def forward(ctx, forward_fn, logits, tau, k):
        idx, vals, probs, tae, allow = forward_fn(logits, tau, k=k)
        ctx.e_n = logits.shape[-1]
        ctx.save_for_backward(idx, probs)
        ctx.mark_non_differentiable(idx, tae, allow)
        ctx.set_materialize_grads(False)
        return idx, vals, probs, tae, allow

    @staticmethod
    def backward(ctx, _g_idx, g_vals, g_probs, _g_tae, _g_allow):
        idx, probs = ctx.saved_tensors
        if g_vals is None and g_probs is None:
            return None, None, None, None
        return (None, topk_gate_backward(idx, probs, ctx.e_n, g_vals,
                                         g_probs), None, None)


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
