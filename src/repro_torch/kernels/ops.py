"""Device dispatcher for the kernels: the hand-written CUDA kernel for a
tensor on a CUDA device, the plain PyTorch version for a tensor on the CPU,
and an error for anything else. There is no fallback between the two: a
CUDA tensor launches its kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.buddy_substitute import (buddy_substitute_cuda,
                                                  buddy_substitute_plain)
from repro_torch.kernels.expert_ffn import expert_ffn_cuda, expert_ffn_plain
from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,
                                             grouped_ffn_plain)
from repro_torch.kernels.quant_ffn import quant_ffn_cuda, quant_ffn_plain
from repro_torch.kernels.route import route_cuda, route_plain
from repro_torch.kernels.topk_gate import topk_gate_cuda, topk_gate_plain
from repro_torch.kernels.wkv_chunk import (WKVChunk, wkv_chunk_cuda,
                                           wkv_chunk_plain)

_CUDA = {"topk_gate": topk_gate_cuda,
         "buddy_substitute": buddy_substitute_cuda,
         "expert_ffn": expert_ffn_cuda,
         "grouped_ffn": grouped_ffn_cuda,
         "quant_ffn": quant_ffn_cuda,
         "wkv_chunk": wkv_chunk_cuda,
         "route": route_cuda}


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


def topk_gate(logits, tau, *, k: int):
    if _on_cuda(logits, "topk_gate"):
        return topk_gate_cuda(logits, tau, k=k)
    return topk_gate_plain(logits, tau, k=k)


def buddy_substitute(s, gate, resident, table, q, *, h: int = 8,
                     rho: int = 3):
    if _on_cuda(s, "buddy_substitute"):
        return buddy_substitute_cuda(s, gate, resident, table, q, h=h,
                                     rho=rho)
    return buddy_substitute_plain(s, gate, resident, table, q, h=h, rho=rho)


def route(logits, tau, beta, resident, table, q, *, k: int, **policy):
    """One MoE layer's routing (``kernels.route.Route``); ``policy`` takes
    route_plain's keyword arguments (substitution mode, miss policy, miss
    masks and costs, Psi's terms, the token gate's temperature and
    margin)."""
    fn = route_cuda if _on_cuda(logits, "route") else route_plain
    return fn(logits, tau, beta, resident, table, q, k=k, **policy)


def expert_ffn(x, w1, w3, w2):
    if _on_cuda(x, "expert_ffn"):
        return expert_ffn_cuda(x, w1, w3, w2)
    return expert_ffn_plain(x, w1, w3, w2)


def grouped_ffn(x, w1, w3, w2, quant=None, counts=None):
    if _on_cuda(x, "grouped_ffn"):
        return grouped_ffn_cuda(x, w1, w3, w2, quant, counts)
    return grouped_ffn_plain(x, w1, w3, w2, quant, counts)


def quant_ffn(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts=None):
    if _on_cuda(x, "quant_ffn"):
        return quant_ffn_cuda(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts)
    return quant_ffn_plain(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts)


def wkv_chunk(rt, kt, v, ke, lae, dg, s0):
    """Differentiable: the forward is the kernel or the plain version, the
    backward the chunked gradient in torch ops on either device."""
    fwd = wkv_chunk_cuda if _on_cuda(rt, "wkv_chunk") else wkv_chunk_plain
    return WKVChunk.apply(fwd, rt, kt, v, ke, lae, dg, s0)


def launch_counts() -> dict:
    """{kernel: calls that launched it} since the last reset."""
    return {name: fn.launches for name, fn in _CUDA.items()}


def reset_launch_counts() -> None:
    for fn in _CUDA.values():
        fn.launches = 0
