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
from repro_torch.kernels.topk_gate import topk_gate_cuda, topk_gate_plain

_CUDA = {"topk_gate": topk_gate_cuda,
         "buddy_substitute": buddy_substitute_cuda,
         "expert_ffn": expert_ffn_cuda,
         "grouped_ffn": grouped_ffn_cuda}


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


def expert_ffn(x, w1, w3, w2):
    if _on_cuda(x, "expert_ffn"):
        return expert_ffn_cuda(x, w1, w3, w2)
    return expert_ffn_plain(x, w1, w3, w2)


def grouped_ffn(x, w1, w3, w2, quant=None, counts=None):
    if _on_cuda(x, "grouped_ffn"):
        return grouped_ffn_cuda(x, w1, w3, w2, quant, counts)
    return grouped_ffn_plain(x, w1, w3, w2, quant, counts)


def launch_counts() -> dict:
    """{kernel: calls that launched it} since the last reset."""
    return {name: fn.launches for name, fn in _CUDA.items()}


def reset_launch_counts() -> None:
    for fn in _CUDA.values():
        fn.launches = 0
