"""Device dispatcher for the kernels: the hand-written CUDA kernel for a
tensor on a CUDA device, the plain PyTorch version for a tensor on the CPU
or the meta device, and an error for anything else. There is no fallback
between the two: a CUDA tensor launches its kernel or raises. A meta
tensor holds no values, so there the plain version runs for its output
shapes only (the launch tooling's dry run traces steps on meta).

While an op counter is active (``launch.roofline.OpCounter``, held in
``_METER``), every call here is charged to it as one unit by the
kernel's cost function (``<kernel>_cost`` beside each kernel: flops and
bytes from the call's shapes and dtypes), and the ops inside the call, the
plain version's or the launch's, are not counted. The same call is charged
the same on every device.

``topk_gate``, ``expert_ffn`` and ``wkv_chunk`` are differentiable: the
forward is the kernel or the plain version, the backward torch ops on
either device. ``route``, ``grouped_ffn`` and ``quant_ffn`` serve only: on
CUDA they raise when autograd would need their gradient, since a kernel's
output has none and the inputs would silently get zero.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.buddy_substitute import (buddy_substitute_cost,
                                                  buddy_substitute_cuda,
                                                  buddy_substitute_plain)
from repro_torch.kernels.expert_ffn import (ExpertFFN, expert_ffn_cost,
                                            expert_ffn_cuda,
                                            expert_ffn_plain)
from repro_torch.kernels.grouped_ffn import (grouped_ffn_cost,
                                             grouped_ffn_cuda,
                                             grouped_ffn_plain)
from repro_torch.kernels.quant_ffn import (quant_ffn_cost, quant_ffn_cuda,
                                           quant_ffn_plain)
from repro_torch.kernels.route import route_cost, route_cuda, route_plain
from repro_torch.kernels.topk_gate import (TopkGate, topk_gate_cost,
                                           topk_gate_cuda, topk_gate_plain)
from repro_torch.kernels.wkv_chunk import (WKVChunk, wkv_chunk_cost,
                                           wkv_chunk_cuda, wkv_chunk_plain)

_CUDA = {"topk_gate": topk_gate_cuda,
         "buddy_substitute": buddy_substitute_cuda,
         "expert_ffn": expert_ffn_cuda,
         "grouped_ffn": grouped_ffn_cuda,
         "quant_ffn": quant_ffn_cuda,
         "wkv_chunk": wkv_chunk_cuda,
         "route": route_cuda}


_METER = None          # the active op counter (launch.roofline.OpCounter)


def _metered(name: str, cost, fn):
    """``fn``, or while a meter is active, ``fn`` charged to it as one unit
    of ``cost(*args)``: ``_METER.kernel(name, flops, bytes)`` is a context
    manager around the call."""
    meter = _METER
    if meter is None:
        return fn

    def call(*args, **kw):
        with meter.kernel(name, *cost(*args, **kw)):
            return fn(*args, **kw)
    return call


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


def _no_grad_needed(name: str, *tensors) -> None:
    """A serve-only kernel on CUDA: raise if autograd would need its
    gradient with respect to any floating input."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no gradient; call "
                           "it under torch.no_grad() or on detached inputs")


def topk_gate(logits, tau, *, k: int):
    """Differentiable in logits through vals and probs."""
    fwd = topk_gate_cuda if _on_cuda(logits, "topk_gate") \
        else topk_gate_plain
    return TopkGate.apply(_metered("topk_gate", topk_gate_cost, fwd),
                          logits, tau, k)


def buddy_substitute(s, gate, resident, table, q, *, h: int = 8,
                     rho: int = 3):
    fn = buddy_substitute_cuda if _on_cuda(s, "buddy_substitute") \
        else buddy_substitute_plain
    return _metered("buddy_substitute", buddy_substitute_cost, fn)(
        s, gate, resident, table, q, h=h, rho=rho)


def route(logits, tau, beta, resident, table, q, *, k: int, **policy):
    """One MoE layer's routing (``kernels.route.Route``); ``policy`` takes
    route_plain's keyword arguments (substitution mode, miss policy, miss
    masks and costs, Psi's terms, the token gate's temperature and
    margin)."""
    fn = route_plain
    if _on_cuda(logits, "route"):
        _no_grad_needed("route", logits, q, *policy.values())
        fn = route_cuda
    return _metered("route", route_cost, fn)(logits, tau, beta, resident,
                                             table, q, k=k, **policy)


def expert_ffn(x, w1, w3, w2):
    """Differentiable in x and the three weights."""
    fwd = expert_ffn_cuda if _on_cuda(x, "expert_ffn") else expert_ffn_plain
    return ExpertFFN.apply(_metered("expert_ffn", expert_ffn_cost, fwd), x,
                           w1, w3, w2)


def grouped_ffn(x, w1, w3, w2, quant=None, counts=None):
    fn = grouped_ffn_plain
    if _on_cuda(x, "grouped_ffn"):
        _no_grad_needed("grouped_ffn", x, w1, w3, w2, *(quant or ()))
        fn = grouped_ffn_cuda
    return _metered("grouped_ffn", grouped_ffn_cost, fn)(x, w1, w3, w2,
                                                         quant, counts)


def quant_ffn(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts=None):
    fn = quant_ffn_plain
    if _on_cuda(x, "quant_ffn"):
        _no_grad_needed("quant_ffn", x, w1_s, w3_s, w2_s)
        fn = quant_ffn_cuda
    return _metered("quant_ffn", quant_ffn_cost, fn)(
        x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts)


def wkv_chunk(rt, kt, v, ke, lae, dg, s0):
    """Differentiable: the forward is the kernel or the plain version, the
    backward the chunked gradient in torch ops on either device."""
    fwd = wkv_chunk_cuda if _on_cuda(rt, "wkv_chunk") else wkv_chunk_plain
    return WKVChunk.apply(_metered("wkv_chunk", wkv_chunk_cost, fwd), rt, kt,
                          v, ke, lae, dg, s0)


def launch_counts() -> dict:
    """{kernel: calls that launched it} since the last reset."""
    return {name: fn.launches for name, fn in _CUDA.items()}


def reset_launch_counts() -> None:
    for fn in _CUDA.values():
        fn.launches = 0
