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

Under a mesh (the dry run's sharded trace: the arguments are DTensors),
a call runs on rank 0's blocks through ``local_map`` (``_local_rows``,
``_local_ffn``), its autograd Function included, at the placements the
reference's hints give there: the router kernels by rows of tokens (the
batch axes), the FFN kernels with the expert buffer as it comes
(``("batch", "expert")``), d_model replicated and d_ff split as the
weights split it, so the output is a partial sum over the d_ff axes (the
reference's ``hg`` on ``dff``), and ``wkv_chunk`` by lanes. The charge is
the cost of the local shapes, and no kernel, plain version or backward
sees a DTensor.

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
                                            expert_ffn_plain, reset_rows,
                                            rows_computed)
from repro_torch.kernels.grouped_ffn import (grouped_ffn_cost,
                                             grouped_ffn_cuda,
                                             grouped_ffn_plain)
from repro_torch.kernels.quant_ffn import (quant_ffn_cost, quant_ffn_cuda,
                                           quant_ffn_plain)
from repro_torch.kernels.route import (Route, route_cost, route_cuda,
                                       route_plain)
from repro_torch.kernels.topk_gate import (TopkGate, topk_gate_cost,
                                           topk_gate_cuda, topk_gate_plain)
from repro_torch.kernels.wkv_chunk import (WKVChunk, wkv_chunk_cost,
                                           wkv_chunk_cuda, wkv_chunk_plain)
from repro_torch.models.common import (is_sharded, local_call, no_partial,
                                       remap, shard_dims, with_partial)

_CUDA = {"topk_gate": topk_gate_cuda,
         "buddy_substitute": buddy_substitute_cuda,
         "expert_ffn": expert_ffn_cuda,
         "grouped_ffn": grouped_ffn_cuda,
         "quant_ffn": quant_ffn_cuda,
         "wkv_chunk": wkv_chunk_cuda,
         "route": route_cuda}


_METER = None          # the active op counter (launch.roofline.OpCounter)


def _ffn_scratch(x, w1, *_, **__) -> int:
    """Bytes of the f32 hidden buffer [G, C, F] an FFN kernel holds while
    it runs (``expert_ffn_cuda`` and its two siblings' ``h``)."""
    return x.shape[0] * x.shape[1] * w1.shape[2] * 4


_SCRATCH = {"expert_ffn": _ffn_scratch, "grouped_ffn": _ffn_scratch,
            "quant_ffn": _ffn_scratch}


def _metered(name: str, cost, fn):
    """``fn``, or while a meter is active, ``fn`` charged to it as one unit
    of ``cost(*args)``: ``_METER.kernel(name, flops, bytes)`` is a context
    manager around the call, and the call's outputs (and the FFN kernels'
    scratch) are handed to ``_METER.outputs``, as the kernel allocates
    them."""
    meter = _METER
    if meter is None:
        return fn
    scratch = _SCRATCH.get(name)

    def call(*args, **kw):
        with meter.kernel(name, *cost(*args, **kw)):
            out = fn(*args, **kw)
        meter.outputs(out, scratch(*args, **kw) if scratch else 0)
        return out
    return call


def _rows(x) -> tuple:
    """x's placements with only its rows (dim 0) split, and no partial
    sum left pending."""
    return no_partial(remap(x.placements, {0: 0}))


def _local_rows(fn, args, n_out: int, whole=()):
    """fn(*args) by rows of tokens: args[0] [T, ...] split by rows, every
    other DTensor as it is; ``n_out`` outputs [T, ...] split by rows, but
    the outputs at the indices in ``whole``, a statistic of the whole
    batch, replicated: rank 0 decides them from its own rows."""
    from torch.distributed.tensor import Replicate
    rows = _rows(args[0])
    in_pl = (rows,) + tuple(a.placements if is_sharded(a) else None
                            for a in args[1:])
    rep = (Replicate(),) * len(rows)
    return local_call(fn, args, in_pl, tuple(rep if i in whole else rows
                                             for i in range(n_out)))


def _local_ffn(fn, x, weights, d_dims, rest=()):
    """An FFN kernel by rows of its expert buffer x [G, C, D]: x with D
    replicated, each weight with its d_model dim (``d_dims``) replicated
    (the FSDP gather), the output x's placements plus a partial sum on
    every mesh dim that splits d_ff; the gradients of the weights are
    partial over the mesh dims that split x's rows."""
    x_pl = no_partial(remap(x.placements, {0: 0, 1: 1}))
    w_pl = [remap(w.placements, {d: d for d in range(w.ndim) if d != dd})
            for w, dd in zip(weights, d_dims)]
    f_dims = set().union(*(shard_dims(p, d) for p, w, dd in
                           zip(w_pl, weights, d_dims)
                           for d in range(w.ndim) if d not in (0, dd)))
    rows = shard_dims(x_pl, 0) | shard_dims(x_pl, 1)
    out_pl = with_partial(x_pl, f_dims)
    rest_pl = tuple(a.placements if is_sharded(a) else None for a in rest)
    in_pl = (x_pl, *w_pl) + rest_pl
    grad_pl = (with_partial(x_pl, f_dims),
               *(with_partial(p, rows) for p in w_pl)) + rest_pl
    return local_call(fn, (x, *weights, *rest), in_pl, out_pl, grad_pl)


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
    if is_sharded(logits):
        return _local_rows(lambda lg: topk_gate(lg, tau, k=k), (logits,), 5)
    fwd = topk_gate_cuda if _on_cuda(logits, "topk_gate") \
        else topk_gate_plain
    return TopkGate.apply(_metered("topk_gate", topk_gate_cost, fwd),
                          logits, tau, k)


def buddy_substitute(s, gate, resident, table, q, *, h: int = 8,
                     rho: int = 3):
    if is_sharded(s):
        return _local_rows(lambda *a: buddy_substitute(*a, h=h, rho=rho),
                           (s, gate, resident, table, q), 3)
    fn = buddy_substitute_cuda if _on_cuda(s, "buddy_substitute") \
        else buddy_substitute_plain
    return _metered("buddy_substitute", buddy_substitute_cost, fn)(
        s, gate, resident, table, q, h=h, rho=rho)


def route(logits, tau, beta, resident, table, q, *, k: int, **policy):
    """One MoE layer's routing (``kernels.route.Route``); ``policy`` takes
    route_plain's keyword arguments (substitution mode, miss policy, miss
    masks and costs, Psi's terms, the token gate's temperature and
    margin)."""
    if is_sharded(logits):
        keys = [n for n, v in policy.items() if isinstance(v, torch.Tensor)]

        def local(lg, *ts):
            kw = dict(policy, **dict(zip(keys, ts[3:])))
            return tuple(route(lg, tau, beta, *ts[:3], k=k, **kw))
        # the distribution gate dist_ok [] is a statistic of the batch
        return Route(*_local_rows(
            local, (logits, resident, table, q, *(policy[n] for n in keys)),
            len(Route._fields), whole={Route._fields.index("dist_ok")}))
    fn = route_plain
    if _on_cuda(logits, "route"):
        _no_grad_needed("route", logits, q, *policy.values())
        fn = route_cuda
    return _metered("route", route_cost, fn)(logits, tau, beta, resident,
                                             table, q, k=k, **policy)


def expert_ffn(x, w1, w3, w2):
    """Differentiable in x and the three weights."""
    if is_sharded(x):
        return _local_ffn(expert_ffn, x, (w1, w3, w2), (1, 1, 2))
    fwd = expert_ffn_cuda if _on_cuda(x, "expert_ffn") else expert_ffn_plain
    return ExpertFFN.apply(_metered("expert_ffn", expert_ffn_cost, fwd), x,
                           w1, w3, w2)


def grouped_ffn(x, w1, w3, w2, quant=None, counts=None):
    if is_sharded(x):
        if quant is not None:
            raise NotImplementedError("grouped_ffn: the int8 half under a "
                                      "mesh (no dry-run step runs it)")
        return _local_ffn(lambda *a: grouped_ffn(*a[:4], None, *a[4:]), x,
                          (w1, w3, w2), (1, 1, 2), (counts,))
    fn = grouped_ffn_plain
    if _on_cuda(x, "grouped_ffn"):
        _no_grad_needed("grouped_ffn", x, w1, w3, w2, *(quant or ()))
        fn = grouped_ffn_cuda
    return _metered("grouped_ffn", grouped_ffn_cost, fn)(x, w1, w3, w2,
                                                         quant, counts)


def quant_ffn(x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts=None):
    if is_sharded(x):
        # w1/w3 [E, D, F] with scales [E, F]; w2 [E, F, D] with scales
        # [E, D]: d_model is dim 1, 1, 2 and the w2 scale's dim 1
        return _local_ffn(quant_ffn, x, (w1_q, w1_s, w3_q, w3_s, w2_q,
                                          w2_s), (1, -1, 1, -1, 2, 1),
                          (counts,))
    fn = quant_ffn_plain
    if _on_cuda(x, "quant_ffn"):
        _no_grad_needed("quant_ffn", x, w1_s, w3_s, w2_s)
        fn = quant_ffn_cuda
    return _metered("quant_ffn", quant_ffn_cost, fn)(
        x, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s, counts)


def wkv_chunk(rt, kt, v, ke, lae, dg, s0):
    """Differentiable: the forward is the kernel or the plain version, the
    backward the chunked gradient in torch ops on either device."""
    if is_sharded(rt):
        lanes = _rows(rt)
        args = (rt, kt, v, ke, lae, dg, s0)
        return local_call(wkv_chunk, args, (lanes,) * 7, (lanes, lanes))
    fwd = wkv_chunk_cuda if _on_cuda(rt, "wkv_chunk") else wkv_chunk_plain
    return WKVChunk.apply(_metered("wkv_chunk", wkv_chunk_cost, fwd), rt, kt,
                          v, ke, lae, dg, s0)


def launch_counts() -> dict:
    """{kernel: calls that launched it} since the last reset."""
    return {name: fn.launches for name, fn in _CUDA.items()}


def reset_launch_counts() -> None:
    """Also resets ``expert_ffn_rows``."""
    for fn in _CUDA.values():
        fn.launches = 0
    reset_rows()


def expert_ffn_rows() -> dict:
    """{"given": rows the expert_ffn kernel was handed (E x C a call),
    "computed": the live rows it computed} since the last reset. "given"
    is counted on the host; "computed" is a running total on the device,
    added by the kernel itself, and reading it copies it from the device
    once (a wait for the queued work): read it after a run, never inside
    a step."""
    return {"given": expert_ffn_cuda.rows_given,
            "computed": rows_computed()}
