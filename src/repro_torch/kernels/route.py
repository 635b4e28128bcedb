"""Routing of one MoE layer in one launch (``csrc/route.cu``): the router
gate with the token gate, the batch distribution gate, and Algorithm 1 with
every miss outcome, plus its plain PyTorch version.

Replaces, on the model's path, the TPU kernels ``topk_gate_pallas``
(repro/kernels/topk_gate.py) and ``buddy_substitute_pallas``
(repro/kernels/buddy_substitute.py) with the reference functions between
and after them (``repro.core.gates.token_gate`` and ``distribution_gate``,
``repro.core.substitute.substitute``). Contract: the whole of
``core.substitute``'s, argument for argument: precedence mode with the
degraded and peer splits, cost mode (the per-slot argmin over buddy,
degraded, peer, fetch and drop), Psi with the eta and kappa terms, the TAE
temperature and the margin co-gate.

Bound on the H100: about 2 KB in and out per call at T = 4, so the launch
latency and the host's issue path bound it, not bytes. The kernel is one
block for T <= 256 (two launches above); the wrapper makes two
allocations, one int32 buffer and one bool buffer whose views are the
outputs (``launch_plan``), and one ctypes call whose argument types were
fixed when the library loaded. Its checks read dtype, shape, contiguity and
the device type only.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.policy import BuddyPolicy
from repro_torch.core.substitute import substitute as substitute_plain
from repro_torch.kernels import _build
from repro_torch.kernels.topk_gate import MAX_E, MAX_K, topk_gate_plain

SINGLE_BLOCK_T = 256      # up to this many tokens: one launch of one block
# dynamic shared memory of the staged tables, E*R*8 + 20*E bytes: 48 KB
# less the one-block kernel's static arrays
SMEM_LIMIT = 44 * 1024
# The outputs in the int32 buffer ("words"; f32 outputs are its bits) and
# in the bool buffer ("flags"), in buffer order; every segment starts on 16
# bytes. outputs() in csrc/route.cu computes the same offsets. Above
# SINGLE_BLOCK_T the words end with a scratch segment: the rows' mean and
# std [T, 2] that the gate launch passes to the substitution launch.
WORD_OUTPUTS = ("idx", "new_idx", "topk_logits", "probs", "tae")
FLAG_OUTPUTS = ("substituted", "missed", "degraded", "peered", "dropped",
                "allow", "dist_ok")


class Route(NamedTuple):
    """What ``router_topk`` plus ``core.substitute`` give one layer."""
    idx: torch.Tensor           # [T, K] int32 router's experts, rank order
    topk_logits: torch.Tensor   # [T, K] f32
    probs: torch.Tensor         # [T, K] f32 renormalized top-k softmax
    tae: torch.Tensor           # [T] f32 (temperature 1)
    allow: torch.Tensor         # [T] bool token gate (TAE at temperature,
    #                             margin co-gate)
    dist_ok: torch.Tensor       # [] bool distribution gate
    new_idx: torch.Tensor       # [T, K] int32 after substitution
    substituted: torch.Tensor   # [T, K] bool
    missed: torch.Tensor        # [T, K] bool fetch (or the fallback)
    degraded: torch.Tensor      # [T, K] bool quant tier
    peered: torch.Tensor        # [T, K] bool peer borrow
    dropped: torch.Tensor       # [T, K] bool cost argmin's drop


def route_plain(logits, tau: float, beta: float, resident, table, q, *,
                k: int, h: int = 8, rho: int = 3, substitute: bool = True,
                quant_ok=None, peer_ok=None, cost: bool = False,
                fid_cost=None, fetch_cost=None, peer_cost=None,
                stall_per_quality: float = 0.05, drop_loss: float = 1.0,
                eta: float = 0.0, kappa: float = 0.0, hop=None,
                temperature: float = 1.0,
                margin_gamma: float = 1.0) -> Route:
    """logits [T, E] f32; resident [E] bool; table [E, R] int32 (-1
    padded, rank order); q [E, R] f32; quant_ok / peer_ok [E] bool or None
    (precedence mode); fid_cost / fetch_cost / peer_cost [E] f32 (cost
    mode; fetch_cost required there); hop [E] int32 or None (kappa term).
    ``substitute`` False is policy mode "none"; ``cost`` True is
    miss_policy "cost". The composition of the plain versions: the router
    top-k, then ``core.substitute`` (token gate, distribution gate,
    Algorithm 1 and the miss outcomes) on the router's logits."""
    idx, vals, probs, tae, _ = topk_gate_plain(logits, tau, k=k)
    pol = BuddyPolicy(tau=tau, beta=beta, rho=rho, H=h, eta=eta, kappa=kappa,
                      temperature=temperature, margin_gamma=margin_gamma,
                      mode="buddy" if substitute else "none",
                      miss_policy="cost" if cost else "precedence",
                      stall_per_quality=stall_per_quality,
                      drop_loss=drop_loss)
    res = substitute_plain(idx, vals, resident, table, q, pol,
                           router_logits=logits, hop=hop, quant_ok=quant_ok,
                           fid_cost=fid_cost, fetch_cost=fetch_cost,
                           peer_ok=peer_ok, peer_cost=peer_cost)
    return Route(idx, vals, probs, tae, res.allowed, res.dist_ok, res.indices,
                 res.substituted, res.missed, res.degraded, res.peered,
                 res.dropped)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


class Plan(NamedTuple):
    launches: int        # 1 (one block) or 2 (gate grid, substitute grid)
    words: int           # int32 buffer length
    flags: int           # bool buffer length
    word_offsets: tuple  # element offset of each WORD_OUTPUTS entry
    flag_offsets: tuple  # element offset of each FLAG_OUTPUTS entry
    scratch: Optional[int]  # word offset of the rows' [T, 2] mean and std
    #                         (two launches only), else None


@functools.lru_cache(maxsize=256)
def launch_plan(t_n: int, k_n: int) -> Plan:
    """How route_cuda lays out and launches T tokens of K slots."""
    ws = _pad16(4 * t_n * k_n) // 4      # words of one [T, K] output
    fs = _pad16(t_n * k_n)               # bytes of one [T, K] mask
    tf = _pad16(t_n)
    outs = 4 * ws + _pad16(4 * t_n) // 4
    grid = t_n > SINGLE_BLOCK_T
    return Plan(2 if grid else 1,
                outs + (_pad16(8 * t_n) // 4 if grid else 0), 5 * fs + tf + 16,
                tuple(i * ws for i in range(5)),
                tuple(i * fs for i in range(6)) + (5 * fs + tf,),
                outs if grid else None)


def _lib():
    lib = _build.load("route")
    fn = lib.route_launch
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 10 + [i] * 8 + [f] * 9 + [p] * 3
        fn.restype = ctypes.c_int
    return lib


def _bad(t, dtype, shape) -> bool:
    return (t.dtype != dtype or t.shape != shape or not t.is_cuda
            or not t.is_contiguous())


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def route_cuda(logits, tau: float, beta: float, resident, table, q, *,
               k: int, h: int = 8, rho: int = 3, substitute: bool = True,
               quant_ok=None, peer_ok=None, cost: bool = False,
               fid_cost=None, fetch_cost=None, peer_cost=None,
               stall_per_quality: float = 0.05, drop_loss: float = 1.0,
               eta: float = 0.0, kappa: float = 0.0, hop=None,
               temperature: float = 1.0,
               margin_gamma: float = 1.0) -> Route:
    """The kernel on CUDA tensors (same contract as route_plain)."""
    if not logits.is_cuda:
        raise ValueError(f"route_cuda: logits on {logits.device}")
    t_n, e_n = logits.shape
    r_n = table.shape[-1]
    h_n = min(h, r_n)
    vec = (e_n,)
    if (_bad(logits, torch.float32, (t_n, e_n))
            or _bad(resident, torch.bool, vec)
            or _bad(table, torch.int32, (e_n, r_n))
            or _bad(q, torch.float32, (e_n, r_n))
            or any(m is not None and _bad(m, torch.bool, vec)
                   for m in (quant_ok, peer_ok))
            or (hop is not None and _bad(hop, torch.int32, vec))
            or any(c is not None and _bad(c, torch.float32, vec)
                   for c in (fid_cost, fetch_cost, peer_cost))
            or (cost and fetch_cost is None)):
        raise ValueError("route_cuda: needs contiguous CUDA logits f32 [T, E],"
                         " resident bool [E], table int32 [E, R], q f32 "
                         "[E, R], quant_ok / peer_ok bool [E] or None, hop "
                         "int32 [E] or None, fid_cost / fetch_cost / "
                         "peer_cost f32 [E] or None (fetch_cost in cost "
                         "mode)")
    if (e_n > MAX_E or not 1 <= k <= min(MAX_K, e_n) or h_n < 1
            or 8 * e_n * r_n + 20 * e_n > SMEM_LIMIT):
        raise ValueError(f"route_cuda: E={e_n} K={k} R={r_n} H={h} not "
                         f"supported (E <= {MAX_E}, K <= {MAX_K}, tables "
                         f"<= {SMEM_LIMIT} bytes)")
    plan = launch_plan(t_n, k)
    dev = logits.device
    words = torch.empty(plan.words, dtype=torch.int32, device=dev)
    flags = torch.empty(plan.flags, dtype=torch.bool, device=dev)
    err = _lib().route_launch(
        logits.data_ptr(), resident.data_ptr(), table.data_ptr(),
        q.data_ptr(), _ptr(quant_ok), _ptr(peer_ok), _ptr(hop),
        _ptr(fid_cost), _ptr(fetch_cost), _ptr(peer_cost), t_n, e_n, k, r_n,
        h_n, int(rho), bool(substitute), bool(cost), float(tau),
        float(beta), math.log(k) if k > 1 else 1.0, float(temperature),
        float(margin_gamma), float(eta), float(kappa),
        float(stall_per_quality), stall_per_quality * drop_loss,
        words.data_ptr(), flags.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "route")
    route_cuda.launches += 1
    return outputs(words, flags, t_n, k)


def outputs(words, flags, t_n: int, k_n: int) -> Route:
    """The outputs as views of route_cuda's two buffers (launch_plan's
    offsets): contiguous, each starting on 16 bytes."""
    plan = launch_plan(t_n, k_n)
    wf = words.view(torch.float32)
    tk, st = (t_n, k_n), (k_n, 1)
    o_i, o_n, o_l, o_p, o_t = plan.word_offsets
    fo = plan.flag_offsets
    return Route(words.as_strided(tk, st, o_i), wf.as_strided(tk, st, o_l),
                 wf.as_strided(tk, st, o_p), wf.as_strided((t_n,), (1,), o_t),
                 flags.as_strided((t_n,), (1,), fo[5]),
                 flags.as_strided((), (), fo[6]),
                 words.as_strided(tk, st, o_n),
                 *(flags.as_strided(tk, st, o) for o in fo[:5]))


route_cuda.launches = 0
