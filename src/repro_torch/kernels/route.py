"""Routing of one MoE layer in one launch (``csrc/route.cu``): the router
gate, the batch distribution gate, Algorithm 1 and the degraded / peer
splits of the misses, plus its plain PyTorch version.

Replaces, on the model's path, the TPU kernels ``topk_gate_pallas``
(repro/kernels/topk_gate.py) and ``buddy_substitute_pallas``
(repro/kernels/buddy_substitute.py) with the reference functions between
and after them (``repro.core.gates.distribution_gate``; the precedence
split of a miss in ``repro.core.substitute``). Contract: precedence mode,
Psi = q, temperature 1, no margin co-gate (``models.moe.kernel_policy``).

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
from typing import NamedTuple

import torch

from repro_torch.core.gates import distribution_gate
from repro_torch.core.substitute import split_degraded, split_peer
from repro_torch.kernels import _build
from repro_torch.kernels.buddy_substitute import buddy_substitute_plain
from repro_torch.kernels.topk_gate import MAX_E, MAX_K, topk_gate_plain

SINGLE_BLOCK_T = 256      # up to this many tokens: one launch of one block
SMEM_LIMIT = 48 * 1024    # staged tables: E*R*8 + 4*E bytes
# The outputs in the int32 buffer ("words"; f32 outputs are its bits) and
# in the bool buffer ("flags"), in buffer order; every segment starts on 16
# bytes. outputs() in csrc/route.cu computes the same offsets.
WORD_OUTPUTS = ("idx", "new_idx", "topk_logits", "probs", "tae")
FLAG_OUTPUTS = ("substituted", "missed", "degraded", "peered", "dropped",
                "allow", "dist_ok")


class Route(NamedTuple):
    """What ``router_topk`` plus precedence substitution give one layer."""
    idx: torch.Tensor           # [T, K] int32 router's experts, rank order
    topk_logits: torch.Tensor   # [T, K] f32
    probs: torch.Tensor         # [T, K] f32 renormalized top-k softmax
    tae: torch.Tensor           # [T] f32
    allow: torch.Tensor         # [T] bool TAE gate
    dist_ok: torch.Tensor       # [] bool distribution gate
    new_idx: torch.Tensor       # [T, K] int32 after substitution
    substituted: torch.Tensor   # [T, K] bool
    missed: torch.Tensor        # [T, K] bool fetch / drop fallback
    degraded: torch.Tensor      # [T, K] bool quant tier
    peered: torch.Tensor        # [T, K] bool peer borrow
    dropped: torch.Tensor       # [T, K] bool, all false (no cost argmin)


def route_plain(logits, tau: float, beta: float, resident, table, q, *,
                k: int, h: int = 8, rho: int = 3, substitute: bool = True,
                quant_ok=None, peer_ok=None) -> Route:
    """logits [T, E] f32; resident [E] bool; table [E, R] int32 (-1
    padded, rank order); q [E, R] f32; quant_ok / peer_ok [E] bool or None.
    ``substitute`` False is policy mode "none". The composition of the
    plain versions: top-k gate, distribution gate, Algorithm 1 on
    allow & dist_ok, then the degraded and the peer split."""
    idx, vals, probs, tae, allow = topk_gate_plain(logits, tau, k=k)
    dist_ok = distribution_gate(idx, resident, beta)
    if substitute:
        new_idx, sub, miss = buddy_substitute_plain(
            idx, allow & dist_ok, resident, table, q, h=h, rho=rho)
    else:
        new_idx, sub = idx, torch.zeros(idx.shape, dtype=torch.bool,
                                        device=idx.device)
        miss = ~resident[idx.long()]
    miss, deg = split_degraded(miss, new_idx, quant_ok)
    miss, peer = split_peer(miss, new_idx, peer_ok)
    return Route(idx, vals, probs, tae, allow, dist_ok, new_idx, sub, miss,
                 deg, peer, torch.zeros_like(miss))


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


class Plan(NamedTuple):
    launches: int        # 1 (one block) or 2 (gate grid, substitute grid)
    words: int           # int32 buffer length
    flags: int           # bool buffer length
    word_offsets: tuple  # element offset of each WORD_OUTPUTS entry
    flag_offsets: tuple  # element offset of each FLAG_OUTPUTS entry


@functools.lru_cache(maxsize=256)
def launch_plan(t_n: int, k_n: int) -> Plan:
    """How route_cuda lays out and launches T tokens of K slots."""
    ws = _pad16(4 * t_n * k_n) // 4      # words of one [T, K] output
    fs = _pad16(t_n * k_n)               # bytes of one [T, K] mask
    tf = _pad16(t_n)
    return Plan(1 if t_n <= SINGLE_BLOCK_T else 2,
                4 * ws + _pad16(4 * t_n) // 4, 5 * fs + tf + 16,
                tuple(i * ws for i in range(5)),
                tuple(i * fs for i in range(6)) + (5 * fs + tf,))


def _lib():
    lib = _build.load("route")
    fn = lib.route_launch
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, f, p, p,
                       p]
        fn.restype = ctypes.c_int
    return lib


def _bad(t, dtype, shape) -> bool:
    return (t.dtype != dtype or t.shape != shape or not t.is_cuda
            or not t.is_contiguous())


def route_cuda(logits, tau: float, beta: float, resident, table, q, *,
               k: int, h: int = 8, rho: int = 3, substitute: bool = True,
               quant_ok=None, peer_ok=None) -> Route:
    """The kernel on CUDA tensors (same contract as route_plain)."""
    if not logits.is_cuda:
        raise ValueError(f"route_cuda: logits on {logits.device}")
    t_n, e_n = logits.shape
    r_n = table.shape[-1]
    h_n = min(h, r_n)
    if (_bad(logits, torch.float32, (t_n, e_n))
            or _bad(resident, torch.bool, (e_n,))
            or _bad(table, torch.int32, (e_n, r_n))
            or _bad(q, torch.float32, (e_n, r_n))
            or (quant_ok is not None
                and _bad(quant_ok, torch.bool, (e_n,)))
            or (peer_ok is not None
                and _bad(peer_ok, torch.bool, (e_n,)))):
        raise ValueError("route_cuda: needs contiguous CUDA logits f32 [T, E],"
                         " resident bool [E], table int32 [E, R], q f32 "
                         "[E, R], quant_ok / peer_ok bool [E] or None")
    if (e_n > MAX_E or not 1 <= k <= min(MAX_K, e_n) or h_n < 1
            or 8 * e_n * r_n + 4 * e_n > SMEM_LIMIT):
        raise ValueError(f"route_cuda: E={e_n} K={k} R={r_n} H={h} not "
                         f"supported (E <= {MAX_E}, K <= {MAX_K}, tables "
                         f"<= {SMEM_LIMIT} bytes)")
    plan = launch_plan(t_n, k)
    dev = logits.device
    words = torch.empty(plan.words, dtype=torch.int32, device=dev)
    flags = torch.empty(plan.flags, dtype=torch.bool, device=dev)
    err = _lib().route_launch(
        logits.data_ptr(), resident.data_ptr(), table.data_ptr(),
        q.data_ptr(), None if quant_ok is None else quant_ok.data_ptr(),
        None if peer_ok is None else peer_ok.data_ptr(), t_n, e_n, k, r_n,
        h_n, int(rho), bool(substitute), float(tau), float(beta),
        math.log(k) if k > 1 else 1.0,
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
