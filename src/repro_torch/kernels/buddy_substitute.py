"""Algorithm 1 (Buddy Expert Substitution) with an external gate
(``csrc/buddy_substitute.cu``), plus its plain PyTorch version.

Replaces the TPU kernel ``buddy_substitute_pallas``
(repro/kernels/buddy_substitute.py): precedence mode with Psi = q only (no
eta/kappa terms, no cost argmin, no degraded or peer split — callers apply
those splits to the returned miss mask). Bound on the H100: launch latency
(a few KB per step); see the source note in the .cu file for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_K = 16


def buddy_substitute_plain(s, gate, resident, table, q, *, h: int = 8,
                           rho: int = 3):
    """s [T, K] int32; gate [T] bool; resident [E] bool; table [E, R] int32
    (-1 padded, rank order); q [E, R] f32. Returns (s' [T, K] int32,
    substituted [T, K] bool, missed [T, K] bool)."""
    t_n, k_n = s.shape
    h_n = min(h, table.shape[1])
    new = s.long().clone()
    sub = torch.zeros((t_n, k_n), dtype=torch.bool, device=s.device)
    miss = torch.zeros_like(sub)
    budget = torch.where(gate, rho, 0)
    cand_all = table[:, :h_n].long()
    q_all = q[:, :h_n].float() - torch.arange(
        h_n, dtype=torch.float32, device=s.device) * 1e-7   # rank tie-break
    for k in range(k_n):
        e = new[:, k]
        res_e = resident[e]
        need = ~res_e & gate & (budget > 0)
        cand = cand_all[e]                                           # [T, H]
        cand_safe = cand.clamp(min=0)
        in_row = (cand_safe[:, :, None] == new[:, None, :]).any(-1)
        elig = (cand >= 0) & resident[cand_safe] & ~in_row
        psi = torch.where(elig, q_all[e], float("-inf"))
        best = psi.argmax(-1, keepdim=True)                          # first max
        found = elig.gather(1, best)[:, 0]
        do_sub = need & found
        new[:, k] = torch.where(do_sub, cand_safe.gather(1, best)[:, 0], e)
        sub[:, k] = do_sub
        miss[:, k] = ~res_e & ~do_sub
        budget = budget - do_sub.long()
    return new.to(torch.int32), sub, miss


def _lib():
    lib = _build.load("buddy_substitute")
    fn = lib.buddy_substitute_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.buddy_substitute_smem_bytes.argtypes = [i, i]
        lib.buddy_substitute_smem_bytes.restype = i
    return lib


def _expect(t, name, dtype, ndim, dev):
    if t.device != dev or t.dtype != dtype or t.ndim != ndim \
            or not t.is_contiguous():
        raise ValueError(f"buddy_substitute_cuda: {name} must be contiguous "
                         f"{dtype} with {ndim} dims on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def buddy_substitute_cuda(s, gate, resident, table, q, *, h: int = 8,
                          rho: int = 3):
    """The kernel on CUDA tensors (same contract as buddy_substitute_plain)."""
    dev = s.device
    if dev.type != "cuda":
        raise ValueError(f"buddy_substitute_cuda: s on {dev}")
    _expect(s, "s", torch.int32, 2, dev)
    _expect(gate, "gate", torch.bool, 1, dev)
    _expect(resident, "resident", torch.bool, 1, dev)
    _expect(table, "table", torch.int32, 2, dev)
    _expect(q, "q", torch.float32, 2, dev)
    t_n, k_n = s.shape
    e_n, r_n = table.shape
    h_n = min(h, r_n)
    lib = _lib()
    if gate.shape[0] != t_n or resident.shape[0] != e_n \
            or q.shape != table.shape or k_n > MAX_K or h_n < 1 \
            or lib.buddy_substitute_smem_bytes(e_n, r_n) > 48 * 1024:
        raise ValueError(
            f"buddy_substitute_cuda: shapes s{tuple(s.shape)} gate"
            f"{tuple(gate.shape)} resident{tuple(resident.shape)} table"
            f"{tuple(table.shape)} q{tuple(q.shape)} H={h_n} not supported")
    out = torch.empty_like(s)
    sub = torch.empty((t_n, k_n), dtype=torch.bool, device=dev)
    miss = torch.empty_like(sub)
    p = _build.ptr
    err = lib.buddy_substitute_launch(
        p(s), p(gate), p(resident), p(table), p(q), t_n, k_n, e_n, r_n, h_n,
        int(rho), p(out), p(sub), p(miss), _build.stream_ptr(dev))
    _build.check(err, "buddy_substitute")
    buddy_substitute_cuda.launches += 1
    return out, sub, miss


buddy_substitute_cuda.launches = 0
