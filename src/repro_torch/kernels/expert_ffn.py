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

# The shared tile's constants (csrc/ffn_gemm.cuh): rows and columns of a
# block's tile, depth of a stage, stages of the cp.async ring.
BM, BN, BK, STAGES = 32, 128, 16, 4


def launch_plan(t_size: int, groups: int, c: int, d: int, f: int, *,
                fp: bool = True, int8: bool = False, ptrs=()) -> dict:
    """The launch of the shared FFN tile for x of ``t_size``-byte elements
    (4 f32, 2 bf16), ``groups`` groups of [c, d] rows, hidden width ``f``,
    with the full-precision class (weights in x's type) and/or the int8
    class. ``ptrs``: base addresses of every operand the kernels copy into
    shared memory. The vec16 instance (16-byte cp.async) needs every copied
    row to be a multiple of 16 bytes; the elem instance (element copies)
    takes any row length. Both need 16-byte-aligned base pointers: anything
    else raises ValueError. The kernel checks the shared-memory bytes
    against its own layout."""
    bad = [hex(p) for p in ptrs if p % 16]
    if bad:
        raise ValueError(f"FFN kernels need 16-byte-aligned operands, got "
                         f"base addresses {bad}")
    row_bytes = [d * t_size, f * 4]                   # x rows, h rows
    if fp:
        row_bytes += [f * t_size, d * t_size]         # w1/w3, w2
    if int8:
        row_bytes += [f, d]                           # w1_q/w3_q, w2_q
    vec16 = all(r % 16 == 0 for r in row_bytes)
    w_size = t_size if fp else 1                      # stages fit either class
    smem1 = STAGES * (BM * BK * t_size + 2 * BK * BN * w_size)
    smem2 = STAGES * (BM * BK * 4 + BK * BN * w_size)
    m_tiles = -(-c // BM)
    return {"instance": "vec16" if vec16 else "elem", "stages": STAGES,
            "smem_gate_up": smem1, "smem_down": smem2,
            "grid_gate_up": (-(-f // BN), m_tiles, groups),
            "grid_down": (-(-d // BN), m_tiles, groups)}


def plan_args(plan: dict) -> tuple:
    """The plan's arguments to a C launch: (vec16, smem bytes x 2)."""
    return (int(plan["instance"] == "vec16"), plan["smem_gate_up"],
            plan["smem_down"])


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
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
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
    plan = launch_plan(x.element_size(), e_n, c_n, d_n, f_n,
                       ptrs=[t.data_ptr() for t in (x, w1, w3, w2, h)])
    p = _build.ptr
    err = _lib().expert_ffn_launch(
        DTYPE_CODES[x.dtype], p(x), p(w1), p(w3), p(w2), p(h), p(out),
        e_n, c_n, d_n, f_n, *plan_args(plan), _build.stream_ptr(x.device))
    _build.check(err, "expert_ffn")
    expert_ffn_cuda.launches += 1
    return out


expert_ffn_cuda.launches = 0
