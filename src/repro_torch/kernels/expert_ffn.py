"""Grouped expert SwiGLU over capacity-dispatch buffers (``csrc/expert_ffn.cu``
with ``csrc/ffn_gemm.cuh``), plus its plain PyTorch version.

Replaces the TPU kernel ``expert_ffn_pallas`` (repro/kernels/expert_ffn.py):
``out[e] = (silu(x[e] @ w1[e]) * (x[e] @ w3[e])) @ w2[e]`` with matmuls on
x.dtype inputs, f32 accumulation and the hidden product cast back to x.dtype
between the two matmuls. Bound on the H100: the weight bytes at the capacity
path's shapes; see the source note in the .cu file for the design. One call
is three launches: the live-row compaction, gate/up, then down. Only the
live rows of x (any element other than +-0) are computed, and every other
row of the output is zero, as the plain version gives it for finite
weights. ``launches`` counts calls, ``rows_given`` the rows they were
handed (E x C a call, on the host); the rows computed are a running total
on each device, read by ``rows_computed()``.

The JAX package has no backward kernel (it trains on the jnp einsums), so
``ExpertFFN``'s gradient is torch ops, the same on both devices: it
recomputes the two hidden products in f32, then forms six batched
products: dhg, dw2, dw1, dw3 and dx's two.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The shared tile's constants (csrc/ffn_gemm.cuh): rows and columns of a
# block's tile, depth of a stage (BK_Q for the int8-only launch, BK for a
# launch with a full-precision class), stages of the cp.async ring.
BM, BN, BK, BK_Q, STAGES = 32, 128, 16, 64, 4


def launch_plan(t_size: int, groups: int, c: int, d: int, f: int, *,
                fp: bool = True, int8: bool = False, ptrs=()) -> dict:
    """The launch of the shared FFN tile for x of ``t_size``-byte elements
    (4 f32, 2 bf16), ``groups`` groups of [c, d] rows, hidden width ``f``,
    with the full-precision class (weights in x's type) and/or the int8
    class. ``ptrs``: base addresses of every operand the kernels copy into
    shared memory. The vec16 instance (16-byte cp.async) needs every copied
    row to be a multiple of 16 bytes; the elem instance (element copies)
    takes any row length. Both need 16-byte-aligned base pointers: anything
    else raises ValueError. The int8-only launch stages BK_Q deep, any
    launch with the full-precision class BK deep (``bk``). The kernel checks
    the shared-memory bytes against its own layout."""
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
    bk = BK if fp else BK_Q
    smem1 = STAGES * (BM * bk * t_size + 2 * bk * BN * w_size)
    smem2 = STAGES * (BM * bk * 4 + bk * BN * w_size)
    m_tiles = -(-c // BM)
    return {"instance": "vec16" if vec16 else "elem", "stages": STAGES,
            "bk": bk, "smem_gate_up": smem1, "smem_down": smem2,
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


def ffn_flops(groups: int, c_n: int, d_n: int, f_n: int) -> int:
    """Products of a SwiGLU over ``groups`` [C, D] row blocks of hidden
    width F, in the dot convention (2 x result elements x contracted size):
    x @ w1 and x @ w3 ([C, F], over D), then h @ w2 ([C, D], over F)."""
    return 3 * 2 * groups * c_n * d_n * f_n


def expert_ffn_cost(x, w1, w3, w2) -> tuple:
    """(flops, bytes) of one call, from shapes only (which rows are live is
    never read: that would wait for the card): every row of the [E, C, D]
    buffer through every expert's SwiGLU, as the reference's dense path
    computes it; x and the three weights read once, out written once. The
    kernel skips rows that are zero, so on a sparse buffer this is above
    the work done."""
    e_n, c_n, d_n = x.shape
    return (ffn_flops(e_n, c_n, d_n, w1.shape[-1]),
            _build.nbytes(x, w1, w3, w2, x))


def expert_ffn_backward(x, w1, w3, w2, dy, need=(True,) * 4):
    """Gradients (dx, dw1, dw3, dw2) of expert_ffn(x, w1, w3, w2) given dy,
    in the inputs' dtypes; ``need`` flags which to form (None otherwise).
    Rows of x that are zero (empty capacity slots) give zero rows of dx and
    add nothing to the weights' gradients."""
    xf, dyf = x.float(), dy.float()
    w1f, w3f, w2f = w1.float(), w3.float(), w2.float()
    h1, h3 = torch.matmul(xf, w1f), torch.matmul(xf, w3f)
    sig = torch.sigmoid(h1)
    s = h1 * sig                                         # silu(h1)
    dhg = torch.matmul(dyf, w2f.transpose(-1, -2))
    hg = (s * h3).to(x.dtype).float()      # as the forward rounds it
    dw2 = torch.matmul(hg.transpose(-1, -2), dyf) if need[3] else None
    dh1 = dhg * h3 * (sig * (1 + h1 * (1 - sig)))        # silu'(h1)
    dh3 = dhg * s
    del h1, h3, sig, s, hg, dhg
    dx = (torch.matmul(dh1, w1f.transpose(-1, -2))
          + torch.matmul(dh3, w3f.transpose(-1, -2))) if need[0] else None
    dw1 = torch.matmul(xf.transpose(-1, -2), dh1) if need[1] else None
    dw3 = torch.matmul(xf.transpose(-1, -2), dh3) if need[2] else None
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip((dx, dw1, dw3, dw2), (x, w1, w3, w2)))


class ExpertFFN(torch.autograd.Function):
    """expert_ffn through ``forward_fn`` (the kernel or the plain version),
    with the recomputing gradient of ``expert_ffn_backward``."""

    @staticmethod
    def forward(ctx, forward_fn, x, w1, w3, w2):
        ctx.save_for_backward(x, w1, w3, w2)
        return forward_fn(x, w1, w3, w2)

    @staticmethod
    def backward(ctx, dy):
        return (None, *expert_ffn_backward(*ctx.saved_tensors, dy,
                                           ctx.needs_input_grad[1:]))


def _lib():
    lib = _build.load("expert_ffn")
    fn = lib.expert_ffn_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


# Per device: the compaction's per-group arrival counts (int32, zero
# between launches: the kernel leaves them zero) and its running total of
# rows computed (int64).
_LIVE: dict = {}


def _live_counters(dev, groups: int) -> tuple:
    done, computed = _LIVE.get(dev, (None, None))
    if computed is None:
        computed = torch.zeros(1, dtype=torch.int64, device=dev)
    if done is None or done.numel() < groups:
        done = torch.zeros(groups, dtype=torch.int32, device=dev)
    _LIVE[dev] = (done, computed)
    return done, computed


def rows_computed() -> int:
    """Rows the kernel computed since the last reset, summed over devices:
    one copy from each device, which waits for its queued work. Read it
    after a run, never inside a step."""
    return sum(int(computed.item()) for _, computed in _LIVE.values())


def reset_rows() -> None:
    expert_ffn_cuda.rows_given = 0
    for _, computed in _LIVE.values():
        computed.zero_()


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
    # the compaction's output: counts [E], then idx [E, C]
    rows = torch.empty(e_n * (c_n + 1), dtype=torch.int32, device=x.device)
    done, computed = _live_counters(x.device, e_n)
    p = _build.ptr
    err = _lib().expert_ffn_launch(
        DTYPE_CODES[x.dtype], p(x), p(w1), p(w3), p(w2), p(rows), p(done),
        p(computed), p(h), p(out), e_n, c_n, d_n, f_n, *plan_args(plan),
        _build.stream_ptr(x.device))
    _build.check(err, "expert_ffn")
    expert_ffn_cuda.launches += 1
    expert_ffn_cuda.rows_given += e_n * c_n
    return out


expert_ffn_cuda.launches = 0
expert_ffn_cuda.rows_given = 0
