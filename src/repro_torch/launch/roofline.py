"""Roofline analysis of a traced step: an op counter, the model's FLOPs,
and the three terms per (arch x shape x mesh).

Counterpart of ``repro/launch/roofline.py``:

  compute term    = FLOPs        / (chips * peak FLOP/s for the dtype)
  memory term     = bytes        / (chips * HBM bytes/s)
  collective term = coll. bytes  / (chips * link bytes/s)

The reference reads its FLOPs and bytes from XLA's compiled HLO text
(``analyze_hlo``, ``parse_hlo_module``, ``parse_collectives`` and
``_shape_bytes``). The port has no HLO: ``OpCounter`` counts the aten ops
a step dispatches instead, so those parsers are not carried over. Its
conventions follow the reference's:

  * FLOPs: dot products only, 2 x result elements x contracted size (mm,
    bmm, addmm, baddbmm, mv, dot, whatever ``matmul`` and ``einsum``
    become); a convolution 2 x result elements. Elementwise ops and
    reductions are 0.
  * bytes: the op-boundary form of the reference's fusion-boundary
    traffic: every op that is not a view or an alias reads each distinct
    input tensor once and writes each output once (an in-place or
    ``out=`` op's written tensor counts once). ``empty`` allocations move
    nothing.
  * a hand-written kernel's call counts as one unit, charged by its cost
    function (``kernels.ops``), whatever implements it: the kernel on the
    card, its plain version on the CPU or meta. The ops inside are not
    counted. Autograd's backward ops are counted as ops.

There is no SPMD partitioner in the port, so no collective is counted:
the collective term is None (``RooflineReport.coll_bytes_per_device``).

Hardware constants are the NVIDIA H100 SXM 80GB's at its 700 W power limit
(``HardwareSpec``). The f32 peak is the one outside the tensor cores,
since the port multiplies f32 with TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One device's peaks. The default is the NVIDIA H100 SXM 80GB at a
    700 W power limit, from NVIDIA's H100 data sheet (a card set to a
    lower limit runs slower under load)."""
    name: str = "NVIDIA H100 SXM 80GB, 700 W"
    # HBM3, bytes/s (H100 SXM 80GB, 700 W)
    hbm_bytes_per_s: float = 3.35e12
    # dense FLOP/s by dtype (H100 SXM 80GB, 700 W): BF16 / FP16 on the
    # tensor cores; FP32 outside them (TF32 off)
    peak_flops: dict = dataclasses.field(default_factory=lambda: {
        "bfloat16": 989e12, "float16": 989e12, "float32": 67e12})
    # NVLink 4, bytes/s per direction (H100 SXM 80GB, 700 W)
    link_bytes_per_s: float = 450e9

    def peak(self, dtype) -> float:
        """Peak FLOP/s for a step in ``dtype`` (a torch dtype or its
        config name)."""
        name = str(dtype).replace("torch.", "")
        return self.peak_flops[name]


H100 = HardwareSpec()

# ops whose result aliases an input without an alias annotation in their
# schema (matmul's and reshape's folding), or that only allocate
_VIEWS = {"aten._unsafe_view.default", "aten.lift_fresh.default"}
_NO_TRAFFIC = {"aten.empty.memory_format", "aten.empty_like.default",
               "aten.empty_strided.default", "aten.new_empty.default",
               "aten.new_empty_strided.default"}


def _is_view(func) -> bool:
    if str(func) in _VIEWS:
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def dot_flops(func, args, out) -> int:
    """FLOPs of one aten op in the dot convention (0 for non-dot ops)."""
    name = func.overloadpacket.__name__
    if name in ("mm", "bmm", "mv", "dot", "vdot"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm", "addmv", "addbmm"):
        k = args[1].shape[-1]
    elif name == "convolution":
        return 2 * out.numel()
    elif name == "convolution_backward":
        return sum(2 * t.numel() for t in out if isinstance(t, torch.Tensor))
    else:
        return 0
    res = out.numel() if name != "addbmm" else \
        args[1].shape[0] * out.numel()
    return 2 * res * int(k)


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op dispatched while active (see
    the module note for the conventions), with per-op and per-kernel
    tallies; works on meta, CPU and CUDA tensors alike, and holds no
    tensor. ``flops`` and ``bytes`` are the totals, kernels included."""

    def __init__(self):
        super().__init__()
        self.by_op = defaultdict(lambda: {"calls": 0, "flops": 0,
                                          "bytes": 0})
        self.by_kernel = defaultdict(lambda: {"calls": 0, "flops": 0,
                                              "bytes": 0})
        self._inside = 0

    # -- totals ---------------------------------------------------------
    @property
    def flops(self) -> int:
        return sum(v["flops"] for v in self.by_op.values()) + \
            sum(v["flops"] for v in self.by_kernel.values())

    @property
    def bytes(self) -> int:
        return sum(v["bytes"] for v in self.by_op.values()) + \
            sum(v["bytes"] for v in self.by_kernel.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "by_kernel": {k: dict(v) for k, v in
                              sorted(self.by_kernel.items())},
                "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())}}

    # -- kernels --------------------------------------------------------
    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        """One kernel call charged (flops, nbytes); nothing inside it is
        counted."""
        if not self._inside:
            k = self.by_kernel[name]
            k["calls"] += 1
            k["flops"] += int(flops)
            k["bytes"] += int(nbytes)
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def __enter__(self):
        if kernel_ops._METER is not None:
            raise RuntimeError("OpCounter: another counter is active")
        kernel_ops._METER = self
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_ops._METER = None
        return super().__exit__(*exc)

    # -- ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside or _is_view(func):
            return out
        name = str(func)
        seen, nbytes = set(), 0
        if name not in _NO_TRAFFIC:
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    nbytes += _tensor_bytes(t)
        rec = self.by_op[name]
        rec["calls"] += 1
        rec["flops"] += dot_flops(func, args, out)
        rec["bytes"] += nbytes
        return out


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: Optional[float]
    model_flops: float
    dtype: str = "bfloat16"
    hardware: str = ""
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: Optional[float] = 0.0
    dominant: str = ""
    useful_flop_ratio: float = 0.0

    def finalize(self, hw: HardwareSpec = H100) -> "RooflineReport":
        """The three terms under ``hw`` (the peak for the step's dtype);
        without collective bytes (None) the collective term is None and
        the dominant term is the larger of the other two."""
        self.hardware = hw.name
        self.compute_s = self.flops_per_device / hw.peak(self.dtype)
        self.memory_s = self.bytes_per_device / hw.hbm_bytes_per_s
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.coll_bytes_per_device is None:
            self.collective_s = None
        else:
            self.collective_s = (self.coll_bytes_per_device
                                 / hw.link_bytes_per_s)
            terms["collective"] = self.collective_s
        self.dominant = max(terms, key=terms.get)
        global_flops = self.flops_per_device * self.chips
        self.useful_flop_ratio = (self.model_flops / global_flops
                                  if global_flops else 0.0)
        return self

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape_kind: str, seq_len: int,
                global_batch: int) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for forward-only (N = active
    params for MoE), D = total tokens processed (1/step for decode)."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * global_batch


def summarize(report: RooflineReport) -> str:
    r = report
    coll = ("      n/a" if r.collective_s is None
            else f"{r.collective_s * 1e3:9.3f}")
    return (f"{r.arch:24s} {r.shape:12s} {r.mesh:10s} "
            f"compute {r.compute_s * 1e3:9.3f} ms | "
            f"memory {r.memory_s * 1e3:9.3f} ms | "
            f"collective {coll} ms | "
            f"dominant {r.dominant:10s} | useful {r.useful_flop_ratio:6.1%}")
