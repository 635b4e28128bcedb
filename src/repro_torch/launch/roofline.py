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

On a sharded trace (DTensors on a ``launch.mesh.fake_mesh``) the counter
counts rank 0's share, as the reference's partitioned HLO is one device's
program: the local ops, at the local shapes, once each. The DTensor-level
call is not counted itself: the counter lets it run and counts what it
dispatches, skipping the sharding propagator's shape inference (ops on
``FakeTensor``s). The collectives it issues (``_c10d_functional``) are
counted by op type in the reference's ring conventions, n the group size
of the mesh dim:

  all-gather          (n-1)/n * result bytes
  reduce-scatter      (n-1)/n * operand bytes
  all-reduce          2(n-1)/n * operand bytes
  all-to-all          (n-1)/n * operand bytes
  collective-permute  operand bytes

Memory: ``peak_bytes`` is the most that the step's new storages held at
once beyond its arguments (registered with ``arguments``), each storage
once whatever views alias it, each rounded up to the CUDA caching
allocator's 512-byte blocks; a storage is freed when the last tensor on it
dies. ``temp_bytes`` is that peak less the step's outputs that are new
storages (``temp_size_bytes`` in XLA's sense: outputs and the arguments
they alias are not temporaries). A kernel call's own temporaries are not
seen: the card's kernel allocates its outputs, and the FFN kernels an f32
hidden buffer [G, C, F] while they run (``kernels.ops._ffn_scratch``).

Hardware constants are the NVIDIA H100 SXM 80GB's at its 700 W power limit
(``HardwareSpec``). The f32 peak is the one outside the tensor cores,
since the port multiplies f32 with TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import weakref
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
    # NVLink 4, bytes/s per direction (H100 SXM 80GB, 700 W); the
    # collective term takes every collective over this one link rate,
    # also where a 16 x 16 mesh would span nodes
    link_bytes_per_s: float = 450e9
    link_name: str = "NVLink 4, 450 GB/s per direction"

    def peak(self, dtype) -> float:
        """Peak FLOP/s for a step in ``dtype`` (a torch dtype or its
        config name)."""
        name = str(dtype).replace("torch.", "")
        return self.peak_flops[name]


H100 = HardwareSpec()

# ops whose result aliases an input without an alias annotation in their
# schema (matmul's and reshape's folding, a collective's wait and autograd
# wrapper), or that only allocate
_VIEWS = {"aten._unsafe_view.default", "aten.lift_fresh.default",
          "_c10d_functional.wait_tensor.default",
          "_c10d_functional._wrap_tensor_autograd.default"}
_NO_TRAFFIC = {"aten.empty.memory_format", "aten.empty_like.default",
               "aten.empty_strided.default", "aten.new_empty.default",
               "aten.new_empty_strided.default",
               # a Python scalar made a 0-d tensor: DTensor makes more of
               # them on the meta device than on a real one
               "aten.scalar_tensor.default"}


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


BLOCK = 512          # the CUDA caching allocator's rounding of a block


def alloc_bytes(n: int) -> int:
    """Bytes the caching allocator hands out for an n-byte request."""
    return -(-n // BLOCK) * BLOCK


# _c10d_functional op -> the reference's collective op type
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all"}


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def collective_bytes(op: str, operand: torch.Tensor, result: torch.Tensor,
                     n: int) -> float:
    """Bytes one device moves for one collective (the module note's ring
    conventions)."""
    ring = (n - 1) / n
    if op == "all-gather":
        return ring * _tensor_bytes(result)
    if op == "all-reduce":
        return 2 * ring * _tensor_bytes(operand)
    if op in ("reduce-scatter", "all-to-all"):
        return ring * _tensor_bytes(operand)
    return float(_tensor_bytes(operand))             # collective-permute


def _rewrap_source(func, args):
    """The storage a collective's autograd wrapper rewraps (the meta
    device gives its output a storage of its own, a real one does not)."""
    if str(func) == "_c10d_functional._wrap_tensor_autograd.default" and \
            _plain(args[0]):
        return args[0].untyped_storage()
    return None


def _fake_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _plain(t) -> bool:
    """A tensor that holds its own storage (not a wrapper subclass such as
    a DTensor, nor a FakeTensor)."""
    return isinstance(t, torch.Tensor) and \
        type(t) in (torch.Tensor, torch.nn.Parameter)


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of every aten op dispatched
    while active, and tracks the memory its new storages hold (see the
    module note for the conventions), with per-op and per-kernel tallies;
    works on meta, CPU and CUDA tensors alike, plain or DTensors.
    ``flops`` and ``bytes`` are the totals, kernels included."""

    def __init__(self):
        super().__init__()
        self.by_op = defaultdict(lambda: {"calls": 0, "flops": 0,
                                          "bytes": 0})
        self.by_kernel = defaultdict(lambda: {"calls": 0, "flops": 0,
                                              "bytes": 0})
        self.coll_bytes_by_op = defaultdict(float)
        self.coll_counts = defaultdict(int)
        self._inside = 0
        self._args = set()           # storages of the arguments
        self._live = {}              # storage key -> allocation key
        self._allocs = {}            # allocation key -> [bytes, storages]
        self._ids = itertools.count()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_blocks = []        # rounded sizes live at the peak
        self.temp_size_bytes = None  # temp_bytes(outputs), set by dryrun

    # -- totals ---------------------------------------------------------
    @property
    def flops(self) -> int:
        return sum(v["flops"] for v in self.by_op.values()) + \
            sum(v["flops"] for v in self.by_kernel.values())

    @property
    def bytes(self) -> int:
        return sum(v["bytes"] for v in self.by_op.values()) + \
            sum(v["bytes"] for v in self.by_kernel.values())

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_bytes_by_op.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "by_kernel": {k: dict(v) for k, v in
                              sorted(self.by_kernel.items())},
                "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())}}

    def collectives(self) -> dict:
        """The reference's ``hlo_analysis`` collective keys."""
        return {"coll_bytes": self.coll_bytes,
                "coll_bytes_by_op": dict(sorted(
                    self.coll_bytes_by_op.items())),
                "coll_counts": dict(sorted(self.coll_counts.items()))}

    # -- memory ---------------------------------------------------------
    @staticmethod
    def _storages(tree):
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor) and not _plain(t) and \
                    hasattr(t, "_local_tensor"):
                t = t._local_tensor
            if _plain(t):
                yield t.untyped_storage()

    def arguments(self, tree) -> None:
        """Register the step's arguments: their storages are never new."""
        for st in self._storages(tree):
            self._args.add(st._cdata)

    def _free(self, key: int) -> None:
        alloc = self._live.pop(key, None)
        if alloc is None:
            return
        rec = self._allocs[alloc]
        rec[1] -= 1
        if not rec[1]:
            del self._allocs[alloc]
            self.live_bytes -= rec[0]

    def _hold(self, st, alloc: int) -> None:
        key = st._cdata
        self._live[key] = alloc
        self._allocs[alloc][1] += 1
        weakref.finalize(st, self._free, key)

    def _track(self, out, alias=None) -> None:
        """Register ``out``'s new storages; with ``alias`` (a storage the
        op only rewraps, which the meta device copies and a real device
        does not) as one allocation with it."""
        src = None if alias is None else self._live.get(alias._cdata)
        for st in self._storages(out):
            key = st._cdata
            if key in self._args or key in self._live:
                continue
            if src is not None:
                self._hold(st, src)
                continue
            nbytes = alloc_bytes(st.nbytes())
            alloc = next(self._ids)
            self._allocs[alloc] = [nbytes, 0]
            self._hold(st, alloc)
            self.live_bytes += nbytes
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                self.peak_blocks = [b for b, _ in self._allocs.values()]

    def temp_bytes(self, outputs) -> int:
        """The peak less the outputs' new storages (alive at the end)."""
        allocs = {self._live.get(st._cdata)
                  for st in self._storages(outputs)} - {None}
        return self.peak_bytes - sum(self._allocs[a][0] for a in allocs)

    # -- kernels --------------------------------------------------------
    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        """One kernel call charged (flops, nbytes); nothing inside it is
        counted. Its outputs' storages are tracked through ``outputs``."""
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

    def outputs(self, out, scratch: int = 0) -> None:
        """A kernel call's outputs, as the card's kernel allocates them,
        and the ``scratch`` bytes it holds beside them while it runs."""
        if not self._inside:
            self._track(out)
            top = self.live_bytes + alloc_bytes(scratch)
            if scratch and top > self.peak_bytes:
                self.peak_bytes = top
                self.peak_blocks = [b for b, _ in self._allocs.values()] \
                    + [alloc_bytes(scratch)]

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
        sub = [t for t in types if t not in (torch.Tensor,
                                             torch.nn.Parameter)]
        if sub:
            from torch._subclasses.fake_tensor import FakeTensor
            if any(issubclass(t, FakeTensor) for t in sub):
                return func(*args, **kwargs)     # shape inference
            # a DTensor call: handed on to the subclass, which runs it with
            # this counter on, so the local ops it dispatches are counted
            return NotImplemented
        out = func(*args, **kwargs)
        if self._inside or _fake_active():
            return out
        if _is_view(func):           # no traffic; a new storage is tracked
            self._track(out, _rewrap_source(func, args))
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
        coll = _COLLECTIVES.get(func.overloadpacket.__name__) \
            if func.namespace in ("_c10d_functional", "_dtensor") else None
        if coll is not None:
            n = _group_size(args[-1])
            self.coll_bytes_by_op[coll] += collective_bytes(
                coll, args[0], out, n)
            self.coll_counts[coll] += 1
        self._track(out)
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
