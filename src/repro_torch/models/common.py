"""Shared model building blocks (functional, parameters as plain dicts).

Counterpart of ``repro/models/common.py``. Sharding: model code annotates
activations with *logical* axis names via ``shard(x, ...names)``, where the
reference does. ``axis_rules`` installs a mapping from logical names to
mesh axes (``launch/sharding.py`` makes it); under it, a DTensor (the dry
run's sharded trace, ``launch/dryrun.py``) is redistributed to the
placements its names give, as ``with_sharding_constraint`` constrains the
reference's. Outside the rules, or for a plain tensor, ``shard`` returns
its input, so a step on one card runs no op for it.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """Config dtype string ('float32', ...) or torch dtype -> torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def resolve_device(device) -> torch.device:
    """The device a caller asked for; CUDA must exist when it is asked for
    (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


# The active rules: process-wide, not per thread as the reference keeps
# them, since a CUDA step's backward (remat's recompute and its hints
# included) runs on autograd's device thread.
_RULES = None


def _rules():
    return _RULES


@contextlib.contextmanager
def axis_rules(rules: dict):
    """rules: logical axis name -> mesh axis name (or tuple) or None.
    Yields the rules."""
    global _RULES
    prev, _RULES = _RULES, rules
    try:
        yield rules
    finally:
        _RULES = prev


def logical_spec(names: Sequence[Optional[str]]):
    """The partition spec (``launch.sharding.P``) that the active rules
    give ``names``."""
    from repro_torch.launch.sharding import P
    rules = _rules() or {}
    return P(*[rules.get(n) if n is not None else None for n in names])


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (the dry run's sharded trace). No DTensor
    exists before its module is imported, so a step on one card imports
    nothing for this."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical axis names: under
    ``axis_rules``, a DTensor is redistributed to its spec's placements,
    the dims the spec leaves None and the mesh axes it does not name
    replicated. A mesh axis that does not divide its dim is dropped
    (``sanitize_spec``), where XLA would pad. A batch axis the spec leaves
    unnamed is gathered, as the constraint asks, and then split again as
    it was (a local slice): XLA's partitioner does the same with the
    reference's FFN hints (``("dff",)`` alone), whose products stay split
    by batch. A spec of all None, no rules, or a plain tensor: ``x``
    itself."""
    rules = _rules()
    if rules is None or not is_sharded(x):
        return x
    spec = logical_spec(names)
    if all(s is None for s in spec):
        return x
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import placements, sanitize_spec
    mesh = x.device_mesh
    spec = sanitize_spec(spec, tuple(x.shape),
                         MeshShape(mesh.mesh.shape, mesh.mesh_dim_names))
    want = placements(spec, mesh, x.ndim)
    was = tuple(x.placements)
    if was != want:
        x = x.redistribute(mesh, want)
    batch = rules.get("batch")
    batch = set(batch if isinstance(batch, (tuple, list)) else (batch,))
    back = tuple(
        w if not (mesh.mesh_dim_names[m] in batch and p.is_shard()
                  and w.is_replicate()
                  and all(not q.is_shard(p.dim) for q in want))
        else p for m, (p, w) in enumerate(zip(was, want)))
    if back != want:
        x = x.redistribute(mesh, back)
    return x


class _Settle(torch.autograd.Function):
    """A partial sum reduced; its gradient passed back whole on every
    device (the gradient of a sum reaches each summand unchanged), where
    DTensor's own redistribute would hand back a partial one, and the
    products before it would then gather their weights to keep it so."""

    @staticmethod
    def forward(ctx, x):
        return x.redistribute(x.device_mesh, no_partial(x.placements))

    @staticmethod
    def backward(ctx, g):
        return g


def settle(x):
    """A DTensor with a partial sum pending, reduced (the rest of its
    placements kept), its gradient whole; anything else as it is."""
    if is_sharded(x) and any(p.is_partial() for p in x.placements):
        return _Settle.apply(x)
    return x


def remap(pl, dims: dict) -> tuple:
    """DTensor placements ``pl`` with each ``Shard(d)`` moved to
    ``Shard(dims[d])``, or replicated where ``dims`` maps d to None or
    lacks it; ``Partial`` and ``Replicate`` kept."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in pl:
        if isinstance(p, Shard):
            d = dims.get(p.dim)
            p = Replicate() if d is None else Shard(d)
        out.append(p)
    return tuple(out)


def with_partial(pl, mesh_dims) -> tuple:
    """``pl`` with a sum ``Partial`` on each mesh dim in ``mesh_dims``."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if m in mesh_dims else p
                 for m, p in enumerate(pl))


def ways(t, dims) -> int:
    """Devices a DTensor's ``dims`` are split over."""
    n = 1
    for m in set().union(*(shard_dims(t.placements, d) for d in dims)):
        n *= t.device_mesh.size(m)
    return n


def gathered(t, dim: int):
    """DTensor ``t`` gathered whole on ``dim``, its other splits kept."""
    return t.redistribute(t.device_mesh, remap(
        t.placements, {d: d for d in range(t.ndim) if d != dim}))


def whole(t, n: int, dim: int):
    """t, under a mesh gathered on ``dim`` where its split does not divide
    ``n`` (the heads of a [.., n * hd] -> [.., n, hd] view, or the kv heads
    of [.., H, ..] -> [.., KV, g, ..]): DTensor cannot view a split off
    those boundaries, where XLA would reshard."""
    if is_sharded(t) and n % ways(t, (dim,)):
        t = gathered(t, dim)
    return t


def coordinate(mesh, dims) -> tuple:
    """(devices, rank 0's index among them) over the mesh dims ``dims``,
    major to minor."""
    n, idx = 1, 0
    for m in sorted(dims):
        n *= mesh.size(m)
        idx = idx * mesh.size(m) + mesh.get_local_rank(m)
    return n, idx


def all_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``t`` (a local block inside a ``local_call``) reduced with ``op``
    ("sum", "max") across the mesh dims ``dims``, one functional
    all-reduce each: the collectives a partitioned step issues where the
    split dim is contracted or reduced."""
    c10d = torch.ops._c10d_functional
    for d in sorted(dims):
        t = c10d.wait_tensor(c10d.all_reduce(t, op,
                                             mesh.get_group(d).group_name))
    return t


def padded_split(t, dim: int, name: str):
    """Where the active rules split logical axis ``name`` over mesh axes
    that do not divide t's ``dim`` (the hint drops them, see ``shard``;
    XLA pads such a split and gives each device ceil(n / ways) of it):
    (the mesh dims, the per-device count, rank 0's first index). None
    where the dim is split already, divides, or no rule names it."""
    axes = (_rules() or {}).get(name)
    if not is_sharded(t) or axes is None or shard_dims(t.placements, dim):
        return None
    mesh = t.device_mesh
    axes = axes if isinstance(axes, (tuple, list)) else (axes,)
    dims = [mesh.mesh_dim_names.index(a) for a in axes
            if a in mesh.mesh_dim_names]
    dims = [m for m in dims if mesh.size(m) > 1]
    n, rank = coordinate(mesh, dims)
    if not dims or t.shape[dim] % n == 0:
        return None
    per = -(-t.shape[dim] // n)
    return dims, per, rank * per


def unpad(t, dim: int, n: int):
    """A DTensor split over a padded dim (``padded_split``'s share on each
    device) gathered whole and cut back to its n entries."""
    return gathered(t, dim).narrow(dim, 0, n)


def local_range(t, dim: int) -> tuple:
    """(first index, length) of rank 0's block of a DTensor along
    ``dim``: its coordinates on the mesh dims that split the dim, major
    to minor, times the block's length."""
    idx = coordinate(t.device_mesh, shard_dims(t.placements, dim))[1]
    n = t.to_local().shape[dim]
    return idx * n, n


def no_partial(pl) -> tuple:
    """``pl`` with every ``Partial`` replicated (the gradient of a partial
    sum is the whole gradient on each device)."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Replicate() if isinstance(p, Partial) else p for p in pl)


def shard_dims(pl, dim: int) -> set:
    """The mesh dims on which ``pl`` shards tensor dim ``dim``."""
    from torch.distributed.tensor import Shard
    return {m for m, p in enumerate(pl) if isinstance(p, Shard) and
            p.dim == dim}


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose gradient is brought back to the placements
    the forward gave its output before it is reshaped back: DTensor cannot
    view a gradient split off the head boundaries (the model axis not
    dividing the heads), where XLA would reshard it."""

    @staticmethod
    def forward(ctx, t, shape):
        out = t.reshape(shape)
        ctx.shape, ctx.out_pl = t.shape, out.placements
        return out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.out_pl):
            g = g.redistribute(g.device_mesh, no_partial(ctx.out_pl))
        return g.reshape(ctx.shape), None


def reshape(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(shape)``; for a DTensor through ``_Reshape``."""
    if is_sharded(t):
        return _Reshape.apply(t, shape)
    return t.reshape(shape)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local region's
    gradient (a permuted layout from inside it) becomes a DTensor's local
    block, which DTensor views as if contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, args, in_pl, out_pl, grad_pl=None):
    """``fn(*args)`` on rank 0's blocks of the DTensors in ``args``
    (``torch.distributed.tensor.experimental.local_map``): each DTensor
    redistributed to its placements in ``in_pl`` first (one entry per
    flattened argument, None for what is not a tensor), the outputs
    DTensors of ``out_pl``, and the inputs' gradients of ``grad_pl``
    (default ``in_pl``); a plain tensor among them (one the step made:
    replicated) is split the same way. ``fn`` sees plain tensors only."""
    from torch.distributed.tensor import DTensor, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map
    if isinstance(out_pl[0], Placement):        # one output
        out_pl = list(out_pl)
    mesh = next(a.device_mesh for a in args if is_sharded(a))
    rep = (Replicate(),) * mesh.ndim
    args = tuple(DTensor.from_local(a, mesh, rep, run_check=False)
                 if isinstance(a, torch.Tensor) and not is_sharded(a)
                 and p is not None else a for a, p in zip(args, in_pl))

    def local(*a):
        return fn(*(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor)
                    and t.requires_grad else t for t in a))
    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl,
                     redistribute_inputs=True)(*args)


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64), for idx in [0, n), as one comparison
    against ``arange(n)``: the same ops on every device (``F.one_hot``
    checks the values on the CPU and scatters on the CPU and CUDA, but
    compares on the meta device), so an op count of a step is the same
    wherever it runs."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts / tuples / lists of tensors)
# ---------------------------------------------------------------------------
def tree_leaves(tree) -> list:
    """The leaves of a nested dict / tuple / list tree. Dicts are walked in
    sorted key order, as ``tree_map`` walks them, so two trees with the same
    keys give their leaves in the same order however they were built."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """The tree with ``fn`` applied to every leaf (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# Initializers (torch.Generator streams; they do not reproduce jax.random)
# ---------------------------------------------------------------------------
def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    return (normal(gen, (in_dim, out_dim), device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    return (normal(gen, (vocab, dim), device) * 0.02).to(dtype)


def fold_in(seed: int, i: int, device) -> torch.Generator:
    """A fresh generator on ``device`` for stream ``i`` of ``seed`` (the
    role of jax.random.fold_in: the same (seed, i) gives the same draws,
    other i other draws). Its seed is a host integer, so making it never
    waits for the device."""
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + i + 1) % (2 ** 63))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # [hd/2]
    angles = positions[..., None].float() * freqs               # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                       # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation (the reference's
    preferred_element_type=f32): f32 inputs multiply as they are, lower
    precision ones are promoted first."""
    return torch.matmul(a.float(), b.float())


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x@w1) * (x@w3)) @ w2, with f32 accumulation and
    the hidden product cast back to x.dtype between the two matmuls."""
    h = F.silu(_mm_f32(x, w1))
    g = _mm_f32(x, w3)
    hg = (h * g).to(x.dtype)
    hg = shard(hg, *([None] * (hg.ndim - 1)), "dff")
    return settle(_mm_f32(hg, w2)).to(x.dtype)
