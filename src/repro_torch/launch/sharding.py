"""Sharding rules: logical-axis rules for activations and per-parameter
partition specs derived from tree paths, the bytes each device holds under
them, and the DTensors that hold one device's share.

Counterpart of ``repro/launch/sharding.py``, with its rules to the letter.
Baseline layout:
  * batch        -> data (x pod)
  * TP features  -> model: attention heads / d_ff / vocab; experts are
    tensor-parallel over d_ff
  * expert FSDP  -> optionally shard expert d_model over data (the two
    Mixtrals when training)

The port runs one card per process. For the dry run's sharded trace a spec
becomes DTensor placements on a ``launch.mesh.fake_mesh`` (``placements``,
the reference's ``to_shardings``), and a tree of tensors becomes DTensors
built from rank 0's blocks (``to_dtensors``), whose bytes are exactly
``bytes_per_device``'s. ``apply_rules`` installs the activation rules that
``models.common.shard`` reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


class P(tuple):
    """A partition spec: one entry per leading dim of a tensor, each None
    (not split), a mesh axis name, or a tuple of names. ``P()`` is
    replicated; dims past the last entry are not split."""

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class ShardingProfile:
    multi_pod: bool = False
    fsdp_experts: bool = False      # shard expert d_model over data axis
    fsdp_dense: bool = False        # shard dense ffn / attn over data too
    shard_vocab: bool = True
    cache_layout: str = "auto"      # 'auto' (heads/hd) | 'seq'

    @property
    def batch(self):
        return ("pod", "data") if self.multi_pod else "data"

    @property
    def fsdp_axis(self):
        return "data"


def profile_for(cfg: ModelConfig, multi_pod: bool = False,
                train: bool = False) -> ShardingProfile:
    """The reference's profile: the two Mixtrals shard their weights over
    data too (FSDP) when training, so weights and optimizer state fit; the
    serve paths keep pure tensor parallelism. Decode caches shard their
    sequence axis for the archs whose KV heads do not divide the model
    axis (``seq_cache_archs``), by head or head dim otherwise."""
    fsdp = train and cfg.arch_id.startswith("mixtral")
    seq_cache_archs = ("internlm2-1.8b", "internlm2-20b", "phi3-medium-14b")
    layout = "seq" if cfg.arch_id in seq_cache_archs else "auto"
    return ShardingProfile(multi_pod=multi_pod, fsdp_experts=fsdp,
                           fsdp_dense=fsdp, cache_layout=layout)


def activation_rules(prof: ShardingProfile, cfg: Optional[ModelConfig] = None,
                     model_size: int = 16) -> dict:
    """Logical activation axis -> mesh axis. Cache layout
    (prof.cache_layout): 'auto' shards the KV-head axis when it divides
    ``model``, else the head dim; 'seq' shards the cache's sequence axis
    over ``model``."""
    rules = {
        "batch": prof.batch,
        "heads": "model",
        "kv_heads": "model",
        "dff": "model",
        "vocab": "model" if prof.shard_vocab else None,
        "expert": None,
        "cache_heads": None,
        "cache_hd": None,
        "cache_seq": None,
    }
    if cfg is not None:
        if prof.cache_layout == "seq":
            rules["cache_seq"] = "model"
        elif cfg.num_kv_heads % model_size == 0:
            rules["cache_heads"] = "model"
        elif cfg.head_dim % model_size == 0:
            rules["cache_hd"] = "model"
    return rules


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
_OUT_FEATURE = ("wq", "wk", "wv", "wg", "ww", "wr", "w1", "w3", "ck",
                "in_proj", "conv_w")
_IN_FEATURE = ("wo", "w2", "cv", "out_proj")


def _base_spec(path: str, name: str, ndim: int, prof: ShardingProfile):
    fsdp = prof.fsdp_axis if prof.fsdp_dense else None
    if name == "embed":
        # d_model-sharded, so the token gather stays local
        return (None, "model")
    if name == "lm_head":
        return (None, "model" if prof.shard_vocab else None)
    if "/moe/" in path:
        efsdp = prof.fsdp_axis if prof.fsdp_experts else None
        if name in ("w1", "w3"):
            return (None, efsdp, "model")        # [E, D, F]
        if name == "w2":
            return (None, "model", efsdp)        # [E, F, D]
        if name == "router":
            return (None, None)
    if "/shared/" in path:
        if name in ("w1", "w3"):
            return (fsdp, "model")
        if name == "w2":
            return ("model", fsdp)
    if name == "u":
        return ("model", None)                   # rwkv bonus [H, hd]
    if name in _OUT_FEATURE:
        return (fsdp, "model")
    if name in _IN_FEATURE:
        return ("model", fsdp)
    if name == "cr":
        return (None, None)
    return None                                   # replicate


def _children(tree):
    """(key, child) pairs of a dict / tuple / list node, else None."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return list(enumerate(tree))
    return None


def _rebuild(like, items):
    if isinstance(like, dict):
        return dict(items)
    vals = [v for _, v in items]
    return type(like)(*vals) if hasattr(like, "_fields") else type(like)(vals)


def _map_with_path(fn, tree, path=()):
    kids = _children(tree)
    if kids is None:
        return None if tree is None else fn(path, tree)
    return _rebuild(tree, [(k, _map_with_path(fn, v, path + (k,)))
                           for k, v in kids])


def param_specs(cfg: ModelConfig, params, prof: ShardingProfile):
    """Partition-spec tree matching ``params`` (nested dicts and tuples of
    tensors, meta ones included), from each leaf's path: the reference's
    ``/groups/0/moe/w1/`` paths and rules."""
    def spec(path_elems, leaf):
        path = "/" + "/".join(str(p) for p in path_elems) + "/"
        base = _base_spec(path, str(path_elems[-1]), leaf.ndim, prof)
        if base is None:
            return P()
        pad = leaf.ndim - len(base)
        if pad < 0:   # 1-D leaf matched a 2-D rule: replicate
            return P()
        return P(*([None] * pad + list(base)))

    return _map_with_path(spec, params)


def placements(spec: P, mesh, ndim: int) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with the spec's
    axis names) for a tensor of ``ndim`` dims under ``spec``: each named
    mesh dim shards the tensor dim that names it, and the rest replicate.
    A tuple of axes on one dim shards it over each, major to minor in the
    tuple's order, as JAX orders them; DTensor orders shards of one dim by
    mesh dim, so the tuple must follow the mesh's order. A mesh dim of
    size 1 replicates."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None or d >= ndim:
            continue
        axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order "
                             f"{names}")
        for m in dims:
            if mesh.size(m) > 1:      # a split over one device replicates
                out[m] = Shard(d)
    return tuple(out)


def _block(leaf: torch.Tensor, spec: P, mesh_shape) -> torch.Tensor:
    """Rank 0's block of ``leaf`` under a sanitized ``spec``: the leading
    slice of every split dim, a fresh contiguous tensor (empty on meta)."""
    shape = shard_shape(tuple(leaf.shape), spec, mesh_shape)
    if leaf.device.type == "meta":
        return torch.empty(shape, dtype=leaf.dtype, device="meta")
    return leaf[tuple(slice(0, n) for n in shape)].clone(
        memory_format=torch.contiguous_format)


def to_dtensors(tree, spec_tree, mesh, mesh_shape):
    """``tree``'s tensors as DTensors on ``mesh`` (a ``DeviceMesh``), each
    built from rank 0's block under its spec in ``spec_tree`` (sanitized
    against ``mesh_shape``, the ``MeshShape`` of ``mesh``, first): the
    local bytes sum to ``bytes_per_device``. Leaves that are not tensors
    (None, a host int) pass through."""
    from torch.distributed.tensor import DTensor

    def one(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = sanitize_spec(spec, tuple(leaf.shape), mesh_shape)
        return DTensor.from_local(
            _block(leaf, spec, mesh_shape), mesh,
            placements(spec, mesh, leaf.ndim), run_check=False,
            shape=leaf.shape, stride=leaf.stride())

    return _zip_specs(one, spec_tree, tree)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, (tuple, list)):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axes]


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes from dims they do not evenly divide (the reference's
    rule for jit argument shardings, which need exact divisibility)."""
    out = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(shape):
            out.append(axes)
            continue
        if isinstance(axes, (tuple, list)):
            kept, size = [], 1
            for a in axes:
                if shape[i] % (size * mesh.shape[a]) == 0:
                    kept.append(a)
                    size *= mesh.shape[a]
            out.append(tuple(kept) if len(kept) > 1 else
                       (kept[0] if kept else None))
        else:
            out.append(axes if shape[i] % mesh.shape[axes] == 0 else None)
    return P(*out)


def _zip_specs(fn, spec_tree, tree):
    """fn(spec, leaf) over a spec tree and the tree it mirrors."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, tree)
    kids = _children(spec_tree)
    if kids is None:
        return None
    other = dict(_children(tree))
    return _rebuild(spec_tree, [(k, _zip_specs(fn, v, other[k]))
                                for k, v in kids])


def sanitize_specs(spec_tree, struct_tree, mesh):
    """Pairwise sanitize a spec tree against the tensors it mirrors."""
    return _zip_specs(lambda s, x: None if x is None
                      else sanitize_spec(s, tuple(x.shape), mesh),
                      spec_tree, struct_tree)


def shard_shape(shape, spec: P, mesh) -> tuple:
    """One device's block of a tensor of ``shape`` under ``spec``: each dim
    divided by the product of its axes' sizes (rounded up: a sanitized
    spec divides exactly)."""
    out = []
    for i, n in enumerate(shape):
        size = _axis_size(mesh, spec[i] if i < len(spec) else None)
        out.append(-(-n // size))
    return tuple(out)


def bytes_per_device(tree, spec_tree, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta ones included)
    under ``spec_tree``: the sum of each leaf's shard shape times its
    element size. None leaves hold nothing."""
    total = []

    def add(spec, leaf):
        if leaf is not None:
            n = 1
            for d in shard_shape(tuple(leaf.shape), spec, mesh):
                n *= d
            total.append(n * leaf.element_size())

    _zip_specs(add, spec_tree, tree)
    return sum(total)


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------
def token_spec(prof: ShardingProfile) -> P:
    return P(prof.batch, None)


def cache_specs(cache_shapes, prof: ShardingProfile):
    """Decode caches are laid out structurally by the dry run, which knows
    each leaf's batch axis, as the reference's are."""
    raise NotImplementedError("use dryrun._cache_spec_tree")


def apply_rules(prof: ShardingProfile):
    """The reference's rules context (``models.common.axis_rules``)."""
    from repro_torch.models.common import axis_rules
    return axis_rules(activation_rules(prof))
