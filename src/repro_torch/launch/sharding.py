"""Sharding rules: logical-axis rules for activations and per-parameter
partition specs derived from tree paths, and the bytes each device holds
under them.

Counterpart of ``repro/launch/sharding.py``, with its rules to the letter.
Baseline layout:
  * batch        -> data (x pod)
  * TP features  -> model: attention heads / d_ff / vocab; experts are
    tensor-parallel over d_ff
  * expert FSDP  -> optionally shard expert d_model over data (the two
    Mixtrals when training)

The port runs one card per process: no tensor is split by these specs.
They feed the dry run's accounting (``shard_shape``, ``bytes_per_device``)
in place of the reference's ``NamedSharding`` placement, and
``apply_rules`` only hands back the activation rules.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

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
    """The reference's rules context, with nothing to apply on one card
    (``models.common.shard`` is the identity): it yields the rules."""
    return contextlib.nullcontext(activation_rules(prof))
