"""Shared model building blocks (functional, parameters as plain dicts).

Counterpart of ``repro/models/common.py``. The reference annotates
activations with logical sharding names; on one card that is a no-op, so
``shard`` returns its input unchanged.
"""
from __future__ import annotations

from typing import Optional

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


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Sharding hint of the reference; a no-op on one device."""
    return x


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
    return _mm_f32(hg, w2).to(x.dtype)
