"""Checkpoint I/O: the reference's npz key scheme <-> nested torch dicts.

Keys follow ``repro/checkpoint/io.py``: a '/'-joined path through the
parameter tree (``embed``, ``groups/0/attn/wq``, ``groups/0/moe/w1``, ...),
where the integer step under ``groups`` indexes the tuple of layer groups.
Each group's arrays keep their stacked ``[L, ...]`` layout.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import resolve_device, torch_dtype


def params_from_numpy(flat: dict, device, dtype=None) -> dict:
    """{'groups/0/moe/w1': ndarray, ...} -> nested params on ``device``.

    ``dtype`` (optional) casts the floating-point leaves; integer leaves
    keep their type. The tensors own copies of the arrays, so training in
    place never writes into the caller's arrays."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    tree: dict = {}
    for key in sorted(flat):
        t = torch.from_numpy(np.array(flat[key]))
        if dt is not None and t.is_floating_point():
            t = t.to(dt)
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(dev)
    if "groups" in tree:
        groups = tree["groups"]
        tree["groups"] = tuple(groups[str(i)] for i in range(len(groups)))
    return tree


def params_to_numpy(tree: Any, prefix: str = "") -> dict:
    """Inverse of params_from_numpy: nested params -> flat {key: ndarray}."""
    flat = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree.detach().cpu().numpy()}
    for k, v in items:
        flat.update(params_to_numpy(v, f"{prefix}/{k}" if prefix else k))
    return flat


def save_npz(path: str, params) -> None:
    """Write params in the reference's ``save_pytree`` format (a
    compressed npz under the same keys)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **params_to_numpy(params))


def load_npz(path: str, device) -> dict:
    """Load a reference ``save_pytree`` npz straight into torch tensors."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, device)
