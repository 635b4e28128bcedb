"""Random weights made by the benchmark from ``--seed``, in the layout the
port's model takes as ``params``: one leaf per call of ``normal_`` on a
generator on the device, in the configuration's dtype, in the order and
shapes the configuration's family gives (``family.shapes``). Both the
program and the reference read these tensors; neither makes them.
"""
from __future__ import annotations

import torch

# norms are 1 + NORM_JITTER * N(0, 1): a program that skipped a norm's
# gain would not agree with the reference
NORM_JITTER = 0.1


def make(family, run_cfg: dict, seed: int, device) -> dict:
    """The params tree, every leaf drawn on ``device`` from one generator
    seeded with ``seed``; a leaf ``groups.<i>.<...>`` goes into the i-th
    of the tuple ``params["groups"]``."""
    if run_cfg["dtype"] != "float32":
        raise ValueError("the harness makes float32 weights only")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params: dict = {"groups": ()}
    groups: list = []
    for path, (shape, scale) in family.shapes(run_cfg).items():
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if scale is None:
            t.normal_(1.0, NORM_JITTER, generator=gen)
        else:
            t.normal_(0.0, scale, generator=gen)
        keys = path.split(".")
        node = params
        if keys[0] == "groups":
            i = int(keys[1])
            groups.extend({} for _ in range(i + 1 - len(groups)))
            node = groups[i]
            keys = keys[2:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    params["groups"] = tuple(groups)
    return params
