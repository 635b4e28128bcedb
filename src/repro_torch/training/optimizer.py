"""AdamW + cosine schedule, as plain functions on the parameter tree.

Counterpart of ``repro/training/optimizer.py``, with its update (not
``torch.optim.AdamW``'s): gradients are clipped by their global norm, the
weight decay is added to the Adam direction before the learning rate
multiplies it, and only leaves with ``ndim >= 2`` are decayed. Layers stay
stacked [L, ...] as in the reference, so the stacked norms, mixes, decay
biases and ``u`` count as 2-D and are decayed there as here.

``apply_updates`` writes the new parameters and moments into the tensors it
is given (the reference returns new trees): at full width that saves a
model-sized copy per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor             # int32 scalar
    mu: Any
    nu: Any


def init_opt_state(params) -> OptState:
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(step, zeros(), zeros())


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step in place. Returns (params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:  # decay matrices only
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    return params, OptState(step, state.mu, state.nu), \
        {"lr": lr, "grad_norm": gnorm}
