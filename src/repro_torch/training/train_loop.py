"""Training loop: loss, train step and loop, on ``torch.autograd``.

Counterpart of ``repro/training/train_loop.py``. Stacks with MoE layers are
refused: the port's MoE kernels write their outputs through ctypes, outside
autograd, so router and expert weights would silently get no gradient.
Gradients for ``topk_gate``, ``expert_ffn`` and ``grouped_ffn`` are
ROADMAP.md's "MoE training" item. ``train`` trains the weights it is
given (the reference makes them from a seed inside ``train``; here
``launch/train.build_trainer`` makes them, on the chosen device).
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ATTN_MOE, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            apply_updates, init_opt_state)


def check_trainable(cfg: ModelConfig) -> None:
    if any(kind == ATTN_MOE for kind, _ in cfg.stack()):
        raise NotImplementedError(
            f"{cfg.arch_id}: training a stack with MoE layers needs "
            "gradients through the topk_gate, expert_ffn and grouped_ffn "
            "kernels, which are not written yet (ROADMAP.md, 'MoE "
            "training')")


def lm_loss(params, cfg: ModelConfig, tokens, targets, *,
            lb_coef: float = 0.01):
    """Mean next-token cross entropy plus the load-balance term."""
    logits, aux = transformer.forward_train(params, cfg, tokens)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    ce = nll.mean()
    n_moe = max(sum(r for k, r in cfg.stack() if k == ATTN_MOE), 1)
    loss = ce + lb_coef * aux["lb"] / n_moe
    return loss, {"ce": ce, "lb": aux["lb"] / n_moe}


class Span:
    """The time between two marks (``_mark``), read by ``float()``: on the
    card the CUDA events' elapsed time, after waiting for the later event,
    so the step itself never synchronizes; on the CPU, where every op has
    finished when it returns, the host clock's."""

    def __init__(self, start, end):
        self.start, self.end = start, end

    def __float__(self) -> float:
        if isinstance(self.end, float):
            return self.end - self.start
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _mark(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def loss_and_grads(params, cfg: ModelConfig, tokens, targets, *,
                   lb_coef: float = 0.01):
    """(loss, metrics, grads): grads has the params' tree structure; the
    metrics' forward_s and backward_s are ``Span``s."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        m0 = _mark(tokens.device)
        loss, metrics = lm_loss(params, cfg, tokens, targets,
                                lb_coef=lb_coef)
        m1 = _mark(tokens.device)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        m2 = _mark(tokens.device)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    flat = iter([torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, flat)])
    grads = tree_map(lambda _: next(flat), params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), dict(metrics, forward_s=Span(m0, m1),
                               backward_s=Span(m1, m2)), grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    lb_coef: float = 0.01):
    """train_step(params, opt_state, tokens, targets) -> (params, opt_state,
    metrics); forward_s, backward_s and optimizer_s in the metrics are
    ``Span``s of the three phases, read when converted with ``float()``."""
    check_trainable(cfg)

    def train_step(params, opt_state: OptState, tokens, targets):
        loss, metrics, grads = loss_and_grads(params, cfg, tokens, targets,
                                              lb_coef=lb_coef)
        m0 = _mark(tokens.device)
        params, opt_state, opt_metrics = apply_updates(params, grads,
                                                       opt_state, opt_cfg)
        del grads
        metrics = dict(metrics, loss=loss, **opt_metrics,
                       optimizer_s=Span(m0, _mark(tokens.device)))
        return params, opt_state, metrics
    return train_step


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, data_iter, params, *,
          log_every: int = 10, lb_coef: float = 0.01, log_fn=print):
    """The training loop from ``params`` (trained in place, on their
    device): one train step per [B, S+1] token batch of ``data_iter``.
    Returns (params, history of the logged steps). Each logged step's
    ``step_s`` is the host's wall time per step since the previous logged
    step (or the loop's start): taking the batch, copying it to the device,
    the step, and reading its metrics back, which waits for the device."""
    check_trainable(cfg)
    dev = tree_leaves(params)[0].device
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, lb_coef=lb_coef)
    history = []
    t_last, n_steps = time.perf_counter(), 0
    for i, batch in enumerate(data_iter):
        batch = torch.as_tensor(batch, dtype=torch.int64).to(dev)
        tokens, targets = batch[:, :-1], batch[:, 1:]
        params, opt_state, m = step_fn(params, opt_state, tokens, targets)
        n_steps += 1
        if i % log_every == 0:
            m = {k: float(v) for k, v in m.items()}
            now = time.perf_counter()
            history.append({"step": i, **m,
                            "step_s": (now - t_last) / n_steps})
            t_last, n_steps = now, 0
            log_fn(f"step {i:4d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                   f"lb {m['lb']:.4f} gnorm {m['grad_norm']:.2f}")
    return params, history
