"""Training loop: loss, train step and loop, on ``torch.autograd``.

Counterpart of ``repro/training/train_loop.py``, for every stack: RWKV6,
dense and MoE attention, the Mamba2 hybrid, the VLM and audio (their
``cond_embeds`` passed through to the forward). A MoE layer's train forward
runs the router's ``topk_gate`` and the capacity branch's ``expert_ffn``
(the kernels on the card), whose autograd Functions carry the gradient to
the router and expert weights (``kernels/topk_gate.py``,
``kernels/expert_ffn.py``). ``rng`` (a torch.Generator on the params'
device) drives the router jitter and ``remat`` recomputes each block in
the backward, as the reference's ``rng`` and ``remat``. ``train`` trains
the weights it is given (the reference makes them from a seed inside
``train``; here ``launch/train.build_trainer`` makes them, on the chosen
device); its per-step generator is ``fold_in(seed, step + 1)``, as the
reference folds its key.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ATTN_MOE, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import (all_reduce, fold_in, is_sharded,
                                       local_call, local_range, no_partial,
                                       remap, shard_dims, tree_leaves,
                                       tree_map)
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            apply_updates, init_opt_state)


def lm_loss(params, cfg: ModelConfig, tokens, targets, *, cond_embeds=None,
            rng=None, lb_coef: float = 0.01, remat: bool = False):
    """Mean next-token cross entropy plus the load-balance term."""
    logits, aux = transformer.forward_train(params, cfg, tokens,
                                            cond_embeds=cond_embeds, rng=rng,
                                            remat=remat)
    if is_sharded(logits) and shard_dims(logits.placements, logits.ndim - 1):
        ce = _vocab_split_nll(logits, targets).mean()
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        ce = nll.mean()
    n_moe = max(sum(r for k, r in cfg.stack() if k == ATTN_MOE), 1)
    loss = ce + lb_coef * aux["lb"] / n_moe
    return loss, {"ce": ce, "lb": aux["lb"] / n_moe}


class _SplitNLL(torch.autograd.Function):
    """-log softmax(logits)[target] of one device's vocab shard (inside a
    ``local_call``): the max, the sum of exponentials and the target's
    logit reduced across the shards, as XLA partitions the reference's
    log_softmax and take_along_axis (three all-reduces of [B, S]); the
    gradient, softmax less the one-hot, is local."""

    @staticmethod
    def forward(ctx, logits, targets, lo: int, mesh, dims):
        z = logits.float()
        m = all_reduce(z.amax(-1), "max", mesh, dims)
        shifted = z - m[..., None]
        lse = all_reduce(shifted.exp().sum(-1), "sum", mesh, dims).log()
        idx = targets - lo
        mine = (idx >= 0) & (idx < z.shape[-1])
        idx = idx.clamp(0, z.shape[-1] - 1)
        picked = torch.gather(shifted, -1, idx[..., None])[..., 0]
        picked = all_reduce(torch.where(mine, picked, 0.0), "sum", mesh,
                            dims)
        ctx.save_for_backward(shifted, lse, idx, mine)
        ctx.dtype = logits.dtype
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        shifted, lse, idx, mine = ctx.saved_tensors
        grad = (shifted - lse[..., None]).exp() * g[..., None]
        grad = grad.scatter_add(-1, idx[..., None],
                                torch.where(mine, -g, 0.0)[..., None])
        return grad.to(ctx.dtype), None, None, None, None


def _vocab_split_nll(logits, targets):
    """The per-token NLL [B, S] of logits [B, S, V] split by vocab on the
    model axis (the dry run's sharded trace), through ``_SplitNLL`` on
    each device's rows and vocab shard."""
    mesh = logits.device_mesh
    pl = no_partial(logits.placements)
    dims = shard_dims(pl, logits.ndim - 1)
    rows = remap(pl, {d: d for d in range(logits.ndim - 1)})
    lo = local_range(logits, logits.ndim - 1)[0]
    return local_call(lambda z, t: _SplitNLL.apply(z, t, lo, mesh, dims),
                      (logits, targets), (pl, rows), rows)


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
                   cond_embeds=None, rng=None, lb_coef: float = 0.01,
                   remat: bool = False):
    """(loss, metrics, grads): grads has the params' tree structure; the
    metrics' forward_s and backward_s are ``Span``s."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        m0 = _mark(tokens.device)
        loss, metrics = lm_loss(params, cfg, tokens, targets,
                                cond_embeds=cond_embeds, rng=rng,
                                lb_coef=lb_coef, remat=remat)
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
                    lb_coef: float = 0.01, remat: bool = False):
    """train_step(params, opt_state, tokens, targets, rng=None,
    cond_embeds=None) -> (params, opt_state, metrics); forward_s,
    backward_s and optimizer_s in the metrics are ``Span``s of the three
    phases, read when converted with ``float()``."""

    def train_step(params, opt_state: OptState, tokens, targets, rng=None,
                   cond_embeds=None):
        loss, metrics, grads = loss_and_grads(params, cfg, tokens, targets,
                                              cond_embeds=cond_embeds,
                                              rng=rng, lb_coef=lb_coef,
                                              remat=remat)
        m0 = _mark(tokens.device)
        params, opt_state, opt_metrics = apply_updates(params, grads,
                                                       opt_state, opt_cfg)
        del grads
        metrics = dict(metrics, loss=loss, **opt_metrics,
                       optimizer_s=Span(m0, _mark(tokens.device)))
        return params, opt_state, metrics
    return train_step


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, data_iter, params, *,
          seed: int = 0, log_every: int = 10, lb_coef: float = 0.01,
          log_fn=print):
    """The training loop from ``params`` (trained in place, on their
    device): one train step per [B, S+1] token batch of ``data_iter``,
    step i's router jitter drawn from ``fold_in(seed, i + 1)``.
    Returns (params, history of the logged steps). Each logged step's
    ``step_s`` is the host's wall time per step since the previous logged
    step (or the loop's start): taking the batch, copying it to the device,
    the step, and reading its metrics back, which waits for the device."""
    dev = tree_leaves(params)[0].device
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, lb_coef=lb_coef)
    history = []
    t_last, n_steps = time.perf_counter(), 0
    for i, batch in enumerate(data_iter):
        batch = torch.as_tensor(batch, dtype=torch.int64).to(dev)
        tokens, targets = batch[:, :-1], batch[:, 1:]
        params, opt_state, m = step_fn(params, opt_state, tokens, targets,
                                       fold_in(seed, i + 1, dev))
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
