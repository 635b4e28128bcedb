"""Serving launcher — BuddyMoE engine over a random or loaded checkpoint, on
the card by default.

    # static one-shot batch (the paper's harness), on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-buddy --reduced --cache-rate 0.5 \
        --policy buddy --steps 64

    # the same on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Counterpart of ``repro/launch/serve.py`` for batch mode. Flags of the
subsystems that are not ported yet (continuous mode, the quant tier, the
mesh, paged KV and the prefix cache, live placement, telemetry and traces)
stop with "not ported yet".
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.checkpoint.io import load_npz
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.core.buddies import build_buddy_lists
from repro_torch.core.coactivation import CoactivationRecorder
from repro_torch.core.policy import BuddyPolicy
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.runtime.cache import ExpertCache
from repro_torch.runtime.prefetch import (CrossLayerPredictor,
                                          PrevStepPredictor, TopFreqPredictor)
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.data import MarkovLM

PREDICTORS = {
    "prev-step": PrevStepPredictor,
    "top-freq": TopFreqPredictor,
    "cross-layer": CrossLayerPredictor,
}


def profile_buddies(cfg, params, lm, *, steps: int = 4, batch: int = 4,
                    seq: int = 64, alpha: float = 0.9, k_max: int = 8):
    """Offline phase: router traces -> co-activation -> CFT buddy lists."""
    n_moe = sum(r for k, r in cfg.stack() if k == "attn_moe")
    rec = CoactivationRecorder(n_moe, cfg.moe.num_experts)
    dev = params["embed"].device
    for _ in range(steps):
        toks = torch.as_tensor(lm.sample(batch, seq), dtype=torch.int64) \
            .to(dev)
        _, aux = transformer.forward_train(params, cfg, toks, record=True)
        per = aux["recorded"][0]
        idx = per["indices"].cpu().numpy()
        probs = per["probs"].cpu().numpy()
        for l in range(n_moe):
            rec.update(l, idx[l], probs[l])
        rec.step_done()
    q = np.stack([rec.conditional(l) for l in range(n_moe)])
    return build_buddy_lists(q, alpha=alpha, k_max=k_max, activity=rec.A), rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-buddy")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep only the first N layers (0: all) — the full "
                         "widths with less depth, for a quick run")
    ap.add_argument("--checkpoint", default=None,
                    help="npz in the reference's save_pytree key scheme")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--cache-rate", type=float, default=0.5)
    ap.add_argument("--policy", choices=["buddy", "random", "none"],
                    default="buddy")
    ap.add_argument("--tau", type=float, default=0.2)
    ap.add_argument("--beta", type=float, default=0.8)
    ap.add_argument("--rho", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=0.9)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--predictor", choices=sorted(PREDICTORS),
                    default="prev-step")
    ap.add_argument("--prefetch-k", type=int, default=-1,
                    help="-1: half the cache capacity")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="issue layer l+k prefetches while layer l computes")
    ap.add_argument("--miss-policy", choices=["precedence", "cost"],
                    default="precedence",
                    help="'cost' runs on the CPU only in this port")
    ap.add_argument("--stall-per-quality", type=float, default=0.05)
    ap.add_argument("--drop-loss", type=float, default=1.0)
    ap.add_argument("--prefetch-min-saving", type=float, default=-1.0)
    ap.add_argument("--fused-dispatch", action="store_true",
                    help="single-dispatch hot path: every slot in ONE "
                         "grouped expert launch (kernels/grouped_ffn.py)")
    # subsystems that are not ported yet: present so that they fail loudly
    ap.add_argument("--mode", choices=["batch", "continuous"],
                    default="batch")
    ap.add_argument("--quant-tier", choices=["off", "int8", "int4"],
                    default="off")
    ap.add_argument("--n-devices", type=int, default=1)
    ap.add_argument("--paged-kv", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--placement", choices=["off", "live"], default="off")
    ap.add_argument("--telemetry", choices=["off", "on"], default="off")
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    for flag, on in (("--mode continuous", args.mode != "batch"),
                     ("--quant-tier", args.quant_tier != "off"),
                     ("--n-devices > 1", args.n_devices != 1),
                     ("--paged-kv", args.paged_kv),
                     ("--prefix-cache", args.prefix_cache),
                     ("--placement live", args.placement != "off"),
                     ("--telemetry", args.telemetry != "off"),
                     ("--trace-out", args.trace_out is not None),
                     ("--trace", args.trace is not None)):
        if on:
            ap.error(f"{flag}: not ported yet")
    if args.lookahead < 1:
        ap.error("--lookahead must be >= 1 (layers ahead to prefetch)")
    if args.layers < 0:
        ap.error("--layers must be >= 0")
    return args


def model_config(args):
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if not cfg.is_moe:
        raise ValueError("the serving engine targets MoE archs")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def build_engine(args, params=None):
    """Weights (loaded, given, or random from seed 0), buddy profiling and
    the engine. Returns (engine, MarkovLM)."""
    dev = resolve_device(args.device)
    cfg = model_config(args)
    if params is None and args.checkpoint:
        params = load_npz(args.checkpoint, dev)
    elif params is None:
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lm = MarkovLM(cfg.vocab_size, seed=0)
    tables, _ = profile_buddies(cfg, params, lm, alpha=args.alpha)
    n_moe = sum(r for k, r in cfg.stack() if k == "attn_moe")
    policy = BuddyPolicy(tau=args.tau, beta=args.beta, rho=args.rho,
                         mode=args.policy, miss_policy=args.miss_policy,
                         stall_per_quality=args.stall_per_quality,
                         drop_loss=args.drop_loss,
                         use_fused_dispatch=args.fused_dispatch)
    cache = ExpertCache(n_moe, cfg.moe.num_experts, args.cache_rate)
    prefetch_k = (max(1, cache.capacity // 2) if args.prefetch_k < 0
                  else args.prefetch_k)
    predictor = PREDICTORS[args.predictor](n_moe, cfg.moe.num_experts)
    eng = ServeEngine(cfg, params, tables=tables, policy=policy, cache=cache,
                      predictor=predictor, prefetch_k=prefetch_k,
                      lookahead=args.lookahead,
                      prefetch_min_saving=(None if args.prefetch_min_saving
                                           < 0 else args.prefetch_min_saving))
    return eng, lm


def main(argv=None):
    args = parse_args(argv)
    eng, lm = build_engine(args)
    out = eng.generate(lm.sample(args.batch, 8), max_new_tokens=args.steps)
    s = eng.summary()
    print(json.dumps(s, indent=1, default=str))
    bd = s["stall_breakdown"]
    print(f"stalls: demand {bd['demand_stall_s']*1e3:.2f}ms  "
          f"late-prefetch {bd['late_prefetch_stall_s']*1e3:.2f}ms  "
          f"overlapped {bd['overlapped_s']*1e3:.2f}ms")
    print("sample output tokens:", out[0, -16:].tolist())


if __name__ == "__main__":
    main()
