"""Quickstart on the PyTorch/CUDA port: the full BuddyMoE pipeline.

The twin of examples/quickstart.py:
  1. build a small DeepSeek-V2-Lite-family MoE (64 experts, top-6),
  2. profile expert co-activations on synthetic data (offline phase),
  3. build CFT buddy lists (Eqs. 5-6),
  4. serve batched requests under memory pressure (c = 0.5) with buddy
     substitution, and compare against the on-demand baseline.

Run:  PYTHONPATH=src python examples/torch_quickstart.py            # GPU
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Random weights come from torch's generator (seed 0), so the numbers are
not the JAX example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.deepseek_v2_lite_buddy import profiling
from repro_torch.core import (BuddyPolicy, CoactivationRecorder,
                              build_buddy_lists, calibrate_tau,
                              tae_from_probs)
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.runtime.cache import ExpertCache
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.data import MarkovLM


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    dev = resolve_device(ap.parse_args().device)
    cfg = profiling()
    print(f"model: {cfg.arch_id} — {cfg.moe.num_experts} experts, "
          f"top-{cfg.moe.top_k} (the paper's §5.1 regime), on {dev}")
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lm = MarkovLM(cfg.vocab_size, seed=0)

    # ---- offline phase: co-activation profiling (§3.2) ----
    rec = CoactivationRecorder(cfg.num_layers, cfg.moe.num_experts)
    taes = []
    with torch.no_grad():
        for _ in range(4):
            toks = torch.as_tensor(lm.sample(4, 64)).to(dev)
            _, aux = transformer.forward_train(params, cfg, toks,
                                               record=True)
            per = aux["recorded"][0]
            for l in range(cfg.num_layers):
                probs = per["probs"][l]
                rec.update(l, per["indices"][l].cpu().numpy(),
                           probs.cpu().numpy())
                taes.append(tae_from_probs(probs).cpu().numpy())
            rec.step_done()
    tau = calibrate_tau(np.concatenate(taes), percentile=15)
    print(f"calibrated TAE gate tau (p15): {tau:.3f}")

    # ---- buddy lists via CFT (§3.3) ----
    q = np.stack([rec.conditional(l) for l in range(cfg.num_layers)])
    tables = build_buddy_lists(q, alpha=0.9, k_max=8, activity=rec.A)
    print(f"buddy list sizes: mean {tables.sizes.mean():.1f}, "
          f"max {tables.sizes.max()}")

    # ---- online phase: serve with half the experts offloaded ----
    def serve(policy):
        eng = ServeEngine(cfg, params, tables=tables, policy=policy,
                          cache=ExpertCache(cfg.num_layers,
                                            cfg.moe.num_experts, 0.5, seed=1),
                          seed=1)
        eng.generate(lm.sample(4, 8), max_new_tokens=16)
        return eng

    eng_buddy = serve(BuddyPolicy(tau=tau, beta=0.9, rho=3, H=8))
    eng_base = serve(BuddyPolicy(mode="none"))

    print("\n                    buddy      on-demand")
    print(f"substitutions    {eng_buddy.stats.n_sub:8d} {0:12d}")
    print(f"sync fetches     {eng_buddy.stats.n_miss_fetch:8d} "
          f"{eng_base.stats.n_miss_fetch:12d}")
    print(f"PCIe bytes       {eng_buddy.ledger.total_bytes/1e6:7.1f}M "
          f"{eng_base.ledger.total_bytes/1e6:11.1f}M")
    print(f"tokens/s (model) {eng_buddy.stats.tokens_per_s:8.1f} "
          f"{eng_base.stats.tokens_per_s:12.1f}")
    speedup = eng_buddy.stats.tokens_per_s / max(eng_base.stats.tokens_per_s,
                                                 1e-9)
    print(f"\nBuddyMoE throughput gain on the simulated clock: "
          f"{speedup:.2f}x (paper reports up to 1.10x on real hardware)")


if __name__ == "__main__":
    main()
