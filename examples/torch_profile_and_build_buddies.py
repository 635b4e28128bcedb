"""Offline phase walkthrough on the PyTorch/CUDA port (§3.2-§3.3): router
traces -> co-activation matrix -> conditional q_{j|i} -> CFT buddy lists
-> serialized tables.

The twin of examples/profile_and_build_buddies.py, on the committed trained
model and its co-activation profile (results/bench/model.npz, coact.npz):
  * uneven activation (Fig. 6),
  * concentrated co-activation (Figs. 7/9),
  * compact buddy lists (|B| stats),
  * expert output similarity (the redundancy being exploited), every
    expert's SwiGLU on the calibration rows through the expert_ffn kernel
    on the card (its plain version on the CPU).

Run:  PYTHONPATH=src python examples/torch_profile_and_build_buddies.py
      PYTHONPATH=src python examples/torch_profile_and_build_buddies.py \
          --device cpu --out build/buddy_tables_example.npz
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np

from repro_torch.checkpoint.io import load_npz
from repro_torch.configs.deepseek_v2_lite_buddy import profiling
from repro_torch.core.buddies import (alpha_schedule, build_buddy_lists,
                                      list_size_stats, save_tables)
from repro_torch.core.coactivation import CoactivationRecorder
from repro_torch.core.similarity import all_layer_similarities
from repro_torch.models.common import resolve_device
from repro_torch.training.data import MarkovLM

BENCH = os.path.join(ROOT, "results", "bench")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "buddy_tables_example.npz"))
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = profiling()
    params = load_npz(os.path.join(BENCH, "model.npz"), dev)
    rec = CoactivationRecorder.load(os.path.join(BENCH, "coact.npz"))
    q = np.stack([rec.conditional(l) for l in range(cfg.num_layers)])
    lm = MarkovLM(cfg.vocab_size, num_blocks=8, seed=0)

    print("\n--- Fig. 6: uneven activation ---")
    for l in range(cfg.num_layers):
        s = rec.activation_skew(l)
        print(f"layer {l}: gini {s['gini']:.3f}  top-1 share "
              f"{s['top1_share']:.3f}  top-8 share {s['top8_share']:.3f} "
              f"(uniform would be {8 / cfg.moe.num_experts:.3f})")

    print("\n--- Figs. 7/9: co-activation concentration ---")
    for l in range(cfg.num_layers):
        print(f"layer {l}: top-8 peers cover "
              f"{rec.topr_coverage(l, 8).mean():.1%} of co-activation mass "
              f"(uniform: {8 / (cfg.moe.num_experts - 1):.1%})")

    print(f"\n--- expert output similarity (the redundancy, Fig. 4), on "
          f"{dev} ---")
    sims = all_layer_similarities(cfg, params, lm.sample(4, 64))
    for l in range(cfg.num_layers):
        off = sims[l][~np.eye(cfg.moe.num_experts, dtype=bool)]
        print(f"layer {l}: mean pairwise output cosine {off.mean():.3f}, "
              f"p90 {np.percentile(off, 90):.3f}")

    print("\n--- CFT buddy lists (Eqs. 5-6), per-layer alpha schedule ---")
    alphas = alpha_schedule(cfg.num_layers, early=0.95, late=0.85)
    tables = build_buddy_lists(q, alpha=alphas, k_max=16, activity=rec.A,
                               output_sim=sims)
    print(f"alpha schedule: {np.round(alphas, 3).tolist()}")
    print(f"list sizes: {list_size_stats(tables)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_tables(args.out, tables)
    print(f"serialized buddy tables -> {args.out} "
          f"(ships alongside the checkpoint, §3.4)")


if __name__ == "__main__":
    main()
