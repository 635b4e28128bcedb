"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter
DeepSeek-V2-Lite-family MoE trained for a few hundred steps on the
synthetic LM pipeline.

The twin of examples/train_moe_100m.py: the same two configs, flags and
convergence check, with ``--device`` added. On the card each MoE layer's
forward runs the hand-written topk_gate and expert_ffn kernels, and their
autograd Functions carry the gradient to the router and expert weights.
The checkpoint is the reference's npz key scheme
(``repro.checkpoint.io.load_pytree`` reads it back).

Run:  PYTHONPATH=src python examples/torch_train_moe_100m.py --steps 200
      PYTHONPATH=src python examples/torch_train_moe_100m.py --reduced \
          --device cpu --steps 20

Random weights come from torch's generator (seed 0), so the losses are
not the JAX example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint.io import save_npz
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.training.data import MarkovLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def config_100m(reduced: bool) -> ModelConfig:
    if reduced:   # CI-scale variant (~20M)
        return ModelConfig(
            arch_id="moe-100m-reduced", family="moe", source="example",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
            d_ff=1024, vocab_size=4096,
            moe=MoEConfig(num_experts=8, top_k=2, d_ff=512,
                          num_shared_experts=1, upcycle_noise=0.25))
    return ModelConfig(
        arch_id="moe-100m", family="moe", source="example",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
        d_ff=2048, vocab_size=16384,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=1024,
                      num_shared_experts=1, upcycle_noise=0.25))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="~20M variant for quick runs")
    ap.add_argument("--save", default="results/example_moe.npz")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = config_100m(args.reduced)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"training {cfg.arch_id}: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    lm = MarkovLM(cfg.vocab_size, num_blocks=16, seed=0)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(10, args.steps // 20))
    params, hist = train(cfg, opt,
                         lm.batches(args.batch, args.seq, args.steps),
                         params, log_every=10)
    if args.save:
        save_npz(args.save, params)
        print(f"checkpoint -> {args.save}")
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "training did not converge"


if __name__ == "__main__":
    main()
