"""Training launcher, on the card by default.

    # RWKV6-1.6B at full width on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --steps 3 --batch 4 --seq 512

    # the reduced config on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --reduced --device cpu --steps 20 --batch 4 --seq 64 \
        --save chiprun_out/rwkv.npz

Counterpart of ``repro/launch/train.py``, with ``--device`` added and
``rwkv6-1.6b`` as the default arch: stacks with MoE layers raise
NotImplementedError until the MoE kernels have gradients. ``--save`` writes
the reference's npz key scheme, which ``repro.checkpoint.io.load_pytree``
reads back.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.io import save_npz
from repro_torch.configs.base import ModelConfig, get_config, get_reduced
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.training.data import MarkovLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import check_trainable, train


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Trainer:
    """What ``train`` needs for one run of the flags."""
    cfg: ModelConfig
    opt_cfg: AdamWConfig
    params: Any
    batches: Any

    def run(self, log_every: int = 10, log_fn=print):
        """Train over every batch; returns (params, history)."""
        return train(self.cfg, self.opt_cfg, self.batches, self.params,
                     log_every=log_every, log_fn=log_fn)


def build_trainer(args) -> Trainer:
    """The config, random weights from seed 0 on the device, optimizer
    settings and synthetic batches for the flags."""
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    check_trainable(cfg)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lm = MarkovLM(cfg.vocab_size, seed=0)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(10, args.steps // 10))
    return Trainer(cfg, opt, params,
                   lm.batches(args.batch, args.seq, args.steps))


def main(argv=None):
    args = parse_args(argv)
    params, hist = build_trainer(args).run()
    if args.save:
        save_npz(args.save, params)
        print(f"saved params to {args.save}")
    print(f"final loss {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
