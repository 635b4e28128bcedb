"""Training launcher, on the card by default.

    # DeepSeek-V2-Lite at full width, 4 of its 27 layers, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --layers 4 \
        --steps 3 --batch 4 --seq 512

    # RWKV6-1.6B at full width and depth on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --steps 3 --batch 4 --seq 512

    # the reduced DeepSeek on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 20

    # the reduced config on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --reduced --device cpu --steps 20 --batch 4 --seq 64 \
        --save chiprun_out/rwkv.npz

    # Zamba2-7B at full width, 15 of its 81 layers (2 super-blocks of 6
    # Mamba2 layers and the shared attention block, then 3 Mamba2 layers)
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --layers 15 --steps 3 --batch 4 --seq 512

    # the reduced hybrid (or llama-3.2-vision-11b) on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --reduced --device cpu --steps 3 --batch 2 --seq 32

Counterpart of ``repro/launch/train.py``, with the same default arch
(``deepseek-v2-lite-buddy``), ``--device`` added, and ``--layers N``
(keep the first N layers; 0: all), as the serve launcher's. ``--save``
writes the reference's npz key scheme, which
``repro.checkpoint.io.load_pytree`` reads back. Like the reference's, the
loop passes no conditioning: the VLM trains without an image (its cross
blocks run as causal self-attention), and ``musicgen-large``, whose
forward needs its conditioning prefix, raises a ValueError naming
``cond_embeds`` at the first step (the reference fails there too).
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
from repro_torch.training.train_loop import train


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-buddy")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep only the first N layers (0: all)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.layers < 0:
        ap.error("--layers must be >= 0")
    return args


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


def build_config(args) -> ModelConfig:
    """The flags' config: the arch's (or its reduced one), cut to
    ``--layers`` when given."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def build_trainer(args) -> Trainer:
    """The config, random weights from seed 0 on the device, optimizer
    settings and synthetic batches for the flags."""
    dev = resolve_device(args.device)
    cfg = build_config(args)
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
