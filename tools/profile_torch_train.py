#!/usr/bin/env python3
"""Where a train step of the PyTorch/CUDA port spends its time on the card.

    PYTHONPATH=src python tools/profile_torch_train.py [--steps 2] \
        [--batch 4] [--seq 512] [--out profile_train.json]

Builds the same trainer as chip_smoke.py's train phase (rwkv6-1.6b at full
width and depth, random weights from seed 0, through launch/train.py's
entry points), runs one warm-up step, then --steps steps under
torch.profiler. Reports the host's wall time per step (the train loop's
step_s: taking and copying the batch, the step, reading its metrics back),
its forward / backward / optimizer split (CUDA-event spans from the train
step's own metrics), the device's busy time and idle share, device time
per kernel, and the same summed into classes: f32 matmuls (cuBLAS),
wkv_chunk, and everything else (elementwise, reductions, copies). Needs a
CUDA device; it exits nonzero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# substrings of cuBLAS / CUTLASS matmul kernel names
GEMM = ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere_sgemm")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _class(name: str) -> str:
    low = name.lower()
    if "wkv_chunk" in low:
        return "wkv_chunk"
    if any(g in low for g in GEMM):
        return "matmul"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launch
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trainer = launch.build_trainer(launch.parse_args(
        ["--arch", "rwkv6-1.6b", "--batch", str(args.batch), "--seq",
         str(args.seq), "--steps", str(args.steps + 1)]))
    batches = list(trainer.batches)
    trainer.batches = iter(batches[:1])            # warm-up step
    params, _ = trainer.run(log_fn=lambda _: None)
    trainer.params, trainer.batches = params, iter(batches[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    n = len(hist)
    wall = sum(h["step_s"] for h in hist)
    # device-side kernel and copy events only: the CPU-side aten ops that
    # launched them carry the same device time again
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    classes: dict = {}
    for k, us, cnt in rows:
        c = classes.setdefault(_class(k), {"ms_per_step": 0.0,
                                           "calls_per_step": 0.0})
        c["ms_per_step"] += us / n / 1e3
        c["calls_per_step"] += cnt / n
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "arch": trainer.cfg.arch_id, "batch": args.batch,
           "seq": args.seq, "steps": n,
           "profiled_wall_ms_per_step": wall / n * 1e3,
           "forward_ms": sum(h["forward_s"] for h in hist) / n * 1e3,
           "backward_ms": sum(h["backward_s"] for h in hist) / n * 1e3,
           "optimizer_ms": sum(h["optimizer_s"] for h in hist) / n * 1e3,
           "device_busy_ms_per_step": busy_us / n / 1e3,
           "device_ops_per_step": sum(r[2] for r in rows) / n,
           "device_idle_share": 1.0 - busy_us / 1e6 / wall,
           "by_class": classes,
           "top_device_ops": [{"name": k[:90], "ms_per_step": us / n / 1e3,
                               "calls_per_step": cnt / n}
                              for k, us, cnt in rows[:20]]}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
