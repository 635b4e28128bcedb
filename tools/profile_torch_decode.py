#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time on the card.

    PYTHONPATH=src python tools/profile_torch_decode.py [--layers 8] [--steps 6] \
        [--quant-tier int8]

Builds the same engine as chip_smoke.py's serve phase (deepseek-v2-lite-buddy
at full width, cut to --layers layers, random weights from seed 0, buddy
profiling, cache-rate 0.5, prev-step predictor), warms it up, then for the
fused and the gather dispatch times --steps decode steps three ways: wall
clock (synchronized), the host-side timeline replay inside the engine
(``ServeEngine._account``), and torch.profiler's device time per kernel.
With --quant-tier the engines carry the replica tier at coverage 0.5
(chip_smoke.py's tier path: 15 full slots and 32 replicas per layer at
full width), so degraded slots run through the grouped kernel's int8 half (fused)
or quant_ffn (gather). Prints one JSON object per dispatch and, with --out,
writes them to a file.
Needs a CUDA device; it exits nonzero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_dispatch(serve, params, layers: int, steps: int, fused: bool,
                     tier_flags=()):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flags = ["--layers", str(layers), "--cache-rate", "0.5", "--policy",
             "buddy", "--predictor", "prev-step", "--batch", "4"]
    eng, lm = serve.build_engine(
        serve.parse_args(flags + list(tier_flags)
                         + (["--fused-dispatch"] if fused else [])),
        params=params)
    account_s = [0.0]
    account = eng._account

    def timed_account(*a, **kw):
        t0 = time.perf_counter()
        account(*a, **kw)
        account_s[0] += time.perf_counter() - t0

    eng._account = timed_account
    prompts = lm.sample(4, steps + 3)
    caches = eng.init_caches(4, 2 * steps + 4)
    tok = eng._tokens(prompts[:, 0])
    for pos in range(3):                           # warm-up
        _, caches = eng.step(tok, caches, pos)
        tok = eng._tokens(prompts[:, pos + 1])
    torch.cuda.synchronize()

    def run(first):
        nonlocal tok, caches
        account_s[0] = 0.0
        t0 = time.perf_counter()
        for pos in range(first, first + steps):
            logits, caches = eng.step(tok, caches, pos)
            tok = eng._tokens(eng.sample_tokens(logits, True))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, account_s[0]

    wall, acc = run(3)                             # without the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = run(3 + steps)
    # device-side kernel and copy events only: the CPU-side aten ops that
    # launched them carry the same device time again
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "dispatch": "fused" if fused else "gather", "layers": layers,
        "steps": steps, "tier": " ".join(tier_flags) or "off",
        "degraded_slots_all_steps": (eng.tier.degraded_tokens
                                     if eng.tier is not None else 0),
        "wall_ms_per_step": wall / steps * 1e3,
        "host_account_ms_per_step": acc / steps * 1e3,
        "profiled_wall_ms_per_step": wall_prof / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_ops_per_step": sum(r[2] for r in rows) / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_prof
                              if busy_us else None),
        "top_device_ops": [{"name": k[:80], "ms_per_step": us / steps / 1e3,
                            "calls_per_step": n / steps}
                           for k, us, n in rows[:15]],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--quant-tier", choices=["off", "int8", "int4"],
                    default="off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tier_flags = () if args.quant_tier == "off" else (
        "--quant-tier", args.quant_tier, "--tier-coverage", "0.5")
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = serve.model_config(serve.parse_args(["--layers",
                                               str(args.layers)]))
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "results": []}
    for fused in (True, False):
        res = profile_dispatch(serve, params, args.layers, args.steps, fused,
                               tier_flags)
        print(json.dumps(res), flush=True)
        out["results"].append(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
