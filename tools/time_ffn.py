#!/usr/bin/env python3
"""Time the three FFN kernels of the shared tile (``csrc/ffn_gemm.cuh``:
expert_ffn, grouped_ffn, quant_ffn) on the card at chip_smoke.py's shapes,
for one version of the port.

    PYTHONPATH=src python tools/time_ffn.py [--src DIR] [--label NAME] \
        [--out FILE]

Runs chip_smoke.py's own kernel_expert_ffn, kernel_grouped_ffn and
kernel_quant_ffn, each on inputs from a fresh seed 0 (the same for every
version), each held to its plain version, and prints their rows: ms, plain
ms, bound, stage depth, and for quant_ffn the device time per kernel
(torch.profiler). Then expert_ffn at the benchmark's decode cell
(``expert_ffn_decode_cell``: Mixtral-8x22B's [8, 128, 6144] x 16384 in
f32, 64 tokens x 2 picks binned per token as moe.py's capacity branch
does, from seed 38): ms, device time per kernel, the bound of the live
experts' weights, x and out, and the live rows per expert and their
largest. --src takes the ``src`` directory of another checkout
(unpacked with ``git archive`` into a directory that .gitignore lists),
which builds its own kernels: one call on the card can then time two
versions in turns (parent, change, change, parent), each in its own
process. Prints one JSON line with the card's name and power limit. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def decode_cell(smoke, dev, seed: int) -> dict:
    """expert_ffn on the decode cell's capacity buffer: B = 64 tokens, K = 2
    distinct experts each, binned per token into [E, B, cap = K] (a pick
    takes its token's first slot of that expert, so the live rows sit at
    2b), weights random on the card."""
    import torch
    from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,
                                                expert_ffn_plain)
    e_n, k_n, b_n, d_n, f_n = 8, 2, 64, 6144, 16384
    g = torch.Generator().manual_seed(seed)
    x = smoke._capacity_binned(g, torch.randn(b_n, d_n, generator=g), b_n,
                               e_n, k_n, dev)
    wg = torch.Generator(device=dev).manual_seed(seed)
    ws = [torch.randn(e_n, a, b, generator=wg, device=dev).mul_(0.02)
          for a, b in ((d_n, f_n), (d_n, f_n), (f_n, d_n))]
    per_expert = (x != 0).any(-1).sum(-1).tolist()
    n_rows, n_live = sum(per_expert), sum(n > 0 for n in per_expert)
    got, want = expert_ffn_cuda(x, *ws), expert_ffn_plain(x, *ws)
    moved = smoke.nbytes(x, got) + smoke.nbytes(*ws) * n_live // e_n
    b_ms, b_by = smoke.bound(moved, 2 * n_rows * d_n * f_n * 3)
    ms = smoke.time_ms(lambda: expert_ffn_cuda(x, *ws))
    return {"shape": list(x.shape) + [f_n], "live_rows": n_rows,
            "live_rows_per_expert": per_expert,
            "live_rows_max": max(per_expert), "live_experts": n_live,
            "max_abs_err": smoke.max_err(got, want),
            "max_abs_plain": float(want.abs().max()), "ms": ms,
            "plain_ms": smoke.time_ms(lambda: expert_ffn_plain(x, *ws),
                                      reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            **smoke.ffn_rate(moved, ms, b_ms),
            **smoke.device_us(lambda: expert_ffn_cuda(x, *ws), by_op=True)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke   # the kernels' cases; imports no repro_torch
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_ffn: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch.kernels import expert_ffn
    plan = expert_ffn.launch_plan
    # a version from before the per-class stage depth names no "bk": its
    # tile staged every class 16 deep
    expert_ffn.launch_plan = lambda *a, **k: {"bk": 16, **plan(*a, **k)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    emitted = []
    smoke.emit = emitted.append
    for run in (smoke.kernel_expert_ffn, smoke.kernel_grouped_ffn,
                smoke.kernel_quant_ffn):
        run(dev, torch.Generator().manual_seed(0))
    out = {"label": args.label, "src": args.src, "nvidia_smi": smi,
           "kernels": {o.pop("kernel"): o for o in emitted}}
    out["kernels"]["expert_ffn_decode_cell"] = decode_cell(smoke, dev, 38)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
