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
(torch.profiler). --src takes the ``src`` directory of another checkout
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
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
