#!/usr/bin/env python3
"""Time the RWKV6 chunked WKV kernel (``csrc/wkv_chunk.cu``) on the card at
chip_smoke.py's shapes, for one version of the port.

    PYTHONPATH=src python tools/time_wkv.py [--src DIR] [--label NAME] \
        [--out FILE]

Runs chip_smoke.py's own kernel_wkv on inputs from a fresh seed 0 (the same
for every version): the train shape [128, 16, 32, 64] and head dim 128
[64, 8, 32, 128], each held to the plain version. Per shape it prints ms
(CUDA-event median over 10 back-to-back calls), the device time per call
(torch.profiler), the bound and the share of it, the ring's stage depth and
a SHA-256 of the bytes of (o, s_final): two versions whose digests agree
give the same outputs bit for bit. It also prints ptxas's registers and
spill bytes per compiled instance. --src takes the ``src`` directory of
another checkout (unpacked with ``git archive`` into a directory that
.gitignore lists), which builds its own kernel: one call on the card can
then time two versions in turns (parent, change, change, parent), each in
its own process. Prints one JSON line with the card's name and power
limit. Needs a CUDA device.
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
    import chip_smoke as smoke   # the kernel's cases; imports no repro_torch
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_wkv: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build, wkv_chunk
    if not hasattr(wkv_chunk, "stages"):
        # a version from before the ring loaded every chunk after the last
        wkv_chunk.stages = lambda c, d: 1
    _build.build_all(("wkv_chunk",))
    log = (_build.BUILD_DIR / "wkv_chunk.log").read_text()  # nvcc -Xptxas -v
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emitted = []
    smoke.emit = emitted.append
    smoke.kernel_wkv(torch.device("cuda"), torch.Generator().manual_seed(0))
    row = emitted[0]
    out = {"label": args.label, "src": args.src, "nvidia_smi": smi,
           "ptxas": smoke._ptxas_functions(log),
           "by_shape": row["by_shape"],
           "backward_rel_err": row["backward_rel_err"]}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
