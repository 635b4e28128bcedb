#!/usr/bin/env python3
"""Time the routing kernel (``csrc/route.cu``) on the card at chip_smoke.py's
shapes, for one version of the port.

    PYTHONPATH=src python tools/time_route.py [--src DIR] [--label NAME] \
        [--policies] [--out FILE]

E = 64 experts, K = 6, R = 8, H = 8, rho = 3, tau 0.2, the tier and peer
masks on, T = 4, 32, 256 and 4096 tokens, inputs from seed 0. For each T it
prints the wrapper's time per call (median of CUDA-event timings of 10
back-to-back calls, chip_smoke.time_ms) and the kernel's own device time
and device ops per call (torch.profiler, chip_smoke.device_us). --policies
adds cost mode (degraded and peer costs) and Psi's eta/kappa terms with the
temperature and margin co-gate, for a version whose route takes them.
--src takes the ``src`` directory of another checkout (unpacked with ``git
archive`` into a directory that .gitignore lists), which builds its own
kernels: one call on the card can then time two versions in turns (parent,
change, change, parent), each in its own process. Prints one JSON line with
the card's name and power limit. Needs a CUDA device.
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
    ap.add_argument("--policies", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke   # timing helpers; imports no repro_torch
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_route: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.route import route_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    pgen = torch.Generator().manual_seed(1)
    e_n, k_n, r_n = 64, 6, 8
    rows = {}
    for t_n in (4, 32, 256, 4096):
        z = torch.randn(t_n, e_n, generator=gen).to(dev)
        resident = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
        table, q = smoke._buddy_tables(gen, e_n, r_n, dev)
        masks = {m: (torch.rand(e_n, generator=gen) < 0.4).to(dev)
                 for m in ("quant_ok", "peer_ok")}
        cases = {"masks": {}}
        if args.policies:
            cases.update({name: smoke._route_policy(name, pgen, e_n, dev)
                          for name in smoke.ROUTE_POLICY_CASES})
        for name, policy in cases.items():
            def call(policy=policy):
                return route_cuda(z, 0.2, 1.1, resident, table, q, k=k_n,
                                  h=8, rho=3, **masks, **policy)
            rows[f"T{t_n}_{name}"] = {"ms": smoke.time_ms(call, inner=10),
                                      **smoke.device_us(call)}
    out = {"label": args.label, "src": args.src, "nvidia_smi": smi,
           "rows": rows}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
