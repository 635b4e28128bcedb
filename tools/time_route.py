#!/usr/bin/env python3
"""Time the routing kernel (``csrc/route.cu``) on the card at chip_smoke.py's
shapes, for one version of the port.

    PYTHONPATH=src python tools/time_route.py [--src DIR] [--label NAME] \
        [--policies] [--floor] [--out FILE]

E = 64 experts, K = 6, R = 8, H = 8, rho = 3, tau 0.2, the tier and peer
masks on, T = 4, 8, 16, 32, 64, 128, 256, 512, 1024 and 4096 tokens, inputs
from seed 0. For each T it prints the form that ran ("cluster" with its
CTAs, "grid", or a version's "block") and its launches per call, whether
every int and bool output equals route_plain's and the floats are within
chip_smoke.TOL_GATE, the wrapper's time per call (median of CUDA-event
timings of 10 back-to-back calls, chip_smoke.time_ms) and the kernel's own
device time and device ops per call (torch.profiler, chip_smoke.device_us)
and its device time per call with the stream kept full (queued_us: the
two-launch form's gap between its kernels included, no host time).
--policies adds cost mode (degraded and peer costs) and Psi's eta/kappa
terms with the temperature and margin co-gate, for a version whose route
takes them. --floor adds the launch floor: the device time of a one-element
torch op (``add_`` on one f32) in the same profiler window as route,
topk_gate and buddy_substitute at chip_smoke.py's shapes.
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
T_SWEEP = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


def _form(plan) -> str:
    ctas = getattr(plan, "ctas", None)
    if ctas is None:                  # a version before the cluster form
        return "block" if plan.launches == 1 else "grid"
    return f"cluster of {ctas}" if ctas else "grid"


def _agrees(smoke, got, want) -> bool:
    import torch
    return (all(torch.equal(getattr(got, f), getattr(want, f))
                for f in smoke.ROUTE_EXACT)
            and max(smoke.max_err(getattr(got, f), getattr(want, f))
                    for f in ("topk_logits", "probs", "tae"))
            <= smoke.TOL_GATE)


def queued_us(fn, n: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn`` with the stream kept full: a spin
    kernel holds the card while the host queues ``n`` calls, which the card
    then runs back to back; CUDA events after the spin and after the last
    call, median of ``reps``. A two-launch form pays the device's gap
    between its kernels here, and no host time."""
    import statistics
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        spin, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(20_000_000)          # ~10 ms at the SM clock
        s.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        e.record()
        e.synchronize()
        if queued_ms >= spin.elapsed_time(s):
            raise RuntimeError("time_route: the host did not queue the "
                               "calls while the card spun")
        out.append(s.elapsed_time(e) * 1e3 / n)
    return statistics.median(out)


def _floor(smoke, call, one) -> dict:
    """``call`` and a one-element add_ in one profiler window: the kernel's
    device time and the add's, the launch floor."""
    by = smoke.device_us(lambda: (call(), one.add_(1.0)),
                         by_op=True).get("device_us_by_op") or {}
    return {"kernel_device_us": sum(v for k, v in by.items()
                                    if "elementwise" not in k),
            "floor_device_us": sum(v for k, v in by.items()
                                   if "elementwise" in k) or None}


def floor_rows(smoke, dev, route_call) -> dict:
    """The launch floor beside route (T = 4, 32, 256), topk_gate and
    buddy_substitute (T = 4, 256), as PERF.md's kernel table has them."""
    import torch
    from repro_torch.kernels.buddy_substitute import buddy_substitute_cuda
    from repro_torch.kernels.topk_gate import topk_gate_cuda
    gen = torch.Generator().manual_seed(2)
    one = torch.zeros(1, device=dev)
    e_n, k_n, r_n = 64, 6, 8
    out = {f"route_T{t}": _floor(smoke, route_call[t], one)
           for t in (4, 32, 256)}
    for t_n in (4, 256):
        z = torch.randn(t_n, e_n, generator=gen).to(dev)
        out[f"topk_gate_T{t_n}"] = _floor(
            smoke, lambda: topk_gate_cuda(z, 0.2, k=k_n), one)
        s = smoke._route_slots(gen, t_n, e_n, k_n, dev)
        gate = (torch.rand(t_n, generator=gen) < 0.8).to(dev)
        resident = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
        table, q = smoke._buddy_tables(gen, e_n, r_n, dev)
        out[f"buddy_substitute_T{t_n}"] = _floor(
            smoke, lambda: buddy_substitute_cuda(s, gate, resident, table, q,
                                                 h=8, rho=3), one)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--policies", action="store_true")
    ap.add_argument("--floor", action="store_true")
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
    from repro_torch.kernels.route import launch_plan, route_cuda, route_plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    pgen = torch.Generator().manual_seed(1)
    e_n, k_n, r_n = 64, 6, 8
    rows, masks_call = {}, {}
    for t_n in T_SWEEP:
        z = torch.randn(t_n, e_n, generator=gen).to(dev)
        resident = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
        table, q = smoke._buddy_tables(gen, e_n, r_n, dev)
        masks = {m: (torch.rand(e_n, generator=gen) < 0.4).to(dev)
                 for m in ("quant_ok", "peer_ok")}
        cases = {"masks": {}}
        if args.policies:
            cases.update({name: smoke._route_policy(name, pgen, e_n, dev)
                          for name in smoke.ROUTE_POLICY_CASES})
        plan = launch_plan(t_n, k_n)
        for name, policy in cases.items():
            def call(fn=route_cuda, policy=policy, a=(z, 0.2, 1.1, resident,
                                                      table, q), m=masks):
                return fn(*a, k=k_n, h=8, rho=3, **m, **policy)
            rows[f"T{t_n}_{name}"] = {
                "form": _form(plan), "launches_per_call": plan.launches,
                "equal_to_plain": _agrees(smoke, call(),
                                          call(fn=route_plain)),
                "ms": smoke.time_ms(call, inner=10),
                "queued_us": queued_us(call),
                **smoke.device_us(call)}
            if name == "masks":
                masks_call[t_n] = call
    out = {"label": args.label, "src": args.src, "nvidia_smi": smi,
           "rows": rows}
    if args.floor:
        out["floor"] = floor_rows(smoke, dev, masks_call)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
