"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, without a CUDA card (or with fewer
cards than the cell asks for), without the program, or when JAX or the
JAX package was loaded. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (--trace 0: the cell's
end-to-end metrics; --trace 1: its per-layer metrics), device, with
--trace 1 breakdown, and last the compared numbers beside their limits,
which also close standard error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the port's nvcc builds go to build/kernels by itself)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=30)
    return float(out.stdout.strip().splitlines()[0])


def result_line(correct, attempted, failed, metrics, device, devtrace,
                compared, step_ms=None) -> dict:
    """The result object, its keys in order; ``devtrace`` (a traced
    run's ``devtrace.summarize``) adds busy_s / window_s to ``device`` and
    the breakdown, and ``step_ms`` the traced steps' device ms by the trace
    and by CUDA events; the compared numbers come last."""
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    if devtrace is not None:
        device["busy_s"] = devtrace["busy_s"]
        device["window_s"] = devtrace["window_s"]
        result["breakdown"] = {"device_ops": devtrace["device_ops"],
                               "idle_gaps": devtrace["idle_gaps"]}
    if step_ms is not None:
        result["step_ms"] = step_ms
    result["check"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    import numpy as np
    import torch
    from chipbench import bench, check
    cell = bench.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"chipbench: {cell['chips']} CUDA card(s) needed; "
              f"is_available={torch.cuda.is_available()} "
              f"count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = bench.Run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    t_process=T_PROCESS)
    run.build()
    run.serve()
    run.read_trace()
    which = "per_layer" if args.trace else "end_to_end"
    metrics = run.metrics(which)
    attempted, failed = run.attempted_failed()
    setup = {k: round(v, 4) for k, v in run.setup.items()}
    print(f"chipbench: setup {json.dumps(setup)} window_s "
          f"{run.t_close - run.t_open:.3f} steps {len(run.window_steps())} "
          f"metrics {json.dumps(metrics)}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    numbers = check.program_numbers(run)
    check_s = time.perf_counter() - t0
    correct, compared = check.judge(numbers, cell["cell"]["check"]["limits"])
    bad = forbidden_modules()
    if bad:
        print(f"chipbench: loaded {bad}: the run may not import JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "power_limit_w": power_limit_w()}
    if args.trace and not run.devtrace:
        print("chipbench: the traced run has no device trace",
              file=sys.stderr)
        return 4
    step_ms = None
    if args.trace:
        # the trace's device time per traced step beside CUDA events from
        # each step's entry to its _account (which also hold the device's
        # idle gaps inside the step)
        step_ms = {"trace": 1e3 * float(np.mean(
            run.devtrace["busy_by_step_s"])), "events": run.step_event_ms()}
        print(f"chipbench: traced step ms {json.dumps(step_ms)}",
              file=sys.stderr)
    result = result_line(correct, attempted, failed, metrics, device,
                         run.devtrace if args.trace else None, compared,
                         step_ms)
    print(f"chipbench: check_s {check_s:.3f}", file=sys.stderr)
    print(json.dumps(result))
    for name, (value, limit) in compared.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
