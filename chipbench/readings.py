"""The readings that the limits of ``correct`` are set from: for each seed,
one run of the cell at its own size and load (the window of
``--seconds``), the compared numbers of the program, and on the first
``--control`` seeds those of the control (the reference in TF32 in the
program's place). All seeds in one process, one after the other, each
with its own weights.

    python3 chipbench/readings.py --workload <cell> --seeds 11,12,13 \
        --seconds 51 --control 3 --out readings.jsonl

One JSON line per seed to ``--out`` and to standard output: seed, the
program's numbers, the control's, the end-to-end metrics and set-up.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from chipbench import bench, check
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload, ROOT)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        run = bench.Run(cell, seed, args.seconds, False, "cuda")
        run.build()
        run.serve()
        row = {"workload": args.workload, "seed": seed,
               "metrics": run.metrics("end_to_end"),
               "setup": run.setup,
               "memory_peak_bytes": run.memory_peak_bytes}
        t0 = time.perf_counter()
        row["program"] = check.program_numbers(run)
        row["check_s"] = time.perf_counter() - t0
        if i < args.control:
            t0 = time.perf_counter()
            row["control"] = check.control_numbers(run)
            row["control_s"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
