#!/usr/bin/env python3
"""Where a decode step (or a chunked-prefill step) of the PyTorch/CUDA port
spends its time on the card.

    PYTHONPATH=src python tools/profile_torch_decode.py [--layers 8] [--steps 6] \
        [--quant-tier int8] [--prefill-chunk 128] [--paged-kv [--prefix-cache]]
    # Mixtral-8x7B's decode step (the capacity branch at batch 4)
    PYTHONPATH=src python tools/profile_torch_decode.py --arch mixtral-8x7b \
        --layers 4

Builds the same engine as chip_smoke.py's serve phase (--arch, by default
deepseek-v2-lite-buddy, at full width, cut to --layers layers, random
weights from seed 0, buddy profiling, cache-rate 0.5, prev-step predictor),
warms it up, then for the fused and the unfused dispatch (the gather
branch at batch 4 when 4 x top-k < experts, as in DeepSeek, else the
capacity branch, as in Mixtral) times --steps decode steps with the
program's host spans on (``runtime.trace``, docs/trace_schema.md "host")
three ways: wall clock (synchronized), host ms per span (the issue, the
wait for the device, the timeline replay of ``ServeEngine._account``,
...), and torch.profiler's device time per kernel and per span; beside
them the rows expert_ffn computed of those it was given over the timed
steps (``kernels.ops.expert_ffn_rows``, read after the steps).
With --quant-tier the engines carry the replica tier at coverage 0.5
(chip_smoke.py's tier path: 15 full slots and 32 replicas per layer at
full width), so degraded slots run through the grouped kernel's int8 half (fused)
or quant_ffn (gather). With --prefill-chunk C > 1 the timed steps are
``ServeEngine.prefill_rows`` chunk steps of 4 rows x C prompt tokens (the
continuous scheduler's fused step while every slot prefills), and the
unfused dispatch is the dropless capacity branch (expert_ffn). With
--paged-kv the engines keep their KV in a block pool (16-token blocks), and
the device time of the page gathers and of the copy-on-write copies is
reported by name (the ``model.paged_gather`` and ``engine.kv_cow_copy``
spans). With
--prefix-cache as well, every timed step is a prefix hit's first step: the
four rows are freed, each adopts the first 60 tokens (not a multiple of the
block) of a prompt another row donated, and the step writes at position 60,
so each row copies the shared tail block; the host's admission work (free,
match, adopt) is inside the step's wall time. Prints one JSON object per
dispatch and, with --out, writes them to a file.
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


HIT = 60                                     # adopted tokens per prefix hit


def profile_dispatch(serve, params, layers: int, steps: int, fused: bool,
                     tier_flags=(), chunk: int = 1, kv_flags=(),
                     arch: str = "deepseek-v2-lite-buddy"):
    flags = ["--arch", arch, "--layers", str(layers), "--cache-rate", "0.5", "--policy",
             "buddy", "--predictor", "prev-step", "--batch", "4"]
    eng, lm = serve.build_engine(
        serve.parse_args(flags + list(tier_flags) + list(kv_flags)
                         + (["--fused-dispatch"] if fused else [])),
        params=params)
    hits = "--prefix-cache" in kv_flags
    return _profile(eng, lm, steps, fused, tier_flags, chunk, kv_flags,
                    layers, hits)


def _host_ms(host, steps) -> dict:
    """Host ms per step by span name (``HostRecorder.table``)."""
    return {k: row["total_ms"] / steps for k, row in host.table().items()}


def _profile(eng, lm, steps, fused, tier_flags, chunk, kv_flags, layers,
             hits):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.runtime import trace
    n_tok = 2 * steps * chunk + 4 + (HIT + chunk if hits else 0)
    prompts = lm.sample(4, n_tok)
    caches = eng.init_caches(4, n_tok)
    tok = eng._tokens(prompts[:, 0])
    for pos in range(3):                           # warm-up
        _, caches = eng.step(tok, caches, pos)
        tok = eng._tokens(prompts[:, pos + 1])
    if hits:
        # row 0 prefills and donates 64 tokens; the others share its first
        # HIT and go on with their own
        caches = eng.reset_rows(caches, range(4))
        donor = prompts[0, :HIT + 4].copy()
        for p in range(0, HIT + 4, 16):
            eng.prefill_rows(np.tile(donor[p:p + 16], (4, 1)),
                             np.arange(4) == 0, caches,
                             base_pos=np.full(4, p))
        eng.insert_prefix(0, donor)
        prompts[:, :HIT] = donor[:HIT]
        prompts[:, HIT] = (donor[HIT] + 1 + np.arange(4)) % eng.cfg.vocab_size
    torch.cuda.synchronize()

    def hit_step():
        """Admit four rows with a prefix hit and take their first step."""
        eng.reset_rows(caches, range(4))
        assert all(eng.adopt_prefix(r, prompts[r]) == HIT for r in range(4))
        if chunk == 1:
            return eng.step(eng._tokens(prompts[:, HIT]), caches,
                            np.full(4, HIT))
        return eng.prefill_rows(prompts[:, HIT:HIT + chunk],
                                np.ones(4, bool), caches,
                                base_pos=np.full(4, HIT))

    def run(first):
        """--steps steps from position ``first`` with the host spans on:
        (wall s, the spans' recorder)."""
        nonlocal tok, caches
        host = trace.start_host()
        try:
            t0 = time.perf_counter()
            for pos in range(first, first + steps * chunk, chunk):
                if hits:
                    logits, caches = hit_step()
                    eng.sample_tokens(
                        logits if chunk == 1 else logits[:, -1], True)
                elif chunk == 1:
                    logits, caches = eng.step(tok, caches, pos)
                    tok = eng._tokens(eng.sample_tokens(logits, True))
                else:
                    logits, caches = eng.prefill_rows(
                        prompts[:, pos:pos + chunk], np.ones(4, bool),
                        caches, base_pos=np.full(4, pos))
                    eng.sample_tokens(logits[:, -1], True)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, host
        finally:
            trace.stop_host()

    rows0 = ops.expert_ffn_rows()
    wall, host = run(3)                            # without the profiler
    ffn_rows = {k: v - rows0[k] for k, v in ops.expert_ffn_rows().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = run(3 + steps * chunk)
    # device-side kernel and copy events only: the CPU-side aten ops that
    # launched them carry the same device time again
    # a span's kernels' device time is its CPU-side range's total (the
    # per-layer ranges "model.attn[3]" summed by span name); the
    # device-side annotation of the same name spans the launch gaps
    # between those kernels too, so it is not used
    named = {}
    for e in prof.key_averages():
        name = e.key.split("[")[0]
        if name in trace.SPAN_NAMES:
            us, n = named.get(name, (0.0, 0))
            if e.device_type == DeviceType.CPU:
                named[name] = (us + float(getattr(
                    e, "device_time_total", getattr(e, "cuda_time_total",
                                                    0.0))), n + e.count)
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and e.key.split("[")[0] not in trace.SPAN_NAMES]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    moe = eng.cfg.moe
    return {
        "dispatch": "fused" if fused else (
            "gather" if chunk == 1 and 4 * moe.top_k < moe.num_experts
            else "capacity"),
        "arch": eng.cfg.arch_id, "layers": layers, "steps": steps, "chunk_tokens": 4 * chunk,
        "tier": " ".join(tier_flags) or "off",
        "kv": ("paged, prefix hit steps" if hits else
               "paged" if kv_flags else "ring"),
        "named_ranges": {k: {"device_ms_per_step": us / steps / 1e3,
                             "calls_per_step": n / steps}
                         for k, (us, n) in sorted(named.items())},
        "cow_copies": (eng.kv_pool.cow_copies if eng.kv_pool is not None
                       else 0),
        "degraded_slots_all_steps": (eng.tier.degraded_tokens
                                     if eng.tier is not None else 0),
        "expert_ffn_rows": {**ffn_rows, "computed_over_given": (
            ffn_rows["computed"] / ffn_rows["given"] if ffn_rows["given"]
            else None)},
        "wall_ms_per_step": wall / steps * 1e3,
        "host_account_ms_per_step": sum(
            _host_ms(host, steps).get(k, 0.0)
            for k in ("engine.wait", "engine.replay")),
        "host_ms_per_step": _host_ms(host, steps),
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
    ap.add_argument("--arch", default="deepseek-v2-lite-buddy",
                    help="a MoE arch id of repro_torch.configs")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--quant-tier", choices=["off", "int8", "int4"],
                    default="off")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="> 1: time chunk steps of 4 rows x this many "
                         "prompt tokens instead of decode steps")
    ap.add_argument("--paged-kv", action="store_true",
                    help="KV in a block pool of 16-token blocks")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="with --paged-kv: time prefix hits' first steps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.prefix_cache and not args.paged_kv:
        ap.error("--prefix-cache requires --paged-kv")
    tier_flags = () if args.quant_tier == "off" else (
        "--quant-tier", args.quant_tier, "--tier-coverage", "0.5")
    kv_flags = (["--paged-kv", "--kv-block", "16"] if args.paged_kv else []) \
        + (["--prefix-cache"] if args.prefix_cache else [])
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = serve.model_config(serve.parse_args(["--arch", args.arch,
                                               "--layers",
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
                               tier_flags, args.prefill_chunk, kv_flags,
                               args.arch)
        print(json.dumps(res), flush=True)
        out["results"].append(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
