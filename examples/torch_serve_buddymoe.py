"""Serving example on the PyTorch/CUDA port: batched requests through the
BuddyMoE engine at a configurable cache rate, with the request/batcher
plumbing.

The twin of examples/serve_buddymoe.py. It serves the committed trained
model (results/bench/model.npz, the profiling config: 64 experts, top-6)
with its committed buddy tables (tables_a0.95_k16.npz) and co-activation
profile (coact.npz, which ranks the tier's covered experts), where the
JAX example trains or loads them through benchmarks/common.py.

Run:  PYTHONPATH=src python examples/torch_serve_buddymoe.py --cache-rate 0.5
      PYTHONPATH=src python examples/torch_serve_buddymoe.py --continuous \\
          --arrival-rate 400 --prefill-chunk 8
      PYTHONPATH=src python examples/torch_serve_buddymoe.py --device cpu \\
          --quant-tier int8 --tier-coverage 0.5 --miss-policy cost
      PYTHONPATH=src python examples/torch_serve_buddymoe.py --n-devices 4
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np

from repro_torch.checkpoint.io import load_npz
from repro_torch.configs.deepseek_v2_lite_buddy import profiling
from repro_torch.core.buddies import load_tables
from repro_torch.core.coactivation import CoactivationRecorder
from repro_torch.core.policy import BuddyPolicy
from repro_torch.models.common import resolve_device
from repro_torch.runtime.cache import ExpertCache
from repro_torch.runtime.prefetch import PrevStepPredictor
from repro_torch.runtime.tiers import TIER_BITS, TieredExpertStore
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.requests import Request, StaticBatcher
from repro_torch.serving.scheduler import (ContinuousScheduler,
                                           PoissonArrivals, RequestQueue,
                                           SLOConfig, make_requests)
from repro_torch.training.data import MarkovLM

BENCH = os.path.join(ROOT, "results", "bench")


def build_engine(args):
    cfg = profiling()
    params = load_npz(os.path.join(BENCH, "model.npz"),
                      resolve_device(args.device))
    tables = load_tables(os.path.join(BENCH, "tables_a0.95_k16.npz"))
    kw = dict(quant_tier=args.quant_tier, miss_policy=args.miss_policy,
              stall_per_quality=args.stall_per_quality)
    policy = (BuddyPolicy(tau=0.1, beta=0.9, rho=3, H=8, **kw)
              if args.policy == "buddy" else BuddyPolicy(mode="none", **kw))
    n, e = cfg.num_layers, cfg.moe.num_experts
    tier, cache = None, None
    if args.quant_tier != "off":
        # int8/int4 replicas of the covered experts stay resident; the
        # leftover budget becomes full-precision cache slots
        tier = TieredExpertStore(n, e, args.cache_rate,
                                 bits=TIER_BITS[args.quant_tier],
                                 d_model=cfg.d_model, d_ff=cfg.moe.d_ff,
                                 seed=0, coverage=args.tier_coverage)
        if args.tier_coverage < 1.0:
            # top-P(use) experts per layer from the profiling activity
            rec = CoactivationRecorder.load(os.path.join(BENCH, "coact.npz"))
            tier.set_coverage(rec.A)
    else:
        cache = ExpertCache(n, e, args.cache_rate, seed=0)
    eng = ServeEngine(cfg, params, tables=tables, policy=policy, cache=cache,
                      tier=tier, predictor=PrevStepPredictor(n, e),
                      prefetch_k=args.prefetch, lookahead=args.lookahead,
                      seed=0, n_devices=args.n_devices,
                      paged_kv=args.paged_kv, kv_block=args.kv_block,
                      prefix_cache=args.prefix_cache)
    return cfg, MarkovLM(cfg.vocab_size, num_blocks=8, seed=0), eng


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--cache-rate", type=float, default=0.5)
    ap.add_argument("--policy", choices=["buddy", "none"], default="buddy")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prefetch", type=int, default=8)
    ap.add_argument("--lookahead", type=int, default=1,
                    help="prefetch depth: issue layer l+k while l computes")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a Poisson arrival stream with continuous "
                         "batching instead of static batches")
    ap.add_argument("--arrival-rate", type=float, default=300.0,
                    help="requests per simulated second (--continuous)")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt tokens per fused step when a request joins "
                         "(--continuous; 1 = token-by-token)")
    ap.add_argument("--quant-tier", choices=["off", "int8", "int4"],
                    default="off",
                    help="resident compressed replicas: a buddy-less miss "
                         "computes degraded instead of stalling on PCIe")
    ap.add_argument("--tier-coverage", type=float, default=1.0,
                    help="fraction of experts per layer with a replica")
    ap.add_argument("--miss-policy", choices=["precedence", "cost"],
                    default="precedence")
    ap.add_argument("--stall-per-quality", type=float, default=0.05)
    ap.add_argument("--n-devices", type=int, default=1,
                    help="expert-parallel mesh size (1-8)")
    ap.add_argument("--paged-kv", action="store_true")
    ap.add_argument("--kv-block", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix cache (requires --paged-kv)")
    args = ap.parse_args()
    if args.prefix_cache and not args.paged_kv:
        ap.error("--prefix-cache requires --paged-kv")

    cfg, lm, eng = build_engine(args)
    rng = np.random.default_rng(0)
    prompts = [lm.sample(1, int(rng.integers(4, 9)))[0]
               for _ in range(args.num_requests)]
    if args.continuous:
        reqs = make_requests(prompts, PoissonArrivals(args.arrival_rate,
                                                      seed=1),
                             args.max_new, SLOConfig(ttft_s=20e-3,
                                                     tpot_s=5e-3))
        s = ContinuousScheduler(eng, slots=args.batch_size,
                                prefill_chunk=args.prefill_chunk).run(
            RequestQueue(reqs))
        print(f"\ncontinuous: {s['completed']}/{s['num_requests']} done, "
              f"{s['steps']} steps (prefill chunk {args.prefill_chunk}), "
              f"mean occupancy {s['mean_occupancy']:.2f}/{args.batch_size}")
        print(f"TTFT p50/p95/p99: {s['ttft_s']['p50']*1e3:.2f}/"
              f"{s['ttft_s']['p95']*1e3:.2f}/{s['ttft_s']['p99']*1e3:.2f}ms"
              f"  goodput {s['goodput_rps']:.1f} req/s, SLO-met "
              f"{s['slo_met_frac']*100:.0f}% (simulated clock)")
        s = s["engine"]
    else:
        requests = [Request(rid=i, prompt=p, max_new_tokens=args.max_new)
                    for i, p in enumerate(prompts)]
        done = 0
        for chunk, mat, mask in StaticBatcher(args.batch_size).batches(
                requests):
            out = eng.generate(mat, max_new_tokens=args.max_new,
                               row_mask=mask)
            for i, r in enumerate(chunk):
                if r.rid >= 0:
                    r.output = out[i]
                    done += 1
            print(f"batch done ({done}/{args.num_requests} requests)")
        s = eng.summary()
        print(f"\npolicy={args.policy} cache_rate={args.cache_rate}")
        print(f"tokens/s (simulated clock, pad rows excluded): "
              f"{s['tokens_per_s']:.1f}")
    st = s["stats"]
    print(f"substitutions: {st['n_sub']}  sync fetches: "
          f"{st['n_miss_fetch']}  late prefetches: {st['n_late_prefetch']}"
          + (f"  degraded: {s['tier']['degraded_tokens']}"
             if "tier" in s else ""))
    print(f"PCIe bytes: {s['ledger']['total_bytes']/1e6:.1f}MB  "
          f"stall: {s['ledger']['sync_stall_s']*1e3:.1f}ms")
    bd = s["stall_breakdown"]
    print(f"stall breakdown: demand {bd['demand_stall_s']*1e3:.1f}ms  "
          f"late-prefetch {bd['late_prefetch_stall_s']*1e3:.1f}ms  "
          f"overlapped {bd['overlapped_s']*1e3:.1f}ms"
          + (f"  peer {bd['peer_stall_s']*1e3:.1f}ms"
             if "peer_stall_s" in bd else ""))
    if "mesh" in s:
        m = s["mesh"]
        print(f"mesh: {m['n_devices']} devices, {m['n_peer_borrow']} "
              f"peer borrows ({m['peer_share']*100:.1f}% of served slots)")


if __name__ == "__main__":
    main()
