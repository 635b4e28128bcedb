"""Serving launcher — BuddyMoE engine over a random or loaded checkpoint, on
the card by default.

    # static one-shot batch (the paper's harness), on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-buddy --reduced --cache-rate 0.5 \
        --policy buddy --steps 64

    # the same on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

    # with the int8 replica tier covering the top half of each layer
    PYTHONPATH=src python -m repro_torch.launch.serve --layers 8 \
        --quant-tier int8 --tier-coverage 0.5 --fused-dispatch

    # the unified expected-cost miss policy (upgrades degraded slots)
    PYTHONPATH=src python -m repro_torch.launch.serve --layers 8 \
        --miss-policy cost --quant-tier int8 --tier-coverage 0.5

    # continuous batching under Poisson load, joining prompts ingested 8
    # tokens per fused step (chunked prefill)
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --mode continuous --num-requests 16 --slots 4 \
        --prefill-chunk 8

    # workload replay: arrivals and per-request token budgets from a JSONL
    # trace of {t_arrival, prompt_len, max_new_tokens} rows
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --mode continuous --trace trace.jsonl --slots 4

Counterpart of ``repro/launch/serve.py`` for batch and continuous mode,
quant tier included. Flags of the subsystems that are not ported yet (the
mesh, paged KV and the prefix cache, live placement, telemetry and the
trace export) stop with "not ported yet".
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.checkpoint.io import load_npz
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.core.buddies import build_buddy_lists
from repro_torch.core.coactivation import CoactivationRecorder
from repro_torch.core.policy import BuddyPolicy
from repro_torch.core.quantize import TIER_BITS
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.runtime.cache import ExpertCache
from repro_torch.runtime.prefetch import (AdaptiveBudgetController,
                                          CrossLayerPredictor,
                                          PrevStepPredictor, TopFreqPredictor)
from repro_torch.runtime.tiers import TieredExpertStore
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import (BurstyArrivals,
                                           ContinuousScheduler,
                                           PoissonArrivals, RequestQueue,
                                           SLOConfig, make_requests,
                                           requests_from_trace)
from repro_torch.training.data import MarkovLM

PREDICTORS = {
    "prev-step": PrevStepPredictor,
    "top-freq": TopFreqPredictor,
    "cross-layer": CrossLayerPredictor,
}


def profile_buddies(cfg, params, lm, *, steps: int = 4, batch: int = 4,
                    seq: int = 64, alpha: float = 0.9, k_max: int = 8):
    """Offline phase: router traces -> co-activation -> CFT buddy lists."""
    n_moe = sum(r for k, r in cfg.stack() if k == "attn_moe")
    rec = CoactivationRecorder(n_moe, cfg.moe.num_experts)
    dev = params["embed"].device
    for _ in range(steps):
        toks = torch.as_tensor(lm.sample(batch, seq), dtype=torch.int64) \
            .to(dev)
        _, aux = transformer.forward_train(params, cfg, toks, record=True)
        per = aux["recorded"][0]
        idx = per["indices"].cpu().numpy()
        probs = per["probs"].cpu().numpy()
        for l in range(n_moe):
            rec.update(l, idx[l], probs[l])
        rec.step_done()
    q = np.stack([rec.conditional(l) for l in range(n_moe)])
    return build_buddy_lists(q, alpha=alpha, k_max=k_max, activity=rec.A), rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-buddy")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep only the first N layers (0: all) — the full "
                         "widths with less depth, for a quick run")
    ap.add_argument("--checkpoint", default=None,
                    help="npz in the reference's save_pytree key scheme")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--cache-rate", type=float, default=0.5)
    ap.add_argument("--policy", choices=["buddy", "random", "none"],
                    default="buddy")
    ap.add_argument("--tau", type=float, default=0.2)
    ap.add_argument("--beta", type=float, default=0.8)
    ap.add_argument("--rho", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=0.9)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--predictor", choices=sorted(PREDICTORS),
                    default="prev-step")
    ap.add_argument("--prefetch-k", type=int, default=-1,
                    help="-1: half the cache capacity")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="issue layer l+k prefetches while layer l computes")
    ap.add_argument("--miss-policy", choices=["precedence", "cost"],
                    default="precedence",
                    help="'precedence': fixed buddy->degraded->fetch/drop "
                         "chain; 'cost': per-slot argmin of the unified "
                         "expected-cost model (buddy Psi loss, replica "
                         "fidelity, fetch ETA, drop loss on one "
                         "stall-seconds scale); both run in the route "
                         "kernel on the card")
    ap.add_argument("--stall-per-quality", type=float, default=0.05)
    ap.add_argument("--drop-loss", type=float, default=1.0)
    ap.add_argument("--prefetch-min-saving", type=float, default=-1.0)
    ap.add_argument("--fused-dispatch", action="store_true",
                    help="single-dispatch hot path: every slot in ONE "
                         "grouped expert launch (kernels/grouped_ffn.py)")
    # -- tiered expert store (compressed resident replicas) -------------
    ap.add_argument("--quant-tier", choices=["off", "int8", "int4"],
                    default="off",
                    help="keep a low-precision replica of the experts "
                         "resident so a buddy-less miss computes degraded "
                         "instead of stalling; the tier displaces full-"
                         "precision cache slots from the --cache-rate budget")
    ap.add_argument("--tier-stall-per-fidelity", type=float, default=0.05,
                    help="seconds of expected stall that justify one unit "
                         "of relative quantization error (precedence mode)")
    ap.add_argument("--tier-coverage", type=float, default=1.0,
                    help="fraction of experts per layer holding a resident "
                         "replica (top-P(use) from the profiling activity); "
                         "the freed bytes become full cache slots")
    ap.add_argument("--upgrade-degraded", choices=["auto", "on", "off"],
                    default="auto",
                    help="background-fetch the true expert after serving "
                         "its slot from the quant tier (auto: on exactly "
                         "with --miss-policy cost and a tier)")
    # -- continuous serving under load ---------------------------------
    ap.add_argument("--mode", choices=["batch", "continuous"],
                    default="batch")
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous batch width)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="requests per SIMULATED second (0: sized to ~70%% "
                         "of MEASURED decode capacity, stalls included)")
    ap.add_argument("--arrivals", choices=["poisson", "bursty"],
                    default="poisson")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="TTFT objective in modeled ms (0: disabled)")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help="per-token objective in modeled ms (0: disabled)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="end-to-end deadline; with --admission slo, doomed "
                         "requests are shed instead of admitted")
    ap.add_argument("--admission", choices=["fcfs", "slo"], default="fcfs")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt tokens ingested per fused step when a "
                         "request joins (1: token-by-token through decode)")
    ap.add_argument("--adaptive-chunk", action="store_true",
                    help="halve the prefill chunk while the estimated "
                         "step time would blow co-resident decode rows' "
                         "TPOT budget")
    ap.add_argument("--adaptive-prefetch", action="store_true",
                    help="resize prefetch budget from queue depth + stall "
                         "attribution instead of the fixed --prefetch-k")
    ap.add_argument("--trace", default=None,
                    help="JSONL serving trace ({t_arrival, prompt_len, "
                         "max_new_tokens} rows) replayed with per-request "
                         "token budgets (--mode continuous)")
    # subsystems that are not ported yet: present so that they fail loudly
    ap.add_argument("--n-devices", type=int, default=1)
    ap.add_argument("--paged-kv", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--placement", choices=["off", "live"], default="off")
    ap.add_argument("--telemetry", choices=["off", "on"], default="off")
    ap.add_argument("--trace-out", default=None)
    args = ap.parse_args(argv)
    for flag, on in (("--n-devices > 1", args.n_devices != 1),
                     ("--paged-kv", args.paged_kv),
                     ("--prefix-cache", args.prefix_cache),
                     ("--placement live", args.placement != "off"),
                     ("--telemetry", args.telemetry != "off"),
                     ("--trace-out", args.trace_out is not None)):
        if on:
            ap.error(f"{flag}: not ported yet")
    if args.lookahead < 1:
        ap.error("--lookahead must be >= 1 (layers ahead to prefetch)")
    if args.prefill_chunk < 1:
        ap.error("--prefill-chunk must be >= 1 (prompt tokens per fused step)")
    if args.trace and args.mode != "continuous":
        ap.error("--trace replays a request stream: use --mode continuous")
    if args.layers < 0:
        ap.error("--layers must be >= 0")
    if not 0.0 < args.tier_coverage <= 1.0:
        ap.error("--tier-coverage must be in (0, 1]")
    return args


def model_config(args):
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if not cfg.is_moe:
        raise ValueError("the serving engine targets MoE archs")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def build_engine(args, params=None):
    """Weights (loaded, given, or random from seed 0), buddy profiling and
    the engine. Returns (engine, MarkovLM)."""
    dev = resolve_device(args.device)
    cfg = model_config(args)
    if params is None and args.checkpoint:
        params = load_npz(args.checkpoint, dev)
    elif params is None:
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lm = MarkovLM(cfg.vocab_size, seed=0)
    tables, rec = profile_buddies(cfg, params, lm, alpha=args.alpha)
    n_moe = sum(r for k, r in cfg.stack() if k == "attn_moe")
    policy = BuddyPolicy(tau=args.tau, beta=args.beta, rho=args.rho,
                         mode=args.policy, quant_tier=args.quant_tier,
                         miss_policy=args.miss_policy,
                         stall_per_quality=args.stall_per_quality,
                         drop_loss=args.drop_loss,
                         use_fused_dispatch=args.fused_dispatch)
    tier = None
    if args.quant_tier != "off":
        tier = TieredExpertStore(
            n_moe, cfg.moe.num_experts, args.cache_rate,
            bits=TIER_BITS[args.quant_tier], d_model=cfg.d_model,
            d_ff=cfg.moe.d_ff,
            stall_per_fidelity=args.tier_stall_per_fidelity,
            coverage=args.tier_coverage)
        if args.tier_coverage < 1.0:
            # partial coverage: replicate the top-P(use) experts per layer,
            # ranked by the profiling run's activation counts
            tier.set_coverage(rec.A)
        cache = tier.cache
    else:
        cache = ExpertCache(n_moe, cfg.moe.num_experts, args.cache_rate)
    prefetch_k = (max(1, cache.capacity // 2) if args.prefetch_k < 0
                  else args.prefetch_k)
    predictor = PREDICTORS[args.predictor](n_moe, cfg.moe.num_experts)
    upgrade = {"auto": None, "on": True, "off": False}[args.upgrade_degraded]
    eng = ServeEngine(cfg, params, tables=tables, policy=policy,
                      cache=None if tier is not None else cache, tier=tier,
                      upgrade_degraded=upgrade,
                      predictor=predictor, prefetch_k=prefetch_k,
                      lookahead=args.lookahead,
                      prefetch_min_saving=(None if args.prefetch_min_saving
                                           < 0 else args.prefetch_min_saving))
    return eng, lm


def continuous_requests(args, eng, lm) -> list:
    """The request stream of --mode continuous: a replayed --trace, or
    --num-requests prompts of 4-8 tokens at --arrival-rate (0: ~70% of the
    capacity an unloaded probe batch measures on the simulated clock, after
    which the engine's runtime state is reset)."""
    slo = SLOConfig(
        ttft_s=args.slo_ttft_ms * 1e-3 if args.slo_ttft_ms > 0 else None,
        tpot_s=args.slo_tpot_ms * 1e-3 if args.slo_tpot_ms > 0 else None,
        deadline_s=args.deadline_ms * 1e-3 if args.deadline_ms > 0 else None)
    if args.trace:
        reqs = requests_from_trace(args.trace,
                                   lambda n: lm.sample(1, max(1, n))[0], slo)
        print(f"[serve] replaying {len(reqs)} requests from {args.trace}")
        return reqs
    rng = np.random.default_rng(1)
    prompts = [lm.sample(1, int(rng.integers(4, 9)))[0]
               for _ in range(args.num_requests)]
    rate = args.arrival_rate
    if rate <= 0:
        # the probe's step time includes transfer stalls (a compute-only
        # estimate is far too optimistic in the transfer-bound regime)
        eng.generate(lm.sample(args.slots, 4), max_new_tokens=8)
        step_s = eng.stats.sim_time_s / max(1, eng.stats.steps)
        eng.reset_runtime()
        rate = 0.7 * args.slots / ((8 + args.steps) * step_s)
        print(f"[serve] auto arrival rate: {rate:.1f} req/s "
              f"(measured step {step_s*1e3:.3f}ms)")
    proc = (PoissonArrivals(rate, seed=2) if args.arrivals == "poisson"
            else BurstyArrivals(rate, seed=2))
    return make_requests(prompts, proc, args.steps, slo)


def serve_continuous(args, eng, lm) -> dict:
    """Drive the engine with continuously arriving requests and SLOs
    through the ContinuousScheduler; returns its summary."""
    queue = RequestQueue(continuous_requests(args, eng, lm),
                         admission=args.admission)
    ctrl = None
    if args.adaptive_prefetch and eng.prefetch_k > 0:
        k = eng.prefetch_k
        ctrl = AdaptiveBudgetController(
            prefetch_k=k, lookahead=args.lookahead, max_k=max(2 * k, 4),
            max_lookahead=max(4, args.lookahead))
    sched = ContinuousScheduler(eng, slots=args.slots, controller=ctrl,
                                prefill_chunk=args.prefill_chunk,
                                adaptive_chunk=args.adaptive_chunk)
    return sched.run(queue)


def main(argv=None, params=None) -> dict:
    """Serve a batch (--mode batch) or a request stream (--mode continuous)
    and print the summary, which it returns. ``params``: weights already on
    the device (default: --checkpoint, or random from seed 0)."""
    args = parse_args(argv)
    eng, lm = build_engine(args, params=params)
    if args.mode == "continuous":
        s = serve_continuous(args, eng, lm)
        print(json.dumps(s, indent=1, default=str))
        print(f"completed {s['completed']}/{s['num_requests']} "
              f"(rejected {s['rejected']})  "
              f"TTFT p50/p99 {s['ttft_s']['p50']*1e3:.2f}/"
              f"{s['ttft_s']['p99']*1e3:.2f}ms  "
              f"goodput {s['goodput_rps']:.1f} req/s  "
              f"SLO-met {s['slo_met_frac']*100:.0f}%")
        return s
    out = eng.generate(lm.sample(args.batch, 8), max_new_tokens=args.steps)
    s = eng.summary()
    print(json.dumps(s, indent=1, default=str))
    bd = s["stall_breakdown"]
    print(f"stalls: demand {bd['demand_stall_s']*1e3:.2f}ms  "
          f"late-prefetch {bd['late_prefetch_stall_s']*1e3:.2f}ms  "
          f"overlapped {bd['overlapped_s']*1e3:.2f}ms")
    if "tier" in s:
        t = s["tier"]
        print(f"tier: {t['degraded_tokens']} degraded slots at "
              f"{t['bits']}-bit, {t['quant_bytes']/1e6:.1f}MB resident, "
              f"{t['tier_budget_split']['cache_slots_per_layer']} full "
              f"slots/layer left")
    print("sample output tokens:", out[0, -16:].tolist())
    return s


if __name__ == "__main__":
    main()
