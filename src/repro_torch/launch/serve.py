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

    # paged KV in blocks of 16 tokens, with the radix prefix cache
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --mode continuous --paged-kv --kv-block 16 \
        --prefix-cache --prefill-chunk 8

    # expert-parallel mesh: experts sharded across 4 simulated devices; a
    # miss on a peer-held expert borrows it over ICI
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --n-devices 4 --steps 8

    # flight recorder: metrics and calibration in the summary, the event
    # log written as JSONL (any other suffix: Perfetto trace_event JSON)
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --mode continuous --telemetry on --trace-out t.jsonl

    # live placement: tier coverage and replicas follow live traffic
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --mode continuous --quant-tier int8 \
        --tier-coverage 0.5 --placement live --placement-interval-ms 1

Counterpart of ``repro/launch/serve.py``: batch and continuous mode, the
quant tier, paged KV and the prefix cache, the simulated mesh, live
placement, telemetry and the trace export (schema: docs/trace_schema.md).
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
from repro_torch.runtime import trace
from repro_torch.runtime.cache import ExpertCache
from repro_torch.runtime.placement import PlacementController
from repro_torch.runtime.prefetch import (AdaptiveBudgetController,
                                          CrossLayerPredictor,
                                          PrevStepPredictor, TopFreqPredictor)
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.tiers import TieredExpertStore
from repro_torch.runtime.trace import export_trace
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
    """Offline phase: router traces -> co-activation -> CFT buddy lists.
    Host spans: ``setup.profile_buddies`` and one ``setup.profile_forward``
    per forward, each with its counter ``tokens`` (the tokens profiled)."""
    n_moe = sum(r for k, r in cfg.stack() if k == "attn_moe")
    rec = CoactivationRecorder(n_moe, cfg.moe.num_experts)
    dev = params["embed"].device
    with trace.span("setup.profile_buddies") as sp:
        if sp is not None:
            sp.note("tokens", steps * batch * seq)
        for _ in range(steps):
            with trace.span("setup.profile_forward") as fp:
                if fp is not None:
                    fp.note("tokens", batch * seq)
                toks = torch.as_tensor(lm.sample(batch, seq),
                                       dtype=torch.int64).to(dev)
                _, aux = transformer.forward_train(params, cfg, toks,
                                                   record=True)
                per = aux["recorded"][0]
                idx = per["indices"].cpu().numpy()
                probs = per["probs"].cpu().numpy()
            for l in range(n_moe):
                rec.update(l, idx[l], probs[l])
            rec.step_done()
        q = np.stack([rec.conditional(l) for l in range(n_moe)])
        return build_buddy_lists(q, alpha=alpha, k_max=k_max,
                                 activity=rec.A), rec


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
    # -- paged KV + radix-tree prefix cache (runtime/paged_kv.py) --------
    ap.add_argument("--paged-kv", action="store_true",
                    help="block-pooled KV cache: rows map fixed-size blocks "
                         "through per-row tables (ref-counted, copy-on-"
                         "write); off = the ring layout")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="tokens per KV block (--paged-kv)")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pool size in blocks (0: exact ring-cache "
                         "footprint, so paged vs ring runs at equal memory)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix cache over the paged pool: "
                         "retiring requests donate their block chains; "
                         "admitted requests adopt the longest cached prefix "
                         "and prefill only the novel suffix (requires "
                         "--paged-kv)")
    # -- expert-parallel mesh (peer-HBM borrowing over ICI) --------------
    ap.add_argument("--n-devices", type=int, default=1,
                    help="simulated expert-parallel mesh size (1-8): "
                         "experts shard round-robin across devices; a miss "
                         "on an expert a peer holds borrows it over that "
                         "device's ICI link (the fifth miss outcome)")
    ap.add_argument("--ici-gbps", type=float, default=0.0,
                    help="per-ICI-link bandwidth in GB/s (0: hardware "
                         "model default)")
    ap.add_argument("--no-peer-borrow", action="store_true",
                    help="mesh ablation: shard experts but resolve misses "
                         "with the four single-device outcomes only")
    # -- live placement (runtime/placement.py) ---------------------------
    ap.add_argument("--placement", choices=["off", "live"], default="off",
                    help="live traffic->placement loop: every refresh "
                         "window of SIMULATED time, re-pick the quant "
                         "tier's covered experts from live activity EMAs, "
                         "background-replicate persistently-hot experts, "
                         "and on a mesh push hot experts to underloaded "
                         "peers")
    ap.add_argument("--placement-interval-ms", type=float, default=1.0,
                    help="simulated ms between placement ticks")
    ap.add_argument("--placement-hot-windows", type=int, default=3,
                    help="hysteresis: consecutive hot windows an expert "
                         "needs before it earns a replica")
    ap.add_argument("--placement-top-k", type=int, default=0,
                    help="experts per layer counted as hot each window "
                         "(0: half the cache capacity)")
    # -- observability (runtime/telemetry.py + runtime/trace.py) ---------
    ap.add_argument("--telemetry", choices=["off", "on"], default="off",
                    help="attach the flight recorder: metrics registry, "
                         "miss-cost calibration and prefetch meters in the "
                         "final summary; and the host spans (wall clock "
                         "of each step's parts, printed as a table)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the event log here after the run (implies "
                         "--telemetry on): '*.jsonl' = lossless JSONL, "
                         "anything else = Chrome/Perfetto trace_event JSON; "
                         "the host spans go beside it, '.host' before the "
                         "suffix")
    args = ap.parse_args(argv)
    if args.lookahead < 1:
        ap.error("--lookahead must be >= 1 (layers ahead to prefetch)")
    if args.prefill_chunk < 1:
        ap.error("--prefill-chunk must be >= 1 (prompt tokens per fused step)")
    if args.trace and args.mode != "continuous":
        ap.error("--trace replays a request stream: use --mode continuous")
    if not 1 <= args.n_devices <= 8:
        ap.error("--n-devices must be in 1..8")
    if args.layers < 0:
        ap.error("--layers must be >= 0")
    if not 0.0 < args.tier_coverage <= 1.0:
        ap.error("--tier-coverage must be in (0, 1]")
    if args.prefix_cache and not args.paged_kv:
        ap.error("--prefix-cache shares KV at block granularity: it "
                 "requires --paged-kv")
    if args.kv_block < 1 or args.kv_blocks < 0:
        ap.error("--kv-block must be >= 1 and --kv-blocks >= 0")
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
    tele = None
    if args.telemetry == "on" or args.trace_out:
        make = Telemetry.with_trace if args.trace_out else Telemetry
        tele = make(predictor_label=args.predictor, num_layers=n_moe,
                    num_experts=cfg.moe.num_experts)
    placement = None
    if args.placement == "live":
        placement = PlacementController(
            refresh_interval_s=args.placement_interval_ms * 1e-3,
            hot_windows=args.placement_hot_windows,
            hot_top_k=args.placement_top_k or None)
    eng = ServeEngine(cfg, params, tables=tables, policy=policy,
                      cache=None if tier is not None else cache, tier=tier,
                      upgrade_degraded=upgrade,
                      predictor=predictor, prefetch_k=prefetch_k,
                      lookahead=args.lookahead,
                      prefetch_min_saving=(None if args.prefetch_min_saving
                                           < 0 else args.prefetch_min_saving),
                      paged_kv=args.paged_kv, kv_block=args.kv_block,
                      kv_blocks=args.kv_blocks or None,
                      prefix_cache=args.prefix_cache,
                      telemetry=tele, n_devices=args.n_devices,
                      ici_gbps=args.ici_gbps if args.ici_gbps > 0 else None,
                      peer_borrow=not args.no_peer_borrow,
                      placement=placement)
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
    the device (default: --checkpoint, or random from seed 0). With
    --telemetry on (or --trace-out) the host spans are on from the engine's
    build to the end of serving."""
    args = parse_args(argv)
    spans = args.telemetry == "on" or bool(args.trace_out)
    host = trace.start_host() if spans else None
    try:
        eng, lm = build_engine(args, params=params)
        if args.mode == "continuous":
            s = serve_continuous(args, eng, lm)
        else:
            out = eng.generate(lm.sample(args.batch, 8),
                               max_new_tokens=args.steps)
            s = eng.summary()
    finally:
        if host is not None:
            trace.stop_host()
    if args.mode == "continuous":
        print(json.dumps(s, indent=1, default=str))
        print(f"completed {s['completed']}/{s['num_requests']} "
              f"(rejected {s['rejected']})  "
              f"TTFT p50/p99 {s['ttft_s']['p50']*1e3:.2f}/"
              f"{s['ttft_s']['p99']*1e3:.2f}ms  "
              f"goodput {s['goodput_rps']:.1f} req/s  "
              f"SLO-met {s['slo_met_frac']*100:.0f}%")
        report(s["engine"], eng, args.trace_out, host)
        return s
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
    report(s, eng, args.trace_out, host)
    return s


def report(s: dict, eng, trace_out=None, host=None) -> None:
    """The digests of an engine summary: paged KV, mesh, placement and
    telemetry (each only where its subsystem is on), then the trace
    export; ``host`` (a runtime.trace.HostRecorder) adds its table."""
    report_prefix(s)
    report_mesh(s)
    report_placement(s)
    report_telemetry(eng.telemetry, trace_out, host)


def report_mesh(s: dict) -> None:
    """Per-link digest of a mesh run (nothing at one device)."""
    if "mesh" not in s:
        return
    m = s["mesh"]
    print(f"[mesh] {m['n_devices']} devices, peer-borrow "
          f"{'on' if m['peer_borrow'] else 'off'}: "
          f"{m['n_peer_borrow']} borrows ({m['peer_share']*100:.1f}% of "
          f"served slots), peer stall {m['peer_stall_s']*1e3:.2f}ms")
    for link in m["links"]:
        by = ", ".join(f"{k} {v/1e6:.2f}MB"
                       for k, v in link["bytes_by_cause"].items())
        print(f"[mesh]   {link['name']}: busy {link['busy_s']*1e3:.2f}ms, "
              f"queue {link['queue_depth']}, {by or 'idle'}")


def report_placement(s: dict) -> None:
    """Live-placement digest (nothing without a controller)."""
    if "placement" not in s:
        return
    p = s["placement"]
    print(f"[placement] {p['n_ticks']} ticks every "
          f"{p['refresh_interval_s']*1e3:.2f}ms: "
          f"{p['coverage_repicks']} coverage re-picks, "
          f"{p['replicas_issued']} replicas issued "
          f"({p['active_replicas']} live, "
          f"{p['replicas_reclaimed']} reclaimed), "
          f"{p['peer_pushes']} peer pushes")


def report_telemetry(tele, trace_out, host=None) -> None:
    """One-line calibration and prefetch digest, the host spans' table
    (host ms per span name), then the --trace-out export (the full nested
    summary is already in the engine summary) and the host spans' beside
    it."""
    if tele is None:
        return
    parts = []
    for o, c in tele.calibration.summary().items():
        p = f"{o} n={c['n']}"
        if c["n"]:
            p += f" |resid| {c['residual_abs_mean_s']*1e3:.3f}ms"
        parts.append(p)
    print("[telemetry] calibration: " + "; ".join(parts))
    pf = tele.prefetch.summary()
    print(f"[telemetry] prefetch[{pf['predictor']}]: precision "
          f"{pf['precision']:.3f} recall {pf['recall']:.3f} issued "
          f"{pf['issued']} used-in-time {pf['used_in_time']} late "
          f"{pf['late']} expected-saved "
          f"{pf['expected_stall_saved_s']*1e3:.2f}ms")
    if host is not None:
        print("[host] span: count, total ms, mean ms")
        for name, row in host.table().items():
            print(f"[host]   {name}: {row['n']}, {row['total_ms']:.3f}, "
                  f"{row['mean_ms']:.4f}")
    if trace_out:
        n = export_trace(tele.trace, trace_out)
        kind = "JSONL" if trace_out.endswith(".jsonl") else "Perfetto"
        print(f"[telemetry] wrote {n} {kind} trace events to {trace_out}")
        if host is not None:
            path = host_trace_path(trace_out)
            n = export_trace(host, path)
            print(f"[telemetry] wrote {n} {kind} host span events to {path}")


def host_trace_path(trace_out: str) -> str:
    """Where --trace-out's host spans go: ``.host`` before the suffix."""
    stem, dot, suffix = trace_out.rpartition(".")
    return f"{stem}.host.{suffix}" if dot and "/" not in suffix \
        else f"{trace_out}.host"


def report_prefix(s: dict) -> None:
    """The pool / copy-on-write / tree digest of a paged-KV engine summary
    (nothing on the ring)."""
    if "prefix" not in s:
        return
    px = s["prefix"]
    occ = px["pool"]
    line = (f"[paged-kv] block {px['kv_block']}: "
            f"{occ['used_blocks']}/{occ['n_blocks']} blocks used, "
            f"{occ['cow_copies']} CoW copies, {occ['evictions']} evictions")
    if px.get("tree") is not None:
        line += (f"; prefix cache: {px['hits']} hits, "
                 f"{px['hit_tokens']} tokens adopted / "
                 f"{px['novel_tokens']} novel, tree "
                 f"{px['tree']['nodes']} nodes")
    print(line)


if __name__ == "__main__":
    main()
