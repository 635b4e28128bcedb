#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BuddyMoE on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch`` and reads the
committed fixture under ``results/bench``). Phases, one JSON line each:

  device   the card's name, power limit and compute capability (must be 9.0)
  build    nvcc builds of the seven kernels (csrc/*.cu), all at once, with
           ptxas's registers and spill bytes per compiled function
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes of the main path, with times (CUDA events) and bounds;
           the routing kernels also with their device time (torch.profiler)
           and device ops per call: route at T = 4, 32, 33, 64, 128, 256,
           512 and 4096 (one launch of one cluster of ceil(T / 4) CTAs up to
           32 tokens, two launches above; each row names its form and
           launches per call) with and without the tier and peer masks and
           with substitution off, and at T = 4, 32, 256 and 4096 in cost
           mode (degraded and peer costs) and with Psi's eta and
           kappa terms, the temperature and the margin co-gate, beside the
           path it replaced (topk_gate, the distribution gate in torch ops,
           buddy_substitute, the splits) timed in the same run;
           the three FFN kernels also print the instance of the shared tile
           that ran (vec16 or elem; the path shapes must run vec16), its
           stage depth bk (64 for quant_ffn's int8-only launch, 16 for the
           others) and the achieved TB/s, and grouped_ffn a row sweep (every
           live group at 1, 3 and 8 rows); the FFN kernels also at the
           continuous phase's chunk shapes: grouped_ffn on 32 and 512 tokens
           binned at the dropless cap T*K (192, 3072), expert_ffn on the
           capacity branch's [64, 4 x 48, 2048] buffer and quant_ffn on its
           degraded slots [64, 192, 2048] with row counts; quant_ffn also
           on the gather tier step's call (4 degraded slots over 3-4 live
           experts), each case with its kernels' device time by kernel
           (torch.profiler); wkv_chunk at the train shape and at head dim
           128 (dynamic shared memory), each with its device time, ring
           depth and a SHA-256 of its outputs' bytes, and its autograd
           backward on the card against the same on the CPU; topk_gate
           and route on signed-zero router rows (-0.0 below +0.0, as
           lax.top_k orders them) against their plain versions; and the
           FFN kernels and route at Mixtral-8x7B's shapes (one line,
           kernel "mixtral_shapes"): expert_ffn on the capacity branch's
           decode buffer [8, 4 x 2, 4096] and a chunk-8 step's [8, 4 x 16,
           4096] (d_ff 14336), grouped_ffn on a fused decode step's
           [16, 8, 4096] with row counts, quant_ffn on the int8 tier's
           degraded slots [8, 8, 4096] with counts, route at E = 8, K = 2,
           R = 7, T = 4 and 32; each with ms, device_us and its bound,
           the FFN cases with their plain version's device ops by name;
           and the train path's two kernels at DeepSeek-V2-Lite's train
           shapes (kernel "train_grads"): expert_ffn on the capacity
           buffer of a 4 x 512 batch [64, 4 x 64, 2048] x 1408 and
           topk_gate at T = 2048, E = 64, K = 6, each forward against its
           plain version and its autograd Function's backward against
           autograd through the plain version on the same card tensors
           (every gradient within GRAD_RTOL of its largest entry), with
           forward and backward ms beside their bounds
  parity   the committed profiling fixture (results/bench/model.npz with
           tables_a0.95_k16.npz) served on the CPU through the plain versions
           and on the card through the kernels, without and with the int8
           quant tier, and in cost mode (fused without the tier, gather
           with it): equal tokens and counters (tier and cost-policy
           counters included), close logits; and paged_prefix: paged KV
           in 8-token blocks with the prefix cache and the int8 tier,
           session requests on a 20-token shared prefix through the
           continuous scheduler, with equal prefix summaries (hits,
           copy-on-write copies, evictions, tree) besides; and reduced
           Mixtral (window 128) from weights made on the CPU, 4 x 124
           prompt + 8 new tokens, capacity and fused, without and with
           the int8 tier, held the same way
  claims   the paper's claims as tests/test_system.py states them (the CPU
           twin is tests/test_torch_system.py), on its token stream
           (MarkovLM seed 11, drawn in its order): (a) the committed
           fixture on the CPU through the plain versions and on the card
           through the kernels (the card's run in its own launch-count
           window: topk_gate, route and expert_ffn launch), under the
           committed tables_a0.95_k16.npz and under the tables the
           reference's test builds (CFT over co-activation and output
           similarity, the similarity computed on each device, the
           tables equal): substitute errors of the top buddy and of a
           random expert (within ERR_TOL), teacher-forced agreement with
           the full model at cache rate 0.5 over 3 residency draws under
           the buddy tables, core.make_random_table's table, mode
           "random" on it, drop and none (n_sub and the substituted masks
           equal, agreement within AGREE_TOL), ServeEngine buddy against
           mode "none" (fetches, substitutions and bytes equal, tokens/s
           within TPS_RTOL) and the gates (no substitution at tau = 1 or
           beta = 0); on the card the paper's inequalities: buddy error
           below random, mean agreement of buddy minus the random table
           above -0.005, fewer fetches and bytes than on-demand; ms per
           forward; (b) deepseek-v2-lite-buddy at full width, the serve
           phase's 8 layers, random weights from seed 0, in one launch-
           count window: the offline pipeline (4 record=True forwards of
           8 x 64, CoactivationRecorder, build_buddy_lists, calibrate_tau
           over tae_from_probs, p15), then agreement on 8 x 48 tokens
           under the buddy tables, make_random_table and drop over 3
           residency draws, and the gates (n_sub 0); launches equal to one
           topk_gate per MoE layer per forward without a policy, one
           route per MoE layer per forward with one, expert_ffn in every
           forward, and the same in torch.profiler's count of kernel
           functions over one forward of each kind; seconds per stage. No quality inequality at
           full width: random weights carry no co-activation structure
  serve    deepseek-v2-lite-buddy at full width cut to 8 layers, random
           weights from seed 0, two paths, each in its own launch-count
           window: (1) buddy profiling, a fused-dispatch batch (4 x 8 prompt
           + 8 new tokens), then 2 steps through the gather branch; (2) the
           same with --quant-tier int8 --tier-coverage 0.5: fused, then 3
           gather steps, both serving degraded slots; (3) the tier path with
           --miss-policy cost: the route kernel's cost argmin, upgrades of
           degraded slots. Every kernel of a path must have launched in that
           path's window; every serve step must have launched route once
           per MoE layer and neither standalone routing kernel
  continuous  the serve phase's weights served to arriving requests through
           the continuous scheduler, three runs, each in its own launch-count
           window: (a) the launcher (serve.main --mode continuous, 4 slots,
           8 requests of 4-8 prompt + 8 new tokens at the auto arrival rate,
           --prefill-chunk 8 --fused-dispatch); (b) the same with --quant-tier
           int8 --tier-coverage 0.5 and without --fused-dispatch (the
           capacity branch through expert_ffn, degraded slots through
           quant_ffn); (c) 8 queued requests of 256-token prompts and 8 new
           tokens at --prefill-chunk 128 (chunk steps of 512 tokens, route's
           two-launch form). Every request completes; every step launches
           route once per MoE layer and no standalone routing kernel; wall
           ms per chunk and decode step (synchronized host clock), step
           counts, TTFT and goodput on the simulated clock, launches, peak
           memory. Then, at 4 requests and without substitution, chunk 8
           against token-by-token: each request's first-token logits agree
           within LOGIT_TOL (the count of equal generated tokens is printed,
           not required: a near tie at random weights may flip one)
  paged    the same weights with paged KV (--paged-kv --kv-block 16), each
           run in its own launch-count window: (a) the launcher as in
           continuous (a): every request completes, route once per MoE
           layer per step, the pool empty at the end, the [paged-kv] line
           printed; (b) 8 requests on a 60-token system prompt (not a
           multiple of the block) with 8-24 tokens of their own, with
           --prefix-cache and without: >= 4 hits of 60 tokens, a copy-on-
           write per hit, the pool's refcounts equal to its holders, fewer
           chunk steps with the cache; wall ms per chunk / decode step,
           peak memory and the pool and tree digest beside continuous
           (a)'s ring figures; (c) (b)'s requests without substitution
           three ways (prefix cache, paged alone, ring): every hit
           request's first-token logits agree within LOGIT_TOL (equal
           generated tokens printed, not required)
  telemetry  the serve phase's batch (fused) and continuous (a)'s
           configuration on the same weights, each four times on one
           engine: telemetry off, Telemetry.with_trace() twice, off again
           (installed by reset_runtime). Tokens, stats, ledger and stall
           breakdown equal in all four; per run with the recorder, one
           outcomes instant per MoE layer per step (hit and buddy sums equal
           to the engine's counters), one step span per step, a fetch
           calibration row per fetch, the request track complete for every
           request; the JSONL export (chiprun_out/trace_*.jsonl) read back
           equal, the Perfetto export (trace_*.json) parsed; wall ms per
           lockstep, chunk and decode step off and on
  mesh     the same weights, batch 4, 8 + 8 tokens, on a simulated mesh
           (--n-devices 4) in precedence and in cost mode beside one device:
           peer borrows, peer stall equal in the stall breakdown and the
           mesh summary, the three links' peer bytes equal to the borrows'
           expert bytes; every route call of the mesh runs (with the
           engine's peer_ok / peer_cost) against route_plain on the card;
           the committed fixture at 4 devices in both modes, CPU against
           the card (tokens, stats, ledger, stall breakdown, mesh summary
           equal, logits within LOGIT_TOL); wall ms per step against one
           device
  placement  continuous (b) (int8 tier at coverage 0.5, the capacity
           branch) without placement, then with --placement live
           --placement-interval-ms 1 on one device and on two: every
           request served, ticks and a coverage re-pick or replica, a peer
           push at two devices, the int8 replicas where they were and no
           more device memory held after the run or at its peak than
           without placement; expert_ffn and quant_ffn launches
  full_depth  after placement, with the 8-layer weights freed (under 1
           GB allocated at the start): the serve launcher at its defaults,
           serve.main with no --layers, so deepseek-v2-lite-buddy at all 27
           layers in f32 (65.17 GB of weights), batch 4, 32 new tokens,
           cache-rate 0.5, buddy, prev-step, precedence; four paths, each
           in its own launch-count window: (1) the defaults (random weights
           from seed 0: the gather branch, T*K = 24 < E = 64); (2) the same
           weights through serve.main(argv, params=) with --fused-dispatch
           (grouped_ffn); (3) --quant-tier int8 --miss-policy cost
           (quant_ffn, the cost argmin in route; the int8 replicas of every
           expert, 14.98 GB, beside the weights); (4) --mode continuous
           --num-requests 8 --prefill-chunk 8 --fused-dispatch. Each path:
           route once per MoE layer per step and no standalone routing
           kernel; every kernel of the path launched, topk_gate and
           expert_ffn once per MoE layer in each of buddy profiling's four
           record=True forwards; every route call's slot outcomes (hit,
           buddy, degraded, peer, fetch, drop) partition its T*K slots; at
           layer 26, on the step's own operands, every route call equal to
           route_plain (ints and masks) and the path's last DEEP_KEEP calls
           of each other kernel equal to its plain version (the kernels
           phase's tolerance); init_params's allocation equal to the meta count
           (within 512 bytes a leaf). Gather and fused: the first step's
           routing at every layer equal and its logits within LOGIT_TOL x
           (1 + max |logit|); the route calls equal from the start and the
           greedy tokens alike are counted. Printed per path: set-up
           seconds (init_params, profile_buddies, attach_quant_tier), peak
           memory, median decode ms after the first step, one profiled
           step's device ms and ops and the idle share
  mixtral  mixtral-8x7b at full width (d_model 4096, 32 query heads over 8
           KV heads, 8 experts x 14336, top-2, window 4096, f32) cut to 4
           of its 32 layers, random weights from seed 0 on the card (their
           allocation equal to the meta count), four
           paths through the launcher's entry points, each in its own
           launch-count window: (1) the default batch (4 x 8 prompt + 8
           new tokens), every decode step in the capacity branch
           (expert_ffn); (2) --fused-dispatch (grouped_ffn); (3) --quant-
           tier int8 --tier-coverage 0.5 (quant_ffn on the degraded
           slots); (4) --mode continuous --slots 4 --num-requests 8
           --prefill-chunk 8. Every request completes, every step launches
           route once per MoE layer and no standalone routing kernel, and
           every step off the fused path expert_ffn once per layer; the
           slot outcomes and the last layer's kernels as in full_depth;
           wall ms per step (synchronized host clock), one profiled step's
           device ms and the idle share, peak memory, parameter count, and
           each FFN kernel of the path on its kept last-layer operands with
           the most filled rows (the capacity decode buffer [8, 8, D], the
           fused [16, 8, D], the tier's [8, 8, D] with counts): ms, device
           ms and the plain version's ms against its bound (reduced
           Mixtral's CPU-vs-card parity is in the parity phase)
  mixtral_8x22b  after dryrun_mixtral, with the 8x7B weights freed: the
           mixtral phase's paths and checks for mixtral-8x22b (d_model
           6144, 48 query heads over 8 KV heads, 8 experts x 16384) cut to
           4 of its 56 layers (41.68 GB): the FFN tile at D = 6144, F =
           16384
  similarity  expert output similarity, the path in its own launch-count
           window: the committed fixture's all_layer_similarities on the
           card, and every Mixtral layer's [8, 256, 4096] calibration rows
           through expert_output_similarity. Then every expert_ffn call of
           the path against expert_ffn_plain on its own operands (within
           TOL_F32 x (1 + max |plain|)), the fixture's cosine means against
           the CPU's and each Mixtral layer's against the plain version's
           on the card, within SIM_TOL; the plain version's device ops at
           Mixtral's shape by name
  train_parity  the reduced rwkv6 config, weights from seed 0 made on the
           CPU: one train step on the CPU (plain) and one on the card
           (kernel); loss, grad norm and every gradient agree; then the
           same for the reduced smollm-360m (tied embeddings, no kernel);
           after dense_train, for deepseek-v2-lite-buddy's profiling config
           (64 experts, top-6): topk_gate and expert_ffn once per MoE layer
           per forward on the card and never on the CPU, every MoE leaf's
           card gradient finite and nonzero where the CPU's is, the
           smallest gap between a token's K-th and (K+1)-th router logit
           printed beside the error
  train    rwkv6-1.6b at full width and depth (24 layers, d_model 2048,
           vocab 65536, f32), random weights from seed 0, through
           launch/train.py's entry points: --batch 4 --seq 512 --steps 3 in
           its own launch-count window; finite loss and grad norm at every
           step, 24 wkv_chunk launches per forward; per-step wall time and
           its forward / backward / optimizer split, tokens/s, peak memory
  decode   the trained full-width weights: forward_train (chunked, through
           the kernel) against 31 decode_steps (per-token recurrence) on 2 x
           32 tokens
  dense_train  internlm2-1.8b at full width and depth (24 layers, d_model
           2048, 16 query heads over 8 KV heads, vocab 92544, f32) through
           launch/train.py, --batch 4 --seq 512 --steps 3: finite loss and
           grad norm at every step; wall per step, tokens/s, the forward /
           backward / optimizer split, peak memory
  moe_train  deepseek-v2-lite-buddy at full width (d_model 2048, 16 heads
           x 128, 64 experts x 1408, top-6, 2 shared experts, vocab 102400,
           f32) cut to 4 of its 27 layers, random weights from seed 0,
           through launch/train.py --layers 4 --batch 4 --seq 512 --steps
           3 in its own launch-count window: finite loss and grad norm at
           every step, topk_gate and expert_ffn 4 times per forward;
           parameters, setup s, per-step wall and forward / backward /
           optimizer s, median tokens/s, peak memory
  dryrun   the launch tooling (launch/{mesh,sharding,roofline,dryrun}.py):
           (1) the dry run on the meta device at production scale
           (deepseek-v2-lite-buddy decode_32k, mixtral-8x7b train_4k,
           internlm2-1.8b prefill_32k, each rank 0's share of the step
           sharded on the 16 x 16 mesh): per-device argument GB, FLOPs,
           bytes, collective bytes by op and their counts,
           temp_size_bytes, the compute, memory and collective terms
           under the H100 HardwareSpec, the dominant term; (2) meta
           against the card
           at full width, two steps: (a) Mixtral-8x7B, the mixtral phase's
           4 layers and weights, one capacity-branch decode step at batch 4
           (after the similarity phase), (b) DeepSeek-V2-Lite, 4 layers,
           one train step at 4 x 512 with remat and AdamW (after
           moe_train). Each step traced on meta and run once on the card
           under the same OpCounter after one warm-up step: equal FLOPs,
           bytes and kernel charges, predicted argument bytes equal to the
           card tensors' (memory_allocated's delta beside them), the
           counted step's launches equal to its charges, the caching
           allocator's peak over the counted step (beyond what it held
           before) within peak_tolerance of the meta tracker's peak
           (PEAK_SLACK = 1 MiB per block over 1 MiB live there: the
           allocator hands out a large block unsplit when less than that
           would be left), temp_size_bytes beside it; then the median of
           10 steps by
           CUDA events (and the wall), the profiler's device-busy time,
           the roofline bound max(FLOPs / the dtype's peak, bytes / HBM)
           and the share bound / event time, at most SHARE_MAX, with the
           card's name and power limit; (c) after long_context, the dry
           run's long shapes for internlm2-1.8b at full width and depth,
           batch 1: internlm2_prefill_32k (forward_train of 32,768 tokens,
           on long_context's weights) and internlm2_train_4k (4,096
           tokens, lm_loss with remat, then AdamW), each checked as (a)
           and (b) but timed over LONG_REPS = 3 steps; a step whose
           counted run took over LONG_STEP_S = 1.5 s is timed without
           another warm-up, and its wall and device-busy time are not
           read; (d) rank 0's share of internlm2-1.8b train_4k sharded on
           the 16 x 16 mesh over the fake backend, on the card (16 x
           4,096 tokens, bf16): equal FLOPs, bytes, kernel charges and
           collectives (calls and bytes by op) to its meta trace, its
           peak within peak_tolerance, the per-device roofline terms with
           the collective term and the share over 3 steps
  long_context  the reference's chunked attention (models/attention.py
           _flash_attend: an online softmax over q chunks of 512 and kv
           chunks of 1024, every full-sequence forward's attention)
           after dryrun (b), in its own launch-count window with zero
           launches of the seven kernels: (a) _flash_attend against the
           whole-matrix _attend on the same card tensors (B = 1, head dim
           128, f32): internlm2-1.8b's 16 over 8 heads, causal, S = 4,096,
           forward and backward (each gradient within GRAD_RTOL of its
           largest entry); Mixtral-8x7B's 32 over 8, window 4,096, S =
           8,192 (rows from 5,119 on see no key of kv chunk 0: the -1e30
           path); Llama-3.2-Vision's cross attention, 512 queries against
           1,601 keys; each within FLASH_TOL, with ms, peak GB and device
           ms by op of each form; (b) internlm2-1.8b at full width and
           depth (24 layers, seed 0): transformer.prefill of 1 x 32,768
           tokens (the dry run's prefill_32k at batch 1; seconds,
           tokens/s, peak memory), its last 512 positions' logits within
           LOGIT_TOL and LONG_TAIL_RTOL of the largest of them of the ring
           path's on the same tokens
           (prefill_chunk in chunks of RING_CHUNK = 2,048 into caches of
           32,768 slots, whose attention is _attend)

The hybrid, VLM and audio families run plain torch ops: each of their
phases resets the launch counts before its path and requires that none of
the seven kernels launched; each frees its weights before the next.
  families_parity  the reduced zamba2-7b, llama-3.2-vision-11b and
           musicgen-large, weights from seed 0 made on the CPU,
           conditioning from a seed where the config has it: forward (S =
           32: the hybrid's chunked scan), 4 decode steps (its per-token
           recurrence) and one train step on the CPU and on the card agree
           (LOGIT_TOL, LOSS_RTOL, GRAD_RTOL)
  hybrid   zamba2-7b at full width and depth (81 layers, d_model 3584,
           Mamba2 56 heads x 128, state 64; 13 super-blocks of 6 Mamba2
           layers and the shared attention block, then 3 Mamba2 layers;
           f32, seed 0): prefill of 4 x 512 tokens (twice), 32 teacher-
           forced decode steps, wall per step (synchronized host clock),
           tokens/s, one decode step's device ms, device ops and its
           eight longest device ops (torch.profiler) and the idle share,
           peak memory; decode
           against the prefill's logits at full depth (printed); then the
           15-layer cut's decode against its forward on 2 x 32 tokens,
           within DECODE_TOL
  vlm      llama-3.2-vision-11b at full width and depth (40 layers:
           8 super-blocks of 4 self-attention layers and a cross-attention
           layer), conditioning [4, 1601, 4096] from a seed: prefill of
           4 x 512 with it (twice) and without it, 16 decode steps as
           above; finite logits, the image changes them by more than
           LOGIT_TOL, and decode (over zero cross keys and values, as the
           reference's) equals a forward on zero conditioning within
           DECODE_TOL
  audio    musicgen-large at full width and depth (48 layers, d_model
           2048), conditioning [4, 256, 2048] as the causal prefix: prefill
           of 4 x 512 (logits [4, 512, 2048]: the tokens only), 16 decode
           steps at positions shifted by the prefix, as above
  hybrid_train  zamba2-7b --layers 15 (2 super-blocks and 3 Mamba2
           layers, 1.60 B parameters) at full width through launch/
           train.py --batch 4 --seq 512 --steps 3: finite loss and grad
           norm at every step; wall per step, the forward / backward /
           optimizer split, tokens/s, peak memory

The line new_phase_seconds gives the seconds of the full_depth and
mixtral_8x22b phases, every phase's seconds (all_phases), and main's
seconds in all and outside the phases. The kernels line's topk_gate and expert_ffn launches include
claims', moe_train's and the dryrun phase's (which adds route's too).

Then the kernels table line, the card's name and power limit as nvidia-smi
prints them, and the result line. Without a CUDA card, or outside a checkout,
it exits nonzero before printing a result.
"""
from __future__ import annotations

import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TOL_F32 = 1e-4                 # |kernel - plain| for f32 FFN outputs (f32
#                                sums in another order over D or F <= 2048)
TOL_GATE = 1e-6                # probs / TAE: the same f32 formulas
LOGIT_TOL = 1e-3               # CPU vs card logits on the fixture (f32
#                                matmuls in another order, two layers)
FID_RTOL = 1e-5                # CPU vs card mean fidelity loss (f32 sums)
FIXTURE = ROOT / "results" / "bench"
GRAD_RTOL = 1e-4               # CPU vs card gradients, of each leaf's (or
#                                WKV input's) largest entry: f32 sums in
#                                another order; the embedding's backward
#                                accumulates with atomics on the card
LOSS_RTOL = 1e-5               # CPU vs card loss and grad norm
DECODE_TOL = 5e-4              # chunked forward vs step-by-step decode,
#                                |diff| <= tol * (1 + |logit|): the tolerance
#                                the reference holds its own chunked form to
#                                (tests/test_ssm_chunked.py), both f32 forms
#                                summing in another order through exp(+-la)
SERVE_KERNELS = ("topk_gate", "expert_ffn", "grouped_ffn", "quant_ffn",
                 "route")
# the serve phase's batch and the continuous phase's runs: full width, 8
# layers, cache-rate 0.5
SERVE_FLAGS = ["--arch", "deepseek-v2-lite-buddy", "--layers", "8",
               "--cache-rate", "0.5", "--policy", "buddy", "--predictor",
               "prev-step", "--batch", "4", "--steps", "8"]
CONTINUOUS_FLAGS = ["--arch", "deepseek-v2-lite-buddy", "--layers", "8",
                    "--cache-rate", "0.5", "--policy", "buddy", "--mode",
                    "continuous", "--slots", "4", "--num-requests", "8",
                    "--steps", "8", "--prefill-chunk", "8"]
TIER_FLAGS = ["--quant-tier", "int8", "--tier-coverage", "0.5"]
OUT_DIR = ROOT / "chiprun_out"     # trace exports (git ignores it)
# the mixtral phase: Mixtral-8x7B at full width, 4 of its 32 layers
MIXTRAL_FLAGS = ["--arch", "mixtral-8x7b", "--layers", "4", "--cache-rate",
                 "0.5", "--policy", "buddy", "--predictor", "prev-step",
                 "--batch", "4", "--steps", "8"]
# the mixtral_8x22b phase: Mixtral-8x22B at full width, 4 of its 56 layers
MIXTRAL_8X22B_FLAGS = ["--arch", "mixtral-8x22b"] + MIXTRAL_FLAGS[2:]
SIM_TOL = 1e-5                 # output cosine means, card vs CPU and kernel
#                                vs plain: f32 sums over D and N in another
#                                order, each cosine in [-1, 1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call, after a warm-up."""
    return statistics.median(event_ms(fn, reps, inner))


def event_ms(fn, reps: int, inner: int = 1, warm: int = 3) -> list:
    """``reps`` CUDA-event timings of ``inner`` back-to-back calls, per
    call, after ``warm`` untimed calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return out


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_us(fn, n: int = 10, by_op: bool = False) -> dict:
    """The device's own time per call of ``fn`` and the device ops (kernels
    and copies) per call, from torch.profiler over ``n`` back-to-back
    calls: what the card spends apart from waiting for the host (with
    ``by_op``, also per device op, by the first 60 characters of its
    name, summed over the ops that share them). The window is
    ``profiled``'s. A window with no device event (seen once) is taken
    again, up to three times; then the numbers are None, "not
    measured"."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, evts = profiled(lambda: [fn() for _ in range(n)])
        if evts:
            out = {"device_us": sum(_self_device_us(e) for e in evts) / n,
                   "device_ops_per_call": sum(e.count for e in evts) / n}
            if by_op:
                by, count = {}, {}
                for e in evts:
                    by[e.key[:60]] = (by.get(e.key[:60], 0.0)
                                      + _self_device_us(e) / n)
                    count[e.key[:60]] = count.get(e.key[:60], 0) + e.count / n
                out["device_us_by_op"] = by
                out["device_ops_by_op"] = count
            return out
    return {"device_us": None, "device_ops_per_call": None}


def profiled(fn) -> tuple:
    """(fn's result, the device events of its one call): torch.profiler
    over the call between two spin kernels (torch.cuda._sleep), which open
    and close the window and are left out, since the profiler can drop a
    window's first or last device event; events with no device time are
    left out too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        out = fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return out, [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and _self_device_us(e) > 0 and "spin" not in e.key.lower()]


def device_ops(fn) -> list:
    """The names of the device ops of one call of ``fn`` (torch.profiler;
    empty if the window caught none): which library kernels ran."""
    return sorted(device_us(fn, n=1, by_op=True).get("device_us_by_op")
                  or {})


def bound(nbytes: float, flops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ffn_rate(moved: float, ms: float, b_ms: float) -> dict:
    """Achieved rate of an FFN call: the bound's bytes over its time."""
    return {"bytes": moved, "tb_per_s": moved / ms / 1e9,
            "share_of_bound": b_ms / ms}


def ffn_plan(x, groups: int, f_n: int, tensors, fp=True,
             int8=False) -> dict:
    """The shared FFN tile's instance and stage depth a call on these
    operands runs; the path shapes must run the 16-byte-copy instance."""
    from repro_torch.kernels.expert_ffn import launch_plan
    _, c_n, d_n = x.shape
    plan = launch_plan(x.element_size(), groups, c_n, d_n, f_n, fp=fp,
                       int8=int8, ptrs=[t.data_ptr() for t in tensors])
    require(plan["instance"] == "vec16",
            f"FFN path shape {tuple(x.shape)} x {f_n} ran {plan}")
    return {"instance": plan["instance"], "bk": plan["bk"]}


def live_rows(x) -> tuple:
    """(rows, groups) of an [G, C, D] buffer that hold an element other
    than +-0: the rows expert_ffn computes, the groups whose weights it
    reads."""
    live = (x != 0).any(-1)
    return int(live.sum()), int(live.any(-1).sum())


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "capability": list(cap),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    require(tuple(cap) == (9, 0), f"needs compute capability 9.0, got {cap}")
    return smi


def _ptxas_functions(log: str) -> dict:
    """ptxas -v's registers and spill bytes per compiled function, under a
    short name: the FFN tile's instances as kernel/type/load width/stage
    depth (the int8-only launch's instances are quant_ffn's)."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            f = re.search(r"ffn\d+(gate_up|down)_kernelI(f|13__nv_bfloat16)"
                          r"Li(\d+)ELb([01])E", name)
            if f:
                name = "/".join((f.group(1), "f32" if f.group(2) == "f"
                                 else "bf16", "vec16" if f.group(4) == "1"
                                 else "elem", f"classes{f.group(3)}"))
            w = re.search(r"wkv_chunk_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
            if w:
                name = "wkv/C{}/D{}/stages{}".format(*w.groups())
            out[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[name]["spill_bytes"] = int(st) + int(ld)
        elif name and "Used" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   ln).group(1))
    return out


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    ptxas = {n: _ptxas_functions(v["log"]) for n, v in info.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})


# ---------------------------------------------------------------------------
def _route_slots(gen, t_n, e_n, k_n, dev):
    """Distinct experts per token, as a router gives them: [T, K] int32."""
    import torch
    return torch.stack([torch.randperm(e_n, generator=gen)[:k_n]
                        for _ in range(t_n)]).to(torch.int32).to(dev)


def _signed_zero_logits(gen, t_n: int, e_n: int, k_n: int):
    """[T, E] f32 router logits with signed zeros, as the reference's
    serving top-k (lax.top_k) orders them: -0.0 below +0.0. Row 0 holds
    zeros of random sign only; each other row fewer than K positive logits,
    then zeros of both signs across the K-th place, then negatives."""
    import torch
    z = torch.empty(t_n, e_n)
    for i in range(t_n):
        signs = torch.where(torch.rand(e_n, generator=gen) < 0.5, -1.0, 1.0)
        if i == 0:
            z[i] = signs * 0.0
            continue
        n_pos = int(torch.randint(0, k_n, (1,), generator=gen))
        n_zero = min(e_n - n_pos, k_n - n_pos + 1
                     + int(torch.randint(2, 8, (1,), generator=gen)))
        row = torch.cat([
            torch.randint(1, 3, (n_pos,), generator=gen).float(),
            signs[:n_zero] * 0.0,
            -torch.randint(1, 3, (e_n - n_pos - n_zero,),
                           generator=gen).float()])
        z[i] = row[torch.randperm(e_n, generator=gen)]
    return z


def _signed_zero_case(dev, gen, t_n: int, e_n: int, k_n: int) -> dict:
    """topk_gate and route on the card against their plain versions on
    signed-zero rows: equal indices and the picked logits' bits (their
    signs) equal."""
    import torch
    from repro_torch.kernels.route import route_cuda, route_plain
    from repro_torch.kernels.topk_gate import topk_gate_cuda, topk_gate_plain
    z = _signed_zero_logits(gen, t_n, e_n, k_n).to(dev)
    got, want = topk_gate_cuda(z, 0.2, k=k_n), topk_gate_plain(z, 0.2, k=k_n)
    gate_eq = (torch.equal(got[0], want[0]) and torch.equal(got[4], want[4])
               and torch.equal(got[1].view(torch.int32),
                               want[1].view(torch.int32)))
    table, q = _buddy_tables(gen, e_n, 8, dev)
    resident = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
    args = (z, 0.2, 1.1, resident, table, q)
    rg = route_cuda(*args, k=k_n, h=8, rho=3)
    rw = route_plain(*args, k=k_n, h=8, rho=3)
    route_eq = all(torch.equal(getattr(rg, f), getattr(rw, f))
                   for f in ROUTE_EXACT) and torch.equal(
        rg.topk_logits.view(torch.int32), rw.topk_logits.view(torch.int32))
    require(gate_eq and route_eq, f"signed zeros T={t_n} E={e_n} K={k_n}: "
                                  f"topk_gate {gate_eq}, route {route_eq}")
    return {"topk_gate_equal": gate_eq, "route_equal": route_eq,
            "negative_zero_picks": int((want[1].view(torch.int32)
                                        == -2 ** 31).sum())}


def kernel_topk(dev, gen):
    import torch
    from repro_torch.kernels.topk_gate import topk_gate_cuda, topk_gate_plain
    e_n, k_n, tau = 64, 6, 0.2
    rows = {}
    for t_n in (4, 256):
        z = torch.randn(t_n, e_n, generator=gen).to(dev)
        got, want = topk_gate_cuda(z, tau, k=k_n), topk_gate_plain(z, tau, k=k_n)
        require(torch.equal(got[0], want[0]) and torch.equal(got[4], want[4]),
                f"topk_gate T={t_n}: indices or gate differ")
        err = max(max_err(g, w) for g, w in zip(got[1:4], want[1:4]))
        require(err <= TOL_GATE, f"topk_gate T={t_n}: err {err}")
        nb = nbytes(z) + nbytes(*got)
        b_ms, b_by = bound(nb, t_n * e_n * k_n)
        rows[t_n] = {"max_abs_err": err,
                     "ms": time_ms(lambda: topk_gate_cuda(z, tau, k=k_n),
                                   inner=10),
                     "plain_ms": time_ms(lambda: topk_gate_plain(z, tau, k=k_n),
                                         inner=10),
                     "library_ms": time_ms(lambda: torch.topk(z, k_n, dim=-1),
                                           inner=10),
                     "bound_ms": b_ms, "bound_by": b_by,
                     **device_us(lambda: topk_gate_cuda(z, tau, k=k_n))}
    # ties on purpose: logits on a coarse grid
    z = (torch.randn(256, e_n, generator=gen) * 2).round().to(dev)
    got, want = topk_gate_cuda(z, tau, k=k_n), topk_gate_plain(z, tau, k=k_n)
    require(torch.equal(got[0], want[0]), "topk_gate: tie order differs")
    # -0.0 below +0.0, as lax.top_k: [-0, +0, -0, +0] at K = 2 picks [1, 3]
    zeros = torch.tensor([[-0.0, 0.0, -0.0, 0.0]], device=dev)
    require(topk_gate_cuda(zeros, tau, k=2)[0].tolist() == [[1, 3]]
            == topk_gate_plain(zeros, tau, k=2)[0].tolist(),
            "topk_gate: -0.0 is not ordered below +0.0")
    zgen = torch.Generator().manual_seed(33)  # leaves gen's draws as they were
    signed = {f"T{t}_E{e}_K{k}": _signed_zero_case(dev, zgen, t, e, k)
              for t, e, k in ((4, 64, 6), (33, 256, 16), (256, 64, 6))}
    emit({"phase": "kernels", "kernel": "topk_gate", "E": e_n, "K": k_n,
          "by_T": rows, "ties_equal": True, "signed_zeros": signed})
    return rows[4]


def _buddy_tables(gen, e_n, r_n, dev):
    """A buddy table [E, R] int32 (rank order, a share of the lower ranks
    -1 padded) and its q values, descending per row."""
    import torch
    table = torch.stack([torch.randperm(e_n, generator=gen)[:r_n]
                         for _ in range(e_n)]).to(torch.int32)
    table[:, r_n // 2:][torch.rand(e_n, r_n - r_n // 2,
                                   generator=gen) < 0.3] = -1
    q = torch.rand(e_n, r_n, generator=gen).sort(-1, descending=True).values
    return table.to(dev), q.to(dev)


def kernel_buddy(dev, gen):
    import torch
    from repro_torch.kernels.buddy_substitute import (buddy_substitute_cuda,
                                                      buddy_substitute_plain)
    e_n, k_n, r_n, h, rho = 64, 6, 8, 8, 3
    res = {}
    for t_n in (4, 256):
        s = _route_slots(gen, t_n, e_n, k_n, dev)
        gate = (torch.rand(t_n, generator=gen) < 0.8).to(dev)
        resident = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
        table, q = _buddy_tables(gen, e_n, r_n, dev)
        args = (s, gate, resident, table, q)
        got = buddy_substitute_cuda(*args, h=h, rho=rho)
        want = buddy_substitute_plain(*args, h=h, rho=rho)
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"buddy_substitute T={t_n}: outputs differ")
        b_ms, b_by = bound(nbytes(*args) + nbytes(*got), t_n * k_n * h * k_n)
        res[t_n] = {"max_abs_err": 0.0, "n_sub": int(got[1].sum()),
                    "ms": time_ms(lambda: buddy_substitute_cuda(*args, h=h,
                                                                rho=rho),
                                  inner=10),
                    "plain_ms": time_ms(lambda: buddy_substitute_plain(
                        *args, h=h, rho=rho), inner=10),
                    "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                    **device_us(lambda: buddy_substitute_cuda(*args, h=h,
                                                              rho=rho))}
    emit({"phase": "kernels", "kernel": "buddy_substitute", "E": e_n,
          "K": k_n, "R": r_n, "by_T": res})
    return res[4]


def _ffn_weights(gen, e_n, d_n, f_n, dev, dtype):
    import torch
    w = [torch.randn(e_n, a, b, generator=gen) * 0.02
         for a, b in ((d_n, f_n), (d_n, f_n), (f_n, d_n))]
    return [t.to(dtype).to(dev) for t in w]


def _capacity_binned(gen, x_tok, rows: int, e_n: int, k_n: int, dev):
    """Bin T = rows x S tokens' K routed slots like the capacity branch of
    a dropless chunk step: per batch row, by expert, into the [E, rows *
    S*K, D] buffer laid out [E, B, cap] with cap = S*K (no slot dropped)."""
    import torch
    t_n, d_n = x_tok.shape
    cap = t_n // rows * k_n
    s = _route_slots(gen, t_n, e_n, k_n, "cpu").long().reshape(rows, cap)
    seen = torch.zeros(rows, e_n, dtype=torch.long)
    flat = torch.empty(rows, cap, dtype=torch.long)
    for b in range(rows):
        for j, e in enumerate(s[b].tolist()):
            flat[b, j] = e * rows * cap + b * cap + seen[b, e]
            seen[b, e] += 1
    buf = torch.zeros(e_n * rows * cap, d_n, dtype=x_tok.dtype, device=dev)
    buf[flat.reshape(-1).to(dev)] = x_tok.to(dev).repeat_interleave(k_n, 0)
    return buf.view(e_n, rows * cap, d_n)


def kernel_expert_ffn(dev, gen):
    import torch
    from repro_torch.kernels.expert_ffn import expert_ffn_cuda, expert_ffn_plain
    e_n, k_n, d_n, f_n = 64, 6, 2048, 1408
    w1, w3, w2 = _ffn_weights(gen, e_n, d_n, f_n, dev, torch.float32)
    rows = {}
    # "full_32": 32 rows in every expert; "chunk_capacity": the capacity
    # branch of a continuous chunk step (4 slots x 8 tokens, dropless
    # cap = 8 x K per slot), the buffer of the continuous phase's run (b)
    for name in ("full_32", "chunk_capacity"):
        if name == "full_32":
            x = torch.randn(e_n, 32, d_n, generator=gen).to(dev)
        else:
            x = _capacity_binned(gen, torch.randn(32, d_n, generator=gen), 4,
                                 e_n, k_n, dev)
        got, want = expert_ffn_cuda(x, w1, w3, w2), expert_ffn_plain(x, w1,
                                                                     w3, w2)
        err = max_err(got, want)
        require(err <= TOL_F32 * (1 + float(want.abs().max())),
                f"expert_ffn {name}: err {err}")
        # the kernel computes the live rows, through the live experts
        n_rows, n_live = live_rows(x)
        flops = 2 * n_rows * d_n * f_n * 3
        moved = nbytes(x, got) + nbytes(w1, w3, w2) * n_live // e_n
        b_ms, b_by = bound(moved, flops)
        rows[name] = {"shape": list(x.shape) + [f_n], "max_abs_err": err,
                      "live_rows": n_rows, "live_experts": n_live,
                      "max_abs_plain": float(want.abs().max()),
                      **ffn_plan(x, e_n, f_n, (x, w1, w3, w2)),
                      "ms": time_ms(lambda: expert_ffn_cuda(x, w1, w3, w2)),
                      "plain_ms": time_ms(lambda: expert_ffn_plain(x, w1, w3,
                                                                   w2)),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows[name].update(ffn_rate(moved, rows[name]["ms"], b_ms))
    # bf16 and ragged shapes: correctness only
    for (e, c, d, f), dt, tol in (((4, 37, 200, 136), torch.float32, TOL_F32),
                                  ((3, 33, 256, 320), torch.bfloat16, 5e-2)):
        xs = (torch.randn(e, c, d, generator=gen)).to(dt).to(dev)
        ws = _ffn_weights(gen, e, d, f, dev, dt)
        e2 = max_err(expert_ffn_cuda(xs, *ws), expert_ffn_plain(xs, *ws))
        require(e2 <= tol, f"expert_ffn {dt} {(e, c, d, f)}: err {e2}")
    emit({"phase": "kernels", "kernel": "expert_ffn",
          "shape": [e_n, "C", d_n, f_n], "by_case": rows})
    return rows["full_32"]


TRAIN_ROWS, TRAIN_SEQ = 4, 512        # moe_train's batch: 4 x 512 tokens


def _train_capacity_buffer(gen, e_n: int, k_n: int, d_n: int, dev):
    """The capacity branch's buffer of a DeepSeek train forward at batch
    TRAIN_ROWS x TRAIN_SEQ: each token's K distinct experts binned per
    batch row in slot order into [E, rows x cap, D], cap = 64 (1.25 x the
    mean load, rounded up to 8), slots past cap dropped, as models/moe.py
    bins them. Returns (buffer, filled rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.moe import _capacity
    rows, s_n = TRAIN_ROWS, TRAIN_SEQ
    cap = _capacity(s_n, k_n, e_n, 1.25)
    x_tok = torch.randn(rows * s_n, d_n, generator=gen)
    row_e = _route_slots(gen, rows * s_n, e_n, k_n, "cpu").long() \
        .reshape(rows, s_n * k_n)
    onehot = F.one_hot(row_e, e_n)
    pos = (onehot.cumsum(1) * onehot).sum(-1) - 1
    kept = pos < cap
    b_idx = torch.arange(rows)[:, None]
    flat = torch.where(kept, row_e * (rows * cap) + b_idx * cap + pos,
                       e_n * rows * cap).reshape(-1)
    buf = torch.zeros(e_n * rows * cap + 1, d_n)
    buf[flat] = x_tok.repeat_interleave(k_n, 0)
    return (buf[:-1].view(e_n, rows * cap, d_n).to(dev),
            int(kept.sum()))


def _grad_rel(got, want) -> float:
    """Largest |got - want| over want's largest entry."""
    return max_err(got, want) / max(float(want.abs().max()), 1e-30)


def kernel_train_grads(dev, gen):
    """The train path's two kernels at DeepSeek-V2-Lite's train shapes
    (batch 4 x 512): forward against the plain version, and the autograd
    Function's backward (torch ops) against autograd through the plain
    version on the same card tensors. expert_ffn on the capacity buffer
    [64, 4 x 64, 2048] x 1408; topk_gate at T = 2048, E = 64, K = 6."""
    import torch
    from repro_torch.kernels.expert_ffn import (ExpertFFN,
                                                expert_ffn_backward,
                                                expert_ffn_cuda,
                                                expert_ffn_plain)
    from repro_torch.kernels.topk_gate import (TopkGate, topk_gate_cuda,
                                               topk_gate_plain)
    e_n, k_n, d_n, f_n, tau = 64, 6, 2048, 1408, 0.2
    out = {"phase": "kernels", "kernel": "train_grads", "tol": GRAD_RTOL}
    # ---- expert_ffn -------------------------------------------------------
    x, filled = _train_capacity_buffer(gen, e_n, k_n, d_n, dev)
    ws = _ffn_weights(gen, e_n, d_n, f_n, dev, torch.float32)
    dy = torch.randn(x.shape, generator=gen).to(dev)
    got, want = expert_ffn_cuda(x, *ws), expert_ffn_plain(x, *ws)
    fwd_err = max_err(got, want)
    require(fwd_err <= TOL_F32 * (1 + float(want.abs().max())),
            f"train_grads: expert_ffn forward err {fwd_err}")
    del got, want
    grads = []
    for fn in (lambda *a: ExpertFFN.apply(expert_ffn_cuda, *a),
               expert_ffn_plain):
        leaves = [t.detach().requires_grad_(True) for t in (x, *ws)]
        fn(*leaves).backward(dy)
        grads.append([t.grad for t in leaves])
    rel = {nm: _grad_rel(g, w) for nm, g, w in
           zip(("dx", "dw1", "dw3", "dw2"), *grads)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads[0])
    del grads
    c_n = x.shape[1]
    mm = 2 * e_n * c_n * d_n * f_n               # one [C, D] x [D, F] product
    n_rows, n_live = live_rows(x)                 # what the forward computes
    fwd_b = bound(nbytes(x, x) + nbytes(*ws) * n_live // e_n,
                  3 * 2 * n_rows * d_n * f_n)
    bwd_b = bound(nbytes(x, *ws, dy) + nbytes(x, *ws), 8 * mm)
    leaves = [t.detach().requires_grad_(True) for t in (x, *ws)]
    y_plain = expert_ffn_plain(*leaves)
    ffn = {"shape": list(x.shape) + [f_n], "filled_rows": filled,
           "forward_max_abs_err": fwd_err,
           **ffn_plan(x, e_n, f_n, (x, *ws)),
           "forward_ms": time_ms(lambda: expert_ffn_cuda(x, *ws), reps=10),
           "forward_plain_ms": time_ms(lambda: expert_ffn_plain(x, *ws),
                                       reps=10),
           "forward_bound_ms": fwd_b[0], "forward_bound_by": fwd_b[1],
           "backward_ms": time_ms(lambda: expert_ffn_backward(x, *ws, dy),
                                  reps=10),
           "backward_plain_autograd_ms": time_ms(
               lambda: torch.autograd.grad(y_plain, leaves, dy,
                                           retain_graph=True), reps=10),
           "backward_bound_ms": bwd_b[0], "backward_bound_by": bwd_b[1],
           "grad_rel_err": rel, "grads_finite": finite}
    del y_plain, leaves, x, ws, dy
    torch.cuda.empty_cache()
    out["expert_ffn"] = ffn
    # ---- topk_gate --------------------------------------------------------
    t_n = TRAIN_ROWS * TRAIN_SEQ
    z = torch.randn(t_n, e_n, generator=gen).to(dev)
    g_v, g_p = (torch.randn(t_n, k_n, generator=gen).to(dev)
                for _ in range(2))
    got, want = topk_gate_cuda(z, tau, k=k_n), topk_gate_plain(z, tau, k=k_n)
    require(torch.equal(got[0], want[0]) and torch.equal(got[4], want[4]),
            "train_grads: topk_gate indices or gate differ")
    gate_err = max(max_err(g, w) for g, w in zip(got[1:4], want[1:4]))
    require(gate_err <= TOL_GATE, f"train_grads: topk_gate err {gate_err}")
    grads = []
    for fn in (lambda a: TopkGate.apply(topk_gate_cuda, a, tau, k_n),
               lambda a: topk_gate_plain(a, tau, k=k_n)):
        a = z.detach().requires_grad_(True)
        _, vals, probs, _, _ = fn(a)
        (torch.sum(vals * g_v) + torch.sum(probs * g_p)).backward()
        grads.append(a.grad)
    gb = bound(nbytes(z, *got), t_n * e_n * k_n)
    out["topk_gate"] = {
        "T": t_n, "E": e_n, "K": k_n, "forward_max_abs_err": gate_err,
        "grad_rel_err": _grad_rel(*grads),
        "forward_ms": time_ms(lambda: topk_gate_cuda(z, tau, k=k_n),
                              inner=10),
        "forward_plain_ms": time_ms(lambda: topk_gate_plain(z, tau, k=k_n),
                                    inner=10),
        "forward_bound_ms": gb[0], "forward_bound_by": gb[1]}
    emit(out)
    require(finite and max(rel.values()) <= GRAD_RTOL,
            f"train_grads: expert_ffn gradients differ: {ffn}")
    require(out["topk_gate"]["grad_rel_err"] <= GRAD_RTOL,
            f"train_grads: topk_gate gradient differs: {out['topk_gate']}")
    return out


def kernel_quant_ffn(dev, gen):
    import torch
    from repro_torch.kernels.quant_ffn import quant_ffn_cuda, quant_ffn_plain
    e_n, k_n, t_n, d_n, f_n = 64, 6, 4, 2048, 1408
    quant = _replicas(*_ffn_weights(gen, e_n, d_n, f_n, dev, torch.float32))
    x_tok = torch.randn(t_n, d_n, generator=gen)
    rows = {}
    # "path": the gather tier step's call (4 degraded slots over 3-4 live
    # experts); "chunk": the capacity branch of a continuous chunk step (run
    # (b)): 4 slots x 8 tokens, half of the 192 routed slots degraded,
    # binned by expert into [E, T*K, D] with counts
    x_chunk = torch.randn(32, d_n, generator=gen)
    for name, c_n in (("decode", t_n * k_n), ("full", 32),
                      ("chunk", 32 * k_n), ("path", t_n * k_n)):
        if name == "path":
            buf, counts = _degraded_path(gen, x_tok, e_n, k_n, dev)
        elif name != "full":
            # the degraded slots binned by expert, as _degraded_outputs does
            buf, counts = _binned(gen, x_tok if name == "decode" else x_chunk,
                                  e_n, k_n, c_n,
                                  1.0 if name == "decode" else 0.5, dev)
            buf, counts = buf[e_n:], counts[e_n:]
        else:
            buf = torch.randn(e_n, c_n, d_n, generator=gen).to(dev)
            counts = None
        got = quant_ffn_cuda(buf, *quant, counts)
        want = quant_ffn_plain(buf, *quant, counts)
        err = max_err(got, want)
        require(err <= TOL_F32 * (1 + float(want.abs().max())),
                f"quant_ffn {name}: err {err}")
        live = (torch.full((e_n,), c_n) if counts is None
                else counts.cpu())
        n_live, filled = int((live > 0).sum()), int(live.sum())
        # data-dependent: the live experts' int8 weights and f32 scales,
        # the filled rows in, the whole output out
        moved = (n_live * (3 * d_n * f_n + (2 * f_n + d_n) * 4)
                 + filled * d_n * 4 + nbytes(got)
                 + (0 if counts is None else nbytes(counts)))
        b_ms, b_by = bound(moved, 2 * filled * d_n * f_n * 3)
        rows[name] = {"max_abs_err": err,
                      "max_abs_plain": float(want.abs().max()),
                      "live_experts": n_live, "filled_rows": filled,
                      **ffn_plan(buf, e_n, f_n, (buf, *quant[::2]),
                                 fp=False, int8=True),
                      # 10 calls back to back: one call's events time the
                      # wrapper's host work, longer than the kernels' here
                      "ms": time_ms(lambda: quant_ffn_cuda(buf, *quant,
                                                           counts), inner=10),
                      "plain_ms": time_ms(lambda: quant_ffn_plain(
                          buf, *quant, counts)),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                      **device_us(lambda: quant_ffn_cuda(buf, *quant, counts),
                                  by_op=True)}
        rows[name].update(ffn_rate(moved, rows[name]["ms"], b_ms))
    # bf16 activations and ragged shapes (up to 63 zero-filled rows of a
    # 64-deep stage): correctness only
    for (e, c, d, f) in ((3, 37, 200, 136), (2, 1, 40, 24), (5, 70, 64, 33)):
        qs = _replicas(*_ffn_weights(gen, e, d, f, dev, torch.float32))
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, 5e-2)):
            xs = torch.randn(e, c, d, generator=gen).to(dt).to(dev)
            e2 = max_err(quant_ffn_cuda(xs, *qs), quant_ffn_plain(xs, *qs))
            require(e2 <= tol, f"quant_ffn {dt} {(e, c, d, f)}: err {e2}")
    emit({"phase": "kernels", "kernel": "quant_ffn",
          "shape": [e_n, "C", d_n, f_n], "by_case": rows})
    return rows["decode"]


def _replicas(w1, w3, w2):
    """The port's per-output-channel int8 replicas, as the kernels take
    them."""
    from repro_torch.core.quantize import quantize_expert_ffn
    from repro_torch.kernels.quant_ffn import quant_operands
    return quant_operands(quantize_expert_ffn(w1, w3, w2, 8))


def _degraded_path(gen, x_tok, e_n, k_n, dev):
    """A decode step's 4 degraded slots over 3 or 4 distinct experts,
    binned by true expert into [E, T*K, D] with counts by the gather
    branch's own binning (models/moe.py _degraded_outputs)."""
    import torch
    from repro_torch.models.moe import _bin, _bin_slots
    t_n, d_n = x_tok.shape
    n = t_n * k_n
    s = _route_slots(gen, t_n, e_n, k_n, "cpu").reshape(-1).long()
    while True:
        deg = torch.zeros(n, dtype=torch.bool)
        deg[torch.randperm(n, generator=gen)[:4]] = True
        if s[deg].unique().numel() >= 3:
            break
    grp = torch.where(deg, s, e_n).to(dev)
    flat, _, counts, _ = _bin_slots(grp, e_n, n)
    xr = x_tok.to(dev).repeat_interleave(k_n, 0)
    return _bin(xr, flat, e_n * n).view(e_n, n, d_n), counts


def _binned(gen, x_tok, e_n, k_n, c_n, deg_frac, dev):
    """Bin T tokens' K routed slots into [2E, C, D] like the fused path;
    a share of the slots goes to the degraded half. Returns (buf, counts)."""
    import torch
    t_n, d_n = x_tok.shape
    s = _route_slots(gen, t_n, e_n, k_n, "cpu").long()
    deg = torch.rand(t_n, k_n, generator=gen) < deg_frac
    grp = torch.where(deg, s + e_n, s).reshape(-1)
    counts = torch.bincount(grp, minlength=2 * e_n)
    pos = torch.zeros_like(grp)
    seen = torch.zeros(2 * e_n, dtype=torch.long)
    for i, g in enumerate(grp.tolist()):
        pos[i] = seen[g]
        seen[g] += 1
    buf = torch.zeros(2 * e_n, c_n, d_n, dtype=x_tok.dtype, device=dev)
    buf[grp.to(dev), pos.to(dev)] = x_tok.to(dev).repeat_interleave(k_n, 0)
    return buf, counts.to(torch.int32).to(dev)


def kernel_grouped_ffn(dev, gen):
    import torch
    from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,
                                                 grouped_ffn_plain)
    e_n, k_n, t_n, d_n, f_n = 64, 6, 4, 2048, 1408
    c_n = t_n * k_n
    w1, w3, w2 = _ffn_weights(gen, e_n, d_n, f_n, dev, torch.float32)
    rows = {}
    # decode: 4 tokens; chunk_t32 / chunk_t512: the continuous phase's
    # fused chunk steps (runs (a) and (c)), T = 4 slots x 8 or x 128
    # tokens at the dropless cap T*K
    for name, tokens, deg_frac, reps in (("decode", t_n, 0.0, 20),
                                         ("decode_int8", t_n, 0.4, 20),
                                         ("chunk_t32", 32, 0.0, 20),
                                         ("chunk_t512", 512, 0.0, 5)):
        x_tok = torch.randn(tokens, d_n, generator=gen)
        buf, counts = _binned(gen, x_tok, e_n, k_n, tokens * k_n, deg_frac,
                              dev)
        quant = _replicas(w1, w3, w2) if deg_frac else None
        got = grouped_ffn_cuda(buf, w1, w3, w2, quant, counts)
        want = grouped_ffn_plain(buf, w1, w3, w2, quant, counts)
        err = max_err(got, want)
        require(err <= TOL_F32 * (1 + float(want.abs().max())),
                f"grouped_ffn {name}: err {err}")
        live = counts.cpu()
        n_fp = int((live[:e_n] > 0).sum())
        n_deg = int((live[e_n:] > 0).sum())
        filled = int(live.sum())
        # data-dependent: only the live groups' weights (int8 replicas
        # plus their f32 scales for the degraded half) and filled rows
        moved = (n_fp * 3 * d_n * f_n * 4
                 + n_deg * (3 * d_n * f_n + (2 * f_n + d_n) * 4)
                 + filled * d_n * 4 + nbytes(got, counts))
        b_ms, b_by = bound(moved, 2 * filled * d_n * f_n * 3)
        copied = (buf, w1, w3, w2) + (quant[::2] if quant else ())
        rows[name] = {"cap": buf.shape[1], "filled_rows": filled,
                      "max_abs_err": err,
                      "max_abs_plain": float(want.abs().max()),
                      "live_fp": n_fp, "live_deg": n_deg,
                      **ffn_plan(buf, 2 * e_n, f_n, copied,
                                 int8=quant is not None),
                      "ms": time_ms(lambda: grouped_ffn_cuda(
                          buf, w1, w3, w2, quant, counts), reps),
                      "plain_ms": time_ms(lambda: grouped_ffn_plain(
                          buf, w1, w3, w2, quant, counts), reps),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows[name].update(ffn_rate(moved, rows[name]["ms"], b_ms))
    # the row sweep: 22 live fp groups (the decode case's count) with the
    # same rows each; the weight bytes stay, the FMA work follows the rows
    sweep = {}
    for r in (1, 3, 8):
        counts = torch.zeros(2 * e_n, dtype=torch.int32)
        counts[:22] = r
        buf = torch.zeros(2 * e_n, c_n, d_n)
        buf[:22, :r] = torch.randn(22, r, d_n, generator=gen)
        buf, counts = buf.to(dev), counts.to(dev)
        want = grouped_ffn_plain(buf, w1, w3, w2, None, counts)
        err = max_err(grouped_ffn_cuda(buf, w1, w3, w2, None, counts), want)
        require(err <= TOL_F32 * (1 + float(want.abs().max())),
                f"grouped_ffn sweep {r} rows: err {err}")
        moved = 22 * (3 * d_n * f_n + r * d_n) * 4 + nbytes(buf, counts)
        b_ms, b_by = bound(moved, 2 * 22 * r * d_n * f_n * 3)
        ms = time_ms(lambda: grouped_ffn_cuda(buf, w1, w3, w2, None, counts))
        sweep[r] = {"max_abs_err": err, "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by, **ffn_rate(moved, ms, b_ms)}
    emit({"phase": "kernels", "kernel": "grouped_ffn",
          "shape": [2 * e_n, "cap", d_n, f_n], "by_case": rows,
          "row_sweep_22_live_groups": sweep})
    return rows["decode"]


def kernel_wkv(dev, gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv_chunk import (stages, wkv_chunk_cuda,
                                               wkv_chunk_plain)
    from repro_torch.models.rwkv import random_chunk_operands
    rows = {}
    # the train phase's shape (B 4 x H 32 lanes, 512 tokens = 16 chunks of
    # 32, head dim 64), and head dim 128 (74.9 KB of dynamic shared memory)
    for name, (b, h, n, c, d) in (("train", (4, 32, 16, 32, 64)),
                                  ("d128", (2, 32, 8, 32, 128))):
        args = random_chunk_operands(gen, b, h, n, c, d, dev)
        got, want = wkv_chunk_cuda(*args), wkv_chunk_plain(*args)
        err = max(max_err(g, w) for g, w in zip(got, want))
        scale = 1 + max(float(w.abs().max()) for w in want)
        require(err <= TOL_F32 * scale, f"wkv_chunk {name}: err {err}")
        bh = b * h
        # per lane and chunk: r~ S and the state's k_end^T v (2 C D^2 each),
        # the strictly lower scores and their product with v (C(C-1) D
        # each), the diagonal term (2 C D) and the decay (2 D^2)
        flops = bh * n * (4 * c * d * d + 2 * c * (c - 1) * d + 2 * c * d
                          + 2 * d * d)
        b_ms, b_by = bound(nbytes(*args) + nbytes(*got), flops)
        dev_t = device_us(lambda: wkv_chunk_cuda(*args))
        rows[name] = {"shape": [bh, n, c, d], "stages": stages(c, d),
                      "max_abs_err": err, "max_abs_plain": scale - 1,
                      "sha256": hashlib.sha256(b"".join(
                          t.cpu().numpy().tobytes() for t in got)).hexdigest(),
                      "ms": time_ms(lambda: wkv_chunk_cuda(*args), inner=10),
                      **dev_t,
                      # of the kernel's own time (None: not measured)
                      "share_of_bound": dev_t["device_us"]
                      and b_ms / dev_t["device_us"] * 1e3,
                      "plain_ms": time_ms(lambda: wkv_chunk_plain(*args)),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    # the autograd backward (torch ops) on the card against the CPU's
    args = random_chunk_operands(gen, 4, 32, 16, 32, 64, "cpu")
    w_o = torch.randn(args[0].shape, generator=gen)
    w_s = torch.randn(args[-1].shape, generator=gen)
    grads = []
    for d in ("cpu", dev):
        a = [t.detach().to(d).requires_grad_(True) for t in args]
        o, s = ops.wkv_chunk(*a)
        (torch.sum(o * w_o.to(d)) + torch.sum(s * w_s.to(d))).backward()
        grads.append([t.grad.cpu() for t in a])
    bwd = {nm: max_err(gg, gc) / float(gc.abs().max())
           for nm, gc, gg in zip(("rt", "kt", "v", "ke", "lae", "dg", "s0"),
                                 *grads)}
    require(max(bwd.values()) <= GRAD_RTOL,
            f"wkv_chunk backward: card vs CPU {bwd}")
    emit({"phase": "kernels", "kernel": "wkv_chunk", "by_shape": rows,
          "backward_rel_err": bwd, "backward_rtol": GRAD_RTOL})
    return rows["train"]


ROUTE_EXACT = ("idx", "allow", "dist_ok", "new_idx", "substituted", "missed",
               "degraded", "peered", "dropped")
# (case, tier and peer masks, substitution on, beta): beta 1.1 opens the
# distribution gate; 0.5 lets the batch decide (at T = 4096 every expert is
# requested, so delta is the non-resident share itself)
ROUTE_CASES = (("masks", True, True, 1.1), ("no_masks", False, True, 0.5),
               ("subst_off", True, False, 1.1))
# at T = 4, 32 (a full cluster, each CTA with its own rows' statistics),
# 256 and 4096 (name, policy): cost mode with the degraded and peer costs
# (fetch stalls around the drop cost: every outcome occurs); Psi's eta and
# kappa terms (hop with the -1 sentinel) with the token gate's temperature
# 0.8 and margin 0.4
ROUTE_POLICY_T = (4, 32, 256, 4096)
# a cluster of one and of eight CTAs, the first T of the two-launch form
# (33) and the grid at the widths between
ROUTE_T = (4, 32, 33, 64, 128, 256, 512, 4096)
ROUTE_POLICY_CASES = ("cost", "eta_kappa")
VECTORS = ("quant_ok", "peer_ok", "hop", "fid_cost", "fetch_cost",
           "peer_cost")


def _route_bound(args, kw, got):
    """Bytes: logits, tables, masks and vectors read once, the outputs
    written once. Operations: the top-k's T*E*K compares, with eta the rows'
    mean and std (2*T*E), and Algorithm 1's H*K scan of each slot that
    searched (non-resident, its token past both gates; in cost mode every
    non-resident slot)."""
    z, _, _, resident, table, q = args
    vecs = [kw[m] for m in VECTORS if kw.get(m) is not None]
    t_n, e_n = z.shape
    k_n = got.idx.shape[1]
    searched = 0
    if kw["substitute"]:
        need = ~resident[got.idx.long()]
        if not kw.get("cost"):
            need &= (got.allow & got.dist_ok)[:, None]
        searched = int(need.sum())
    stats = 2 * t_n * e_n if kw.get("eta") else 0
    return bound(nbytes(z, resident, table, q, *vecs) + nbytes(*got),
                 t_n * e_n * k_n + stats + searched * kw["h"] * k_n)


def _route_policy(name, gen, e_n, dev) -> dict:
    """route's keyword arguments of ROUTE_POLICY_CASES entry ``name``."""
    import torch
    if name == "cost":
        fetch, fid, peer = (torch.rand(e_n, generator=gen) * 0.08
                            for _ in range(3))
        for c in (fid, peer):
            c[torch.rand(e_n, generator=gen) < 0.3] = float("inf")
        return dict(cost=True, fetch_cost=fetch.to(dev),
                    fid_cost=fid.to(dev), peer_cost=peer.to(dev),
                    stall_per_quality=0.05)
    hop = torch.randint(-1, 4, (e_n,), generator=gen, dtype=torch.int32)
    return dict(eta=0.5, kappa=0.2, hop=hop.to(dev), temperature=0.8,
                margin_gamma=0.4)


def kernel_route(dev, gen):
    """The routing kernel against route_plain, and at T = 4 against the
    path it replaced, timed in the same run."""
    import torch
    from repro_torch.core.gates import distribution_gate
    from repro_torch.core.substitute import split_degraded, split_peer
    from repro_torch.kernels.buddy_substitute import buddy_substitute_cuda
    from repro_torch.kernels.route import (Route, compiled_form, launch_plan,
                                           route_cuda, route_plain)
    from repro_torch.kernels.topk_gate import topk_gate_cuda

    def composed(z, tau, beta, resident, table, q, *, k, h, rho, substitute,
                 quant_ok, peer_ok):
        # models/moe.py before route: two launches, the distribution gate
        # and the splits in torch ops between and after them
        idx, vals, probs, tae, allow = topk_gate_cuda(z, tau, k=k)
        dist_ok = distribution_gate(idx, resident, beta)
        new_idx, sub, miss = buddy_substitute_cuda(
            idx, allow & dist_ok, resident, table, q, h=h, rho=rho)
        miss, deg = split_degraded(miss, new_idx, quant_ok)
        miss, peer = split_peer(miss, new_idx, peer_ok)
        return Route(idx, vals, probs, tae, allow, dist_ok, new_idx, sub,
                     miss, deg, peer, torch.zeros_like(miss))

    e_n, k_n, r_n, h, rho, tau = 64, 6, 8, 8, 3, 0.2
    by_t, old_path = {}, None
    pgen = torch.Generator().manual_seed(1)   # the policy cases' vectors
    for t_n in ROUTE_T:
        plan = launch_plan(t_n, k_n)
        require(compiled_form(t_n) == (plan.launches, plan.ctas),
                f"route T={t_n}: csrc/route.cu runs another form than "
                f"launch_plan's {plan}")
        z = torch.randn(t_n, e_n, generator=gen).to(dev)
        resident = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
        table, q = _buddy_tables(gen, e_n, r_n, dev)
        masks = {m: (torch.rand(e_n, generator=gen) < 0.4).to(dev)
                 for m in ("quant_ok", "peer_ok")}
        cases = {}
        todo = [(name, beta, dict(substitute=sub, **{
                    m: v if with_masks else None for m, v in masks.items()}))
                for name, with_masks, sub, beta in ROUTE_CASES]
        if t_n in ROUTE_POLICY_T:
            todo += [(name, 1.1, dict(masks, **_route_policy(name, pgen, e_n,
                                                              dev)))
                     for name in ROUTE_POLICY_CASES]
        for name, beta, policy in todo:
            args = (z, tau, beta, resident, table, q)
            kw = dict(k=k_n, h=h, rho=rho, **policy)
            kw.setdefault("substitute", True)
            got, want = route_cuda(*args, **kw), route_plain(*args, **kw)
            equal = all(torch.equal(getattr(got, f), getattr(want, f))
                        for f in ROUTE_EXACT)
            err = max(max_err(getattr(got, f), getattr(want, f))
                      for f in ("topk_logits", "probs", "tae"))
            require(equal, f"route T={t_n} {name}: an int or bool output "
                           "differs from route_plain")
            require(err <= TOL_GATE, f"route T={t_n} {name}: err {err}")
            b_ms, b_by = _route_bound(args, kw, got)
            cases[name] = {
                "max_abs_err": err, "ints_and_masks_equal": equal,
                "dist_ok": bool(got.dist_ok),
                "n_sub": int(got.substituted.sum()),
                "n_degraded": int(got.degraded.sum()),
                "n_peered": int(got.peered.sum()),
                "n_missed": int(got.missed.sum()),
                "n_dropped": int(got.dropped.sum()),
                "n_allowed": int(got.allow.sum()),
                "launches_per_call": plan.launches,
                "form": f"cluster of {plan.ctas}" if plan.ctas else "grid",
                "ms": time_ms(lambda: route_cuda(*args, **kw), inner=10),
                "plain_ms": time_ms(lambda: route_plain(*args, **kw),
                                    inner=10),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                **device_us(lambda: route_cuda(*args, **kw))}
            if t_n == 4 and name == "masks":
                old = composed(*args, **kw)
                require(all(torch.equal(getattr(old, f), getattr(got, f))
                            for f in ROUTE_EXACT + ("probs", "tae")),
                        "route T=4: the replaced path gives other outputs")
                old_path = {"ms": time_ms(lambda: composed(*args, **kw),
                                          inner=10),
                            **device_us(lambda: composed(*args, **kw))}
        if t_n == ROUTE_POLICY_T[-1]:
            c = cases["cost"]
            require(c["n_sub"] and c["n_degraded"] and c["n_peered"]
                    and c["n_dropped"], f"route T={t_n} cost: an outcome "
                                        f"never won: {c}")
        by_t[t_n] = cases
    emit({"phase": "kernels", "kernel": "route", "E": e_n, "K": k_n,
          "R": r_n, "H": h, "rho": rho, "tau": tau, "by_T": by_t,
          "replaced_path_T4": old_path})
    return by_t[4]["masks"]


# ---------------------------------------------------------------------------
def _ffn_case(name, fn, plain, args, moved: float, flops: float,
              reps: int = 20, inner: int = 1) -> dict:
    """One FFN call against its plain version on the same operands: error
    (within TOL_F32 x (1 + the plain output's largest entry)), times, the
    device's own time, the plain version's device ops, and the bound of
    ``moved`` bytes and ``flops``."""
    got, want = fn(*args), plain(*args)
    err, top = max_err(got, want), float(want.abs().max())
    require(err <= TOL_F32 * (1 + top),
            f"{name} at {tuple(args[0].shape)}: err {err}")
    b_ms, b_by = bound(moved, flops)
    ms = time_ms(lambda: fn(*args), reps, inner)
    return {"shape": list(args[0].shape), "max_abs_err": err,
            "max_abs_plain": top, "ms": ms,
            "plain_ms": time_ms(lambda: plain(*args), reps),
            "plain_ops": device_ops(lambda: plain(*args)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            **ffn_rate(moved, ms, b_ms), **device_us(lambda: fn(*args))}


def kernel_mixtral(dev, gen):
    """The FFN kernels and route at Mixtral-8x7B's shapes (8 experts, top-2,
    d_model 4096, d_ff 14336, f32; weights random on the card): expert_ffn
    on the capacity branch's decode buffer (4 rows x cap 2 = [8, 8, 4096])
    and a chunk-8 step's dropless one ([8, 4 x 16, 4096]); grouped_ffn on
    a fused decode step's [16, 8, 4096] with row counts; quant_ffn on the
    int8 tier's degraded half of a decode step's slots, binned by expert
    into [8, 8, 4096] with counts; route at E = 8, K = 2, R = 7, T = 4 and
    32, with the tier's mask. Each bound counts the live groups' weights
    and the filled rows: expert_ffn's from x, whose zero rows it skips,
    the others' from their row counts."""
    import torch
    from repro_torch.kernels.expert_ffn import expert_ffn_cuda, expert_ffn_plain
    from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,
                                                 grouped_ffn_plain)
    from repro_torch.kernels.quant_ffn import quant_ffn_cuda, quant_ffn_plain
    from repro_torch.kernels.route import route_cuda, route_plain
    e_n, k_n, d_n, f_n, t_n = 8, 2, 4096, 14336, 4
    wgen = torch.Generator(device=dev).manual_seed(8)
    w1, w3, w2 = (torch.randn(e_n, a, b, generator=wgen, device=dev)
                  .mul_(0.02) for a, b in ((d_n, f_n), (d_n, f_n),
                                           (f_n, d_n)))
    w_bytes = nbytes(w1, w3, w2)
    out = {"phase": "kernels", "kernel": "mixtral_shapes", "E": e_n,
           "K": k_n, "D": d_n, "F": f_n, "weight_bytes": w_bytes}
    rows = {}
    for name, tokens in (("decode", t_n), ("chunk8", 4 * 8)):
        x = _capacity_binned(gen, torch.randn(tokens, d_n, generator=gen), 4,
                             e_n, k_n, dev)
        n_rows, n_live = live_rows(x)
        rows[name] = dict(_ffn_case(
            "expert_ffn", expert_ffn_cuda, expert_ffn_plain, (x, w1, w3, w2),
            nbytes(x) * 2 + n_live * w_bytes // e_n,
            2 * n_rows * d_n * f_n * 3), live_rows=n_rows,
            live_experts=n_live, **ffn_plan(x, e_n, f_n, (x, w1, w3, w2)))
    out["expert_ffn"] = rows
    buf, counts = _binned(gen, torch.randn(t_n, d_n, generator=gen), e_n,
                          k_n, t_n * k_n, 0.0, dev)
    live = counts.cpu()
    n_live, filled = int((live > 0).sum()), int(live.sum())
    out["grouped_ffn"] = {"decode": dict(_ffn_case(
        "grouped_ffn", lambda *a: grouped_ffn_cuda(*a, None, counts),
        lambda *a: grouped_ffn_plain(*a, None, counts), (buf, w1, w3, w2),
        n_live * w_bytes // e_n + filled * d_n * 4 + nbytes(buf, counts),
        2 * filled * d_n * f_n * 3),
        live_groups=n_live, filled_rows=filled,
        **ffn_plan(buf, 2 * e_n, f_n, (buf, w1, w3, w2)))}
    quant = _replicas(w1, w3, w2)
    buf, counts = _binned(gen, torch.randn(t_n, d_n, generator=gen), e_n,
                          k_n, t_n * k_n, 0.5, dev)
    buf, counts = buf[e_n:].contiguous(), counts[e_n:].contiguous()
    live = counts.cpu()
    n_live, filled = int((live > 0).sum()), int(live.sum())
    require(filled > 0, "quant_ffn at Mixtral's width: no degraded slot")
    out["quant_ffn"] = {"decode_degraded": dict(_ffn_case(
        "quant_ffn", lambda *a: quant_ffn_cuda(*a, counts),
        lambda *a: quant_ffn_plain(*a, counts), (buf, *quant),
        n_live * (3 * d_n * f_n + (2 * f_n + d_n) * 4) + filled * d_n * 4
        + nbytes(buf) + nbytes(counts), 2 * filled * d_n * f_n * 3,
        inner=10), live_experts=n_live, filled_rows=filled,
        **ffn_plan(buf, e_n, f_n, (buf, *quant[::2]), fp=False, int8=True))}
    del quant, w1, w3, w2
    r_n, tau, beta = 7, 0.2, 1.1
    by_t = {}
    for t in (t_n, 4 * 8):
        z = torch.randn(t, e_n, generator=gen).to(dev)
        resident = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
        table, q = _buddy_tables(gen, e_n, r_n, dev)
        quant_ok = (torch.rand(e_n, generator=gen) < 0.5).to(dev)
        args = (z, tau, beta, resident, table, q)
        kw = dict(k=k_n, h=8, rho=3, substitute=True, quant_ok=quant_ok)
        got, want = route_cuda(*args, **kw), route_plain(*args, **kw)
        require(all(torch.equal(getattr(got, f), getattr(want, f))
                    for f in ROUTE_EXACT),
                f"route at E={e_n}, K={k_n}, T={t}: an int or bool output "
                "differs from route_plain")
        err = max(max_err(getattr(got, f), getattr(want, f))
                  for f in ("topk_logits", "probs", "tae"))
        require(err <= TOL_GATE, f"route at E={e_n}, T={t}: err {err}")
        b_ms, b_by = _route_bound(args, kw, got)
        by_t[t] = {"max_abs_err": err, "ints_and_masks_equal": True,
                   "n_sub": int(got.substituted.sum()),
                   "n_degraded": int(got.degraded.sum()),
                   "n_missed": int(got.missed.sum()),
                   "ms": time_ms(lambda: route_cuda(*args, **kw), inner=10),
                   "plain_ms": time_ms(lambda: route_plain(*args, **kw),
                                       inner=10),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   **device_us(lambda: route_cuda(*args, **kw))}
    out["route"] = by_t
    emit(out)
    return out


# ---------------------------------------------------------------------------
def _fixture_model(device) -> tuple:
    """The committed profiling fixture on ``device``: (cfg, params, buddy
    tables, activity to rank the tier's coverage (None: the store's
    default), 4 x 8 prompt tokens)."""
    from repro_torch.checkpoint.io import load_npz
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.core.buddies import load_tables
    from repro_torch.training.data import MarkovLM
    cfg = profiling()
    return (cfg, load_npz(str(FIXTURE / "model.npz"), device),
            load_tables(str(FIXTURE / "tables_a0.95_k16.npz")), None,
            MarkovLM(cfg.vocab_size, seed=0).sample(4, 8))


@functools.cache
def _reduced_mixtral_cpu() -> tuple:
    """Reduced Mixtral (window 128), made once on the CPU: weights from
    seed 0, the launcher's buddy profile and activity, 4 x 124 prompt
    tokens (prompt + 8 new tokens pass the window)."""
    import torch
    from repro_torch.configs.base import get_reduced
    from repro_torch.launch.serve import profile_buddies
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    cfg = get_reduced("mixtral-8x7b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    tables, rec = profile_buddies(cfg, params,
                                  MarkovLM(cfg.vocab_size, seed=0))
    return (cfg, params, tables, rec.A,
            MarkovLM(cfg.vocab_size, seed=3).sample(4, 124))


def _reduced_mixtral(device) -> tuple:
    """_reduced_mixtral_cpu with the weights copied to ``device``."""
    from repro_torch.models.common import tree_map
    cfg, params, tables, activity, prompts = _reduced_mixtral_cpu()
    return (cfg, tree_map(lambda t: t.to(device, copy=True), params),
            tables, activity, prompts)


MODELS = {"fixture": _fixture_model, "mixtral": _reduced_mixtral}


def _fixture_run(device, fused: bool, tier: bool = False, paged=False,
                 n_devices: int = 1, model: str = "fixture", **policy):
    """Serve ``model`` (a key of MODELS; by default the committed profiling
    fixture), with the int8 tier when asked for, on a simulated mesh of
    ``n_devices``, and ``policy``'s further BuddyPolicy fields: 8 new
    tokens after the model's prompts. Returns (tokens, summary, per-step
    logits). ``paged`` (the fixture): paged KV in 8-token blocks with
    the prefix cache, serving six requests on a 20-token shared prefix
    through the continuous scheduler (2 slots, chunks of 4), so that
    later arrivals adopt it and copy its tail block on write."""
    import numpy as np
    import torch
    from repro_torch.core.policy import BuddyPolicy
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.runtime.prefetch import PrevStepPredictor
    from repro_torch.runtime.tiers import TieredExpertStore
    from repro_torch.serving.engine import ServeEngine
    cfg, params, tables, activity, prompts = MODELS[model](device)
    n_moe, e_n = cfg.num_layers, cfg.moe.num_experts
    store = None
    if tier:
        # half coverage: the fixture's cache keeps 15 full slots, so hits,
        # buddies, fetches and degraded slots all occur
        store = TieredExpertStore(n_moe, e_n, 0.5, bits=8, coverage=0.5,
                                  d_model=cfg.d_model, d_ff=cfg.moe.d_ff)
        if activity is not None:
            store.set_coverage(activity)
        cache = store.cache
    else:
        cache = ExpertCache(n_moe, e_n, 0.5)
    eng = ServeEngine(cfg, params, tables=tables,
                      policy=BuddyPolicy(use_fused_dispatch=fused,
                                         quant_tier="int8" if tier else "off",
                                         **policy),
                      cache=None if tier else cache, tier=store,
                      predictor=PrevStepPredictor(n_moe, e_n),
                      prefetch_k=max(1, cache.capacity // 2),
                      paged_kv=paged, kv_block=8, prefix_cache=paged,
                      n_devices=n_devices)
    logits = []
    if paged:
        from repro_torch.serving import scheduler as S
        rng = np.random.default_rng(13)
        base = rng.integers(0, cfg.vocab_size, 20)
        reqs = S.make_requests(
            [np.concatenate([base, rng.integers(0, cfg.vocab_size, n)])
             for n in (4, 6, 13, 5, 9, 3)],
            S.ReplayArrivals([0.0, 0.0, 0.03, 0.035, 0.04, 0.045]), 4)
        sample = eng.sample_tokens

        def sampled(lg, *a, **kw):
            logits.append(lg.detach().cpu())
            return sample(lg, *a, **kw)

        eng.sample_tokens = sampled
        S.ContinuousScheduler(eng, slots=2, prefill_chunk=4).run(
            S.RequestQueue(reqs))
        return (np.concatenate([r.tokens for r in reqs]), eng.summary(),
                torch.stack(logits))
    step = eng.step

    def logged(*a, **kw):
        out = step(*a, **kw)
        logits.append(out[0].detach().cpu())
        return out

    eng.step = logged
    toks = eng.generate(prompts, 8)
    return toks, eng.summary(), torch.stack(logits)


def _tier_counters_equal(a: dict, b: dict) -> bool:
    """Tier summaries agree: counters and budget exactly, the mean
    fidelity loss to FID_RTOL (f32 sums in another order on the card)."""
    fa, fb = a.pop("mean_fidelity_loss"), b.pop("mean_fidelity_loss")
    return a == b and abs(fa - fb) <= FID_RTOL * abs(fa)


# (tag, fused, tier, policy): cost mode as tests/test_torch_engine.py
# (cost_fused: a quality price low enough that buddies and drops beat
# fetches) and tests/test_torch_tier_engine.py (cost_upgrade_gather, whose
# engine upgrades degraded slots) configure it; the mixtral_ cases serve
# reduced Mixtral (window 128) past its window, decode on the capacity
# branch or fused
PARITY_CASES = (
    ("fused", True, False, {}), ("gather", False, False, {}),
    ("fused_int8", True, True, {}), ("gather_int8", False, True, {}),
    ("cost_fused", True, False, dict(miss_policy="cost",
                                     stall_per_quality=2e-4)),
    ("cost_gather_int8", False, True, dict(miss_policy="cost",
                                           stall_per_quality=0.05)),
    ("paged_prefix", True, True, dict(paged=True)),
    ("mixtral_capacity", False, False, dict(model="mixtral")),
    ("mixtral_fused", True, False, dict(model="mixtral")),
    ("mixtral_capacity_int8", False, True, dict(model="mixtral")),
    ("mixtral_fused_int8", True, True, dict(model="mixtral")))


def phase_parity():
    import numpy as np
    from repro_torch.kernels import ops
    out = {"phase": "parity"}
    for tag, fused, tier, policy in PARITY_CASES:
        t0 = time.perf_counter()
        policy = dict(policy)
        paged = policy.pop("paged", False)
        model = policy.pop("model", "fixture")
        before = ops.launch_counts()
        t_cpu, s_cpu, l_cpu = _fixture_run("cpu", fused, tier, paged,
                                           model=model, **policy)
        require(ops.launch_counts() == before, "CPU run launched a kernel")
        t_gpu, s_gpu, l_gpu = _fixture_run("cuda", fused, tier, paged,
                                           model=model, **policy)
        err = max_err(l_gpu, l_cpu)
        st = s_gpu["stats"]
        out[tag] = {"seconds": time.perf_counter() - t0,
                    "tokens_equal": bool(np.array_equal(t_cpu, t_gpu)),
                    "stats_equal": s_cpu["stats"] == st,
                    "ledger_equal": s_cpu["ledger"] == s_gpu["ledger"],
                    "cost_policy_equal": s_cpu.get("cost_policy")
                    == s_gpu.get("cost_policy"),
                    "logits_max_abs_err": err, "logits_tol": LOGIT_TOL,
                    "n_sub": st["n_sub"], "n_hit": st["n_hit"],
                    "n_miss_fetch": st["n_miss_fetch"],
                    "n_miss_drop": st["n_miss_drop"],
                    "n_upgrade_issued": st["n_upgrade_issued"]}
        ok = all(out[tag][k] for k in ("tokens_equal", "stats_equal",
                                       "ledger_equal", "cost_policy_equal"))
        if tier:
            out[tag]["degraded_tokens"] = s_gpu["tier"]["degraded_tokens"]
            out[tag]["tier_equal"] = _tier_counters_equal(s_cpu["tier"],
                                                          s_gpu["tier"])
            ok = ok and out[tag]["tier_equal"]
            require(out[tag]["degraded_tokens"] > 0,
                    f"parity ({tag}): the tier served no slot")
        if paged:
            px = s_gpu["prefix"]
            out[tag]["prefix_equal"] = s_cpu["prefix"] == px
            out[tag]["prefix"] = px
            ok = ok and out[tag]["prefix_equal"]
            require(px["hits"] > 0 and px["pool"]["cow_copies"] > 0,
                    f"parity ({tag}): no prefix hit or copy-on-write")
        if policy:
            require(st["n_miss_drop"] + st["n_miss_fetch"] > 0,
                    f"parity ({tag}): no slot was dropped or fetched")
            require(not tier or st["n_upgrade_issued"] > 0,
                    f"parity ({tag}): no degraded slot was upgraded")
        require(ok, f"parity ({tag}): CPU and card disagree: {out[tag]}")
        require(err <= LOGIT_TOL, f"parity ({tag}): logits err {err}")
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the claims phase: tests/test_system.py's claims (the twin is
# tests/test_torch_system.py), on the fixture CPU vs card, then the offline
# pipeline and the policies at full width
CLAIM_POLICY = dict(tau=0.05, beta=1.1, rho=6, H=16, fallback="drop")
CLAIM_SERVE = {"buddy": dict(tau=0.0, beta=1.1, rho=6, H=16),
               "none": dict(mode="none")}
CLAIM_GATES = {"tau_1": dict(tau=1.0, beta=1.1, rho=6, H=16),
               "beta_0": dict(tau=0.0, beta=0.0, rho=6, H=16)}
CLAIM_TRIALS = 3
CLAIM_B, CLAIM_S = 8, 48           # the agreement batch
AGREE_TOL = 1.0 / (CLAIM_B * CLAIM_S)   # one token of B x S
ERR_TOL = 1e-5                     # substitute errors ~1, CPU vs card: f32
#                                    matmuls in another order
TPS_RTOL = 1e-6                    # the modeled clock, CPU vs card
# tests/test_system.py's draws from one MarkovLM(seed=11), in its order
CLAIM_STREAM = (("sims", (4, 64)), ("errs", (2, 64)),
                ("agree", (CLAIM_B, CLAIM_S)), ("serve_buddy", (2, 4)),
                ("serve_none", (2, 4)), ("gates", (2, 16)))


def _residency_draws(seed: int, l_n: int, e_n: int, trials: int) -> list:
    """``trials`` residency masks [L, E], half of each layer's experts."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(trials):
        resident = np.zeros((l_n, e_n), bool)
        for l in range(l_n):
            resident[l, rng.choice(e_n, e_n // 2, replace=False)] = True
        out.append(resident)
    return out


def _tiled_random_table(l_n: int, e_n: int, r_max: int = 16):
    """core.make_random_table (a CPU generator, seed 7) tiled over the
    layers: (table [L, E, R], q) numpy."""
    import numpy as np
    import torch
    from repro_torch.core import make_random_table
    t, q = make_random_table(e_n, r_max,
                             generator=torch.Generator().manual_seed(7))
    return (np.tile(t.numpy()[None], (l_n, 1, 1)),
            np.tile(q.numpy()[None], (l_n, 1, 1)))


def _policy_forward(params, cfg, toks, policy, resident, table, q,
                    record=False):
    """forward_train with ``policy`` over BuddyState(resident, table, q)
    (numpy) on the params' device: (logits, aux)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.moe import BuddyState
    dev = params["embed"].device
    l_n, e_n = resident.shape
    bud = BuddyState(torch.from_numpy(resident).to(dev),
                     torch.from_numpy(table).to(dev),
                     torch.from_numpy(q).to(dev),
                     torch.zeros((l_n, e_n), dtype=torch.int32, device=dev))
    with torch.no_grad():
        return transformer.forward_train(params, cfg, toks, policy=policy,
                                         buddies=bud, record=record)


def _agreement_runs(params, cfg, toks, top1, runs, record=False) -> dict:
    """{(name, trial): (agreement, n_sub, substituted masks)}: ``runs`` maps
    a name to (BuddyPolicy, table, q), each over the residency draws of
    tests/test_system.py (seed 1)."""
    l_n, e_n = next(iter(runs.values()))[1].shape[:2]
    out = {}
    for name, (pol, tab, q) in runs.items():
        for trial, resident in enumerate(_residency_draws(1, l_n, e_n,
                                                          CLAIM_TRIALS)):
            logits, aux = _policy_forward(params, cfg, toks, pol, resident,
                                          tab, q, record=record)
            require(bool(logits.isfinite().all()),
                    f"claims: non-finite logits under {name}")
            subs = (aux["recorded"][0]["substituted"].cpu().numpy()
                    if record else None)
            out[name, trial] = (
                float((logits.argmax(-1).cpu().numpy() == top1).mean()),
                int(aux["n_sub"]), subs)
    return out


def _mean_agreement(agree: dict, name: str) -> float:
    import numpy as np
    return float(np.mean([agree[name, t][0] for t in range(CLAIM_TRIALS)]))


def _claims_fixture(device) -> dict:
    """Claims 3-6 of tests/test_system.py on the committed fixture on
    ``device``, under the committed CFT tables and the tables the
    reference's test builds (co-activation and output similarity, the
    similarity computed here): substitute errors, teacher-forced agreement
    (buddy, the port's random table, mode "random" on it, drop, none),
    ServeEngine buddy against mode "none", and the gates."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.io import load_npz
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.core import (DROP, ORIGINAL, BuddyPolicy, BuddyTables,
                                  CoactivationRecorder, build_buddy_lists,
                                  load_tables)
    from repro_torch.core.similarity import (all_layer_similarities,
                                             collect_layer_inputs)
    from repro_torch.models import transformer
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import MarkovLM
    cfg = profiling()
    l_n, e_n = cfg.num_layers, cfg.moe.num_experts
    params = load_npz(str(FIXTURE / "model.npz"), device)
    lm = MarkovLM(cfg.vocab_size, num_blocks=8, seed=11)
    stream = {name: lm.sample(*shape) for name, shape in CLAIM_STREAM}
    profile = CoactivationRecorder.load(str(FIXTURE / "coact.npz"))
    sims = all_layer_similarities(cfg, params, stream["sims"])
    q = np.stack([profile.conditional(l) for l in range(l_n)])
    built = build_buddy_lists(q, alpha=0.95, k_max=16, activity=profile.A,
                              output_sim=sims)
    committed = load_tables(str(FIXTURE / "tables_a0.95_k16.npz"))
    buddy_sets = {"committed": committed, "built": built}
    rt, rq = _tiled_random_table(l_n, e_n)
    out = {"built_table": built.table}
    # 3. substitute errors: each buddy set's draws (numpy, seed 0)
    xs = collect_layer_inputs(cfg, params, stream["errs"])
    moe = params["groups"][0]["moe"]
    errs = {}
    with torch.no_grad():
        for name, tb in buddy_sets.items():
            rng = np.random.default_rng(0)
            e = {"buddy": [], "random": []}
            for l in range(l_n):
                x = xs[l][:128]
                w = {k: moe[k][l] for k in ("w1", "w3", "w2")}

                def y(j):
                    return (torch.nn.functional.silu(x @ w["w1"][j])
                            * (x @ w["w3"][j])) @ w["w2"][j]

                for i in range(e_n):
                    if profile.A[l, i] <= 0 or tb.table[l, i, 0] < 0:
                        continue
                    jr = int(rng.choice([v for v in range(e_n) if v != i]))
                    yi = y(i)
                    for kind, j in (("buddy", int(tb.table[l, i, 0])),
                                    ("random", jr)):
                        e[kind].append(float(torch.linalg.norm(yi - y(j))
                                             / (torch.linalg.norm(yi)
                                                + 1e-8)))
            errs[name] = {k: np.array(v) for k, v in e.items()}
    out["errs"] = errs
    # 4. agreement
    toks = torch.as_tensor(stream["agree"]).to(device)
    with torch.no_grad():
        top1 = transformer.forward_train(params, cfg, toks)[0] \
            .argmax(-1).cpu().numpy()
    pol = BuddyPolicy(**CLAIM_POLICY)
    runs = {name: (pol, tb.table, tb.q) for name, tb in buddy_sets.items()}
    runs.update(random=(pol, rt, rq),
                random_mode=(BuddyPolicy(**CLAIM_POLICY, mode="random"),
                             rt, rq),
                drop=(DROP, committed.table, committed.q),
                none=(ORIGINAL, committed.table, committed.q))
    out["top1"] = top1
    out["agree"] = _agreement_runs(params, cfg, toks, top1, runs,
                                   record=True)
    if device == "cuda":
        resident = _residency_draws(1, l_n, e_n, 1)[0]
        out["forward_ms"] = {
            "full": time_ms(lambda: transformer.forward_train(
                params, cfg, toks), reps=10),
            "buddy": time_ms(lambda: _policy_forward(
                params, cfg, toks, pol, resident, committed.table,
                committed.q), reps=10)}
    # 5. serving, 6. the gates
    out["serve"], out["gates"] = {}, {}
    for name, tb in buddy_sets.items():
        tables = BuddyTables(tb.table, tb.q,
                             (tb.table >= 0).sum(-1).astype(np.int32))
        out["serve"][name] = {}
        for mode, kw in CLAIM_SERVE.items():
            eng = ServeEngine(cfg, params, tables=tables,
                              policy=BuddyPolicy(**kw),
                              cache=ExpertCache(l_n, e_n, 0.5, seed=2),
                              seed=2)
            eng.generate(stream["serve_" + mode], max_new_tokens=6)
            out["serve"][name][mode] = {
                "n_miss_fetch": eng.stats.n_miss_fetch,
                "n_sub": eng.stats.n_sub,
                "total_bytes": eng.ledger.total_bytes,
                "tokens_per_s": eng.stats.tokens_per_s}
        gate_toks = torch.as_tensor(stream["gates"]).to(device)
        resident = _residency_draws(3, l_n, e_n, 1)[0]
        out["gates"][name] = {
            case: int(_policy_forward(params, cfg, gate_toks,
                                      BuddyPolicy(**kw), resident, tb.table,
                                      tb.q)[1]["n_sub"])
            for case, kw in CLAIM_GATES.items()}
    return out


def _claims_full(smi: str) -> dict:
    """DeepSeek-V2-Lite-buddy at full width, the serve phase's 8 layers,
    random weights from seed 0 on the card: the offline pipeline (record=
    True forwards, CoactivationRecorder, build_buddy_lists, calibrate_tau
    over tae_from_probs of the profile), then agreement with the full model
    under the buddy tables, make_random_table and drop at cache rate 0.5
    over 3 residency draws, and the gates, in one launch-count window."""
    import numpy as np
    import torch
    from repro_torch.core import (DROP, BuddyPolicy, CoactivationRecorder,
                                  build_buddy_lists, calibrate_tau,
                                  tae_from_probs)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    cfg = serve.model_config(serve.parse_args(SERVE_FLAGS))
    n_moe = sum(r for k, r in cfg.stack() if k == "attn_moe")
    l_n, e_n = n_moe, cfg.moe.num_experts
    stages = {}
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    stages["init_s"] = time.perf_counter() - t0
    ops.reset_launch_counts()                  # the path starts here
    n_plain = n_policy = 0                     # forwards without / with one
    t0 = time.perf_counter()
    rec = CoactivationRecorder(n_moe, e_n)
    lm = MarkovLM(cfg.vocab_size, seed=0)
    taes = []
    with torch.no_grad():
        for _ in range(4):
            toks = torch.as_tensor(lm.sample(CLAIM_B, 64)).to("cuda")
            _, aux = transformer.forward_train(params, cfg, toks, record=True)
            n_plain += 1
            per = aux["recorded"][0]
            idx = per["indices"].cpu().numpy()
            for l in range(n_moe):
                rec.update(l, idx[l], per["probs"][l].cpu().numpy())
                taes.append(tae_from_probs(per["probs"][l]).cpu().numpy())
            rec.step_done()
    tau = calibrate_tau(np.concatenate(taes), percentile=15)
    q = np.stack([rec.conditional(l) for l in range(n_moe)])
    tables = build_buddy_lists(q, alpha=0.95, k_max=16, activity=rec.A)
    stages["profile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = torch.as_tensor(MarkovLM(cfg.vocab_size, seed=1).sample(
        CLAIM_B, CLAIM_S)).to("cuda")
    with torch.no_grad():
        full = transformer.forward_train(params, cfg, toks)[0]
    n_plain += 1
    require(bool(full.isfinite().all()), "claims full: non-finite logits")
    top1 = full.argmax(-1).cpu().numpy()
    pol = BuddyPolicy(**dict(CLAIM_POLICY, tau=tau))
    rt, rq = _tiled_random_table(l_n, e_n)
    runs = {"buddy": (pol, tables.table, tables.q), "random": (pol, rt, rq),
            "drop": (DROP, tables.table, tables.q)}
    agree = _agreement_runs(params, cfg, toks, top1, runs)
    n_policy += len(runs) * CLAIM_TRIALS
    stages["agreement_s"] = time.perf_counter() - t0
    resident = _residency_draws(3, l_n, e_n, 1)[0]
    gates = {case: int(_policy_forward(params, cfg, toks, BuddyPolicy(**kw),
                                       resident, tables.table,
                                       tables.q)[1]["n_sub"])
             for case, kw in CLAIM_GATES.items()}
    n_policy += len(CLAIM_GATES)
    torch.cuda.synchronize()
    counts = ops.launch_counts()               # ... and ends here
    # the profiler's count of this repo's device kernels in one forward
    # without and one with a policy, by kernel function: topk_gate is one
    # gate_kernel per MoE layer, route at 384 rows its two-launch form
    # (gate_kernel, substitute_kernel), expert_ffn gate_up_kernel and
    # down_kernel
    prof = {
        "plain": device_us(lambda: transformer.forward_train(
            params, cfg, toks), n=1, by_op=True),
        "policy": device_us(lambda: _policy_forward(
            params, cfg, toks, pol, resident, tables.table, tables.q), n=1,
            by_op=True)}
    names = ("gate_kernel", "substitute_kernel", "route_cluster_kernel",
             "gate_up_kernel", "down_kernel")
    kernels_seen = {
        k: {name: sum(c for op, c in (v.get("device_ops_by_op") or {})
                      .items() if name in op.split("(")[0])
            for name in names}
        for k, v in prof.items()}
    want_seen = {"plain": dict(zip(names, (n_moe, 0, 0, n_moe, n_moe))),
                 "policy": dict(zip(names, (n_moe, n_moe, 0, n_moe, n_moe)))}
    out = {"arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "experts": e_n, "top_k": cfg.moe.top_k,
           "batch": [CLAIM_B, CLAIM_S], "cache_rate": 0.5,
           "tau_calibrated_p15": tau,
           "buddy_list_mean": float(tables.sizes.mean()),
           "agreement_mean": {n: _mean_agreement(agree, n) for n in runs},
           "n_sub": {f"{n}_{t}": agree[n, t][1] for n, t in agree},
           "gates_n_sub": gates, "launches": counts,
           "launches_want": {"topk_gate": n_plain * n_moe,
                             "route": n_policy * n_moe,
                             "expert_ffn": (n_plain + n_policy) * n_moe},
           "profiler_kernels": kernels_seen, "stages_s": stages,
           "nvidia_smi": smi,
           "note": "random initialised weights carry no co-activation "
                   "structure: no quality inequality is asserted here"}
    require(gates == {"tau_1": 0, "beta_0": 0},
            f"claims full: a gate let a substitution through: {gates}")
    require(all(counts[k] == v for k, v in out["launches_want"].items())
            and counts["grouped_ffn"] == counts["quant_ffn"] == 0,
            f"claims full: launches {counts}, want {out['launches_want']}")
    require(kernels_seen == want_seen,
            f"claims full: the profiler counted {kernels_seen}, want "
            f"{want_seen}")
    require(sum(agree["buddy", t][1] for t in range(CLAIM_TRIALS)) > 0,
            "claims full: no substitution under the buddy tables")
    del params
    torch.cuda.empty_cache()
    return out


def phase_claims(smi: str) -> dict:
    """(a) The fixture's claims on the CPU (plain versions) and on the card
    (kernels), in one launch-count window for the card's run; (b) the full-
    width pipeline. Returns (a)'s launches."""
    import numpy as np
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    before = ops.launch_counts()
    cpu = _claims_fixture("cpu")
    require(ops.launch_counts() == before, "claims: the CPU run launched")
    ops.reset_launch_counts()                  # the card's run starts here
    card = _claims_fixture("cuda")
    counts = ops.launch_counts()               # ... and ends here
    fixture_s = time.perf_counter() - t0
    require(counts["topk_gate"] > 0 and counts["route"] > 0
            and counts["expert_ffn"] > 0,
            f"claims: a kernel of the path did not launch: {counts}")
    require(np.array_equal(cpu["built_table"], card["built_table"]),
            "claims: the card built other buddy tables than the CPU")
    require(np.array_equal(cpu["top1"], card["top1"]),
            "claims: the full model's top-1 differs CPU vs card")
    err_diff = max(float(np.abs(card["errs"][s][k] - cpu["errs"][s][k])
                         .max()) for s in card["errs"]
                   for k in ("buddy", "random"))
    require(err_diff <= ERR_TOL, f"claims: substitute errors differ by "
                                 f"{err_diff}")
    for key, (a, n, subs) in card["agree"].items():
        ca, cn, csubs = cpu["agree"][key]
        require(n == cn and np.array_equal(subs, csubs),
                f"claims {key}: substitutions differ CPU vs card ({n} / "
                f"{cn})")
        require(abs(a - ca) <= AGREE_TOL,
                f"claims {key}: agreement {a} vs {ca} on the CPU")
    for name, modes in card["serve"].items():
        for mode, row in modes.items():
            c = cpu["serve"][name][mode]
            require(all(row[k] == c[k] for k in ("n_miss_fetch", "n_sub",
                                                 "total_bytes"))
                    and abs(row["tokens_per_s"] - c["tokens_per_s"])
                    <= TPS_RTOL * c["tokens_per_s"],
                    f"claims serve {name} {mode}: {row} vs {c} on the CPU")
    require(card["gates"] == cpu["gates"]
            and all(g == {"tau_1": 0, "beta_0": 0}
                    for g in card["gates"].values()),
            f"claims gates: {card['gates']} / {cpu['gates']}")
    # the paper's inequalities on the card
    agree = card["agree"]
    diffs = {s: float(np.mean([agree[s, t][0] - agree["random", t][0]
                               for t in range(CLAIM_TRIALS)]))
             for s in ("committed", "built")}
    err_means = {s: {k: float(v.mean()) for k, v in e.items()}
                 for s, e in card["errs"].items()}
    line = {"phase": "claims", "fixture": "results/bench/model.npz",
            "seconds_fixture": fixture_s,
            "agreement_mean": {n: _mean_agreement(agree, n)
                               for n in ("committed", "built", "random",
                                         "random_mode", "drop", "none")},
            "agreement_buddy_minus_random": diffs,
            "random_mode_equals_random_table": all(
                agree["random_mode", t][:2] == agree["random", t][:2]
                for t in range(CLAIM_TRIALS)),
            "n_sub": {f"{n}_{t}": v[1] for (n, t), v in agree.items()},
            "substitute_err_mean": err_means,
            "err_max_diff_cpu": err_diff, "err_tol": ERR_TOL,
            "agree_tol": AGREE_TOL, "serve": card["serve"],
            "gates_n_sub": card["gates"],
            "forward_ms": card["forward_ms"], "launches": counts,
            "card_equals_cpu": True}
    emit(line)
    for s in ("committed", "built"):
        e = err_means[s]
        require(e["buddy"] < e["random"],
                f"claims ({s}): buddy error {e['buddy']} !< random "
                f"{e['random']}")
        require(diffs[s] > -0.005,
                f"claims ({s}): buddy agreement below random by {diffs[s]}")
        b, o = card["serve"][s]["buddy"], card["serve"][s]["none"]
        require(b["n_sub"] > 0 and o["n_miss_fetch"] > 0
                and b["n_miss_fetch"] < o["n_miss_fetch"]
                and b["total_bytes"] < o["total_bytes"],
                f"claims ({s}): buddy does not fetch less: {b} vs {o}")
    t0 = time.perf_counter()
    full = _claims_full(smi)
    emit(dict({"phase": "claims_full_width",
               "seconds": time.perf_counter() - t0}, **full))
    return {k: counts[k] + full["launches"][k] for k in counts}


def _serve_path(serve, flags, params, gather_steps: int) -> dict:
    """One full-width serve path through the launcher's entry points: buddy
    profiling and a fused-dispatch batch, then ``gather_steps`` steps
    through the gather branch on the same weights."""
    import torch
    from repro_torch.kernels import ops
    args = serve.parse_args(flags + ["--fused-dispatch"])
    t0 = time.perf_counter()
    eng, lm = serve.build_engine(args, params=params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = lm.sample(args.batch, 8)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, args.steps)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    mid = ops.launch_counts()
    eng2, _ = serve.build_engine(serve.parse_args(flags),
                                 params=eng.params if params is None
                                 else params)
    start = ops.launch_counts()
    t0 = time.perf_counter()
    toks2 = eng2.generate(prompts[:, :1], gather_steps)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    end = ops.launch_counts()
    # the serve steps' own launches (set-up and buddy profiling excluded)
    steps = [{k: b[k] - a[k] for k in a} for a, b in ((before, mid),
                                                       (start, end))]
    return {"engines": (eng, eng2), "tokens": (toks, toks2),
            "setup_s": setup_s, "fused_s": fused_s, "gather_s": gather_s,
            "step_launches": steps}


def _path_row(run) -> dict:
    eng, eng2 = run["engines"]
    s = eng.summary()
    st = s["stats"]
    row = {"setup_s": run["setup_s"], "fused_steps": st["steps"],
           "fused_wall_ms_per_step": run["fused_s"] / st["steps"] * 1e3,
           "gather_steps": eng2.stats.steps,
           "gather_wall_ms_per_step":
               run["gather_s"] / eng2.stats.steps * 1e3,
           "n_sub": st["n_sub"], "n_hit": st["n_hit"],
           "n_miss_fetch": st["n_miss_fetch"],
           "n_miss_drop": st["n_miss_drop"],
           "n_upgrade_issued": st["n_upgrade_issued"],
           "simulated_tokens_per_s": s["tokens_per_s"],
           "step_launches_fused": run["step_launches"][0],
           "step_launches_gather": run["step_launches"][1]}
    if eng.tier is not None:
        row["degraded_fused"] = eng.tier.degraded_tokens
        row["degraded_gather"] = eng2.tier.degraded_tokens
        row["tier_budget_split"] = eng.tier.budget_split()
        row["mean_fidelity_loss"] = eng.tier.summary()["mean_fidelity_loss"]
    return row


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.common import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    flags = SERVE_FLAGS
    cfg = serve.model_config(serve.parse_args(flags))
    ops.reset_launch_counts()                  # path 1 starts here
    base = _serve_path(serve, flags, None, 2)
    counts_base = ops.launch_counts()          # ... and ends here
    params = base["engines"][0].params
    ops.reset_launch_counts()                  # path 2 (the tier) starts here
    tier_flags = flags + TIER_FLAGS
    tier = _serve_path(serve, tier_flags, params, 3)
    counts_tier = ops.launch_counts()          # ... and ends here
    ops.reset_launch_counts()                  # path 3 (cost mode) starts here
    cost = _serve_path(serve, tier_flags + ["--miss-policy", "cost"], params,
                       3)
    counts_cost = ops.launch_counts()          # ... and ends here
    counts = {k: counts_base[k] + counts_tier[k] + counts_cost[k]
              for k in counts_base}
    out = {"phase": "serve", "arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
           "d_ff_expert": cfg.moe.d_ff, "top_k": cfg.moe.top_k,
           "vocab": cfg.vocab_size,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "base": dict(_path_row(base), launches=counts_base),
           "int8_tier": dict(_path_row(tier), launches=counts_tier),
           "cost_int8_tier": dict(_path_row(cost), launches=counts_cost),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    emit(out)
    for run, steps in ((base, 2), (tier, 3), (cost, 3)):
        eng, eng2 = run["engines"]
        require(eng.stats.steps == 15 and eng2.stats.steps == steps,
                "wrong step count")
        require(all(np.all((t >= 0) & (t < cfg.vocab_size))
                    for t in run["tokens"]),
                "generated tokens out of the vocabulary")
        st = eng.stats
        require(st.n_hit + st.n_sub + st.n_miss_fetch > 0,
                "no expert slot was served")
        for e, d in zip(run["engines"], run["step_launches"]):
            require(d["route"] == e.num_moe_layers * e.stats.steps
                    and d["topk_gate"] == 0 and d["buddy_substitute"] == 0,
                    f"serve steps: want route once per MoE layer and step "
                    f"and no standalone routing kernel, got {d}")
    require(all(counts_base[k] > 0 for k in SERVE_KERNELS
                if k != "quant_ffn"),
            f"a kernel was not launched on the serve path: {counts_base}")
    for name, c in (("tier", counts_tier), ("cost", counts_cost)):
        require(all(c[k] > 0 for k in SERVE_KERNELS),
                f"a kernel was not launched on the {name} path: {c}")
    require(out["int8_tier"]["degraded_fused"] > 0
            and out["int8_tier"]["degraded_gather"] > 0,
            f"a tier run served no degraded slot: {out['int8_tier']}")
    require(all(e.policy.miss_policy == "cost" for e in cost["engines"])
            and sum(e.stats.n_upgrade_issued for e in cost["engines"]) > 0,
            f"the cost path issued no upgrade: {out['cost_int8_tier']}")
    return counts, params


# ---------------------------------------------------------------------------
class StepLog:
    """Records every ServeEngine.step and .prefill_rows call while open
    (patched on the class, so it also sees the engines that serve.main
    builds): its kind ("chunk", "decode", or "probe" for a lockstep batch:
    generate's steps, and the probe that sizes the auto arrival rate),
    tokens fed, wall ms on a host clock synchronized with the card, and the
    kernel launches it made; and the range of every sampled token array.
    ``profile``: (kind, n), the n-th step of that kind runs under
    torch.profiler (``profiled``) and gets its device ms and device ops
    (None where the window caught no device event: not measured) and the
    flag "profiled"; ``keep_logits``: every step's logits, on the host."""

    def __init__(self, profile=None, keep_logits: bool = False):
        self.steps, self.sampled, self.logits = [], [], []
        self.engine = None             # the engine of the last step
        self.profile = profile
        self.keep_logits = keep_logits

    def walls(self, kind: str) -> list:
        """Wall ms of the steps of ``kind``, the profiled one left out."""
        return [st["ms"] for st in self.steps
                if st["kind"] == kind and not st.get("profiled")]

    def __enter__(self):
        from repro_torch.serving.engine import ServeEngine
        self._orig = {n: getattr(ServeEngine, n)
                      for n in ("step", "prefill_rows", "sample_tokens")}
        ServeEngine.step = self._timed("step")
        ServeEngine.prefill_rows = self._timed("prefill_rows")
        sample = self._orig["sample_tokens"]

        def sample_tokens(eng, *a, **kw):
            out = sample(eng, *a, **kw)
            self.sampled.append((int(out.min()), int(out.max())))
            return out

        ServeEngine.sample_tokens = sample_tokens
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.engine import ServeEngine
        for n, fn in self._orig.items():
            setattr(ServeEngine, n, fn)

    def _timed(self, name):
        import numpy as np
        import torch
        from repro_torch.kernels import ops
        fn = self._orig[name]

        def call(eng, tokens, *a, **kw):
            if name == "prefill_rows":
                kind, fed = "chunk", int(tokens.numel() if torch.is_tensor(
                    tokens) else np.asarray(tokens).size)
            else:
                pos = a[1] if len(a) > 1 else kw["pos"]
                kind = "decode" if isinstance(pos, np.ndarray) else "probe"
                fed = int(tokens.shape[0])
            nth = sum(st["kind"] == kind for st in self.steps)
            prof = self.profile == (kind, nth)
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if prof:
                out, evts = profiled(lambda: fn(eng, tokens, *a, **kw))
            else:
                out = fn(eng, tokens, *a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = ops.launch_counts()
            self.engine = eng
            rec = {"kind": kind, "tokens": fed, "ms": ms,
                   "layers": eng.num_moe_layers,
                   "launches": {k: after[k] - before[k] for k in after}}
            if prof:
                rec.update(profiled=True, device_ms=(
                    sum(_self_device_us(e) for e in evts) / 1e3
                    if evts else None),
                    device_ops=sum(e.count for e in evts) if evts else None)
            self.steps.append(rec)
            if self.keep_logits and name == "step":
                self.logits.append(out[0].detach().float().cpu())
            return out

        return call


class SetupLog:
    """Records the launcher's set-up calls while open (patched where
    build_engine and ServeEngine look them up): transformer.init_params,
    serve.profile_buddies and quantize.attach_quant_tier, each with its
    seconds on the synchronized host clock, the device memory it left
    allocated (bytes after minus before), the peak since the last reset of
    the peak and its kernel launches. After init_params the peak is reset,
    so a path's peak is that of serving beside the weights."""

    NAMES = (("repro_torch.models.transformer", "init_params"),
             ("repro_torch.launch.serve", "profile_buddies"),
             ("repro_torch.core.quantize", "attach_quant_tier"))

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import importlib
        self._orig = []
        for mod, name in self.NAMES:
            m = importlib.import_module(mod)
            fn = getattr(m, name)
            self._orig.append((m, name, fn))
            setattr(m, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self._orig:
            setattr(m, name, fn)

    def _timed(self, name, fn):
        import torch
        from repro_torch.kernels import ops

        def call(*a, **kw):
            torch.cuda.synchronize()
            mem, before = torch.cuda.memory_allocated(), ops.launch_counts()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            self.calls.append({"name": name, "s": time.perf_counter() - t0,
                               "allocated_bytes":
                                   torch.cuda.memory_allocated() - mem,
                               "peak_gb":
                                   torch.cuda.max_memory_allocated() / 1e9,
                               "launches": {k: after[k] - before[k]
                                            for k in after}})
            if name == "init_params":
                torch.cuda.reset_peak_memory_stats()
            return out

        return call

    def seconds(self) -> dict:
        out = {}
        for c in self.calls:
            out[c["name"]] = out.get(c["name"], 0.0) + c["s"]
        return out

    def one(self, name: str) -> dict:
        got = [c for c in self.calls if c["name"] == name]
        require(len(got) == 1, f"set-up: {len(got)} calls of {name}")
        return got[0]


TAPPED = ("route", "topk_gate", "expert_ffn", "grouped_ffn", "quant_ffn")
DEEP_KEEP = 8             # deepest-layer calls a KernelTap keeps per kernel


class KernelTap:
    """Wraps the kernel dispatchers a MoE layer calls (``ops.<name>`` for
    the TAPPED kernels) while open, for a model of ``layers`` MoE layers
    whose every forward and step calls each tapped kernel it runs once per
    layer, in layer order: so a kernel's call i is at layer i % layers.
    Keeps every route call's output with a copy of its residency mask (the
    slot-outcome partition), every deepest-layer route call's inputs
    (copies) and output, and the last DEEP_KEEP deepest-layer calls of
    each other kernel (their operands and outputs: fresh buffers and the
    weights, which nothing writes). Counts the calls per kernel."""

    def __init__(self, layers: int):
        import collections
        self.layers = layers
        self.calls = dict.fromkeys(TAPPED, 0)
        self.routes, self.deep_routes = [], []
        self.deep = collections.defaultdict(
            lambda: collections.deque(maxlen=DEEP_KEEP))

    def __enter__(self):
        from repro_torch.kernels import ops
        self._orig = {n: getattr(ops, n) for n in TAPPED}
        for n in TAPPED:
            setattr(ops, n, self._tap(n, self._orig[n]))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self._orig.items():
            setattr(ops, n, fn)

    def _tap(self, name, fn):
        import torch

        def cp(v):
            return v.clone() if torch.is_tensor(v) else v

        def call(*a, **kw):
            deep = self.calls[name] % self.layers == self.layers - 1
            self.calls[name] += 1
            if name == "route":
                args = ([cp(v) for v in a], {k: cp(v) for k, v in kw.items()})
            out = fn(*a, **kw)
            if name == "route":
                self.routes.append((args[0][3], out))
                if deep:
                    self.deep_routes.append((*args, out))
            elif deep:
                self.deep[name].append((a, kw, out))
            return out

        return call

    def partition(self) -> dict:
        """Every route call's slots split into the six outcomes: hit (the
        router's expert resident), buddy (substituted), degraded, peer,
        fetch (missed) and drop; each slot must be exactly one of them, so
        the counts sum to T*K per call. Returns the counts over all calls
        and the slots checked."""
        import torch
        names = ("hit", "buddy", "degraded", "peer", "fetch", "drop")
        tot = dict.fromkeys(names, 0)
        slots = 0
        for resident, r in self.routes:
            masks = torch.stack([resident[r.idx.long()], r.substituted,
                                 r.degraded, r.peered, r.missed, r.dropped])
            per_slot = masks.to(torch.int32).sum(0)
            require(bool((per_slot == 1).all()),
                    f"slot outcomes do not partition T*K: {per_slot.tolist()}"
                    f" at T = {r.idx.shape[0]}")
            for n, c in zip(names, masks.sum((1, 2)).tolist()):
                tot[n] += int(c)
            slots += r.idx.numel()
        require(sum(tot.values()) == slots, f"outcomes {tot} of {slots}")
        return {"route_calls": len(self.routes), "slots": slots, **tot}

    def deep_parity(self) -> dict:
        """At the deepest layer, on the path's own operands: every route
        call against route_plain (ints and masks equal, floats within
        TOL_GATE), and the kept calls of each other kernel against its
        plain version (topk_gate: indices and the gate equal, floats within
        TOL_GATE; the FFN kernels within TOL_F32 x (1 + max |plain|), the
        kernels phase's tolerance)."""
        import torch
        from repro_torch.kernels.expert_ffn import expert_ffn_plain
        from repro_torch.kernels.grouped_ffn import grouped_ffn_plain
        from repro_torch.kernels.quant_ffn import quant_ffn_plain
        from repro_torch.kernels.route import route_plain
        from repro_torch.kernels.topk_gate import topk_gate_plain
        out = {}
        if self.deep_routes:
            err, equal = 0.0, True
            for a, kw, got in self.deep_routes:
                want = route_plain(*a, **kw)
                equal &= all(torch.equal(getattr(got, f), getattr(want, f))
                             for f in ROUTE_EXACT)
                err = max(err, max(max_err(getattr(got, f), getattr(want, f))
                                   for f in ("topk_logits", "probs", "tae")))
            out["route"] = {"calls": len(self.deep_routes),
                            "ints_and_masks_equal": equal,
                            "max_abs_err": err}
            require(equal and err <= TOL_GATE,
                    f"route at layer {self.layers - 1} differs from "
                    f"route_plain: {out['route']}")
        for a, kw, got in self.deep.get("topk_gate", ()):
            want = topk_gate_plain(*a, **kw)
            equal = torch.equal(got[0], want[0]) and torch.equal(got[-1],
                                                                 want[-1])
            err = max(max_err(g, w) for g, w in zip(got[1:], want[1:])
                      if g.is_floating_point())
            row = out.setdefault("topk_gate", {
                "shape": list(a[0].shape), "calls": 0,
                "idx_and_allow_equal": True, "max_abs_err": 0.0})
            row["calls"] += 1
            row["idx_and_allow_equal"] &= equal
            row["max_abs_err"] = max(row["max_abs_err"], err)
            require(equal and err <= TOL_GATE,
                    f"topk_gate at layer {self.layers - 1}: {row}")
        plains = {"expert_ffn": expert_ffn_plain,
                  "grouped_ffn": grouped_ffn_plain,
                  "quant_ffn": quant_ffn_plain}
        for name, plain in plains.items():
            for a, kw, got in self.deep.get(name, ()):
                want = plain(*a, **kw)
                err, top = max_err(got, want), float(want.abs().max())
                row = out.setdefault(name, {
                    "shape": list(a[0].shape), "calls": 0,
                    "max_abs_err": 0.0, "max_abs_plain": 0.0})
                row["calls"] += 1
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["max_abs_plain"] = max(row["max_abs_plain"], top)
                require(err <= TOL_F32 * (1 + top),
                        f"{name} at layer {self.layers - 1}, "
                        f"{tuple(a[0].shape)}: err {err}")
        return out


def _continuous_row(log: StepLog, s: dict, counts: dict) -> dict:
    """One run's figures: wall ms per chunk / decode step (median, mean),
    step counts, the simulated clock's TTFT and goodput, launches."""
    row = {"completed": s["completed"], "num_requests": s["num_requests"],
           "scheduler_steps": s["steps"]}
    for kind in ("chunk", "decode", "probe"):
        ms = [st["ms"] for st in log.steps if st["kind"] == kind]
        row[f"{kind}_steps"] = len(ms)
        if ms:
            row[f"{kind}_wall_ms_median"] = statistics.median(ms)
            row[f"{kind}_wall_ms_mean"] = statistics.fmean(ms)
    row["chunk_tokens_max"] = max((st["tokens"] for st in log.steps
                                   if st["kind"] == "chunk"), default=0)
    row.update(simulated_ttft_ms_p50=s["ttft_s"]["p50"] * 1e3,
               simulated_ttft_ms_p99=s["ttft_s"]["p99"] * 1e3,
               simulated_tpot_ms_p50=s["tpot_s"]["p50"] * 1e3,
               simulated_goodput_rps=s["goodput_rps"],
               simulated_goodput_tok_s=s["goodput_tok_s"],
               n_sub=s["engine"]["stats"]["n_sub"],
               n_miss_fetch=s["engine"]["stats"]["n_miss_fetch"],
               launches=counts)
    if "tier" in s["engine"]:
        row["degraded_slots"] = s["engine"]["tier"]["degraded_tokens"]
    return row


def _check_continuous(tag: str, log: StepLog, s: dict, counts: dict,
                      vocab: int, kernels) -> None:
    require(s["completed"] == s["num_requests"] > 0,
            f"continuous ({tag}): {s['completed']} of {s['num_requests']} "
            "requests completed")
    for st in log.steps:
        d = st["launches"]
        require(d["route"] == st["layers"] and d["topk_gate"] == 0
                and d["buddy_substitute"] == 0,
                f"continuous ({tag}): want route once per MoE layer and no "
                f"standalone routing kernel in every step, got {st}")
    require(any(st["kind"] == "chunk" for st in log.steps),
            f"continuous ({tag}): no chunk step")
    require(all(k in counts and counts[k] > 0 for k in kernels),
            f"continuous ({tag}): a kernel of the run did not launch: "
            f"{counts}")
    require(all(0 <= lo and hi < vocab for lo, hi in log.sampled),
            f"continuous ({tag}): a token outside the vocabulary")


def _first_token_logits(eng, sched):
    """Patch ``eng.sample_tokens`` to keep, per step, the simulated time and
    the rid of each row beside the logits it samples from; returns a
    function that gives {rid: first-token logits} after the run."""
    seen = []
    sample = eng.sample_tokens

    def logged(logits, *a, **kw):
        seen.append((eng.scheduler.now,
                     [None if r is None else r.rid for r in sched._slot],
                     logits.detach().float().cpu()))
        return sample(logits, *a, **kw)

    eng.sample_tokens = logged

    def firsts(reqs):
        by_t = {t: (rids, lg) for t, rids, lg in seen}
        out = {}
        for r in reqs:
            rids, lg = by_t[r.first_token_s]
            out[r.rid] = lg[rids.index(r.rid)]
        return out

    return firsts


def phase_continuous(params):
    """Continuous serving at full width (8 layers) on the serve phase's
    weights; see the module note. Returns the three runs' launches and run
    (a)'s figures."""
    import contextlib
    import io
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import scheduler as S
    from repro_torch.training.data import MarkovLM
    flags = CONTINUOUS_FLAGS
    cfg = serve.model_config(serve.parse_args(flags))
    vocab = cfg.vocab_size

    def run_main(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            s = serve.main(argv, params=params)
        return s, buf.getvalue().strip().splitlines()[-1]

    def run_long():
        args = serve.parse_args(flags + ["--fused-dispatch"])
        eng, lm = serve.build_engine(args, params=params)
        reqs = S.make_requests(list(lm.sample(8, 256)),
                               S.ReplayArrivals([0.0] * 8), 8)
        return S.ContinuousScheduler(eng, slots=4, prefill_chunk=128).run(
            S.RequestQueue(reqs)), None

    runs = (("a_launcher_fused", lambda: run_main(flags + ["--fused-dispatch"]),
             ("route", "grouped_ffn")),
            ("b_launcher_int8_tier_capacity",
             lambda: run_main(flags + TIER_FLAGS),
             ("route", "expert_ffn", "quant_ffn")),
            ("c_long_prompts_chunk128", run_long, ("route", "grouped_ffn")))
    t_phase = time.perf_counter()
    out = {"phase": "continuous", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "slots": 4}
    total = None
    for tag, fn, kernels in runs:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()             # this run starts here
        t0 = time.perf_counter()
        with StepLog() as log:
            s, line = fn()
        counts = ops.launch_counts()          # ... and ends here
        out[tag] = dict(_continuous_row(log, s, counts),
                        run_s=time.perf_counter() - t0,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                        **({"launcher_line": line} if line else {}))
        _check_continuous(tag, log, s, counts, vocab, kernels)
        total = counts if total is None else {k: total[k] + counts[k]
                                              for k in total}
    require(out["c_long_prompts_chunk128"]["chunk_tokens_max"] > 256,
            "continuous (c): no chunk step above 256 tokens")
    require(out["b_launcher_int8_tier_capacity"]["degraded_slots"] > 0,
            "continuous (b): the tier served no slot")

    # chunked (C = 8) against token-by-token (C = 1), substitution off so
    # that both runs compute the same function whatever the residency
    cmp_flags = flags + ["--policy", "none", "--fused-dispatch"]
    lm = MarkovLM(vocab, seed=3)
    rng = np.random.default_rng(3)
    prompts = [lm.sample(1, int(rng.integers(4, 9)))[0] for _ in range(4)]
    res = {}
    for chunk in (8, 1):
        eng, _ = serve.build_engine(serve.parse_args(cmp_flags),
                                    params=params)
        reqs = S.make_requests(prompts, S.ReplayArrivals([0.0] * 4), 8)
        sched = S.ContinuousScheduler(eng, slots=4, prefill_chunk=chunk)
        firsts = _first_token_logits(eng, sched)
        sched.run(S.RequestQueue(reqs))
        res[chunk] = (firsts(reqs), {r.rid: r.tokens for r in reqs})
    errs = [max_err(res[8][0][rid], res[1][0][rid]) for rid in res[1][0]]
    same = sum(int(a == b) for rid in res[1][1]
               for a, b in zip(res[8][1][rid], res[1][1][rid]))
    out["chunked_vs_token_by_token"] = {
        "requests": 4, "first_token_logits_max_abs_err": max(errs),
        "tol": LOGIT_TOL, "generated_tokens_equal": same,
        "generated_tokens": sum(len(t) for t in res[1][1].values())}
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    require(max(errs) <= LOGIT_TOL,
            f"continuous: chunked and token-by-token first-token logits "
            f"differ: {out['chunked_vs_token_by_token']}")
    return total, out["a_launcher_fused"]


SYSTEM_PROMPT = 60                     # tokens; not a multiple of the block


def _shared_prefix_requests(vocab: int):
    """Eight requests, all arriving at 0, on one 60-token system prompt,
    each with 8-24 tokens of its own (the first of them distinct, so a hit
    adopts exactly the system prompt) and 8 new tokens."""
    from repro_torch.serving import scheduler as S
    import numpy as np
    rng = np.random.default_rng(5)
    system = rng.integers(0, vocab, SYSTEM_PROMPT)
    firsts = rng.choice(vocab, 8, replace=False)
    prompts = [np.concatenate([system, [f], rng.integers(0, vocab, n - 1)])
               for f, n in zip(firsts, rng.integers(8, 25, 8))]
    return S.make_requests(prompts, S.ReplayArrivals([0.0] * 8), 8)


def phase_paged(params, ring_row: dict) -> dict:
    """Paged KV and the prefix cache at full width (8 layers) on the serve
    phase's weights; see the module note. Returns the runs' launches."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import scheduler as S
    base = CONTINUOUS_FLAGS + ["--fused-dispatch"]
    paged = ["--paged-kv", "--kv-block", "16"]
    flags = base + paged
    cfg = serve.model_config(serve.parse_args(flags))
    t_phase = time.perf_counter()
    out = {"phase": "paged", "arch": cfg.arch_id, "layers": cfg.num_layers,
           "slots": 4, "kv_block": 16,
           "ring_a_launcher_fused": {k: ring_row[k] for k in ring_row
                                     if "wall_ms" in k or k.endswith("steps")
                                     or k == "peak_mem_gb"}}
    total = {}

    def window(tag, fn, kernels):
        """One run in its own launch-count window, under a StepLog."""
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()             # this run starts here
        t0 = time.perf_counter()
        with StepLog() as log:
            s, eng, text = fn()
        counts = ops.launch_counts()          # ... and ends here
        for k in counts:
            total[k] = total.get(k, 0) + counts[k]
        out[tag] = dict(_continuous_row(log, s, counts),
                        run_s=time.perf_counter() - t0,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                        prefix=s["engine"]["prefix"])
        _check_continuous(tag, log, s, counts, cfg.vocab_size, kernels)
        return s, eng or log.engine, text

    def launcher():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            s = serve.main(flags, params=params)
        return s, None, buf.getvalue()

    def shared(extra):
        def run():
            args = serve.parse_args(flags + extra)
            eng, _ = serve.build_engine(args, params=params)
            sched = S.ContinuousScheduler(eng, slots=4, prefill_chunk=8)
            reqs = _shared_prefix_requests(cfg.vocab_size)
            return sched.run(S.RequestQueue(reqs)), eng, None
        return run

    # (a) the launcher with --paged-kv
    s, eng, text = window("a_launcher_paged", launcher,
                          ("route", "grouped_ffn"))
    eng.kv_pool.check()
    line = [ln for ln in text.splitlines() if ln.startswith("[paged-kv]")]
    out["a_launcher_paged"]["launcher_line"] = line[-1] if line else None
    require(bool(line), "paged (a): the launcher printed no [paged-kv] line")
    require(eng.kv_pool.used_blocks == 0,
            f"paged (a): {eng.kv_pool.used_blocks} blocks held after every "
            "request retired")

    # (b) the shared system prompt, with and without the prefix cache
    s, eng, _ = window("b_prefix_cache", shared(["--prefix-cache"]),
                       ("route", "grouped_ffn"))
    px = s["engine"]["prefix"]
    eng.kv_pool.check(eng.prefix_tree.block_holders())
    _, eng_off, _ = window("b_paged_only", shared([]),
                           ("route", "grouped_ffn"))
    eng_off.kv_pool.check()
    chunks = (out["b_prefix_cache"]["chunk_steps"],
              out["b_paged_only"]["chunk_steps"])
    require(px["hits"] >= 4 and px["hit_tokens"] == SYSTEM_PROMPT
            * px["hits"] and px["pool"]["cow_copies"] >= px["hits"],
            f"paged (b): want >= 4 hits of {SYSTEM_PROMPT} tokens, each "
            f"with a copy-on-write, got {px}")
    require(chunks[0] < chunks[1], f"paged (b): {chunks[0]} chunk steps "
            f"with the prefix cache, {chunks[1]} without")

    # (c) first-token logits of every hit request, substitution off, three
    # ways: the prefix cache, paged KV alone, the ring
    res = {}
    for tag, extra in (("prefix", ["--prefix-cache"]), ("paged", []),
                       ("ring", None)):
        args = serve.parse_args(base + ["--policy", "none"] + (
            [] if extra is None else paged + extra))
        eng, _ = serve.build_engine(args, params=params)
        sched = S.ContinuousScheduler(eng, slots=4, prefill_chunk=8)
        firsts = _first_token_logits(eng, sched)
        reqs = _shared_prefix_requests(cfg.vocab_size)
        ops.reset_launch_counts()
        sched.run(S.RequestQueue(reqs))
        for k, v in ops.launch_counts().items():
            total[k] += v
        res[tag] = (firsts(reqs), {r.rid: r.tokens for r in reqs},
                    [r.rid for r in reqs if r.prefix_hit_tokens > 0])
    hit = res["prefix"][2]
    errs = {f"{a}_vs_{b}": max(max_err(res[a][0][r], res[b][0][r])
                               for r in hit)
            for a, b in (("prefix", "paged"), ("prefix", "ring"),
                         ("paged", "ring"))}
    out["c_first_token_logits"] = {
        "hit_requests": len(hit), "max_abs_err": errs, "tol": LOGIT_TOL,
        "generated_tokens_equal": {
            k: sum(int(x == y) for r in res["ring"][1]
                   for x, y in zip(res[k][1][r], res["ring"][1][r]))
            for k in ("prefix", "paged")},
        "generated_tokens": sum(len(t) for t in res["ring"][1].values())}
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    require(len(hit) >= 4, f"paged (c): {len(hit)} prefix hits")
    require(max(errs.values()) <= LOGIT_TOL,
            f"paged (c): first-token logits differ: {errs}")
    return total


# ---------------------------------------------------------------------------
def _fresh(reqs):
    """Unserved copies of a request list: the same prompts and arrivals."""
    import dataclasses
    return [dataclasses.replace(r, tokens=[], token_times=[]) for r in reqs]


def _step_ms(log: StepLog) -> dict:
    """Median wall ms per step of one run, by kind (``lockstep``: a batch
    ``generate``'s decode steps)."""
    out = {}
    for kind, name in (("chunk", "chunk"), ("decode", "decode"),
                       ("probe", "lockstep")):
        ms = [st["ms"] for st in log.steps if st["kind"] == kind]
        if ms:
            out[f"{name}_steps"] = len(ms)
            out[f"{name}_wall_ms_median"] = statistics.median(ms)
    return out


def _trace_digest(tag: str, eng, tele, reqs=None, export=False) -> dict:
    """Hold a run's flight-recorder events against the engine's counters:
    one ``outcomes`` instant per MoE layer per step whose hit and buddy
    sums are the engine's, one ``step`` span per step, as many fetch
    calibration rows as fetches and, with ``reqs``, every served request's
    track complete. ``export``: write the JSONL and Perfetto exports under
    chiprun_out/, read the JSONL back equal and parse the Perfetto JSON."""
    from repro_torch.runtime.trace import FlightRecorder, export_trace
    evs = tele.trace.sorted_events()
    by_kind = {}
    for e in evs:
        by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
    outcomes = [e for e in evs if e["kind"] == "outcomes"]
    sums = {k: sum(e["args"][k] for e in outcomes)
            for k in ("hit", "buddy", "degraded", "fetch", "drop")}
    st = eng.stats
    row = {"events": len(evs), "by_kind": by_kind, "outcome_sums": sums,
           "fetch_calibration_n": tele.calibration.summary()["fetch"]["n"]}
    require(len(outcomes) == st.steps * eng.num_moe_layers
            and by_kind.get("step") == st.steps,
            f"telemetry ({tag}): {len(outcomes)} outcomes instants and "
            f"{by_kind.get('step')} step spans for {st.steps} steps")
    require(sums["hit"] == st.n_hit and sums["buddy"] == st.n_sub,
            f"telemetry ({tag}): outcome sums {sums} against n_hit "
            f"{st.n_hit}, n_sub {st.n_sub}")
    require(row["fetch_calibration_n"] == st.n_miss_fetch,
            f"telemetry ({tag}): {row['fetch_calibration_n']} fetch "
            f"calibration rows for {st.n_miss_fetch} fetches")
    if reqs is not None:
        lanes = {}
        for e in evs:
            if e["track"] == "requests":
                lanes.setdefault(e["lane"], set()).add(e["kind"])
        want = {"arrive", "queued", "prefill", "decode", "retire"}
        served = [r.rid for r in reqs if r.finished_s >= 0]
        row["request_tracks_complete"] = sum(
            want <= lanes.get(rid, set()) for rid in served)
        require(row["request_tracks_complete"] == len(served) == len(reqs),
                f"telemetry ({tag}): {row['request_tracks_complete']} "
                f"complete request tracks for {len(reqs)} requests")
    if export:
        OUT_DIR.mkdir(exist_ok=True)
        jl, pf = OUT_DIR / f"trace_{tag}.jsonl", OUT_DIR / f"trace_{tag}.json"
        n_jl, n_pf = export_trace(tele.trace, str(jl)), export_trace(
            tele.trace, str(pf))
        with open(pf) as f:
            perfetto = json.load(f)
        row.update(jsonl=str(jl.relative_to(ROOT)), jsonl_events=n_jl,
                   perfetto=str(pf.relative_to(ROOT)), perfetto_events=n_pf)
        require(FlightRecorder.load_jsonl(str(jl)) == evs and n_jl == len(evs),
                f"telemetry ({tag}): the JSONL export does not read back")
        require(n_pf == len(perfetto["traceEvents"]) > 0,
                f"telemetry ({tag}): the Perfetto export does not parse")
    return row


def phase_telemetry(params):
    """Telemetry off and on at full width (8 layers) on the serve phase's
    weights; see the module note. Returns the phase's launches."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime.telemetry import Telemetry
    from repro_torch.serving import scheduler as S
    t_phase = time.perf_counter()
    out = {"phase": "telemetry", "order": ["off", "on", "on", "off"]}
    ops.reset_launch_counts()                  # the phase's runs start here
    for mode, flags in (("batch", SERVE_FLAGS + ["--fused-dispatch"]),
                        ("continuous",
                         CONTINUOUS_FLAGS + ["--fused-dispatch"])):
        args = serve.parse_args(flags)
        eng, lm = serve.build_engine(args, params=params)
        if mode == "batch":
            prompts = lm.sample(args.batch, 8)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                reqs0 = serve.continuous_requests(args, eng, lm)
        rows, results = [], []
        for i, on in enumerate((False, True, True, False)):
            # a fresh bundle (or none) is installed by reset_runtime, which
            # also gives each run the same fresh serving state
            eng.telemetry = (Telemetry.with_trace(
                predictor_label=args.predictor,
                num_layers=eng.num_moe_layers,
                num_experts=eng.cfg.moe.num_experts) if on else None)
            eng.reset_runtime()
            reqs = None
            with StepLog() as log:
                if mode == "batch":
                    toks = eng.generate(prompts, args.steps).tolist()
                else:
                    reqs = _fresh(reqs0)
                    s = S.ContinuousScheduler(
                        eng, slots=args.slots,
                        prefill_chunk=args.prefill_chunk,
                        adaptive_chunk=args.adaptive_chunk).run(
                        S.RequestQueue(reqs, admission=args.admission))
                    require(s["completed"] == s["num_requests"] == len(reqs),
                            f"telemetry: {s['completed']} of "
                            f"{s['num_requests']} requests completed")
                    toks = [r.tokens for r in reqs]
            es = eng.summary()
            results.append((toks, {k: es[k] for k in
                                   ("stats", "ledger", "stall_breakdown")}))
            row = {"telemetry": "on" if on else "off", **_step_ms(log)}
            if on:
                row["trace"] = _trace_digest(f"{mode}", eng, eng.telemetry,
                                             reqs, export=i == 1)
                row["summary_keys"] = sorted(es["telemetry"])
            rows.append(row)
        same = [results[i] == results[0] for i in range(4)]
        out[mode] = {"runs": rows, "off_on_equal": same,
                     "stats": results[0][1]["stats"]}
        for kind in ("lockstep", "chunk", "decode"):
            key = f"{kind}_wall_ms_median"
            if key in rows[0]:
                off = [r[key] for r in rows if r["telemetry"] == "off"]
                on_ = [r[key] for r in rows if r["telemetry"] == "on"]
                out[mode][f"{kind}_wall_ms_off_on"] = [
                    statistics.fmean(off), statistics.fmean(on_)]
        require(all(same), f"telemetry ({mode}): tokens, stats, ledger or "
                           f"stall breakdown differ between off and on runs: "
                           f"{same}")
    counts = ops.launch_counts()               # ... and end here
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    require(counts["route"] > 0 and counts["grouped_ffn"] > 0,
            f"telemetry: a kernel of the path did not launch: {counts}")
    return counts


def phase_mesh(params):
    """The simulated expert-parallel mesh at full width (8 layers) on the
    serve phase's weights; see the module note. Returns the launches."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    out = {"phase": "mesh"}
    flags = SERVE_FLAGS + ["--fused-dispatch"]
    runs = (("d1_precedence", []),
            ("d4_precedence", ["--n-devices", "4"]),
            ("d4_cost", ["--n-devices", "4", "--miss-policy", "cost"]))
    captured = {}
    ops.reset_launch_counts()                  # the phase's runs start here
    for tag, extra in runs:
        args = serve.parse_args(flags + extra)
        eng, lm = serve.build_engine(args, params=params)
        prompts = lm.sample(args.batch, 8)
        # KernelTap(1): every call is kept with its inputs
        with KernelTap(1) as tap, StepLog() as log:
            toks = eng.generate(prompts, args.steps)
        captured[tag] = tap
        s = eng.summary()
        st = s["stats"]
        row = {**_step_ms(log), "n_hit": st["n_hit"], "n_sub": st["n_sub"],
               "n_miss_fetch": st["n_miss_fetch"],
               "n_miss_drop": st["n_miss_drop"],
               "stall_breakdown": s["stall_breakdown"]}
        require(np.all((toks >= 0) & (toks < eng.cfg.vocab_size)),
                f"mesh ({tag}): a token outside the vocabulary")
        require(len(tap.routes) == eng.num_moe_layers * st["steps"],
                f"mesh ({tag}): {len(tap.routes)} route calls for "
                f"{st['steps']} steps")
        if "mesh" in s:
            m = s["mesh"]
            peer_bytes = sum(u["bytes_by_cause"].get("peer", 0)
                             for u in m["links"])
            row["mesh"] = {k: m[k] for k in ("n_devices", "n_peer_borrow",
                                             "peer_share", "peer_stall_s")}
            row["links"] = [{k: u[k] for k in ("name", "busy_s",
                                               "bytes_by_cause")}
                            for u in m["links"]]
            require(m["n_peer_borrow"] > 0 and m["peer_stall_s"] > 0.0,
                    f"mesh ({tag}): no peer borrow: {row['mesh']}")
            require(s["stall_breakdown"]["peer_stall_s"] == m["peer_stall_s"],
                    f"mesh ({tag}): peer stall differs between the stall "
                    f"breakdown and the mesh summary")
            require(len(m["links"]) == 3 and peer_bytes
                    == m["n_peer_borrow"] * eng._expert_bytes,
                    f"mesh ({tag}): {peer_bytes} peer bytes over "
                    f"{len(m['links'])} links for {m['n_peer_borrow']} "
                    "borrows")
        else:
            require("peer_stall_s" not in s["stall_breakdown"],
                    f"mesh ({tag}): a peer stall at one device")
        out[tag] = row
    counts = ops.launch_counts()               # ... and end here
    base = out["d1_precedence"]["lockstep_wall_ms_median"]
    for tag in ("d4_precedence", "d4_cost"):
        out[tag]["lockstep_wall_ms_vs_d1"] = (
            out[tag]["lockstep_wall_ms_median"] / base)

    # route on every captured layer call of the D = 4 runs (the engine's
    # peer_ok / peer_cost, hop and costs as they reached the card) against
    # route_plain on the same inputs on the card (KernelTap.deep_parity)
    for tag in ("d4_precedence", "d4_cost"):
        tap = captured[tag]
        kw = tap.deep_routes[-1][1]
        row = dict(tap.deep_parity()["route"],
                   n_peered=sum(int(r.peered.sum()) for _, r in tap.routes),
                   inputs={k: kw[k] is not None
                           for k in ("peer_ok", "peer_cost", "fetch_cost")})
        out[tag]["route_vs_plain"] = row
        require(row["n_peered"] > 0 and (row["inputs"]["peer_cost"]
                                         if "cost" in tag
                                         else row["inputs"]["peer_ok"]),
                f"mesh ({tag}): no peer input or peered slot reached route")

    # the committed fixture on a 4-device mesh, CPU against the card
    for tag, pol in (("fixture_d4_precedence", {}),
                     ("fixture_d4_cost", dict(miss_policy="cost",
                                              stall_per_quality=2e-4))):
        t_cpu, s_cpu, l_cpu = _fixture_run("cpu", True, n_devices=4, **pol)
        t_gpu, s_gpu, l_gpu = _fixture_run("cuda", True, n_devices=4, **pol)
        err = max_err(l_gpu, l_cpu)
        row = {k + "_equal": s_cpu[k] == s_gpu[k]
               for k in ("stats", "ledger", "stall_breakdown", "mesh")}
        row.update(tokens_equal=bool(np.array_equal(t_cpu, t_gpu)),
                   logits_max_abs_err=err, logits_tol=LOGIT_TOL,
                   n_peer_borrow=s_gpu["mesh"]["n_peer_borrow"])
        out[tag] = row
        require(all(v for k, v in row.items() if k.endswith("_equal"))
                and err <= LOGIT_TOL and row["n_peer_borrow"] > 0,
                f"mesh ({tag}): CPU and card disagree: {row}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    require(counts["route"] > 0 and counts["grouped_ffn"] > 0,
            f"mesh: a kernel of the path did not launch: {counts}")
    return counts


def phase_placement(params):
    """Live placement on continuous (b) at full width (8 layers) on the
    serve phase's weights; see the module note. Returns the launches."""
    import contextlib
    import gc
    import io
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.common import tree_leaves
    t_phase = time.perf_counter()
    out = {"phase": "placement"}
    flags = CONTINUOUS_FLAGS + TIER_FLAGS      # (b): the capacity branch
    live = ["--placement", "live", "--placement-interval-ms", "1"]
    runs = (("b_off", []), ("b_live_d1", live),
            ("b_live_d2", live + ["--n-devices", "2"]))
    total = {}
    for tag, extra in runs:
        gc.collect()                           # the last run's engine
        torch.cuda.empty_cache()
        args = serve.parse_args(flags + extra)
        eng, lm = serve.build_engine(args, params=params)
        quant = tree_leaves([g["moe"]["quant"] for g in eng.params["groups"]
                             if "quant" in g.get("moe", {})])
        ptrs = [t.data_ptr() for t in quant]
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()              # this run starts here
        with StepLog() as log, contextlib.redirect_stdout(io.StringIO()):
            s = serve.serve_continuous(args, eng, lm)
        counts = ops.launch_counts()           # ... and ends here
        torch.cuda.synchronize()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        row = {"completed": s["completed"],
               "num_requests": s["num_requests"], **_step_ms(log),
               "degraded_slots": s["engine"]["tier"]["degraded_tokens"],
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "allocated_gb_before_after": [
                   alloc0 / 1e9, torch.cuda.memory_allocated() / 1e9],
               "replica_tensors_moved": sum(
                   t.data_ptr() != p for t, p in zip(quant, ptrs)),
               "launches": {k: counts[k] for k in ("route", "expert_ffn",
                                                   "quant_ffn",
                                                   "grouped_ffn")}}
        if "placement" in s["engine"]:
            p = dict(s["engine"]["placement"])
            p.pop("trace")
            row["placement"] = p
        # the mesh's own device input: a precedence step ships peer_ok,
        # [MoE layers, experts] bools, beside the masks D = 1 ships
        row["peer_input_bytes"] = (eng.num_moe_layers
                                   * eng.cfg.moe.num_experts
                                   if eng.n_devices > 1 else 0)
        if "mesh" in s["engine"]:
            row["n_peer_borrow"] = s["engine"]["mesh"]["n_peer_borrow"]
        out[tag] = row
        eng = log = quant = None
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for tag, row in out.items():
        if not tag.startswith("b_"):
            continue
        require(row["completed"] == row["num_requests"] > 0,
                f"placement ({tag}): {row['completed']} of "
                f"{row['num_requests']} requests completed")
        require(all(row["launches"][k] > 0 for k in ("expert_ffn",
                                                     "quant_ffn", "route")),
                f"placement ({tag}): a kernel of the path did not launch: "
                f"{row['launches']}")
        require(row["replica_tensors_moved"] == 0 and
                row["allocated_gb_before_after"][1]
                <= row["allocated_gb_before_after"][0],
                f"placement ({tag}): device memory moved or grew: {row}")
        if tag == "b_off":
            continue
        p = row["placement"]
        require(p["n_ticks"] > 0
                and p["coverage_repicks"] + p["replicas_issued"] > 0,
                f"placement ({tag}): no tick, re-pick or replica: {p}")
        require(row["peak_mem_bytes"] <= out["b_off"]["peak_mem_bytes"]
                + row["peer_input_bytes"],
                f"placement ({tag}): peak memory above the run without "
                f"placement (plus the mesh's peer input): "
                f"{row['peak_mem_bytes']} against "
                f"{out['b_off']['peak_mem_bytes']} bytes")
    require(out["b_live_d2"]["placement"]["peer_pushes"] > 0,
            "placement (b_live_d2): no peer push at two devices")
    return total


# ---------------------------------------------------------------------------
# the full_depth phase: the serve launcher at its defaults (no --layers:
# deepseek-v2-lite-buddy at all 27 layers, f32, batch 4, 32 new tokens,
# cache-rate 0.5, buddy, prev-step, precedence); (tag, flags, kernels the
# path must launch: topk_gate and expert_ffn in buddy profiling)
FULL_DEPTH_PATHS = (
    ("gather", [], ("route", "topk_gate", "expert_ffn")),
    ("fused", ["--fused-dispatch"],
     ("route", "topk_gate", "expert_ffn", "grouped_ffn")),
    ("cost_int8_tier", ["--quant-tier", "int8", "--miss-policy", "cost"],
     ("route", "topk_gate", "expert_ffn", "quant_ffn")),
    ("continuous", ["--mode", "continuous", "--num-requests", "8",
                    "--prefill-chunk", "8", "--fused-dispatch"],
     ("route", "topk_gate", "expert_ffn", "grouped_ffn")))
FRESH_BYTES = 1 << 30     # device memory a full-size phase may find taken
ALLOC_ROUND = 512         # the caching allocator rounds each block up to it
PROFILED_STEP = 4         # the step of each path run under torch.profiler


def moe_layers(cfg) -> int:
    return sum(r for k, r in cfg.stack() if k == "attn_moe")


def meta_weight_bytes(cfg) -> tuple:
    """(bytes, leaves) of init_params(cfg) counted on the meta device."""
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(transformer.init_params(cfg, None, "meta"))
    return nbytes(*leaves), len(leaves)


def _launcher_path(serve, argv, params, layers: int) -> dict:
    """serve.main(argv, params=params) in its own launch-count window, its
    printed summary kept out of the log, with its set-up calls (SetupLog),
    its kernel calls (KernelTap) and its steps (StepLog, the logits kept,
    step PROFILED_STEP of the path's kind profiled) recorded."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import ops
    kind = "decode" if "continuous" in argv else "probe"
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    ops.reset_launch_counts()                  # this path starts here
    t0 = time.perf_counter()
    with SetupLog() as setup, KernelTap(layers) as tap, \
            StepLog(profile=(kind, PROFILED_STEP), keep_logits=True) as log:
        with contextlib.redirect_stdout(io.StringIO()):
            s = serve.main(argv, params=params)
    torch.cuda.synchronize()
    counts = ops.launch_counts()               # ... and ends here
    return {"summary": s, "setup": setup, "tap": tap, "log": log,
            "kind": kind, "counts": counts, "run_s": time.perf_counter() - t0,
            "allocated_gb_at_start": start / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _check_launcher_path(tag: str, run: dict, kernels, vocab: int,
                         layers: int) -> dict:
    """The checks of a full-depth serve path and its row: launches per step
    and per path, the set-up's launches, the slot-outcome partition, the
    deepest layer's kernels against their plain versions, tokens in the
    vocabulary; decode ms (median of the steps of the path's kind after
    the first), the profiled step's device ms and the idle share."""
    s, log, counts = run["summary"], run["log"], run["counts"]
    st = s["stats"] if "stats" in s else s["engine"]["stats"]
    for step in log.steps:
        d = step["launches"]
        require(d["route"] == layers and d["topk_gate"] == 0
                and d["buddy_substitute"] == 0,
                f"{tag}: want route once per MoE layer and no standalone "
                f"routing kernel in every step, got {step}")
    require(all(counts[k] > 0 for k in kernels),
            f"{tag}: a kernel of the path did not launch: {counts}")
    prof = run["setup"].one("profile_buddies")
    forwards = 4 * layers                      # profile_buddies' 4 forwards
    require(prof["launches"]["topk_gate"] == forwards
            and prof["launches"]["expert_ffn"] == forwards
            and prof["launches"]["route"] == 0,
            f"{tag}: buddy profiling launched {prof['launches']}, want "
            f"topk_gate and expert_ffn once per MoE layer per forward")
    require(all(0 <= lo and hi < vocab for lo, hi in log.sampled),
            f"{tag}: a token outside the vocabulary")
    require(st["n_hit"] + st["n_sub"] + st["n_miss_fetch"] > 0,
            f"{tag}: no expert slot was served")
    walls = log.walls(run["kind"])[1:]
    prof_step = [x for x in log.steps if x.get("profiled")]
    require(len(prof_step) == 1, f"{tag}: no profiled step")
    dev_ms = prof_step[0]["device_ms"]
    med = statistics.median(walls)
    row = {"run_s": run["run_s"], "steps": len(log.steps),
           "decode_wall_ms_median": med,
           "decode_wall_ms_mean": statistics.fmean(walls),
           "decode_steps_timed": len(walls),
           "profiled_step": {"kind": run["kind"], "n": PROFILED_STEP,
                             "wall_ms": prof_step[0]["ms"],
                             "device_ms": dev_ms,
                             "device_ops": prof_step[0]["device_ops"]},
           "idle_share": None if dev_ms is None else 1 - dev_ms / med,
           "setup_s": run["setup"].seconds(),
           "allocated_gb_at_start": run["allocated_gb_at_start"],
           "peak_gb": run["peak_gb"],
           "n_hit": st["n_hit"], "n_sub": st["n_sub"],
           "n_miss_fetch": st["n_miss_fetch"],
           "n_miss_drop": st["n_miss_drop"],
           "n_upgrade_issued": st["n_upgrade_issued"],
           "kernel_calls": run["tap"].calls,
           "slot_outcomes": run["tap"].partition(),
           "deep_layer_parity": run["tap"].deep_parity(),
           "launches": counts,
           "launches_in_profiling": prof["launches"]}
    tier = s.get("tier") or s.get("engine", {}).get("tier")
    if tier is not None:
        row["degraded_slots"] = tier["degraded_tokens"]
        row["tier_quant_gb"] = tier["quant_bytes"] / 1e9
    return row


def phase_full_depth(smi: str) -> dict:
    """The serve launcher at its defaults, deepseek-v2-lite-buddy at all 27
    layers; see the module note. Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    _fresh_card()
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    require(held < FRESH_BYTES, f"full_depth: {held} bytes held on the card "
            "at the start")
    cfg = serve.model_config(serve.parse_args([]))
    layers = moe_layers(cfg)
    want_bytes, n_leaves = meta_weight_bytes(cfg)
    out = {"phase": "full_depth", "nvidia_smi": smi, "arch": cfg.arch_id,
           "layers": cfg.num_layers, "moe_layers": layers,
           "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
           "d_ff_expert": cfg.moe.d_ff, "top_k": cfg.moe.top_k,
           "dtype": cfg.dtype, "allocated_bytes_at_start": held}
    params, total, runs = None, None, {}
    for tag, flags, kernels in FULL_DEPTH_PATHS:
        _fresh_card()
        run = _launcher_path(serve, flags, params, layers)
        if params is None:
            # the defaults made the weights: every later path serves them
            params = run["log"].engine.params
            init = run["setup"].one("init_params")
            got = init["allocated_bytes"]
            out["weights"] = {"allocated_bytes": got, "meta_bytes": want_bytes,
                              "leaves": n_leaves, "init_s": init["s"],
                              "init_peak_gb": init["peak_gb"]}
            require(0 <= got - want_bytes <= ALLOC_ROUND * n_leaves,
                    f"full_depth: init_params left {got} bytes allocated, "
                    f"the meta count is {want_bytes}")
        row = _check_launcher_path(tag, run, kernels, cfg.vocab_size, layers)
        if tag == "continuous":
            s = run["summary"]
            require(s["completed"] == s["num_requests"] > 0,
                    f"full_depth (continuous): {s['completed']} of "
                    f"{s['num_requests']} requests completed")
            require(any(x["kind"] == "chunk" for x in run["log"].steps),
                    "full_depth (continuous): no chunk step")
            row.update(completed=s["completed"], requests=s["num_requests"],
                       chunk_steps=sum(x["kind"] == "chunk"
                                       for x in run["log"].steps))
        else:
            require(len(run["log"].steps) == 8 + 32 - 1,
                    f"full_depth ({tag}): {len(run['log'].steps)} steps")
        if tag == "cost_int8_tier":
            q = run["setup"].one("attach_quant_tier")
            row["quantize_and_fidelity_s"] = q["s"]
            row["tier_allocated_bytes"] = q["allocated_bytes"]
            require(row["degraded_slots"] > 0
                    and row["n_upgrade_issued"] > 0,
                    f"full_depth (cost_int8_tier): no degraded slot or no "
                    f"upgrade: {row}")
        run["tap"].deep.clear()     # its operands: the tier's replicas too
        runs[tag] = run
        out[tag] = row
        total = run["counts"] if total is None else {
            k: total[k] + run["counts"][k] for k in total}
        # drop the path's engine (and with the tier, its replicas)
        del run["log"].engine, run["summary"]
    # gather and fused on the same weights and prompts: the first step's
    # routing at every layer and its logits agree (the FFN sums run in
    # another order, so later steps may part on a near tie: counted)
    g, f = runs["gather"], runs["fused"]
    first = [(a[1], b[1]) for a, b in zip(g["tap"].routes[:layers],
                                          f["tap"].routes[:layers])]
    same_route = all(torch.equal(getattr(a, n), getattr(b, n))
                     for a, b in first for n in ROUTE_EXACT)
    lg, lf = g["log"].logits, f["log"].logits
    logit_err = max_err(lg[0], lf[0])
    top = float(lg[0].abs().max())
    lead = 0
    for a, b in zip(g["tap"].routes, f["tap"].routes):
        if not all(torch.equal(getattr(a[1], n), getattr(b[1], n))
                   for n in ROUTE_EXACT):
            break
        lead += 1
    toks_g = [int(x.argmax()) for x in torch.cat(lg[7:])]
    toks_f = [int(x.argmax()) for x in torch.cat(lf[7:])]
    out["gather_vs_fused"] = {
        "first_step_routing_equal": same_route,
        "first_step_logits_max_abs_err": logit_err,
        "first_step_logits_max_abs": top,
        "route_calls_equal_from_start": lead,
        "route_calls": len(g["tap"].routes),
        "greedy_tokens_equal": int(np.sum(np.array(toks_g)
                                          == np.array(toks_f))),
        "greedy_tokens": len(toks_g)}
    require(same_route and logit_err <= LOGIT_TOL * (1 + top),
            f"full_depth: gather and fused part at the first step: "
            f"{out['gather_vs_fused']}")
    del params, runs, g, f
    _fresh_card()
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return total


# ---------------------------------------------------------------------------
# (tag, extra flags, kernels the path must launch, mode)
MIXTRAL_PATHS = (
    ("capacity", [], ("route", "expert_ffn")),
    ("fused", ["--fused-dispatch"], ("route", "grouped_ffn")),
    ("int8_tier", TIER_FLAGS, ("route", "expert_ffn", "quant_ffn")),
    ("continuous", ["--mode", "continuous", "--slots", "4",
                    "--num-requests", "8", "--prefill-chunk", "8"],
     ("route", "expert_ffn")))


def _mixtral_path(serve, argv, params) -> tuple:
    """One Mixtral path through the launcher's entry points, in its own
    launch-count window (buddy profiling included): a batch of 4 x 8
    prompt + 8 new tokens through build_engine and generate, or
    serve.main in continuous mode, with its kernel calls (KernelTap) and
    its steps (StepLog, step PROFILED_STEP of the path's kind profiled)
    recorded. Returns (row, step log, counts, tap)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    args = serve.parse_args(argv)
    layers = moe_layers(serve.model_config(args))
    kind = "decode" if args.mode == "continuous" else "probe"
    ops.reset_launch_counts()                  # this path starts here
    t0 = time.perf_counter()
    with KernelTap(layers) as tap, \
            StepLog(profile=(kind, PROFILED_STEP)) as log:
        if args.mode == "continuous":
            with contextlib.redirect_stdout(io.StringIO()):
                s = serve.main(argv, params=params)
            eng = log.engine
            done, wanted = s["completed"], s["num_requests"]
        else:
            eng, lm = serve.build_engine(args, params=params)
            toks = eng.generate(lm.sample(args.batch, 8), args.steps)
            s = eng.summary()
            done = int(np.all((toks[:, 8:] >= 0)
                              & (toks[:, 8:] < eng.cfg.vocab_size), axis=1)
                       .sum())
            wanted = args.batch
    torch.cuda.synchronize()
    counts = ops.launch_counts()               # ... and ends here
    st = s["stats"] if "stats" in s else s["engine"]["stats"]
    ms = [x["ms"] for x in log.steps if not x.get("profiled")]
    walls = log.walls(kind)[1:]
    prof = [x for x in log.steps if x.get("profiled")]
    require(len(prof) == 1, f"{argv}: no profiled step")
    dev_ms = prof[0]["device_ms"]
    row = {"run_s": time.perf_counter() - t0, "completed": done,
           "requests": wanted, "steps": len(log.steps),
           "wall_ms_per_step_median": statistics.median(ms),
           "wall_ms_per_step_mean": statistics.fmean(ms),
           "decode_wall_ms_median": statistics.median(walls),
           "profiled_step": {"kind": kind, "n": PROFILED_STEP,
                             "wall_ms": prof[0]["ms"], "device_ms": dev_ms,
                             "device_ops": prof[0]["device_ops"]},
           "idle_share": (None if dev_ms is None
                          else 1 - dev_ms / statistics.median(walls)),
           "chunk_steps": sum(x["kind"] == "chunk" for x in log.steps),
           "n_sub": st["n_sub"], "n_hit": st["n_hit"],
           "n_miss_fetch": st["n_miss_fetch"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    if eng.tier is not None:
        row["degraded_slots"] = eng.tier.degraded_tokens
    return row, log, counts, tap


def _ffn_at_bound(tap) -> dict:
    """Each FFN kernel on the path's kept deepest-layer operands with the
    most filled rows (the last of them on a tie: the capacity branch's
    decode buffer [E, 4 x 2, D]; the fused step's [2E, 8, D] with row
    counts; the tier's degraded slots [E, 8, D] with counts): ms per call (CUDA events) and device time per call
    (torch.profiler) against its bound, the plain version's ms beside
    them. The bound: x, the output and the live groups' weights, moved
    once, and the counts where there are any; expert_ffn's live groups and
    filled rows are those of x with an element other than +-0."""
    from repro_torch.kernels.expert_ffn import expert_ffn_plain, ffn_flops
    from repro_torch.kernels.grouped_ffn import grouped_ffn_plain
    from repro_torch.kernels.ops import _CUDA
    from repro_torch.kernels.quant_ffn import quant_ffn_plain
    plains = {"expert_ffn": expert_ffn_plain,
              "grouped_ffn": grouped_ffn_plain, "quant_ffn": quant_ffn_plain}
    out = {}
    for name, plain in plains.items():
        if not tap.deep.get(name):
            continue
        at = {"expert_ffn": 4, "grouped_ffn": 5, "quant_ffn": 7}[name]
        calls = []
        for a, kw, _ in tap.deep[name]:
            g_n, c_n, _ = a[0].shape
            counts = kw.get("counts", a[at] if len(a) > at else None)
            if name == "expert_ffn":
                rows = (a[0] != 0).any(-1).cpu()
                live = rows.any(-1).nonzero()[:, 0].tolist()
                filled = int(rows.sum())
            elif counts is None:
                live, filled = list(range(g_n)), g_n * c_n
            else:
                cnt = counts.cpu()
                live = (cnt > 0).nonzero()[:, 0].tolist()
                filled = int(cnt.clamp(max=c_n).sum())
            calls.append((filled, len(calls), a, kw, counts, live))
        filled, _, a, kw, counts, live = max(calls, key=lambda c: c[:2])
        x = a[0]
        g_n, c_n, d_n = x.shape
        f_n = a[1].shape[-1]
        if name == "quant_ffn":
            per = [3 * d_n * f_n + (2 * f_n + d_n) * 4] * g_n
        else:
            e_n = a[1].shape[0]
            fp = nbytes(*a[1:4]) // e_n
            q = (0 if name == "expert_ffn" or a[4] is None
                 else nbytes(*a[4]) // e_n)
            per = [fp] * e_n + [q] * (g_n - e_n)
        moved = (sum(per[g] for g in live) + 2 * nbytes(x)
                 + (nbytes(counts) if counts is not None else 0))
        b_ms, b_by = bound(moved, ffn_flops(1, filled, d_n, f_n))
        fn = _CUDA[name]
        dev = device_us(lambda: fn(*a, **kw))["device_us"]
        ms = time_ms(lambda: fn(*a, **kw), reps=10)
        out[name] = {"shape": list(x.shape), "d_ff": f_n,
                     "live_groups": len(live), "filled_rows": filled,
                     "bytes": moved, "bound_ms": b_ms, "bound_by": b_by,
                     "ms": ms, "share_of_bound": b_ms / ms,
                     "device_ms": None if dev is None else dev / 1e3,
                     "device_share_of_bound": (None if dev is None
                                               else b_ms / (dev / 1e3)),
                     "plain_ms": time_ms(lambda: plain(*a, **kw), reps=5)}
    return out


def phase_mixtral(name: str = "mixtral", flags=MIXTRAL_FLAGS):
    """A Mixtral at full width cut to 4 layers (``flags``); see the module
    note. Returns (launches, params, cfg)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.common import resolve_device, tree_leaves
    _fresh_card()
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    require(held < FRESH_BYTES, f"{name}: {held} bytes held on the card at "
            "the start")
    args = serve.parse_args(flags)
    cfg, dev = serve.model_config(args), resolve_device(args.device)
    want_bytes, n_leaves = meta_weight_bytes(cfg)
    t0 = time.perf_counter()
    # the launcher's own weights (build_engine's: seed 0 on the card),
    # made once and given to every path
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated() - held
    out = {"phase": name, "arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
           "experts": cfg.moe.num_experts, "d_ff_expert": cfg.moe.d_ff,
           "top_k": cfg.moe.top_k, "window": cfg.sliding_window,
           "rope_theta": cfg.rope_theta, "vocab": cfg.vocab_size,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "weight_gb": sum(t.numel() * t.element_size()
                            for t in tree_leaves(params)) / 1e9,
           "weights": {"allocated_bytes": got, "meta_bytes": want_bytes,
                       "leaves": n_leaves},
           "init_s": time.perf_counter() - t0}
    require(0 <= got - want_bytes <= ALLOC_ROUND * n_leaves,
            f"{name}: init_params left {got} bytes allocated, the meta "
            f"count is {want_bytes}")
    total = None
    for tag, extra, kernels in MIXTRAL_PATHS:
        row, log, counts, tap = _mixtral_path(serve, flags + extra, params)
        out[tag] = row
        require(row["completed"] == row["requests"] > 0,
                f"{name} ({tag}): {row['completed']} of {row['requests']} "
                f"requests completed")
        require(all(counts[k] > 0 for k in kernels),
                f"{name} ({tag}): a kernel of the path did not launch: "
                f"{counts}")
        for st in log.steps:
            d = st["launches"]
            require(d["route"] == st["layers"] and d["topk_gate"] == 0
                    and d["buddy_substitute"] == 0,
                    f"{name} ({tag}): want route once per MoE layer and no "
                    f"standalone routing kernel in every step, got {st}")
            require(tag == "fused" or d["expert_ffn"] == st["layers"],
                    f"{name} ({tag}): a step left the capacity branch: "
                    f"{st}")
        row["slot_outcomes"] = tap.partition()
        row["deep_layer_parity"] = tap.deep_parity()
        row["ffn_at_bound"] = _ffn_at_bound(tap)
        tap.deep.clear()
        total = counts if total is None else {k: total[k] + counts[k]
                                              for k in total}
    require(out["int8_tier"]["degraded_slots"] > 0,
            f"{name} (int8_tier): the tier served no slot")
    require(out["continuous"]["chunk_steps"] > 0,
            f"{name} (continuous): no chunk step")
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return total, params, cfg


def phase_similarity(params, cfg) -> dict:
    """Expert output similarity. The path, in its own launch-count window:
    all_layer_similarities on the committed fixture on the card, and on the
    Mixtral phase's weights collect_layer_inputs and every layer's
    expert_output_similarity on its calibration rows (4 x 64 tokens:
    [8, 256, 4096] per layer). Then the checks: every expert_ffn call the
    path made, held raw against expert_ffn_plain on its own operands
    (TOL_F32 x (1 + the plain output's largest entry)); the fixture's
    cosine means against the CPU's, and each Mixtral layer's against the
    plain version's on the card (SIM_TOL). Times last. Returns the path's
    launches."""
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.checkpoint.io import load_npz
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import ops
    from repro_torch.kernels.expert_ffn import expert_ffn_plain
    from repro_torch.training.data import MarkovLM
    t_phase = time.perf_counter()
    out = {"phase": "similarity", "tol": SIM_TOL}
    pcfg = profiling()
    toks = MarkovLM(pcfg.vocab_size, num_blocks=8, seed=0).sample(4, 64)
    fixture = {d: load_npz(str(FIXTURE / "model.npz"), d)
               for d in ("cpu", "cuda")}
    gp = params["groups"][0]["moe"]
    moes = [{k: gp[k][li] for k in ("w1", "w3", "w2")}
            for li in range(gp["w1"].shape[0])]
    calls, kernel_ffn = [], ops.expert_ffn

    def recorded(*a):
        y = kernel_ffn(*a)
        calls.append((a, y.clone()))
        return y

    with mock.patch.object(ops, "expert_ffn", recorded):
        ops.reset_launch_counts()              # the path starts here
        got = {"cuda": sim.all_layer_similarities(pcfg, fixture["cuda"],
                                                  toks)}
        xs = sim.collect_layer_inputs(
            cfg, params, MarkovLM(cfg.vocab_size, seed=0).sample(4, 64))
        kern = [sim.expert_output_similarity(m, x) for m, x in zip(moes, xs)]
        torch.cuda.synchronize()
        counts = ops.launch_counts()           # ... and ends here
    require(counts["expert_ffn"] > 0, "similarity: expert_ffn never ran")
    raw = {}
    for a, y in calls:
        want = expert_ffn_plain(*a)
        err, top = max_err(y, want), float(want.abs().max())
        require(err <= TOL_F32 * (1 + top),
                f"similarity: expert_ffn at {tuple(a[0].shape)} x "
                f"{a[1].shape[-1]}: err {err} (max |plain| {top})")
        r = raw.setdefault(str(list(a[0].shape) + [a[1].shape[-1]]),
                           {"calls": 0, "max_abs_err": 0.0,
                            "max_abs_plain": 0.0})
        r["calls"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_abs_plain"] = max(r["max_abs_plain"], top)
    # which cuBLAS kernels the plain version ran at the Mixtral shape
    out["plain_ops"] = device_ops(lambda: expert_ffn_plain(*calls[-1][0]))
    del calls
    out["expert_ffn_raw"] = raw
    got["cpu"] = sim.all_layer_similarities(pcfg, fixture["cpu"], toks)
    err = float(abs(got["cuda"] - got["cpu"]).max())
    off = ~np.eye(pcfg.moe.num_experts, dtype=bool)
    out["fixture"] = {"max_abs_err": err,
                      "mean_off_diagonal": float(got["cuda"][:, off].mean())}
    require(err <= SIM_TOL, f"similarity (fixture): CPU and card differ "
                            f"by {err}")
    off = ~np.eye(cfg.moe.num_experts, dtype=bool)
    layers = []
    for m, x, k in zip(moes, xs, kern):
        with mock.patch.object(ops, "expert_ffn", expert_ffn_plain):
            plain = sim.expert_output_similarity(m, x)
            plain_ms = time_ms(lambda: sim.expert_output_similarity(m, x),
                               reps=3)
        e = float(abs(k - plain).max())
        require(e <= SIM_TOL, f"similarity (mixtral layer {len(layers)}): "
                              f"kernel and plain differ by {e}")
        layers.append({"max_abs_err": e, "ms": time_ms(
            lambda: sim.expert_output_similarity(m, x), reps=3),
            "plain_ms": plain_ms, "mean_off_diagonal": float(k[off].mean())})
    out["mixtral"] = {"rows": list(xs.shape[1:]), "layers": layers}
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return counts


# ---------------------------------------------------------------------------
TRAIN_KERNELS = ("wkv_chunk", "topk_gate", "expert_ffn")


def _topk_gap(logits, k: int) -> float:
    """The smallest gap between a token's K-th and (K+1)-th router logit:
    how close the routing is to a flip."""
    import torch
    v = torch.sort(logits.float(), dim=-1, descending=True).values
    return float((v[:, k - 1] - v[:, k]).min())


def phase_train_parity(arch: str = "rwkv6-1.6b"):
    """One train step of ``arch`` on the CPU (plain) and on the card: the
    reduced config, or for deepseek-v2-lite-buddy the profiling config (64
    experts, top-6, the committed fixture's shape). The RWKV6 stack runs
    wkv_chunk, a MoE stack topk_gate and expert_ffn once per MoE layer per
    forward, a dense stack no kernel of this repo. For a MoE stack every
    MoE leaf's card gradient is finite and nonzero where the CPU's is, and
    the smallest top-K router-logit gap is printed beside the error: a
    flip between CPU and card would change whole gradients."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_reduced
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.checkpoint.io import params_to_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    from repro_torch.models.common import tree_map
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)
    cfg = profiling() if arch == "deepseek-v2-lite-buddy" \
        else get_reduced(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, seed=0).sample(2, 65))
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=3,
                                               warmup_steps=10))
    gate = ops.topk_gate
    res = {}
    for d in ("cpu", "cuda"):
        seen = []

        def spy(logits, tau, *, k):            # the router logits it routes
            seen.append(logits.detach().cpu())
            return gate(logits, tau, k=k)
        before = ops.launch_counts()
        p = tree_map(lambda t: t.to(d, copy=True), params)
        x, y = toks[:, :-1].to(d), toks[:, 1:].to(d)
        ops.topk_gate = spy
        try:
            _, _, grads = loss_and_grads(p, cfg, x, y)
        finally:
            ops.topk_gate = gate
        _, _, m = step_fn(p, init_opt_state(p), x, y)
        after = ops.launch_counts()
        res[d] = (float(m["loss"]), float(m["grad_norm"]),
                  params_to_numpy(grads),
                  {k: after[k] - before[k] for k in TRAIN_KERNELS}, seen)
    (lc, nc, gc, kc, zc), (lg, ng, gg, kg, zg) = res["cpu"], res["cuda"]
    grad_rel = max(float(abs(gg[k] - gc[k]).max())
                   / max(float(abs(gc[k]).max()), 1e-30) for k in gc)
    n_moe = cfg.num_layers if cfg.is_moe else 0
    out = {"phase": "train_parity", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "tie_embeddings": cfg.tie_embeddings,
           "loss_cpu": lc, "loss_cuda": lg, "grad_norm_cpu": nc,
           "grad_norm_cuda": ng, "grad_max_rel_err": grad_rel,
           "grad_rtol": GRAD_RTOL, "loss_rtol": LOSS_RTOL,
           "launches_cpu": kc, "launches_cuda": kg}
    if n_moe:
        moe_keys = [k for k in gc if "/moe/" in k]
        out.update(
            experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
            moe_leaves=len(moe_keys),
            moe_leaves_zero_on_card=[k for k in moe_keys
                                     if abs(gc[k]).max() > 0
                                     and not abs(gg[k]).max() > 0],
            grads_finite_on_card=all(bool(np.isfinite(v).all())
                                     for v in gg.values()),
            min_topk_logit_gap_cpu=min(_topk_gap(z, cfg.moe.top_k)
                                       for z in zc),
            min_topk_logit_gap_cuda=min(_topk_gap(z, cfg.moe.top_k)
                                        for z in zg),
            router_logit_max_abs_diff=max(max_err(a, b)
                                          for a, b in zip(zc, zg)))
    emit(out)
    # two forwards per device: loss_and_grads, then the train step's
    want = {"wkv_chunk": 2 * cfg.num_layers if cfg.family == "ssm" else 0,
            "topk_gate": 2 * n_moe, "expert_ffn": 2 * n_moe}
    require(kc == dict.fromkeys(TRAIN_KERNELS, 0) and kg == want,
            f"train parity: launches {kc} / {kg}, want 0 / {want}")
    require(abs(lg - lc) <= LOSS_RTOL * abs(lc)
            and abs(ng - nc) <= LOSS_RTOL * abs(nc),
            f"train parity: loss or grad norm differ: {out}")
    require(grad_rel <= GRAD_RTOL, f"train parity: gradients differ: {out}")
    if n_moe:
        require(out["moe_leaves"] > 0 and not out["moe_leaves_zero_on_card"]
                and out["grads_finite_on_card"],
                f"train parity: a MoE gradient is zero or not finite on the "
                f"card: {out}")


def phase_train(wkv_ms: float):
    """rwkv6-1.6b at full width and depth through launch/train.py."""
    import gc
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.common import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = launch.parse_args(["--arch", "rwkv6-1.6b", "--batch", "4",
                              "--seq", "512", "--steps", "3"])
    t0 = time.perf_counter()
    trainer = launch.build_trainer(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = trainer.cfg
    n_params = sum(t.numel() for t in tree_leaves(trainer.params))
    ops.reset_launch_counts()                  # the train path starts here
    params, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    counts = ops.launch_counts()               # ... and ends here
    steps, step_s, fwd_s = _train_steps(hist, args)
    out = {"phase": "train", "arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.ssm.num_heads,
           "head_dim": cfg.ssm.head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "params": n_params,
           "batch": args.batch, "seq": args.seq, "setup_s": setup_s,
           "steps": steps, "median_step_s": step_s,
           "median_tokens_per_s": args.batch * args.seq / step_s,
           "wkv_launches_per_forward": counts["wkv_chunk"] / len(hist),
           "wkv_share_of_forward": cfg.num_layers * wkv_ms / 1e3 / fwd_s,
           "wkv_share_of_step": cfg.num_layers * wkv_ms / 1e3 / step_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    emit(out)
    require(len(hist) == 3, f"train: {len(hist)} steps")
    require(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                for s in steps), "train: non-finite loss or grad norm")
    require(counts["wkv_chunk"] == cfg.num_layers * len(hist),
            f"train: wkv_chunk launched {counts['wkv_chunk']} times, "
            f"want {cfg.num_layers} per forward")
    return counts["wkv_chunk"], params, cfg


def _train_steps(hist, args) -> tuple:
    """Per-step rows of a train run's history; (rows, median wall s,
    median forward s) over the steps after the first."""
    steps = []
    for h in hist:
        # wall_s: the host's wall time of the whole loop pass (taking and
        # copying the batch, the step, reading the metrics back); the
        # three phases are spans between CUDA events inside the step
        phases = h["forward_s"] + h["backward_s"] + h["optimizer_s"]
        steps.append({"step": h["step"], "loss": h["loss"],
                      "grad_norm": h["grad_norm"], "lr": h["lr"],
                      "wall_s": h["step_s"], "forward_s": h["forward_s"],
                      "backward_s": h["backward_s"],
                      "optimizer_s": h["optimizer_s"],
                      "device_phases_s": phases,
                      "host_gap_s": h["step_s"] - phases,
                      "tokens_per_s": args.batch * args.seq / h["step_s"]})
    steady = steps[1:] or steps
    return (steps, statistics.median(s["wall_s"] for s in steady),
            statistics.median(s["forward_s"] for s in steady))


def phase_dense_train():
    """internlm2-1.8b at full width and depth through launch/train.py: a
    dense GQA stack (16 query heads over 8 KV heads), no kernel of this
    repo on its path."""
    import gc
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.common import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    args = launch.parse_args(["--arch", "internlm2-1.8b", "--batch", "4",
                              "--seq", "512", "--steps", "3"])
    trainer = launch.build_trainer(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    cfg = trainer.cfg
    n_params = sum(t.numel() for t in tree_leaves(trainer.params))
    ops.reset_launch_counts()                  # the train path starts here
    _, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    counts = ops.launch_counts()               # ... and ends here
    del trainer
    steps, step_s, _ = _train_steps(hist, args)
    out = {"phase": "dense_train", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
           "batch": args.batch, "seq": args.seq, "setup_s": setup_s,
           "steps": steps, "median_step_s": step_s,
           "median_tokens_per_s": args.batch * args.seq / step_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts,
           **{f"median_{k}": statistics.median(s[k] for s in steps[1:])
              for k in ("forward_s", "backward_s", "optimizer_s")},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    require(len(hist) == 3, f"dense_train: {len(hist)} steps")
    require(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                for s in steps), "dense_train: non-finite loss or grad norm")
    require(cfg.num_layers == 24 and cfg.d_model == 2048,
            f"dense_train: not internlm2-1.8b's full shape: {cfg}")


MOE_TRAIN_FLAGS = ["--arch", "deepseek-v2-lite-buddy", "--layers", "4",
                   "--batch", str(TRAIN_ROWS), "--seq", str(TRAIN_SEQ),
                   "--steps", "3"]


def phase_moe_train():
    """DeepSeek-V2-Lite at full width (d_model 2048, 16 heads x 128, 64
    experts x 1408, top-6, 2 shared, vocab 102400, f32) cut to 4 of its 27
    layers, through launch/train.py (--layers 4 --batch 4 --seq 512
    --steps 3): every forward runs topk_gate and expert_ffn once per MoE
    layer, and their Functions' backward in torch ops."""
    import gc
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.common import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = launch.parse_args(MOE_TRAIN_FLAGS)
    t0 = time.perf_counter()
    trainer = launch.build_trainer(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = trainer.cfg
    n_params = sum(t.numel() for t in tree_leaves(trainer.params))
    ops.reset_launch_counts()                  # the train path starts here
    _, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    counts = ops.launch_counts()               # ... and ends here
    del trainer
    steps, step_s, _ = _train_steps(hist, args)
    n = len(hist)
    out = {"phase": "moe_train", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim,
           "experts": cfg.moe.num_experts, "expert_d_ff": cfg.moe.d_ff,
           "top_k": cfg.moe.top_k, "shared_experts":
           cfg.moe.num_shared_experts, "vocab": cfg.vocab_size,
           "params": n_params, "batch": args.batch, "seq": args.seq,
           "setup_s": setup_s, "steps": steps, "median_step_s": step_s,
           "median_tokens_per_s": args.batch * args.seq / step_s,
           **{f"median_{k}": statistics.median(s[k] for s in steps[1:])
              for k in ("forward_s", "backward_s", "optimizer_s")},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_forward": {k: counts[k] / n
                                    for k in ("topk_gate", "expert_ffn")},
           "launches": counts}
    emit(out)
    require(n == 3, f"moe_train: {n} steps")
    require(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                for s in steps), "moe_train: non-finite loss or grad norm")
    require(abs(steps[0]["loss"] - math.log(cfg.vocab_size)) < 1.0,
            f"moe_train: first loss {steps[0]['loss']} far from ln(vocab)")
    require((cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff, cfg.moe.top_k,
             cfg.num_layers) == (2048, 64, 1408, 6, 4),
            f"moe_train: not DeepSeek-V2-Lite's width at 4 layers: {cfg}")
    require(counts["topk_gate"] == counts["expert_ffn"]
            == cfg.num_layers * n,
            f"moe_train: launches {counts}, want {cfg.num_layers} topk_gate "
            f"and expert_ffn per forward")
    return counts


def phase_decode(params, cfg):
    """Chunked full-sequence forward against per-token decode, full width."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    b, s = 2, 32
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, seed=1).sample(b, s)) \
        .to("cuda")
    with torch.no_grad():
        before = ops.launch_counts()["wkv_chunk"]
        full, _ = transformer.forward_train(params, cfg, toks)
        launches = ops.launch_counts()["wkv_chunk"] - before
        caches = transformer.init_caches(cfg, b, s, device="cuda")
        err, worst = 0.0, 0.0
        for pos in range(s - 1):
            lg, caches, _ = transformer.decode_step(params, cfg, toks[:, pos],
                                                    caches, pos)
            diff = (lg - full[:, pos]).abs()
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / (1 + full[:, pos].abs()))
                                     .max()))
    out = {"phase": "decode", "batch": b, "tokens": s,
           "wkv_launches_forward": launches, "max_abs_err": err,
           "max_err_over_1_plus_abs": worst, "tol": DECODE_TOL,
           "max_abs_logit": float(full.abs().max())}
    emit(out)
    require(launches == cfg.num_layers, f"decode: {launches} wkv launches")
    require(bool(torch.isfinite(full).all()), "decode: non-finite logits")
    require(worst <= DECODE_TOL, f"decode: chunked vs step differ: {out}")


# ---------------------------------------------------------------------------
# The hybrid, VLM and audio families: plain torch ops, none of the seven
# kernels on their paths (each phase resets the counts and requires zero)
FAMILIES = ("zamba2-7b", "llama-3.2-vision-11b", "musicgen-large")
FAMILY_ROWS, FAMILY_PROMPT = 4, 512
HYBRID_TRAIN_FLAGS = ["--arch", "zamba2-7b", "--layers", "15", "--batch",
                      str(TRAIN_ROWS), "--seq", str(TRAIN_SEQ), "--steps",
                      "3"]


def _fresh_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _no_launches(tag: str) -> dict:
    """The counts since the window's reset: no kernel of this repo may
    have launched."""
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    require(not any(counts.values()), f"{tag}: a kernel launched: {counts}")
    return counts


def _sync_s(fn) -> tuple:
    """(fn's result, its seconds on the synchronized host clock)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _rel_err(got, want) -> float:
    """max |got - want| / (1 + |want|), DECODE_TOL's form."""
    return float(((got.float() - want.float()).abs()
                  / (1 + want.float().abs())).max())


def _family_model(arch: str, layers: int = 0) -> tuple:
    """(config cut to ``layers`` if given, seed-0 weights made on the
    card, setup seconds, parameter count)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_leaves
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params, setup_s = _sync_s(lambda: transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    return cfg, params, setup_s, sum(t.numel() for t in tree_leaves(params))


def _serve_family(cfg, params, n_decode: int, cond=None) -> tuple:
    """Prefill (forward_train's logits) of FAMILY_ROWS x FAMILY_PROMPT
    tokens twice (the second is the steady one), then ``n_decode``
    teacher-forced decode_steps on the prompt's tokens from fresh caches
    sized for prompt and new tokens, each on the synchronized host clock,
    and one more under torch.profiler (its device time, device ops and
    the eight device ops that took longest, by name). Returns (row,
    tokens, prefill logits, decode logits [n_decode, B, V])."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, seed=0).sample(
        FAMILY_ROWS, FAMILY_PROMPT)).to("cuda")
    with torch.no_grad():
        pre_s = []
        for _ in range(2):
            logits, sec = _sync_s(lambda: transformer.prefill(
                params, cfg, toks, cond_embeds=cond))
            pre_s.append(sec)
        caches = transformer.init_caches(cfg, FAMILY_ROWS,
                                         FAMILY_PROMPT + n_decode,
                                         device="cuda")
        step_s, dec = [], []
        for pos in range(n_decode):
            (lg, _, _), sec = _sync_s(lambda: transformer.decode_step(
                params, cfg, toks[:, pos], caches, pos))
            step_s.append(sec)
            dec.append(lg)
        prof = device_us(lambda: transformer.decode_step(
            params, cfg, toks[:, n_decode], caches, n_decode), n=1,
            by_op=True)
    med = statistics.median(step_s[1:])
    busy = prof["device_us"]
    row = {"rows": FAMILY_ROWS, "prompt": FAMILY_PROMPT,
           "prefill_s": pre_s,
           "prefill_tokens_per_s": FAMILY_ROWS * FAMILY_PROMPT / pre_s[-1],
           "decode_steps": n_decode, "decode_step_ms": [1e3 * t
                                                        for t in step_s],
           "median_decode_ms": 1e3 * med,
           "decode_tokens_per_s": FAMILY_ROWS / med,
           "decode_device_ms": None if busy is None else busy / 1e3,
           "decode_device_ops": prof["device_ops_per_call"],
           "decode_idle_share": (None if busy is None
                                 else 1 - busy / 1e3 / (1e3 * med)),
           "decode_top_device_ms": dict(sorted(
               ((k, us / 1e3) for k, us in
                (prof.get("device_us_by_op") or {}).items()),
               key=lambda kv: -kv[1])[:8]),
           "kv_capacity": FAMILY_PROMPT + n_decode + cfg.num_cond_tokens}
    return row, toks, logits, torch.stack(dec)


def _finite(*ts) -> bool:
    import torch
    return all(bool(torch.isfinite(t).all()) for t in ts)


def phase_families_parity():
    """The three reduced configs, weights from seed 0 made on the CPU:
    forward (S = 32: the hybrid's chunked scan), 4 decode steps (its
    per-token recurrence) and one train step on the CPU and on the card,
    with conditioning where the config has it."""
    import torch
    from repro_torch.checkpoint.io import params_to_numpy
    from repro_torch.configs.base import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_map
    from repro_torch.training.data import MarkovLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)
    rows = []
    for arch in FAMILIES:
        cfg = get_reduced(arch)
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu")
        toks = torch.from_numpy(MarkovLM(cfg.vocab_size, seed=0)
                                .sample(2, 33))
        cond = (torch.randn(2, cfg.num_cond_tokens, cfg.cond_dim,
                            generator=torch.Generator().manual_seed(1))
                if cfg.num_cond_tokens else None)
        step_fn = make_train_step(cfg, AdamWConfig(total_steps=3,
                                                   warmup_steps=10))
        res = {}
        ops.reset_launch_counts()              # the window starts here
        for d in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(d, copy=True), params)
            c = None if cond is None else cond.to(d)
            x, y = toks[:, :-1].to(d), toks[:, 1:].to(d)
            with torch.no_grad():
                fwd = transformer.forward_train(p, cfg, x,
                                                cond_embeds=c)[0].cpu()
                caches = transformer.init_caches(cfg, 2, 8, device=d)
                dec = torch.stack([transformer.decode_step(
                    p, cfg, x[:, i], caches, i)[0] for i in range(4)]).cpu()
            _, _, grads = loss_and_grads(p, cfg, x, y, cond_embeds=c)
            _, _, m = step_fn(p, init_opt_state(p), x, y, cond_embeds=c)
            res[d] = (fwd, dec, float(m["loss"]), float(m["grad_norm"]),
                      params_to_numpy(grads))
        counts = _no_launches(f"families_parity {arch}")   # ... ends here
        (fc, dc, lc, nc, gc), (fg, dg, lg, ng, gg) = res["cpu"], res["cuda"]
        row = {"arch": cfg.arch_id, "stack": cfg.stack(),
               "forward_max_abs_err": max_err(fg, fc),
               "decode_max_abs_err": max_err(dg, dc),
               "max_abs_logit": float(fc.abs().max()),
               "loss_cpu": lc, "loss_cuda": lg, "grad_norm_cpu": nc,
               "grad_norm_cuda": ng,
               "grad_max_rel_err": max(
                   float(abs(gg[k] - gc[k]).max())
                   / max(float(abs(gc[k]).max()), 1e-30) for k in gc),
               "launches": counts}
        rows.append(row)
        require(row["forward_max_abs_err"] <= LOGIT_TOL
                and row["decode_max_abs_err"] <= LOGIT_TOL,
                f"families_parity: logits differ: {row}")
        require(abs(lg - lc) <= LOSS_RTOL * abs(lc)
                and abs(ng - nc) <= LOSS_RTOL * abs(nc)
                and row["grad_max_rel_err"] <= GRAD_RTOL,
                f"families_parity: train step differs: {row}")
    emit({"phase": "families_parity", "logit_tol": LOGIT_TOL,
          "loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL, "archs": rows})


def phase_hybrid():
    """Zamba2-7B at full width and depth (81 layers: 13 super-blocks of 6
    Mamba2 layers and the shared attention block, then 3 Mamba2 layers):
    prefill 4 x 512 through the chunked scan, 32 decode steps through the
    per-token recurrence; then decode against forward on 2 x 32 tokens on
    the 15-layer cut, within DECODE_TOL."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    _fresh_card()
    cfg, params, setup_s, n_params = _family_model("zamba2-7b")
    require((cfg.num_layers, cfg.d_model, cfg.stack())
            == (81, 3584, (("hybrid_super", 13), ("mamba2", 3))),
            f"hybrid: not Zamba2-7B's full shape: {cfg}")
    ops.reset_launch_counts()                  # the serve path starts here
    row, _, logits, dec = _serve_family(cfg, params, 32)
    counts = _no_launches("hybrid")            # ... and ends here
    finite = _finite(logits, dec)
    # prefill (chunked scan) against decode (recurrence), the prompt's
    # first 32 positions, at full depth: printed, not required
    full_depth_err = _rel_err(dec.transpose(0, 1), logits[:, :32])
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, logits, dec
    _fresh_card()
    cfg15, p15, _, n15 = _family_model("zamba2-7b", 15)
    ops.reset_launch_counts()                  # the decode check's window
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, seed=1).sample(2, 32)) \
        .to("cuda")
    with torch.no_grad():
        full, _ = transformer.forward_train(p15, cfg15, toks)
        caches = transformer.init_caches(cfg15, 2, 32, device="cuda")
        worst = max(_rel_err(transformer.decode_step(
            p15, cfg15, toks[:, pos], caches, pos)[0], full[:, pos])
            for pos in range(31))
    counts15 = _no_launches("hybrid decode check")
    out = {"phase": "hybrid", "arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "ssm_heads": cfg.ssm.num_heads,
           "ssm_head_dim": cfg.ssm.head_dim, "state_dim": cfg.ssm.state_dim,
           "attn_head_dim": cfg.head_dim, "params": n_params,
           "setup_s": setup_s, **row, "peak_mem_gb": peak,
           "finite": finite,
           "full_depth_decode_vs_prefill_err": full_depth_err,
           "decode_check": {"layers": cfg15.num_layers, "params": n15,
                            "tokens": 32, "rows": 2,
                            "max_err_over_1_plus_abs": worst,
                            "tol": DECODE_TOL,
                            "max_abs_logit": float(full.abs().max())},
           "launches": counts, "launches_decode_check": counts15}
    emit(out)
    require(finite, "hybrid: non-finite logits")
    require(worst <= DECODE_TOL, f"hybrid: decode vs forward: {out}")


def phase_vlm():
    """Llama-3.2-Vision-11B at full width and depth (40 layers: 8
    super-blocks of 4 self-attention layers and a cross-attention layer):
    conditioning [4, 1601, 4096] from a seed, prefill 4 x 512 with it and
    without it, 16 decode steps (which, as the reference's, attend over
    zero cross keys and values: decode equals a forward on zero
    conditioning, within DECODE_TOL)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    _fresh_card()
    cfg, params, setup_s, n_params = _family_model("llama-3.2-vision-11b")
    require((cfg.num_layers, cfg.d_model, cfg.num_cond_tokens, cfg.cond_dim)
            == (40, 4096, 1601, 4096),
            f"vlm: not Llama-3.2-Vision-11B's full shape: {cfg}")
    cond = torch.randn(FAMILY_ROWS, cfg.num_cond_tokens, cfg.cond_dim,
                       device="cuda", generator=torch.Generator(
                           device="cuda").manual_seed(1))
    n_dec = 16
    ops.reset_launch_counts()                  # the serve path starts here
    row, toks, logits, dec = _serve_family(cfg, params, n_dec, cond)
    with torch.no_grad():
        bare, bare_s = _sync_s(lambda: transformer.prefill(params, cfg,
                                                           toks))
        zero = transformer.prefill(params, cfg, toks,
                                   cond_embeds=torch.zeros_like(cond))
    counts = _no_launches("vlm")               # ... and ends here
    out = {"phase": "vlm", "arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "cond": list(cond.shape),
           "params": n_params, "setup_s": setup_s, **row,
           "prefill_without_image_s": bare_s,
           "finite": _finite(logits, bare, dec),
           "image_changes_logits_by": max_err(logits, bare),
           "decode_vs_zero_image_prefill_err": _rel_err(
               dec.transpose(0, 1), zero[:, :n_dec]),
           "tol": DECODE_TOL,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    del params, logits, bare, zero, dec
    emit(out)
    require(out["finite"], "vlm: non-finite logits")
    require(out["image_changes_logits_by"] > LOGIT_TOL,
            f"vlm: the image does not change the logits: {out}")
    require(out["decode_vs_zero_image_prefill_err"] <= DECODE_TOL,
            f"vlm: decode vs zero-image forward: {out}")


def phase_audio():
    """MusicGen-Large at full width and depth (48 layers, d_model 2048):
    conditioning [4, 256, 2048] as the causal prefix, prefill 4 x 512 (the
    logits cover the tokens only), 16 decode steps at positions shifted by
    the prefix (no entry point writes the prefix into the cache, as the
    reference's)."""
    import torch
    from repro_torch.kernels import ops
    _fresh_card()
    cfg, params, setup_s, n_params = _family_model("musicgen-large")
    require((cfg.num_layers, cfg.d_model, cfg.num_cond_tokens)
            == (48, 2048, 256),
            f"audio: not MusicGen-Large's full shape: {cfg}")
    cond = torch.randn(FAMILY_ROWS, cfg.num_cond_tokens, cfg.cond_dim,
                       device="cuda", generator=torch.Generator(
                           device="cuda").manual_seed(1))
    ops.reset_launch_counts()                  # the serve path starts here
    row, _, logits, dec = _serve_family(cfg, params, 16, cond)
    counts = _no_launches("audio")             # ... and ends here
    out = {"phase": "audio", "arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "cond": list(cond.shape), "params": n_params,
           "setup_s": setup_s, **row, "logits_shape": list(logits.shape),
           "finite": _finite(logits, dec),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    del params, logits, dec
    emit(out)
    require(out["finite"], "audio: non-finite logits")
    require(out["logits_shape"] == [FAMILY_ROWS, FAMILY_PROMPT,
                                    cfg.vocab_size],
            f"audio: logits {out['logits_shape']}")


def phase_hybrid_train():
    """zamba2-7b --layers 15 (2 super-blocks and 3 Mamba2 layers, 1.60 B
    parameters) at full width through launch/train.py, --batch 4 --seq
    512 --steps 3."""
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.common import tree_leaves
    _fresh_card()
    args = launch.parse_args(HYBRID_TRAIN_FLAGS)
    trainer, setup_s = _sync_s(lambda: launch.build_trainer(args))
    cfg = trainer.cfg
    n_params = sum(t.numel() for t in tree_leaves(trainer.params))
    ops.reset_launch_counts()                  # the train path starts here
    _, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    counts = _no_launches("hybrid_train")      # ... and ends here
    del trainer
    steps, step_s, _ = _train_steps(hist, args)
    out = {"phase": "hybrid_train", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "stack": cfg.stack(),
           "d_model": cfg.d_model, "params": n_params, "batch": args.batch,
           "seq": args.seq, "setup_s": setup_s, "steps": steps,
           "median_step_s": step_s,
           "median_tokens_per_s": args.batch * args.seq / step_s,
           **{f"median_{k}": statistics.median(s[k] for s in steps[1:])
              for k in ("forward_s", "backward_s", "optimizer_s")},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    emit(out)
    require(len(hist) == 3, f"hybrid_train: {len(hist)} steps")
    require(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                for s in steps), "hybrid_train: non-finite loss or grad norm")
    require(cfg.stack() == (("hybrid_super", 2), ("mamba2", 3))
            and cfg.d_model == 3584,
            f"hybrid_train: not Zamba2-7B's width at 15 layers: {cfg}")


# ---------------------------------------------------------------------------
# The launch tooling: the dry run on meta, and meta against the card
DRYRUN_CASES = (("deepseek-v2-lite-buddy", "decode_32k"),
                ("mixtral-8x7b", "train_4k"),
                ("internlm2-1.8b", "prefill_32k"))
SHARE_MAX = 1.05      # bound / device time above this: the count is wrong
DRYRUN_REPS = 10      # timed steps (median) after the counted one
LONG_STEP_S = 1.5     # a counted step over this: no warm-up, wall or profile
# The card's peak against the meta trace's (roofline.OpCounter's tracker:
# each new storage rounded up to 512 bytes, as the CUDA caching allocator
# rounds every block). The allocator hands a request from its large pool
# (over 1 MiB) a cached block whole when splitting it would leave 1 MiB or
# less, so each large block live at the peak may hold up to 1 MiB more than
# it asked for: PEAK_SLACK per block over SMALL_BLOCK live at the meta
# peak is the tolerance, either way.
SMALL_BLOCK = 1 << 20
PEAK_SLACK = 1 << 20
SHARDED_ARCH, SHARDED_SHAPE = "internlm2-1.8b", "train_4k"
SHARDED_REPS = 3      # timed steps of rank 0's share on the card


def peak_tolerance(blocks) -> int:
    """PEAK_SLACK for each block over SMALL_BLOCK among ``blocks`` (the
    rounded sizes live at the meta trace's peak)."""
    return PEAK_SLACK * sum(1 for b in blocks if b > SMALL_BLOCK)


def card_peak(step) -> int:
    """Bytes the caching allocator handed out at most while ``step()``
    ran, beyond what it held before (a warm-up has run, so the cuBLAS
    workspace already stands)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_dryrun_meta():
    """The dry run at production scale on the meta device (nothing on the
    card): run_one on the 16 x 16 mesh for DRYRUN_CASES (rank 0's share of
    the sharded step), one line each with per-device argument GB, FLOPs,
    bytes, collective bytes by op and their counts, temp_size_bytes, the
    compute, memory and collective terms under the H100 HardwareSpec and
    the dominant term."""
    from repro_torch.launch import dryrun
    for arch, shape in DRYRUN_CASES:
        out = dryrun.run_one(arch, shape, verbose=False,
                             results_dir=OUT_DIR / "dryrun_torch")
        r, c = out["roofline"], out["counts"]
        emit({"phase": "dryrun", "case": "meta", "arch": arch,
              "shape": shape, "mesh": out["mesh"], "chips": out["chips"],
              "trace_s": out["trace_s"],
              "argument_gb_per_device":
                  out["memory"]["argument_size_bytes"] / 1e9,
              "output_gb_per_device": out["memory"]["output_size_bytes"] / 1e9,
              "flops": c["flops"], "bytes": c["bytes"],
              "kernel_calls": {k: v["calls"] for k, v in
                               c["by_kernel"].items()},
              "coll_bytes_by_op": out["hlo_analysis"]["coll_bytes_by_op"],
              "coll_counts": out["hlo_analysis"]["coll_counts"],
              "temp_size_bytes": out["memory"]["temp_size_bytes"],
              "peak_bytes": out["memory"]["peak_bytes"],
              "compute_s": r["compute_s"], "memory_s": r["memory_s"],
              "collective_s": r["collective_s"], "dominant": r["dominant"],
              "split": r["split"], "link": r["link"],
              "hardware": r["hardware"]})
        require(c["flops"] > 0 and c["bytes"] > 0
                and r["collective_s"] is not None and r["collective_s"] > 0
                and out["memory"]["temp_size_bytes"] is not None
                and r["dominant"] in ("compute", "memory", "collective"),
                f"dryrun ({arch} {shape}): empty count {r}")
        require(arch == "internlm2-1.8b" or c["by_kernel"],
                f"dryrun ({arch} {shape}): no kernel charged")


def _tensors(tree) -> list:
    from repro_torch.models.common import tree_leaves
    import torch
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _dryrun_card(tag: str, cfg, kind: str, batch: int, seq: int, smi: str,
                 kernels, params=None, reps: int = DRYRUN_REPS) -> dict:
    """One step traced on meta, then run on the card under the same
    OpCounter (outside any timed window), then timed: equal FLOPs, bytes
    and kernel charges; the predicted argument bytes (the meta arguments
    under their specs on a one-device mesh) equal to the card tensors'
    nbytes; the counted run's launches equal to the kernel charges; the
    roofline bound max(FLOPs / the dtype's peak, bytes / HBM) over the
    median CUDA-event time of ``reps`` steps (the share) at most
    SHARE_MAX, then as many synchronized steps for the wall and the
    profiler's device-busy time of three. A step whose counted run took
    over LONG_STEP_S is a long one (a 32k-token prefill takes seconds,
    its host issue a fraction of a percent): the counted run is its
    warm-up, and neither its wall nor its device-busy time is read.
    Returns the launches of the card part."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import activation_rules, profile_for
    t0 = time.perf_counter()
    meta_case = dryrun.make_case(cfg, kind, batch, seq, device="meta")
    meta_c, meta_out = dryrun.trace(meta_case)
    trace_s = time.perf_counter() - t0
    prof = profile_for(cfg, train=kind == "train")
    arg_specs, _ = dryrun.case_specs(cfg, meta_case, meta_out, prof,
                                     activation_rules(prof, cfg, 1))
    one = MeshShape((1, 1), ("data", "model"))
    predicted = dryrun.memory_per_device(meta_case.args, arg_specs, one)
    del meta_case, meta_out
    _fresh_card()
    alloc0 = torch.cuda.memory_allocated()
    case = dryrun.make_case(cfg, kind, batch, seq, device="cuda",
                            params=params)
    torch.cuda.synchronize()
    alloc_delta = torch.cuda.memory_allocated() - alloc0
    real = {k: sum(t.numel() * t.element_size() for t in _tensors(v))
            for k, v in case.args.items() if k in predicted}
    t0 = time.perf_counter()
    case.fn(case.args)                         # warm-up: cuBLAS workspace
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()                  # the counted step
    t0 = time.perf_counter()
    held = {}

    def counted_step():
        held["c"], _ = dryrun.trace(case)
    peak = card_peak(counted_step)
    card_c = held.pop("c")
    counted_s = time.perf_counter() - t0
    counted = ops.launch_counts()
    meta_d, card_d = meta_c.as_dict(), card_c.as_dict()
    op_diff = {k: [meta_d["by_op"].get(k), card_d["by_op"].get(k)]
               for k in set(meta_d["by_op"]) | set(card_d["by_op"])
               if meta_d["by_op"].get(k) != card_d["by_op"].get(k)}

    def step():
        case.fn(case.args)

    long_step = counted_s > LONG_STEP_S
    events = event_ms(step, reps, warm=0 if long_step else 2)
    ev_ms = statistics.median(events)
    walls, busy = [], {"device_us": None, "device_ops_per_call": None}
    if not long_step:
        for _ in range(reps):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - w0) * 1e3)
        busy = device_us(step, n=3)
    launches = ops.launch_counts()             # ... and ends here
    dtype = str(cfg.dtype)
    compute_ms = meta_c.flops / rl.H100.peak(dtype) * 1e3
    memory_ms = meta_c.bytes / rl.H100.hbm_bytes_per_s * 1e3
    bound_ms = max(compute_ms, memory_ms)
    busy_ms = None if busy["device_us"] is None else busy["device_us"] / 1e3
    row = {"phase": "dryrun", "case": tag, "arch": cfg.arch_id,
           "layers": cfg.num_layers, "kind": kind, "batch": batch,
           "seq": seq, "dtype": dtype, "meta_trace_s": trace_s,
           "flops": {"meta": meta_d["flops"], "card": card_d["flops"]},
           "bytes": {"meta": meta_d["bytes"], "card": card_d["bytes"]},
           "kernel_charges": {"meta": meta_d["by_kernel"],
                              "card": card_d["by_kernel"]},
           "by_op_differences": op_diff,
           "argument_bytes": {"predicted": predicted, "real": real},
           "memory_allocated_delta_bytes": alloc_delta,
           "peak_bytes": {"meta": meta_c.peak_bytes, "card": peak,
                          "card_tracker": card_c.peak_bytes,
                          "tolerance": peak_tolerance(meta_c.peak_blocks),
                          "gap": peak - meta_c.peak_bytes},
           "temp_size_bytes": {"meta": meta_c.temp_size_bytes,
                               "card_tracker": card_c.temp_size_bytes},
           "warm_up_s": warm_s,
           "params_made_before_phase": params is not None,
           "launches_counted_step": counted,
           "counted_step_s": counted_s, "long_step": long_step,
           "reps": reps, "event_ms_median": ev_ms, "event_ms": events,
           "wall_ms_median": statistics.median(walls) if walls else None,
           "wall_ms": walls,
           "device_busy_ms": busy_ms,
           "device_ops_per_step": busy["device_ops_per_call"],
           "compute_ms": compute_ms, "memory_ms": memory_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if compute_ms >= memory_ms else "bytes",
           "share": bound_ms / ev_ms,
           "share_of_busy": None if not busy_ms else bound_ms / busy_ms,
           "hardware": rl.H100.name, "nvidia_smi": smi}
    emit(row)
    require(meta_d["flops"] == card_d["flops"]
            and meta_d["bytes"] == card_d["bytes"]
            and meta_d["by_kernel"] == card_d["by_kernel"],
            f"dryrun ({tag}): meta and card counts differ: {op_diff}")
    require(predicted == real,
            f"dryrun ({tag}): argument bytes {predicted} != {real}")
    require(abs(peak - meta_c.peak_bytes) <= row["peak_bytes"]["tolerance"],
            f"dryrun ({tag}): card peak {row['peak_bytes']} against meta")
    require(all(counted[k] == card_d["by_kernel"].get(k, {}).get("calls", 0)
                for k in counted) and all(counted[k] > 0 for k in kernels),
            f"dryrun ({tag}): launches {counted} against the charges "
            f"{card_d['by_kernel']}")
    require(row["share"] <= SHARE_MAX,
            f"dryrun ({tag}): share {row['share']} above {SHARE_MAX}")
    return launches


def phase_dryrun_mixtral(params, cfg, smi: str) -> dict:
    """(a) Mixtral-8x7B at the mixtral phase's configuration and weights (4
    layers, f32, batch 4): one decode step on the capacity branch (T * K =
    8 = E: expert_ffn streams every expert; route once per layer)."""
    return _dryrun_card("mixtral_capacity_decode", cfg, "decode", 4, 16,
                        smi, ("route", "expert_ffn"), params=params)


def phase_dryrun_train(smi: str) -> dict:
    """(b) DeepSeek-V2-Lite at full width, 4 layers, f32: one train step at
    batch 4 x 512 (moe_train's), lm_loss forward and backward with remat,
    then AdamW; topk_gate and expert_ffn twice per layer (the forward and
    remat's recompute)."""
    from repro_torch.launch import train as launch
    cfg = launch.build_config(launch.parse_args(MOE_TRAIN_FLAGS))
    return _dryrun_card("deepseek_train_step", cfg, "train", TRAIN_ROWS,
                        TRAIN_SEQ, smi, ("topk_gate", "expert_ffn"))


# ---------------------------------------------------------------------------
# Long context: the reference's chunked attention (_flash_attend) on the card
FLASH_TOL = 1e-5      # chunked vs whole-matrix softmax, f32, unit inputs:
#                       the same sums, the row's max and denominator taken
#                       per kv chunk instead of once
LONG_ARCH = "internlm2-1.8b"
LONG_SEQ = 32768      # the dry run's prefill_32k, at batch 1
LONG_TAIL = 512       # last positions held against the ring path
LONG_TAIL_RTOL = 1e-4  # ... also within this share of the tail's largest
#                        logit (random weights keep logits near 1, so a
#                        mask error may move them by less than LOGIT_TOL)
RING_CHUNK = 2048     # the ring path's chunk: [1, 16, 2048, 32768] f32 scores
LONG_REPS = 3         # timed steps of the two long dryrun cases
TRAIN_4K = 4096       # the dry run's train_4k, at batch 1
# name, query heads, KV heads, queries, keys, causal, window
FLASH_CASES = (("internlm2_causal_4k", 16, 8, 4096, 4096, True, 0),
               ("mixtral_window_8k", 32, 8, 8192, 8192, True, 4096),
               ("vision_cross_1601", 32, 8, 512, 1601, False, 0))


def _peak_gb(fn) -> tuple:
    """(fn's result, the card memory it took above what was allocated
    before it, GB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def _flash_case(gen, name, h, kv, sq, skv, causal, window) -> dict:
    """_flash_attend against _attend (the whole [Sq, Skv] softmax) on the
    same card tensors, B = 1, head dim 128, f32: the max abs error, ms and
    peak GB of each; the first case also its backward (each gradient's
    error over its largest entry)."""
    import torch
    from repro_torch.models import attention as A
    q, k, v = [torch.randn(shape, generator=gen).cuda() for shape in
               ((1, sq, h, 128), (1, skv, kv, 128), (1, skv, kv, 128))]
    valid = None
    if causal:
        qpos = torch.arange(sq, device="cuda")[:, None]
        kpos = torch.arange(skv, device="cuda")[None, :]
        valid = kpos <= qpos
        if window:
            valid = valid & (kpos > qpos - window)
        valid = valid[None]

    def flash(q=q, k=k, v=v):
        return A._flash_attend(q, k, v, 0, causal=causal, window=window)

    def whole(q=q, k=k, v=v):
        return A._attend(q, k, v, valid)

    row = {"case": name, "heads": h, "kv_heads": kv, "queries": sq,
           "keys": skv, "causal": causal, "window": window,
           "kv_chunks": -(-skv // min(1024, skv))}
    if window:
        # rows that see no key of kv chunk 0: its scores all -1e30
        row["rows_blind_to_chunk_0"] = max(0, sq - (1024 + window - 1))
    with torch.no_grad():
        got, row["flash_peak_gb"] = _peak_gb(flash)
        want, row["whole_peak_gb"] = _peak_gb(whole)
        row["max_abs_err"] = max_err(got, want)
        row["max_abs_out"] = float(want.abs().max())
        row["flash_ms"] = time_ms(flash, reps=5)
        row["whole_ms"] = time_ms(whole, reps=5)
        for tag, fn in (("flash", flash), ("whole", whole)):
            prof = device_us(fn, n=1, by_op=True)
            row[f"{tag}_device_ms_by_op"] = dict(sorted(
                ((op, us / 1e3) for op, us in
                 (prof.get("device_us_by_op") or {}).items()),
                key=lambda kv: -kv[1])[:6])
    require(_finite(got) and row["max_abs_err"] <= FLASH_TOL,
            f"long_context ({name}): flash vs whole {row['max_abs_err']}")
    if name == FLASH_CASES[0][0]:
        w = torch.randn(got.shape, generator=gen).cuda()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads = [torch.autograd.grad((fn(*leaves) * w).sum(), leaves)
                 for fn in (flash, whole)]
        row["grad_rel_err"] = {n: _grad_rel(a, b) for n, a, b in
                               zip("qkv", *grads)}
        row["flash_fwd_bwd_ms"], row["whole_fwd_bwd_ms"] = [
            time_ms(lambda fn=fn: torch.autograd.grad(
                (fn(*leaves) * w).sum(), leaves), reps=5)
            for fn in (flash, whole)]
        require(max(row["grad_rel_err"].values()) <= GRAD_RTOL,
                f"long_context ({name}): gradients {row['grad_rel_err']}")
    return row


def phase_long_context(smi: str):
    """(a) _flash_attend against _attend at FLASH_CASES; (b) LONG_ARCH at
    full width and depth, transformer.prefill of 1 x LONG_SEQ tokens, its
    last LONG_TAIL logits against the ring path (prefill_chunk in chunks
    of RING_CHUNK into caches of LONG_SEQ slots, attention through
    _attend). The layer cases carry the check of the chunk loop (their
    outputs are of unit scale); the tail shows that the whole depth runs
    and fits at 32k and agrees with the ring path. No kernel of this repo
    launches. Returns the weights for the prefill_32k dryrun case."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    _fresh_card()
    ops.reset_launch_counts()                 # the long-context path
    gen = torch.Generator().manual_seed(0)
    for case in FLASH_CASES:
        emit({"phase": "long_context", "part": "layer",
              **_flash_case(gen, *case)})
        _fresh_card()
    cfg, params, setup_s, n_params = _family_model(LONG_ARCH)
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, seed=0).sample(
        1, LONG_SEQ)).cuda()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        logits, pre_s = _sync_s(lambda: transformer.prefill(params, cfg,
                                                            toks))
        pre_peak = torch.cuda.max_memory_allocated() / 1e9
        finite = _finite(logits)
        logits_gb = logits.numel() * logits.element_size() / 1e9
        tail = logits[:, -LONG_TAIL:].clone()
        del logits
        _fresh_card()
        caches = transformer.init_caches(cfg, 1, LONG_SEQ, device="cuda")
        cache_gb = sum(t.numel() * t.element_size()
                       for t in _tensors(caches)) / 1e9
        ring_steps = []
        for c0 in range(0, LONG_SEQ, RING_CHUNK):
            (ring, _, _), sec = _sync_s(lambda: transformer.prefill_chunk(
                params, cfg, toks[:, c0:c0 + RING_CHUNK], caches,
                np.array([c0]), np.ones((1, RING_CHUNK), bool)))
            ring_steps.append(sec)
        ring_peak = torch.cuda.max_memory_allocated() / 1e9
        err = max_err(tail, ring[:, -LONG_TAIL:])
        del caches, ring
    launched = _no_launches("long_context")
    row = {"phase": "long_context", "part": "prefill", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "params": n_params, "setup_s": setup_s, "batch": 1,
           "seq": LONG_SEQ, "prefill_s": pre_s,
           "prefill_tokens_per_s": LONG_SEQ / pre_s,
           "prefill_peak_gb": pre_peak, "logits_gb": logits_gb,
           "ring_chunk": RING_CHUNK, "ring_cache_gb": cache_gb,
           "ring_s": sum(ring_steps), "ring_step_s": ring_steps,
           "ring_peak_gb": ring_peak,
           "tail": LONG_TAIL, "tail_max_abs_err": err,
           "tail_max_abs_logit": float(tail.abs().max()),
           "launches": launched, "nvidia_smi": smi}
    emit(row)
    require(finite, "long_context: non-finite prefill logits")
    tol = min(LOGIT_TOL, LONG_TAIL_RTOL * row["tail_max_abs_logit"])
    require(err <= tol, f"long_context: prefill vs ring logits {err} > {tol}")
    return cfg, params


def phase_dryrun_prefill_32k(cfg, params, smi: str) -> dict:
    """(c) the dry run's long shapes on the card at batch 1, each with
    LONG_REPS timed steps: LONG_ARCH's prefill_32k (forward_train of 1 x
    LONG_SEQ) on the long_context phase's weights, ..."""
    return _dryrun_card("internlm2_prefill_32k", cfg, "prefill", 1,
                        LONG_SEQ, smi, (), params=params, reps=LONG_REPS)


def phase_dryrun_train_4k(cfg, smi: str) -> dict:
    """... and train_4k (1 x TRAIN_4K: lm_loss forward and backward with
    remat, then AdamW) on weights and optimizer state of its own."""
    return _dryrun_card("internlm2_train_4k", cfg, "train", 1, TRAIN_4K,
                        smi, (), reps=LONG_REPS)


def phase_dryrun_sharded(smi: str) -> dict:
    """(d) Rank 0's share of the sharded step on the card: SHARDED_ARCH's
    SHARDED_SHAPE (internlm2-1.8b train_4k, bf16: 16 rows x 4,096 tokens
    per device, lm_loss with remat, then AdamW) as rank 0 of the 16 x 16
    mesh over the fake backend (launch.dryrun.sharded on "cuda"), traced
    first on meta (a CPU mesh). The card's arguments are rank 0's blocks
    of random full-width weights (the global ones freed once they are
    cut); its collectives move no data, so the step runs rank 0's local
    work. A warm-up step, then the counted one under the same OpCounter as
    the meta trace: equal FLOPs, bytes, kernel charges and collectives
    (calls and bytes by op type), the tracker's peak equal, the card's
    allocator peak within peak_tolerance of it; then SHARDED_REPS steps by
    CUDA events. One line: the per-device roofline terms (the collective
    term at roofline.H100's link rate), the bound, the share bound / event
    time and the card's name and power limit. The model is dense, so no
    integer crosses a collective: the fake group's unset outputs are only
    ever floats here. Returns the launches (none: no kernel of this
    repo)."""
    import torch
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import activation_rules, profile_for
    mesh = make_production_mesh()
    cfg = dryrun._bf16(get_config(SHARDED_ARCH))
    shp = SHAPES[SHARDED_SHAPE]
    prof = profile_for(cfg, train=shp.kind == "train")
    rules = activation_rules(prof, cfg, mesh.shape["model"])
    t0 = time.perf_counter()
    meta = dryrun.trace_sharded(
        cfg, dryrun.make_case(cfg, shp.kind, shp.global_batch, shp.seq_len),
        mesh, prof, rules)
    trace_s = time.perf_counter() - t0
    meta_c = meta["counter"]
    _fresh_card()
    ops.reset_launch_counts()
    case = dryrun.make_case(cfg, shp.kind, shp.global_batch, shp.seq_len,
                            device="cuda")
    with dryrun.sharded(case.fn, case.args, meta["arg_specs"],
                        meta["out_specs"], mesh, rules, "cuda") as sh:
        case.args.clear()                     # the global tensors go
        t0 = time.perf_counter()
        sh.step()                             # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        card_c = rl.OpCounter()
        t0 = time.perf_counter()
        peak = card_peak(lambda: sh.step(card_c))
        counted_s = time.perf_counter() - t0
        events = event_ms(sh.step, SHARDED_REPS, warm=0)
        local_bytes = sh.argument_local_bytes
    launches = ops.launch_counts()
    ev_ms = statistics.median(events)
    compute_ms = meta_c.flops / rl.H100.peak(cfg.dtype) * 1e3
    memory_ms = meta_c.bytes / rl.H100.hbm_bytes_per_s * 1e3
    coll_ms = meta_c.coll_bytes / rl.H100.link_bytes_per_s * 1e3
    bound_ms = max(compute_ms, memory_ms)
    meta_d, card_d = meta_c.as_dict(), card_c.as_dict()
    op_diff = {k: [meta_d["by_op"].get(k), card_d["by_op"].get(k)]
               for k in set(meta_d["by_op"]) | set(card_d["by_op"])
               if meta_d["by_op"].get(k) != card_d["by_op"].get(k)}
    row = {"phase": "dryrun", "case": "sharded_rank0", "arch": cfg.arch_id,
           "shape": SHARDED_SHAPE, "mesh": mesh.name, "chips": mesh.size,
           "rows_per_device": shp.global_batch // mesh.shape["data"],
           "seq": shp.seq_len, "dtype": str(cfg.dtype),
           "meta_trace_s": trace_s, "warm_up_s": warm_s,
           "counted_step_s": counted_s,
           "argument_bytes_per_device": {
               "predicted": meta["argument_local_bytes"],
               "card": local_bytes},
           "flops": {"meta": meta_d["flops"], "card": card_d["flops"]},
           "bytes": {"meta": meta_d["bytes"], "card": card_d["bytes"]},
           "kernel_charges": {"meta": meta_d["by_kernel"],
                              "card": card_d["by_kernel"]},
           "collectives": {"meta": meta_c.collectives(),
                           "card": card_c.collectives()},
           "by_op_differences": op_diff,
           "peak_bytes": {"meta": meta_c.peak_bytes, "card": peak,
                          "card_tracker": card_c.peak_bytes,
                          "tolerance": peak_tolerance(meta_c.peak_blocks),
                          "gap": peak - meta_c.peak_bytes},
           "temp_size_bytes": {"meta": meta_c.temp_size_bytes,
                               "card_tracker": card_c.temp_size_bytes},
           "reps": SHARDED_REPS, "event_ms": events,
           "event_ms_median": ev_ms, "compute_ms": compute_ms,
           "memory_ms": memory_ms, "collective_ms": coll_ms,
           "collective_link": rl.H100.link_name, "bound_ms": bound_ms,
           "bound_by": "operations" if compute_ms >= memory_ms else "bytes",
           "share": bound_ms / ev_ms, "launches": launches,
           "hardware": rl.H100.name, "nvidia_smi": smi}
    emit(row)
    require(meta_d["flops"] == card_d["flops"]
            and meta_d["bytes"] == card_d["bytes"]
            and meta_d["by_kernel"] == card_d["by_kernel"]
            and meta_c.collectives() == card_c.collectives(),
            f"dryrun (sharded_rank0): meta and card counts differ: "
            f"{op_diff} {row['collectives']}")
    require(meta["argument_local_bytes"] == local_bytes,
            f"dryrun (sharded_rank0): argument bytes {local_bytes}")
    require(abs(peak - meta_c.peak_bytes) <= row["peak_bytes"]["tolerance"],
            f"dryrun (sharded_rank0): card peak {row['peak_bytes']}")
    require(meta_c.coll_bytes > 0 and not any(launches.values()),
            f"dryrun (sharded_rank0): collectives {meta_c.coll_bytes}, "
            f"launches {launches}")
    require(row["share"] <= SHARE_MAX,
            f"dryrun (sharded_rank0): share {row['share']} above {SHARE_MAX}")
    return launches


# ---------------------------------------------------------------------------
KERNELS = (  # name, source, TPU kernel it replaces (file:line of pallas_call)
    ("topk_gate", "src/repro_torch/csrc/topk_gate.cu",
     "src/repro/kernels/topk_gate.py:75"),
    ("buddy_substitute", "src/repro_torch/csrc/buddy_substitute.cu",
     "src/repro/kernels/buddy_substitute.py:110"),
    ("expert_ffn", "src/repro_torch/csrc/expert_ffn.cu",
     "src/repro/kernels/expert_ffn.py:62"),
    ("grouped_ffn", "src/repro_torch/csrc/grouped_ffn.cu",
     "src/repro/kernels/grouped_ffn.py:146"),
    ("quant_ffn", "src/repro_torch/csrc/quant_ffn.cu",
     "src/repro/kernels/quant_ffn.py:83"),
    ("wkv_chunk", "src/repro_torch/csrc/wkv_chunk.cu",
     "src/repro/kernels/wkv_chunk.py:58"),
    ("route", "src/repro_torch/csrc/route.cu",
     "src/repro/kernels/topk_gate.py:75, "
     "src/repro/kernels/buddy_substitute.py:110"),
)
# buddy_substitute has no launch on the serve path: there Algorithm 1 runs
# inside route
NOTES = {"buddy_substitute": "no launch on the serve path (Algorithm 1 runs "
                             "inside route there); it runs in the kernels "
                             "phase, and its device code in route's "
                             "two-launch form (T > 32)"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}                # every phase's seconds, in order

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        return res

    smi = timed("device", phase_device)
    timed("build", phase_build)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {name: timed(name, fn, dev, gen) for name, fn in (
        ("topk_gate", kernel_topk), ("buddy_substitute", kernel_buddy),
        ("expert_ffn", kernel_expert_ffn), ("grouped_ffn", kernel_grouped_ffn),
        ("quant_ffn", kernel_quant_ffn), ("wkv_chunk", kernel_wkv),
        ("route", kernel_route))}
    timed("kernels_mixtral", kernel_mixtral, dev, gen)
    timed("kernels_train_grads", kernel_train_grads, dev, gen)
    timed("parity", phase_parity)
    claims = timed("claims", phase_claims, smi)
    counts, params = timed("serve", phase_serve)
    cont, ring_row = timed("continuous", phase_continuous, params)
    paged = timed("paged", phase_paged, params, ring_row)
    tele = timed("telemetry", phase_telemetry, params)
    mesh = timed("mesh", phase_mesh, params)
    place = timed("placement", phase_placement, params)
    del params
    full = timed("full_depth", phase_full_depth, smi)
    mix, params, cfg = timed("mixtral", phase_mixtral)
    sims = timed("similarity", phase_similarity, params, cfg)
    dry_mix = timed("dryrun_mixtral", phase_dryrun_mixtral, params, cfg, smi)
    del params
    m22, params, _ = timed("mixtral_8x22b", phase_mixtral, "mixtral_8x22b",
                           MIXTRAL_8X22B_FLAGS)
    del params
    counts = {k: counts[k] + claims[k] + cont[k] + paged[k] + tele[k]
              + mesh[k] + place[k] + full[k] + mix[k] + sims[k] + dry_mix[k]
              + m22[k] for k in counts}
    timed("train_parity", phase_train_parity)
    timed("train_parity_smollm", phase_train_parity, "smollm-360m")
    counts["wkv_chunk"], params, cfg = timed(
        "train", phase_train, rows["wkv_chunk"]["ms"])
    timed("decode", phase_decode, params, cfg)
    del params
    timed("dense_train", phase_dense_train)
    timed("train_parity_deepseek", phase_train_parity,
          "deepseek-v2-lite-buddy")
    moe = timed("moe_train", phase_moe_train)
    for k in ("topk_gate", "expert_ffn"):
        counts[k] += moe[k]
    timed("dryrun_meta", phase_dryrun_meta)
    dry_train = timed("dryrun_train", phase_dryrun_train, smi)
    # long context through the reference's chunked attention: no kernel
    # of this repo
    long_cfg, params = timed("long_context", phase_long_context, smi)
    dry_long = timed("dryrun_prefill_32k", phase_dryrun_prefill_32k,
                     long_cfg, params, smi)
    del params
    dry_4k = timed("dryrun_train_4k", phase_dryrun_train_4k, long_cfg, smi)
    dry_sh = timed("dryrun_sharded", phase_dryrun_sharded, smi)
    counts = {k: counts[k] + dry_train[k] + dry_long[k] + dry_4k[k]
              + dry_sh[k] for k in counts}
    new_s = {name: phase_s[name] for name in ("full_depth", "mixtral_8x22b")}
    # the hybrid, VLM and audio families: no kernel of this repo
    family_phases = (("families_parity", phase_families_parity),
                     ("hybrid", phase_hybrid), ("vlm", phase_vlm),
                     ("audio", phase_audio),
                     ("hybrid_train", phase_hybrid_train))
    for name, fn in family_phases:
        timed(name, fn)
    total = time.perf_counter() - t_start
    emit({"phase": "new_phase_seconds", "by_phase": new_s,
          "sum": sum(new_s.values()), "all_phases": phase_s,
          "main_s": total, "outside_phases_s": total - sum(phase_s.values())})
    table = []
    for name, src, replaces in KERNELS:
        r = rows[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"],
                      **{k: r[k] for k in ("device_us",) if k in r},
                      **({"note": NOTES[name]} if name in NOTES else {})})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
