#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BuddyMoE on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch`` and reads the
committed fixture under ``results/bench``). Phases, one JSON line each:

  device   the card's name, power limit and compute capability (must be 9.0)
  build    nvcc builds of the seven kernels (csrc/*.cu), all at once
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes of the main path, with times (CUDA events) and bounds;
           the routing kernels also with their device time (torch.profiler)
           and device ops per call: route at T = 4, 32, 256, 512 and 4096
           (one launch up to 256 tokens, two above) with and without the tier
           and peer masks and with substitution off, and at T = 4 and 4096
           in cost mode (degraded and peer costs) and with Psi's eta and
           kappa terms, the temperature and the margin co-gate, beside the
           path it replaced (topk_gate, the distribution gate in torch ops,
           buddy_substitute, the splits) timed in the same run;
           the three FFN kernels also print the instance of the shared tile
           that ran (vec16 or elem; the path shapes must run vec16) and the
           achieved TB/s, and grouped_ffn a row sweep (every live group at
           1, 3 and 8 rows); the FFN kernels also at the continuous
           phase's chunk shapes: grouped_ffn on 32 and 512 tokens binned at
           the dropless cap T*K (192, 3072), expert_ffn on the capacity
           branch's [64, 4 x 48, 2048] buffer and quant_ffn on its degraded
           slots [64, 192, 2048] with row counts; wkv_chunk also at head dim 128 (dynamic shared
           memory), and its autograd backward on the card against the same
           on the CPU
  parity   the committed profiling fixture (results/bench/model.npz with
           tables_a0.95_k16.npz) served on the CPU through the plain versions
           and on the card through the kernels, without and with the int8
           quant tier, and in cost mode (fused without the tier, gather
           with it): equal tokens and counters (tier and cost-policy
           counters included), close logits
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
  train_parity  the reduced rwkv6 config, weights from seed 0 made on the
           CPU: one train step on the CPU (plain) and one on the card
           (kernel); loss, grad norm and every gradient agree
  train    rwkv6-1.6b at full width and depth (24 layers, d_model 2048,
           vocab 65536, f32), random weights from seed 0, through
           launch/train.py's entry points: --batch 4 --seq 512 --steps 3 in
           its own launch-count window; finite loss and grad norm at every
           step, 24 wkv_chunk launches per forward; per-step wall time and
           its forward / backward / optimizer split, tokens/s, peak memory
  decode   the trained full-width weights: forward_train (chunked, through
           the kernel) against 31 decode_steps (per-token recurrence) on 2 x
           32 tokens

Then the kernels table line, the card's name and power limit as nvidia-smi
prints them, and the result line. Without a CUDA card, or outside a checkout,
it exits nonzero before printing a result.
"""
from __future__ import annotations

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call, after a warm-up."""
    import torch
    for _ in range(3):
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
    return statistics.median(out)


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_us(fn, n: int = 10) -> dict:
    """The device's own time per call of ``fn`` and the device ops (kernels
    and copies) per call, from torch.profiler over ``n`` back-to-back
    calls: what the card spends apart from waiting for the host. Two spin
    kernels (torch.cuda._sleep) open and close the window and are left out:
    the profiler can drop a window's first or last device event. A window
    with no device event (seen once) is taken again, up to three times;
    then the numbers are None, "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(n):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and _self_device_us(e) > 0 and "spin" not in e.key.lower()]
        if evts:
            return {"device_us": sum(_self_device_us(e) for e in evts) / n,
                    "device_ops_per_call": sum(e.count for e in evts) / n}
    return {"device_us": None, "device_ops_per_call": None}


def bound(nbytes: float, flops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ffn_rate(moved: float, ms: float, b_ms: float) -> dict:
    """Achieved rate of an FFN call: the bound's bytes over its time."""
    return {"bytes": moved, "tb_per_s": moved / ms / 1e9,
            "share_of_bound": b_ms / ms}


def ffn_instance(x, groups: int, f_n: int, tensors, fp=True,
                 int8=False) -> str:
    """The shared FFN tile's instance a call on these operands runs; the
    path shapes must run the 16-byte-copy one."""
    from repro_torch.kernels.expert_ffn import launch_plan
    _, c_n, d_n = x.shape
    plan = launch_plan(x.element_size(), groups, c_n, d_n, f_n, fp=fp,
                       int8=int8, ptrs=[t.data_ptr() for t in tensors])
    require(plan["instance"] == "vec16",
            f"FFN path shape {tuple(x.shape)} x {f_n} ran {plan}")
    return plan["instance"]


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


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    ptxas = {n: [ln.split("info    : ")[-1] for ln in v["log"].splitlines()
                 if "Used" in ln or "spill" in ln] for n, v in info.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})


# ---------------------------------------------------------------------------
def _route_slots(gen, t_n, e_n, k_n, dev):
    """Distinct experts per token, as a router gives them: [T, K] int32."""
    import torch
    return torch.stack([torch.randperm(e_n, generator=gen)[:k_n]
                        for _ in range(t_n)]).to(torch.int32).to(dev)


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
    emit({"phase": "kernels", "kernel": "topk_gate", "E": e_n, "K": k_n,
          "by_T": rows, "ties_equal": True})
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
        # the kernel has no row counts: every row of every expert is work
        flops = 2 * e_n * x.shape[1] * d_n * f_n * 3
        moved = nbytes(x, w1, w3, w2, got)
        b_ms, b_by = bound(moved, flops)
        rows[name] = {"shape": list(x.shape) + [f_n], "max_abs_err": err,
                      "max_abs_plain": float(want.abs().max()),
                      "instance": ffn_instance(x, e_n, f_n, (x, w1, w3, w2)),
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


def kernel_quant_ffn(dev, gen):
    import torch
    from repro_torch.kernels.quant_ffn import quant_ffn_cuda, quant_ffn_plain
    e_n, k_n, t_n, d_n, f_n = 64, 6, 4, 2048, 1408
    quant = _replicas(*_ffn_weights(gen, e_n, d_n, f_n, dev, torch.float32))
    x_tok = torch.randn(t_n, d_n, generator=gen)
    rows = {}
    # "chunk": the capacity branch of a continuous chunk step (run (b)):
    # 4 slots x 8 tokens, half of the 192 routed slots degraded, binned by
    # expert into [E, T*K, D] with counts
    x_chunk = torch.randn(32, d_n, generator=gen)
    for name, c_n in (("decode", t_n * k_n), ("full", 32),
                      ("chunk", 32 * k_n)):
        if name != "full":
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
                      "instance": ffn_instance(buf, e_n, f_n,
                                               (buf, *quant[::2]), fp=False,
                                               int8=True),
                      "ms": time_ms(lambda: quant_ffn_cuda(buf, *quant,
                                                           counts)),
                      "plain_ms": time_ms(lambda: quant_ffn_plain(
                          buf, *quant, counts)),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows[name].update(ffn_rate(moved, rows[name]["ms"], b_ms))
    # bf16 activations and ragged shapes: correctness only
    for (e, c, d, f) in ((3, 37, 200, 136), (2, 1, 40, 24)):
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
                      "instance": ffn_instance(buf, 2 * e_n, f_n, copied,
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
    from repro_torch.kernels.wkv_chunk import wkv_chunk_cuda, wkv_chunk_plain
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
        rows[name] = {"shape": [bh, n, c, d], "max_abs_err": err,
                      "max_abs_plain": scale - 1,
                      "ms": time_ms(lambda: wkv_chunk_cuda(*args), inner=10),
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
# at T = 4 and 4096 (name, policy): cost mode with the degraded and peer
# costs (fetch stalls around the drop cost: every outcome occurs); Psi's
# eta and kappa terms (hop with the -1 sentinel) with the token gate's
# temperature 0.8 and margin 0.4
ROUTE_POLICY_T = (4, 4096)
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
    from repro_torch.kernels.route import (Route, launch_plan, route_cuda,
                                           route_plain)
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
    for t_n in (4, 32, 256, 512, 4096):
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
                "launches_per_call": launch_plan(t_n, k_n).launches,
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
def _fixture_run(device, fused: bool, tier: bool = False, **policy):
    """Serve the committed profiling fixture, with the int8 tier when asked
    for and ``policy``'s further BuddyPolicy fields; returns (tokens,
    summary, per-step logits)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.io import load_npz
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.core.buddies import load_tables
    from repro_torch.core.policy import BuddyPolicy
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.runtime.prefetch import PrevStepPredictor
    from repro_torch.runtime.tiers import TieredExpertStore
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import MarkovLM
    cfg = profiling()
    n_moe, e_n = cfg.num_layers, cfg.moe.num_experts
    store = None
    if tier:
        # half coverage: the cache keeps 15 full slots, so hits, buddies,
        # fetches and degraded slots all occur
        store = TieredExpertStore(n_moe, e_n, 0.5, bits=8, coverage=0.5,
                                  d_model=cfg.d_model, d_ff=cfg.moe.d_ff)
        cache = store.cache
    else:
        cache = ExpertCache(n_moe, e_n, 0.5)
    eng = ServeEngine(cfg, load_npz(str(FIXTURE / "model.npz"), device),
                      tables=load_tables(str(FIXTURE / "tables_a0.95_k16.npz")),
                      policy=BuddyPolicy(use_fused_dispatch=fused,
                                         quant_tier="int8" if tier else "off",
                                         **policy),
                      cache=None if tier else cache, tier=store,
                      predictor=PrevStepPredictor(n_moe, e_n),
                      prefetch_k=max(1, cache.capacity // 2))
    logits = []
    step = eng.step

    def logged(*a, **kw):
        out = step(*a, **kw)
        logits.append(out[0].detach().cpu())
        return out

    eng.step = logged
    prompts = MarkovLM(cfg.vocab_size, seed=0).sample(4, 8)
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
# engine upgrades degraded slots) configure it
PARITY_CASES = (
    ("fused", True, False, {}), ("gather", False, False, {}),
    ("fused_int8", True, True, {}), ("gather_int8", False, True, {}),
    ("cost_fused", True, False, dict(miss_policy="cost",
                                     stall_per_quality=2e-4)),
    ("cost_gather_int8", False, True, dict(miss_policy="cost",
                                           stall_per_quality=0.05)))


def phase_parity():
    import numpy as np
    from repro_torch.kernels import ops
    out = {"phase": "parity"}
    for tag, fused, tier, policy in PARITY_CASES:
        before = ops.launch_counts()
        t_cpu, s_cpu, l_cpu = _fixture_run("cpu", fused, tier, **policy)
        require(ops.launch_counts() == before, "CPU run launched a kernel")
        t_gpu, s_gpu, l_gpu = _fixture_run("cuda", fused, tier, **policy)
        err = max_err(l_gpu, l_cpu)
        st = s_gpu["stats"]
        out[tag] = {"tokens_equal": bool(np.array_equal(t_cpu, t_gpu)),
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
        if policy:
            require(st["n_miss_drop"] + st["n_miss_fetch"] > 0,
                    f"parity ({tag}): no slot was dropped or fetched")
            require(not tier or st["n_upgrade_issued"] > 0,
                    f"parity ({tag}): no degraded slot was upgraded")
        require(ok, f"parity ({tag}): CPU and card disagree: {out[tag]}")
        require(err <= LOGIT_TOL, f"parity ({tag}): logits err {err}")
    emit(out)


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
    flags = ["--arch", "deepseek-v2-lite-buddy", "--layers", "8",
             "--cache-rate", "0.5", "--policy", "buddy", "--predictor",
             "prev-step", "--batch", "4", "--steps", "8"]
    cfg = serve.model_config(serve.parse_args(flags))
    ops.reset_launch_counts()                  # path 1 starts here
    base = _serve_path(serve, flags, None, 2)
    counts_base = ops.launch_counts()          # ... and ends here
    params = base["engines"][0].params
    ops.reset_launch_counts()                  # path 2 (the tier) starts here
    tier_flags = flags + ["--quant-tier", "int8", "--tier-coverage", "0.5"]
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
    builds): its kind ("chunk", "decode", or "probe" for the lockstep batch
    that sizes the auto arrival rate), tokens fed, wall ms on a host clock
    synchronized with the card, and the kernel launches it made; and the
    range of every sampled token array."""

    def __init__(self):
        self.steps, self.sampled = [], []

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
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(eng, tokens, *a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = ops.launch_counts()
            self.steps.append({"kind": kind, "tokens": fed, "ms": ms,
                               "layers": eng.num_moe_layers,
                               "launches": {k: after[k] - before[k]
                                            for k in after}})
            return out

        return call


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


def phase_continuous(params) -> dict:
    """Continuous serving at full width (8 layers) on the serve phase's
    weights; see the module note. Returns the three runs' launches."""
    import contextlib
    import io
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import scheduler as S
    from repro_torch.training.data import MarkovLM
    flags = ["--arch", "deepseek-v2-lite-buddy", "--layers", "8",
             "--cache-rate", "0.5", "--policy", "buddy", "--mode",
             "continuous", "--slots", "4", "--num-requests", "8", "--steps",
             "8", "--prefill-chunk", "8"]
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
             lambda: run_main(flags + ["--quant-tier", "int8",
                                       "--tier-coverage", "0.5"]),
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
    return total


# ---------------------------------------------------------------------------
def phase_train_parity():
    """One reduced rwkv6 train step on the CPU (plain) and on the card."""
    import torch
    from repro_torch.configs.rwkv6_1p6b import reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.data import MarkovLM
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)
    cfg = reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, seed=0).sample(2, 65))
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=3,
                                               warmup_steps=10))
    res = {}
    for d in ("cpu", "cuda"):
        before = ops.launch_counts()["wkv_chunk"]
        p = tree_map(lambda t: t.to(d, copy=True), params)
        x, y = toks[:, :-1].to(d), toks[:, 1:].to(d)
        _, _, grads = loss_and_grads(p, cfg, x, y)
        _, _, m = step_fn(p, init_opt_state(p), x, y)
        res[d] = (float(m["loss"]), float(m["grad_norm"]),
                  [g.cpu() for g in tree_leaves(grads)],
                  ops.launch_counts()["wkv_chunk"] - before)
    (lc, nc, gc, kc), (lg, ng, gg, kg) = res["cpu"], res["cuda"]
    grad_rel = max(max_err(b, a) / max(float(a.abs().max()), 1e-30)
                   for a, b in zip(gc, gg))
    out = {"phase": "train_parity", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "loss_cpu": lc, "loss_cuda": lg, "grad_norm_cpu": nc,
           "grad_norm_cuda": ng, "grad_max_rel_err": grad_rel,
           "grad_rtol": GRAD_RTOL, "loss_rtol": LOSS_RTOL,
           "wkv_launches_cpu": kc, "wkv_launches_cuda": kg}
    emit(out)
    require(kc == 0 and kg == 2 * cfg.num_layers,
            f"train parity: wkv_chunk launches {kc} / {kg}")
    require(abs(lg - lc) <= LOSS_RTOL * abs(lc)
            and abs(ng - nc) <= LOSS_RTOL * abs(nc),
            f"train parity: loss or grad norm differ: {out}")
    require(grad_rel <= GRAD_RTOL, f"train parity: gradients differ: {out}")


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
    step_s = statistics.median(s["wall_s"] for s in steady)
    fwd_s = statistics.median(s["forward_s"] for s in steady)
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
                             "two-launch form (T > 256)"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {"topk_gate": kernel_topk(dev, gen),
            "buddy_substitute": kernel_buddy(dev, gen),
            "expert_ffn": kernel_expert_ffn(dev, gen),
            "grouped_ffn": kernel_grouped_ffn(dev, gen),
            "quant_ffn": kernel_quant_ffn(dev, gen),
            "wkv_chunk": kernel_wkv(dev, gen),
            "route": kernel_route(dev, gen)}
    phase_parity()
    counts, params = phase_serve()
    cont = phase_continuous(params)
    del params
    counts = {k: counts[k] + cont[k] for k in counts}
    phase_train_parity()
    counts["wkv_chunk"], params, cfg = phase_train(rows["wkv_chunk"]["ms"])
    phase_decode(params, cfg)
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
