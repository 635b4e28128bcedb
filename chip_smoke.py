#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BuddyMoE on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch`` and reads the
committed fixture under ``results/bench``). Phases, one JSON line each:

  device   the card's name, power limit and compute capability (must be 9.0)
  build    nvcc builds of the four kernels (csrc/*.cu), all at once
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes of the main path, with times (CUDA events) and bounds
  parity   the committed profiling fixture (results/bench/model.npz with
           tables_a0.95_k16.npz) served on the CPU through the plain versions
           and on the card through the kernels: equal tokens and counters,
           close logits
  serve    deepseek-v2-lite-buddy at full width cut to 8 layers, random
           weights from seed 0: buddy profiling, a fused-dispatch batch
           (4 x 8 prompt + 8 new tokens), then 2 steps through the gather
           branch; every kernel's launch count from this phase must be > 0

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
FIXTURE = ROOT / "results" / "bench"


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


def bound(nbytes: float, flops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
                     "bound_ms": b_ms, "bound_by": b_by}
    # ties on purpose: logits on a coarse grid
    z = (torch.randn(256, e_n, generator=gen) * 2).round().to(dev)
    got, want = topk_gate_cuda(z, tau, k=k_n), topk_gate_plain(z, tau, k=k_n)
    require(torch.equal(got[0], want[0]), "topk_gate: tie order differs")
    emit({"phase": "kernels", "kernel": "topk_gate", "E": e_n, "K": k_n,
          "by_T": rows, "ties_equal": True})
    return rows[4]


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
        table = torch.stack([torch.randperm(e_n, generator=gen)[:r_n]
                             for _ in range(e_n)]).to(torch.int32)
        table[:, r_n // 2:][torch.rand(e_n, r_n - r_n // 2,
                                       generator=gen) < 0.3] = -1
        q = torch.rand(e_n, r_n, generator=gen).sort(-1, descending=True).values
        table, q = table.to(dev), q.to(dev)
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
                    "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "kernel": "buddy_substitute", "E": e_n,
          "K": k_n, "R": r_n, "by_T": res})
    return res[4]


def _ffn_weights(gen, e_n, d_n, f_n, dev, dtype):
    import torch
    w = [torch.randn(e_n, a, b, generator=gen) * 0.02
         for a, b in ((d_n, f_n), (d_n, f_n), (f_n, d_n))]
    return [t.to(dtype).to(dev) for t in w]


def kernel_expert_ffn(dev, gen):
    import torch
    from repro_torch.kernels.expert_ffn import expert_ffn_cuda, expert_ffn_plain
    e_n, c_n, d_n, f_n = 64, 32, 2048, 1408
    x = torch.randn(e_n, c_n, d_n, generator=gen).to(dev)
    w1, w3, w2 = _ffn_weights(gen, e_n, d_n, f_n, dev, torch.float32)
    got, want = expert_ffn_cuda(x, w1, w3, w2), expert_ffn_plain(x, w1, w3, w2)
    err = max_err(got, want)
    require(err <= TOL_F32 * (1 + float(want.abs().max())),
            f"expert_ffn: err {err}")
    # bf16 and ragged shapes: correctness only
    for (e, c, d, f), dt, tol in (((4, 37, 200, 136), torch.float32, TOL_F32),
                                  ((3, 33, 256, 320), torch.bfloat16, 5e-2)):
        xs = (torch.randn(e, c, d, generator=gen)).to(dt).to(dev)
        ws = _ffn_weights(gen, e, d, f, dev, dt)
        e2 = max_err(expert_ffn_cuda(xs, *ws), expert_ffn_plain(xs, *ws))
        require(e2 <= tol, f"expert_ffn {dt} {(e, c, d, f)}: err {e2}")
    flops = 2 * e_n * c_n * d_n * f_n * 3
    b_ms, b_by = bound(nbytes(x, w1, w3, w2, got), flops)
    row = {"max_abs_err": err, "max_abs_plain": float(want.abs().max()),
           "ms": time_ms(lambda: expert_ffn_cuda(x, w1, w3, w2)),
           "plain_ms": time_ms(lambda: expert_ffn_plain(x, w1, w3, w2)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "kernel": "expert_ffn",
          "shape": [e_n, c_n, d_n, f_n], **row})
    return row


def _quantize(w):
    """Symmetric per-output-channel int8 over the contraction axis (1)."""
    import torch
    s = w.abs().amax(1).clamp(min=1e-8) / 127.0                     # [E, out]
    return torch.round(w / s[:, None, :]).clamp(-127, 127).to(torch.int8), s


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
    buf = torch.zeros(2 * e_n, c_n, d_n, dtype=x_tok.dtype)
    buf[grp, pos] = x_tok.cpu().repeat_interleave(k_n, 0)
    return buf.to(dev), counts.to(torch.int32).to(dev)


def kernel_grouped_ffn(dev, gen):
    import torch
    from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,
                                                 grouped_ffn_plain)
    e_n, k_n, t_n, d_n, f_n = 64, 6, 4, 2048, 1408
    c_n = t_n * k_n
    w1, w3, w2 = _ffn_weights(gen, e_n, d_n, f_n, dev, torch.float32)
    x_tok = torch.randn(t_n, d_n, generator=gen)
    rows = {}
    for name, deg_frac in (("decode", 0.0), ("decode_int8", 0.4)):
        buf, counts = _binned(gen, x_tok, e_n, k_n, c_n, deg_frac, dev)
        quant = None
        if deg_frac:
            (q1, s1), (q3, s3), (q2, s2) = map(_quantize, (w1, w3, w2))
            quant = (q1, s1, q3, s3, q2, s2)
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
        rows[name] = {"max_abs_err": err,
                      "max_abs_plain": float(want.abs().max()),
                      "live_fp": n_fp, "live_deg": n_deg,
                      "ms": time_ms(lambda: grouped_ffn_cuda(buf, w1, w3, w2,
                                                             quant, counts)),
                      "plain_ms": time_ms(lambda: grouped_ffn_plain(
                          buf, w1, w3, w2, quant, counts)),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "kernel": "grouped_ffn",
          "shape": [2 * e_n, c_n, d_n, f_n], "by_case": rows})
    return rows["decode"]


# ---------------------------------------------------------------------------
def _fixture_run(device, fused: bool):
    """Serve the committed profiling fixture; returns (tokens, stats,
    per-step logits)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.io import load_npz
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.core.buddies import load_tables
    from repro_torch.core.policy import BuddyPolicy
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.runtime.prefetch import PrevStepPredictor
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import MarkovLM
    cfg = profiling()
    n_moe, e_n = cfg.num_layers, cfg.moe.num_experts
    cache = ExpertCache(n_moe, e_n, 0.5)
    eng = ServeEngine(cfg, load_npz(str(FIXTURE / "model.npz"), device),
                      tables=load_tables(str(FIXTURE / "tables_a0.95_k16.npz")),
                      policy=BuddyPolicy(use_fused_dispatch=fused), cache=cache,
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


def phase_parity():
    import numpy as np
    from repro_torch.kernels import ops
    out = {"phase": "parity"}
    for fused in (True, False):
        before = ops.launch_counts()
        t_cpu, s_cpu, l_cpu = _fixture_run("cpu", fused)
        require(ops.launch_counts() == before, "CPU run launched a kernel")
        t_gpu, s_gpu, l_gpu = _fixture_run("cuda", fused)
        err = max_err(l_gpu, l_cpu)
        tag = "fused" if fused else "gather"
        out[tag] = {"tokens_equal": bool(np.array_equal(t_cpu, t_gpu)),
                    "stats_equal": s_cpu["stats"] == s_gpu["stats"],
                    "ledger_equal": s_cpu["ledger"] == s_gpu["ledger"],
                    "logits_max_abs_err": err, "logits_tol": LOGIT_TOL,
                    "n_sub": s_gpu["stats"]["n_sub"],
                    "n_hit": s_gpu["stats"]["n_hit"],
                    "n_miss_fetch": s_gpu["stats"]["n_miss_fetch"]}
        require(out[tag]["tokens_equal"] and out[tag]["stats_equal"]
                and out[tag]["ledger_equal"],
                f"parity ({tag}): CPU and card disagree: {out[tag]}")
        require(err <= LOGIT_TOL, f"parity ({tag}): logits err {err}")
    emit(out)


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    flags = ["--arch", "deepseek-v2-lite-buddy", "--layers", "8",
             "--cache-rate", "0.5", "--policy", "buddy", "--predictor",
             "prev-step", "--batch", "4", "--steps", "8"]
    args = serve.parse_args(flags + ["--fused-dispatch"])
    cfg = serve.model_config(args)
    ops.reset_launch_counts()                  # the main path starts here
    t0 = time.perf_counter()
    eng, lm = serve.build_engine(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = lm.sample(args.batch, 8)
    t0 = time.perf_counter()
    toks = eng.generate(prompts, args.steps)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    s = eng.summary()
    # two more steps through the tiny-batch gather branch, same weights
    eng2, _ = serve.build_engine(serve.parse_args(flags), params=eng.params)
    t0 = time.perf_counter()
    toks2 = eng2.generate(prompts[:, :1], 2)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    counts = ops.launch_counts()               # ... and ends here
    n_params = sum(t.numel() for t in
                   _leaves(eng.params))
    st = s["stats"]
    out = {"phase": "serve", "arch": cfg.arch_id, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
           "d_ff_expert": cfg.moe.d_ff, "top_k": cfg.moe.top_k,
           "vocab": cfg.vocab_size, "params": n_params,
           "setup_s": setup_s,
           "fused_steps": st["steps"],
           "fused_wall_ms_per_step": fused_s / st["steps"] * 1e3,
           "gather_steps": eng2.stats.steps,
           "gather_wall_ms_per_step": gather_s / eng2.stats.steps * 1e3,
           "n_sub": st["n_sub"], "n_hit": st["n_hit"],
           "n_miss_fetch": st["n_miss_fetch"],
           "simulated_tokens_per_s": s["tokens_per_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    emit(out)
    require(st["steps"] == 15 and eng2.stats.steps == 2, "wrong step count")
    require(all(n > 0 for n in counts.values()),
            f"a kernel was not launched on the main path: {counts}")
    require(np.all((toks >= 0) & (toks < cfg.vocab_size))
            and np.all((toks2 >= 0) & (toks2 < cfg.vocab_size)),
            "generated tokens out of the vocabulary")
    require(st["n_hit"] + st["n_sub"] + st["n_miss_fetch"] > 0,
            "no expert slot was served")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
)


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
            "grouped_ffn": kernel_grouped_ffn(dev, gen)}
    phase_parity()
    counts = phase_serve()
    table = []
    for name, src, replaces in KERNELS:
        r = rows[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
