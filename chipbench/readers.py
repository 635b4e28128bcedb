"""What the metric readers under ``chipbench/metrics/`` share: each reads
one number from a finished ``bench.Run`` (its wall-clock stamps, its
steps, its device trace, its timed kernel calls), or None where the run
has nothing to read. Step kinds: "decode" (the engine's ``step``) and
"prefill" (chunk steps, ``prefill_rows``)."""
from __future__ import annotations

import numpy as np
import torch

from chipbench import yardstick

KINDS = {"decode": "decode", "prefill": "chunk"}


def window_s(run) -> float:
    return run.t_close - run.t_open


def _in(run, t) -> bool:
    return run.t_open <= t <= run.t_close


def output_tokens_per_s(run):
    n = sum(1 for walls in run.emitted.values() for t in walls
            if _in(run, t))
    return n / window_s(run)


def prompt_tokens_per_s(run):
    n = 0
    for st in run.window_steps():
        for i, rid in enumerate(st.rids):
            if rid < 0:
                continue
            plen = run.prompt_len(rid)
            if st.kind == "decode":
                n += int(bool(st.valid[i]) and st.pos[i] < plen)
            else:
                fed = int(st.valid[i].sum())
                n += max(0, min(plen, int(st.pos[i]) + fed) - int(st.pos[i]))
    return n / window_s(run)


def tpot_p95_ms(run):
    gaps = [b - a for walls in run.emitted.values()
            for a, b in zip(walls, walls[1:]) if _in(run, b)]
    return yardstick.p95(gaps) * 1e3 if gaps else None


def ttft_p95_ms(run):
    xs = [walls[0] - run.admitted[rid] for rid, walls in run.emitted.items()
          if walls and _in(run, walls[0])]
    return yardstick.p95(xs) * 1e3 if xs else None


def _steps(run, kind):
    """Untraced window steps of ``kind`` with the cycle each took (to the
    next step's entry, or to the window's close)."""
    ws = run.window_steps()
    out = []
    for i, st in enumerate(ws):
        if st.kind != KINDS[kind] or st.traced:
            continue
        nxt = ws[i + 1].t_enter if i + 1 < len(ws) else run.t_close
        out.append((st, nxt - st.t_enter))
    return out


def loop_host_ms(run, kind):
    xs = [cyc - (st.t_exit - st.t_enter) - (st.t_sample1 - st.t_sample0)
          for st, cyc in _steps(run, kind)]
    return float(np.mean(xs)) * 1e3 if xs else None


def account_ms(run, kind):
    xs = [st.t_account - st.t_dev for st, _ in _steps(run, kind)]
    return float(np.mean(xs)) * 1e3 if xs else None


def _traced_kind(run, kind) -> bool:
    traced = [s for s in run.steps if s.traced]
    return bool(run.devtrace) and bool(traced) and \
        all(s.kind == KINDS[kind] for s in traced)


def step_device_ms(run, kind):
    if not _traced_kind(run, kind):
        return None
    return float(np.mean(run.devtrace["busy_by_step_s"])) * 1e3


def idle_share(run, kind):
    if not _traced_kind(run, kind):
        return None
    dt = run.devtrace
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])


def mfu(run, kind):
    if not run.cuda:
        return None
    steps = _steps(run, kind)
    if not steps:
        return None
    pk = yardstick.peaks(torch.cuda.get_device_name(run.device))
    flops = sum(run.step_flops(st) for st, _ in steps)
    wall = sum(cyc for _, cyc in steps)
    return 100.0 * flops / (wall * pk["f32_flops"])


def roofline(run, kernel):
    """Share of the kernel's bound (what its routed rows need) in the time
    CUDA events gave its calls; above 105% the count or the time is
    wrong, and the run fails."""
    if not run.cuda:
        return None
    calls = [c for c in run.kernel_times() if c[0] == kernel]
    if not calls:
        return None
    pk = yardstick.peaks(torch.cuda.get_device_name(run.device))
    need = sum(yardstick.bound_s(*yardstick.ffn_call_need(run.rc, rows, live),
                                 pk) for _, _, rows, live in calls)
    share = 100.0 * need / sum(t for _, t, _, _ in calls)
    if share > 105.0:
        raise RuntimeError(f"{kernel}_roofline {share:.1f}% > 105%: the "
                           "count or the time is wrong")
    return share
