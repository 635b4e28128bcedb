"""Reading a ``torch.profiler`` trace of the traced steps: device busy time
(the union of device op intervals), busy per step, device time by op
name, and the longest idle gaps labelled with the benchmark's host span
that covered them (``chipbench.account``: the engine's ``_account``;
``chipbench.sample``: sampling; ``chipbench.step``: the rest of the
engine's step, which issues it; none: the scheduler's own loop)."""
from __future__ import annotations

from collections import defaultdict

HOST_SPANS = {"chipbench.account": "engine _account",
              "chipbench.sample": "sampling",
              "chipbench.step": "issue of the step"}
_INNER_FIRST = ("chipbench.account", "chipbench.sample", "chipbench.step")


def _is_device(evt) -> bool:
    kind = str(getattr(evt, "device_type", "")).upper()
    return "CUDA" in kind


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _covered(merged, lo, hi) -> float:
    tot = 0.0
    for s, e in merged:
        a, b = max(s, lo), min(e, hi)
        if b > a:
            tot += b - a
    return tot


def summarize(events, t_begin_us=None, t_end_us=None, top: int = 10) -> dict:
    """``events``: the profiler's FunctionEvents. Times in the trace's
    microseconds; the window runs from the first ``chipbench.step`` range
    to the end of the last device op or host span. Returns busy_s,
    window_s, busy_by_step_s, device_ops, idle_gaps."""
    ops, spans = [], defaultdict(list)
    for evt in events:
        name = evt.name
        s, e = float(evt.time_range.start), float(evt.time_range.end)
        if name.startswith("chipbench."):
            if not _is_device(evt):
                spans[name].append((s, e))
            continue
        if _is_device(evt) and e > s:
            ops.append((s, e, name))
    steps = sorted(spans.get("chipbench.step", []))
    if not ops or not steps:
        return {}
    lo = steps[0][0] if t_begin_us is None else t_begin_us
    hi = max(max(e for _, e, _ in ops),
             max(e for v in spans.values() for _, e in v))
    if t_end_us is not None:
        hi = t_end_us
    merged = _merge([(max(s, lo), min(e, hi)) for s, e, _ in ops
                     if e > lo and s < hi])
    busy = sum(e - s for s, e in merged)
    bounds = [s for s, _ in steps] + [hi]
    per_step = [_covered(merged, bounds[i], bounds[i + 1]) * 1e-6
                for i in range(len(steps))]
    by_name = defaultdict(float)
    for s, e, name in ops:
        by_name[name] += (e - s) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
             merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged and merged[0][0] > lo:
        gaps.append((merged[0][0] - lo, lo, merged[0][0]))
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        label = "scheduler loop"
        for key in _INNER_FIRST:
            if any(s <= mid <= e for s, e in spans.get(key, [])):
                label = HOST_SPANS[key]
                break
        idle.append([label, length * 1e-6])
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "busy_by_step_s": per_step, "device_ops": [list(x) for x in
                                                       device_ops],
            "idle_gaps": idle, "n_device_ops": len(ops)}
