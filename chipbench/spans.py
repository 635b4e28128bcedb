"""The program's host spans (``repro_torch.runtime.trace``) read for a
``bench.Run``: the host time of each part of a step, the expert dispatch's
fill, the profiling's token rate, and the device's idle time by the
program span the host was in.

A run keeps the spans only where the program has them and the run turned
them on (``SpannedRun``: its recorder on ``run.host``); every reader here
gives None otherwise. Host numbers are read over the window's untraced
steps of one kind (``readers.KINDS``), as ``readers.account_ms`` is; the
idle time over the traced steps' device trace, in the window
``devtrace.summarize`` takes.

    python3 chipbench/spans.py --workload <cell> --seed <n> --seconds <s> \\
        [--spans 1,0] [--out spans.jsonl]

runs the cell's traced run once per entry of ``--spans`` (1: host spans
on, 0: off), all on one seed, and prints one JSON line each: the cell's
per-layer metrics, this module's readings, the untraced steps' mean
cycle, and the traced steps' idle time by program span; then the cost of
a span call site with no recorder active.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

from chipbench import bench, devtrace, readers  # noqa: E402

# top-level name parts of the program's spans (``trace.SPAN_NAMES``)
PROGRAM = ("serve.", "sched.", "engine.", "model.", "setup.")
SCHED = ("sched.admit", "sched.feed", "sched.select", "sched.emit",
         "sched.feedback")
# the scheduler's spans of a step that run before its entry: they belong to
# the previous step's cycle
NEXT = ("sched.admit", "sched.feed")


class SpannedRun(bench.Run):
    """A ``bench.Run`` with the program's host spans on from the engine's
    build to the end of serving; the recorder stays on ``host``. Its
    device trace leaves out the device-side copies of the program's ranges
    (``device_events``)."""

    host = None

    def build(self) -> None:
        from repro_torch.runtime import trace
        self.host = trace.start_host()
        try:
            super().build()
        except BaseException:
            trace.stop_host()
            raise

    def serve(self) -> None:
        from repro_torch.runtime import trace
        try:
            super().serve()
        finally:
            trace.stop_host()

    def read_trace(self) -> None:
        if self._prof_done is not None:
            self.devtrace = devtrace.summarize(
                device_events(self._prof_done.events()))


def _is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def device_events(events) -> list:
    """The profiler's events less the device-side annotations of the
    program's ranges (the profiler copies a range that launched kernels
    onto the device's timeline, from its first kernel to its last, gaps
    included): as ``devtrace`` drops its own ``chipbench.*`` copies, so that
    only device ops count as busy."""
    return [e for e in events
            if not (devtrace._is_device(e) and _is_program(e.name))]


def split_label(label: str) -> tuple:
    """``"model.attn[3]"`` -> ("model.attn", 3); no layer -> None."""
    if label.endswith("]") and "[" in label:
        name, layer = label[:-1].split("[", 1)
        return name, int(layer)
    return label, None


def step_parts(run, kind: str):
    """[(Step, cycle s, {span name: [records]})] of the window's untraced
    steps of ``kind``: the spans each step's cycle holds (the benchmark's
    cycle runs from the step's entry to the next step's), so those of its
    ``serve.step`` but for the scheduler's admission and inputs, which
    come from the next one; None without host spans."""
    h = getattr(run, "host", None)
    if h is None:
        return None
    events = h.events
    starts = [i for i, e in enumerate(events) if e["kind"] == "span"
              and e["name"] == "serve.step"]
    by_lane = {}
    for n, i in enumerate(starts):
        j = starts[n + 1] if n + 1 < len(starts) else len(events)
        by_lane[events[i]["lane"]] = [e for e in events[i:j]
                                      if e["kind"] == "span"]
    index = {id(st): i for i, st in enumerate(run.steps)}
    out = []
    for st, cyc in readers._steps(run, kind):
        i = index[id(st)]
        if i not in by_lane or i + 1 not in by_lane:
            continue
        parts = defaultdict(list)
        for e in by_lane[i]:
            if e["name"] not in NEXT:
                parts[e["name"]].append(e)
        for e in by_lane[i + 1]:
            if e["name"] in NEXT:
                parts[e["name"]].append(e)
        out.append((st, cyc, parts))
    return out or None


def _mean_ms(rows, fn):
    if not rows:
        return None
    return float(np.mean([fn(p) for _, _, p in rows])) * 1e3


def _dur(parts, name) -> float:
    return sum(e["dur"] for e in parts.get(name, ()))


def issue_ms(run, kind):
    """Host ms a step from the engine's entry until the model's kernels
    are all issued (``engine.issue``)."""
    rows = step_parts(run, kind)
    return None if rows is None else _mean_ms(
        rows, lambda p: _dur(p, "engine.issue"))


def device_wait_ms(run, kind):
    """Host ms a step from the end of ``engine.issue`` to the end of
    ``engine.wait`` (the step's device work done and its masks copied
    back; a caller's own wait in between counts)."""
    rows = step_parts(run, kind)

    def wait(p):
        iss, w = p["engine.issue"][-1], p["engine.wait"][-1]
        return w["ts"] + w["dur"] - (iss["ts"] + iss["dur"])
    return None if rows is None else _mean_ms(rows, wait)


def replay_ms(run, kind):
    """Host ms a step in ``engine.replay``: the step replayed on the
    modeled transfer timeline."""
    rows = step_parts(run, kind)
    return None if rows is None else _mean_ms(
        rows, lambda p: _dur(p, "engine.replay"))


def sample_ms(run, kind):
    rows = step_parts(run, kind)
    return None if rows is None else _mean_ms(
        rows, lambda p: _dur(p, "engine.sample"))


def sched_ms(run, kind):
    """Host ms a step's cycle in the scheduler's own spans: the pick of
    each row's logits from a chunk, the token loop after sampling, the
    feedback, the next step's admission and inputs."""
    rows = step_parts(run, kind)
    return None if rows is None else _mean_ms(
        rows, lambda p: sum(_dur(p, n) for n in SCHED))


def cycle_ms(run, kind):
    """Mean cycle of the same steps (entry to the next step's entry): the
    parts above lie in it, one after another."""
    rows = step_parts(run, kind)
    return None if rows is None else float(
        np.mean([c for _, c, _ in rows])) * 1e3


def brackets_ms(run, kind):
    """The benchmark's two host brackets split by the spans, on the clock
    they share (``time.perf_counter``), ms a step: ``account_ms``'s from its
    stamp to ``engine.wait`` (the benchmark's own copy of the records and
    its range), ``engine.wait``, from there to ``engine.replay``,
    ``engine.replay`` and from the replay's end to its stamp;
    ``loop_host_ms``'s in the scheduler's spans and outside them."""
    rows = step_parts(run, kind)
    if rows is None:
        return None
    pre, mid, post = [], [], []
    for st, _, p in rows:
        w, r = p["engine.wait"][-1], p["engine.replay"][-1]
        pre.append(w["ts"] - st.t_dev)
        mid.append(r["ts"] - (w["ts"] + w["dur"]))
        post.append(st.t_account - (r["ts"] + r["dur"]))
    loop = readers.loop_host_ms(run, kind)
    sched = sched_ms(run, kind)
    return {"account_ms": readers.account_ms(run, kind),
            "to_wait_ms": 1e3 * float(np.mean(pre)),
            "wait_ms": _mean_ms(rows, lambda p: _dur(p, "engine.wait")),
            "to_replay_ms": 1e3 * float(np.mean(mid)),
            "replay_ms": replay_ms(run, kind),
            "after_replay_ms": 1e3 * float(np.mean(post)),
            "loop_host_ms": loop, "sched_ms": sched,
            "loop_outside_sched_ms": loop - sched}


def dispatch_fill(run, kind):
    """Percent of the rows the expert kernel is given that are routed
    rows of active tokens, over every dispatch of the steps."""
    rows = step_parts(run, kind)
    if rows is None:
        return None
    given = routed = 0
    for _, _, p in rows:
        for d in p.get("model.dispatch", ()):
            given += d["args"]["rows"]
            routed += d["args"]["routed"]
    return 100.0 * routed / given if given else None


def profile_tok_s(run):
    """Tokens the launcher's buddy profiling forwards over its host
    seconds (``setup.profile_buddies``)."""
    h = getattr(run, "host", None)
    spans = [] if h is None else [e for e in h.events
                                  if e["name"] == "setup.profile_buddies"]
    if not spans or not spans[0]["dur"]:
        return None
    return spans[0]["args"]["tokens"] / spans[0]["dur"]


# -- the device's idle time by program span -------------------------------
def idle_gaps(events) -> tuple:
    """(gaps, ranges): the device's idle intervals in the window
    ``devtrace.summarize`` takes (first ``chipbench.step`` range to the end
    of the last device op or benchmark range), and the program's host
    ranges [(start, end, label)] in it, in the trace's microseconds."""
    ops, bench_spans, ranges = [], [], []
    for evt in events:
        name = evt.name
        s, e = float(evt.time_range.start), float(evt.time_range.end)
        dev = devtrace._is_device(evt)
        if name.startswith("chipbench."):
            if not dev:
                bench_spans.append((name, s, e))
        elif _is_program(name):
            if not dev:
                ranges.append((s, e, name))
        elif dev:
            if e > s:
                ops.append((s, e))
    steps = sorted(s for n, s, _ in bench_spans if n == "chipbench.step")
    if not ops or not steps:
        return [], ranges
    lo = steps[0]
    hi = max(max(e for _, e in ops), max(e for _, _, e in bench_spans))
    merged = devtrace._merge([(max(s, lo), min(e, hi)) for s, e in ops
                              if e > lo and s < hi])
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return gaps, ranges


def innermost(ranges, t):
    """The label of the innermost program range covering ``t`` (the one
    that opened last; the shorter on a tie), or None."""
    best = None
    for s, e, label in ranges:
        if s <= t <= e and (best is None or s > best[0]
                            or (s == best[0] and e < best[1])):
            best = (s, e, label)
    return None if best is None else best[2]


def idle_by_span(events) -> dict:
    """Seconds of device idle by the innermost program span the host was
    in at each gap's midpoint (label with its layer, "" outside any), with
    "total" the sum (= the window less the device's busy time)."""
    gaps, ranges = idle_gaps(events)
    out = defaultdict(float)
    for a, b in gaps:
        out[innermost(ranges, 0.5 * (a + b)) or ""] += (b - a) * 1e-6
    out["total"] = sum(v for k, v in out.items())
    return dict(out)


def idle_under(events, name: str) -> float:
    """Seconds of device idle whose gap midpoint lies inside a program
    range ``name`` (at any depth below it)."""
    gaps, ranges = idle_gaps(events)
    under = [(s, e) for s, e, label in ranges
             if split_label(label)[0] == name]
    tot = 0.0
    for a, b in gaps:
        m = 0.5 * (a + b)
        if any(s <= m <= e for s, e in under):
            tot += (b - a) * 1e-6
    return tot


def issue_idle_ms(run, kind):
    """Device idle ms a traced step while the host issues it (every gap
    whose midpoint falls under ``engine.issue``), over the traced steps."""
    if getattr(run, "host", None) is None or \
            not readers._traced_kind(run, kind) or run._prof_done is None:
        return None
    n = sum(1 for s in run.steps if s.traced)
    return 1e3 * idle_under(run._prof_done.events(), "engine.issue") / n


READINGS = {"issue_ms": issue_ms, "device_wait_ms": device_wait_ms,
            "replay_ms": replay_ms, "sample_ms": sample_ms,
            "sched_ms": sched_ms, "cycle_ms": cycle_ms,
            "dispatch_fill": dispatch_fill, "issue_idle_ms": issue_idle_ms}


def readings(run, kind) -> dict:
    out = {f"{k}.{kind}": f(run, kind) for k, f in READINGS.items()}
    out["profile_tok_s"] = profile_tok_s(run)
    return out


def off_cost_ns(n: int = 200000) -> float:
    """ns per ``with trace.span(...)`` call site with no recorder active."""
    from repro_torch.runtime import trace
    assert trace.HOST is None
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("model.dispatch"):
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        pass
    t2 = time.perf_counter()
    return ((t1 - t0) - (t2 - t1)) / n * 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", default="1,0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload, ROOT)
    kind = "prefill" if "prefill" in args.workload else "decode"
    out = open(args.out, "a") if args.out else None
    for on in (bool(int(x)) for x in args.spans.split(",")):
        torch.cuda.reset_peak_memory_stats()
        cls = SpannedRun if on else bench.Run
        run = cls(cell, args.seed, args.seconds, True, "cuda")
        run.build()
        run.serve()
        run.read_trace()
        row = {"workload": args.workload, "seed": args.seed, "spans": on,
               "setup": run.setup, "per_layer": run.metrics("per_layer"),
               "spans_read": readings(run, kind),
               "cycle_ms": 1e3 * float(np.mean(
                   [c for _, c in readers._steps(run, kind)])),
               "window_steps": len(run.window_steps()),
               "memory_peak_bytes": run.memory_peak_bytes}
        if run._prof_done is not None:
            evs = run._prof_done.events()
            row["idle_by_span_ms"] = {k: v * 1e3 for k, v in sorted(
                idle_by_span(evs).items(), key=lambda kv: -kv[1])}
            row["devtrace_idle_ms"] = 1e3 * (run.devtrace["window_s"]
                                             - run.devtrace["busy_s"])
            row["step_ms_events"] = run.step_event_ms()
        if on:
            row["host_table"] = run.host.table()
            row["brackets_ms"] = brackets_ms(run, kind)
        line = json.dumps(row, default=float)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    row = {"off_cost_ns_per_call_site": off_cost_ns()}
    print(json.dumps(row), flush=True)
    if out:
        out.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
