"""One run of one cell: the engine built through the launcher from the
cell's flags on weights made here from the seed, the traffic through
``ContinuousScheduler.run``, a measured window on the wall clock, then
the judgement of what the window served.

The benchmark's own spans sit around the calls the scheduler makes into
the engine (``step``, ``prefill_rows``, ``sample_tokens``, and the
engine's ``_account``), on instance attributes of the one engine; the
scheduler and the queue are the program's, subclassed to stamp the wall
time of each admission and each emitted token. The window opens at the
first step after every slot has emitted its first token, and closes at
the first step that would start after ``--seconds``: that step never
runs.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from chipbench import devtrace, families, traffic, weights, yardstick

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class WindowClosed(Exception):
    """Raised from the engine's entry when the window has closed."""


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell names, found by the names in BENCHMARK.json,
    with the module of its configuration's family; a configuration whose
    family is missing or unknown stops here."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = [w for w in spec["workloads"] if w["name"] == name]
    if not wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    cfg_entry = [c for c in spec["configs"] if c["name"] == wl["config"]][0]
    base = root / "chipbench"
    config = json.loads((root / cfg_entry["file"]).read_text())
    family = families.load(config.get("family"), base / "families")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"name": name, "chips": wl["chips"],
            "config": config, "family": family,
            "cell": json.loads((base / "workloads" / f"{name}.json")
                               .read_text()),
            "mix": json.loads((base / "traffic" / f"{wl['traffic']}.json")
                              .read_text()),
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str):
    """The ``read(run)`` function of ``chipbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Step:
    kind: str                 # "decode" (engine.step) | "chunk"
    t_enter: float
    rids: list                # request id per batch row, -1 empty
    pos: np.ndarray           # [B] position, or chunk base position
    valid: np.ndarray         # [B] active rows, or [B, C] valid tokens
    residency: np.ndarray     # [M, E] the step's expert residency
    traced: bool = False
    t_dev: float = math.nan   # the step's device work done
    t_account: float = math.nan
    t_exit: float = math.nan
    t_sample0: float = math.nan
    t_sample1: float = math.nan
    aux: Optional[dict] = None  # [M, T, K] top-k / substituted / missed
    served_logit: Optional[torch.Tensor] = None  # [B] the sampled token's
    events: Optional[tuple] = None  # traced: CUDA events, entry to _account


class Run:
    """One run of ``cell`` (from ``load_cell``). ``device`` "cuda" for the
    benchmark; the CPU tests run the same path on the kernels' plain
    versions."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_process: Optional[float] = None):
        self.cell = cell
        self.rc = cell["config"]["as_run"]
        self.family = cell["family"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_process = time.perf_counter() if t_process is None \
            else t_process
        self.setup: dict = {}
        self.steps: list = []
        self.admitted: dict = {}
        self.emitted: dict = {}
        self.emitted_slots: set = set()
        self.emitted_at: dict = {}    # (rid, j) -> (step index, row)
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.kernel_calls: list = []
        self.devtrace: dict = {}
        self.memory_peak_bytes = 0
        self._prof = None
        self._prof_done = None
        self._traced_left = 0

    # -- set-up ---------------------------------------------------------
    def build(self) -> None:
        t = time.perf_counter
        from repro_torch.launch import serve
        self.setup["import_s"] = t() - self.t_process
        argv = (self.cell["config"]["launcher"] + self.cell["cell"]["launcher"]
                + ["--device", self.device.type])
        self.args = args = serve.parse_args(argv)
        self._judgeable(args)
        cfg = serve.model_config(args)
        self._same_sizes(cfg)
        t0 = t()
        self.params = weights.make(self.family, self.rc, self.seed,
                                   self.device)
        self._sync()
        self.setup["init_s"] = t() - t0
        orig = serve.profile_buddies
        fwd = serve.transformer.forward_train
        self.profile_topk = []

        def forward_train(*a, **kw):
            # the router's top-k of each profiling forward, for the
            # reference to judge and to build its own tables from
            out = fwd(*a, **kw)
            rec = out[1].get("recorded") or []
            self.profile_topk.append(torch.cat(
                [g["indices"].reshape(g["indices"].shape[0], -1,
                                      g["indices"].shape[-1])
                 for g in rec]).cpu() if rec else None)
            return out

        def timed(*a, **kw):
            t1 = t()
            serve.transformer.forward_train = forward_train
            try:
                out = orig(*a, **kw)
            finally:
                serve.transformer.forward_train = fwd
            self._sync()
            self.setup["profile_s"] = t() - t1
            return out
        serve.profile_buddies = timed
        t0 = t()
        try:
            self.eng, _ = serve.build_engine(args, params=self.params)
        finally:
            serve.profile_buddies = orig
        self.setup["engine_s"] = t() - t0

    @staticmethod
    def _judgeable(args) -> None:
        """The reference judges the precedence policy without the quant
        tier, the mesh or paged KV; other flags are refused, not run."""
        bad = [n for n, ok in (
            ("--policy", args.policy in ("buddy", "none")),
            ("--miss-policy", args.miss_policy == "precedence"),
            ("--quant-tier", args.quant_tier == "off"),
            ("--n-devices", args.n_devices == 1),
            ("--paged-kv", not args.paged_kv),
            ("--mode", args.mode == "continuous"),
            ("--adaptive-chunk", not args.adaptive_chunk)) if not ok]
        if bad:
            raise ValueError(f"the reference cannot judge {bad}")

    def _same_sizes(self, cfg) -> None:
        for key, attr in self.family.CFG_KEYS.items():
            v = cfg
            for a in attr.split("."):
                v = getattr(v, a)
            want = self.rc[key]
            if (isinstance(want, float) and not math.isclose(v, want)) or \
                    (not isinstance(want, float) and v != want):
                raise ValueError(f"the program's {attr} is {v!r}; the "
                                 f"configuration file says {want!r}")

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # -- the loop -------------------------------------------------------
    def serve(self) -> None:
        from repro_torch.serving.scheduler import (ContinuousScheduler,
                                                   ReplayArrivals,
                                                   RequestQueue,
                                                   make_requests)
        run = self
        reqs = traffic.requests(self.cell["mix"], self.seed,
                                self.rc["vocab_size"])
        self.requests = make_requests([p for p, _ in reqs],
                                      ReplayArrivals([0.0] * len(reqs)),
                                      [o for _, o in reqs])

        class Queue(RequestQueue):
            def pop(self, now, *a, **kw):
                r = super().pop(now, *a, **kw)
                if r is not None:
                    run.admitted[r.rid] = time.perf_counter()
                return r

        class Scheduler(ContinuousScheduler):
            def _emit(self, slot, i, nxt, t1, tok):
                walls = run.emitted.setdefault(slot[i].rid, [])
                run.emitted_at[(slot[i].rid, len(walls))] = (
                    len(run.steps) - 1, i)
                walls.append(time.perf_counter())
                run.emitted_slots.add(i)
                super()._emit(slot, i, nxt, t1, tok)

        self.queue = Queue(self.requests)
        self.sched = Scheduler(self.eng, slots=self.args.slots,
                               prefill_chunk=self.args.prefill_chunk)
        self._wrap()
        t_loop = time.perf_counter()
        try:
            self.sched.run(self.queue)
        except WindowClosed:
            pass
        else:
            raise RuntimeError("the traffic ran out before the window "
                               "closed: give the mix more blocks")
        finally:
            self._unwrap()
            if self._prof is not None:
                self._stop_profiler()
        self._sync()
        self.memory_peak_bytes = (torch.cuda.max_memory_allocated(self.device)
                                  if self.cuda else 0)
        self.setup["warmup_s"] = self.t_open - t_loop
        self.setup["setup_s"] = self.t_open - self.t_process
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def _enter(self, kind, pos, valid):
        now = time.perf_counter()
        if self.t_open is None and len(self.emitted_slots) >= self.args.slots:
            self.t_open = now
        if self.t_open is not None and now >= self.t_open + self.seconds:
            self.t_close = now
            raise WindowClosed
        if self._prof is not None and self._traced_left == 0:
            self._stop_profiler()
        if (self.trace and self._prof is None and self._prof_done is None
                and self.t_open is not None and now >= self.t_open
                + self.cell["cell"]["trace_at"] * self.seconds):
            self._start_profiler()
        traced = self._prof is not None
        if traced:
            self._traced_left -= 1
        st = Step(kind, now, [(-1 if r is None else r.rid)
                              for r in self.sched._slot],
                  np.array(pos, copy=True), np.array(valid, copy=True),
                  self.eng.cache.residency_mask(), traced)
        self.steps.append(st)
        return st

    def _start_profiler(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._traced_left = int(self.cell["cell"]["trace_steps"])

    def _stop_profiler(self) -> None:
        self._sync()
        prof, self._prof = self._prof, None
        prof.stop()
        self._prof_done = prof

    def _in_window(self) -> bool:
        return (self.t_open is not None and self.t_close is None
                and self._prof is None)

    def _wrap(self) -> None:
        eng, run = self.eng, self
        rf = torch.profiler.record_function
        self._orig = {n: getattr(eng, n) for n in
                      ("step", "prefill_rows", "_account", "sample_tokens")}
        o = self._orig

        def step(token, caches, pos, active=None):
            st = run._enter("decode", pos, active)
            run._event(st)
            with rf("chipbench.step"):
                out = o["step"](token, caches, pos, active=active)
            st.t_exit = time.perf_counter()
            return out

        def prefill_rows(tokens, rows, caches, base_pos, tok_valid=None):
            rows_b = np.asarray(rows, bool)
            valid = (np.asarray(tok_valid, bool) & rows_b[:, None]
                     if tok_valid is not None else
                     np.repeat(rows_b[:, None], np.shape(tokens)[1], 1))
            st = run._enter("chunk", base_pos, valid)
            run._event(st)
            with rf("chipbench.step"):
                out = o["prefill_rows"](tokens, rows, caches, base_pos,
                                        tok_valid=tok_valid)
            st.t_exit = time.perf_counter()
            return out

        def account(aux, active):
            st = run.steps[-1]
            run._event(st)
            run._sync()
            st.t_dev = time.perf_counter()
            rec = aux.get("recorded", [])
            if rec:
                st.aux = {k: torch.cat([g[k] for g in rec]) for k in
                          ("indices", "substituted", "missed")}
            with rf("chipbench.account"):
                o["_account"](aux, active)
            st.t_account = time.perf_counter()

        def sample_tokens(logits, greedy, temperature=1.0):
            st = run.steps[-1]
            st.t_sample0 = time.perf_counter()
            with rf("chipbench.sample"):
                out = o["sample_tokens"](logits, greedy, temperature)
                # the logit of each row's sampled token, kept on the
                # device for the judgement
                tok = torch.as_tensor(out).to(logits.device, torch.int64)
                st.served_logit = logits.gather(1, tok[:, None])[:, 0]
            st.t_sample1 = time.perf_counter()
            return out

        eng.step, eng.prefill_rows = step, prefill_rows
        eng._account, eng.sample_tokens = account, sample_tokens
        if self.trace and self.cuda:
            self._wrap_kernels()

    def _wrap_kernels(self) -> None:
        """Traced runs: CUDA events around each expert FFN dispatch in the
        window (the profiled steps excepted), and the rows and experts it
        was given, counted after its end event."""
        from repro_torch.kernels import ops
        run = self
        self._ops = ops
        self._orig_ops = {n: getattr(ops, n)
                          for n in ("expert_ffn", "grouped_ffn")}
        oe, og = self._orig_ops["expert_ffn"], self._orig_ops["grouped_ffn"]

        def timed(name, fn, count):
            def call(*a, **kw):
                if not run._in_window():
                    return fn(*a, **kw)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*a, **kw)
                e.record()
                rows, live = count(*a, **kw)
                run.kernel_calls.append((name, s, e, rows, live))
                return out
            return call

        def count_capacity(x, *_, **__):
            filled = x.abs().amax(-1) > 0                    # [E, C]
            return filled.sum(), filled.any(-1).sum()

        def count_grouped(x, w1, w3, w2, quant=None, counts=None):
            if counts is None or quant is not None:
                raise ValueError("grouped_ffn is timed with counts and "
                                 "without the quant tier only")
            e_n = w1.shape[0]
            return counts.sum(), (counts[:e_n] > 0).sum()

        ops.expert_ffn = timed("expert_ffn", oe, count_capacity)
        ops.grouped_ffn = timed("grouped_ffn", og, count_grouped)

    def _event(self, st: Step) -> None:
        """Traced steps on the card: a CUDA event at the step's entry and
        one where ``_account`` starts (all the step's kernels issued)."""
        if st.traced and self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            st.events = (st.events or ()) + (e,)

    def step_event_ms(self) -> Optional[float]:
        """Mean CUDA-event time of the traced steps, from the step's entry
        to the start of its ``_account``: the device time ``step_device_ms``
        reads from the trace, with the device's idle gaps inside the
        step."""
        evs = [s.events for s in self.steps
               if s.events is not None and len(s.events) == 2]
        if not evs:
            return None
        self._sync()
        return float(np.mean([a.elapsed_time(b) for a, b in evs]))

    def _unwrap(self) -> None:
        for n, f in self._orig.items():
            delattr(self.eng, n)
        if getattr(self, "_orig_ops", None):
            for n, f in self._orig_ops.items():
                setattr(self._ops, n, f)

    # -- after the window -----------------------------------------------
    def read_trace(self) -> None:
        if self._prof_done is not None:
            self.devtrace = devtrace.summarize(self._prof_done.events())

    def kernel_times(self) -> list:
        """[(name, seconds, rows, live experts)] of the timed calls."""
        self._sync()
        return [(n, s.elapsed_time(e) * 1e-3, int(r), int(lv))
                for n, s, e, r, lv in self.kernel_calls]

    def window_steps(self, kind: Optional[str] = None) -> list:
        """Steps wholly in the window (entered after it opened; it closes
        before the next step enters), of ``kind`` if given."""
        return [s for s in self.steps
                if s.t_enter >= self.t_open and not math.isnan(s.t_sample1)
                and s.t_sample1 <= self.t_close
                and (kind is None or s.kind == kind)]

    def prompt_len(self, rid: int) -> int:
        return len(self.requests[rid].prompt)

    def step_flops(self, st: Step) -> float:
        """Operations the step's valid tokens need: every fed position at
        its context; the head only where the row's logits are sampled."""
        fam, rc = self.family, self.rc
        total = 0.0
        for i, rid in enumerate(st.rids):
            if rid < 0:
                continue
            plen = self.prompt_len(rid)
            if st.kind == "decode":
                if not st.valid[i]:
                    continue
                p = int(st.pos[i])
                total += yardstick.token_flops(fam, rc, p + 1,
                                               p >= plen - 1)
            else:
                n = int(st.valid[i].sum())
                for j in range(n):
                    p = int(st.pos[i]) + j
                    total += yardstick.token_flops(
                        fam, rc, p + 1, j == n - 1 and p >= plen - 1)
        return total

    def attempted_failed(self) -> tuple:
        n = 0
        for r in self.requests:
            a = self.admitted.get(r.rid)
            if a is None or a > self.t_close:
                continue
            walls = self.emitted.get(r.rid, [])
            done = len(walls) >= r.max_new_tokens
            if not done or walls[-1] >= self.t_open:
                n += 1
        return n, len(self.queue.rejected)

    def metrics(self, which: str) -> dict:
        """{name: {"value", "unit"}} of the cell's end-to-end (``which`` =
        "end_to_end") or per-layer metrics; a reader that finds nothing
        to read leaves its metric out."""
        out = {}
        for m in self.cell[which]:
            v = reader(m["name"])(self)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
