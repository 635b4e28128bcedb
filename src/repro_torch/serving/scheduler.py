"""Continuous-batching request scheduler on the transfer timeline.

Counterpart of ``repro/serving/scheduler.py``: the same host-side (numpy)
scheduling on the simulated clock; the engine's steps run on its device.
The request-lifecycle trace spans are emitted only with a telemetry bundle,
which the port's engine does not take yet.

The paper's llama.cpp harness serves fixed static batches: a batch forms,
decodes in lockstep to completion, and only then does the next batch start.
BuddyMoE's value — hiding PCIe transfers behind compute and absorbing late
prefetches with buddies — only shows up under realistic serving load, where
requests arrive continuously and queueing interacts with expert-transfer
stalls. This module turns the repro into a traffic-serving simulator:

  ArrivalProcess     Poisson / bursty (Markov-modulated) / trace-replay
                     request arrival generators, all in SIMULATED seconds on
                     the same clock the TransferScheduler advances.
  ServeRequest       per-request SLO state: arrival, admission, TTFT, TPOT,
                     deadline, per-token emission timestamps.
  RequestQueue       FCFS backlog with optional SLO-aware admission: a
                     request whose deadline cannot be met given the current
                     service-time estimate is shed instead of admitted.
  ContinuousScheduler token-level continuous batching over ServeEngine's
                     per-layer step timeline: requests join free decode
                     slots mid-stream (per-row positions — no global
                     barrier), retire the step their budget completes, and
                     the freed slot is re-used immediately. Prefetch budget
                     adapts to queue depth + stall attribution through
                     runtime.prefetch.AdaptiveBudgetController.
  StaticServer       the llama.cpp-style baseline on the same clock:
                     batch formation barrier, left-padded prompts, lockstep
                     decode, stragglers hold the whole batch.

Both servers report p50/p95/p99 TTFT / TPOT / end-to-end latency and
goodput (SLO-satisfying requests and tokens per simulated second), next to
``ServeEngine.summary()``'s stall attribution — the measurement substrate
for the serving-load experiments.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime.prefetch import AdaptiveBudgetController

# Request lifecycle states
WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
REJECTED = "rejected"           # shed by SLO-aware admission


# ===========================================================================
# Arrival processes (simulated-clock seconds)
# ===========================================================================
class ArrivalProcess:
    def times(self, n: int) -> np.ndarray:
        raise NotImplementedError


class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at ``rate`` requests per simulated second."""

    def __init__(self, rate: float, seed: int = 0, start_s: float = 0.0):
        assert rate > 0
        self.rate = rate
        self.seed = seed
        self.start_s = start_s

    def times(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, n)
        return self.start_s + np.cumsum(gaps)


class BurstyArrivals(ArrivalProcess):
    """Markov-modulated Poisson: bursts of ~``burst_size`` requests arrive at
    ``burstiness`` x the base rate, separated by long quiet gaps, with the
    same long-run mean rate as PoissonArrivals(rate)."""

    def __init__(self, rate: float, burst_size: int = 4,
                 burstiness: float = 8.0, seed: int = 0, start_s: float = 0.0):
        assert rate > 0 and burst_size >= 1 and burstiness > 1.0
        self.rate = rate
        self.burst_size = burst_size
        self.burstiness = burstiness
        self.seed = seed
        self.start_s = start_s

    def times(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        # inside a burst: gaps at burstiness*rate; between bursts: the gap is
        # stretched so the long-run mean matches `rate`
        out, t = [], self.start_s
        fast = 1.0 / (self.rate * self.burstiness)
        # mean time per burst cycle must be burst_size/rate:
        slow = self.burst_size / self.rate - (self.burst_size - 1) * fast
        while len(out) < n:
            size = max(1, int(rng.geometric(1.0 / self.burst_size)))
            t += rng.exponential(slow)
            for _ in range(min(size, n - len(out))):
                out.append(t)
                t += rng.exponential(fast)
        return np.asarray(out[:n])


class ReplayArrivals(ArrivalProcess):
    """Replay recorded arrival timestamps (sorted)."""

    def __init__(self, times_s: Sequence[float]):
        self._times = np.sort(np.asarray(times_s, np.float64))

    def times(self, n: int) -> np.ndarray:
        assert n <= len(self._times), "trace shorter than request count"
        return self._times[:n].copy()


def load_trace(path: str) -> List[dict]:
    """Load a serving trace: JSONL rows of
    ``{"t_arrival": <simulated s>, "prompt_len": P, "max_new_tokens": M}``
    (blank lines and ``#`` comments skipped). Rows may carry optional
    ``session`` / ``parent`` ints so a recorded trace can express prefix
    structure (multi-turn sessions sharing a system prompt; ``parent`` is
    the previous turn's row). Rows are returned sorted by arrival time —
    the ReplayArrivals contract."""
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                d = json.loads(line)
                row = {"t_arrival": float(d["t_arrival"]),
                       "prompt_len": int(d["prompt_len"]),
                       "max_new_tokens": int(d["max_new_tokens"])}
                if "session" in d:
                    row["session"] = int(d["session"])
                if "parent" in d:
                    row["parent"] = int(d["parent"])
                rows.append(row)
            except (KeyError, TypeError, ValueError) as e:
                # TypeError covers valid-JSON non-object rows ('[0.1, 5, 3]')
                raise ValueError(f"{path}:{ln}: bad trace row {line!r}") from e
    if not rows:
        raise ValueError(f"empty trace file: {path}")
    if not all(r["prompt_len"] >= 1 and r["max_new_tokens"] >= 1
               for r in rows):
        raise ValueError("trace rows need prompt_len/max_new_tokens >= 1")
    rows.sort(key=lambda r: r["t_arrival"])
    return rows


def requests_from_trace(path: str, sample_prompt: Callable[[int], np.ndarray],
                        slo: Optional[SLOConfig] = None,
                        limit: Optional[int] = None) -> List[ServeRequest]:
    """Workload replay from a recorded trace file (ROADMAP follow-up):
    arrivals are replayed verbatim and every request carries its OWN token
    budget from the trace row. ``sample_prompt(P)`` supplies prompt tokens of
    the recorded length (real traces record lengths, not content)."""
    rows = load_trace(path)
    if limit is not None:
        rows = rows[:limit]
    prompts = [np.asarray(sample_prompt(r["prompt_len"])) for r in rows]
    for p, r in zip(prompts, rows):
        assert p.ndim == 1 and len(p) == r["prompt_len"], \
            f"sample_prompt returned {p.shape} for prompt_len {r['prompt_len']}"
    reqs = make_requests(prompts,
                         ReplayArrivals([r["t_arrival"] for r in rows]),
                         [r["max_new_tokens"] for r in rows], slo)
    for q, r in zip(reqs, rows):
        q.session = r.get("session")
        q.parent = r.get("parent")
    return reqs


# ===========================================================================
# Requests + SLO state
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Per-request service-level objectives (simulated seconds). ``None``
    disables a term. ``deadline_s`` is relative to arrival."""
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                  # [P] int tokens
    max_new_tokens: int
    arrival_s: float
    slo: Optional[SLOConfig] = None
    session: Optional[int] = None       # shared-prefix session id (traces)
    parent: Optional[int] = None        # previous turn's rid in the session
    # -- runtime state (filled by the scheduler) ------------------------
    state: str = WAITING
    admitted_s: float = -1.0
    first_token_s: float = -1.0
    finished_s: float = -1.0
    rejected_s: float = -1.0            # shed time (SLO admission)
    cursor: int = 0                     # next prompt token to feed
    prefix_hit_tokens: int = 0          # prompt tokens served from the cache
    tokens: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)

    # -- metrics --------------------------------------------------------
    def ttft(self) -> float:
        return self.first_token_s - self.arrival_s

    def tpot(self) -> float:
        """Mean time per output token after the first."""
        if len(self.token_times) < 2:
            return 0.0
        return ((self.token_times[-1] - self.token_times[0])
                / (len(self.token_times) - 1))

    def e2e(self) -> float:
        return self.finished_s - self.arrival_s

    def token_gaps(self) -> List[float]:
        """Per-token latency: arrival->first token, then inter-token gaps."""
        ts = [self.arrival_s] + list(self.token_times)
        return [b - a for a, b in zip(ts, ts[1:])]

    def slo_ok(self) -> bool:
        if self.state != FINISHED:
            return False
        if self.slo is None:
            return True
        s = self.slo
        if s.ttft_s is not None and self.ttft() > s.ttft_s:
            return False
        if s.tpot_s is not None and len(self.token_times) > 1 \
                and self.tpot() > s.tpot_s:
            return False
        if s.deadline_s is not None and self.e2e() > s.deadline_s:
            return False
        return True


def make_requests(prompts: Sequence[np.ndarray], arrivals: ArrivalProcess,
                  max_new_tokens, slo: Optional[SLOConfig] = None
                  ) -> List[ServeRequest]:
    """Zip prompts with an arrival process into a workload. ``max_new_tokens``
    is an int or a per-request sequence."""
    n = len(prompts)
    ts = arrivals.times(n)
    if np.isscalar(max_new_tokens):
        max_new_tokens = [int(max_new_tokens)] * n
    return [ServeRequest(rid=i, prompt=np.asarray(p, np.int64),
                         max_new_tokens=int(m), arrival_s=float(t), slo=slo)
            for i, (p, m, t) in enumerate(zip(prompts, max_new_tokens, ts))]


# ===========================================================================
# Request queue with SLO-aware admission
# ===========================================================================
class RequestQueue:
    """FCFS backlog on the simulated clock. ``admission="slo"`` sheds
    requests at pop time when the service-time estimate says their deadline
    is already unreachable — serving them would waste slots that later
    requests could still use (goodput-aware load shedding)."""

    def __init__(self, requests: Sequence[ServeRequest],
                 admission: str = "fcfs"):
        assert admission in ("fcfs", "slo")
        self.admission = admission
        self.total = len(requests)          # offered workload size
        self._future = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        self._pending: List[ServeRequest] = []
        self.rejected: List[ServeRequest] = []
        self.peak_depth = 0

    # -- clock-driven release -------------------------------------------
    def release_until(self, now: float) -> None:
        while self._future and self._future[0].arrival_s <= now:
            self._pending.append(self._future.pop(0))
        self.peak_depth = max(self.peak_depth, len(self._pending))

    def depth(self, now: Optional[float] = None) -> int:
        if now is not None:
            self.release_until(now)
        return len(self._pending)

    def next_arrival(self) -> Optional[float]:
        return self._future[0].arrival_s if self._future else None

    @property
    def exhausted(self) -> bool:
        return not self._future and not self._pending

    def max_context(self) -> int:
        rs = self._future + self._pending
        return max((len(r.prompt) + r.max_new_tokens for r in rs), default=1)

    # -- admission ------------------------------------------------------
    def pop(self, now: float,
            est_service_fn: Optional[Callable[[ServeRequest], float]] = None
            ) -> Optional[ServeRequest]:
        """Next admissible request, shedding doomed ones under ``slo``."""
        self.release_until(now)
        while self._pending:
            r = self._pending.pop(0)
            if (self.admission == "slo" and est_service_fn is not None
                    and r.slo is not None and r.slo.deadline_s is not None):
                est_finish = now + est_service_fn(r)
                if est_finish > r.arrival_s + r.slo.deadline_s:
                    r.state = REJECTED
                    r.rejected_s = now
                    self.rejected.append(r)
                    continue
            return r
        return None

    def requeue(self, r: ServeRequest) -> None:
        """Put a preempted request back at the FRONT of the backlog (it is
        the oldest admitted work, so FCFS order is preserved)."""
        self._pending.insert(0, r)


# ===========================================================================
# Request-lifecycle trace spans (flight recorder, "requests" track)
# ===========================================================================
def emit_request_spans(trace, requests: Sequence[ServeRequest],
                       emitted: set) -> int:
    """Emit each request's lifecycle onto the recorder's "requests" track:
    arrive instant, queued span (arrival -> admit/shed), prefill span
    (admit -> first token), decode span (first token -> retire), per-token
    instants, and a retire/shed terminal instant. Lane = request id.

    Requests still WAITING/RUNNING (truncated run) get only the events whose
    timestamps exist, so a mid-step-truncated trace is still loadable.
    ``emitted`` (a set of rids owned by the caller) makes the call
    idempotent — summary() can run more than once without duplicating
    spans. Returns the number of requests newly emitted."""
    n = 0
    for r in requests:
        if r.rid in emitted:
            continue
        emitted.add(r.rid)
        n += 1
        trace.instant("requests", r.rid, "arrive", f"req{r.rid}",
                      r.arrival_s, prompt_len=len(r.prompt),
                      max_new_tokens=r.max_new_tokens)
        if r.state == REJECTED:
            end = r.rejected_s if r.rejected_s >= 0 else r.arrival_s
            trace.span("requests", r.rid, "queued", "queued",
                       r.arrival_s, end)
            trace.instant("requests", r.rid, "shed", "shed", end,
                          reason="slo_admission")
            continue
        if r.admitted_s < 0:
            continue                        # never admitted (truncated run)
        trace.span("requests", r.rid, "queued", "queued",
                   r.arrival_s, r.admitted_s)
        if r.prefix_hit_tokens > 0:
            # admit-with-prefix-hit: this many prompt tokens were adopted
            # from the radix cache instead of being prefilled
            trace.instant("requests", r.rid, "prefix_hit", "prefix_hit",
                          r.admitted_s, hit_tokens=r.prefix_hit_tokens,
                          prompt_len=len(r.prompt))
        if r.first_token_s >= 0:
            trace.span("requests", r.rid, "prefill", "prefill",
                       r.admitted_s, r.first_token_s)
        end = r.finished_s if r.finished_s >= 0 else (
            r.token_times[-1] if r.token_times else r.admitted_s)
        if r.first_token_s >= 0:
            trace.span("requests", r.rid, "decode", "decode",
                       r.first_token_s, end, tokens=len(r.tokens))
        for k, t in enumerate(r.token_times):
            trace.instant("requests", r.rid, "token", f"tok{k}", t)
        if r.state == FINISHED:
            trace.instant("requests", r.rid, "retire", "retire", end,
                          ttft_s=r.ttft(), e2e_s=r.e2e(),
                          slo_ok=r.slo_ok())
    return n


# ===========================================================================
# Percentile / summary helpers
# ===========================================================================
def percentiles(xs: Sequence[float]) -> dict:
    """p50/p95/p99/mean with linear interpolation (empty -> zeros)."""
    if not len(xs):
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


def _summarize(label: str, requests: Sequence[ServeRequest],
               rejected: Sequence[ServeRequest], elapsed_s: float,
               engine, extra: Optional[dict] = None,
               total: Optional[int] = None) -> dict:
    """``total`` is the offered workload size — requests still waiting or
    running when a run truncates must count against the SLO fraction."""
    done = [r for r in requests if r.state == FINISHED]
    ok = [r for r in done if r.slo_ok()]
    gaps = [g for r in done for g in r.token_gaps()]
    tok_ok = sum(len(r.tokens) for r in ok)
    tok_all = sum(len(r.tokens) for r in done)
    el = max(elapsed_s, 1e-12)
    if total is None:
        total = len(requests) + len(rejected)
    out = {
        "mode": label,
        "num_requests": total,
        "completed": len(done),
        "rejected": len(rejected),
        "slo_met": len(ok),
        "slo_met_frac": len(ok) / max(1, total),
        "elapsed_s": elapsed_s,
        "ttft_s": percentiles([r.ttft() for r in done]),
        "tpot_s": percentiles([r.tpot() for r in done if len(r.tokens) > 1]),
        "e2e_s": percentiles([r.e2e() for r in done]),
        "token_latency_s": percentiles(gaps),
        "goodput_rps": len(ok) / el,
        "goodput_tok_s": tok_ok / el,
        "throughput_tok_s": tok_all / el,
        "engine": engine.summary(),
    }
    if extra:
        out.update(extra)
    return out


# ===========================================================================
# Continuous batching
# ===========================================================================
class ContinuousScheduler:
    """Token-level continuous batching over a ServeEngine.

    ``slots`` decode rows step together in one fixed-shape step, but
    each row carries its own position (per-row ring-buffer KV) so a new
    prompt joins the step after a slot frees — prefill tokens of one request
    interleave with decode tokens of the others, no global barrier. A row
    retires the step its budget completes and the slot is re-admitted from
    the queue before the next step.

    ``prefill_chunk`` > 1 switches admission to CHUNKED prefill: a joining
    prompt is ingested in ⌈P/C⌉ fused multi-token steps
    (``ServeEngine.prefill_rows``) instead of P token-by-token decode steps.
    Decode rows ride the same fused step as 1-valid-token chunks, so they
    keep emitting while a neighbour slot prefills (each fused step is one
    step on the clock — the chunked-prefill interference trade-off: slightly
    longer steps for everyone vs a far shorter prefill phase and TTFT).
    """

    def __init__(self, engine, slots: int, *,
                 greedy: bool = True, temperature: float = 1.0,
                 controller: Optional[AdaptiveBudgetController] = None,
                 max_steps: int = 1_000_000, prefill_chunk: int = 1,
                 adaptive_chunk: bool = False):
        if slots < 1 or prefill_chunk < 1:
            raise ValueError(f"slots ({slots}) and prefill_chunk "
                             f"({prefill_chunk}) must be >= 1")
        self.engine = engine
        self.slots = slots
        self.greedy = greedy
        self.temperature = temperature
        self.controller = controller
        self.max_steps = max_steps
        self.prefill_chunk = prefill_chunk
        # shrink a joining prompt's chunk while co-resident decode rows are
        # under TPOT pressure (carried-over ROADMAP item); off by default —
        # the fixed-chunk path is byte-identical
        self.adaptive_chunk = adaptive_chunk
        self.completed: List[ServeRequest] = []
        self.occupancy: List[int] = []
        self.steps = 0
        self._trace_emitted: set = set()    # rids already on the trace
        # live references into the running loop's slot/pos/tok state so
        # preempt() can be driven mid-run (e.g. from a controller)
        self._slot: Optional[List[Optional[ServeRequest]]] = None
        self._pos: Optional[np.ndarray] = None
        self._tok: Optional[np.ndarray] = None

    # -- service-time estimate for SLO-aware admission ------------------
    def _est_service(self, r: ServeRequest, est_step_s: float) -> float:
        prefill_steps = -(-len(r.prompt) // self.prefill_chunk)
        return (prefill_steps + r.max_new_tokens) * est_step_s

    def _effective_chunk(self, slot, pos) -> int:
        """Per-step prefill chunk size. With ``adaptive_chunk``, halve the
        chunk while the EWMA step time exceeds the tightest TPOT budget of
        a co-resident DECODE row — a joining prompt's long fused steps are
        exactly what inflates its neighbours' inter-token gaps. Step time
        is ~linear in fed tokens at the margin (the weight-streaming term
        is per-step), so each halving roughly halves the projection;
        power-of-two shrinks also bound the chunk shapes to log2(C)."""
        c = self.prefill_chunk
        if not self.adaptive_chunk or c <= 1:
            return c
        budgets = [r.slo.tpot_s for i, r in enumerate(slot)
                   if r is not None and r.slo is not None
                   and r.slo.tpot_s is not None and pos[i] >= len(r.prompt)]
        if not budgets:
            return c
        budget, est = min(budgets), self._est_step_s
        while c > 1 and est > budget:
            c //= 2
            est /= 2.0
        return max(1, c)

    # -- scaffolding shared by the token-by-token and chunked loops -----
    def _admit(self, queue: RequestQueue, slot, pos, tok, caches):
        """Fill free slots from the backlog at the current clock; reset the
        decode caches of reused rows. Returns (caches, active mask)."""
        eng = self.engine
        now = eng.scheduler.now
        newly = []
        for i in range(self.slots):
            if slot[i] is not None:
                continue
            r = queue.pop(now,
                          lambda rq: self._est_service(rq, self._est_step_s))
            if r is None:
                break
            r.state = RUNNING
            r.admitted_s = now
            r.cursor = 1
            slot[i] = r
            pos[i] = 0
            tok[i] = int(r.prompt[0])
            newly.append(i)
        if newly:
            caches = eng.reset_rows(caches, newly)
        if getattr(eng, "prefix_tree", None) is not None:
            # radix-cache admission: adopt the longest cached prefix and
            # start prefill at the first novel token — a full-prefix hit
            # leaves exactly one token to feed (near-zero TTFT)
            for i in newly:
                r = slot[i]
                m = eng.adopt_prefix(i, r.prompt)
                if m > 0:
                    r.prefix_hit_tokens = m
                    pos[i] = m
                    tok[i] = int(r.prompt[m])
                    r.cursor = m + 1
        return caches, np.array([s is not None for s in slot], bool)

    def _tick(self, t0: float, n_active: int) -> float:
        """Post-step bookkeeping: refine the EWMA step estimate, count the
        step and its occupancy. Returns the step's completion time."""
        t1 = self.engine.scheduler.now
        self._est_step_s = 0.9 * self._est_step_s + 0.1 * max(t1 - t0, 1e-12)
        self.steps += 1
        self.occupancy.append(n_active)
        return t1

    def _emit(self, slot, i: int, nxt: int, t1: float, tok) -> None:
        """Record a sampled token for slot ``i``; mid-step retirement frees
        the slot the step its budget completes."""
        r = slot[i]
        r.tokens.append(nxt)
        r.token_times.append(t1)
        if r.first_token_s < 0:
            r.first_token_s = t1
        tok[i] = nxt
        if len(r.tokens) >= r.max_new_tokens:
            r.state = FINISHED
            r.finished_s = t1
            self.completed.append(r)
            slot[i] = None
            # paged KV: hand the retired row's pages back immediately (its
            # donated prefix blocks stay alive via radix-tree refcounts);
            # no-op for a ring engine
            self.engine.release_kv_row(i)

    def _maybe_insert_prefix(self, i: int, r: ServeRequest) -> None:
        """Donate a row's prompt KV to the radix cache the step its prefill
        completes (both serving loops call this exactly once per request —
        the step where pos crosses len(prompt))."""
        if getattr(self.engine, "prefix_tree", None) is not None:
            self.engine.insert_prefix(i, r.prompt)

    def preempt(self, i: int, queue: RequestQueue) -> None:
        """Evict a still-PREFILLING row under pressure: release its KV pages
        (the prefix it donated — or matched — stays warm in the radix tree)
        and put the request back at the head of the backlog for
        re-admission, where the prefix cache makes the lost work cheap to
        recover. Only callable mid-run (run()/._run_chunked stash live
        state); rows that have emitted tokens cannot be preempted — their
        sampled continuation would be lost."""
        assert self._slot is not None, "preempt() only applies mid-run"
        r = self._slot[i]
        assert r is not None, f"slot {i} is empty"
        assert not r.tokens, "cannot preempt a decoding row (tokens emitted)"
        self.engine.release_kv_row(i)
        r.state = WAITING
        r.admitted_s = -1.0
        r.cursor = 0
        r.prefix_hit_tokens = 0
        self._slot[i] = None
        self._pos[i] = 0
        self._tok[i] = 0
        queue.requeue(r)

    def _feedback(self, queue: RequestQueue) -> None:
        """Resize the prefetch budget from stall attribution + queue depth
        (and, with cost-ranked prefetch, the count of candidates whose
        expected stall saved was worth the bytes). The engine's placement
        controller rides the same step loop: its tick is interval-gated on
        the simulated clock, so calling it here AND from the engine's
        step accounting never double-fires a window."""
        if self.controller is not None:
            self.controller.observe_step(
                self.engine.stall_breakdown(),
                queue.depth(self.engine.scheduler.now),
                worthwhile=getattr(self.engine,
                                   "last_prefetch_worthwhile", None))
            self.controller.apply(self.engine)
        placement = getattr(self.engine, "placement", None)
        if placement is not None:
            placement.maybe_tick(self.engine)

    def run(self, queue: RequestQueue,
            max_context: Optional[int] = None) -> dict:
        if self.prefill_chunk > 1:
            return self._run_chunked(queue, max_context)
        eng = self.engine
        b = self.slots
        ctx = max_context or queue.max_context()
        caches = eng.init_caches(b, ctx)
        slot: List[Optional[ServeRequest]] = [None] * b
        pos = np.zeros(b, np.int32)
        tok = np.zeros(b, np.int64)
        self._slot, self._pos, self._tok = slot, pos, tok
        t_start = eng.scheduler.now
        # seed the step-time estimate from the hardware model (refined online)
        self._est_step_s = eng.hw.decode_compute_time(eng._active_params, b)

        while self.steps < self.max_steps:
            caches, active = self._admit(queue, slot, pos, tok, caches)
            if not active.any():
                nxt = queue.next_arrival()
                if nxt is None:
                    break                       # drained: all work done
                eng.advance_clock(max(eng.scheduler.now, nxt))
                continue

            # ---- one fused step: prefill + decode rows together -------
            t0 = eng.scheduler.now
            logits, caches = eng.step(eng._tokens(tok), caches, pos.copy(),
                                      active=active)
            t1 = self._tick(t0, int(active.sum()))

            sampled = eng.sample_tokens(logits, self.greedy, self.temperature)
            for i in range(b):
                r = slot[i]
                if r is None:
                    continue
                pos[i] += 1
                if r.cursor < len(r.prompt):    # still prefilling this row
                    tok[i] = int(r.prompt[r.cursor])
                    r.cursor += 1
                    continue
                if pos[i] == len(r.prompt):     # prefill just completed
                    self._maybe_insert_prefix(i, r)
                self._emit(slot, i, int(sampled[i]), t1, tok)
            self._feedback(queue)

        return self.summary(queue, t_start)

    def _run_chunked(self, queue: RequestQueue,
                     max_context: Optional[int] = None) -> dict:
        """Chunked-prefill serving loop. Per-row state is just ``pos`` (next
        position to feed): pos < len(prompt) means the row is prefilling and
        the step feeds prompt[pos : pos+C]; otherwise it feeds the last
        sampled token. A fused step only launches while some row prefills —
        pure-decode steps use the cheaper single-token graph."""
        eng = self.engine
        b = self.slots
        ctx = max_context or queue.max_context()
        caches = eng.init_caches(b, ctx)
        slot: List[Optional[ServeRequest]] = [None] * b
        pos = np.zeros(b, np.int32)
        tok = np.zeros(b, np.int64)
        self._slot, self._pos, self._tok = slot, pos, tok
        t_start = eng.scheduler.now
        self._est_step_s = eng.hw.decode_compute_time(eng._active_params, b)

        while self.steps < self.max_steps:
            caches, active = self._admit(queue, slot, pos, tok, caches)
            if not active.any():
                nxt = queue.next_arrival()
                if nxt is None:
                    break                       # drained: all work done
                eng.advance_clock(max(eng.scheduler.now, nxt))
                continue

            # ---- one fused step: prefill chunks + decode rows ---------
            t0 = eng.scheduler.now
            n_feed = np.zeros(b, np.int32)
            prefilling = any(slot[i] is not None
                             and pos[i] < len(slot[i].prompt)
                             for i in range(b))
            if prefilling:
                chunk = self._effective_chunk(slot, pos)
                tokens = np.zeros((b, chunk), np.int64)
                valid = np.zeros((b, chunk), bool)
                for i in range(b):
                    r = slot[i]
                    if r is None:
                        continue
                    if pos[i] < len(r.prompt):
                        n = min(chunk, len(r.prompt) - pos[i])
                        tokens[i, :n] = r.prompt[pos[i]:pos[i] + n]
                    else:
                        n = 1
                        tokens[i, 0] = tok[i]
                    valid[i, :n] = True
                    n_feed[i] = n
                logits, caches = eng.prefill_rows(
                    tokens, active, caches, base_pos=pos.copy(),
                    tok_valid=valid)
                last = torch.from_numpy((n_feed - 1).clip(0).astype(np.int64))
                step_logits = logits[torch.arange(b, device=logits.device),
                                     last.to(logits.device)]
            else:
                n_feed[active] = 1
                step_logits, caches = eng.step(
                    eng._tokens(tok), caches, pos.copy(), active=active)
            t1 = self._tick(t0, int(active.sum()))

            sampled = eng.sample_tokens(step_logits, self.greedy,
                                        self.temperature)
            for i in range(b):
                r = slot[i]
                if r is None:
                    continue
                pos[i] += n_feed[i]
                if pos[i] < len(r.prompt):      # still prefilling this row
                    continue
                if pos[i] == len(r.prompt):     # prefill just completed
                    self._maybe_insert_prefix(i, r)
                self._emit(slot, i, int(sampled[i]), t1, tok)
            self._feedback(queue)

        return self.summary(queue, t_start)

    def summary(self, queue: RequestQueue, t_start: float = 0.0) -> dict:
        elapsed = self.engine.scheduler.now - t_start
        tele = getattr(self.engine, "telemetry", None)
        if tele is not None and tele.trace is not None:
            emit_request_spans(tele.trace, self.completed,
                               self._trace_emitted)
            emit_request_spans(tele.trace, queue.rejected,
                               self._trace_emitted)
        extra = {
            "steps": self.steps,
            "slots": self.slots,
            "mean_occupancy": float(np.mean(self.occupancy))
            if self.occupancy else 0.0,
            "queue_peak_depth": queue.peak_depth,
        }
        if self.controller is not None:
            extra["budget"] = dataclasses.asdict(self.controller.budget)
            extra["budget_trace"] = list(self.controller.trace)
        return _summarize("continuous", self.completed, queue.rejected,
                          elapsed, self.engine, extra, total=queue.total)


# ===========================================================================
# Static-batching baseline on the same clock
# ===========================================================================
class StaticServer:
    """The llama.cpp-style harness: batches form in arrival order (a batch
    waits for its LAST member to arrive), prompts are left-padded to a common
    length, all rows decode in lockstep for the batch-max token budget, and
    the next batch cannot start until every straggler finishes."""

    def __init__(self, engine, batch_size: int, *, greedy: bool = True,
                 temperature: float = 1.0):
        self.engine = engine
        self.batch_size = batch_size
        self.greedy = greedy
        self.temperature = temperature
        self.completed: List[ServeRequest] = []

    def run(self, requests: Sequence[ServeRequest]) -> dict:
        from repro_torch.serving.requests import Request, StaticBatcher
        eng = self.engine
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        by_rid = {r.rid: r for r in reqs}
        # StaticBatcher owns the llama.cpp-harness padding semantics
        # (rid=-1 pad copies, left-pad to common length, row mask)
        shadow = [Request(rid=r.rid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens) for r in reqs]
        t_start = eng.scheduler.now
        for bchunk, mat, mask in StaticBatcher(self.batch_size).batches(
                shadow):
            chunk = [by_rid[q.rid] for q in bchunk if q.rid >= 0]
            # batch-formation barrier: wait for the last member
            form_t = max(r.arrival_s for r in chunk)
            eng.advance_clock(max(eng.scheduler.now, form_t))

            plen = mat.shape[1]
            max_new = max(q.max_new_tokens for q in bchunk)
            total = plen + max_new
            caches = eng.init_caches(self.batch_size, total)

            tok = eng._tokens(mat[:, 0])
            live = mask.copy()      # rows whose budget is not yet exhausted
            for p in range(total - 1):
                logits, caches = eng.step(tok, caches, p, active=live)
                t1 = eng.scheduler.now
                if p + 1 < plen:
                    tok = eng._tokens(mat[:, p + 1])
                    continue
                nxt = eng.sample_tokens(logits, self.greedy, self.temperature)
                for i, r in enumerate(chunk):
                    if len(r.tokens) >= r.max_new_tokens:
                        continue                     # straggler row idles
                    r.tokens.append(int(nxt[i]))
                    r.token_times.append(t1)
                    if r.first_token_s < 0:
                        r.first_token_s = t1
                        r.admitted_s = form_t
                    if len(r.tokens) >= r.max_new_tokens:
                        live[i] = False      # done: stop counting its tokens
                if not live.any():           # every real row has finished
                    break
                tok = eng._tokens(nxt)
            for r in chunk:
                r.state = FINISHED
                r.finished_s = r.token_times[-1] if r.token_times \
                    else eng.scheduler.now
                self.completed.append(r)
        elapsed = eng.scheduler.now - t_start
        return _summarize("static", self.completed, [], elapsed, eng,
                          {"batch_size": self.batch_size})
