"""Flight recorder — structured trace spans/events on the simulated clock.

The runtime's whole premise is temporal: a prefetch that lands 50 us after
the layer needed it is a miss, one that lands 50 us before is free. End-of-
run ``summary()`` dicts cannot show WHEN a stall happened or WHICH transfer
caused it. This module records the timeline itself:

  track "requests"   per-request lifecycle — arrive (instant), queued span
                     (arrival -> admit), prefill span (admit -> first token),
                     decode span (first token -> retire), per-token instants,
                     retire/shed instants. Lane = request id.
  track "layers"     the per-layer step timeline ServeEngine._account
                     replays — compute slices, stall spans (with cause and
                     the transfer that caused them), and one instant per
                     layer-step carrying the miss-outcome breakdown
                     {hit, buddy, degraded, fetch, drop}. Lane = MoE layer.
  track "transfers"  per-transfer spans (submit -> land/cancel) with cause,
                     bytes, and priority, plus start/escalate instants —
                     emitted by TransferScheduler. Lane = transfer id.
                     Named links (the ICI links of a multi-device mesh) get
                     their own lanes: track "transfers:<link>" per link, so
                     host-PCIe and each peer's borrow traffic render as
                     separate rows. The unnamed host link keeps the bare
                     "transfers" track — single-device traces are unchanged.
  track "engine"     whole-step spans and controller/budget events.

Every record carries a monotonic sequence id assigned at record time, so
simultaneous events (common on a discrete-event clock) have a total order
and exports are byte-stable across runs at a fixed seed.

Exports:
  * JSONL — one record per line, lossless round-trip (``load_jsonl``);
  * Chrome/Perfetto ``trace_event`` JSON — open in https://ui.perfetto.dev
    (or chrome://tracing): a stall span on the "layers" track sits directly
    under the transfer span that caused it on the "transfers" track, making
    a stall visually attributable.

Zero-overhead-when-off contract: the recorder is opt-in. Call sites hold
``None`` instead of a recorder and guard every emission with an ``is not
None`` check, so a telemetry-off run executes the exact pre-telemetry code
path (bit-identical outputs and summaries).

Host spans (``HostRecorder``, the second half of this module) put the
same record format on the WALL clock (``time.perf_counter``): where the
serving path spends the host's time, step by step and layer by layer,
and, while a ``torch.profiler`` session records, which program span the
host was in during each idle gap of the device. They live in their own
recorder, so the simulated-clock exports above never change.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

# Canonical track names -> Chrome trace pids (stable, documented in
# docs/trace_schema.md). Unknown tracks get pids past the known ones.
TRACKS = ("requests", "layers", "transfers", "engine")

# Span/event kinds (the ``kind`` field; one vocabulary for both exports)
REQUEST_KINDS = ("arrive", "queued", "prefill", "decode", "token",
                 "retire", "shed", "prefix_hit")
LAYER_KINDS = ("compute", "stall", "outcomes")
TRANSFER_KINDS = ("transfer", "start", "escalate")
ENGINE_KINDS = ("step", "budget", "prefix_hit")


class FlightRecorder:
    """Append-only event log on the simulated clock.

    Records are plain dicts:
      seq    monotonic int — assigned at record time; the deterministic
             tie-break for simultaneous events
      track  one of TRACKS (trace process / Perfetto track group)
      lane   int lane within the track (request id / layer / transfer id)
      kind   event kind (vocabulary above)
      name   display name
      ts     simulated-clock seconds (span start for spans)
      dur    span duration in seconds; absent (None) for instants
      args   labels dict (JSON-safe scalars)
    """

    def __init__(self) -> None:
        self.events: List[dict] = []
        self._seq = 0
        # open transfer spans keyed by (link, transfer id) — tids restart
        # per scheduler, so the link name disambiguates mesh traffic
        self._open_transfers: Dict[tuple, dict] = {}

    def __len__(self) -> int:
        return len(self.events)

    # -- primitives -----------------------------------------------------
    def _record(self, track: str, lane: int, kind: str, name: str,
                ts: float, dur: Optional[float], args: dict) -> dict:
        self._seq += 1
        ev = {"seq": self._seq, "track": track, "lane": int(lane),
              "kind": kind, "name": name, "ts": float(ts)}
        if dur is not None:
            ev["dur"] = float(max(0.0, dur))
        if args:
            ev["args"] = args
        self.events.append(ev)
        return ev

    def instant(self, track: str, lane: int, kind: str, name: str,
                ts: float, **args) -> dict:
        return self._record(track, lane, kind, name, ts, None, args)

    def span(self, track: str, lane: int, kind: str, name: str,
             t0: float, t1: float, **args) -> dict:
        return self._record(track, lane, kind, name, t0, t1 - t0, args)

    # -- transfer listener (driven by TransferScheduler._emit) ----------
    def transfer_event(self, kind: str, t, now: float,
                       link: Optional[str] = None) -> None:
        """Map scheduler events onto per-transfer spans + instants. The
        scheduler stamps ``t.event_seq`` before calling (satellite:
        deterministic ordering), recorded as a label for cross-checking.
        ``link`` names the emitting scheduler's lane: ``None`` (the host
        PCIe link) records on the bare "transfers" track exactly as the
        single-link recorder always did; a named ICI link records on its
        own "transfers:<link>" track."""
        track = "transfers" if link is None else f"transfers:{link}"
        base = {"cause": t.cause, "bytes": int(t.nbytes), "layer": t.layer,
                "expert": t.expert, "event_seq": getattr(t, "event_seq", 0)}
        if kind == "submit":
            self._open_transfers[(link, t.tid)] = dict(base,
                                                       issue_s=t.issue_s)
            self.instant(track, t.tid, "start", "submit", now, **base)
        elif kind == "start":
            self.instant(track, t.tid, "start", "link_start", now, **base)
        elif kind == "escalate":
            self.instant(track, t.tid, "escalate", "escalate", now, **base)
        elif kind in ("complete", "cancel"):
            opened = self._open_transfers.pop((link, t.tid), None)
            t0 = opened["issue_s"] if opened else t.issue_s
            self.span(track, t.tid, "transfer",
                      f"{t.cause}:{t.layer}.{t.expert}", t0, now,
                      outcome=("land" if kind == "complete" else "cancel"),
                      **base)

    # -- exports --------------------------------------------------------
    def sorted_events(self) -> List[dict]:
        """Events in (ts, seq) order — seq breaks simultaneous-event ties,
        so the export byte-stream is stable across runs at a fixed seed."""
        return sorted(self.events, key=lambda e: (e["ts"], e["seq"]))

    def export_jsonl(self, path: str) -> int:
        evs = self.sorted_events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, sort_keys=True) + "\n")
        return len(evs)

    @staticmethod
    def load_jsonl(path: str) -> List[dict]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def to_perfetto(self) -> dict:
        """Chrome ``trace_event`` format dict (json.dump it; Perfetto and
        chrome://tracing both load it). ts/dur are microseconds. Spans are
        complete ("X") events; instants are "i" with thread scope."""
        pids = {name: i + 1 for i, name in enumerate(TRACKS)}
        out: List[dict] = []
        for name, pid in pids.items():
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": name}})
        for ev in self.sorted_events():
            pid = pids.setdefault(ev["track"], len(pids) + 1)
            row = {"name": ev["name"], "cat": ev["kind"], "pid": pid,
                   "tid": ev["lane"], "ts": ev["ts"] * 1e6,
                   "args": dict(ev.get("args", {}), seq=ev["seq"])}
            if "dur" in ev:
                row["ph"] = "X"
                row["dur"] = ev["dur"] * 1e6
            else:
                row["ph"] = "i"
                row["s"] = "t"
            out.append(row)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_perfetto(self, path: str) -> int:
        trace = self.to_perfetto()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


def export_trace(recorder: Optional[FlightRecorder], path: str) -> int:
    """Shared --trace-out handler: ``*.jsonl`` exports the lossless JSONL
    log, anything else the Chrome/Perfetto trace_event JSON. Returns the
    number of events written (0 when no recorder is attached)."""
    if recorder is None:
        return 0
    if path.endswith(".jsonl"):
        return recorder.export_jsonl(path)
    return recorder.export_perfetto(path)


# ===========================================================================
# Host spans: the serving path on the wall clock
# ===========================================================================
# Track of the program spans (lane = the scheduler's step index, -1 outside
# a step) and of the request records (lane = request id).
HOST_TRACK = "host"
HOST_REQUEST_TRACK = "host:requests"
HOST_KINDS = ("span", "admit", "request")
# Every program span, in the order a step opens them, then the set-up's
# (docs/trace_schema.md says where each one opens and closes).
SPAN_NAMES = ("serve.step", "sched.admit", "sched.feed", "engine.issue",
              "engine.kv_map", "engine.kv_cow_copy", "engine.state",
              "model.embed", "model.plan", "model.layer", "model.attn",
              "model.paged_gather", "model.route", "model.dispatch",
              "model.ffn", "model.head", "engine.wait", "engine.replay",
              "sched.select", "engine.sample", "sched.emit",
              "sched.feedback",
              "setup.profile_buddies", "setup.profile_forward")

HOST: Optional["HostRecorder"] = None   # the active recorder; None = off


class _Off:
    """What every span call site enters while no recorder is active: a
    shared object that does nothing, entered as None."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, layer: Optional[int] = None,
         step: Optional[int] = None):
    """``with span(name):`` records the block as a program span of the
    active ``HostRecorder`` (entered as its ``HostSpan``), or does nothing
    (entered as None) while there is none: one ``is None`` test, and
    nothing allocated. ``layer`` (default: the enclosing span's) and
    ``step`` (``serve.step`` only: the scheduler's step index, the lane of
    every span it encloses) label the record."""
    h = HOST
    if h is None:
        return _OFF
    return HostSpan(h, name, layer, step)


def admitted(r) -> None:
    """Wall time of request ``r``'s admission (``r.wall_admitted_s``)."""
    h = HOST
    if h is not None:
        h.admit(r)


def emitted(r) -> None:
    """Wall time of a token just appended to ``r.tokens``."""
    h = HOST
    if h is not None:
        h.token(r)


def start_host() -> "HostRecorder":
    """Turn host spans on: a fresh recorder becomes the active one. While
    a ``torch.profiler`` session records, every span also opens a
    ``record_function``, so that the session holds the spans beside the
    kernels (outside one, a range would cost tens of microseconds and show
    nothing)."""
    global HOST
    if HOST is not None:
        raise RuntimeError("a host recorder is already active")
    HOST = HostRecorder()
    return HOST


def stop_host() -> Optional["HostRecorder"]:
    """Turn host spans off; returns the recorder that was active."""
    global HOST
    h, HOST = HOST, None
    return h


class HostSpan:
    """One open program span: a record of the ``host`` track whose ``ts``
    is its wall start and ``dur`` its length, ``args`` its parent's
    ``seq`` (the enclosing open span), its layer, and its counters."""
    __slots__ = ("h", "name", "layer", "step", "rec", "index", "rf",
                 "prev_step", "owns_tokens", "dropped")

    def __init__(self, h: "HostRecorder", name: str, layer, step):
        self.h, self.name, self.layer, self.step = h, name, layer, step
        self.rf = None
        self.owns_tokens = self.dropped = False

    def __enter__(self) -> "HostSpan":
        h = self.h
        parent = h.open_spans[-1] if h.open_spans else None
        args = {}
        if parent is not None:
            args["parent"] = parent.rec["seq"]
            if self.layer is None:
                self.layer = parent.layer
        if self.layer is not None:
            args["layer"] = int(self.layer)
        self.prev_step = h.step
        if self.step is not None:
            h.step = int(self.step)
        if h.profiling():
            label = (self.name if self.layer is None
                     else f"{self.name}[{self.layer}]")
            self.rf = h.record_function(label)
            self.rf.__enter__()
        self.index = len(h.events)
        self.rec = h._record(HOST_TRACK, -1 if h.step is None else h.step,
                             "span", self.name, time.perf_counter(), 0.0,
                             args)
        self.rec["args"] = args
        h.open_spans.append(self)
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        h = self.h
        self.rec["dur"] = max(0.0, t - self.rec["ts"])
        if not self.rec["args"]:
            del self.rec["args"]
        if self.rf is not None:
            self.rf.__exit__(*exc)
        h.open_spans.pop()
        h.step = self.prev_step
        if self.owns_tokens:
            h.tokens = None
        if self.dropped:
            del h.events[self.index:]
        return False

    def note(self, key: str, value) -> None:
        """A counter of this span (a JSON scalar) into its ``args``."""
        self.rec["args"][key] = value

    def feed(self, tokens: int) -> None:
        """The step's active tokens (its counter ``tokens``): the
        dispatches inside count their routed rows from it."""
        self.note("tokens", int(tokens))
        self.h.tokens = int(tokens)
        self.owns_tokens = True

    def dispatch(self, kernel: str, rows: int, t_n: int, k_n: int) -> None:
        """The expert dispatch's counters: the kernel launched, the rows
        it is given, and the routed rows of active tokens (the step's
        ``tokens`` x K; all ``t_n`` tokens outside an engine step)."""
        active = self.h.tokens if self.h.tokens is not None else t_n
        self.note("kernel", kernel)
        self.note("rows", int(rows))
        self.note("routed", int(active) * int(k_n))

    def drop(self) -> None:
        """Take this span and every record made inside it out when it
        closes (a scheduler iteration that ran no step)."""
        self.dropped = True


class HostRecorder(FlightRecorder):
    """Program spans and request records on the wall clock, in the
    ``FlightRecorder``'s record format and exports (``ts`` / ``dur`` in
    ``time.perf_counter`` seconds). Kept in memory; ``export_jsonl`` /
    ``export_perfetto`` write them at the end, ``table`` sums them."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import record_function
        super().__init__()
        self.open_spans: List[HostSpan] = []
        self.step: Optional[int] = None     # the open serve.step's index
        self.tokens: Optional[int] = None   # the issuing step's tokens
        self.record_function = record_function
        self.profiling = torch._C._autograd._profiler_enabled

    def admit(self, r) -> None:
        r.wall_admitted_s = time.perf_counter()
        r.wall_token_s = []
        self._record(HOST_REQUEST_TRACK, r.rid, "admit", f"req{r.rid}",
                     r.wall_admitted_s, None, self._req_args(r))

    def token(self, r) -> None:
        """The token's wall on ``r``; its last one closes the request's
        span (the walls stay on ``r``, not one record a token)."""
        t = time.perf_counter()
        if r.wall_token_s is None:          # admitted before recording
            r.wall_token_s = []
        r.wall_token_s.append(t)
        if len(r.tokens) >= r.max_new_tokens and r.wall_admitted_s >= 0:
            args = self._req_args(r)
            args["tokens"] = len(r.wall_token_s)
            args["first_token_s"] = r.wall_token_s[0] - r.wall_admitted_s
            self._record(HOST_REQUEST_TRACK, r.rid, "request",
                         f"req{r.rid}", r.wall_admitted_s,
                         t - r.wall_admitted_s, args)

    def _req_args(self, r) -> dict:
        args = {"rid": int(r.rid)}
        if self.step is not None:
            args["step"] = self.step
        return args

    def spans(self, name: Optional[str] = None) -> List[dict]:
        """The span records (of ``name``), in the order they opened."""
        return [e for e in self.events if e["kind"] == "span"
                and (name is None or e["name"] == name)]

    def table(self) -> Dict[str, dict]:
        """Per span name: count, total and mean host ms, largest total
        first."""
        tot: Dict[str, list] = {}
        for e in self.spans():
            t = tot.setdefault(e["name"], [0, 0.0])
            t[0] += 1
            t[1] += e["dur"]
        return {k: {"n": n, "total_ms": s * 1e3, "mean_ms": s * 1e3 / n}
                for k, (n, s) in sorted(tot.items(), key=lambda kv: -kv[1][1])}
