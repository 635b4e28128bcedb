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
"""
from __future__ import annotations

import json
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
