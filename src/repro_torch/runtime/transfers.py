"""Event-driven transfer scheduler — one instance per link.

The paper's regime is transfer-bound: one expert over PCIe is ~10 ms while a
decode layer is ~100 us, so WHEN a transfer lands — not just how many bytes
moved — decides whether a prefetched expert is usable or is a miss that buddy
substitution must absorb. This module models that timeline explicitly:

  * a simulated clock shared with the serving engine (``now``),
  * one link per scheduler whose bandwidth is FAIR-SHARED among the
    transfers it is currently serving — by default the host→device PCIe
    link, but ``bw``/``fixed_s``/``name`` parameterize any link: an
    expert-parallel mesh instantiates one scheduler per device↔device ICI
    link (``make_ici_links``) next to the host link, all on one clock,
  * two priority classes — DEMAND fetches preempt PREFETCHES entirely (a
    stalled layer must not queue behind speculative traffic),
  * per-transfer fixed launch cost (host pinning + descriptor setup) paid
    before that transfer's bytes stream (launch costs of concurrent
    transfers overlap; bandwidth is what they contend for),
  * cancellation of stale prefetches (predictions superseded before service),
  * escalation: an in-flight prefetch that a layer suddenly needs is promoted
    to demand priority and the caller stalls only for its *remaining* time —
    the "late prefetch" case, which is accounted separately from a cold
    demand fetch.

Listeners (the ledger, the cache) receive ``(kind, transfer)`` events with
kind in {"submit", "start", "complete", "cancel", "escalate"} so byte
accounting and residency commits are driven by the same timeline the latency
model uses.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.runtime.memory import DEFAULT_HW, HardwareModel

# Transfer states
QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
CANCELLED = "cancelled"

# Priority classes (lower value serves first)
PRIO_DEMAND = 0
PRIO_PREFETCH = 10

# float-residue tolerances: a transfer with less than half a byte (or a
# femtosecond of launch cost) left is complete — without these, event steps
# can underflow (now + dt == now) and the loop stops making progress
_EPS_B = 0.5
_EPS_S = 1e-12


@dataclasses.dataclass
class Transfer:
    tid: int
    layer: int
    expert: int
    nbytes: int
    cause: str          # "prefetch"|"demand"|"upgrade"|"peer"|"replicate"
    priority: int
    issue_s: float                  # submission time
    remaining_fixed_s: float        # launch cost left (serial, per transfer)
    remaining_bytes: float          # payload left to stream
    start_s: float = -1.0           # first time the link served it
    done_s: float = -1.0
    state: str = QUEUED
    event_seq: int = 0              # last event's scheduler sequence number

    @property
    def started(self) -> bool:
        return self.start_s >= 0.0

    @property
    def in_flight(self) -> bool:
        return self.state in (QUEUED, ACTIVE)


class TransferScheduler:
    """Single-link timeline with priorities and fair bandwidth sharing.

    ``advance(t)`` plays the link forward to simulated time ``t``; transfers
    that complete in that window fire "complete" events at their exact finish
    times. ``run_until_done(tr)`` is the stall primitive: it advances time
    until ``tr`` lands and returns the completion timestamp.

    The default link is the host→device PCIe lane (``hw.pcie_bw`` /
    ``hw.pcie_fixed_s``). Pass ``bw``/``fixed_s`` to model any other link —
    a device↔device ICI hop for peer-HBM borrows — and ``name`` to label its
    trace lane (``transfers:<name>``) and per-link accounting; ``name=None``
    keeps the pre-mesh single-link trace output byte-identical.
    """

    def __init__(self, hw: HardwareModel = DEFAULT_HW,
                 max_inflight_prefetch: int = 4, *,
                 bw: Optional[float] = None,
                 fixed_s: Optional[float] = None,
                 name: Optional[str] = None):
        self.hw = hw
        self.bw = hw.pcie_bw if bw is None else float(bw)
        self.fixed_s = hw.pcie_fixed_s if fixed_s is None else float(fixed_s)
        self.name = name
        self.now = 0.0
        self.busy_s = 0.0           # cumulative time the link was serving
        self.max_inflight_prefetch = max_inflight_prefetch
        self._queued: List[Tuple[int, int, Transfer]] = []   # heap
        self._active: List[Transfer] = []
        self._by_key: Dict[Tuple[int, int], Transfer] = {}
        self._listeners: List[Callable[[str, Transfer], None]] = []
        self._next_tid = 0
        self._event_seq = 0
        self.bytes_by_cause: Dict[str, int] = {}    # per-link utilization
        self.trace = None           # optional FlightRecorder (runtime/trace)

    # -- wiring ---------------------------------------------------------
    def add_listener(self, fn: Callable[[str, Transfer], None]) -> None:
        self._listeners.append(fn)

    def _emit(self, kind: str, t: Transfer) -> None:
        # monotonic per-scheduler sequence id: simultaneous events (common on
        # a discrete-event clock) get a total order, so listeners and trace
        # exports are byte-stable across runs at a fixed seed
        self._event_seq += 1
        t.event_seq = self._event_seq
        for fn in self._listeners:
            fn(kind, t)
        if self.trace is not None:
            self.trace.transfer_event(kind, t, self.now, link=self.name)

    # -- submission / lookup -------------------------------------------
    def in_flight(self, layer: int, expert: int) -> Optional[Transfer]:
        t = self._by_key.get((layer, expert))
        return t if t is not None and t.in_flight else None

    def submit(self, layer: int, expert: int, nbytes: int, cause: str,
               priority: Optional[int] = None) -> Transfer:
        """Queue a transfer at the current clock. Duplicate (layer, expert)
        submissions return the in-flight transfer (escalated if the new
        request is more urgent). ``cause`` 'upgrade' is the degraded-then-
        upgrade background fetch (runtime/costs.py): speculative priority —
        it shares the prefetch class and cap — but exempt from stale-
        prediction cancellation, and its bytes are ledgered separately.
        ``cause`` 'peer' is a peer-HBM borrow over an ICI link: a stalled
        slot is waiting on it, so it rides at demand priority. ``cause``
        'replicate' is the placement controller's background copy of a
        persistently-hot expert (runtime/placement.py): prefetch priority
        like 'upgrade', exempt from stale-prediction cancellation, bytes
        ledgered under its own key."""
        assert cause in ("prefetch", "demand", "upgrade", "peer",
                         "replicate")
        existing = self.in_flight(layer, expert)
        if existing is not None:
            if cause in ("demand", "peer") and \
                    existing.priority > PRIO_DEMAND:
                self.escalate(existing)
            return existing
        prio = priority if priority is not None else (
            PRIO_DEMAND if cause in ("demand", "peer") else PRIO_PREFETCH)
        t = Transfer(tid=self._next_tid, layer=layer, expert=expert,
                     nbytes=int(nbytes), cause=cause, priority=prio,
                     issue_s=self.now,
                     remaining_fixed_s=self.fixed_s,
                     remaining_bytes=float(nbytes))
        self._next_tid += 1
        self.bytes_by_cause[cause] = \
            self.bytes_by_cause.get(cause, 0) + int(nbytes)
        self._by_key[(layer, expert)] = t
        heapq.heappush(self._queued, (t.priority, t.tid, t))
        self._emit("submit", t)
        return t

    def escalate(self, t: Transfer) -> None:
        """Promote a prefetch to demand priority (a layer needs it NOW)."""
        if not t.in_flight or t.priority <= PRIO_DEMAND:
            return
        t.priority = PRIO_DEMAND
        if t.state == QUEUED:
            # re-push; stale heap entries are skipped on pop by state check
            heapq.heappush(self._queued, (t.priority, t.tid, t))
        self._emit("escalate", t)

    def cancel(self, t: Transfer) -> bool:
        """Drop a queued/active transfer. Returns True if it was in flight."""
        if not t.in_flight:
            return False
        t.state = CANCELLED
        if t in self._active:
            self._active.remove(t)
        self._by_key.pop((t.layer, t.expert), None)
        self._emit("cancel", t)
        return True

    def cancel_stale_prefetches(self, layer: int, keep) -> int:
        """Cancel in-flight prefetches for ``layer`` not in ``keep``."""
        keep = set(int(e) for e in keep)
        n = 0
        for (l, e), t in list(self._by_key.items()):
            if (l == layer and t.cause == "prefetch" and t.in_flight
                    and e not in keep):
                n += int(self.cancel(t))
        return n

    def set_prefetch_cap(self, n: int) -> None:
        """Resize the concurrent-prefetch cap (the serving layer's adaptive
        budget controller shrinks this when late-prefetch stalls dominate).
        Already-admitted prefetches keep streaming; the new cap gates
        admission from the queue."""
        self.max_inflight_prefetch = max(1, int(n))

    # -- timeline -------------------------------------------------------
    def _admit(self) -> None:
        """Move queued transfers onto the link: every demand immediately;
        prefetches up to the concurrency cap."""
        requeue = []
        n_prefetch = sum(1 for t in self._active if t.priority > PRIO_DEMAND)
        while self._queued:
            prio, _, t = heapq.heappop(self._queued)
            if t.state != QUEUED or prio != t.priority:
                continue    # cancelled, already admitted, or stale heap entry
            if t.priority > PRIO_DEMAND and \
                    n_prefetch >= self.max_inflight_prefetch:
                requeue.append(t)
                continue
            t.state = ACTIVE
            self._active.append(t)
            if t.priority > PRIO_DEMAND:
                n_prefetch += 1
        for t in requeue:
            heapq.heappush(self._queued, (t.priority, t.tid, t))

    def _serving(self) -> List[Transfer]:
        """Demand transfers monopolise the link; prefetches only progress
        when no demand is in flight."""
        if not self._active:
            return []
        best = min(t.priority for t in self._active)
        return [t for t in self._active if t.priority == best]

    def _next_event_dt(self) -> float:
        """Time until the next state change on the link (inf if idle)."""
        serving = self._serving()
        if not serving:
            return float("inf")
        streaming = [t for t in serving if t.remaining_fixed_s <= _EPS_S]
        share = self.bw / max(1, len(streaming))
        dts = []
        for t in serving:
            if t.remaining_fixed_s > _EPS_S:
                dts.append(t.remaining_fixed_s)
            else:
                dts.append(t.remaining_bytes / share)
        return max(0.0, min(dts))

    def advance(self, to_time: float) -> None:
        """Play the link forward to ``to_time`` (no-op if in the past)."""
        while True:
            self._admit()
            if to_time <= self.now:
                return
            dt = self._next_event_dt()
            step = min(dt, to_time - self.now)
            serving = self._serving()
            streaming = [t for t in serving if t.remaining_fixed_s <= _EPS_S]
            share = self.bw / max(1, len(streaming))
            if serving:
                self.busy_s += step
            for t in serving:
                # "started" = actually received link service; a paused
                # prefetch admitted behind a demand has NOT started and a
                # later cancel refunds its bytes in the ledger
                if not t.started and step > 0.0:
                    t.start_s = self.now
                    self._emit("start", t)
                if t.remaining_fixed_s > _EPS_S:
                    t.remaining_fixed_s = max(0.0, t.remaining_fixed_s - step)
                else:
                    t.remaining_bytes = max(0.0, t.remaining_bytes
                                            - share * step)
            self.now += step
            for t in list(serving):
                if t.remaining_fixed_s <= _EPS_S and t.remaining_bytes <= _EPS_B:
                    t.state = DONE
                    t.done_s = self.now
                    self._active.remove(t)
                    self._by_key.pop((t.layer, t.expert), None)
                    self._emit("complete", t)
            if dt == float("inf") and not self._queued:
                self.now = to_time
                return

    def eta_s(self, t: Transfer) -> float:
        """Optimistic remaining-service estimate for an in-flight transfer:
        the fixed-cost tail plus its bytes at FULL link bandwidth (queued
        demands ahead of it and bandwidth sharing are ignored). The tiered
        store's degrade-vs-wait decision wants a cheap lower bound — if even
        the optimistic ETA exceeds the fidelity-justified stall, computing
        from the resident replica wins for sure."""
        if t.state == DONE:
            return 0.0
        return max(0.0, t.remaining_fixed_s) \
            + t.remaining_bytes / self.bw

    def transfer_time(self, nbytes: int) -> float:
        """Cold (unqueued, unshared) service time of one transfer on THIS
        link — the per-link analogue of ``HardwareModel.transfer_time``."""
        return self.fixed_s + nbytes / self.bw

    def backlog_s(self) -> float:
        """Pessimistic wait before a NEW demand-class transfer would get
        bandwidth: total remaining service of demand-priority transfers
        already on the link (prefetches don't count — a new demand preempts
        them). Used to price peer-borrow ETAs off a busy ICI link."""
        s = 0.0
        for t in self.pending():
            if t.priority <= PRIO_DEMAND:
                s += max(0.0, t.remaining_fixed_s) \
                    + t.remaining_bytes / self.bw
        return s

    def run_until_done(self, t: Transfer) -> float:
        """Advance the clock until ``t`` completes; returns its finish time.
        This is the synchronous-stall primitive: the caller's layer is
        blocked for ``t.done_s - now``."""
        if t.state == DONE:
            return t.done_s
        assert t.in_flight, f"cannot wait on a {t.state} transfer"
        guard = 0
        while t.in_flight:
            self._admit()
            dt = self._next_event_dt()
            assert dt != float("inf"), "waiting on a transfer the link lost"
            self.advance(self.now + dt)
            guard += 1
            assert guard < 1_000_000, "scheduler failed to converge"
        return t.done_s

    def flush(self) -> float:
        """Run every in-flight transfer to completion; returns the clock."""
        while self._active or self._queued:
            self._admit()
            dt = self._next_event_dt()
            if dt == float("inf"):
                break
            self.advance(self.now + dt)
        return self.now

    # -- introspection --------------------------------------------------
    # escalate() re-pushes a QUEUED transfer at its new priority and leaves
    # the stale heap entry behind (skipped on pop by the state/priority
    # check), so heap walks must dedup by tid or escalated transfers are
    # counted twice.
    @property
    def n_in_flight(self) -> int:
        return len(self._active) + len(
            {t.tid for _, _, t in self._queued if t.state == QUEUED})

    def pending(self) -> List[Transfer]:
        out = list(self._active)
        seen = {t.tid for t in out}
        for _, _, t in sorted(self._queued):
            if t.state == QUEUED and t.tid not in seen:
                seen.add(t.tid)
                out.append(t)
        return out

    def utilization(self) -> dict:
        """Per-link digest: cumulative busy time, queue depth right now, and
        the bytes submitted per cause (demand / prefetch / upgrade / peer /
        replicate)."""
        return {
            "name": self.name or "pcie",
            "busy_s": self.busy_s,
            "queue_depth": self.n_in_flight,
            "bytes_by_cause": dict(sorted(self.bytes_by_cause.items())),
            "total_bytes": sum(self.bytes_by_cause.values()),
        }


def device_hops(d: int, n_devices: int) -> int:
    """Manhattan distance from device 0 to device ``d`` on the smallest
    square grid holding ``n_devices`` chips — the same shape
    ``launch/mesh.py`` builds and ``ExpertCache.hop_vector`` models."""
    side = max(1, int(math.ceil(math.sqrt(n_devices))))
    return abs(d % side - 0) + abs(d // side - 0)


def make_ici_links(n_devices: int, hw: HardwareModel = DEFAULT_HW, *,
                   ici_bw: Optional[float] = None
                   ) -> Dict[int, "TransferScheduler"]:
    """One ICI scheduler per peer device (1..D-1), each pricing the
    Manhattan hop count from device 0 into its fixed launch cost. Returns
    ``{device: scheduler}``; the caller advances them alongside the host
    PCIe link so every link shares one simulated clock."""
    bw = hw.ici_bw if ici_bw is None else float(ici_bw)
    return {
        d: TransferScheduler(
            hw, bw=bw,
            fixed_s=hw.ici_fixed_s * device_hops(d, n_devices),
            name=f"ici{d}")
        for d in range(1, n_devices)
    }
