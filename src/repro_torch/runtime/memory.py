"""Two-tier memory model + transfer ledger.

The paper's regime: experts offloaded to host memory, fetched over PCIe
(~10 ms / expert on Mixtral-8x7B; transfers are 85-94% of latency on edge
deployments, §2.4). Transfer latency and device compute are MODELED
(constants below: modeled constants of the simulation, identical to the
reference's; not measured on this card); bytes and event counts are exact. Accuracy effects of substitution are real.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Modeled constants of the simulation, identical to the reference's;
    not measured on this card (roofline + transfer model)."""
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s
    ici_bw: float = 50e9                # bytes/s per device<->device link
    ici_fixed_s: float = 25e-6          # per-hop launch cost on the ICI mesh
    pcie_bw: float = 24e9               # bytes/s host<->device (16-32 GB/s, §2.4)
    pcie_fixed_s: float = 0.5e-3        # per-transfer fixed cost (launch+pin)

    def transfer_time(self, nbytes: int) -> float:
        return self.pcie_fixed_s + nbytes / self.pcie_bw

    def ici_transfer_time(self, nbytes: int, hops: int = 1) -> float:
        """One expert over the device mesh: per-hop launch cost, then the
        payload streams at link bandwidth (wormhole routing — bytes pay the
        link once, not per hop)."""
        return self.ici_fixed_s * max(1, hops) + nbytes / self.ici_bw

    def decode_compute_time(self, active_params: int, batch: int,
                            dtype_bytes: int = 2) -> float:
        """Per-decode-step compute estimate: weight-streaming bound
        (memory term dominates at decode) vs FLOPs term."""
        flops = 2.0 * active_params * batch
        mem = active_params * dtype_bytes
        return max(flops / self.peak_flops, mem / self.hbm_bw)


DEFAULT_HW = HardwareModel()


class TransferLedger:
    """Counts host<->device traffic by cause; the measurement substrate for
    Fig. 8 (PCIe bytes) and the Tables 2-4 throughput model.

    Two recording paths coexist:
      * the legacy direct calls (``prefetch``/``sync_fetch``) used by unit
        tests and simple scripts, and
      * the event path — attach the ledger to a
        ``runtime.transfers.TransferScheduler`` and every submit/cancel
        updates byte counts, while the engine attributes stalls via
        ``stall()``/``overlapped()`` with a cause breakdown:
          demand_stall_s        cold miss, nothing in flight (full fetch wait)
          late_prefetch_stall_s predicted but not yet ARRIVED — the paper's
                                late-prefetch case; stall is only the tail
          peer_stall_s          miss served by borrowing the expert from a
                                peer device's HBM over ICI (multi-device
                                meshes only; absent from the breakdown when
                                zero so single-device summaries are
                                unchanged)
          overlapped_s          transfer time hidden under earlier layers'
                                compute (costs bytes, not latency)

    The ledger is link-agnostic: attach it to every per-link scheduler of a
    device mesh and the cause keys (``peer_borrow`` for ICI borrows) keep
    host-PCIe and peer traffic separable in one byte count.
    """

    def __init__(self, hw: HardwareModel = DEFAULT_HW):
        self.hw = hw
        self.reset()

    def reset(self) -> None:
        self.bytes_by_cause = defaultdict(int)
        self.events_by_cause = defaultdict(int)
        self.sync_stall_s = 0.0
        self.overlap_s = 0.0
        self.demand_stall_s = 0.0
        self.late_prefetch_stall_s = 0.0
        self.peer_stall_s = 0.0
        self.overlapped_s = 0.0

    # -- scheduler event path -------------------------------------------
    _CAUSE_KEY = {"prefetch": "prefetch", "demand": "sync_fetch",
                  "upgrade": "upgrade", "peer": "peer_borrow",
                  "replicate": "replicate"}

    def attach(self, scheduler) -> None:
        scheduler.add_listener(self.on_transfer_event)

    def on_transfer_event(self, kind: str, t) -> None:
        key = self._CAUSE_KEY.get(t.cause, t.cause)
        if kind == "submit":
            self.bytes_by_cause[key] += t.nbytes
            self.events_by_cause[key] += 1
        elif kind == "cancel":
            self.events_by_cause["cancelled"] += 1
            if not t.started:
                # never touched the link: refund the bytes
                self.bytes_by_cause[key] -= t.nbytes
                self.events_by_cause[key] -= 1
        elif kind == "escalate":
            self.events_by_cause["escalated"] += 1

    def stall(self, kind: str, seconds: float) -> None:
        """Engine-attributed pipeline stall.
        kind: 'demand'|'late_prefetch'|'peer'."""
        assert kind in ("demand", "late_prefetch", "peer")
        seconds = max(0.0, seconds)
        if kind == "demand":
            self.demand_stall_s += seconds
        elif kind == "peer":
            self.peer_stall_s += seconds
        else:
            self.late_prefetch_stall_s += seconds
        self.sync_stall_s += seconds     # aggregate view stays coherent

    def overlapped(self, seconds: float) -> None:
        """Transfer service time hidden under compute (no latency cost)."""
        self.overlapped_s += max(0.0, seconds)
        self.overlap_s += max(0.0, seconds)

    # -- recording ------------------------------------------------------
    def prefetch(self, nbytes: int, n_events: int = 1) -> None:
        """Asynchronous, overlappable transfer (issued ahead of use)."""
        self.bytes_by_cause["prefetch"] += nbytes
        self.events_by_cause["prefetch"] += n_events
        self.overlap_s += n_events * self.hw.pcie_fixed_s + nbytes / self.hw.pcie_bw

    def sync_fetch(self, nbytes: int, n_events: int = 1) -> None:
        """Synchronous on-demand fetch — stalls the pipeline (prefetch miss
        with no buddy, or the Original baseline)."""
        self.bytes_by_cause["sync_fetch"] += nbytes
        self.events_by_cause["sync_fetch"] += n_events
        self.sync_stall_s += n_events * self.hw.pcie_fixed_s + nbytes / self.hw.pcie_bw

    def buddy_hit(self, n_events: int = 1) -> None:
        """Substitution — zero transfer (the whole point)."""
        self.events_by_cause["buddy_sub"] += n_events

    def drop(self, n_events: int = 1) -> None:
        self.events_by_cause["drop"] += n_events

    def degraded(self, n_events: int = 1) -> None:
        """Miss served from the resident quant-replica tier — zero transfer,
        zero stall, bounded fidelity loss (runtime/tiers.py)."""
        self.events_by_cause["degraded"] += n_events

    def tier_upload(self, nbytes: int) -> None:
        """One-time host->device upload of the compressed replica tier (paid
        at engine init / runtime reset, amortized over the whole run)."""
        self.bytes_by_cause["tier_upload"] += int(nbytes)
        self.events_by_cause["tier_upload"] += 1

    # -- reporting ------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_cause.values())

    def summary(self) -> dict:
        breakdown = {
            "demand_stall_s": self.demand_stall_s,
            "late_prefetch_stall_s": self.late_prefetch_stall_s,
            "overlapped_s": self.overlapped_s,
        }
        if self.peer_stall_s:       # multi-device only: D=1 dict unchanged
            breakdown["peer_stall_s"] = self.peer_stall_s
        return {
            "bytes": dict(self.bytes_by_cause),
            "events": dict(self.events_by_cause),
            "total_bytes": self.total_bytes,
            "sync_stall_s": self.sync_stall_s,
            "overlap_s": self.overlap_s,
            "stall_breakdown": breakdown,
        }


def expert_nbytes(d_model: int, d_ff: int, dtype_bytes: int = 2) -> int:
    """SwiGLU expert: w1 + w3 + w2."""
    return 3 * d_model * d_ff * dtype_bytes


def quant_expert_nbytes(d_model: int, d_ff: int, bits: int,
                        scale_bytes: int = 4) -> int:
    """HBM footprint of one compressed expert replica (runtime/tiers.py):
    the int8/int4 payload of w1+w3+w2 plus f32 per-output-channel scales
    (F each for w1/w3, D for w2). int4 is accounted at its true 4-bit
    payload even though core/quantize.py stores values unpacked."""
    assert bits in (4, 8)
    weights = 3 * d_model * d_ff * bits // 8
    scales = (2 * d_ff + d_model) * scale_bytes
    return weights + scales
