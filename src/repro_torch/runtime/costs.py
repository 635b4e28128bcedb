"""Unified expected-cost model for the five-way miss decision.

Every prefetch miss has five possible outcomes — buddy substitution
(core/substitute.py), degraded compute from the resident quant-replica tier
(runtime/tiers.py), borrowing the full-precision expert from a peer
device's HBM over ICI (multi-device meshes), a demand fetch over PCIe
(runtime/transfers.py), or dropping the slot and renormalizing. Before this
module the runtime resolved them with a FIXED precedence (buddy strictly
before degraded before fetch/drop) and a per-mechanism threshold
(``stall_per_fidelity``). Related systems (MELINOE's compressed experts,
predictive-prefetch replication, ExpertFlow's hierarchy-wide memory
coordination) show the choices only compose when they are scored on ONE
scale, so this module puts all five outcomes in stall-second units via a
single exchange rate:

  ``stall_per_quality``  seconds of pipeline stall the deployment is willing
                         to pay to avoid one unit of quality loss.

  cost(buddy)    = stall_per_quality * (1 - Psi_best)    zero stall; quality
                   loss shrinks with the buddy's co-activation score
  cost(degraded) = stall_per_quality * fidelity[l, e]    zero stall; quality
                   loss is the replica's calibrated round-trip error
  cost(peer)     = peer_eta_s[l, e]                      pure stall: the
                   owning device's ICI link queue plus the hop-priced
                   transfer — usually ~100x cheaper than PCIe, and zero
                   quality loss (it is the full-precision expert)
  cost(fetch)    = eta_s[l, e]                           pure stall: the
                   in-flight tail (TransferScheduler.eta_s) or the modeled
                   full cold transfer; zero quality loss
  cost(drop)     = stall_per_quality * drop_loss         zero stall; the slot's
                   contribution to the token's expert mixture is lost

The argmin over these replaces the precedence chain (policy.miss_policy =
'cost'): a high-q buddy beats a low-fidelity int4 replica, a nearly-landed
prefetch beats both, and a cold fetch loses to anything cheap. The same
scores drive the prefetcher: the expected stall SAVED by prefetching expert
e is P(use) x the miss cost the runtime would otherwise pay (the lateness
risk on the current timeline), which is what ``prefetch_scores`` ranks.

Host-side numpy only — the in-graph argmin lives in core/substitute.py and
consumes the per-expert cost vectors this module prepares (BuddyState
fid_cost / fetch_cost).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.runtime.memory import DEFAULT_HW, HardwareModel

# outcome codes (argmin tie-break order: quality-free fetch never beats an
# equally-priced reroute — ties go to the earlier, transfer-free outcome;
# a peer-HBM borrow beats an equally-priced host fetch, the cheaper link)
BUDDY, DEGRADED, PEER, FETCH, DROP = 0, 1, 2, 3, 4
OUTCOMES = ("buddy", "degraded", "peer", "fetch", "drop")


class MissCostModel:
    """Scores the five miss outcomes of every (layer, expert) on one
    stall-seconds scale and ranks prefetch candidates by expected stall
    saved. Stateless apart from its constants — call sites pass the current
    timeline (scheduler + per-link ICI schedulers), residency, and
    calibration each step. Single-device call sites simply never pass
    ``peer_eta`` and the model is the pre-mesh four-way scorer."""

    def __init__(self, num_layers: int, num_experts: int, *,
                 expert_bytes: int, hw: HardwareModel = DEFAULT_HW,
                 stall_per_quality: float = 0.05, drop_loss: float = 1.0):
        assert stall_per_quality > 0.0, "the exchange rate must be positive"
        assert drop_loss >= 0.0
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.expert_bytes = int(expert_bytes)
        self.hw = hw
        self.stall_per_quality = float(stall_per_quality)
        self.drop_loss = float(drop_loss)

    # -- per-outcome costs ----------------------------------------------
    def fetch_eta(self, scheduler=None) -> np.ndarray:
        """[L, E] expected stall of fetching each expert on a miss THIS
        step. A cold miss pays the full modeled transfer; an expert with a
        transfer already in flight pays only its optimistic remaining tail
        (TransferScheduler.eta_s).

        'upgrade'-cause transfers keep the COLD estimate: an upgrade is
        background quality-repair for a slot the policy already chose to
        serve degraded, so blocking a layer on its tail would invert the
        decision that spawned it — and because eta_s is an optimistic lower
        bound (link sharing ignored), waiting on self-generated upgrade
        traffic systematically overpays. The replica serves until the
        upgrade lands; only genuine prefetches discount the fetch cost.
        'replicate'-cause transfers (the placement controller's background
        hot-expert copies) are self-generated repair traffic of the same
        kind and keep the COLD estimate too."""
        eta = np.full((self.num_layers, self.num_experts),
                      self.hw.transfer_time(self.expert_bytes))
        if scheduler is not None:
            for t in scheduler.pending():
                if t.layer < self.num_layers and \
                        t.cause not in ("upgrade", "replicate"):
                    eta[t.layer, t.expert] = scheduler.eta_s(t)
        return eta

    def degraded_cost(self, fidelity: Optional[np.ndarray],
                      shape=None) -> np.ndarray:
        """Stall-equivalent of serving from the quant tier. fidelity is the
        calibrated relative round-trip error (inf = no replica / uncovered /
        uncalibrated -> never degrade); None means no tier at all."""
        if fidelity is None:
            return np.full(shape or (self.num_layers, self.num_experts),
                           np.inf)
        fidelity = np.asarray(fidelity, np.float64)
        return self.stall_per_quality * fidelity

    def buddy_cost(self, best_q: Optional[np.ndarray],
                   shape=None) -> np.ndarray:
        """Stall-equivalent of rerouting to the best currently ELIGIBLE
        buddy (best_q < 0 or NaN = no resident buddy -> inf). This is the
        host-side approximation used for prefetch ranking; the in-graph
        argmin recomputes Psi per token."""
        if best_q is None:
            return np.full(shape or (self.num_layers, self.num_experts),
                           np.inf)
        q = np.asarray(best_q, np.float64)
        cost = self.stall_per_quality * (1.0 - np.clip(q, 0.0, 1.0))
        return np.where(np.isfinite(q) & (q >= 0.0), cost, np.inf)

    def drop_cost(self) -> float:
        return self.stall_per_quality * self.drop_loss

    def peer_eta(self, links, peer_resident) -> np.ndarray:
        """[L, E] expected stall of borrowing each expert from a peer
        device's HBM over ICI — priced FROM THE OWNING LINK'S QUEUE, not a
        free-link idealization. For every peer link d:

            eta_d[e] = backlog_s(d) + fixed_s(d) + bytes / bw(d)

        where backlog is the remaining service of demand-class transfers
        already on that link (a borrow queues behind them). An expert the
        link is already carrying pays only its optimistic in-flight tail.
        Experts no peer holds are inf — the argmin falls through to
        host-PCIe fetch. ``links``: {device: TransferScheduler},
        ``peer_resident``: [D, L, E] bool (ExpertCache.peer_resident)."""
        eta = np.full((self.num_layers, self.num_experts), np.inf)
        if not links:
            return eta
        peer_resident = np.asarray(peer_resident, bool)
        for d, link in links.items():
            cold = link.backlog_s() + link.transfer_time(self.expert_bytes)
            eta = np.where(peer_resident[d], np.minimum(eta, cold), eta)
            for t in link.pending():
                if t.layer < self.num_layers:
                    eta[t.layer, t.expert] = min(eta[t.layer, t.expert],
                                                 link.eta_s(t))
        return eta

    # -- the unified score ----------------------------------------------
    def _outcome_stack(self, fetch_eta, fidelity, best_q,
                       peer_eta=None) -> np.ndarray:
        """Rows are indexed by the outcome codes: peer_eta=None (any
        single-device call site) prices the peer row at inf, so the stack
        is always 5-deep and codes never shift."""
        fetch_eta = np.asarray(fetch_eta, np.float64)
        if peer_eta is None:
            peer = np.full(fetch_eta.shape, np.inf)
        else:
            peer = np.asarray(peer_eta, np.float64)
        return np.stack([
            self.buddy_cost(best_q, shape=fetch_eta.shape),
            self.degraded_cost(fidelity, shape=fetch_eta.shape),
            peer,
            fetch_eta,
            np.full(fetch_eta.shape, self.drop_cost()),
        ])

    def miss_cost(self, fetch_eta: np.ndarray,
                  fidelity: Optional[np.ndarray] = None,
                  best_q: Optional[np.ndarray] = None,
                  peer_eta: Optional[np.ndarray] = None) -> np.ndarray:
        """The stall-equivalent cost the runtime would actually pay if this
        expert missed right now — the min over all five outcomes. This is
        the 'lateness risk' a prefetch removes. Shapes follow ``fetch_eta``
        ([L, E] or a single layer's [E])."""
        return self._outcome_stack(fetch_eta, fidelity, best_q,
                                   peer_eta).min(axis=0)

    def outcome_argmin(self, fetch_eta: np.ndarray,
                       fidelity: Optional[np.ndarray] = None,
                       best_q: Optional[np.ndarray] = None,
                       peer_eta: Optional[np.ndarray] = None) -> np.ndarray:
        """Int outcome codes (BUDDY/DEGRADED/PEER/FETCH/DROP) — the
        host-side mirror of the in-graph argmin, for introspection/tests.
        np.argmin takes the first minimal row, which encodes the tie-break
        order: reroutes beat transfers at equal cost, and a peer borrow
        beats an equally-priced host fetch (cheaper link, full fidelity)."""
        return self._outcome_stack(fetch_eta, fidelity, best_q,
                                   peer_eta).argmin(axis=0)

    # -- prefetch ranking -----------------------------------------------
    def prefetch_scores(self, p_use: np.ndarray, miss_cost: np.ndarray,
                        resident: np.ndarray,
                        inflight: Optional[np.ndarray] = None) -> np.ndarray:
        """Expected stall SAVED by prefetching each expert of one layer:

            score[e] = P(use e next step) x miss_cost[e]

        Residents save nothing; in-flight transfers are already paid for.
        The prefetcher ranks by this instead of raw predicted frequency, so
        an expert whose miss a cheap fallback absorbs (good buddy, high-
        fidelity replica) stops crowding out one whose miss would stall."""
        p_use = np.asarray(p_use, np.float64)
        score = p_use * np.asarray(miss_cost, np.float64)
        score = np.where(np.asarray(resident, bool), 0.0, score)
        if inflight is not None:
            score = np.where(np.asarray(inflight, bool), 0.0, score)
        return score


def best_resident_q(table: np.ndarray, q: np.ndarray,
                    resident: np.ndarray) -> np.ndarray:
    """[L, E] (or [E] given per-layer slices) best buddy q among each
    expert's currently-resident candidates; -1 where none is eligible.
    Vectorized over the buddy rank axis (last)."""
    table = np.asarray(table)
    q = np.asarray(q, np.float64)
    resident = np.asarray(resident, bool)
    valid = table >= 0
    safe = np.where(valid, table, 0)
    if table.ndim == 3:                       # [L, E, R]
        res = resident[np.arange(safe.shape[0])[:, None, None], safe]
    else:                                     # [E, R] single layer
        res = resident[safe]
    elig = valid & res
    qv = np.where(elig, q, -1.0)
    return qv.max(axis=-1)
