"""Online expert replication & live placement — the traffic→placement loop.

Buddy groups, tier coverage, and the initial cache seed are all frozen at
profiling time, but real traffic drifts (tenant mix, language, time of day).
Related systems close exactly this gap: predictive-prefetch replication
copies persistently-hot experts so misses on them disappear, and ExpertFlow
re-plans expert placement from live routing statistics. This module is the
repo's version of that loop: a ``PlacementController`` that runs ON THE
ENGINE'S SIMULATED CLOCK and, every ``refresh_interval_s`` of simulated
time, turns the per-expert activity EMAs into three placement actions:

  (a) coverage re-pick — re-rank per-layer activity and point
      ``TieredExpertStore.set_coverage`` at the live ranking, so a
      partial-coverage quant tier replicates the experts traffic actually
      hits instead of the profiling draw. The re-pick is hysteresis-guarded
      like replication — the desired covered set must persist for
      ``hot_windows`` CONSECUTIVE ticks, because a near-tied EMA ranking
      must not flap the tier — and applied make-before-break: experts
      about to LOSE coverage are pre-staged into the cache by a background
      'replicate' copy first, so the uncovering never converts their next
      miss into a fetch stall;
  (b) replication — persistently-hot experts that are NOT resident earn a
      full-precision replica: a background ``'replicate'``-cause transfer
      on the host link (prefetch priority, exempt from stale-prediction
      cancellation, its own ledger bucket). Hysteresis guards both edges:
      an expert must stay hot for ``hot_windows`` CONSECUTIVE windows
      before it earns a replica, and a replica whose expert has gone cold
      is marked reclaim-first so the cache evicts it before any normal
      victim. Admission control guards the slot itself: the copy is only
      issued when the victim it would displace (``preview_victim``) is
      clearly colder than the candidate (``replicate_margin``), because
      evicting a warm resident to install a replica just moves the miss;
  (c) peer push — on a mesh (``n_devices > 1``), hot experts are pushed to
      the least-loaded peer's HBM via ``ExpertCache.peer_insert``, with the
      bytes riding the owning device's ICI link, so future peer borrows
      come off a shorter queue.

The controller is a pure add-on: ``placement=None`` engines never construct
one and stay bit-identical to the pre-placement build (frozen-capture test
in tests/test_placement.py). All of its time arithmetic is in simulated
seconds (the transfer timeline's clock), never wall time.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.runtime.telemetry import ExpertStats


class PlacementController:
    """Closes the loop from live routing statistics to expert placement.

    Lifecycle: construct with the knobs below, pass as ``ServeEngine(...,
    placement=ctrl)``. The engine calls ``attach`` (from ``__init__`` and
    again from ``reset_runtime`` — configuration survives, per-run state
    does not), feeds ``observe_layer`` every (layer, step), and calls
    ``maybe_tick`` after each step; the continuous scheduler's feedback
    hook ticks it as well, so the controller fires at most once per
    ``refresh_interval_s`` of SIMULATED time regardless of who drives it.

    Knobs (all constructor-only; ``attach`` never changes them):

      refresh_interval_s   simulated seconds between placement ticks
      hot_windows          hysteresis K: consecutive hot windows an expert
                           needs before it earns a replica, and consecutive
                           ticks a changed coverage ranking must persist
                           before the tier is re-pointed at it
      hot_top_k            experts per layer counted as hot each window
                           (None: half the cache capacity, set at attach)
      max_replicas_per_layer  new 'replicate' transfers (and peer pushes)
                           issued per layer per tick
      replicate_margin     admission control: a replica is only issued when
                           candidate EMA > victim EMA x this margin (the
                           would-be eviction victim from ``preview_victim``)
      retune_coverage / replicate / peer_push   gate each action
      alpha                EMA decay of the controller's own ExpertStats
    """

    def __init__(self, *, refresh_interval_s: float = 1e-3,
                 hot_windows: int = 3, hot_top_k: Optional[int] = None,
                 max_replicas_per_layer: int = 2,
                 replicate_margin: float = 2.0,
                 retune_coverage: bool = True, replicate: bool = True,
                 peer_push: bool = True, alpha: float = 0.05):
        assert refresh_interval_s > 0.0, "refresh interval: simulated seconds"
        assert hot_windows >= 1, "hysteresis needs at least one hot window"
        assert max_replicas_per_layer >= 1
        assert replicate_margin >= 1.0, \
            "margin < 1 would admit replicas HOTTER victims must yield to"
        self.refresh_interval_s = float(refresh_interval_s)
        self.hot_windows = int(hot_windows)
        self._hot_top_k_cfg = hot_top_k
        self.hot_top_k = hot_top_k if hot_top_k is None else int(hot_top_k)
        self.max_replicas_per_layer = int(max_replicas_per_layer)
        self.replicate_margin = float(replicate_margin)
        self.retune_coverage = bool(retune_coverage)
        self.replicate = bool(replicate)
        self.peer_push = bool(peer_push)
        self.alpha = float(alpha)
        self.stats: Optional[ExpertStats] = None
        self.trace: list = []       # one dict per tick that changed placement
        self._reset_run_state(0, 0)

    # -- lifecycle ------------------------------------------------------
    def _reset_run_state(self, num_layers: int, num_experts: int) -> None:
        self._streak = np.zeros((num_layers, num_experts), np.int32)
        self._replicas = [set() for _ in range(num_layers)]
        self._cov_want: Optional[np.ndarray] = None   # pending covered set
        self._cov_streak = 0       # ticks the pending set has persisted
        self._next_tick = self.refresh_interval_s
        self.trace = []
        self.n_ticks = 0
        self.n_coverage_repicks = 0
        self.n_replicas_issued = 0
        self.n_replicas_reclaimed = 0
        self.n_peer_pushes = 0

    def attach(self, engine) -> None:
        """Bind to an engine: fresh per-run state (streaks, replica sets,
        counters, next-tick time) on the SAME configuration — exactly what
        ``reset_runtime`` needs between benchmark arms."""
        l_n = engine.num_moe_layers
        e_n = engine.cfg.moe.num_experts
        self.stats = ExpertStats(l_n, e_n, alpha=self.alpha)
        if self._hot_top_k_cfg is None:
            self.hot_top_k = max(1, engine.cache.capacity // 2)
        self.hot_top_k = min(self.hot_top_k, e_n)
        self._reset_run_state(l_n, e_n)

    # -- signal ---------------------------------------------------------
    def observe_layer(self, layer: int, used, hit, missed,
                      degraded=None) -> None:
        """Per-(layer, step) activity feed — same indicator-EMA semantics as
        ``telemetry.ExpertStats.update``. The controller owns its stats so
        live placement works with or without a Telemetry bundle attached."""
        self.stats.update(layer, used, hit, missed, degraded)

    # -- tick -----------------------------------------------------------
    def maybe_tick(self, engine) -> bool:
        """Fire ``tick`` when the engine's simulated clock has crossed the
        next refresh boundary. Idempotent within a window, so both the
        engine's step loop and the continuous scheduler's feedback hook may
        call it. Returns True when a tick ran."""
        now = engine.scheduler.now
        if now + 1e-12 < self._next_tick:
            return False
        self._next_tick = now + self.refresh_interval_s
        self.tick(engine)
        return True

    def tick(self, engine) -> None:
        """One placement window: re-rank activity, advance hot streaks, and
        apply the three actions. All transfers issued here are background
        ('replicate' cause — prefetch priority, cancel-exempt); the tick
        never advances the clock or stalls a layer."""
        self.n_ticks += 1
        act = self.stats.used_ema
        changed: dict = {}

        hot = self._hot_mask(act)
        self._streak = np.where(hot, self._streak + 1, 0).astype(np.int32)
        earned = self._streak >= self.hot_windows

        n_cov = self._retune_coverage(engine, act)
        n_rep = (self._replicate_hot(engine, earned, act)
                 if self.replicate else 0)
        n_rec = self._reclaim_cold(engine)
        n_push = (self._push_to_peers(engine, earned)
                  if self.peer_push and engine.n_devices > 1 else 0)

        if n_cov:
            changed["coverage_repicks"] = n_cov
        if n_rep:
            changed["replicas_issued"] = n_rep
        if n_rec:
            changed["replicas_reclaimed"] = n_rec
        if n_push:
            changed["peer_pushes"] = n_push
        if changed:
            entry = {"t": engine.scheduler.now, **changed}
            self.trace.append(entry)
            self._emit(engine, changed)

    def _hot_mask(self, act: np.ndarray) -> np.ndarray:
        """Per-layer top-``hot_top_k`` by activity EMA; experts with zero
        recorded activity are never hot (argsort would otherwise fill the
        top-k with arbitrary unused ids on a fresh run)."""
        hot = np.zeros(act.shape, bool)
        if act.size == 0:
            return hot
        top = np.argsort(-act, axis=1, kind="stable")[:, :self.hot_top_k]
        np.put_along_axis(hot, top, True, axis=1)
        return hot & (act > 0.0)

    # -- action (a): live tier coverage ---------------------------------
    def _retune_coverage(self, engine, act: np.ndarray) -> int:
        """Re-pick the quant tier's covered set from live activity.

        The target set is the live per-layer top-``n_covered`` by EMA —
        the same ranking ``set_coverage`` was designed for, fed from
        traffic instead of the profiling draw. Four guards keep the
        re-pick from costing what it saves:

          * margin — the activity mass under the desired set must beat the
            mass under the current covered set by ``replicate_margin``;
            swapping coverage between near-tied experts buys nothing and
            risks a stall on the uncovering edge;
          * persistence — the desired set must differ from the current
            covered mask AND persist unchanged for ``hot_windows``
            consecutive ticks, so a near-tied ranking that flips order
            between windows never churns the tier;
          * make-before-break — experts about to LOSE coverage are
            pre-staged into the cache by a background 'replicate' copy,
            and the re-pick is DEFERRED until every one of them is
            resident, so uncovering never turns their next miss into a
            fetch stall;
          * a stable workload (want == covered) resets the pending state
            and never touches the tier."""
        tier = engine.tier
        if (not self.retune_coverage or tier is None
                or tier.n_covered >= tier.num_experts or not act.any()):
            return 0
        want = np.zeros(act.shape, bool)
        top = np.argsort(-act, axis=1, kind="stable")[:, :tier.n_covered]
        np.put_along_axis(want, top, True, axis=1)
        if np.array_equal(want, tier.covered):
            self._cov_want, self._cov_streak = None, 0
            return 0
        if float((act * want).sum()) <= \
                float((act * tier.covered).sum()) * self.replicate_margin:
            self._cov_want, self._cov_streak = None, 0
            return 0
        if self._cov_want is None or not np.array_equal(want, self._cov_want):
            self._cov_want, self._cov_streak = want, 1
        else:
            self._cov_streak += 1
        if self._cov_streak < self.hot_windows:
            return 0
        if self._prestage_uncovered(engine, tier.covered & ~want, act):
            return 0            # copies in flight: apply on a later tick
        tier.set_coverage(act)
        self._cov_want, self._cov_streak = None, 0
        self.n_coverage_repicks += 1
        return 1

    def _prestage_uncovered(self, engine, losing: np.ndarray,
                            act: np.ndarray) -> int:
        """Make-before-break: background-copy every non-resident expert in
        ``losing`` (covered now, uncovered after the pending re-pick) into
        the cache. Returns the number still NOT resident — the re-pick is
        deferred while that is nonzero. The copy obeys the same
        ``replicate_margin`` admission control as replication: installing
        a cold about-to-be-uncovered expert must not evict a warm resident
        (the re-pick simply stays deferred until a slot opens up or the
        victim cools). Duplicate submits are absorbed by the scheduler (an
        in-flight (layer, expert) is returned, not re-queued), so calling
        this every tick until landing is safe."""
        cache = engine.cache
        pending = 0
        for layer, e in zip(*np.nonzero(losing)):
            layer, e = int(layer), int(e)
            if cache.resident[layer, e]:
                continue
            pending += 1
            if (cache.inflight[layer, e]
                    or engine.scheduler.in_flight(layer, e) is not None):
                continue
            victim = cache.preview_victim(layer, e)
            if victim >= 0 and act[layer, e] <= \
                    act[layer, victim] * self.replicate_margin:
                continue        # victim still warm: keep the re-pick deferred
            engine.scheduler.submit(layer, e, engine._expert_bytes,
                                    "replicate")
            self._replicas[layer].add(e)
            self.n_replicas_issued += 1
        return pending

    # -- action (b): replicate persistently-hot experts -----------------
    def _replicate_hot(self, engine, earned: np.ndarray,
                       act: np.ndarray) -> int:
        """Issue background 'replicate' fetches for hot-streak experts that
        are not resident or already in flight, bounded per layer per tick.
        The host link's cache listener commits each one into a full-
        precision slot when it lands. Admission control: when the cache is
        full, the copy only goes out if the would-be eviction victim is
        colder than the candidate by ``replicate_margin`` — displacing a
        warm resident doesn't remove a miss, it relocates it (and on a
        small cache the resulting ping-pong turns background replication
        into foreground fetch stalls)."""
        cache = engine.cache
        issued = 0
        for layer in range(earned.shape[0]):
            n_layer = 0
            for e in np.flatnonzero(earned[layer]):
                if n_layer >= self.max_replicas_per_layer:
                    break
                e = int(e)
                if (cache.resident[layer, e] or cache.inflight[layer, e]
                        or engine.scheduler.in_flight(layer, e) is not None):
                    # already placed (or arriving): just track hot residents
                    # we previously installed via their replica set
                    continue
                victim = cache.preview_victim(layer, e)
                if victim >= 0 and act[layer, e] <= \
                        act[layer, victim] * self.replicate_margin:
                    continue
                engine.scheduler.submit(layer, e, engine._expert_bytes,
                                        "replicate")
                self._replicas[layer].add(e)
                self.n_replicas_issued += 1
                n_layer += 1
                issued += 1
        return issued

    def _reclaim_cold(self, engine) -> int:
        """Hysteresis down-edge: replicas whose expert broke its hot streak
        are marked reclaim-first (``ExpertCache.mark_reclaimable``), so the
        next insertion evicts them before any normal victim. Replicas that
        heated back up are unmarked; replicas already evicted are counted
        reclaimed and forgotten."""
        cache = engine.cache
        reclaimed = 0
        for layer in range(self._streak.shape[0]):
            for e in list(self._replicas[layer]):
                if not cache.resident[layer, e]:
                    if not cache.inflight[layer, e] and \
                            engine.scheduler.in_flight(layer, e) is None:
                        # eviction already cleared the reclaimable flag
                        # (cache.insert does), so the eviction itself is
                        # the signal: count it and forget the replica
                        self._replicas[layer].discard(e)
                        self.n_replicas_reclaimed += 1
                        reclaimed += 1
                        cache.clear_reclaimable(layer, [e])
                    continue
                if self._streak[layer, e] == 0:
                    cache.mark_reclaimable(layer, [e])
                else:
                    cache.clear_reclaimable(layer, [e])
        return reclaimed

    # -- action (c): dynamic peer placement -----------------------------
    def _push_to_peers(self, engine, earned: np.ndarray) -> int:
        """Push hot experts into the least-loaded peer's HBM: the replica
        mask flips at submit time (``peer_insert``), while the bytes ride
        the owning device's ICI link as a background 'replicate' transfer —
        an optimistic flip, the same discipline peer seeding uses. Load is
        the link's cumulative busy time plus its current demand backlog."""
        cache = engine.cache
        links = engine.peer_links
        if not links:
            return 0
        load = {d: lk.busy_s + lk.backlog_s() for d, lk in links.items()}
        target = min(sorted(load), key=lambda d: load[d])
        pushed = 0
        for layer in range(earned.shape[0]):
            n_layer = 0
            for e in np.flatnonzero(earned[layer]):
                if n_layer >= self.max_replicas_per_layer:
                    break
                e = int(e)
                if cache.peer_resident[target, layer, e]:
                    continue
                owner = int(cache.owner[e])
                link = links.get(owner, links[target])
                if link.in_flight(layer, e) is not None:
                    continue
                link.submit(layer, e, engine._expert_bytes, "replicate")
                cache.peer_insert(target, layer, e)
                self.n_peer_pushes += 1
                n_layer += 1
                pushed += 1
        return pushed

    # -- observability --------------------------------------------------
    def _emit(self, engine, changed: dict) -> None:
        """Telemetry counters + an engine-track trace instant per changing
        tick — both behind the engine's ``telemetry is None`` guard, so a
        telemetry-off run pays nothing."""
        tele = engine.telemetry
        if tele is None:
            return
        for action, n in changed.items():
            tele.metrics.counter("placement", action=action).inc(n)
        if tele.trace is not None:
            tele.trace.instant("engine", 0, "placement", "placement",
                               engine.scheduler.now, **changed)

    def active_replicas(self) -> int:
        return sum(len(s) for s in self._replicas)

    def summary(self) -> dict:
        """Config + counter digest — ``ServeEngine.summary()['placement']``.
        Counters are per-run (reset by attach); times are simulated
        seconds."""
        return {
            "refresh_interval_s": self.refresh_interval_s,
            "hot_windows": self.hot_windows,
            "hot_top_k": self.hot_top_k,
            "max_replicas_per_layer": self.max_replicas_per_layer,
            "replicate_margin": self.replicate_margin,
            "retune_coverage": self.retune_coverage,
            "replicate": self.replicate,
            "peer_push": self.peer_push,
            "n_ticks": self.n_ticks,
            "coverage_repicks": self.n_coverage_repicks,
            "replicas_issued": self.n_replicas_issued,
            "replicas_reclaimed": self.n_replicas_reclaimed,
            "peer_pushes": self.n_peer_pushes,
            "active_replicas": self.active_replicas(),
            "trace": list(self.trace),
        }
