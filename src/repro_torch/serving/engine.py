"""BuddyMoE serving engine — batched decode with an offloaded expert cache.

Counterpart of ``repro/serving/engine.py`` for batch and continuous
serving. Each step runs ``transformer.decode_step`` (or, for a chunked-
prefill step, ``transformer.prefill_chunk``) on the device with the CURRENT
residency mask
(experts whose transfers have ARRIVED; in-flight prefetches are misses); the
in-model BuddyMoE layer substitutes/flags per slot (Alg. 1). Between steps
the host replays the step on the event-driven PCIe timeline
(runtime/transfers.py): compute advances layer by layer, in-flight transfers
overlap the compute of earlier layers, a miss stalls only the layer that
needs it, and prefetches for layer l+lookahead are issued while layer l
computes. The clock is the simulation's model (runtime/memory.py), not the
card's.

Stall attribution: demand (cold miss, full fetch wait), late-prefetch
(predicted but not yet arrived: only the tail), overlapped (hidden under
compute). The recorded per-slot masks come back to the host once per step
(one device-to-host copy, plus the sampled tokens).

The quant tier (``tier=``, a runtime.tiers.TieredExpertStore) is ported:
the engine quantizes every MoE expert on the params' device, calibrates
the fidelity, uses the tier's displaced-budget cache, and serves a miss
the tier takes as a degraded slot. The continuous scheduler's row hooks
(``prefill_rows``, ``reset_rows``, ``advance_clock``, ``release_kv_row``)
are ported for the ring KV cache. Not ported yet (they raise
NotImplementedError): telemetry, the multi-device mesh, paged KV, the
prefix cache and live placement.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantize
from repro_torch.core.buddies import BuddyTables
from repro_torch.core.policy import BuddyPolicy
from repro_torch.models import transformer
from repro_torch.models.moe import BuddyState
from repro_torch.runtime.cache import ExpertCache
from repro_torch.runtime.costs import MissCostModel, best_resident_q
from repro_torch.runtime.memory import (DEFAULT_HW, HardwareModel,
                                        TransferLedger, expert_nbytes)
from repro_torch.runtime.transfers import TransferScheduler

# per-slot masks pulled back to the host each step, in this order
_SLOT_KEYS = ("indices", "substituted", "missed", "degraded", "dropped",
              "peered")


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens: int = 0
    sim_time_s: float = 0.0
    compute_s: float = 0.0
    stall_s: float = 0.0
    n_sub: int = 0
    n_miss_fetch: int = 0
    n_hit: int = 0
    n_late_prefetch: int = 0
    n_prefetch_issued: int = 0
    n_prefetch_cancelled: int = 0
    n_miss_drop: int = 0        # misses the cost argmin dropped (renorm)
    n_upgrade_issued: int = 0   # degraded-then-upgrade background fetches

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.sim_time_s if self.sim_time_s else 0.0


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *,
                 tables: Optional[BuddyTables] = None,
                 policy: BuddyPolicy = BuddyPolicy(),
                 cache: Optional[ExpertCache] = None,
                 predictor=None,
                 prefetch_k: int = 0,
                 lookahead: int = 1,
                 hw: HardwareModel = DEFAULT_HW,
                 window: int = -1,
                 seed: int = 0,
                 prefetch_min_saving: Optional[float] = None,
                 tier=None, upgrade_degraded: Optional[bool] = None,
                 telemetry=None, n_devices: int = 1,
                 paged_kv: bool = False, prefix_cache: bool = False,
                 placement=None):
        """Same knobs as the reference engine for what is ported. The
        params live on the device the engine runs on (their ``embed``
        tensor's device).

        tier: a TieredExpertStore; ``policy.quant_tier`` must name its
        precision. upgrade_degraded: background-fetch the true expert of
        every degraded slot (None: on exactly in cost mode with a tier)."""
        if not cfg.is_moe:
            raise ValueError("ServeEngine's expert cache applies to MoE archs")
        if lookahead < 1:
            raise ValueError("lookahead: layers ahead to prefetch (>= 1)")
        for what, on in (("telemetry", telemetry is not None),
                         ("the multi-device mesh", int(n_devices) != 1),
                         ("paged KV", paged_kv),
                         ("the prefix cache", prefix_cache),
                         ("live placement", placement is not None)):
            if on:
                _not_ported(what)
        self.telemetry = None          # read by serving.scheduler.summary
        self.tier = tier
        if tier is not None:
            if policy.quant_tier == "off":
                raise ValueError("a TieredExpertStore needs "
                                 "policy.quant_tier='int8'/'int4'")
            if quantize.TIER_BITS[policy.quant_tier] != tier.bits:
                raise ValueError(f"policy tier {policy.quant_tier} != store "
                                 f"bits {tier.bits}")
            if cache is not None and cache is not tier.cache:
                raise ValueError("pass the cache through the tier (it owns "
                                 "the budget split)")
            params, fid = quantize.attach_quant_tier(cfg, params, tier.bits)
            tier.attach_fidelity(fid)
            cache = tier.cache
        elif policy.quant_tier != "off":
            raise ValueError("policy.quant_tier is on but no "
                             "TieredExpertStore was given")
        self.cfg = cfg
        self.policy = policy
        self.params = params
        self.device = params["embed"].device
        self.num_moe_layers = sum(r for k, r in cfg.stack() if k == "attn_moe")
        e = cfg.moe.num_experts
        self.cache = cache or ExpertCache(self.num_moe_layers, e, 1.0)
        self.predictor = predictor
        self.prefetch_k = prefetch_k
        self.lookahead = lookahead
        self.hw = hw
        self.cache.enable_mesh(1)
        self.window = window
        self._expert_bytes = expert_nbytes(cfg.d_model, cfg.moe.d_ff)
        self._active_params = cfg.active_param_count()
        self._cost_mode = policy.miss_policy == "cost"
        self.costs = MissCostModel(
            self.num_moe_layers, e, expert_bytes=self._expert_bytes, hw=hw,
            stall_per_quality=policy.stall_per_quality,
            drop_loss=policy.drop_loss)
        if prefetch_min_saving is None:
            prefetch_min_saving = 0.01 * hw.transfer_time(self._expert_bytes)
        self.prefetch_min_saving = float(prefetch_min_saving)
        self.ledger = TransferLedger(hw)
        self.scheduler = TransferScheduler(hw)
        # residency commits and byte counts are driven by the same timeline
        self.scheduler.add_listener(self.cache.on_transfer_event)
        self.ledger.attach(self.scheduler)
        if tier is not None:
            self.ledger.tier_upload(tier.quant_bytes)
        self.upgrade_degraded = (self._cost_mode and tier is not None
                                 if upgrade_degraded is None
                                 else bool(upgrade_degraded))
        self.stats = EngineStats()
        self._last_used: dict = {}
        self.last_prefetch_worthwhile: Optional[int] = None
        self._step_worthwhile: Optional[int] = None
        # temperature sampling (generate(greedy=False)) draws from here
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        if tables is None:
            r = 8
            self._table = np.full((self.num_moe_layers, e, r), -1, np.int32)
            self._q = np.zeros((self.num_moe_layers, e, r), np.float32)
        else:
            self._table = np.asarray(tables.table, np.int32)
            self._q = np.asarray(tables.q, np.float32)
        if self.cache.buddy_table is None and tables is not None:
            # buddy-aware eviction: prefer victims whose misses buddies absorb
            self.cache.buddy_table = self._table
        # the profile is static: it goes to the device once
        self._table_dev = torch.from_numpy(self._table).to(self.device)
        self._q_dev = torch.from_numpy(self._q).to(self.device)

    def _buddy_state(self) -> BuddyState:
        res = self.cache.residency_mask()
        hop = np.stack([self.cache.hop_vector(l)
                        for l in range(self.num_moe_layers)])
        quant_ok = fid_cost = fetch_cost = None
        if self._cost_mode:
            # unified cost mode: the in-model argmin consumes per-expert
            # stall-equivalent costs (no tier: the degraded option is inf)
            # expected stall of fetching each expert on a miss THIS step
            # (cold: the full modeled transfer; in flight: its tail)
            eta = self.costs.fetch_eta(self.scheduler)
            fid = (None if self.tier is None
                   else self.tier.effective_fidelity())
            fid_cost = torch.as_tensor(self.costs.degraded_cost(
                fid, shape=eta.shape), dtype=torch.float32).to(self.device)
            fetch_cost = torch.as_tensor(eta, dtype=torch.float32) \
                .to(self.device)
        elif self.tier is not None:
            # precedence mode: degrade a miss whose expected stall buys
            # the replica's fidelity loss
            quant_ok = torch.from_numpy(self.tier.degraded_ok(
                res, self.costs.fetch_eta(self.scheduler))).to(self.device)
        return BuddyState(resident=torch.from_numpy(res).to(self.device),
                          table=self._table_dev, q=self._q_dev,
                          hop=torch.from_numpy(hop.astype(np.int32))
                          .to(self.device),
                          quant_ok=quant_ok, fid_cost=fid_cost,
                          fetch_cost=fetch_cost)

    def init_caches(self, batch: int, seq_len: int):
        return transformer.init_caches(
            self.cfg, batch, seq_len,
            window=0 if self.window < 0 else self.window, device=self.device)

    def advance_clock(self, to_time: float) -> None:
        """Advance the simulated clock (the host PCIe link's timeline) to
        ``to_time``: the serving schedulers' idle time between steps. The
        reference also advances its mesh's links; at one device this is
        exactly ``scheduler.advance``."""
        self.scheduler.advance(to_time)

    # ------------------------------------------------------------------
    def step(self, token, caches, pos, active: Optional[np.ndarray] = None):
        """One decode step for the whole batch. token [B] int tensor on the
        engine's device; pos an int (lockstep batch) or [B] per-row
        positions (a tensor, or the scheduler's numpy array, which goes to
        the device here). ``active`` is a bool [B] slot mask: inactive rows
        still flow through the step but are excluded from all expert-usage,
        transfer and throughput accounting. Returns (logits [B, V],
        caches)."""
        if isinstance(pos, np.ndarray) and pos.ndim == 1:
            pos = torch.from_numpy(pos.astype(np.int64)).to(self.device)
        logits, caches, aux = transformer.decode_step(
            self.params, self.cfg, token, caches, pos, policy=self.policy,
            buddies=self._buddy_state(), window=self.window, record=True)
        if active is None:
            active = np.ones(int(token.shape[0]), bool)
        self._account(aux, active=np.asarray(active, bool))
        return logits, caches

    def prefill_rows(self, tokens, rows, caches, base_pos, tok_valid=None):
        """Fused chunked-prefill step: up to C tokens per row in one launch
        of the model and one replay on the timeline (instead of C decode
        steps).

        tokens [B, C] int (numpy, or a tensor); ``rows`` bool [B] marks live
        slots (the others ride the fixed-shape step, masked out of all
        accounting); base_pos [B] is each row's absolute position of chunk
        token 0; tok_valid [B, C] is a PREFIX validity mask (default: every
        token of a live row). A decode row joins as a 1-valid-token chunk,
        so decode rows keep stepping while a neighbour slot prefills. The
        chunk's tokens share one weight-streaming pass on the simulated
        clock, and its expert activations feed the predictor and the cache.

        Returns (logits [B, C, V], caches); row i's next-token logits sit
        at index ``tok_valid[i].sum() - 1``. Raises ValueError when a
        multi-token chunk would wrap the ring KV cache."""
        if not torch.is_tensor(tokens):
            tokens = self._tokens(tokens)
        tokens = tokens.to(self.device)
        b, c = tokens.shape
        rows = np.asarray(rows, bool)
        if tok_valid is None:
            tok_valid = np.repeat(rows[:, None], c, axis=1)
        tok_valid = np.asarray(tok_valid, bool) & rows[:, None]
        base = np.asarray(base_pos, np.int64)
        counts = tok_valid.sum(axis=1)
        # a multi-token chunk is scattered into the ring before its queries
        # attend, so it must not wrap it (attn_prefill_chunk); single-token
        # rows are plain decode writes
        cap = caches[0]["kv"]["k"].shape[2]
        multi = counts > 1
        if multi.any() and int((base[multi] + counts[multi]).max()) > cap:
            raise ValueError(
                "chunked prefill would wrap the KV ring buffer: size caches "
                f"to the full prompt (prompt end "
                f"{int((base[multi] + counts[multi]).max())} > capacity "
                f"{cap})")
        logits, caches, aux = transformer.prefill_chunk(
            self.params, self.cfg, tokens, caches, base, tok_valid,
            policy=self.policy, buddies=self._buddy_state(),
            window=self.window, record=True)
        self._account(aux, active=tok_valid.reshape(-1))
        return logits, caches

    def reset_rows(self, caches, rows):
        """Zero the ring KV caches of ``rows`` (batch indices), in place, so
        that a freed slot can take a newly admitted request. Attention
        stacks only: their cache leaves are [L, B, ...]."""
        transformer.require_attention_stack(self.cfg, "reset_rows")
        idx = torch.as_tensor(np.atleast_1d(rows), dtype=torch.int64) \
            .to(self.device)
        for g in caches:
            for a in g["kv"].values():
                a[:, idx] = 0
        return caches

    def release_kv_row(self, row: int) -> None:
        """The scheduler's preemption and retirement hook: returns a row's
        KV pages to the pool in the reference's paged mode. A no-op on the
        ring, whose slots are zeroed on re-admission."""

    # -- per-layer step timeline ---------------------------------------
    def _account(self, aux, active: np.ndarray) -> None:
        """Replay the step on the transfer timeline, layer by layer.
        ``active`` is a flat [T] token mask. Per-step compute is
        ``hw.decode_compute_time(active_params, n_valid_tokens)``."""
        n_active = int(active.sum())
        if n_active == 0:
            return
        self._step_worthwhile = None
        sched = self.scheduler
        step_t0 = sched.now
        busy0 = sched.busy_s
        compute_total = self.hw.decode_compute_time(
            self._active_params, n_active)
        per_layer = compute_total / max(1, self.num_moe_layers)
        cursor = step_t0
        step_stall = 0.0

        layer_off = 0
        e_n = self.cfg.moe.num_experts
        for rec in aux.get("recorded", []):
            # one device -> host copy of every per-slot mask of the group
            host = torch.stack([rec[k].to(torch.int32) for k in _SLOT_KEYS]) \
                .cpu().numpy()                                # [6, L, T, K]
            idx = host[0]
            sub_sl, miss_sl, deg_sl, drop_sl, peer_sl = (host[1:] != 0)
            for li in range(idx.shape[0]):
                layer = layer_off + li
                # transfers in flight overlap all earlier layers' compute
                sched.advance(cursor)
                rows = idx[li][active]                        # [T_act, K]
                used = rows.reshape(-1)
                self._observe_layer(layer, used)
                res_used = np.unique(used[self.cache.resident[layer, used]])
                self.cache.pin(layer, res_used)
                self.stats.n_hit += int(len(res_used))

                n_sub = int(sub_sl[li][active].sum())
                self.stats.n_sub += n_sub
                self.ledger.buddy_hit(n_sub)
                n_deg = int(deg_sl[li][active].sum())
                if n_deg:
                    # misses served by the resident quant tier: no
                    # transfer, no stall — only the degraded accounting
                    self.ledger.degraded(n_deg)
                    if self.tier is not None:
                        self.tier.note_degraded(n_deg)
                    if self.upgrade_degraded:
                        self._upgrade_degraded(
                            layer, rows[deg_sl[li][active]])
                n_dr = int(drop_sl[li][active].sum())
                if n_dr:
                    # misses the cost argmin dropped: renormalized in the
                    # model, no transfer, no stall — event accounting only
                    self.ledger.drop(n_dr)
                    self.stats.n_miss_drop += n_dr
                if peer_sl[li][active].any():
                    _not_ported("peer borrowing (multi-device mesh)")
                miss_row = np.bincount(rows[miss_sl[li][active]],
                                       minlength=e_n)
                cursor, stall = self._resolve_misses(layer, miss_row, cursor)
                step_stall += stall
                cursor += per_layer          # this layer's compute slice
                self._issue_prefetches(layer, used)
                self.cache.unpin(layer)
            layer_off += idx.shape[0]

        sched.advance(cursor)               # drain overlap to end of step
        step_time = cursor - step_t0
        overlapped = max(0.0, (sched.busy_s - busy0) - step_stall)
        self.ledger.overlapped(overlapped)

        self.stats.steps += 1
        self.stats.tokens += n_active
        self.stats.compute_s += compute_total
        self.stats.stall_s += step_stall
        self.stats.sim_time_s += step_time

    def _observe_layer(self, layer: int, used: np.ndarray) -> None:
        self.cache.touch(layer, used)
        if self.predictor is not None:
            if hasattr(self.predictor, "observe_transition") and layer > 0:
                self.predictor.observe_transition(
                    layer, self._last_used.get(layer - 1, []), used)
            self.predictor.observe(layer, used)
        self._last_used[layer] = used

    def _resolve_misses(self, layer: int, miss_row: np.ndarray,
                        cursor: float):
        """Residual misses (post-substitution) block THIS layer only. An
        in-flight prefetch is escalated and waited for its tail (late
        prefetch); otherwise a demand fetch pays the full transfer."""
        if self.policy.fallback != "fetch":
            self.ledger.drop(int(miss_row.sum()))
            return cursor, 0.0
        sched = self.scheduler
        stall = 0.0
        for e in np.flatnonzero(miss_row > 0):
            e = int(e)
            if self.cache.resident[layer, e]:
                # arrived after this step's mask snapshot — already on device
                continue
            t = sched.in_flight(layer, e)
            if t is not None:
                sched.escalate(t)
                if t.cause in ("upgrade", "replicate"):
                    kind = "demand"
                else:
                    kind = "late_prefetch"
                    self.stats.n_late_prefetch += 1
            else:
                t = sched.submit(layer, e, self._expert_bytes, "demand")
                kind = "demand"
            done = sched.run_until_done(t)
            s = max(0.0, done - cursor)
            self.ledger.stall(kind, s)      # ledger owns the breakdown
            stall += s
            cursor = max(cursor, done)
            self.stats.n_miss_fetch += 1
        return cursor, stall

    def _upgrade_degraded(self, layer: int, experts: np.ndarray) -> None:
        """Degraded-then-upgrade: background-fetch the true experts the
        quant tier just served ('upgrade' cause: prefetch priority, exempt
        from stale-prediction cancels). This step's outputs stay degraded;
        a duplicate submission returns the in-flight transfer, so an expert
        pays its bytes once."""
        for e_up in np.unique(np.asarray(experts, np.int64)):
            e_up = int(e_up)
            if self.cache.resident[layer, e_up] or \
                    self.scheduler.in_flight(layer, e_up) is not None:
                continue
            self.scheduler.submit(layer, e_up, self._expert_bytes, "upgrade")
            self.stats.n_upgrade_issued += 1

    def _rank_prefetch(self, tgt: int, used: np.ndarray):
        """Expected-stall-saved prefetch ranking (cost mode): score[e] =
        P(use e at the target layer) x the miss cost without it. Returns
        (want, worthwhile) as the reference does."""
        p_use = np.asarray(self.predictor.predict_proba(
            tgt, lookahead=self.lookahead, context=used), np.float64)
        eta = np.full(self.cfg.moe.num_experts,
                      self.hw.transfer_time(self._expert_bytes))
        fid_row = (None if self.tier is None
                   else self.tier.effective_fidelity(tgt))
        best_q = (None if self.policy.mode == "none" else
                  best_resident_q(self._table[tgt], self._q[tgt],
                                  self.cache.resident[tgt]))
        risk = self.costs.miss_cost(eta, fid_row, best_q)
        score = self.costs.prefetch_scores(p_use, risk,
                                           self.cache.resident[tgt])
        new_score = np.where(self.cache.inflight[tgt], 0.0, score)
        worthwhile = int((new_score > self.prefetch_min_saving).sum())
        order = np.argsort(-score, kind="stable")
        want = [int(e) for e in order[:self.prefetch_k]
                if score[e] > self.prefetch_min_saving]
        return want, worthwhile

    def _issue_prefetches(self, layer: int, used: np.ndarray) -> None:
        """While ``layer`` computes, line up transfers for layer
        ``layer + lookahead`` (wrapping into the next step); predictions
        that changed since the last issue are cancelled if unserved."""
        if self.predictor is None or self.prefetch_k <= 0:
            return
        tgt = (layer + self.lookahead) % self.num_moe_layers
        if self._cost_mode and hasattr(self.predictor, "predict_proba"):
            want, w = self._rank_prefetch(tgt, used)
            self._step_worthwhile = (w if self._step_worthwhile is None
                                     else max(self._step_worthwhile, w))
            self.last_prefetch_worthwhile = self._step_worthwhile
        else:
            want = self.predictor.predict_ahead(
                tgt, self.prefetch_k, lookahead=self.lookahead, context=used)
            want = [int(e) for e in np.atleast_1d(want)]
        self.stats.n_prefetch_cancelled += \
            self.scheduler.cancel_stale_prefetches(tgt, want)
        for e in want:
            if self.cache.resident[tgt, e] or self.cache.inflight[tgt, e]:
                continue
            self.scheduler.submit(tgt, e, self._expert_bytes, "prefetch")
            self.stats.n_prefetch_issued += 1

    # ------------------------------------------------------------------
    def reset_runtime(self, cache: Optional[ExpertCache] = None,
                      predictor=None) -> None:
        """Fresh serving state (clock, ledger, cache, predictor, stats) on
        the same model, e.g. to reuse one engine across runs. The tier's
        replicas are static: it is repointed at the fresh cache and its
        one-time upload is paid again."""
        e = self.cfg.moe.num_experts
        if cache is None:
            old = self.cache
            cache = ExpertCache(self.num_moe_layers, e, old.capacity / e,
                                policy=old.policy,
                                num_partitions=old.num_partitions,
                                buddy_table=old.buddy_table,
                                buddy_candidates=old.buddy_candidates)
        self.cache = cache
        if self.tier is not None:
            self.tier.cache = cache
            self.tier.reset_counters()
        if predictor is None and self.predictor is not None:
            # carry the predictor's configuration into the fresh instance
            if hasattr(self.predictor, "clone_fresh"):
                predictor = self.predictor.clone_fresh()
            else:
                predictor = type(self.predictor)(self.num_moe_layers, e)
        self.predictor = predictor
        self.ledger = TransferLedger(self.hw)
        self.scheduler = TransferScheduler(self.hw)
        self.scheduler.add_listener(self.cache.on_transfer_event)
        self.ledger.attach(self.scheduler)
        if self.tier is not None:
            self.ledger.tier_upload(self.tier.quant_bytes)
        self.stats = EngineStats()
        self._last_used = {}
        self.last_prefetch_worthwhile = None
        self._step_worthwhile = None

    # ------------------------------------------------------------------
    def sample_tokens(self, logits, greedy: bool, temperature: float = 1.0):
        """Next-token choice from [B, V] logits: argmax, or temperature
        sampling from the engine's seeded torch.Generator."""
        if greedy:
            return logits.argmax(-1).cpu().numpy()
        if temperature <= 0.0:
            raise ValueError("temperature must be > 0 for sampling")
        p = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(p, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    def _tokens(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=torch.int64) \
            .to(self.device)

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 greedy: bool = True, temperature: float = 1.0,
                 row_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Teacher-free batched generation. prompts [B, P] int. ``row_mask``
        [B] marks real rows (pad rows are stepped for shape but excluded
        from the accounting)."""
        b, p_len = prompts.shape
        total = p_len + max_new_tokens
        caches = self.init_caches(b, total)
        out = np.zeros((b, total), np.int64)
        out[:, :p_len] = prompts
        tok = self._tokens(prompts[:, 0])
        for pos in range(total - 1):
            logits, caches = self.step(tok, caches, pos, active=row_mask)
            if pos + 1 < p_len:
                tok = self._tokens(prompts[:, pos + 1])
            else:
                nxt = self.sample_tokens(logits, greedy, temperature)
                out[:, pos + 1] = nxt
                tok = self._tokens(nxt)
        return out

    def teacher_forced_nll(self, tokens: np.ndarray,
                           row_mask: Optional[np.ndarray] = None) -> float:
        """Mean next-token NLL under the engine's policy (the tier's
        accuracy measure). ``row_mask`` [B] excludes pad rows."""
        b, s = tokens.shape
        mask = (np.ones(b, bool) if row_mask is None
                else np.asarray(row_mask, bool))
        caches = self.init_caches(b, s)
        nll, n = 0.0, 0
        for pos in range(s - 1):
            logits, caches = self.step(self._tokens(tokens[:, pos]), caches,
                                       pos, active=mask)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tgt = self._tokens(tokens[:, pos + 1])
            row_nll = -logp.gather(1, tgt[:, None])[:, 0].cpu().numpy()
            nll += float(row_nll[mask].sum())
            n += int(mask.sum())
        return nll / n

    def stall_breakdown(self) -> dict:
        return {
            "demand_stall_s": self.ledger.demand_stall_s,
            "late_prefetch_stall_s": self.ledger.late_prefetch_stall_s,
            "overlapped_s": self.ledger.overlapped_s,
        }

    def summary(self) -> dict:
        s = {
            "policy": dataclasses.asdict(self.policy),
            "cache_rate": self.cache.capacity / self.cfg.moe.num_experts,
            "stats": dataclasses.asdict(self.stats),
            "tokens_per_s": self.stats.tokens_per_s,
            "stall_breakdown": self.stall_breakdown(),
            "ledger": self.ledger.summary(),
        }
        if self.tier is not None:
            s["tier"] = self.tier.summary()
        if self._cost_mode:
            s["cost_policy"] = {
                "stall_per_quality": self.policy.stall_per_quality,
                "drop_loss": self.policy.drop_loss,
                "n_miss_drop": self.stats.n_miss_drop,
                "n_upgrade_issued": self.stats.n_upgrade_issued,
                "upgrade_degraded": self.upgrade_degraded,
                "prefetch_worthwhile_last": self.last_prefetch_worthwhile,
            }
        return s
