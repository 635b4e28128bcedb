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
are ported for the ring KV cache and for paged KV (``paged_kv=True``: a
runtime.paged_kv.PagedKVPool of blocks behind per-row block tables, with
copy-on-write), and so is the radix prefix cache over that pool
(``prefix_cache=True``: serving.prefix.PrefixTree, ``adopt_prefix`` and
``insert_prefix``). So are the reference's three observers and
extensions of the host loop: telemetry (``telemetry=``, a
runtime.telemetry.Telemetry: spans, counters, calibration and the
prefetch meter, read from the host arrays each step already has), the
simulated expert-parallel mesh (``n_devices`` 2-8: peer HBM pools behind
their own ICI links on the one event clock, whose borrow masks and costs
reach the routing on the device) and live placement (``placement=``, a
runtime.placement.PlacementController ticking on the simulated clock; a
coverage re-pick moves only the tier's host mask, since every expert's
replica is already on the device).
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
from repro_torch.runtime import trace
from repro_torch.runtime.cache import ExpertCache
from repro_torch.runtime.costs import MissCostModel, best_resident_q
from repro_torch.runtime.memory import (DEFAULT_HW, HardwareModel,
                                        TransferLedger, expert_nbytes)
from repro_torch.runtime.paged_kv import PagedKVPool
from repro_torch.runtime.telemetry import ExpertStats, Telemetry
from repro_torch.runtime.transfers import TransferScheduler, make_ici_links
from repro_torch.serving.prefix import PrefixTree

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
                 latency_cfg: Optional[ModelConfig] = None,
                 prefetch_min_saving: Optional[float] = None,
                 tier=None, upgrade_degraded: Optional[bool] = None,
                 telemetry: Optional[Telemetry] = None, n_devices: int = 1,
                 ici_gbps: Optional[float] = None, peer_borrow: bool = True,
                 paged_kv: bool = False, kv_block: int = 16,
                 kv_blocks: Optional[int] = None, prefix_cache: bool = False,
                 placement=None):
        """Same knobs as the reference engine for what is ported. The
        params live on the device the engine runs on (their ``embed``
        tensor's device).

        latency_cfg: the full-scale config whose expert size and active
        params price the simulated transfer and compute clock, so that a
        reduced model is timed as its deployment target (None: cfg).

        tier: a TieredExpertStore; ``policy.quant_tier`` must name its
        precision. upgrade_degraded: background-fetch the true expert of
        every degraded slot (None: on exactly in cost mode with a tier).

        paged_kv: one shared pool of ``kv_blocks`` blocks of ``kv_block``
        tokens per layer in place of the per-row ring (None: the ring's
        footprint, ``batch * ceil(seq_len / kv_block)``); attention stacks
        without a sliding window only. prefix_cache: the radix tree over
        that pool, which lets an admitted request adopt the KV of a cached
        prompt prefix (needs paged_kv).

        telemetry: a runtime.telemetry.Telemetry bundle (flight-recorder
        spans on the simulated clock, per-expert EMAs, miss-cost
        calibration, the prefetch meter); a pure observer, so None runs
        the same steps and decisions.

        n_devices: expert-parallel mesh size (1-8). Experts are sharded
        round-robin (owner[e] = e % D); device 0 computes, devices 1..D-1
        are simulated peer HBM pools, each behind its own ICI link (hop-
        priced) on the one event clock. A miss on an expert a peer holds
        can be borrowed over ICI (the fifth miss outcome) and lands in
        device 0's cache. ici_gbps: per-link bandwidth in GB/s (None:
        hw.ici_bw). peer_borrow: False keeps the sharding but resolves
        misses with the four single-device outcomes.

        placement: a runtime.placement.PlacementController, fed each layer's
        activity and ticked on the simulated clock (coverage re-picks,
        background replicas, peer pushes at D > 1)."""
        if not cfg.is_moe:
            raise ValueError("ServeEngine's expert cache applies to MoE archs")
        if lookahead < 1:
            raise ValueError("lookahead: layers ahead to prefetch (>= 1)")
        if not 1 <= int(n_devices) <= 8:
            raise ValueError(f"n_devices: 1-8 device mesh, got {n_devices}")
        if paged_kv:
            if kv_block < 1:
                raise ValueError(f"kv_block must be >= 1, got {kv_block}")
            transformer.require_attention_stack(cfg, "paged KV")
            if cfg.sliding_window or window > 0:
                raise ValueError("paged KV blocks never wrap; sliding-window "
                                 "decode is ring-only")
            if cfg.num_cond_tokens:
                raise ValueError("paged KV does not model conditioning-"
                                 "prefix positions")
        elif prefix_cache:
            raise ValueError("prefix_cache requires paged_kv")
        self._paged = bool(paged_kv)
        self._kv_block = int(kv_block)
        self._kv_blocks = kv_blocks
        self._prefix_on = bool(prefix_cache)
        self.kv_pool: Optional[PagedKVPool] = None
        self.prefix_tree: Optional[PrefixTree] = None
        self._prefix_hits = 0
        self._prefix_hit_tokens = 0
        self._prefix_novel_tokens = 0
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
        self.window = window
        ref_cfg = latency_cfg or cfg
        self._expert_bytes = expert_nbytes(ref_cfg.d_model, ref_cfg.moe.d_ff)
        self._latency_cfg = ref_cfg
        self._active_params = ref_cfg.active_param_count()
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
        self.n_devices = int(n_devices)
        self.peer_borrow = bool(peer_borrow)
        self._ici_bw = (hw.ici_bw if ici_gbps is None
                        else float(ici_gbps) * 1e9)
        self.cache.enable_mesh(self.n_devices)
        self.peer_links = self._build_peer_links()
        self._n_peer_borrow = 0
        if tier is not None:
            self.ledger.tier_upload(tier.quant_bytes)
        self.upgrade_degraded = (self._cost_mode and tier is not None
                                 if upgrade_degraded is None
                                 else bool(upgrade_degraded))
        self.stats = EngineStats()
        self._last_used: dict = {}
        self.last_prefetch_worthwhile: Optional[int] = None
        self._step_worthwhile: Optional[int] = None
        self.telemetry = telemetry
        self._wire_telemetry()
        self.placement = placement
        if placement is not None:
            placement.attach(self)
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

    # ------------------------------------------------------------------
    def _build_peer_links(self) -> dict:
        """One ICI TransferScheduler per peer device (empty at D=1). Every
        link shares the engine's event clock, commits borrowed experts into
        device 0's cache on completion (the host link's listener protocol),
        and books its bytes and stalls into the shared ledger."""
        if self.n_devices <= 1:
            return {}
        links = make_ici_links(self.n_devices, self.hw, ici_bw=self._ici_bw)
        for link in links.values():
            link.add_listener(self._on_peer_link_event)
            self.ledger.attach(link)
        return links

    def _on_peer_link_event(self, kind: str, t) -> None:
        """ICI-link cache listener: a borrow lands in device 0's cache, but
        a placement 'replicate' push lands in the target peer's HBM (its
        mask flipped at submit time), so it leaves device 0's state alone."""
        if t.cause == "replicate":
            return
        self.cache.on_transfer_event(kind, t)

    def _links_busy_s(self) -> float:
        return (self.scheduler.busy_s
                + sum(l.busy_s for l in self.peer_links.values()))

    def _wire_telemetry(self) -> None:
        """Attach the telemetry bundle (if any) to the current scheduler
        and links: the trace hook, the prefetch meter's listener, the
        tier's counters and the default ExpertStats. Called from __init__
        and again by reset_runtime, which rebuilds the scheduler."""
        tele = self.telemetry
        if tele is None:
            return
        self.scheduler.trace = tele.trace
        self.scheduler.add_listener(tele.prefetch.on_transfer_event)
        for link in self.peer_links.values():
            # per-link trace lanes ("transfers:ici<d>"); peer borrows are
            # demand-class, so the prefetch meter does not listen here
            link.trace = tele.trace
        if self.tier is not None:
            self.tier.telemetry = tele
        if tele.expert_stats is None:
            tele.expert_stats = ExpertStats(self.num_moe_layers,
                                            self.cfg.moe.num_experts)

    def _tier_fidelity(self) -> Optional[np.ndarray]:
        """[L, E] calibrated replica error with uncovered experts at inf,
        or None without a tier."""
        return None if self.tier is None else self.tier.effective_fidelity()

    def _buddy_state(self) -> BuddyState:
        res = self.cache.residency_mask()
        hop = np.stack([self.cache.hop_vector(l)
                        for l in range(self.num_moe_layers)])
        quant_ok = fid_cost = fetch_cost = peer_ok = peer_cost = None
        peer_on = self.peer_borrow and bool(self.peer_links)
        if self._cost_mode:
            # unified cost mode: the in-model argmin consumes per-expert
            # stall-equivalent costs (no tier: the degraded option is inf)
            # expected stall of fetching each expert on a miss THIS step
            # (cold: the full modeled transfer; in flight: its tail)
            eta = self.costs.fetch_eta(self.scheduler)
            fid_cost = torch.as_tensor(self.costs.degraded_cost(
                self._tier_fidelity(), shape=eta.shape),
                dtype=torch.float32).to(self.device)
            fetch_cost = torch.as_tensor(eta, dtype=torch.float32) \
                .to(self.device)
            if peer_on:
                # [L, E] peer borrow priced from the owning links' live
                # queues; inf where no peer holds the expert
                peer_cost = torch.as_tensor(self.costs.peer_eta(
                    self.peer_links, self.cache.peer_resident),
                    dtype=torch.float32).to(self.device)
        else:
            if self.tier is not None:
                # precedence mode: degrade a miss whose expected stall buys
                # the replica's fidelity loss
                quant_ok = torch.from_numpy(self.tier.degraded_ok(
                    res, self.costs.fetch_eta(self.scheduler))) \
                    .to(self.device)
            if peer_on:
                # [L, E]: any expert a peer holds is borrowable (chain:
                # buddy -> degraded -> peer -> fetch/drop)
                peer_ok = torch.from_numpy(
                    self.cache.peer_resident.any(axis=0)).to(self.device)
        return BuddyState(resident=torch.from_numpy(res).to(self.device),
                          table=self._table_dev, q=self._q_dev,
                          hop=torch.from_numpy(hop.astype(np.int32))
                          .to(self.device),
                          quant_ok=quant_ok, fid_cost=fid_cost,
                          fetch_cost=fetch_cost, peer_ok=peer_ok,
                          peer_cost=peer_cost)

    def init_caches(self, batch: int, seq_len: int):
        """Ring KV caches for ``batch`` rows of ``seq_len`` tokens, or in
        paged mode a fresh pool (and prefix tree) with block tables that
        wide and its device storage."""
        if self._paged:
            bs = self._kv_block
            max_blocks = -(-seq_len // bs)
            n_blocks = (int(self._kv_blocks) if self._kv_blocks
                        else batch * max_blocks)
            self.kv_pool = PagedKVPool(n_blocks, bs, batch, max_blocks)
            self._prefix_hits = 0
            self._prefix_hit_tokens = 0
            self._prefix_novel_tokens = 0
            if self._prefix_on:
                self.prefix_tree = PrefixTree(self.kv_pool)
            return transformer.init_paged_caches(self.cfg, n_blocks, bs,
                                                 device=self.device)
        return transformer.init_caches(
            self.cfg, batch, seq_len,
            window=0 if self.window < 0 else self.window, device=self.device)

    def _apply_kv_copies(self, caches):
        """Land the pool's pending copy-on-write pairs in one batched
        in-place copy per cache leaf ([L, P, bs, KV, hd]: block axis 1).
        It must run before the step's scatter, which may write into a
        fresh copy, and the source block stays as it was (the tree's)."""
        pairs = self.kv_pool.drain_copies()
        if pairs:
            src, dst = torch.tensor(pairs, dtype=torch.int64).T \
                .to(self.device)
            with trace.span("engine.kv_cow_copy"):
                for g in caches:
                    for a in g["kv"].values():
                        a[:, dst] = a[:, src]
        return caches

    def _map_rows(self, caches, starts, ends):
        """Paged mode: make positions [starts[i], ends[i]) writable by each
        row i (allocate, or copy-on-write a shared block), land the copies,
        and return the block table the step ships to the device."""
        for i in np.flatnonzero(ends > starts):
            self.kv_pool.ensure_range(int(i), int(starts[i]), int(ends[i]))
        self._apply_kv_copies(caches)
        return self.kv_pool.tables

    def advance_clock(self, to_time: float) -> None:
        """Advance every link of the mesh (host PCIe and each ICI link) to
        the same simulated instant ``to_time``: the serving schedulers'
        idle time between steps. At one device this is exactly
        ``scheduler.advance``."""
        self.scheduler.advance(to_time)
        for link in self.peer_links.values():
            link.advance(to_time)

    # ------------------------------------------------------------------
    def step(self, token, caches, pos, active: Optional[np.ndarray] = None):
        """One decode step for the whole batch. token [B] int tensor on the
        engine's device; pos an int (lockstep batch) or [B] per-row
        positions (a tensor, or the scheduler's numpy array, which goes to
        the device here). ``active`` is a bool [B] slot mask: inactive rows
        still flow through the step but are excluded from all expert-usage,
        transfer and throughput accounting. Returns (logits [B, V],
        caches)."""
        with trace.span("engine.issue") as sp:
            if active is None:
                active = np.ones(int(token.shape[0]), bool)
            if sp is not None:
                sp.feed(np.count_nonzero(active))
            tables = None
            if self._paged:
                # paged decode is always per-row: broadcast a lockstep
                # scalar; the block table and positions go up in the
                # step's plan
                pos = np.broadcast_to(np.asarray(pos, np.int64),
                                      (int(token.shape[0]),))
                tables = self._map_rows(caches, np.where(active, pos, 0),
                                        np.where(active, pos + 1, 0))
            elif isinstance(pos, np.ndarray) and pos.ndim == 1:
                pos = torch.from_numpy(pos.astype(np.int64)).to(self.device)
            with trace.span("engine.state"):
                buddies = self._buddy_state()
            logits, caches, aux = transformer.decode_step(
                self.params, self.cfg, token, caches, pos,
                policy=self.policy, buddies=buddies, window=self.window,
                record=True, block_tables=tables)
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
        multi-token chunk would wrap the ring KV cache; in paged mode there
        is no ring (a slot's index is its content position) and the rows'
        write ranges are mapped in the pool instead."""
        with trace.span("engine.issue") as sp:
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
            if sp is not None:
                sp.feed(counts.sum())
            tables = None
            if self._paged:
                tables = self._map_rows(caches, base, base + counts)
            else:
                # a multi-token chunk is scattered into the ring before
                # its queries attend, so it must not wrap it
                # (attn_prefill_chunk); single-token rows are plain decode
                # writes
                cap = caches[0]["kv"]["k"].shape[2]
                multi = counts > 1
                if multi.any() and \
                        int((base[multi] + counts[multi]).max()) > cap:
                    raise ValueError(
                        "chunked prefill would wrap the KV ring buffer: "
                        "size caches to the full prompt (prompt end "
                        f"{int((base[multi] + counts[multi]).max())} > "
                        f"capacity {cap})")
            with trace.span("engine.state"):
                buddies = self._buddy_state()
            logits, caches, aux = transformer.prefill_chunk(
                self.params, self.cfg, tokens, caches, base, tok_valid,
                policy=self.policy, buddies=buddies, window=self.window,
                record=True, block_tables=tables)
        self._account(aux, active=tok_valid.reshape(-1))
        return logits, caches

    def reset_rows(self, caches, rows):
        """Free the KV caches of ``rows`` (batch indices) so that a freed
        slot can take a newly admitted request: the ring's rows are zeroed
        in place (attention stacks only: their cache leaves are [L, B,
        ...]); in paged mode the rows' blocks go back to the pool (shared
        prefix blocks live on through the tree's refcounts) and the device
        storage is left as it is."""
        transformer.require_attention_stack(self.cfg, "reset_rows")
        if self._paged:
            for r in np.atleast_1d(rows):
                self.kv_pool.free_row(int(r))
            return caches
        idx = torch.as_tensor(np.atleast_1d(rows), dtype=torch.int64) \
            .to(self.device)
        for g in caches:
            for a in g["kv"].values():
                a[:, idx] = 0
        return caches

    def release_kv_row(self, row: int) -> None:
        """The scheduler's preemption and retirement hook: in paged mode,
        return the row's blocks to the pool without touching the device
        storage. A no-op on the ring, whose rows are zeroed on
        re-admission."""
        if self._paged:
            self.kv_pool.free_row(int(row))

    # -- prefix cache ---------------------------------------------------
    def adopt_prefix(self, row: int, prompt) -> int:
        """Match ``prompt`` against the radix tree and map the longest
        cached prefix into ``row``'s block table (a refcount each; the
        shared tail block is copied on the row's first write to it).
        Returns the number of adopted tokens m: the scheduler then feeds
        prompt[m] first and chunk-prefills only the novel suffix."""
        if self.prefix_tree is None:
            raise ValueError("adopt_prefix needs prefix_cache=True and "
                             "caches from init_caches")
        toks = [int(t) for t in prompt]
        m, blocks = self.prefix_tree.match(toks, cap=len(toks) - 1)
        if m > 0:
            self.kv_pool.adopt(row, blocks)
            self._prefix_hits += 1
        self._prefix_hit_tokens += m
        self._prefix_novel_tokens += len(toks) - m
        tele = self.telemetry
        if tele is not None:
            tele.metrics.counter("prefix_tokens", kind="hit").inc(m)
            tele.metrics.counter("prefix_tokens",
                                 kind="novel").inc(len(toks) - m)
            self._prefix_gauges(tele)
            if m > 0 and tele.trace is not None:
                tele.trace.instant("engine", 0, "prefix_hit", f"row{row}",
                                   self.scheduler.now, row=int(row),
                                   hit_tokens=int(m),
                                   novel_tokens=int(len(toks) - m))
        return m

    def insert_prefix(self, row: int, prompt) -> None:
        """Donate a fully prefilled row's prompt KV to the radix tree,
        trimmed to full blocks: the final partial block stays private, so
        the donor keeps decoding into it without a copy."""
        if self.prefix_tree is None:
            return
        bs = self.kv_pool.block_size
        covered = (len(prompt) // bs) * bs
        if covered == 0:
            return
        self.prefix_tree.insert([int(t) for t in prompt[:covered]],
                                self.kv_pool.row_blocks(row, covered))
        if self.telemetry is not None:
            self._prefix_gauges(self.telemetry)

    def _prefix_gauges(self, tele) -> None:
        occ = self.kv_pool.occupancy()
        tele.metrics.gauge("kv_pool_used_blocks").set(occ["used_blocks"])
        tele.metrics.gauge("kv_pool_free_blocks").set(occ["free_blocks"])
        if self.prefix_tree is not None:
            tele.metrics.gauge("prefix_tree_nodes").set(
                self.prefix_tree.n_nodes)

    # -- per-layer step timeline ---------------------------------------
    def _account(self, aux, active: np.ndarray) -> None:
        """Replay the step on the transfer timeline, layer by layer.
        ``active`` is a flat [T] token mask. Per-step compute is
        ``hw.decode_compute_time(active_params, n_valid_tokens)``. The
        telemetry, placement and peer rows read only the host arrays this
        replay already holds."""
        n_active = int(active.sum())
        if n_active == 0:
            return
        with trace.span("engine.wait"):
            # one device -> host copy of every per-slot mask of each
            # group; the first waits for the step's device work
            hosts = [torch.stack([rec[k].to(torch.int32)
                                  for k in _SLOT_KEYS]).cpu().numpy()
                     for rec in aux.get("recorded", [])]    # [6, L, T, K]
        with trace.span("engine.replay"):
            self._replay(hosts, active, n_active)

    def _replay(self, hosts, active: np.ndarray, n_active: int) -> None:
        """``_account``'s replay of the step from the host copies of its
        per-slot masks."""
        self._step_worthwhile = None
        tele = self.telemetry
        flight = tele.trace if tele is not None else None
        sched = self.scheduler
        step_t0 = sched.now
        busy0 = self._links_busy_s()
        compute_total = self.hw.decode_compute_time(
            self._active_params, n_active)
        per_layer = compute_total / max(1, self.num_moe_layers)
        cursor = step_t0
        step_stall = 0.0

        layer_off = 0
        e_n = self.cfg.moe.num_experts
        for host in hosts:
            idx = host[0]
            sub_sl, miss_sl, deg_sl, drop_sl, peer_sl = (host[1:] != 0)
            for li in range(idx.shape[0]):
                layer = layer_off + li
                # transfers in flight overlap all earlier layers' compute
                self.advance_clock(cursor)
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
                miss_row = np.bincount(rows[miss_sl[li][active]],
                                       minlength=e_n)
                peer_row = None
                n_peer = 0
                if peer_sl[li][active].any():
                    # slots the routing resolved by peer-HBM borrow: a
                    # demand-class ICI transfer from the owning device
                    peer_row = np.bincount(rows[peer_sl[li][active]],
                                           minlength=e_n)
                    n_peer = int(peer_row.sum())
                if tele is not None:
                    self._record_layer_telemetry(
                        layer, rows, used, res_used, miss_row, cursor,
                        n_sub=n_sub, n_deg=n_deg, n_dr=n_dr, n_peer=n_peer,
                        sub_slots=sub_sl[li][active],
                        deg_slots=deg_sl[li][active])
                if self.placement is not None:
                    # the controller owns its own ExpertStats, so live
                    # placement works with or without telemetry
                    self.placement.observe_layer(
                        layer, np.unique(used), res_used,
                        np.flatnonzero(miss_row > 0),
                        (np.unique(rows[deg_sl[li][active]])
                         if n_deg else None))
                stall_t0 = cursor
                stall = 0.0
                if peer_row is not None:
                    cursor, pstall = self._resolve_peer(layer, peer_row,
                                                        cursor)
                    stall += pstall
                cursor, fstall = self._resolve_misses(layer, miss_row,
                                                      cursor)
                stall += fstall
                step_stall += stall
                if flight is not None:
                    if stall > 0.0:
                        flight.span("layers", layer, "stall", "stall",
                                   stall_t0, cursor, stall_s=stall,
                                   n_fetch=int((miss_row > 0).sum()))
                    flight.span("layers", layer, "compute", "compute",
                               cursor, cursor + per_layer)
                cursor += per_layer          # this layer's compute slice
                self._issue_prefetches(layer, used)
                self.cache.unpin(layer)
            layer_off += idx.shape[0]

        self.advance_clock(cursor)          # drain overlap to end of step
        step_time = cursor - step_t0
        overlapped = max(0.0, (self._links_busy_s() - busy0) - step_stall)
        self.ledger.overlapped(overlapped)

        self.stats.steps += 1
        self.stats.tokens += n_active
        self.stats.compute_s += compute_total
        self.stats.stall_s += step_stall
        self.stats.sim_time_s += step_time

        if tele is not None:
            m = tele.metrics
            m.ema("step_time_s", alpha=0.05).update(step_time)
            m.histogram("step_stall_s").observe(step_stall)
            m.gauge("inflight_transfers").set(sched.n_in_flight)
            if flight is not None:
                flight.span("engine", 0, "step",
                           f"step{self.stats.steps - 1}", step_t0, cursor,
                           tokens=n_active, stall_s=step_stall,
                           overlapped_s=overlapped)
        if self.placement is not None:
            # interval-gated on the simulated clock, so the continuous
            # scheduler ticking it as well never fires a window twice
            self.placement.maybe_tick(self)

    def _observe_layer(self, layer: int, used: np.ndarray) -> None:
        self.cache.touch(layer, used)
        if self.predictor is not None:
            if hasattr(self.predictor, "observe_transition") and layer > 0:
                self.predictor.observe_transition(
                    layer, self._last_used.get(layer - 1, []), used)
            self.predictor.observe(layer, used)
        self._last_used[layer] = used

    def _record_layer_telemetry(self, layer: int, rows, used, res_used,
                                miss_row, t_layer: float, *, n_sub: int,
                                n_deg: int, n_dr: int, sub_slots,
                                deg_slots, n_peer: int = 0) -> None:
        """One (layer, step)'s telemetry: the miss-outcome breakdown (trace
        instant and counters), the per-expert EMAs, the prefetch meter's
        used-in-time credit, and the zero-stall calibration rows of the
        transfer-free outcomes (buddy, degraded, drop) with their quality
        price. The fetch and peer rows are recorded where the realized
        stall is known (_resolve_misses, _resolve_peer). Touches no engine,
        cache or scheduler state."""
        tele = self.telemetry
        missing = np.flatnonzero(miss_row > 0)
        uniq_used = np.unique(used)
        deg_e = (np.unique(rows[deg_slots]) if n_deg else None)
        if tele.expert_stats is not None:
            tele.expert_stats.update(layer, uniq_used, res_used, missing,
                                     deg_e)
        tele.prefetch.note_used(layer, uniq_used)
        m = tele.metrics
        m.counter("slots", outcome="hit").inc(len(res_used))
        for outcome, n in (("buddy", n_sub), ("degraded", n_deg),
                           ("peer", n_peer),
                           ("fetch", int(miss_row.sum())), ("drop", n_dr)):
            if n:
                m.counter("slots", outcome=outcome).inc(n)
        cal = tele.calibration
        if n_sub:
            # buddy: zero stall by construction; the quality price is the
            # cost model's host-side estimate at the substituted experts
            bq = best_resident_q(self._table[layer], self._q[layer],
                                 self.cache.resident[layer])
            bc = self.costs.buddy_cost(bq)[np.asarray(rows[sub_slots])]
            bc = bc[np.isfinite(bc)]
            cal.record("buddy", 0.0, 0.0, n=n_sub,
                       quality_cost=float(bc.mean()) if bc.size else 0.0)
        if n_deg:
            dc = self.costs.degraded_cost(self._tier_fidelity())[layer][deg_e]
            dc = dc[np.isfinite(dc)]
            cal.record("degraded", 0.0, 0.0, n=n_deg,
                       quality_cost=float(dc.mean()) if dc.size else 0.0)
        if n_dr:
            cal.record("drop", 0.0, 0.0, n=n_dr,
                       quality_cost=self.costs.drop_cost())
        if tele.trace is not None:
            extra = {"peer": n_peer} if self.n_devices > 1 else {}
            tele.trace.instant(
                "layers", layer, "outcomes", f"L{layer}", t_layer,
                hit=len(res_used), buddy=n_sub, degraded=n_deg,
                fetch=int(miss_row.sum()), drop=n_dr, **extra)

    def _resolve_misses(self, layer: int, miss_row: np.ndarray,
                        cursor: float):
        """Residual misses (post-substitution) block THIS layer only. An
        in-flight prefetch is escalated and waited for its tail (late
        prefetch); otherwise a demand fetch pays the full transfer."""
        tele = self.telemetry
        if self.policy.fallback != "fetch":
            n_dropped = int(miss_row.sum())
            self.ledger.drop(n_dropped)
            if tele is not None and n_dropped:
                tele.calibration.record("drop", 0.0, 0.0, n=n_dropped,
                                        quality_cost=self.costs.drop_cost())
            return cursor, 0.0
        sched = self.scheduler
        stall = 0.0
        for e in np.flatnonzero(miss_row > 0):
            e = int(e)
            if self.cache.resident[layer, e]:
                # arrived after this step's mask snapshot — already on device
                continue
            t = sched.in_flight(layer, e)
            # calibration: the cost model's predicted stall of the fetch at
            # decision time (the in-flight tail, or the cold transfer)
            predicted = None
            if tele is not None:
                predicted = (sched.eta_s(t) if t is not None else
                             self.hw.transfer_time(self._expert_bytes))
                if t is None:
                    tele.prefetch.note_uncovered_miss(layer, e)
            if t is not None:
                sched.escalate(t)
                if t.cause in ("upgrade", "replicate"):
                    # not a prediction: waiting on one is a demand stall
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
            if tele is not None:
                tele.calibration.record("fetch", predicted, s)
                tele.metrics.histogram("stall_s", kind=kind).observe(s)
            stall += s
            cursor = max(cursor, done)
            self.stats.n_miss_fetch += 1
        return cursor, stall

    def _resolve_peer(self, layer: int, peer_row: np.ndarray,
                      cursor: float):
        """Peer-HBM borrows block THIS layer until the ICI transfer lands.
        Each borrowed expert comes from the cheapest live holder's link
        (priced as costs.peer_eta: the in-flight tail, else queue backlog
        plus the hop-priced transfer) and enters device 0's cache when it
        lands. An expert no reachable peer holds any more falls back to a
        host demand fetch, so the slot is never lost."""
        tele = self.telemetry
        stall = 0.0
        for e in np.flatnonzero(peer_row > 0):
            e = int(e)
            if self.cache.resident[layer, e]:
                # landed after this step's mask snapshot — already on device
                continue
            best_d = best_eta = t = None
            for d in self.cache.peer_holders(layer, e):
                link = self.peer_links.get(int(d))
                if link is None:
                    continue
                tf = link.in_flight(layer, e)
                eta = (link.eta_s(tf) if tf is not None else
                       link.backlog_s()
                       + link.transfer_time(self._expert_bytes))
                if best_eta is None or eta < best_eta:
                    best_d, best_eta, t = int(d), eta, tf
            if best_d is None:
                # raced out of every peer (eviction churn): demand-fetch
                t = self.scheduler.submit(layer, e, self._expert_bytes,
                                          "demand")
                done = self.scheduler.run_until_done(t)
                s = max(0.0, done - cursor)
                self.ledger.stall("demand", s)
                stall += s
                cursor = max(cursor, done)
                self.stats.n_miss_fetch += 1
                continue
            link = self.peer_links[best_d]
            if t is None:
                t = link.submit(layer, e, self._expert_bytes, "peer")
            done = link.run_until_done(t)
            s = max(0.0, done - cursor)
            self.ledger.stall("peer", s)
            if tele is not None:
                tele.calibration.record("peer", best_eta, s)
                tele.metrics.histogram("stall_s", kind="peer").observe(s)
            stall += s
            cursor = max(cursor, done)
            self._n_peer_borrow += 1
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
        # a miss a peer can absorb over ICI is cheap: its saving shrinks to
        # the peer ETA, freeing PCIe bytes for experts only the host has
        peer_row = (self.costs.peer_eta(self.peer_links,
                                        self.cache.peer_resident)[tgt]
                    if self.peer_borrow and self.peer_links else None)
        risk = self.costs.miss_cost(eta, fid_row, best_q, peer_eta=peer_row)
        score = self.costs.prefetch_scores(p_use, risk,
                                           self.cache.resident[tgt])
        new_score = np.where(self.cache.inflight[tgt], 0.0, score)
        worthwhile = int((new_score > self.prefetch_min_saving).sum())
        order = np.argsort(-score, kind="stable")
        want = [int(e) for e in order[:self.prefetch_k]
                if score[e] > self.prefetch_min_saving]
        # for the prefetch meter: _issue_prefetches credits each new
        # submission's score (expected stall saved) to the telemetry
        self._last_rank_scores = score
        return want, worthwhile

    def _issue_prefetches(self, layer: int, used: np.ndarray) -> None:
        """While ``layer`` computes, line up transfers for layer
        ``layer + lookahead`` (wrapping into the next step); predictions
        that changed since the last issue are cancelled if unserved."""
        if self.predictor is None or self.prefetch_k <= 0:
            return
        tgt = (layer + self.lookahead) % self.num_moe_layers
        scores = None
        if self._cost_mode and hasattr(self.predictor, "predict_proba"):
            want, w = self._rank_prefetch(tgt, used)
            scores = self._last_rank_scores
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
            if self.telemetry is not None and scores is not None:
                self.telemetry.prefetch.add_expected_saving(scores[e])

    # ------------------------------------------------------------------
    def reset_runtime(self, cache: Optional[ExpertCache] = None,
                      predictor=None) -> None:
        """Fresh serving state (clock, ledger, cache, predictor, stats) on
        the same model, e.g. to reuse one engine across runs. The tier's
        replicas are static: it is repointed at the fresh cache and its
        one-time upload is paid again. The mesh keeps its size (a fresh
        cache is sharded and fresh links built), an attached telemetry
        bundle keeps accumulating and is wired to the new scheduler, and an
        attached placement controller starts a fresh run on its unchanged
        configuration."""
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
        if self.cache.n_devices != self.n_devices:
            # a fresh cache arrives un-sharded: seed the home shard and the
            # peer pools as __init__ did
            self.cache.enable_mesh(self.n_devices)
        self.peer_links = self._build_peer_links()
        self._n_peer_borrow = 0
        if self.tier is not None:
            self.ledger.tier_upload(self.tier.quant_bytes)
        self.stats = EngineStats()
        self._last_used = {}
        self.last_prefetch_worthwhile = None
        self._step_worthwhile = None
        self._wire_telemetry()
        if self.placement is not None:
            self.placement.attach(self)

    # ------------------------------------------------------------------
    def sample_tokens(self, logits, greedy: bool, temperature: float = 1.0):
        """Next-token choice from [B, V] logits: argmax, or temperature
        sampling from the engine's seeded torch.Generator."""
        with trace.span("engine.sample"):
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
            with trace.span("serve.step", step=pos):
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
        """The ledger's attribution; the peer key only on a mesh (D > 1)."""
        d = {
            "demand_stall_s": self.ledger.demand_stall_s,
            "late_prefetch_stall_s": self.ledger.late_prefetch_stall_s,
            "overlapped_s": self.ledger.overlapped_s,
        }
        if self.n_devices > 1:
            d["peer_stall_s"] = self.ledger.peer_stall_s
        return d

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
        if self.n_devices > 1:
            total = self.stats.n_hit + self.stats.n_sub + \
                self.stats.n_miss_fetch + self._n_peer_borrow
            s["mesh"] = {
                "n_devices": self.n_devices,
                "ici_bw": self._ici_bw,
                "peer_borrow": self.peer_borrow,
                "n_peer_borrow": self._n_peer_borrow,
                "peer_share": (self._n_peer_borrow / total if total else 0.0),
                "peer_stall_s": self.ledger.peer_stall_s,
                "links": [self.peer_links[d].utilization()
                          for d in sorted(self.peer_links)],
            }
        if self._paged:
            s["prefix"] = {
                "paged_kv": True,
                "kv_block": self._kv_block,
                "prefix_cache": self._prefix_on,
                "pool": (self.kv_pool.occupancy()
                         if self.kv_pool is not None else None),
                "hits": self._prefix_hits,
                "hit_tokens": self._prefix_hit_tokens,
                "novel_tokens": self._prefix_novel_tokens,
            }
            if self.prefix_tree is not None:
                s["prefix"]["tree"] = self.prefix_tree.stats()
        if self.placement is not None:
            s["placement"] = self.placement.summary()
        if self.telemetry is not None:
            s["telemetry"] = self.telemetry.summary()
        return s
