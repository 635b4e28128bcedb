"""The port's paged KV and radix prefix cache against the JAX package's, on
live reference calls:

  * the pool and the tree (``runtime/paged_kv.py``, ``serving/prefix.py``):
    the same seeded random request lifecycles (match, adopt, copy-on-write
    writes, donate, retire, evict, as tests/test_paged.py's property test
    drives them) through both leave equal block tables, refcounts, free
    lists, match results, copy pairs and eviction counts after every op;
  * ``attn_decode_paged`` / ``attn_prefill_chunk_paged`` on seeded numpy
    inputs with -1 holes in the block table, a block two rows share, and
    tokens that must not write: outputs within 1e-5 (f32, the same einsums
    and softmax in another order), written cache slots within 1e-5 and
    every other slot bit-equal to the pool before the call;
  * the engine on the reduced config (the reference's params carried over
    through params_from_numpy): paged ``generate`` equal to the ring's and
    to the reference's paged tokens, paged chunked-prefill logits within
    1e-5 of the ring's, and a prefix hit's logits bitwise equal to a cold
    recompute of the whole prompt;
  * the continuous scheduler on the committed fixture (results/bench/
    model.npz, tables_a0.95_k16.npz) with paged KV and the prefix cache,
    session requests sharing a prefix that is not block-aligned and one
    preemption: equal tokens per request, an equal prefix summary, and
    the simulated-clock summary allclose at rel 1e-9;
  * the configuration errors the reference refuses; telemetry, the mesh
    and live placement beside paged KV and the prefix cache, held against
    the reference through the scheduler; their flags beside the paged
    ones.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten_with_paths, load_pytree  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import reduced as jreduced  # noqa: E402
from repro.core.buddies import load_tables as jload_tables  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import paged_kv as JP  # noqa: E402
from repro.runtime import placement as JPlace  # noqa: E402
from repro.runtime import prefetch as JF  # noqa: E402
from repro.runtime import telemetry as JTel  # noqa: E402
from repro.runtime.cache import ExpertCache as JCache  # noqa: E402
from repro.serving import prefix as JX  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.checkpoint.io import load_npz, params_from_numpy  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import reduced  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.runtime import paged_kv as P  # noqa: E402
from repro_torch.runtime import placement as Place  # noqa: E402
from repro_torch.runtime import prefetch as F  # noqa: E402
from repro_torch.runtime import telemetry as Tel  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.serving import prefix as X  # noqa: E402
from repro_torch.serving import scheduler as S  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = str(FIXTURE / "tables_a0.95_k16.npz")
ATTN_TOL = 1e-5
CHUNK_TOL = 1e-5


def _assert_same(a, b, path=""):
    """Equal structure; ints/bools/strings equal, floats allclose."""
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-15), \
            f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a} != {b}"


# ===========================================================================
# the pool and the tree, differential
# ===========================================================================
def _lifecycles(pool_mod, tree_mod, seed):
    """Seeded random request lifecycles against one pool/tree pair: each
    request matches, adopts, makes its suffix writable (copy-on-write of a
    shared tail), donates its full blocks and retires now or later; retires
    and LRU evictions are interleaved; then everything is torn down.
    Returns the state after every op."""
    rng = np.random.default_rng(seed)
    bs = int(rng.integers(2, 6))
    batch = int(rng.integers(2, 5))
    max_blocks = int(rng.integers(2, 6))
    # at least the rows' footprint, so only the tree's blocks ever run out
    pool = pool_mod.PagedKVPool(batch * max_blocks + int(rng.integers(0, 9)),
                                bs, batch, max_blocks)
    tree = tree_mod.PrefixTree(pool)
    live, trace = set(), []

    def snap(event):
        trace.append((event, pool.tables.tolist(), pool.refcount.tolist(),
                      list(pool._free), pool.cow_copies, pool.evictions,
                      sorted(tree.block_holders().items()), tree.stats()))
        pool.check(tree.block_holders())

    for _ in range(30):
        free_rows = [r for r in range(batch) if r not in live]
        op = rng.random()
        if op < 0.2 and live:
            r = int(rng.choice(sorted(live)))
            pool.free_row(r)
            live.discard(r)
            snap(("retire", r))
        elif op < 0.3:
            snap(("evict", tree.evict_lru_leaf()))
        elif free_rows:
            row = int(rng.choice(free_rows))
            n = int(rng.integers(1, max_blocks * bs + 1))
            toks = [int(t) for t in rng.integers(0, 3, n)]   # prefixes collide
            m, chain = tree.match(toks, cap=n - 1)
            if m:
                pool.adopt(row, chain)
            pool.ensure_range(row, m, n)
            copies = pool.drain_copies()
            covered = (n // bs) * bs
            added = (tree.insert(toks[:covered], pool.row_blocks(row, covered))
                     if covered else 0)
            if rng.random() < 0.5:
                pool.free_row(row)
            else:
                live.add(row)
            snap(("serve", row, m, chain, copies, added))
    for r in sorted(live):
        pool.free_row(r)
    while tree.evict_lru_leaf():
        snap(("teardown",))
    snap(("end", pool.used_blocks, tree.n_nodes))
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_pool_and_tree_match_reference(seed):
    want = _lifecycles(JP, JX, seed)
    got = _lifecycles(P, X, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, f"diverged at {w[0]}"
    assert got[-1][0] == ("end", 0, 0)                      # nothing leaks


@pytest.mark.parametrize("mods", [(JP, JX), (P, X)], ids=["jax", "torch"])
def test_pool_exhaustion_raises_and_eviction_recovers(mods):
    pool_mod, tree_mod = mods
    pool = pool_mod.PagedKVPool(2, 4, 2, 4)
    pool.ensure_range(0, 0, 8)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.ensure_range(1, 0, 4)
    pool = pool_mod.PagedKVPool(2, 4, 2, 4)
    tree = tree_mod.PrefixTree(pool)
    pool.ensure_range(0, 0, 8)
    tree.insert([0, 1, 2, 3, 0, 1, 2, 3], pool.row_blocks(0, 8))
    pool.free_row(0)
    pool.ensure_range(1, 0, 8)                 # evicts the leaf, reuses
    assert (pool.evictions, tree.n_evicted) == (1, 1)
    pool.check(tree.block_holders())


# ===========================================================================
# paged attention
# ===========================================================================
BS, MB, NBLK = 4, 4, 12
# row: block table (-1 holes; block 0 is shared by rows 1 and 2 and written
# by neither), chunk (base, valid tokens), decode position
PAGED_ROWS = (
    ([5, -1, 2, -1], (0, 5), 4),      # token at 4 is valid, its block a hole
    ([0, 6, 8, -1], (9, 1), 9),       # a decode row in the chunk
    ([0, 9, -1, -1], (5, 2), 5),      # a partial prefix; pos 8, 9 unmapped
    ([10, 11, -1, -1], (6, 0), 17),   # inactive; decode past the table
)


def _paged_inputs(seed, c):
    b, d, h, kv, hd = len(PAGED_ROWS), 32, 4, 2, 8
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=shp) * 0.2).astype(np.float32)
         for k, shp in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                        ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}
    x = rng.normal(size=(b, c, d)).astype(np.float32)
    k0, v0 = (rng.normal(size=(NBLK, BS, kv, hd)).astype(np.float32)
              for _ in range(2))
    bt = np.array([r[0] for r in PAGED_ROWS], np.int32)
    return p, x, k0, v0, bt, dict(num_heads=h, num_kv_heads=kv, head_dim=hd,
                                  rope_theta=1e4)


def _written(bt, pos, valid):
    """[P, bs] slots a valid token writes (its block mapped)."""
    out = np.zeros((NBLK, BS), bool)
    for i, j in zip(*np.nonzero(valid)):
        blk = bt[i, min(pos[i, j] // BS, MB - 1)]
        if blk >= 0:
            out[blk, pos[i, j] % BS] = True
    return out


@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_paged_attention_matches_reference(mode):
    c = 1 if mode == "decode" else 5
    p, x, k0, v0, bt, kw = _paged_inputs(3 if mode == "decode" else 4, c)
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy())}
    if mode == "decode":
        pos = np.array([r[2] for r in PAGED_ROWS])
        valid = np.ones((len(pos), 1), bool)
        jy, jc = JA.attn_decode_paged(jparams, jnp.asarray(x), jcache,
                                      jnp.asarray(pos, jnp.int32),
                                      jnp.asarray(bt), **kw)
        ty, tc = A.attn_decode_paged(tparams, torch.from_numpy(x), cache,
                                     pos, bt, **kw)
        pos = pos[:, None]
    else:
        base = np.array([r[1][0] for r in PAGED_ROWS])
        valid = np.arange(c)[None, :] < np.array(
            [r[1][1] for r in PAGED_ROWS])[:, None]
        jy, jc = JA.attn_prefill_chunk_paged(
            jparams, jnp.asarray(x), jcache, jnp.asarray(base, jnp.int32),
            jnp.asarray(valid), jnp.asarray(bt), **kw)
        ty, tc = A.attn_prefill_chunk_paged(
            tparams, torch.from_numpy(x), cache, base, valid, bt, **kw)
        pos = base[:, None] + np.arange(c)[None, :]
    assert tc["k"] is cache["k"]                         # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    written = _written(bt, pos, valid)
    assert written.any() and not written.all()
    for name, before in (("k", k0), ("v", v0)):
        got, want = tc[name].numpy(), np.asarray(jc[name])
        np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        np.testing.assert_array_equal(got[~written], before[~written])
        np.testing.assert_array_equal(np.asarray(jc[name])[~written],
                                      before[~written])


# ===========================================================================
# the engine on the reduced config
# ===========================================================================
@pytest.fixture(scope="module")
def reduced_models():
    cfg = jreduced()
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jp).items()}
    return cfg, jp, reduced(), params_from_numpy(flat, "cpu")


def _engine(cfg, params, *, paged, prefix=False, kv_block=8, mod=None):
    l, e = cfg.num_layers, cfg.moe.num_experts
    engine, cache = (JEngine, JCache) if mod == "jax" else (ServeEngine,
                                                            ExpertCache)
    return engine(cfg, params, cache=cache(l, e, 1.0, seed=0), seed=0,
                  paged_kv=paged, kv_block=kv_block, prefix_cache=prefix)


def test_paged_generate_matches_ring(reduced_models):
    jcfg, jp, cfg, params = reduced_models
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 9))
    ring = _engine(cfg, params, paged=False).generate(prompts, 6)
    eng = _engine(cfg, params, paged=True)
    paged = eng.generate(prompts, 6)
    np.testing.assert_array_equal(paged, ring)
    ref = _engine(jcfg, jp, paged=True, mod="jax").generate(prompts, 6)
    np.testing.assert_array_equal(paged, np.asarray(ref))
    px = eng.summary()["prefix"]
    assert px["pool"]["used_blocks"] == 3 * 2          # 15 tokens, bs 8
    assert px["prefix_cache"] is False and "tree" not in px


def test_paged_prefill_logits_match_ring(reduced_models):
    _, _, cfg, params = reduced_models
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    logits = {}
    for paged in (False, True):
        eng = _engine(cfg, params, paged=paged)
        caches = eng.init_caches(2, 12)
        out = []
        for s in range(0, 12, 4):
            lg, caches = eng.prefill_rows(prompts[:, s:s + 4],
                                          np.ones(2, bool), caches,
                                          base_pos=np.full(2, s))
            out.append(lg.numpy())
        logits[paged] = np.concatenate(out, axis=1)
    np.testing.assert_allclose(logits[True], logits[False], rtol=CHUNK_TOL,
                               atol=CHUNK_TOL)


def _chunked_prefill_row(eng, caches, row, b, prompt, start, chunk=4):
    """Feed prompt[start:] into ``row`` in chunks; returns (caches,
    last-token logits)."""
    last, pos, n = None, start, len(prompt)
    while pos < n:
        c = min(chunk, n - pos)
        toks = np.zeros((b, chunk), np.int64)
        valid = np.zeros((b, chunk), bool)
        toks[row, :c] = prompt[pos:pos + c]
        valid[row, :c] = True
        base = np.zeros(b, np.int64)
        base[row] = pos
        lg, caches = eng.prefill_rows(toks, valid.any(1), caches,
                                      base_pos=base, tok_valid=valid)
        last = lg[row, c - 1].clone()
        pos += c
    return caches, last


def test_prefix_hit_logits_bitwise_equal_recompute(reduced_models):
    _, _, cfg, params = reduced_models
    rng = np.random.default_rng(9)
    b, cap, bs = 2, 32, 8
    donor = rng.integers(0, cfg.vocab_size, 24)          # 3 full blocks
    adopter = np.concatenate([donor[:20], rng.integers(0, cfg.vocab_size, 4)])
    eng = _engine(cfg, params, paged=True, prefix=True, kv_block=bs)
    caches = eng.init_caches(b, cap)
    caches, _ = _chunked_prefill_row(eng, caches, 0, b, donor, 0)
    eng.insert_prefix(0, donor)
    shared = caches[0]["kv"]["k"][:, eng.kv_pool.tables[0, 2]].clone()
    m = eng.adopt_prefix(1, adopter)
    assert m == 20
    caches, hit = _chunked_prefill_row(eng, caches, 1, b, adopter, m)
    assert eng.kv_pool.cow_copies >= 1      # the shared mid-fill block
    # the tree's copy of that block is untouched by the adopter's writes
    assert torch.equal(caches[0]["kv"]["k"][:, eng.kv_pool.tables[0, 2]],
                       shared)
    cold_eng = _engine(cfg, params, paged=True, prefix=True, kv_block=bs)
    caches2 = cold_eng.init_caches(b, cap)
    _, cold = _chunked_prefill_row(cold_eng, caches2, 1, b, adopter, 0)
    assert torch.equal(hit, cold)
    eng.kv_pool.check(eng.prefix_tree.block_holders())
    px = eng.summary()["prefix"]
    assert (px["hits"], px["hit_tokens"], px["novel_tokens"]) == (1, 20, 4)


# ===========================================================================
# the continuous scheduler on the committed fixture
# ===========================================================================
class _PreemptOnce:
    """Controller stub (tests/test_paged.py's): preempts ``rid`` the first
    step it is seen mid-prefill."""

    def __init__(self, rid, budget):
        self.rid, self.budget, self.trace = rid, budget, []
        self.sched = self.queue = None
        self.fired = False

    def observe_step(self, *a, **k):
        pass

    def apply(self, eng):
        if self.fired:
            return
        s = self.sched
        for i, r in enumerate(s._slot):
            if (r is not None and r.rid == self.rid and not r.tokens
                    and s._pos[i] < len(r.prompt)):
                s.preempt(i, self.queue)
                self.fired = True
                return


@pytest.fixture(scope="module")
def fixture_models():
    cfg = jprofiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, profiling(), load_npz(str(FIXTURE / "model.npz"), "cpu")


def _session_requests(mod, vocab):
    """Four requests on a 20-token shared prefix (not a multiple of the
    8-token block), two of them arriving after the first ones retired."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, vocab, 20)
    tails = (4, 6, 13, 5)
    arrivals = (0.0, 0.0, 0.03, 0.035)
    return [mod.ServeRequest(
        rid=i, prompt=np.concatenate([base, rng.integers(0, vocab, n)])
        .astype(np.int64), max_new_tokens=3, arrival_s=t)
        for i, (n, t) in enumerate(zip(tails, arrivals))]


def test_scheduler_with_prefix_cache_and_preemption_matches_reference(
        fixture_models):
    cfg, jp, pcfg, tp = fixture_models
    n, e = cfg.num_layers, cfg.moe.num_experts
    out = []
    for mod, engine, cache, pred, policy, tables, c, params, fmod in (
            (JS, JEngine, JCache, JF.PrevStepPredictor, JPolicy,
             jload_tables, cfg, jp, JF),
            (S, ServeEngine, ExpertCache, F.PrevStepPredictor, BuddyPolicy,
             load_tables, pcfg, tp, F)):
        ec = cache(n, e, 0.5)
        eng = engine(c, params, tables=tables(TABLES),
                     policy=policy(use_fused_dispatch=True), cache=ec,
                     predictor=pred(n, e), prefetch_k=ec.capacity // 2,
                     paged_kv=True, kv_block=8, prefix_cache=True)
        ctrl = _PreemptOnce(2, fmod.PrefetchBudget(0, 1, 0))
        sched = mod.ContinuousScheduler(eng, slots=2, prefill_chunk=4,
                                        controller=ctrl)
        reqs = _session_requests(mod, c.vocab_size)
        queue = mod.RequestQueue(reqs)
        ctrl.sched, ctrl.queue = sched, queue
        s = sched.run(queue)
        assert ctrl.fired, "the stub never found rid 2 mid-prefill"
        eng.kv_pool.check(eng.prefix_tree.block_holders())
        out.append((reqs, s))
    (jreqs, js), (preqs, ps) = out
    for jr, pr in zip(jreqs, preqs):
        assert pr.tokens == jr.tokens, f"request {pr.rid}"
        assert pr.prefix_hit_tokens == jr.prefix_hit_tokens
        np.testing.assert_allclose(pr.token_times, jr.token_times, rtol=1e-9)
    assert ps["engine"]["prefix"] == js["engine"]["prefix"]
    _assert_same(js, ps)
    px = ps["engine"]["prefix"]
    assert ps["completed"] == 4 and px["hits"] >= 2
    assert px["pool"]["cow_copies"] >= 2 and px["tree"]["nodes"] >= 2
    assert next(r for r in preqs if r.rid == 2).prefix_hit_tokens >= 20


# ===========================================================================
# refusals
# ===========================================================================
@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(paged_kv=True, window=8),
                                dict(paged_kv=True, kv_block=0)])
def test_paged_configuration_errors_match_reference(fixture_models, kw):
    """What the reference asserts against, the port raises ValueError for
    (asserts vanish under -O)."""
    cfg, jp, pcfg, tp = fixture_models
    with pytest.raises(AssertionError):
        JEngine(cfg, jp, **kw)
    with pytest.raises(ValueError):
        ServeEngine(pcfg, tp, **kw)


def _subsystem(name, mod):
    """The observer or extension of one package that joins paged KV."""
    if name == "telemetry":
        tel = JTel if mod == "jax" else Tel
        return dict(telemetry=tel.Telemetry.with_trace(num_layers=2,
                                                       num_experts=64))
    if name == "n_devices":
        return dict(n_devices=2)
    ctrl = JPlace if mod == "jax" else Place
    return dict(placement=ctrl.PlacementController(
        refresh_interval_s=5e-5, hot_windows=1, replicate_margin=1.0))


@pytest.mark.parametrize("kw", ["telemetry", "n_devices", "placement"])
def test_paged_engine_still_refuses_unported(fixture_models, kw):
    """Telemetry, the mesh and live placement were refused next to paged KV
    until they were ported; now each runs beside paged KV and the prefix
    cache, and the fixture's session requests through the scheduler give
    the reference's tokens and engine summary (floats at rel 1e-9)."""
    cfg, jp, pcfg, tp = fixture_models
    n, e = cfg.num_layers, cfg.moe.num_experts
    out = []
    for mod, engine, cache, pred, policy, tables, c, params in (
            (JS, JEngine, JCache, JF.PrevStepPredictor, JPolicy,
             jload_tables, cfg, jp),
            (S, ServeEngine, ExpertCache, F.PrevStepPredictor, BuddyPolicy,
             load_tables, pcfg, tp)):
        ec = cache(n, e, 0.5)
        eng = engine(c, params, tables=tables(TABLES),
                     policy=policy(use_fused_dispatch=True), cache=ec,
                     predictor=pred(n, e), prefetch_k=ec.capacity // 2,
                     paged_kv=True, kv_block=8, prefix_cache=True,
                     **_subsystem(kw, "jax" if mod is JS else "torch"))
        reqs = _session_requests(mod, c.vocab_size)
        s = mod.ContinuousScheduler(eng, slots=2, prefill_chunk=4).run(
            mod.RequestQueue(reqs))
        eng.kv_pool.check(eng.prefix_tree.block_holders())
        out.append(([r.tokens for r in reqs], s))
    (jtok, js), (ptok, ps) = out
    assert ptok == jtok
    _assert_same(json.loads(json.dumps(js, default=str)),
                 json.loads(json.dumps(ps, default=str)))
    eng_s = ps["engine"]
    assert ps["completed"] == 4 and eng_s["prefix"]["hits"] >= 1
    assert {"telemetry": "telemetry", "n_devices": "mesh",
            "placement": "placement"}[kw] in eng_s


@pytest.mark.parametrize("flag,want", [
    (["--n-devices", "2", "--ici-gbps", "50", "--no-peer-borrow"],
     dict(n_devices=2, ici_gbps=50.0, no_peer_borrow=True)),
    (["--placement", "live", "--placement-interval-ms", "0.5",
      "--placement-hot-windows", "2", "--placement-top-k", "4"],
     dict(placement="live", placement_interval_ms=0.5,
          placement_hot_windows=2, placement_top_k=4)),
    (["--telemetry", "on"], dict(telemetry="on", trace_out=None)),
    (["--trace-out", "t.json"], dict(telemetry="off", trace_out="t.json")),
    (["--kv-blocks", "-1"], "--kv-blocks >= 0")])
def test_launcher_paged_flags(flag, want, capsys):
    """The mesh, placement and telemetry flags parse beside the paged ones
    (with the reference's defaults for what is not given); a pool of
    negative size is refused."""
    ok = serve.parse_args(["--paged-kv", "--kv-block", "4", "--kv-blocks",
                           "0", "--prefix-cache"])
    assert (ok.paged_kv, ok.kv_block, ok.kv_blocks, ok.prefix_cache) == \
        (True, 4, 0, True)
    argv = ["--paged-kv", "--prefix-cache"] + flag
    if isinstance(want, str):
        with pytest.raises(SystemExit):
            serve.parse_args(argv)
        assert want in capsys.readouterr().err
        return
    args = serve.parse_args(argv)
    assert args.paged_kv and args.prefix_cache
    assert {k: getattr(args, k) for k in want} == want
