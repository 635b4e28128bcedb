"""The port's chunked prefill against the JAX package's: ``attn_prefill_chunk``
on seeded numpy inputs (f32, 1e-5: the same einsums and softmax in another
order), ``prefill_chunk`` on the committed profiling fixture
(results/bench/model.npz, tables_a0.95_k16.npz), with the fused and the
capacity dispatch and with and without the int8 tier (logits to 1e-4, as
tests/test_torch_model.py holds decode_step; caches allclose 1e-4; routing
indices and every per-slot mask exactly equal), and the engine's
``prefill_rows`` (stats and ledger equal; floats on the simulated clock to
rel 1e-9) with its ring-wrap refusal. Inside torch, chunked prefill equals
token-by-token prefill through decode_step (1e-5: the same math at other
matmul shapes)."""
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import load_pytree  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.core.buddies import load_tables as jload_tables  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.cache import ExpertCache as JCache  # noqa: E402
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.configs.rwkv6_1p6b import reduced as rwkv_reduced  # noqa: E402
from repro_torch.core import quantize as pq  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = str(FIXTURE / "tables_a0.95_k16.npz")
ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4
CHUNK_TOL = 1e-5
SLOT_MASKS = ("indices", "substituted", "missed", "degraded", "dropped",
              "peered")

# rows of one [4, 5] chunk: (base position, valid tokens): a prefill from
# 0, a decode row (1 valid token) late in its prompt, a partly valid
# prefix mid-prompt, and an inactive row
ROWS = ((0, 5), (9, 1), (3, 2), (6, 0))


@pytest.fixture(scope="module")
def models():
    cfg = jprofiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, profiling(), load_npz(str(FIXTURE / "model.npz"), "cpu")


def _chunk_rows(c):
    base = np.array([r[0] for r in ROWS])
    valid = np.arange(c)[None, :] < np.array([r[1] for r in ROWS])[:, None]
    return base, valid


@pytest.mark.parametrize("window", [0, 6])
def test_attn_prefill_chunk_matches_reference(window):
    b, c, d, h, kv, hd, cap = len(ROWS), 5, 32, 4, 2, 8, 12
    rng = np.random.default_rng(window)
    p = {k: (rng.normal(size=shp) * 0.2).astype(np.float32)
         for k, shp in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                        ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}
    x = rng.normal(size=(b, c, d)).astype(np.float32)
    k0, v0 = (rng.normal(size=(b, cap, kv, hd)).astype(np.float32)
              for _ in range(2))
    base, valid = _chunk_rows(c)
    kw = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, rope_theta=1e4,
              window=window)
    jy, jc = JA.attn_prefill_chunk(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(base, jnp.int32), jnp.asarray(valid), **kw)
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy())}
    ty, tc = A.attn_prefill_chunk(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        cache, base, valid, **kw)
    assert tc["k"] is cache["k"]                         # updated in place
    live = valid.any(1)
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    for name, before in (("k", k0), ("v", v0)):
        got, want = tc[name].numpy(), np.asarray(jc[name])
        np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        # invalid tokens write nothing: every slot no valid token aims at
        # is bit-equal to the cache before the call
        written = np.zeros((b, cap), bool)
        for i, (b0, n) in enumerate(ROWS):
            written[i, (b0 + np.arange(n)) % cap] = True
        np.testing.assert_array_equal(got[~written], before[~written])


def _buddies(rng, cfg, tables, tier: bool):
    n, e = cfg.num_layers, cfg.moe.num_experts
    arrays = [rng.random((n, e)) < 0.5, tables.table, tables.q,
              np.zeros((n, e), np.int32)]
    extra = {"quant_ok": rng.random((n, e)) < 0.6} if tier else {}
    jb = JM.BuddyState(*map(jnp.asarray, arrays),
                       **{k: jnp.asarray(v) for k, v in extra.items()})
    tb = M.BuddyState(*[torch.from_numpy(np.array(a)) for a in arrays],
                      **{k: torch.from_numpy(v) for k, v in extra.items()})
    return jb, tb


@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_prefill_chunk_matches_reference(models, fused, tier):
    """Two mixed chunk steps through both stacks, the second reading the
    first's cache: logits, caches, counters and per-slot masks."""
    cfg, jp, pcfg, tp = models
    pol_kw = dict(tau=0.1, beta=1.1, rho=3, use_fused_dispatch=fused,
                  quant_tier="int8" if tier else "off")
    if tier:
        jp, _ = jq.attach_quant_tier(cfg, jp, 8)
        tp, _ = pq.attach_quant_tier(pcfg, tp, 8)
    tables = jload_tables(TABLES)
    rng = np.random.default_rng(int(fused) * 2 + int(tier))
    c, cap = 5, 16
    jc = JT.init_caches(cfg, len(ROWS), cap)
    tc = T.init_caches(pcfg, len(ROWS), cap, device="cpu")
    fn = jax.jit(lambda p, t, cc, b, v, bud: JT.prefill_chunk(
        p, cfg, t, cc, b, v, policy=JPolicy(**pol_kw), buddies=bud,
        record=True))
    base, valid = _chunk_rows(c)
    n_sub = n_deg = 0
    for step in range(2):
        toks = rng.integers(0, cfg.vocab_size, (len(ROWS), c))
        jb, tb = _buddies(rng, cfg, tables, tier)
        jl, jc, jaux = fn(jp, jnp.asarray(toks, jnp.int32), jc,
                          jnp.asarray(base, jnp.int32), jnp.asarray(valid),
                          jb)
        tl, tc, taux = T.prefill_chunk(
            tp, pcfg, torch.from_numpy(toks), tc, base, valid,
            policy=BuddyPolicy(**pol_kw), buddies=tb, record=True)
        assert tl.shape == (len(ROWS), c, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jr, tr = jaux["recorded"][0], taux["recorded"][0]
        for k in SLOT_MASKS:
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]),
                                          err_msg=f"step {step}: {k}")
        for k in ("n_sub", "n_miss", "n_drop", "n_degraded",
                  "miss_per_expert"):
            np.testing.assert_array_equal(taux[k].numpy(),
                                          np.asarray(jaux[k]), err_msg=k)
        n_sub += int(taux["n_sub"])
        n_deg += int(taux["n_degraded"])
        base = base + valid.sum(1)
    assert n_sub > 0 and (n_deg > 0) == tier
    for g, w in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("window", [-1, 4])
def test_prefill_matches_reference(models, window):
    """The full-sequence prefill compute (forward_train's logits), with the
    config's window and with a sliding one, within LOGIT_TOL."""
    cfg, jp, pcfg, tp = models
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9))
    want = JT.prefill(jp, cfg, jnp.asarray(toks, jnp.int32), window=window)
    got = T.prefill(tp, pcfg, torch.from_numpy(toks), window=window)
    assert got.shape == (2, 9, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_prefill_chunk_refuses_rwkv():
    cfg = rwkv_reduced()
    with pytest.raises(ValueError, match="attention stacks only"):
        T.prefill_chunk({"embed": torch.zeros(4, 4)}, cfg,
                        torch.zeros(1, 2, dtype=torch.int64), None,
                        np.zeros(1), np.ones((1, 2), bool))


@pytest.mark.parametrize("fused", [False, True])
def test_chunked_equals_token_by_token(models, fused):
    """Inside torch: the same prompts fed in chunks of 4 (a partial last
    chunk) and one token per decode_step give the same last-token logits
    and the same caches, with full residency and substitution off."""
    _, _, cfg, tp = models
    pol = BuddyPolicy(mode="none", use_fused_dispatch=fused)
    n, e = cfg.num_layers, cfg.moe.num_experts
    tables = load_tables(TABLES)
    bud = M.BuddyState(torch.ones(n, e, dtype=torch.bool),
                       torch.from_numpy(tables.table),
                       torch.from_numpy(tables.q),
                       torch.zeros(n, e, dtype=torch.int32))
    b, p_len, chunk, ctx = 3, 11, 4, 14
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                (b, p_len))
    c1 = T.init_caches(cfg, b, ctx, device="cpu")
    for i in range(p_len):
        l1, c1, _ = T.decode_step(tp, cfg, torch.from_numpy(prompts[:, i]),
                                  c1, torch.full((b,), i), policy=pol,
                                  buddies=bud)
    c2 = T.init_caches(cfg, b, ctx, device="cpu")
    for p in range(0, p_len, chunk):
        n_tok = min(chunk, p_len - p)
        toks = np.zeros((b, chunk), np.int64)
        toks[:, :n_tok] = prompts[:, p:p + n_tok]
        valid = np.arange(chunk)[None, :].repeat(b, 0) < n_tok
        l2, c2, _ = T.prefill_chunk(tp, cfg, torch.from_numpy(toks), c2,
                                    np.full(b, p), valid, policy=pol,
                                    buddies=bud)
    torch.testing.assert_close(l2[:, n_tok - 1], l1, rtol=CHUNK_TOL,
                               atol=CHUNK_TOL)
    for a, w in zip(tree_leaves(c2), tree_leaves(c1)):
        torch.testing.assert_close(a, w, rtol=CHUNK_TOL, atol=CHUNK_TOL)


# ---------------------------------------------------------------------------
# The engine's prefill_rows
# ---------------------------------------------------------------------------
def _assert_same(a, b, path=""):
    """Equal structure; ints/bools/strings equal, floats allclose."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-15), \
            f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a} != {b}"


def _engines(models, fused):
    cfg, jp, pcfg, tp = models
    n, e = cfg.num_layers, cfg.moe.num_experts
    jc, pc = JCache(n, e, 0.5), ExpertCache(n, e, 0.5)
    jeng = JEngine(cfg, jp, tables=jload_tables(TABLES),
                   policy=JPolicy(use_fused_dispatch=fused), cache=jc,
                   predictor=JPred(n, e), prefetch_k=jc.capacity // 2)
    peng = ServeEngine(pcfg, tp, tables=load_tables(TABLES),
                       policy=BuddyPolicy(use_fused_dispatch=fused),
                       cache=pc, predictor=PrevStepPredictor(n, e),
                       prefetch_k=pc.capacity // 2)
    return jeng, peng


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_rows_matches_reference(models, fused):
    """The counterpart of the reference's
    test_prefill_rows_counts_valid_tokens_only, against the reference
    engine: a prefill row of 3 tokens and a decode row in one [2, 4] step,
    then a second step; only valid tokens are counted."""
    jeng, peng = _engines(models, fused)
    jcache, pcache = jeng.init_caches(2, 16), peng.init_caches(2, 16)
    toks = np.random.default_rng(3).integers(0, 512, (2, 2, 4))
    valid = np.array([[True, True, True, False], [True, False, False, False]])
    rows = np.array([True, True])
    for s, base in enumerate(([0, 5], [3, 6])):
        jl, jcache = jeng.prefill_rows(toks[s], rows, jcache,
                                       base_pos=np.array(base),
                                       tok_valid=valid)
        pl, pcache = peng.prefill_rows(toks[s], rows, pcache,
                                       base_pos=np.array(base),
                                       tok_valid=valid)
        assert pl.shape == (2, 4, 512)
        np.testing.assert_allclose(pl.numpy()[valid], np.asarray(jl)[valid],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert peng.stats.steps == 2 and peng.stats.tokens == 8     # 2 x (3 + 1)
    js, ps = jeng.summary(), peng.summary()
    _assert_same(js["stats"], ps["stats"])
    _assert_same(js["ledger"], ps["ledger"])
    _assert_same(js["stall_breakdown"], ps["stall_breakdown"])
    assert ps["stats"]["n_sub"] + ps["stats"]["n_miss_fetch"] > 0


def test_prefill_rows_refuses_to_wrap_the_ring(models):
    jeng, peng = _engines(models, False)
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(AssertionError, match="ring"):
        jeng.prefill_rows(toks, np.array([True]), jeng.init_caches(1, 6),
                          base_pos=np.array([4]))          # 4 + 4 > 6
    with pytest.raises(ValueError, match="ring"):
        peng.prefill_rows(toks, np.array([True]), peng.init_caches(1, 6),
                          base_pos=np.array([4]))
    # a single-token row at the wrap is a plain decode write
    peng.prefill_rows(toks, np.array([True]), peng.init_caches(1, 6),
                      base_pos=np.array([5]),
                      tok_valid=np.array([[True, False, False, False]]))
    assert peng.stats.steps == 1


def test_reset_rows_zeroes_only_those_rows(models):
    _, peng = _engines(models, False)
    caches = peng.init_caches(3, 8)
    for a in tree_leaves(caches):
        a.fill_(1.0)
    out = peng.reset_rows(caches, [0, 2])
    assert out is caches
    for a in tree_leaves(caches):
        assert float(a[:, [0, 2]].abs().sum()) == 0.0
        assert bool((a[:, 1] == 1.0).all())
