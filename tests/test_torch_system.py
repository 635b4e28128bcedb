"""The paper's qualitative claims held on the port, beside the JAX package's
numbers on the same inputs: the twin of tests/test_system.py.

Both packages load the committed fixture (results/bench/model.npz, the
profiling config: 2 layers, 64 experts, top-6, and its profile coact.npz).
The token streams are tests/test_system.py's own: one MarkovLM(seed=11)
drawn in the order its tests draw (similarity, errors, agreement, the two
engines' prompts, gates). Claims 3-6 run under two buddy tables: the
committed CFT tables tables_a0.95_k16.npz, and the tables
tests/test_system.py builds (CFT over co-activation and output
similarity, alpha 0.95, k_max 16), which the port builds equal to the
reference's. The reference's side of every claim is computed once, in the
module's ``ref`` fixture. For each claim, the port's number against the
reference's, then the claim's inequality on the port:

  1. routers specialise (Figs. 6/7/9): the recorder of ``record=True``
     forwards (a stream of its own, seed 21, 8 x 8 x 64 tokens as the
     fixture's profile); activation and co-activation counts equal, so
     Gini and top-r coverage equal too (the probability-weighted counts
     within 1e-5 relative: f32 probs ~1e-7 apart, summed)
  2. upcycled experts are redundant (Fig. 4): ``all_layer_similarities``
     within 1e-5
  3. a buddy changes a layer's output less than a random expert: the
     relative errors of the same (layer, expert, substitute) draws
     within 1e-5
  4. buddy substitution keeps top-1 agreement with the full model at
     least as well as a random table (Tables 2-4): teacher-forced
     ``forward_train(policy=, buddies=)`` under the buddy tables, the
     reference's random table and the port's own ``make_random_table``
     (each table given to both packages): n_sub equal, agreement within
     one token of B x S
  5. substitution moves fewer PCIe bytes than on-demand fetching (Fig. 8,
     Table 1): ``ServeEngine`` buddy against mode "none"; fetches,
     substitutions and bytes equal, modeled tokens/s within 1e-6
     relative (the host's simulated clock replays the same decisions)
  6. the gates restrict substitution: n_sub 0 under tau = 1 and under
     beta = 0, on both sides

Claim 4 is a property of the stream as much as of the tables: on a
second agreement stream (seed 13) buddy agreement falls below the
reference's random table's under both buddy tables, in both packages
alike. test_agreement_on_a_second_stream holds the port to the reference
there and asserts no direction.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import load_pytree  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro.core import BuddyPolicy as JPolicy  # noqa: E402
from repro.core import CoactivationRecorder as JRecorder  # noqa: E402
from repro.core import make_random_table as jmake_random_table  # noqa: E402
from repro.core import similarity as JS  # noqa: E402
from repro.core import build_buddy_lists as jbuild_buddy_lists  # noqa: E402
from repro.core.buddies import BuddyTables as JBuddyTables  # noqa: E402
from repro.core.buddies import load_tables as jload_tables  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.cache import ExpertCache as JCache  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core import (BuddyPolicy, BuddyTables,  # noqa: E402
                              CoactivationRecorder, build_buddy_lists,
                              make_random_table)
from repro_torch.core import similarity as S  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.training.data import MarkovLM  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = FIXTURE / "tables_a0.95_k16.npz"
SIM_ATOL = 1e-5            # cosine means in [-1, 1], f32 sums in another order
ERR_ATOL = 1e-5            # relative errors ~1, f32 matmuls in another order
W_RTOL = 1e-5              # weighted counts: sums of f32 probs ~1e-7 apart
Q_RTOL = 1e-4              # built tables' q: products of similarities
TPS_RTOL = 1e-6            # the modeled clock
B, S_LEN = 8, 48           # the agreement batch, as tests/test_system.py
AGREE_TOL = 1.0 / (B * S_LEN)
PROFILE_STEPS, PROFILE_BATCH, PROFILE_SEQ = 8, 8, 64   # as get_profile
POLICY = dict(tau=0.05, beta=1.1, rho=6, H=16, fallback="drop")
SERVE = {"buddy": dict(tau=0.0, beta=1.1, rho=6, H=16),
         "none": dict(mode="none")}
GATE_CASES = {"tau_1": dict(tau=1.0, beta=1.1, rho=6, H=16),
              "beta_0": dict(tau=0.0, beta=0.0, rho=6, H=16)}
TRIALS = 3
BUDDY_SETS = ("committed", "built")
RANDOM_SETS = ("random_ref", "random_port")
# tests/test_system.py's draws from MarkovLM(seed=11), in its order
STREAM_SEED = 11
STREAM = (("sims", (4, 64)), ("errs", (2, 64)), ("agree", (B, S_LEN)),
          ("serve_buddy", (2, 4)), ("serve_none", (2, 4)),
          ("gates", (2, 16)))
PROFILE_SEED, SECOND_AGREE_SEED = 21, 13


def _lm(seed):
    return MarkovLM(profiling().vocab_size, num_blocks=8, seed=seed)


def _stream() -> dict:
    lm = _lm(STREAM_SEED)
    return {name: lm.sample(*shape) for name, shape in STREAM}


def _residency(seed, l_n, e_n, trials):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(trials):
        resident = np.zeros((l_n, e_n), bool)
        for l in range(l_n):
            resident[l, rng.choice(e_n, e_n // 2, replace=False)] = True
        out.append(resident)
    return out


def _random_tables(l_n, e_n) -> dict:
    """The reference's random table (key 7) and the port's (seed 7), each
    tiled over the layers as tests/test_system.py tiles it."""
    jt, jq = jmake_random_table(jax.random.PRNGKey(7), e_n, 16)
    pt, pq = make_random_table(e_n, 16,
                               generator=torch.Generator().manual_seed(7))

    def tile(a):
        return np.tile(np.asarray(a)[None], (l_n, 1, 1))

    return {"random_ref": (tile(jt), tile(jq)),
            "random_port": (tile(pt.numpy()), tile(pq.numpy()))}


def _build(build, rec, sims):
    """tests/test_system.py's tables from the fixture's profile."""
    q = np.stack([rec.conditional(l) for l in range(rec.num_layers)])
    return build(q, alpha=0.95, k_max=16, activity=rec.A, output_sim=sims)


def _error_draws(activity, table):
    """(layer, expert, buddy, random expert) for every active expert with a
    buddy, the random substitutes drawn as tests/test_system.py draws
    them (numpy, seed 0)."""
    l_n, e_n = activity.shape
    rng = np.random.default_rng(0)
    draws = []
    for l in range(l_n):
        for i in range(e_n):
            if activity[l, i] <= 0 or table[l, i, 0] < 0:
                continue
            draws.append((l, i, int(table[l, i, 0]),
                          int(rng.choice([x for x in range(e_n) if x != i]))))
    return draws


def _rel_errs(moe_w, xs, draws, silu, norm):
    """||y_i - y_j|| / (||y_i|| + 1e-8) for each draw, both substitutes."""
    def out(l, e, x):
        h = silu(x @ moe_w["w1"][l][e]) * (x @ moe_w["w3"][l][e])
        return h @ moe_w["w2"][l][e]

    errs = {"buddy": [], "random": []}
    for l, i, jb, jr in draws:
        x = xs[l][:128]
        yi = out(l, i, x)
        for name, j in (("buddy", jb), ("random", jr)):
            errs[name].append(float(norm(yi - out(l, j, x))
                                    / (norm(yi) + 1e-8)))
    return {k: np.array(v) for k, v in errs.items()}


def _recorder(rec_cls, cfg, forward):
    lm = _lm(PROFILE_SEED)
    rec = rec_cls(cfg.num_layers, cfg.moe.num_experts)
    for _ in range(PROFILE_STEPS):
        per = forward(lm.sample(PROFILE_BATCH, PROFILE_SEQ))
        for l in range(cfg.num_layers):
            rec.update(l, np.asarray(per["indices"][l]),
                       np.asarray(per["probs"][l]))
        rec.step_done()
    return rec


def _claims(rec, cfg):
    """Claim 1's numbers: Gini and mean top-8 coverage per layer."""
    return [(rec.activation_skew(l)["gini"], rec.topr_coverage(l, 8).mean())
            for l in range(cfg.num_layers)]


def _agreement(forward, full_top1, tables, l_n, e_n) -> dict:
    """{(table set, trial): (top-1 agreement, n_sub)} over the residency
    draws of tests/test_system.py (seed 1); ``forward(resident, table, q)``
    returns (logits, n_sub)."""
    out = {}
    for name, (tab, q) in tables.items():
        for trial, resident in enumerate(_residency(1, l_n, e_n, TRIALS)):
            logits, n_sub = forward(resident, tab, q)
            out[name, trial] = (float((np.asarray(logits).argmax(-1)
                                       == full_top1).mean()), n_sub)
    return out


def _serve_numbers(eng) -> dict:
    return {"n_miss_fetch": eng.stats.n_miss_fetch, "n_sub": eng.stats.n_sub,
            "total_bytes": eng.ledger.total_bytes,
            "tokens_per_s": eng.stats.tokens_per_s}


def _gate_subs(run, l_n, e_n) -> dict:
    resident = _residency(3, l_n, e_n, 1)[0]
    return {name: run(pol, resident) for name, pol in GATE_CASES.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's side of every claim, computed once (each model call
    under jit: op-by-op dispatch compiles every op once per shape)."""
    cfg = jprofiling()
    params = load_pytree(str(FIXTURE / "model.npz"), jax.eval_shape(
        lambda: JT.init_params(cfg, jax.random.PRNGKey(0))))
    l_n, e_n = cfg.num_layers, cfg.moe.num_experts
    moe_w = params["groups"][0]["moe"]
    stream = _stream()
    out = {}
    # 1. the recorder
    fwd = jax.jit(lambda p, t: JT.forward_train(p, cfg, t, record=True))
    rec = _recorder(JRecorder, cfg, lambda t: fwd(params, jnp.asarray(t))[1]
                    ["recorded"][0])
    out["rec"], out["claims1"] = rec, _claims(rec, cfg)
    # 2. similarity: all_layer_similarities' two steps, with
    # collect_layer_inputs under jit
    collect = jax.jit(lambda p, t: JS.collect_layer_inputs(cfg, p, t))
    xs = collect(params, jnp.asarray(stream["sims"]))
    out["sims"] = sims = np.stack([JS.expert_output_similarity(
        {k: moe_w[k][l] for k in ("w1", "w3", "w2")}, xs[l][:512])
        for l in range(l_n)])
    profile = JRecorder.load(str(FIXTURE / "coact.npz"))
    built = _build(jbuild_buddy_lists, profile, sims)
    committed = jload_tables(str(TABLES))
    out["tables"] = tables = {
        "committed": (committed.table, committed.q),
        "built": (built.table, built.q), **_random_tables(l_n, e_n)}
    # 3. substitute errors
    xs = collect(params, jnp.asarray(stream["errs"]))
    out["draws"], out["errs"] = {}, {}
    for name in BUDDY_SETS:
        draws = _error_draws(profile.A, tables[name][0])
        out["draws"][name] = draws
        out["errs"][name] = _rel_errs(moe_w, xs, draws, jax.nn.silu,
                                      jnp.linalg.norm)
    # 4. agreement (one compiled forward for every table and draw)
    full = jax.jit(lambda p, t: JT.forward_train(p, cfg, t)[0])
    pol = JPolicy(**POLICY)
    sub = jax.jit(lambda p, t, bud: JT.forward_train(
        p, cfg, t, policy=pol, buddies=bud))
    for key, toks in (("agree", stream["agree"]),
                      ("agree_second", _lm(SECOND_AGREE_SEED).sample(
                          B, S_LEN))):
        toks = jnp.asarray(toks)
        top1 = np.asarray(full(params, toks)).argmax(-1)

        def forward(resident, tab, q):
            logits, aux = sub(params, toks, JM.BuddyState(
                jnp.asarray(resident), jnp.asarray(tab), jnp.asarray(q),
                jnp.zeros((l_n, e_n), jnp.int32)))
            return logits, int(aux["n_sub"])

        out[key + "_top1"] = top1
        out[key] = _agreement(forward, top1, tables, l_n, e_n)
    # 5. serving, and 6. the gates
    out["serve"], out["gates"] = {}, {}
    for name in BUDDY_SETS:
        tab, q = tables[name]
        bt = JBuddyTables(tab, q, (tab >= 0).sum(-1).astype(np.int32))
        out["serve"][name] = {}
        for mode, kw in SERVE.items():
            eng = JEngine(cfg, params, tables=bt, policy=JPolicy(**kw),
                          cache=JCache(l_n, e_n, 0.5, seed=2), seed=2)
            eng.generate(stream["serve_" + mode], max_new_tokens=6)
            out["serve"][name][mode] = _serve_numbers(eng)
        toks = jnp.asarray(stream["gates"])
        out["gates"][name] = _gate_subs(
            lambda p_kw, resident: int(jax.jit(
                lambda p, t, bud: JT.forward_train(
                    p, cfg, t, policy=JPolicy(**p_kw),
                    buddies=bud)[1]["n_sub"])(
                        params, toks, JM.BuddyState(
                            jnp.asarray(resident), jnp.asarray(tab),
                            jnp.asarray(q),
                            jnp.zeros((l_n, e_n), jnp.int32)))), l_n, e_n)
    return out


@pytest.fixture(scope="module")
def port():
    cfg = profiling()
    return cfg, load_npz(str(FIXTURE / "model.npz"), "cpu"), _stream()


def _buddy_state(resident, tab, q):
    l_n, e_n = resident.shape
    return M.BuddyState(torch.from_numpy(resident),
                        torch.from_numpy(np.array(tab)),
                        torch.from_numpy(np.array(q)),
                        torch.zeros((l_n, e_n), dtype=torch.int32))


def _port_agreement(params, cfg, toks, tables):
    """The port's full-model top-1 and _agreement on ``toks`` [B, S]."""
    l_n, e_n = cfg.num_layers, cfg.moe.num_experts
    toks = torch.from_numpy(toks)
    with torch.no_grad():
        top1 = T.forward_train(params, cfg, toks)[0].numpy().argmax(-1)

        def forward(resident, tab, q):
            logits, aux = T.forward_train(
                params, cfg, toks, policy=BuddyPolicy(**POLICY),
                buddies=_buddy_state(resident, tab, q))
            return logits.numpy(), int(aux["n_sub"])

        return top1, _agreement(forward, top1, tables, l_n, e_n)


def _assert_agreement_matches(got, want):
    for key, (a, n_sub) in got.items():
        want_a, want_n = want[key]
        assert n_sub == want_n, (key, n_sub, want_n)
        assert abs(a - want_a) <= AGREE_TOL, (key, a, want_a)
        assert n_sub > 0, key


def _mean_diffs(agree, buddy) -> dict:
    """Mean over the draws of buddy agreement minus each random table's."""
    return {rand: float(np.mean([agree[buddy, t][0] - agree[rand, t][0]
                                 for t in range(TRIALS)]))
            for rand in RANDOM_SETS}


# ------------------------------------------------------------------ claim 1
def test_router_specializes(ref, port):
    """Figs. 6/7/9 on the port's recorder."""
    cfg, params, _ = port
    with torch.no_grad():
        rec = _recorder(CoactivationRecorder, cfg, lambda t: T.forward_train(
            params, cfg, torch.from_numpy(t), record=True)[1]["recorded"][0])
    want = ref["rec"]
    np.testing.assert_array_equal(rec.A, want.A)
    np.testing.assert_array_equal(rec.M, want.M)
    np.testing.assert_allclose(rec.W, want.W, rtol=W_RTOL, atol=0)
    got = _claims(rec, cfg)
    assert got == ref["claims1"]
    e_n = cfg.moe.num_experts
    for gini, cov in got:
        assert gini > 0.02
        assert cov > 8 / (e_n - 1) * 1.5, \
            f"co-activation not concentrated: {cov}"


# ------------------------------------------------------------------ claim 2
def test_upcycled_experts_are_redundant(ref, port):
    """Fig. 4: substantial pairwise output similarity; the tables built on
    it equal the reference's."""
    cfg, params, stream = port
    sims = S.all_layer_similarities(cfg, params, stream["sims"])
    np.testing.assert_allclose(sims, ref["sims"], rtol=0, atol=SIM_ATOL)
    e_n = cfg.moe.num_experts
    off = sims[0][~np.eye(e_n, dtype=bool)]
    assert off.mean() > 0.2, f"no redundancy to exploit: {off.mean():.3f}"
    built = _build(build_buddy_lists, CoactivationRecorder.load(
        str(FIXTURE / "coact.npz")), sims)
    tab, q = ref["tables"]["built"]
    np.testing.assert_array_equal(built.table, tab)
    np.testing.assert_allclose(built.q, q, rtol=Q_RTOL, atol=0)


# ------------------------------------------------------------------ claim 3
@pytest.mark.parametrize("tables", BUDDY_SETS)
def test_buddies_are_better_substitutes_than_random(ref, port, tables):
    """Replacing expert i by its top buddy changes the layer output less
    than replacing it by a random expert."""
    cfg, params, stream = port
    xs = S.collect_layer_inputs(cfg, params, stream["errs"])
    activity = CoactivationRecorder.load(str(FIXTURE / "coact.npz")).A
    draws = _error_draws(activity, ref["tables"][tables][0])
    assert draws == ref["draws"][tables] and draws
    with torch.no_grad():
        errs = _rel_errs(params["groups"][0]["moe"], xs, draws,
                         torch.nn.functional.silu, torch.linalg.norm)
    for name in ("buddy", "random"):
        np.testing.assert_allclose(errs[name], ref["errs"][tables][name],
                                   rtol=0, atol=ERR_ATOL, err_msg=name)
    b, r = errs["buddy"].mean(), errs["random"].mean()
    assert b < r, f"buddy {b:.4f} !< random {r:.4f}"


# ------------------------------------------------------------------ claim 4
@pytest.mark.parametrize("tables", BUDDY_SETS)
def test_buddy_beats_random_end_to_end(ref, port, tables):
    """Tables 2-4 direction at c = 0.5: buddy substitution keeps top-1
    agreement with the full model at least as well as either random table
    (averaged over three residency draws)."""
    cfg, params, stream = port
    sets = {k: ref["tables"][k] for k in (tables,) + RANDOM_SETS}
    before = ops.launch_counts()
    top1, agree = _port_agreement(params, cfg, stream["agree"], sets)
    assert ops.launch_counts() == before          # CPU: the plain versions
    # the same top-1 as the reference's full model on every token
    np.testing.assert_array_equal(top1, ref["agree_top1"])
    _assert_agreement_matches(agree, ref["agree"])
    for rand, diff in _mean_diffs(agree, tables).items():
        assert diff > -0.005, f"buddy worse than {rand}: {diff}"


def test_agreement_on_a_second_stream(ref, port):
    """The agreement of claim 4 on a second stream (seed 13): the port's
    n_sub and agreement against the reference's under all four tables.
    No direction is asserted: here buddy agreement falls below the
    reference's random table's (the reference's numbers, which the port
    matches)."""
    cfg, params, _ = port
    toks = _lm(SECOND_AGREE_SEED).sample(B, S_LEN)
    top1, agree = _port_agreement(params, cfg, toks, ref["tables"])
    np.testing.assert_array_equal(top1, ref["agree_second_top1"])
    _assert_agreement_matches(agree, ref["agree_second"])
    for name in BUDDY_SETS:
        assert _mean_diffs(agree, name) == pytest.approx(
            _mean_diffs(ref["agree_second"], name), abs=AGREE_TOL)


# ------------------------------------------------------------------ claim 5
@pytest.mark.parametrize("tables", BUDDY_SETS)
def test_buddy_reduces_pcie_bytes(ref, port, tables):
    """Fig. 8 + Table 1: substitutions replace sync fetches, so fewer bytes
    and a higher modeled throughput."""
    cfg, params, stream = port
    l_n, e_n = cfg.num_layers, cfg.moe.num_experts
    tab, q = ref["tables"][tables]
    bt = BuddyTables(tab, q, (tab >= 0).sum(-1).astype(np.int32))
    got = {}
    for mode, kw in SERVE.items():
        eng = ServeEngine(cfg, params, tables=bt, policy=BuddyPolicy(**kw),
                          cache=ExpertCache(l_n, e_n, 0.5, seed=2), seed=2)
        eng.generate(stream["serve_" + mode], max_new_tokens=6)
        got[mode] = _serve_numbers(eng)
    for mode, row in got.items():
        want = ref["serve"][tables][mode]
        for k in ("n_miss_fetch", "n_sub", "total_bytes"):
            assert row[k] == want[k], (mode, k, row[k], want[k])
        assert row["tokens_per_s"] == pytest.approx(want["tokens_per_s"],
                                                    rel=TPS_RTOL)
    b, o = got["buddy"], got["none"]
    assert o["n_miss_fetch"] > 0 and b["n_sub"] > 0
    assert b["n_miss_fetch"] < o["n_miss_fetch"]
    assert b["total_bytes"] < o["total_bytes"]
    assert b["tokens_per_s"] > o["tokens_per_s"]


# ------------------------------------------------------------------ claim 6
@pytest.mark.parametrize("tables", BUDDY_SETS)
def test_gates_restrict_substitution(ref, port, tables):
    """tau = 1 forbids every token; beta = 0 bypasses at batch level; the
    same inputs with both gates open do substitute."""
    cfg, params, stream = port
    l_n, e_n = cfg.num_layers, cfg.moe.num_experts
    tab, q = ref["tables"][tables]
    toks = torch.from_numpy(stream["gates"])

    def n_sub(pol, resident):
        with torch.no_grad():
            return int(T.forward_train(
                params, cfg, toks, policy=BuddyPolicy(**pol),
                buddies=_buddy_state(resident, tab, q))[1]["n_sub"])

    got = _gate_subs(n_sub, l_n, e_n)
    assert got == ref["gates"][tables] == {"tau_1": 0, "beta_0": 0}
    opened = _gate_subs(lambda pol, resident: n_sub(
        dict(pol, tau=0.0, beta=1.1), resident), l_n, e_n)
    assert all(n > 0 for n in opened.values()), opened
