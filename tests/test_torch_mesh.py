"""The port's simulated expert-parallel mesh (``n_devices`` 2-8 on the
engine: peer HBM pools behind their own ICI links on the one event clock,
the fifth miss outcome, peer borrowing) against the JAX package's, on live
reference calls on the committed fixture (results/bench/model.npz,
tables_a0.95_k16.npz; cache-rate 0.5, PrevStepPredictor, batch 4, 8 prompt
+ 8 greedy new tokens):

  * D = 2 and D = 4, precedence and cost (with and without the eta/kappa
    terms of Psi, which read the hop vector the mesh re-seeds), an int8
    tier beside the peers, an ICI bandwidth override and
    ``peer_borrow=False``: the same tokens and an equal ``summary()``
    (``stats``, ``stall_breakdown``, ledger, ``mesh`` with its per-link
    digests, and the telemetry section with its ``peer`` calibration row);
  * the continuous scheduler at D = 4, which advances every link between
    steps;
  * peer borrows fire at D = 4, and their bytes and stalls add up;
  * ``reset_runtime`` keeps the mesh (and the next run still equals the
    reference's);
  * D = 1 has no ``mesh`` key and no peer stall.

Every comparison is exact but for the int8 tier's ``mean_fidelity_loss``
and the degraded calibration row's ``quality_cost_mean`` (rel 1e-5: f32
quantization-error sums in another order on each package, as in
tests/test_torch_tier_engine.py)."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import load_pytree  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro.core.buddies import load_tables as jload_tables  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.cache import ExpertCache as JCache  # noqa: E402
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.runtime.telemetry import Telemetry as JTele  # noqa: E402
from repro.runtime.tiers import TieredExpertStore as JStore  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.runtime.telemetry import Telemetry  # noqa: E402
from repro_torch.runtime.tiers import TieredExpertStore  # noqa: E402
from repro_torch.serving import scheduler as S  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = str(FIXTURE / "tables_a0.95_k16.npz")
FID_TOL = 1e-5
FID_PATHS = ("/tier/mean_fidelity_loss",
             "/telemetry/calibration/degraded/quality_cost_mean")
COST = dict(miss_policy="cost", stall_per_quality=2e-4)
# name: (n_devices, policy kwargs, engine kwargs, int8 tier coverage)
CASES = {
    "d2_precedence": (2, dict(), {}, None),
    "d4_precedence_fused": (4, dict(use_fused_dispatch=True), {}, None),
    "d2_cost": (2, COST, {}, None),
    "d4_cost_eta_kappa": (4, dict(COST, eta=0.1, kappa=0.05,
                                  use_fused_dispatch=True), {}, None),
    "d4_precedence_int8": (4, dict(quant_tier="int8"), {}, 0.5),
    "d4_cost_ici_50gbps": (4, COST, dict(ici_gbps=50.0), None),
    "d4_cost_no_peer_borrow": (4, COST, dict(peer_borrow=False), None),
}


def _jsonable(x):
    return json.loads(json.dumps(x, default=str))


def _assert_summary(a, b, path=""):
    """Equal, exactly, but for the FID_PATHS floats (at FID_TOL)."""
    if any(path.endswith(p) for p in FID_PATHS):
        assert math.isclose(a, b, rel_tol=FID_TOL), f"{path}: {a} != {b}"
    elif isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_summary(a[k], b[k], f"{path}/{k}")
    else:
        assert a == b, f"{path}: {a} != {b}"


@pytest.fixture(scope="module")
def weights():
    cfg = jprofiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, profiling(), load_npz(str(FIXTURE / "model.npz"), "cpu")


def _engine(weights, mod, name):
    d, policy_kw, engine_kw, coverage = CASES[name]
    cfg, jp, pcfg, tp = weights
    if mod == "jax":
        c, p, eng, cache, pred, pol, lt, store, tele = (
            cfg, jp, JEngine, JCache, JPred, JPolicy, jload_tables, JStore,
            JTele)
    else:
        c, p, eng, cache, pred, pol, lt, store, tele = (
            pcfg, tp, ServeEngine, ExpertCache, PrevStepPredictor,
            BuddyPolicy, load_tables, TieredExpertStore, Telemetry)
    n, e = c.num_layers, c.moe.num_experts
    tier = ec = None
    if coverage is not None:
        tier = store(n, e, 0.5, bits=8, d_model=c.d_model, d_ff=c.moe.d_ff,
                     coverage=coverage)
        tier.set_coverage(np.random.default_rng(3).random((n, e)))
        capacity = tier.cache.capacity
    else:
        ec = cache(n, e, 0.5)
        capacity = ec.capacity
    return eng(c, p, tables=lt(TABLES), policy=pol(**policy_kw), cache=ec,
               tier=tier, predictor=pred(n, e),
               prefetch_k=max(1, capacity // 2), n_devices=d,
               telemetry=tele(num_layers=n, num_experts=e), **engine_kw)


def _generate(eng, seed=0):
    toks = eng.generate(MarkovLM(512, seed=seed).sample(4, 8), 8)
    return np.asarray(toks), _jsonable(eng.summary())


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_reference(weights, name):
    jt, js = _generate(_engine(weights, "jax", name))
    eng = _engine(weights, "torch", name)
    pt, ps = _generate(eng)
    np.testing.assert_array_equal(pt, jt)
    _assert_summary(ps, js)
    m = ps["mesh"]
    assert m["n_devices"] == CASES[name][0]
    assert len(m["links"]) == m["n_devices"] - 1
    assert ps["stall_breakdown"]["peer_stall_s"] == m["peer_stall_s"]
    if "no_peer_borrow" in name:
        assert m["n_peer_borrow"] == 0 and m["peer_borrow"] is False
    else:
        assert m["n_peer_borrow"] > 0
    if "ici" in name:
        assert m["ici_bw"] == 50e9


def _borrow_checks(eng, s):
    m = s["mesh"]
    assert m["n_peer_borrow"] > 0, "the fifth outcome never fired"
    assert m["peer_stall_s"] > 0.0
    assert [u["name"] for u in m["links"]] == ["ici1", "ici2", "ici3"]
    peer_bytes = sum(u["bytes_by_cause"].get("peer", 0) for u in m["links"])
    assert peer_bytes == m["n_peer_borrow"] * eng._expert_bytes
    assert s["telemetry"]["calibration"]["peer"]["n"] == m["n_peer_borrow"]
    assert s["telemetry"]["metrics"]["slots"]["outcome=peer"] >= \
        m["n_peer_borrow"]


@pytest.mark.parametrize("name", ["d4_precedence_fused", "d4_cost_eta_kappa"])
def test_peer_borrows_fire_at_four_devices(weights, name):
    eng = _engine(weights, "torch", name)
    _, s = _generate(eng)
    _borrow_checks(eng, s)


def test_continuous_mesh_matches_reference(weights):
    out = {}
    for mod, smod in (("jax", JS), ("torch", S)):
        eng = _engine(weights, mod, "d4_cost_eta_kappa")
        lm = MarkovLM(512, seed=1)
        rng = np.random.default_rng(1)
        prompts = [lm.sample(1, int(rng.integers(4, 12)))[0]
                   for _ in range(6)]
        reqs = smod.make_requests(prompts, smod.PoissonArrivals(2000.0,
                                                                seed=2), 4)
        s = smod.ContinuousScheduler(eng, slots=3, prefill_chunk=4).run(
            smod.RequestQueue(reqs))
        out[mod] = ([r.tokens for r in reqs], _jsonable(s), eng)
    assert out["torch"][0] == out["jax"][0]
    _assert_summary(out["torch"][1], out["jax"][1])
    s = out["torch"][1]
    assert s["completed"] == 6
    _borrow_checks(out["torch"][2], s["engine"])


def test_reset_runtime_keeps_mesh(weights):
    runs = {}
    for mod in ("jax", "torch"):
        eng = _engine(weights, mod, "d4_precedence_fused")
        _generate(eng)
        eng.reset_runtime()
        assert eng.cache.n_devices == 4
        assert sorted(eng.peer_links) == [1, 2, 3]
        assert all(link.busy_s == 0.0 for link in eng.peer_links.values())
        assert eng.summary()["mesh"]["n_peer_borrow"] == 0
        runs[mod] = _generate(eng, seed=3)
    np.testing.assert_array_equal(runs["torch"][0], runs["jax"][0])
    _assert_summary(runs["torch"][1], runs["jax"][1])
    assert runs["torch"][1]["mesh"]["n_peer_borrow"] > 0


def test_single_device_has_no_mesh_section(weights):
    _, _, pcfg, tp = weights
    n, e = pcfg.num_layers, pcfg.moe.num_experts
    summaries = []
    for kw in ({}, dict(n_devices=1)):
        eng = ServeEngine(pcfg, tp, tables=load_tables(TABLES),
                          cache=ExpertCache(n, e, 0.5),
                          predictor=PrevStepPredictor(n, e), prefetch_k=16,
                          **kw)
        assert eng.peer_links == {}
        assert "peer_stall_s" not in eng.stall_breakdown()
        summaries.append(_generate(eng))
    assert "mesh" not in summaries[1][1]
    np.testing.assert_array_equal(summaries[0][0], summaries[1][0])
    assert summaries[0][1] == summaries[1][1]
