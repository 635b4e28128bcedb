"""The port's live placement (``runtime/placement.py``'s
PlacementController attached to the engine) against the JAX package's, on
live reference calls on the committed fixture (results/bench/model.npz,
tables_a0.95_k16.npz; int8 tier, PrevStepPredictor, 12 seeded Poisson
requests of 8 new tokens through the continuous scheduler in chunks of 4,
a placement tick every 50 simulated us):

  * coverage 0.25 and 0.5, D = 1 and D = 2: the same tokens per request,
    an equal ``summary()["placement"]`` (ticks, coverage re-picks,
    replicas issued and reclaimed, peer pushes, the per-tick trace) and an
    equal tier coverage mask at the end;
  * a coverage re-pick moves no device tensor: every parameter tensor,
    the int8 replicas included, keeps its ``data_ptr`` and its values;
  * ``reset_runtime`` re-attaches the controller with its configuration.

The cache budgets sit above the expert count (cache rate 1.1 and 1.3; the
tier displaces part of that budget): make-before-break defers a re-pick
until every expert about to lose its replica is resident, so on a smaller
cache this short run would issue replicas but never re-pick. Counts and
the placement summary are exact (the host replays the same decisions);
the tier's ``mean_fidelity_loss`` (f32 quantization-error sums in another
order) is not compared here; tests/test_torch_tier_engine.py holds it."""
import json
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
from repro.runtime.placement import PlacementController as JController  # noqa: E402
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.runtime.tiers import TieredExpertStore as JStore  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.runtime.placement import PlacementController  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.runtime.tiers import TieredExpertStore  # noqa: E402
from repro_torch.serving import scheduler as S  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = str(FIXTURE / "tables_a0.95_k16.npz")
INTERVAL_S = 5e-5
# name: (tier coverage, n_devices, cache rate)
CASES = {
    "cov25_d1": (0.25, 1, 1.1),
    "cov25_d2": (0.25, 2, 1.1),
    "cov50_d1": (0.5, 1, 1.3),
    "cov50_d2": (0.5, 2, 1.1),
}


@pytest.fixture(scope="module")
def weights():
    cfg = jprofiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, profiling(), load_npz(str(FIXTURE / "model.npz"), "cpu")


def _engine(weights, mod, name, **ctrl_kw):
    cov, d, rate = CASES[name]
    cfg, jp, pcfg, tp = weights
    if mod == "jax":
        c, p, eng, ctrl, pred, pol, lt, store = (
            cfg, jp, JEngine, JController, JPred, JPolicy, jload_tables,
            JStore)
    else:
        c, p, eng, ctrl, pred, pol, lt, store = (
            pcfg, tp, ServeEngine, PlacementController, PrevStepPredictor,
            BuddyPolicy, load_tables, TieredExpertStore)
    n, e = c.num_layers, c.moe.num_experts
    tier = store(n, e, rate, bits=8, d_model=c.d_model, d_ff=c.moe.d_ff,
                 coverage=cov)
    # the profiling draw the live ranking is to replace
    tier.set_coverage(np.random.default_rng(3).random((n, e)))
    kw = dict(refresh_interval_s=INTERVAL_S, hot_windows=1,
              replicate_margin=1.0, **ctrl_kw)
    return eng(c, p, tables=lt(TABLES), policy=pol(quant_tier="int8"),
               tier=tier, predictor=pred(n, e),
               prefetch_k=max(1, tier.cache.capacity // 2), n_devices=d,
               placement=ctrl(**kw))


def _serve(eng, smod):
    lm = MarkovLM(512, seed=1)
    rng = np.random.default_rng(1)
    prompts = [lm.sample(1, int(rng.integers(4, 12)))[0] for _ in range(12)]
    reqs = smod.make_requests(prompts, smod.PoissonArrivals(2000.0, seed=2),
                              8)
    s = smod.ContinuousScheduler(eng, slots=4, prefill_chunk=4).run(
        smod.RequestQueue(reqs))
    return [r.tokens for r in reqs], json.loads(json.dumps(s, default=str))


@pytest.mark.parametrize("name", list(CASES))
def test_placement_matches_reference(weights, name):
    jeng = _engine(weights, "jax", name)
    jtok, js = _serve(jeng, JS)
    peng = _engine(weights, "torch", name)
    ptok, ps = _serve(peng, S)
    assert ptok == jtok
    assert ps["completed"] == 12
    p = ps["engine"]["placement"]
    assert p == js["engine"]["placement"]
    np.testing.assert_array_equal(peng.tier.covered, np.asarray(
        jeng.tier.covered))
    assert ps["engine"]["stats"] == js["engine"]["stats"]
    assert p["n_ticks"] > 0
    assert p["coverage_repicks"] + p["replicas_issued"] > 0
    if CASES[name][1] > 1:
        assert p["peer_pushes"] > 0
    if name in ("cov25_d1", "cov50_d1"):
        assert p["coverage_repicks"] > 0


def _tensors(tree, out):
    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def test_repick_moves_no_device_tensor(weights):
    eng = _engine(weights, "torch", "cov25_d1")
    before = [(t.data_ptr(), t.clone()) for t in _tensors(eng.params, [])]
    quant = _tensors([g["moe"]["quant"] for g in eng.params["groups"]
                      if "moe" in g], [])
    assert quant, "the int8 replicas are not among the params"
    covered0 = eng.tier.covered.copy()
    _serve(eng, S)
    assert eng.placement.n_coverage_repicks > 0
    assert not np.array_equal(eng.tier.covered, covered0)
    after = _tensors(eng.params, [])
    assert len(after) == len(before)
    for (ptr, val), t in zip(before, after):
        assert t.data_ptr() == ptr
        assert torch.equal(t, val)


def test_reset_runtime_reattaches_controller(weights):
    eng = _engine(weights, "torch", "cov25_d2", hot_top_k=3,
                  max_replicas_per_layer=1)
    _serve(eng, S)
    ctrl = eng.placement
    assert ctrl.n_ticks > 0
    eng.reset_runtime()
    s = eng.summary()["placement"]
    assert (s["n_ticks"], s["coverage_repicks"], s["replicas_issued"],
            s["peer_pushes"], s["trace"]) == (0, 0, 0, 0, [])
    assert (s["hot_top_k"], s["max_replicas_per_layer"],
            s["refresh_interval_s"]) == (3, 1, INTERVAL_S)
    assert ctrl.stats.used_ema.sum() == 0.0
