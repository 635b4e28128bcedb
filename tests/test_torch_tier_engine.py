"""The port's ServeEngine with the quant tier against the JAX package's, on
the committed fixture (results/bench/model.npz with tables_a0.95_k16.npz;
cache-rate 0.5, PrevStepPredictor, batch 4, 8 prompt + 8 greedy new tokens):
the same tokens, ``stats``, ledger and tier counters. Floats on the
simulated clock are held to rel 1e-9 (the host timeline replays the same
decisions); the tier's ``mean_fidelity_loss`` to rel 1e-5 (f32 sums in
another order); teacher-forced NLL to rel 1e-5 (f32 log-softmax over
logits that agree to ~1e-6). Also ``reset_runtime``, the tier's
configuration errors and the serve launcher's tier flags."""
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
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.runtime.tiers import TieredExpertStore as JStore  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.runtime.tiers import TieredExpertStore  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = str(FIXTURE / "tables_a0.95_k16.npz")
FID_TOL = 1e-5
# name: (policy kwargs, store kwargs, engine kwargs). int4 replicas have a
# fidelity loss near 0.1, so at the default 0.05 s per unit a 0.5 ms cold
# miss never buys it: the int4 case lowers the exchange rate.
CASES = {
    "fused_int8": (dict(quant_tier="int8", use_fused_dispatch=True),
                   dict(bits=8), {}),
    "gather_int8_half_coverage": (dict(quant_tier="int8"),
                                  dict(bits=8, coverage=0.5), {}),
    "fused_int4_low_exchange_rate": (
        dict(quant_tier="int4", use_fused_dispatch=True),
        dict(bits=4, stall_per_fidelity=1e-3), {}),
    "cost_upgrade_gather": (dict(quant_tier="int8", miss_policy="cost",
                                 stall_per_quality=0.05),
                            dict(bits=8), dict(upgrade_degraded=True)),
}


def _close(a, b, path, rel=1e-9):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}",
                   FID_TOL if k == "mean_fidelity_loss" else rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rel, abs_tol=1e-15), \
            f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a} != {b}"


def _engines(policy_kw, store_kw, engine_kw, cache_rate=0.5):
    cfg, pcfg = jprofiling(), profiling()
    n, e = cfg.num_layers, cfg.moe.num_experts
    kw = dict(d_model=cfg.d_model, d_ff=cfg.moe.d_ff, **store_kw)
    jt, pt = JStore(n, e, cache_rate, **kw), TieredExpertStore(n, e,
                                                               cache_rate,
                                                               **kw)
    act = np.random.default_rng(5).random((n, e))
    jt.set_coverage(act)
    pt.set_coverage(act)
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    k = max(1, jt.cache.capacity // 2)
    jeng = JEngine(cfg, jp, tables=jload_tables(TABLES), tier=jt,
                   policy=JPolicy(**policy_kw), predictor=JPred(n, e),
                   prefetch_k=k, **engine_kw)
    peng = ServeEngine(pcfg, load_npz(str(FIXTURE / "model.npz"), "cpu"),
                       tables=load_tables(TABLES), tier=pt,
                       policy=BuddyPolicy(**policy_kw),
                       predictor=PrevStepPredictor(n, e), prefetch_k=k,
                       **engine_kw)
    return cfg, jeng, peng


@pytest.mark.parametrize("name", list(CASES))
def test_tier_engine_matches_reference(name):
    cfg, jeng, peng = _engines(*CASES[name])
    prompts = MarkovLM(cfg.vocab_size, seed=0).sample(4, 8)
    np.testing.assert_array_equal(peng.generate(prompts, 8),
                                  jeng.generate(prompts, 8))
    js, ps = jeng.summary(), peng.summary()
    for key in ("stats", "ledger", "stall_breakdown", "tier"):
        _close(js[key], ps[key], key)
    assert js.get("cost_policy") == ps.get("cost_policy")
    assert ps["tier"]["degraded_tokens"] > 0     # the tier served slots
    assert ps["ledger"]["events"]["degraded"] == \
        ps["tier"]["degraded_tokens"]
    if name.startswith("cost"):
        assert ps["stats"]["n_upgrade_issued"] > 0


def test_teacher_forced_nll_and_reset_runtime_match_reference():
    """The tier's accuracy measure, then a reset: fresh counters, the
    one-time upload paid again, the same decisions on a second run."""
    cfg, jeng, peng = _engines(*CASES["gather_int8_half_coverage"])
    toks = MarkovLM(cfg.vocab_size, seed=3).sample(3, 10)
    mask = np.array([True, True, False])
    jn, pn = (e.teacher_forced_nll(toks, row_mask=mask) for e in (jeng, peng))
    assert math.isclose(pn, jn, rel_tol=1e-5), (pn, jn)
    first = peng.summary()
    for eng in (jeng, peng):
        eng.reset_runtime()
    fresh = peng.summary()
    assert fresh["stats"]["steps"] == 0
    assert fresh["tier"]["degraded_tokens"] == 0
    assert fresh["ledger"]["bytes"] == {"tier_upload":
                                        peng.tier.quant_bytes}
    assert peng.cache is peng.tier.cache
    assert peng.cache.capacity == first["tier"]["tier_budget_split"][
        "cache_slots_per_layer"]
    prompts = MarkovLM(cfg.vocab_size, seed=0).sample(4, 8)
    np.testing.assert_array_equal(peng.generate(prompts, 6),
                                  jeng.generate(prompts, 6))
    js, ps = jeng.summary(), peng.summary()
    for key in ("stats", "ledger", "tier"):
        _close(js[key], ps[key], key)


@pytest.mark.parametrize("kw", [
    dict(policy=BuddyPolicy(), tier="int8"),           # tier, tier off
    dict(policy=BuddyPolicy(quant_tier="int8")),        # tier on, no store
    dict(policy=BuddyPolicy(quant_tier="int4"), tier="int8"),  # bits differ
    dict(policy=BuddyPolicy(quant_tier="int8"), tier="int8",
         cache="own")])                                 # cache not the tier's
def test_tier_misconfiguration_raises(kw):
    cfg = profiling()
    kw = dict(kw)
    if "tier" in kw:
        kw["tier"] = TieredExpertStore(cfg.num_layers, cfg.moe.num_experts,
                                       0.5, bits=8, d_model=cfg.d_model,
                                       d_ff=cfg.moe.d_ff)
    if kw.get("cache") == "own":
        kw["cache"] = ExpertCache(cfg.num_layers, cfg.moe.num_experts, 0.5)
    with pytest.raises(ValueError):
        ServeEngine(cfg, load_npz(str(FIXTURE / "model.npz"), "cpu"), **kw)


@pytest.mark.parametrize("flags", [
    ["--quant-tier", "int8", "--tier-coverage", "0.5", "--fused-dispatch"],
    ["--quant-tier", "int4", "--stall-per-quality", "1e-3",
     "--miss-policy", "cost", "--upgrade-degraded", "on"]])
def test_serve_tier_flags_on_cpu(flags, capsys):
    serve.main(["--reduced", "--device", "cpu", "--layers", "1",
                "--batch", "2", "--steps", "3", *flags])
    out = capsys.readouterr().out
    s = json.loads(out[:out.index("\nstalls:")])
    assert s["policy"]["quant_tier"] == flags[1]
    assert s["tier"]["bits"] == int(flags[1][-1])
    assert s["tier"]["degraded_tokens"] > 0
    assert "tier: " in out
    if "--tier-coverage" in flags:
        assert s["tier"]["tier_budget_split"]["coverage"] == 0.5
    else:
        assert s["cost_policy"]["upgrade_degraded"] is True


def test_serve_rejects_bad_coverage(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--quant-tier", "int8", "--tier-coverage", "0"])
    assert "--tier-coverage" in capsys.readouterr().err
