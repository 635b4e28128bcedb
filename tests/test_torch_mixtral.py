"""The port serving Mixtral against the JAX package, on ``mixtral-8x7b`` and
``mixtral-8x22b`` reduced (2 layers, d_model 256, 4 query heads over 2 KV
heads, 4 experts x 512, top-2, no shared expert, sliding window 128), with
the reference's random weights carried across by
``checkpoint/io.params_from_numpy`` (``build_model``, which
tests/test_torch_mixtral_{tier,continuous}.py share with this file): the
port's buddy profiling equals the reference launcher's, and
``ServeEngine`` serves a batch of 4 past the 128-token window as the
reference engine does: a 128-token prompt prefilled in chunks of 8
(``prefill_rows``, T = 32: the dropless capacity branch or the fused
dispatch), then 8 greedy decode steps (``step``, T = 4: T*K = 8 >= E = 4,
so the capacity branch), on the capacity path, the same with the ring cut
to the window (so decode wraps it), and the fused dispatch. Equal tokens,
``stats``, ledger and stall breakdown (floats on the simulated clock to
rel 1e-9). The int8 tier's paths: tests/test_torch_mixtral_tier.py;
token-by-token ``generate``, continuous serving, the paged-KV refusal and
the launcher: tests/test_torch_mixtral_continuous.py."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten_with_paths  # noqa: E402
from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.launch.serve import profile_buddies as jprofile  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.cache import ExpertCache as JCache  # noqa: E402
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.runtime.tiers import TieredExpertStore as JStore  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core.buddies import BuddyTables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.runtime.tiers import TieredExpertStore  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCHS = ["mixtral-8x7b", "mixtral-8x22b"]
FID_TOL = 1e-5
PROMPT, NEW, CHUNK = 128, 8, 8    # decode at 128..135: past the window


def close(a, b, path="", rel=1e-9):
    """Equal structure; ints/bools/strings equal, floats allclose."""
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            close(a[k], b[k], f"{path}/{k}",
                  FID_TOL if k == "mean_fidelity_loss" else rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]", rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rel, abs_tol=1e-15), \
            f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a} != {b}"


def build_model(arch: str) -> dict:
    """Both packages' configs and weights, and the reference launcher's
    buddy profile (and the port's own, to hold against it)."""
    jcfg, cfg = jreduced(arch), get_reduced(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jp).items()}
    lm_kw = dict(vocab_size=cfg.vocab_size, seed=0)
    jtables, jrec = jprofile(jcfg, jp, MarkovLM(**lm_kw))
    tp = params_from_numpy(flat, "cpu")
    tables, rec = serve.profile_buddies(cfg, tp, MarkovLM(**lm_kw))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jp=jp, tp=tp,
                jtables=jtables, tables=tables, activity=jrec.A,
                port_activity=rec.A)


def engines(model, policy_kw, tier_kw, engine_kw):
    """(reference engine, port engine) on the same weights and tables,
    cache-rate 0.5, PrevStepPredictor; with ``tier_kw`` a tier store whose
    coverage the reference profile's activity ranks."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    n, e = jcfg.num_layers, jcfg.moe.num_experts
    out = []
    for Eng, Pol, Cache, Store, Pred, cfg_, params, tables in (
            (JEngine, JPolicy, JCache, JStore, JPred, jcfg, model["jp"],
             model["jtables"]),
            (ServeEngine, BuddyPolicy, ExpertCache, TieredExpertStore,
             PrevStepPredictor, cfg, model["tp"],
             BuddyTables(*model["jtables"]))):
        tier = None
        if tier_kw:
            tier = Store(n, e, 0.5, d_model=cfg_.d_model, d_ff=cfg_.moe.d_ff,
                         **tier_kw)
            tier.set_coverage(model["activity"])
        cache = tier.cache if tier else Cache(n, e, 0.5)
        out.append(Eng(cfg_, params, tables=tables, policy=Pol(**policy_kw),
                       cache=None if tier else cache, tier=tier,
                       predictor=Pred(n, e),
                       prefetch_k=max(1, cache.capacity // 2), **engine_kw))
    return out


def assert_summaries(jeng, peng, tier: bool):
    """Equal stats, ledger, stall breakdown, cost-policy (and tier)
    summaries; returns the port's stats."""
    js, ps = jeng.summary(), peng.summary()
    for key in ("stats", "ledger", "stall_breakdown", "cost_policy"):
        close(js.get(key), ps.get(key), key)
    if tier:
        close(js["tier"], ps["tier"], "tier")
        assert ps["tier"]["degraded_tokens"] > 0
    st = ps["stats"]
    assert st["n_hit"] + st["n_sub"] + st["n_miss_fetch"] > 0
    return st


def serve_chunked(eng, prompts, tokens):
    """Prefill ``prompts`` [B, P] in CHUNK-token steps, then NEW - 1 greedy
    lockstep decode steps; returns the NEW sampled tokens [B, NEW].
    ``tokens`` makes the engine's token array from a host one."""
    b, p_len = prompts.shape
    caches = eng.init_caches(b, p_len + NEW)
    rows = np.ones(b, bool)
    for p0 in range(0, p_len, CHUNK):
        logits, caches = eng.prefill_rows(prompts[:, p0:p0 + CHUNK], rows,
                                          caches, np.full(b, p0))
    out = [eng.sample_tokens(logits[:, -1], True)]
    for pos in range(p_len, p_len + NEW - 1):
        logits, caches = eng.step(tokens(out[-1]), caches, pos)
        out.append(eng.sample_tokens(logits, True))
    return np.stack([np.asarray(t) for t in out], 1)


def check_batch_serving(model, policy_kw, tier_kw, engine_kw):
    """A batch of 4 served past the window by both engines: equal tokens
    and summaries. Returns the port's stats."""
    jeng, peng = engines(model, policy_kw, tier_kw, engine_kw)
    prompts = MarkovLM(model["cfg"].vocab_size, seed=3).sample(4, PROMPT)
    np.testing.assert_array_equal(
        serve_chunked(peng, prompts, peng._tokens),
        serve_chunked(jeng, prompts, lambda t: jnp.asarray(t, jnp.int32)))
    st = assert_summaries(jeng, peng, bool(tier_kw))
    assert st["steps"] == PROMPT // CHUNK + NEW - 1
    return st

# name: (policy kwargs, engine kwargs); the int8 tier's cases are in
# tests/test_torch_mixtral_tier.py
CASES = {
    "capacity": (dict(), {}),
    "capacity_ring_wrap": (dict(), dict(window=128)),
    "fused": (dict(use_fused_dispatch=True), {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the reduced model's ops
    are tiny, and six test workers each spinning the machine's every core
    slowed them several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return build_model(request.param)


def test_profiling_matches_reference(model):
    np.testing.assert_array_equal(model["port_activity"], model["activity"])
    for got, want in zip(model["tables"], model["jtables"]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_batch_serving_matches_reference(model, name):
    policy_kw, engine_kw = CASES[name]
    check_batch_serving(model, policy_kw, None, engine_kw)
