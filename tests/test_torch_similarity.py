"""The port's expert output similarity (``core/similarity.py``) against the
JAX package's on the committed fixture (results/bench/model.npz, the
profiling config: 2 layers, 64 experts, top-6; calibration tokens
``MarkovLM(vocab, num_blocks=8, seed=0).sample(4, 64)`` as
benchmarks/common.py draws them), and ``ServeEngine(latency_cfg=)`` on the
same fixture against the reference engine.

Tolerances: the calibration activations within 1e-5 of their largest entry
(f32 sums in another order through two attention and MoE layers); the
[E, E] cosine means within 1e-5 absolute (each a mean of cosines in
[-1, 1], f32 sums over D and N in another order). The engine summary is
held as tests/test_torch_engine.py holds it: ints equal, floats to 1e-9
relative (the host's simulated clock replays the same decisions)."""
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import load_pytree  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import CONFIG as JFULL  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro.core import similarity as JS  # noqa: E402
from repro.core.buddies import load_tables as jload_tables  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.cache import ExpertCache as JCache  # noqa: E402
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import CONFIG as FULL  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core import similarity as S  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
ACT_RTOL = 1e-5
SIM_ATOL = 1e-5


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


@pytest.fixture(scope="module")
def fixture():
    """Both packages' weights, the calibration tokens, and the reference's
    layer inputs and similarities, computed once."""
    jcfg, cfg = jprofiling(), profiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = load_npz(str(FIXTURE / "model.npz"), "cpu")
    toks = MarkovLM(cfg.vocab_size, num_blocks=8, seed=0).sample(4, 64)
    jxs = np.asarray(JS.collect_layer_inputs(jcfg, jp, jnp.asarray(toks)))
    jsims = JS.all_layer_similarities(jcfg, jp, jnp.asarray(toks))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, toks=toks, jxs=jxs,
                jsims=jsims)


def test_collect_layer_inputs_matches_reference(fixture):
    xs = S.collect_layer_inputs(fixture["cfg"], fixture["tp"],
                                fixture["toks"])
    want = fixture["jxs"]
    assert tuple(xs.shape) == want.shape == (2, 256, 128)
    err = np.abs(xs.numpy() - want).max()
    assert err <= ACT_RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("n", [1, 37, 256])
def test_expert_output_similarity_matches_reference(fixture, layer, n):
    """The same [n, D] rows (the reference's layer inputs) through both."""
    xs = fixture["jxs"][layer][:n]
    jmoe = {k: fixture["jp"]["groups"][0]["moe"][k][layer]
            for k in ("w1", "w3", "w2")}
    tmoe = {k: fixture["tp"]["groups"][0]["moe"][k][layer]
            for k in ("w1", "w3", "w2")}
    want = JS.expert_output_similarity(jmoe, jnp.asarray(xs))
    got = S.expert_output_similarity(tmoe, torch.tensor(xs))
    assert got.shape == want.shape == (64, 64)
    np.testing.assert_allclose(got, want, atol=SIM_ATOL, rtol=0)


def test_all_layer_similarities_matches_reference(fixture):
    before = ops.launch_counts()
    got = S.all_layer_similarities(fixture["cfg"], fixture["tp"],
                                   fixture["toks"])
    assert ops.launch_counts() == before      # CPU: the plain versions
    want = fixture["jsims"]
    assert got.shape == want.shape == (2, 64, 64)
    np.testing.assert_allclose(got, want, atol=SIM_ATOL, rtol=0)
    # the redundancy the fixture's upcycled experts carry (Fig. 4)
    off = got[:, ~np.eye(64, dtype=bool)]
    assert off.mean() > 0.1
    np.testing.assert_allclose(np.diagonal(got, axis1=1, axis2=2), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_latency_cfg_prices_the_clock_as_reference(fixture, fused):
    """The profiling fixture served with latency_cfg = the full DeepSeek
    config: the expert bytes and active params of the full model price
    the simulated clock; the whole summary equals the reference's."""
    jcfg, cfg = fixture["jcfg"], fixture["cfg"]
    n, e = jcfg.num_layers, jcfg.moe.num_experts
    tables = str(FIXTURE / "tables_a0.95_k16.npz")
    jc, pc = JCache(n, e, 0.5), ExpertCache(n, e, 0.5)
    jeng = JEngine(jcfg, fixture["jp"], tables=jload_tables(tables),
                   policy=JPolicy(use_fused_dispatch=fused), cache=jc,
                   predictor=JPred(n, e), prefetch_k=max(1, jc.capacity // 2),
                   latency_cfg=JFULL)
    peng = ServeEngine(cfg, fixture["tp"], tables=load_tables(tables),
                       policy=BuddyPolicy(use_fused_dispatch=fused), cache=pc,
                       predictor=PrevStepPredictor(n, e),
                       prefetch_k=max(1, pc.capacity // 2), latency_cfg=FULL)
    assert peng._latency_cfg is FULL
    assert peng._active_params == FULL.active_param_count()
    prompts = MarkovLM(cfg.vocab_size, seed=0).sample(4, 8)
    np.testing.assert_array_equal(peng.generate(prompts, 8),
                                  jeng.generate(prompts, 8))
    js, ps = jeng.summary(), peng.summary()
    _assert_same(js, ps)
    # the full model's experts take far longer to fetch than the fixture's
    base = ServeEngine(cfg, fixture["tp"], tables=load_tables(tables),
                       policy=BuddyPolicy(use_fused_dispatch=fused),
                       cache=ExpertCache(n, e, 0.5),
                       predictor=PrevStepPredictor(n, e),
                       prefetch_k=max(1, pc.capacity // 2))
    base.generate(prompts, 8)
    assert ps["stats"]["stall_s"] > base.summary()["stats"]["stall_s"]
