"""The port's continuous-batching scheduler against the JAX package's:
arrival processes and trace loading equal to the reference's; on the
committed profiling fixture (results/bench/model.npz with
tables_a0.95_k16.npz; cache-rate 0.5, PrevStepPredictor) the same seeded
Poisson arrivals served token by token (chunk 1), in chunks of 8, and in
adaptive chunks under SLOs with adaptive prefetch, and the static baseline:
the same tokens per request, the same step counts and counters, and the
simulated-clock summary (TTFT, TPOT, e2e percentiles, goodput) allclose at
rel 1e-9 (the host timeline replays the same decisions)."""
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
from repro.runtime.prefetch import AdaptiveBudgetController as JCtrl  # noqa: E402
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import AdaptiveBudgetController  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.serving import scheduler as S  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = str(FIXTURE / "tables_a0.95_k16.npz")
RATE = 3000.0                 # requests per simulated second: a backlog


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


@pytest.mark.parametrize("name", ["poisson", "bursty", "replay"])
def test_arrivals_match_reference(name):
    make = {"poisson": lambda m: m.PoissonArrivals(250.0, seed=4,
                                                   start_s=0.5),
            "bursty": lambda m: m.BurstyArrivals(250.0, burst_size=3,
                                                 burstiness=6.0, seed=4),
            "replay": lambda m: m.ReplayArrivals([0.3, 0.1, 0.2, 0.2])}[name]
    np.testing.assert_array_equal(make(S).times(4), make(JS).times(4))


def _write_trace(path):
    path.write_text(
        "# recorded serving trace\n"
        '{"t_arrival": 0.002, "prompt_len": 3, "max_new_tokens": 5, '
        '"session": 1, "parent": 0}\n'
        "\n"
        '{"t_arrival": 0.0, "prompt_len": 6, "max_new_tokens": 2}\n'
        '{"t_arrival": 0.001, "prompt_len": 4, "max_new_tokens": 3, '
        '"session": 1}\n')
    return str(path)


def test_trace_loading_matches_reference(tmp_path):
    p = _write_trace(tmp_path / "t.jsonl")
    assert S.load_trace(p) == JS.load_trace(p)
    slo = dict(ttft_s=1e-3, tpot_s=None, deadline_s=5e-3)

    def sample(n):
        return np.arange(n) + 7

    got = S.requests_from_trace(p, sample, S.SLOConfig(**slo), limit=2)
    want = JS.requests_from_trace(p, sample, JS.SLOConfig(**slo), limit=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.rid, g.max_new_tokens, g.arrival_s, g.session, g.parent,
                g.slo.ttft_s, g.slo.deadline_s) == \
            (w.rid, w.max_new_tokens, w.arrival_s, w.session, w.parent,
             w.slo.ttft_s, w.slo.deadline_s)


@pytest.mark.parametrize("text,err", [
    ('{"t_arrival": 0.0, "prompt_len": 3}\n', ValueError),
    ("[0.1, 5, 3]\n", ValueError), ("", AssertionError),
    ('{"t_arrival": 0.0, "prompt_len": 0, "max_new_tokens": 1}\n',
     AssertionError)])
def test_trace_rejects_what_the_reference_rejects(tmp_path, text, err):
    """The reference asserts on an empty trace and on empty rows; the port
    raises ValueError for every malformed file (asserts vanish under -O)."""
    p = tmp_path / "bad.jsonl"
    p.write_text(text)
    with pytest.raises(err):
        JS.load_trace(str(p))
    with pytest.raises(ValueError):
        S.load_trace(str(p))


def test_percentiles_match_reference():
    xs = np.random.default_rng(0).exponential(1e-3, 37).tolist()
    assert S.percentiles(xs) == JS.percentiles(xs)
    assert S.percentiles([]) == JS.percentiles([])


@pytest.fixture(scope="module")
def weights():
    cfg = jprofiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, profiling(), load_npz(str(FIXTURE / "model.npz"), "cpu")


def _engines(weights, fused=True):
    cfg, jp, pcfg, tp = weights
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


def _requests(mod, n, new_tokens, slo=None):
    lm = MarkovLM(512, seed=1)
    rng = np.random.default_rng(1)
    prompts = [lm.sample(1, int(rng.integers(4, 12)))[0] for _ in range(n)]
    return mod.make_requests(prompts, mod.PoissonArrivals(RATE, seed=2),
                             new_tokens, slo)


def _compare_runs(jreqs, preqs, jsum, psum):
    for jr, pr in zip(sorted(jreqs, key=lambda r: r.rid),
                      sorted(preqs, key=lambda r: r.rid)):
        assert pr.tokens == jr.tokens, f"request {pr.rid}"
        assert pr.state == jr.state
        np.testing.assert_allclose(pr.token_times, jr.token_times,
                                   rtol=1e-9)
    _assert_same(jsum, psum)


# name: (scheduler kwargs, SLOs, queue admission, adaptive prefetch)
RUNS = {
    "chunk1": (dict(prefill_chunk=1), None, "fcfs", False),
    "chunk8": (dict(prefill_chunk=8), None, "fcfs", False),
    # a TPOT budget below any step time halves the chunk down to 1 while a
    # decode row is resident; the deadline sheds part of the backlog
    "chunk8_adaptive_slo": (dict(prefill_chunk=8, adaptive_chunk=True),
                            dict(ttft_s=2e-3, tpot_s=1e-6, deadline_s=4e-3),
                            "slo", True),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_continuous_matches_reference(weights, name):
    kw, slo, admission, adaptive = RUNS[name]
    jeng, peng = _engines(weights)
    chunk_steps = []
    prefill_rows = peng.prefill_rows

    def counted(*a, **k):
        chunk_steps.append(a[0].shape)
        return prefill_rows(*a, **k)

    peng.prefill_rows = counted
    out = []
    for mod, eng, ctrl in ((JS, jeng, JCtrl), (S, peng,
                                               AdaptiveBudgetController)):
        reqs = _requests(mod, 7, 5, slo and mod.SLOConfig(**slo))
        c = ctrl(prefetch_k=eng.prefetch_k, lookahead=1, max_k=32,
                 window=2) if adaptive else None
        sched = mod.ContinuousScheduler(eng, slots=3, controller=c, **kw)
        out.append((reqs, sched.run(mod.RequestQueue(reqs,
                                                     admission=admission))))
    (jreqs, js), (preqs, ps) = out
    _compare_runs(jreqs, preqs, js, ps)
    assert ps["completed"] + ps["rejected"] == 7 and ps["completed"] > 0
    if name == "chunk8_adaptive_slo":
        assert ps["rejected"] > 0 and len(ps["budget_trace"]) > 0
    else:
        assert ps["completed"] == 7
    # chunk 1 feeds prompts through decode steps; chunk 8 through fused
    # [3, 8] steps, which the adaptive run shrinks under TPOT pressure
    shapes = set(chunk_steps)
    assert {"chunk1": not shapes, "chunk8": shapes == {(3, 8)},
            "chunk8_adaptive_slo": len(shapes) > 1}[name], shapes


def test_static_server_matches_reference(weights):
    jeng, peng = _engines(weights, fused=False)
    out = []
    for mod, eng in ((JS, jeng), (S, peng)):
        reqs = mod.make_requests(
            [MarkovLM(512, seed=2).sample(1, 5 + i)[0] for i in range(3)],
            mod.ReplayArrivals([0.0, 1e-4, 2e-4]), [3, 5, 4])
        out.append((reqs, mod.StaticServer(eng, batch_size=2).run(reqs)))
    (jreqs, js), (preqs, ps) = out
    _compare_runs(jreqs, preqs, js, ps)
    assert ps["completed"] == 3
