"""The port's ServeEngine against the JAX package's on the committed fixture
(results/bench/model.npz with tables_a0.95_k16.npz; cache-rate 0.5,
PrevStepPredictor, batch 4, 8 prompt + 8 greedy new tokens): the same tokens
and the same counters on the simulated clock; float clock values allclose
(rtol 1e-9: the host-side timeline replays the same decisions). Also the
serve launcher's batch mode and its refusals. The quant tier's engine
tests are in tests/test_torch_tier_engine.py; chunked prefill and the
continuous scheduler's in tests/test_torch_prefill.py and
tests/test_torch_scheduler.py."""
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
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
POLICIES = {
    "gather": dict(),
    "fused": dict(use_fused_dispatch=True),
    # a quality price low enough that buddies and drops beat fetches
    "cost_fused": dict(miss_policy="cost", stall_per_quality=2e-4,
                       use_fused_dispatch=True),
}


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


def _engines(policy_kw, cache_rate=0.5):
    cfg, pcfg = jprofiling(), profiling()
    n, e = cfg.num_layers, cfg.moe.num_experts
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    tables = str(FIXTURE / "tables_a0.95_k16.npz")
    jc, pc = JCache(n, e, cache_rate), ExpertCache(n, e, cache_rate)
    jeng = JEngine(cfg, jp, tables=jload_tables(tables),
                   policy=JPolicy(**policy_kw), cache=jc,
                   predictor=JPred(n, e), prefetch_k=max(1, jc.capacity // 2))
    peng = ServeEngine(pcfg, load_npz(str(FIXTURE / "model.npz"), "cpu"),
                       tables=load_tables(tables),
                       policy=BuddyPolicy(**policy_kw), cache=pc,
                       predictor=PrevStepPredictor(n, e),
                       prefetch_k=max(1, pc.capacity // 2))
    return cfg, jeng, peng


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_generate_matches_reference(name):
    cfg, jeng, peng = _engines(POLICIES[name])
    prompts = MarkovLM(cfg.vocab_size, seed=0).sample(4, 8)
    jout = jeng.generate(prompts, 8)
    pout = peng.generate(prompts, 8)
    np.testing.assert_array_equal(pout, jout)
    js, ps = jeng.summary(), peng.summary()
    _assert_same(js["stats"], ps["stats"])
    _assert_same(js["ledger"], ps["ledger"])
    _assert_same(js["stall_breakdown"], ps["stall_breakdown"])
    assert js.get("cost_policy", {}).keys() == ps.get("cost_policy",
                                                      {}).keys()
    assert ps["stats"]["n_sub"] > 0          # substitution was exercised
    if name == "cost_fused":
        assert ps["stats"]["n_miss_drop"] > 0


def test_temperature_sampling_is_seeded():
    """generate(greedy=False) draws from the engine's seeded generator: the
    same seed gives the same tokens, and a vanishing temperature gives the
    greedy ones."""
    params = load_npz(str(FIXTURE / "model.npz"), "cpu")
    prompts = MarkovLM(512, seed=1).sample(2, 4)

    def run(**kw):
        eng = ServeEngine(profiling(), params, seed=3)
        return eng.generate(prompts, 4, **kw)

    a, b = run(greedy=False), run(greedy=False)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < 512
    np.testing.assert_array_equal(run(greedy=False, temperature=1e-6),
                                  run(greedy=True))
    with pytest.raises(ValueError):
        run(greedy=False, temperature=0.0)


@pytest.mark.parametrize("kw", [dict(telemetry=object()),
                                dict(n_devices=2), dict(paged_kv=True),
                                dict(prefix_cache=True),
                                dict(placement=object())])
def test_unported_subsystems_raise(kw):
    """The quant tier is ported: its configuration errors are held against
    the reference's in tests/test_torch_tier_engine.py."""
    params = load_npz(str(FIXTURE / "model.npz"), "cpu")
    with pytest.raises(NotImplementedError):
        ServeEngine(profiling(), params, **kw)


@pytest.mark.parametrize("flag", [["--n-devices", "2"], ["--paged-kv"],
                                  ["--prefix-cache"],
                                  ["--placement", "live"],
                                  ["--telemetry", "on"],
                                  ["--trace-out", "t.json"]])
def test_serve_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(flag)
    assert "not ported yet" in capsys.readouterr().err


def test_serve_defaults_to_cuda_and_never_falls_back():
    args = serve.parse_args([])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_engine(serve.parse_args(["--reduced"]))


def test_serve_batch_mode_on_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--layers", "1",
                "--batch", "2", "--steps", "2", "--fused-dispatch"])
    out = capsys.readouterr().out
    summary = out[:out.index("\nstalls:")]
    import json
    s = json.loads(summary)
    assert s["stats"]["steps"] == 9 and s["stats"]["tokens"] == 18
    assert s["policy"]["use_fused_dispatch"] is True


@pytest.mark.parametrize("chunk", [1, 4])
def test_serve_continuous_on_cpu(chunk, capsys):
    """--mode continuous at the auto arrival rate (an unloaded probe batch,
    then reset_runtime): every request completes with --steps tokens, the
    printed summary is the returned one, and chunk 4 ingests the 4-8 token
    prompts in fewer steps."""
    import json
    s = serve.main(["--reduced", "--device", "cpu", "--layers", "1",
                    "--mode", "continuous", "--num-requests", "5",
                    "--slots", "2", "--steps", "3", "--fused-dispatch",
                    "--prefill-chunk", str(chunk)])
    out = capsys.readouterr().out
    assert "[serve] auto arrival rate" in out
    printed = out[out.index("\n{") + 1:out.index("\ncompleted ")]
    assert json.loads(printed) == json.loads(json.dumps(s, default=str))
    assert s["mode"] == "continuous" and s["slots"] == 2
    assert s["completed"] == s["num_requests"] == 5
    prompt_tokens = s["engine"]["stats"]["tokens"] - 5 * (3 - 1)
    assert 5 * 4 <= prompt_tokens <= 5 * 8
    assert s["steps"] < prompt_tokens if chunk == 4 else \
        s["steps"] >= prompt_tokens / 2


def test_serve_trace_replay_on_cpu(tmp_path, capsys):
    """--trace replays arrivals and per-request token budgets; it needs
    --mode continuous."""
    trace = tmp_path / "t.jsonl"
    trace.write_text("".join(
        '{"t_arrival": %g, "prompt_len": %d, "max_new_tokens": %d}\n'
        % (i * 1e-4, 3 + i, 2 + i) for i in range(3)))
    with pytest.raises(SystemExit):
        serve.parse_args(["--trace", str(trace)])
    assert "--mode continuous" in capsys.readouterr().err
    s = serve.main(["--reduced", "--device", "cpu", "--layers", "1",
                    "--mode", "continuous", "--trace", str(trace),
                    "--slots", "2", "--prefill-chunk", "2",
                    "--adaptive-prefetch"])
    assert "replaying 3 requests" in capsys.readouterr().out
    assert s["completed"] == 3 and "budget" in s
    # per-request budgets from the trace: 2 + 3 + 4 tokens
    assert s["engine"]["stats"]["tokens"] == (3 + 4 + 5) + (2 + 3 + 4) - 3
