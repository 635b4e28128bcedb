"""The port serving Mixtral against the JAX package, part two (set-up in
tests/test_torch_mixtral.py, batch serving in tests/test_torch_mixtral.py),
on ``mixtral-8x7b`` and ``mixtral-8x22b`` reduced (sliding window 128):
``generate`` token by token over a 124-token prompt + 8 new tokens (equal
tokens and summaries); continuous serving at chunk 8 through both
schedulers, capacity and fused, two of the eight prompts past the window
(equal tokens per request, token times and the scheduler summary to rel
1e-9); paged KV refused for a sliding window by both engines and the
launcher; and the launcher's paths on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_mixtral as P  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import scheduler as S  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

NEW = 8


@pytest.fixture(scope="module", params=P.ARCHS)
def model(request):
    return P.build_model(request.param)


def test_generate_token_by_token_matches_reference(model):
    """The batch API: 124 prompt tokens fed one decode step each, then 8
    sampled; positions 0..130 pass the window."""
    jeng, peng = P.engines(model, {}, None, {})
    prompts = MarkovLM(model["cfg"].vocab_size, seed=4).sample(4, 124)
    np.testing.assert_array_equal(peng.generate(prompts, NEW),
                                  jeng.generate(prompts, NEW))
    st = P.assert_summaries(jeng, peng, False)
    assert st["steps"] == 124 + NEW - 1


def _requests(mod, vocab):
    """Eight requests of 5 new tokens: six short prompts and two that pass
    the window (130 and 134 tokens), at a backlog's arrival rate."""
    lm = MarkovLM(vocab, seed=1)
    lens = (6, 130, 9, 4, 134, 11, 7, 5)
    return mod.make_requests([lm.sample(1, n)[0] for n in lens],
                             mod.PoissonArrivals(3000.0, seed=2), 5)


@pytest.mark.parametrize("fused", [False, True])
def test_continuous_chunk8_matches_reference(model, fused):
    jeng, peng = P.engines(model, dict(use_fused_dispatch=fused), None, {})
    chunk_steps = []
    prefill_rows = peng.prefill_rows

    def counted(*a, **k):
        chunk_steps.append(a[0].shape)
        return prefill_rows(*a, **k)

    peng.prefill_rows = counted
    out = []
    for mod, eng in ((JS, jeng), (S, peng)):
        reqs = _requests(mod, model["cfg"].vocab_size)
        sched = mod.ContinuousScheduler(eng, slots=4, prefill_chunk=8)
        out.append((reqs, sched.run(mod.RequestQueue(reqs))))
    (jreqs, js), (preqs, ps) = out
    for jr, pr in zip(sorted(jreqs, key=lambda r: r.rid),
                      sorted(preqs, key=lambda r: r.rid)):
        assert pr.tokens == jr.tokens, f"request {pr.rid}"
        np.testing.assert_allclose(pr.token_times, jr.token_times, rtol=1e-9)
    P.close(js, ps)
    assert ps["completed"] == 8
    assert set(chunk_steps) == {(4, 8)}


def test_paged_kv_refuses_a_sliding_window(model):
    """The reference asserts; the port raises ValueError, as it does for
    every configuration the reference asserts against (asserts vanish
    under -O), with the reference's message."""
    with pytest.raises(AssertionError, match="never wrap"):
        JEngine(model["jcfg"], model["jp"], paged_kv=True)
    with pytest.raises(ValueError, match="never wrap"):
        ServeEngine(model["cfg"], model["tp"], paged_kv=True)
    with pytest.raises(ValueError, match="never wrap"):
        serve.main(["--arch", model["arch"], "--reduced", "--device", "cpu",
                    "--mode", "continuous", "--paged-kv"])


@pytest.mark.parametrize("extra", [[], ["--fused-dispatch"],
                                   ["--quant-tier", "int8",
                                    "--tier-coverage", "0.5"],
                                   ["--miss-policy", "cost"],
                                   ["--mode", "continuous",
                                    "--prefill-chunk", "8"]])
def test_launcher_serves_reduced_mixtral_on_cpu(extra):
    """The launcher's paths on the CPU (their engines are held against the
    reference in these two files): every request served."""
    s = serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                    "cpu", "--steps", "4", "--num-requests", "4"] + extra)
    if "continuous" in extra:
        assert s["completed"] == 4
    else:
        assert s["stats"]["steps"] == 8 + 4 - 1
