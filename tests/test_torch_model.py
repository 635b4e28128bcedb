"""The port's decoder stack against the JAX package's on the committed
profiling checkpoint (results/bench/model.npz: 2 layers, 64 experts, top-6):
weight carry-over, ``forward_train(record=True)`` and ``decode_step``
(lockstep and per-row positions, fused and unfused dispatch). Logits agree
to 1e-4 (f32, |logits| ~ 1-10, two layers of matmuls summed in another
order); routing indices and every per-slot mask are exactly equal."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import load_pytree  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint.io import (load_npz, params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training.data import MarkovLM  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
LOGIT_TOL = 1e-4
SLOT_MASKS = ("indices", "substituted", "missed", "degraded", "dropped",
              "peered")


@pytest.fixture(scope="module")
def models():
    cfg = jprofiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, profiling(), load_npz(str(FIXTURE / "model.npz"), "cpu")


def test_weights_carry_over_exactly():
    with np.load(FIXTURE / "model.npz") as data:
        flat = {k: data[k] for k in data.files}
    params = params_from_numpy(flat, "cpu")
    assert isinstance(params["groups"], tuple) and len(params["groups"]) == 1
    assert params["groups"][0]["moe"]["w1"].shape == (2, 64, 128, 64)
    back = params_to_numpy(params)
    assert set(back) == set(flat) and len(back) == 16
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    bf = params_from_numpy(flat, "cpu", dtype="bfloat16")
    assert bf["embed"].dtype == torch.bfloat16


def test_init_params_layout_matches_reference():
    """Random init (torch.Generator streams) with the reference's keys,
    shapes and dtypes."""
    from repro.checkpoint.io import _flatten_with_paths
    cfg = profiling()
    jflat = _flatten_with_paths(JT.init_params(jprofiling(),
                                               jax.random.PRNGKey(0)))
    flat = params_to_numpy(T.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert set(flat) == set(jflat)
    for k in flat:
        assert flat[k].shape == jflat[k].shape and \
            flat[k].dtype == jflat[k].dtype, k


def test_forward_train_record_matches_reference(models):
    cfg, jp, pcfg, tp = models
    toks = MarkovLM(cfg.vocab_size, seed=3).sample(2, 24)
    fwd = jax.jit(lambda p, t: JT.forward_train(p, cfg, t, record=True))
    jl, jaux = fwd(jp, jnp.asarray(toks))
    tl, taux = T.forward_train(tp, pcfg, torch.from_numpy(toks), record=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    jr, tr = jaux["recorded"][0], taux["recorded"][0]
    np.testing.assert_array_equal(tr["indices"].numpy(),
                                  np.asarray(jr["indices"]))
    np.testing.assert_allclose(tr["probs"].numpy(), np.asarray(jr["probs"]),
                               rtol=1e-5, atol=1e-6)
    for k in ("n_sub", "n_miss", "n_drop", "miss_per_expert"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
    np.testing.assert_allclose(float(taux["lb"]), float(jaux["lb"]),
                               rtol=1e-5)


def _buddies(rng, n_layers, e, tables):
    resident = rng.random((n_layers, e)) < 0.5
    hop = np.zeros((n_layers, e), np.int32)
    table, q = tables["table"], tables["q"]
    jb = JM.BuddyState(*map(jnp.asarray, (resident, table, q, hop)))
    tb = M.BuddyState(*[torch.from_numpy(np.array(a))
                        for a in (resident, table, q, hop)])
    return jb, tb


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_reference(models, fused, per_row):
    cfg, jp, pcfg, tp = models
    b, steps = 4, 6
    offset = np.arange(b) if per_row else np.zeros(b, np.int64)
    cap = steps + int(offset.max())
    with np.load(FIXTURE / "tables_a0.95_k16.npz") as t:
        tables = {k: t[k] for k in t.files}
    rng = np.random.default_rng(int(fused) * 2 + int(per_row))
    pol_kw = dict(tau=0.1, beta=1.1, rho=3, use_fused_dispatch=fused)
    jpol, pol = JPolicy(**pol_kw), BuddyPolicy(**pol_kw)
    step = jax.jit(lambda p, tok, c, pos, bud: JT.decode_step(
        p, cfg, tok, c, pos, policy=jpol, buddies=bud, record=True))
    jc = JT.init_caches(cfg, b, cap)
    tc = T.init_caches(pcfg, b, cap, device="cpu")
    toks = MarkovLM(cfg.vocab_size, seed=5).sample(b, steps)
    n_sub = 0
    for s in range(steps):
        jb, tb = _buddies(rng, cfg.num_layers, cfg.moe.num_experts, tables)
        pos = offset + s
        jl, jc, jaux = step(jp, jnp.asarray(toks[:, s], jnp.int32), jc,
                            jnp.asarray(pos if per_row else s, jnp.int32), jb)
        tl, tc, taux = T.decode_step(
            tp, pcfg, torch.from_numpy(toks[:, s]), tc,
            torch.from_numpy(pos) if per_row else s, policy=pol, buddies=tb,
            record=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jr, tr = jaux["recorded"][0], taux["recorded"][0]
        for k in SLOT_MASKS:
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]),
                                          err_msg=f"step {s}: {k}")
        n_sub += int(taux["n_sub"])
    assert n_sub > 0          # the buddy path was exercised
    np.testing.assert_allclose(tc[0]["kv"]["k"].numpy(),
                               np.asarray(jc[0]["kv"]["k"]), rtol=1e-4,
                               atol=1e-4)
