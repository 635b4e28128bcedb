"""The port's Zamba2 hybrid stack against the JAX package's, on the reduced
``zamba2-7b`` config (d_model 256, one ``hybrid_super`` of 2 Mamba2 layers
and the shared attention block), with the reference's random weights from
PRNGKey(0) carried across by ``params_from_numpy``: ``forward_train``'s
logits at S = 16 (the per-token recurrence) and S = 32 (the chunked
scan); 7 ``decode_step``s, their logits and every cache leaf (conv tails,
SSM states, the shared block's ring KV); the port's decode against its own
forward at the reference's 2e-4 (tests/test_models_smoke.py's
``test_decode_matches_forward_hybrid``); one train step (the port's
``make_train_step`` against the reference's ``lm_loss`` gradients through
its ``apply_updates``) with every gradient, ``shared_attn/ln1``'s zero in
both (the super-blocks norm with their own ``ln_attn``); ``remat`` on
against off; ``launch/train.py --arch zamba2-7b --reduced --device cpu``,
and ``--layers 15``'s group structure at full width.

Tolerances: logits and caches 1e-4 x (1 + |ref|) (f32 sums in another
order through two Mamba2 layers, the chunked scan's exp(+-la) factors and
an attention block); loss and grad norm 1e-5 relative; each gradient leaf
within 1e-4 of its largest entry, as tests/test_torch_train.py."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten_with_paths  # noqa: E402
from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_loop import lm_loss as jlm_loss  # noqa: E402
from repro_torch.checkpoint.io import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as L  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

ARCH = "zamba2-7b"
TOL = 1e-4
OPT = dict(lr=3e-4, warmup_steps=10, total_steps=3)
B, S_TRAIN, N_DECODE = 2, 32, 7


def flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


def close(got, want, what="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / (1 + np.abs(want))
    assert err.max() <= tol, (what, float(err.max()))


def grads_close(got: dict, want: dict):
    """Every gradient leaf within 1e-4 of its largest entry."""
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err)


def reference_train(jcfg, jp, x, y, cond=None) -> tuple:
    """The reference's loss metrics (with its optimizer's lr and grad
    norm) and gradients, flattened."""
    c = None if cond is None else jnp.asarray(cond)
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jcfg, jnp.asarray(x), jnp.asarray(y),
                           cond_embeds=c), has_aux=True))(jp)
    _, _, opt = jax.jit(JO.apply_updates, static_argnums=3)(
        jp, g, JO.init_opt_state(jp), JO.AdamWConfig(**OPT))
    return {k: float(v) for k, v in dict(aux, loss=loss, **opt).items()}, \
        flat(g)


def port_train(cfg, weights, x, y, cond=None):
    """The port's train step metrics, and its gradients from the same
    weights."""
    c = None if cond is None else torch.from_numpy(cond)
    tp = params_from_numpy(weights, "cpu")
    _, _, m = L.make_train_step(cfg, O.AdamWConfig(**OPT))(
        tp, O.init_opt_state(tp), torch.from_numpy(x), torch.from_numpy(y),
        cond_embeds=c)
    _, _, g = L.loss_and_grads(params_from_numpy(weights, "cpu"), cfg,
                               torch.from_numpy(x), torch.from_numpy(y),
                               cond_embeds=c)
    return m, params_to_numpy(g)


def metrics_close(m, want):
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def ref():
    """The reference's weights and its forward, decode and train outputs,
    each computed once for the module."""
    jcfg = jreduced(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (B, S_TRAIN + 1))
    fwd = jax.jit(lambda p, t: JT.forward_train(p, jcfg, t)[0])
    out = {"weights": flat(jp), "toks": toks,
           "logits": {s: np.asarray(fwd(jp, jnp.asarray(toks[:, :s])))
                      for s in (16, 32)}}
    step = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c,
                                                       pos)[:2])
    caches = JT.init_caches(jcfg, B, 8)
    steps = []
    for pos in range(N_DECODE):
        lg, caches = step(jp, jnp.asarray(toks[:, pos]), caches,
                          jnp.asarray(pos, jnp.int32))
        steps.append((np.asarray(lg), flat(caches)))
    out["decode"] = steps
    out["train"] = reference_train(jcfg, jp, toks[:, :-1], toks[:, 1:])
    return out


@pytest.mark.parametrize("s", [16, 32])
def test_forward_matches_reference(ref, s):
    cfg = get_reduced(ARCH)
    got, aux = T.forward_train(params_from_numpy(ref["weights"], "cpu"), cfg,
                               torch.from_numpy(ref["toks"][:, :s]))
    close(got, ref["logits"][s], f"logits S={s}")
    assert float(aux["lb"]) == 0.0


def test_decode_matches_reference_logits_and_caches(ref):
    cfg = get_reduced(ARCH)
    tp = params_from_numpy(ref["weights"], "cpu")
    caches = T.init_caches(cfg, B, 8, device="cpu")
    assert set(params_to_numpy(caches)) == set(ref["decode"][0][1])
    for pos, (want_lg, want_c) in enumerate(ref["decode"]):
        lg, caches, _ = T.decode_step(
            tp, cfg, torch.from_numpy(ref["toks"][:, pos]), caches, pos)
        close(lg, want_lg, f"logits {pos}")
        got_c = params_to_numpy(caches)
        for k, w in want_c.items():
            close(got_c[k], w, f"{k} at {pos}")


def test_decode_matches_own_forward(ref):
    """Teacher-forced decode against the full-sequence forward, the
    reference's own check at its tolerance."""
    cfg = get_reduced(ARCH)
    tp = params_from_numpy(ref["weights"], "cpu")
    toks = torch.from_numpy(ref["toks"][:, :8])
    full, _ = T.forward_train(tp, cfg, toks)
    caches = T.init_caches(cfg, B, 8, device="cpu")
    for pos in range(7):
        lg, caches, _ = T.decode_step(tp, cfg, toks[:, pos], caches, pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_train_step_matches_reference(ref):
    cfg = get_reduced(ARCH)
    toks = ref["toks"]
    want_m, want_g = ref["train"]
    m, got_g = port_train(cfg, ref["weights"], toks[:, :-1], toks[:, 1:])
    metrics_close(m, want_m)
    grads_close(got_g, want_g)
    # the shared block's ln1 is never read: its gradient is zero in both
    assert not want_g["shared_attn/ln1"].any()
    assert not got_g["shared_attn/ln1"].any()
    assert np.abs(got_g["shared_attn/ln2"]).max() > 0


def test_remat_matches_no_remat(ref):
    cfg = get_reduced(ARCH)
    toks = torch.from_numpy(ref["toks"])
    res = [L.loss_and_grads(params_from_numpy(ref["weights"], "cpu"), cfg,
                            toks[:, :-1], toks[:, 1:], remat=remat)
           for remat in (False, True)]
    (l0, _, g0), (l1, _, g1) = res
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    g0, g1 = params_to_numpy(g0), params_to_numpy(g1)
    for k, w in g0.items():
        assert np.abs(g1[k] - w).max() <= 1e-6 * max(np.abs(w).max(),
                                                      1e-30), k


def test_launcher_trains_reduced_hybrid_on_cpu():
    args = launch.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "32"])
    trainer = launch.build_trainer(args)
    assert trainer.cfg.family == "hybrid"
    params, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    assert len(hist) == 2
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist)
    assert "shared_attn" in params


def test_launcher_layers_keep_the_group_structure():
    """--layers 15 at full width: 2 super-blocks of 6 Mamba2 layers and
    the shared attention block, then 3 Mamba2 layers; 1.60 B parameters."""
    cfg = launch.build_config(launch.parse_args(["--arch", ARCH,
                                                 "--layers", "15"]))
    assert cfg.stack() == (("hybrid_super", 2), ("mamba2", 3))
    assert (cfg.d_model, cfg.ssm.num_heads, cfg.ssm.head_dim) == \
        (3584, 56, 128)
    assert round(cfg.param_count() / 1e9, 2) == 1.60
