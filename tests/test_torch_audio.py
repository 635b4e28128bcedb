"""The port's MusicGen stack against the JAX package's, on the reduced
``musicgen-large`` config (d_model 256, 2 dense attention layers, a
16-token conditioning prefix of width 256), with the reference's random
weights from PRNGKey(0) carried across by ``params_from_numpy``:

- ``forward_train`` with the prefix: the projected conditioning goes in
  front of the tokens, and the logits cover only the token positions;
- 4 ``decode_step``s, logits and every cache leaf: positions shift by
  ``num_cond_tokens`` and the ring has room for the prefix, but no entry
  point writes the prefix (the reference's behaviour, kept: its slots stay
  zero);
- ``prefill_chunk`` (rows at base positions 0 and 2, 4 and 3 live tokens),
  whose positions shift the same way;
- one train step with ``cond_embeds`` (loss, grad norm, every gradient);
- ``launch/train.py --arch musicgen-large``, which passes no conditioning:
  the reference's loss fails there (``None @ cond_proj``), and the port
  raises a ValueError naming ``cond_embeds``.

Tolerances as tests/test_torch_hybrid.py: logits and caches 1e-4 x (1 +
|ref|); loss and grad norm 1e-5 relative; each gradient within 1e-4 of its
leaf's largest entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training.train_loop import lm_loss as jlm_loss  # noqa: E402
from repro_torch.checkpoint.io import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_hybrid import (close, flat, grads_close,  # noqa: E402
                               metrics_close, port_train, reference_train)
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

ARCH = "musicgen-large"
B, S, N_DECODE = 2, 32, 4
BASE = np.array([0, 2])
VALID = np.array([[True] * 4, [True] * 3 + [False]])


@pytest.fixture(scope="module")
def ref():
    """The reference's weights, inputs and outputs, computed once."""
    jcfg = jreduced(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1))
    cond = rng.standard_normal((B, jcfg.num_cond_tokens, jcfg.cond_dim)) \
        .astype(np.float32)
    fwd = jax.jit(lambda p, t, c: JT.forward_train(p, jcfg, t,
                                                   cond_embeds=c)[0])
    out = {"weights": flat(jp), "toks": toks, "cond": cond,
           "logits": np.asarray(fwd(jp, jnp.asarray(toks[:, :S]),
                                    jnp.asarray(cond)))}
    step = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c,
                                                       pos)[:2])
    caches = JT.init_caches(jcfg, B, 8)
    steps = []
    for pos in range(N_DECODE):
        lg, caches = step(jp, jnp.asarray(toks[:, pos]), caches,
                          jnp.asarray(pos, jnp.int32))
        steps.append((np.asarray(lg), flat(caches)))
    out["decode"] = steps
    lg, caches, _ = JT.prefill_chunk(
        jp, jcfg, jnp.asarray(toks[:, :4]), JT.init_caches(jcfg, B, 8),
        jnp.asarray(BASE), jnp.asarray(VALID))
    out["chunk"] = (np.asarray(lg), flat(caches))
    out["train"] = reference_train(jcfg, jp, toks[:, :-1], toks[:, 1:],
                                   cond)
    try:                        # the reference's loss without conditioning
        jlm_loss(jp, jcfg, jnp.asarray(toks[:, :-1]),
                 jnp.asarray(toks[:, 1:]))
        out["reference_error"] = None
    except Exception as e:      # noqa: BLE001  (kept to be checked)
        out["reference_error"] = e
    return out


def _params(ref):
    return params_from_numpy(ref["weights"], "cpu")


def test_forward_with_prefix_matches_reference(ref):
    cfg = get_reduced(ARCH)
    got, _ = T.forward_train(_params(ref), cfg,
                             torch.from_numpy(ref["toks"][:, :S]),
                             cond_embeds=torch.from_numpy(ref["cond"]))
    assert got.shape == (B, S, cfg.vocab_size)
    close(got, ref["logits"], "logits")


def test_decode_offset_matches_reference(ref):
    cfg = get_reduced(ARCH)
    nc = cfg.num_cond_tokens
    caches = T.init_caches(cfg, B, 8, device="cpu")
    assert caches[0]["kv"]["k"].shape[2] == 8 + nc   # room for the prefix
    tp = _params(ref)
    for pos, (want_lg, want_c) in enumerate(ref["decode"]):
        lg, caches, _ = T.decode_step(
            tp, cfg, torch.from_numpy(ref["toks"][:, pos]), caches, pos)
        close(lg, want_lg, f"logits {pos}")
        got_c = params_to_numpy(caches)
        assert set(got_c) == set(want_c)
        for k, w in want_c.items():
            close(got_c[k], w, f"{k} at {pos}")
    k = caches[0]["kv"]["k"]
    # token t went to slot nc + t; the prefix's slots were never written
    assert not bool(k[:, :, :nc].any())
    assert bool(k[:, :, nc:nc + N_DECODE].abs().amax(dim=(0, 1, 3, 4))
                .gt(0).all())


def test_prefill_chunk_offset_matches_reference(ref):
    cfg = get_reduced(ARCH)
    lg, caches, _ = T.prefill_chunk(
        _params(ref), cfg, torch.from_numpy(ref["toks"][:, :4]),
        T.init_caches(cfg, B, 8, device="cpu"), BASE, VALID)
    want_lg, want_c = ref["chunk"]
    close(lg.numpy()[VALID], want_lg[VALID], "logits")
    got_c = params_to_numpy(caches)
    for k, w in want_c.items():
        close(got_c[k], w, k)


def test_train_step_with_conditioning_matches_reference(ref):
    cfg = get_reduced(ARCH)
    toks = ref["toks"]
    want_m, want_g = ref["train"]
    m, got_g = port_train(cfg, ref["weights"], toks[:, :-1], toks[:, 1:],
                          ref["cond"])
    metrics_close(m, want_m)
    grads_close(got_g, want_g)
    assert np.abs(got_g["cond_proj"]).max() > 0


def test_launcher_refuses_without_conditioning(ref):
    """Where the reference's loss fails (no conditioning), the port says
    what is missing."""
    assert isinstance(ref["reference_error"], TypeError)
    args = launch.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--steps", "1", "--batch", "2", "--seq", "16"])
    trainer = launch.build_trainer(args)
    assert trainer.cfg.family == "audio"
    with pytest.raises(ValueError, match="cond_embeds"):
        trainer.run(log_every=1, log_fn=lambda _: None)
