"""The port's Llama-3.2-Vision stack against the JAX package's, on the
reduced ``llama-3.2-vision-11b`` config (d_model 256, 4 query heads over 2
KV heads, one ``vlm_super`` of a self-attention layer and a cross-attention
layer, 16 conditioning tokens of width 256), with the reference's random
weights from PRNGKey(0) carried across by ``params_from_numpy``:

- ``forward_train`` with ``cond_embeds`` (the cross block attends to the
  projected conditioning, no RoPE, no mask), and without them, where the
  reference runs each cross block as causal self-attention with RoPE;
- 7 ``decode_step``s, logits and every cache leaf. The reference's decode
  ignores the image: ``init_caches`` fills ``cross_kv`` with zeros (and
  takes ``cond_embeds`` and ``params`` without using them), so the cross
  attention adds exactly 0 and decode equals a forward on zero
  conditioning;
- one train step with ``cond_embeds`` (loss, grad norm, every gradient);
- ``launch/train.py --arch llama-3.2-vision-11b --reduced --device cpu``,
  which, like the reference's, trains without an image.

Tolerances as tests/test_torch_hybrid.py: logits and caches 1e-4 x (1 +
|ref|); loss and grad norm 1e-5 relative; each gradient within 1e-4 of its
leaf's largest entry."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint.io import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_hybrid import (close, flat, grads_close,  # noqa: E402
                               metrics_close, port_train, reference_train)
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

ARCH = "llama-3.2-vision-11b"
B, S, N_DECODE = 2, 32, 7


@pytest.fixture(scope="module")
def ref():
    """The reference's weights, inputs and outputs, computed once."""
    jcfg = jreduced(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1))
    cond = rng.standard_normal((B, jcfg.num_cond_tokens, jcfg.cond_dim)) \
        .astype(np.float32)
    fwd = jax.jit(lambda p, t, c: JT.forward_train(p, jcfg, t,
                                                   cond_embeds=c)[0])
    x = jnp.asarray(toks[:, :S])
    out = {"weights": flat(jp), "toks": toks, "cond": cond,
           "with": np.asarray(fwd(jp, x, jnp.asarray(cond))),
           "without": np.asarray(fwd(jp, x, None))}
    step = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c,
                                                       pos)[:2])
    caches = JT.init_caches(jcfg, B, 8)
    steps = []
    for pos in range(N_DECODE):
        lg, caches = step(jp, jnp.asarray(toks[:, pos]), caches,
                          jnp.asarray(pos, jnp.int32))
        steps.append((np.asarray(lg), flat(caches)))
    out["decode"] = steps
    out["train"] = reference_train(jcfg, jp, toks[:, :-1], toks[:, 1:],
                                   cond)
    return out


def _params(ref):
    return params_from_numpy(ref["weights"], "cpu")


def test_forward_with_conditioning_matches_reference(ref):
    cfg = get_reduced(ARCH)
    got, _ = T.forward_train(_params(ref), cfg,
                             torch.from_numpy(ref["toks"][:, :S]),
                             cond_embeds=torch.from_numpy(ref["cond"]))
    close(got, ref["with"], "logits")


def test_forward_without_conditioning_matches_reference(ref):
    """No image: each cross block is causal self-attention with RoPE."""
    cfg = get_reduced(ARCH)
    got, _ = T.forward_train(_params(ref), cfg,
                             torch.from_numpy(ref["toks"][:, :S]))
    close(got, ref["without"], "logits")
    assert np.abs(got.numpy() - ref["with"]).max() > 1e-3


def test_decode_matches_reference_logits_and_caches(ref):
    cfg = get_reduced(ARCH)
    caches = T.init_caches(cfg, B, 8, device="cpu")
    assert set(params_to_numpy(caches)) == set(ref["decode"][0][1])
    tp = _params(ref)
    for pos, (want_lg, want_c) in enumerate(ref["decode"]):
        lg, caches, _ = T.decode_step(
            tp, cfg, torch.from_numpy(ref["toks"][:, pos]), caches, pos,
            cond_embeds=torch.from_numpy(ref["cond"]))
        close(lg, want_lg, f"logits {pos}")
        got_c = params_to_numpy(caches)
        for k, w in want_c.items():
            close(got_c[k], w, f"{k} at {pos}")


def test_decode_ignores_the_image(ref):
    """The reference's behaviour, kept: init_caches's cross_kv are zeros
    whatever it is given, the cross attention over them adds exactly 0,
    and decode equals a forward on zero conditioning."""
    cfg = get_reduced(ARCH)
    tp = _params(ref)
    cond = torch.from_numpy(ref["cond"])
    caches = T.init_caches(cfg, B, 8, device="cpu", cond_embeds=cond,
                           params=tp)
    cross_kv = caches[0]["cross_kv"]
    assert len(cross_kv) == 2 and not any(bool(t.any()) for t in cross_kv)
    cp = tp["groups"][0]["cross"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    h, cache = A.attn_decode(
        {k: v[0] for k, v in cp["attn"].items()}, x, None, 3,
        cross_kv=(cross_kv[0][0], cross_kv[1][0]), num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta)
    assert cache is None and h.shape == x.shape and not bool(h.any())
    toks = torch.from_numpy(ref["toks"][:, :8])
    full, _ = T.forward_train(tp, cfg, toks,
                              cond_embeds=torch.zeros_like(cond))
    for pos in range(7):
        lg, caches, _ = T.decode_step(tp, cfg, toks[:, pos], caches, pos,
                                      cond_embeds=cond)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_train_step_with_conditioning_matches_reference(ref):
    cfg = get_reduced(ARCH)
    toks = ref["toks"]
    want_m, want_g = ref["train"]
    m, got_g = port_train(cfg, ref["weights"], toks[:, :-1], toks[:, 1:],
                          ref["cond"])
    metrics_close(m, want_m)
    grads_close(got_g, want_g)
    assert np.abs(got_g["cond_proj"]).max() > 0


def test_launcher_trains_reduced_vlm_on_cpu():
    args = launch.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "16"])
    trainer = launch.build_trainer(args)
    assert trainer.cfg.family == "vlm"
    params, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    assert len(hist) == 2
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist)
    assert params["cond_proj"].shape == (trainer.cfg.cond_dim,
                                         trainer.cfg.d_model)
