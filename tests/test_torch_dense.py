"""The port training the dense attention archs against the JAX package, on
the reduced ``internlm2-1.8b``, ``internlm2-20b``, ``phi3-medium-14b`` and
``smollm-360m`` (tied embeddings) configs, with the reference's random
weights from PRNGKey(0) carried across by ``params_from_numpy``: one train
step's loss, grad norm and learning rate (the port's ``make_train_step``
against the reference's ``lm_loss`` gradients through its
``apply_updates``) and every gradient (``loss_and_grads`` against
``jax.value_and_grad``); and ``launch/train.py --arch <dense> --reduced
--device cpu``.

Tolerances, as tests/test_torch_train.py: loss and grad norm 1e-5
relative; each gradient leaf within 1e-4 of its largest entry (f32 sums
in another order through two layers and the softmaxes)."""
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
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as L  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

DENSE = ["internlm2-1.8b", "internlm2-20b", "phi3-medium-14b", "smollm-360m"]
OPT = dict(lr=3e-4, warmup_steps=10, total_steps=3)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch):
    jcfg, cfg = jreduced(arch), get_reduced(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    flat = _flat(jp)
    assert ("lm_head" in flat) == (not cfg.tie_embeddings)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    # the reference's loss and gradients, then its optimizer step on them
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jcfg, jnp.asarray(x), jnp.asarray(y)),
        has_aux=True))(jp)
    _, _, jopt = JO.apply_updates(jp, jg, JO.init_opt_state(jp),
                                  JO.AdamWConfig(**OPT))
    jm = dict(jaux, loss=jloss, **jopt)
    # the port's train step (loss, grad norm, lr), and its gradients from
    # the same weights
    tp = params_from_numpy(flat, "cpu")
    _, _, m = L.make_train_step(cfg, O.AdamWConfig(**OPT))(
        tp, O.init_opt_state(tp), torch.from_numpy(x), torch.from_numpy(y))
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    loss, _, grads = L.loss_and_grads(params_from_numpy(flat, "cpu"), cfg,
                                      torch.from_numpy(x),
                                      torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tg, jgf = params_to_numpy(grads), _flat(jg)
    assert set(tg) == set(jgf)
    for k, want in jgf.items():
        err = np.abs(tg[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("arch", DENSE)
def test_launcher_trains_reduced_dense_on_cpu(arch):
    args = launch.parse_args(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "3", "--batch", "2", "--seq", "16"])
    trainer = launch.build_trainer(args)
    assert trainer.cfg.family == "dense"
    params, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    assert len(hist) == 3
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist)
    assert params["embed"].shape == (trainer.cfg.vocab_size,
                                     trainer.cfg.d_model)
