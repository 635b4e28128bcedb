"""The port's training path against the JAX package on the reduced
``rwkv6-1.6b`` config: ``lm_loss`` and its gradients (autograd through the
WKV Function against ``jax.value_and_grad``), and the optimizer apart from
them (``schedule`` and ``apply_updates`` fed the same numpy gradients,
since AdamW's first step is about +-lr per element whatever a gradient's
size, so a whole-step comparison would flip on near-zero gradients); the
launcher on the CPU with its checkpoint read back by the reference. MoE
stacks train too: tests/test_torch_moe_train.py.

Tolerances: loss 1e-5 relative; each gradient leaf within 1e-4 of its
largest entry (f32 sums in another order through two layers and the
exp(+-la) factors of the chunked form); the optimizer's outputs 1e-6
relative (the same f32 formulas; the global norm sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import (_flatten_with_paths,  # noqa: E402
                                 load_pytree)
from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_loop import lm_loss as jlm_loss  # noqa: E402
from repro_torch.checkpoint.io import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as L  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("rwkv6-1.6b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jp).items()}
    return jcfg, jp, get_reduced("rwkv6-1.6b"), flat


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.mark.parametrize("s", [32, 64])
def test_lm_loss_and_gradients_match_reference(models, s):
    jcfg, jp, cfg, flat = models
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jlm_loss(p, jcfg, jnp.asarray(x), jnp.asarray(y)),
        has_aux=True)(jp)
    tp = params_from_numpy(flat, "cpu")
    loss, m, grads = L.loss_and_grads(tp, cfg, torch.from_numpy(x),
                                      torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    assert not any(p.requires_grad for p in tree_leaves(tp))
    tg, jgf = params_to_numpy(grads), _flat(jg)
    assert set(tg) == set(jgf)
    for k, want in jgf.items():
        err = np.abs(tg[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    want = JO.schedule(JO.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    got = O.schedule(O.AdamWConfig(**cfg),
                     torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_tree_like(like, flat):
    """A JAX tree shaped like ``like`` with the arrays of ``flat``."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in paths]
    return jax.tree_util.tree_unflatten(treedef,
                                        [jnp.asarray(flat[k]) for k in keys])


def test_apply_updates_matches_reference(models):
    """Three steps fed the same numpy gradients, one of them clipped."""
    _, jp, _, flat = models
    rng = np.random.default_rng(0)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=5.0)
    jcfg, tcfg = JO.AdamWConfig(**ocfg), O.AdamWConfig(**ocfg)
    tp = params_from_numpy(flat, "cpu")
    jstate, tstate = JO.init_opt_state(jp), O.init_opt_state(tp)
    for scale in (1.0, 0.01, 10.0):
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in flat.items()}
        jg = _jax_tree_like(jp, g)
        jp, jstate, jm = JO.apply_updates(jp, jg, jstate, jcfg)
        tp, tstate, tm = O.apply_updates(tp, params_from_numpy(g, "cpu"),
                                         tstate, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(tstate.step) == int(jstate.step)
    for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        got, want = params_to_numpy(got), _flat(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-8, err_msg=k)


def test_weight_decay_reaches_stacked_vectors_only_through_ndim(models):
    """Zero gradients: only leaves with ndim >= 2 move (decay), and the
    stacked per-layer vectors (ln1, u, w_bias, ...) are among them."""
    _, _, _, flat = models
    tp = params_from_numpy(flat, "cpu")
    zero = {k: np.zeros_like(v) for k, v in flat.items()}
    tp, _, _ = O.apply_updates(tp, params_from_numpy(zero, "cpu"),
                               O.init_opt_state(tp),
                               O.AdamWConfig(lr=1.0, warmup_steps=0))
    after = params_to_numpy(tp)
    for k, v in flat.items():
        moved = not np.array_equal(after[k], v)
        assert moved == (v.ndim >= 2 and bool(np.any(v))), k
    assert flat["groups/0/ln1"].ndim == 2 and flat["final_norm"].ndim == 1


def test_launcher_trains_on_cpu_and_checkpoint_loads_in_reference(
        models, tmp_path, capsys):
    jcfg, jp, _, flat = models
    path = str(tmp_path / "rwkv.npz")
    launch.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                 "--steps", "3", "--seq", "32", "--batch", "2",
                 "--save", path])
    out = capsys.readouterr().out
    assert "saved params" in out and "final loss" in out
    loaded = _flat(load_pytree(path, jp))
    assert set(loaded) == set(flat)
    moved = sum(not np.array_equal(loaded[k], flat[k]) for k in flat)
    assert moved > len(flat) // 2          # the steps changed the weights
    assert all(np.all(np.isfinite(v)) for v in loaded.values())


def test_train_history_and_phase_times(models):
    _, _, cfg, _ = models
    args = launch.parse_args(["--arch", "rwkv6-1.6b", "--reduced",
                              "--device", "cpu", "--steps", "4", "--seq",
                              "32", "--batch", "2", "--lr", "1e-2"])
    trainer = launch.build_trainer(args)
    _, hist = trainer.run(log_every=1, log_fn=lambda _: None)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    for h in hist:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        phases = (h["forward_s"], h["backward_s"], h["optimizer_s"])
        assert min(phases) > 0
        # the host's wall time per step holds the three phases and more
        assert h["step_s"] > sum(phases)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        launch.build_trainer(launch.parse_args(["--arch", "rwkv6-1.6b",
                                                "--reduced"]))
