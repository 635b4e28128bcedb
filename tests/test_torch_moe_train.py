"""The port training MoE attention stacks against the JAX package, on the
reduced ``deepseek-v2-lite-buddy`` (4 experts, top-2, one shared expert),
its ``profiling()`` config (64 experts, top-6, two shared) and the reduced
``mixtral-8x7b`` (GQA, a window, no shared expert), with the reference's
random weights from PRNGKey(0) carried across by ``params_from_numpy``:
``loss_and_grads`` against ``jax.value_and_grad`` of the reference's
``lm_loss`` (autograd through ``TopkGate`` and ``ExpertFFN``, whose
forwards are the kernels' plain versions here), one train step's loss,
grad norm and learning rate, ``remat``, the router jitter, the launcher,
and the two Functions' backward against autograd through the plain ops.

Tolerances, as tests/test_torch_train.py: loss, ce and lb 1e-5 relative;
each gradient leaf within 1e-4 of its largest entry (f32 sums in another
order; measured ~2e-6). The jitter's draws come from a torch.Generator
and cannot equal JAX's PRNG, so jitter is held to its own contract (zero
jitter is no jitter, the noise is bounded, the same seed routes the
same), not to the reference's draws."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten_with_paths, load_pytree  # noqa
from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprof  # noqa
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_loop import lm_loss as jlm_loss  # noqa: E402
from repro_torch.checkpoint.io import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.expert_ffn import (ExpertFFN,  # noqa: E402
                                            expert_ffn_plain)
from repro_torch.kernels.topk_gate import TopkGate, topk_gate_plain  # noqa
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import fold_in, tree_leaves  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as L  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

CONFIGS = {
    "deepseek": (lambda: jreduced("deepseek-v2-lite-buddy"),
                 lambda: get_reduced("deepseek-v2-lite-buddy")),
    "profiling": (jprof, profiling),
    "mixtral": (lambda: jreduced("mixtral-8x7b"),
                lambda: get_reduced("mixtral-8x7b")),
}
OPT = dict(lr=3e-4, warmup_steps=10, total_steps=3)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def ref():
    """(jcfg, jparams, cfg, flat weights) per config, and the reference's
    loss and gradients per (config, S), each computed once."""
    models, grads = {}, {}

    def model(name):
        if name not in models:
            jcfg = CONFIGS[name][0]()
            jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
            models[name] = (jcfg, jp, CONFIGS[name][1](), _flat(jp))
        return models[name]

    def value_and_grad(name, s):
        if (name, s) not in grads:
            jcfg, jp, cfg, _ = model(name)
            toks = np.random.default_rng(s).integers(0, cfg.vocab_size,
                                                     (2, s + 1))
            x, y = toks[:, :-1], toks[:, 1:]
            (jloss, jm), jg = jax.jit(jax.value_and_grad(
                lambda p: jlm_loss(p, jcfg, jnp.asarray(x), jnp.asarray(y)),
                has_aux=True))(jp)
            grads[name, s] = (x, y, jloss, jm, jg)
        return grads[name, s]

    return model, value_and_grad


def _assert_grads_close(tg: dict, jgf: dict):
    assert set(tg) == set(jgf)
    for k, want in jgf.items():
        err = np.abs(tg[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_loss_and_gradients_match_reference(ref, name, s):
    model, value_and_grad = ref
    _, _, cfg, flat = model(name)
    x, y, jloss, jm, jg = value_and_grad(name, s)
    tp = params_from_numpy(flat, "cpu")
    loss, m, grads = L.loss_and_grads(tp, cfg, torch.from_numpy(x),
                                      torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "lb"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert not any(p.requires_grad for p in tree_leaves(tp))
    tg = params_to_numpy(grads)
    _assert_grads_close(tg, _flat(jg))
    # the router and every expert weight are trained through the kernels'
    # Functions, not only through the load-balance term
    for k in tg:
        if "/moe/" in k:
            assert np.abs(tg[k]).max() > 0, k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_reference(ref, name):
    """The port's make_train_step against the reference's gradients
    through its apply_updates: loss, ce, lb, grad norm and lr."""
    model, value_and_grad = ref
    _, jp, cfg, flat = model(name)
    x, y, jloss, jaux, jg = value_and_grad(name, 32)
    _, _, jopt = jax.jit(lambda p, g: JO.apply_updates(
        p, g, JO.init_opt_state(p), JO.AdamWConfig(**OPT)))(jp, jg)
    jm = dict(jaux, loss=jloss, **jopt)
    tp = params_from_numpy(flat, "cpu")
    _, _, m = L.make_train_step(cfg, O.AdamWConfig(**OPT))(
        tp, O.init_opt_state(tp), torch.from_numpy(x), torch.from_numpy(y))
    for k in ("loss", "ce", "lb", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_remat_equals_no_remat_and_reference(ref, name):
    """remat=True recomputes each block in the backward: the same loss and
    gradients as without, and the reference's remat=True logits."""
    model, value_and_grad = ref
    jcfg, jp, cfg, flat = model(name)
    x, y, *_ = value_and_grad(name, 32)
    out = [L.loss_and_grads(params_from_numpy(flat, "cpu"), cfg,
                            torch.from_numpy(x), torch.from_numpy(y),
                            remat=remat) for remat in (False, True)]
    (l0, m0, g0), (l1, m1, g1) = out
    assert float(l0) == float(l1) and float(m0["lb"]) == float(m1["lb"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
    jl, _ = jax.jit(lambda p, t: JT.forward_train(p, jcfg, t, remat=True))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        tl, _ = T.forward_train(params_from_numpy(flat, "cpu"), cfg,
                                torch.from_numpy(x), remat=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Router jitter
# ---------------------------------------------------------------------------
def _jitter_case(jitter: float, seed: int = 0):
    cfg = get_reduced("deepseek-v2-lite-buddy")
    moe_cfg = dataclasses.replace(cfg.moe, router_jitter=jitter)
    g = torch.Generator().manual_seed(seed)
    params = M.init_moe(g, cfg.d_model, moe_cfg, torch.float32, "cpu")
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    return params, x, moe_cfg


def _routed_logits(monkeypatch):
    """Records the logits every ops.topk_gate call receives."""
    seen = []
    gate = ops.topk_gate

    def spy(logits, tau, *, k):
        seen.append(logits.detach().clone())
        return gate(logits, tau, k=k)
    monkeypatch.setattr(ops, "topk_gate", spy)
    return seen


def test_zero_jitter_with_a_generator_is_no_jitter():
    params, x, cfg = _jitter_case(0.0)
    y0, a0 = M.moe_forward(params, x, cfg)
    y1, a1 = M.moe_forward(params, x, cfg,
                           rng=torch.Generator().manual_seed(3))
    assert torch.equal(y0, y1) and torch.equal(a0.indices, a1.indices)
    assert torch.equal(a0.lb_loss, a1.lb_loss)


def test_jitter_noise_is_bounded_and_changes_the_logits(monkeypatch):
    params, x, cfg = _jitter_case(0.3)
    seen = _routed_logits(monkeypatch)
    M.moe_forward(params, x, cfg)                 # no generator: no noise
    M.moe_forward(params, x, cfg, rng=torch.Generator().manual_seed(1))
    clean, noisy = seen
    delta = (noisy - clean).abs()
    assert float(delta.max()) <= 0.3 and float(delta.min()) > 0


def test_jitter_same_seed_routes_the_same():
    params, x, cfg = _jitter_case(5.0)           # large: routing moves
    runs = [M.moe_forward(params, x, cfg,
                          rng=torch.Generator().manual_seed(s))[1].indices
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], M.moe_forward(params, x, cfg)[1].indices)


def test_jitter_under_remat_routes_the_recompute_the_same(ref):
    """With jitter, remat's recomputed forward draws the same noise (each
    layer's generator is made inside the checkpointed block): the
    gradients equal those without remat, and differ from those of another
    seed."""
    model, _ = ref
    _, _, cfg, flat = model("deepseek")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, router_jitter=0.5))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 33))
    x, y = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])

    def run(seed, remat):
        return L.loss_and_grads(params_from_numpy(flat, "cpu"), cfg, x, y,
                                rng=fold_in(seed, 1, "cpu"), remat=remat)
    (l0, _, g0), (l1, _, g1), (l2, _, _) = (run(0, False), run(0, True),
                                            run(1, False))
    assert float(l0) == float(l1) and float(l0) != float(l2)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_reduced_deepseek_on_cpu(ref, tmp_path, capsys):
    """--layers 1 keeps one layer; --save is read back by the reference's
    load_pytree into a one-layer tree; the refusal is gone."""
    model, _ = ref
    jcfg, *_ = model("deepseek")
    path = str(tmp_path / "moe.npz")
    launch.main(["--arch", "deepseek-v2-lite-buddy", "--reduced",
                 "--layers", "1", "--device", "cpu", "--steps", "3",
                 "--seq", "32", "--batch", "2", "--save", path])
    out = capsys.readouterr().out
    assert "saved params" in out and "final loss" in out
    like = JT.init_params(dataclasses.replace(jcfg, num_layers=1),
                          jax.random.PRNGKey(0))
    loaded = _flat(load_pytree(path, like))
    assert loaded["groups/0/moe/w1"].shape[0] == 1
    assert all(np.all(np.isfinite(v)) for v in loaded.values())
    assert not hasattr(L, "check_trainable")
    with pytest.raises(SystemExit):
        launch.parse_args(["--layers", "-1"])
    assert launch.parse_args([]).arch == "deepseek-v2-lite-buddy"


# ---------------------------------------------------------------------------
# The two Functions' backward against autograd through the plain ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,e,k,ties", [(37, 64, 6, False), (8, 4, 2, False),
                                        (16, 8, 3, True), (5, 6, 1, False)])
def test_topk_gate_backward_matches_autograd_of_plain(t, e, k, ties):
    g = torch.Generator().manual_seed(t * e + k)
    z = torch.randn(t, e, generator=g)
    if ties:
        z = (z * 2).round()
    w_v, w_p = torch.randn(t, k, generator=g), torch.randn(t, k, generator=g)
    grads = []
    for fn in (lambda a: TopkGate.apply(topk_gate_plain, a, 0.3, k),
               lambda a: topk_gate_plain(a, 0.3, k=k)):
        a = z.clone().requires_grad_(True)
        idx, vals, probs, tae, allow = fn(a)
        assert not idx.requires_grad and not allow.requires_grad
        (torch.sum(vals * w_v) + torch.sum(probs * w_p)).backward()
        grads.append(a.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    # probs alone (the MoE layer's use): vals' gradient is never formed
    a = z.clone().requires_grad_(True)
    torch.sum(TopkGate.apply(topk_gate_plain, a, 0.3, k)[2] * w_p).backward()
    want = z.clone().requires_grad_(True)
    torch.sum(topk_gate_plain(want, 0.3, k=k)[2] * w_p).backward()
    torch.testing.assert_close(a.grad, want.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("e,c,d,f,empty", [(4, 8, 32, 48, 0),
                                           (3, 13, 40, 24, 5),
                                           (2, 6, 16, 16, 6)])
def test_expert_ffn_backward_matches_autograd_of_plain(e, c, d, f, empty):
    """Rows of x left empty (a capacity buffer's unfilled slots) are zero
    and get zero gradient rows."""
    g = torch.Generator().manual_seed(e * c + d)
    x = torch.randn(e, c, d, generator=g)
    x[:, c - empty:] = 0
    ws = [torch.randn(e, d, f, generator=g) * 0.2,
          torch.randn(e, d, f, generator=g) * 0.2,
          torch.randn(e, f, d, generator=g) * 0.2]
    dy = torch.randn(e, c, d, generator=g)
    grads = []
    for fn in (lambda *a: ExpertFFN.apply(expert_ffn_plain, *a),
               expert_ffn_plain):
        args = [t.clone().requires_grad_(True) for t in (x, *ws)]
        torch.sum(fn(*args) * dy).backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if empty:
        assert torch.equal(grads[0][0][:, c - empty:],
                           torch.zeros(e, empty, d))
    # x alone needs a gradient: the weights' are not formed
    xa = x.clone().requires_grad_(True)
    torch.sum(ExpertFFN.apply(expert_ffn_plain, xa, *ws) * dy).backward()
    torch.testing.assert_close(xa.grad, grads[1][0], rtol=1e-5, atol=1e-5)


def test_topk_gate_backward_in_f64_gradcheck():
    """The backward formula alone (topk_gate_backward) against finite
    differences of the same top-k softmax in f64."""
    from repro_torch.kernels.topk_gate import topk_gate_backward
    g = torch.Generator().manual_seed(0)
    z = torch.randn(6, 10, generator=g, dtype=torch.float64)
    k = 3
    idx = torch.sort(z, dim=-1, descending=True, stable=True)[1][:, :k]

    def f(a):                                   # idx fixed: no flips
        v = torch.gather(a, 1, idx)
        return v, torch.softmax(v, -1)
    a = z.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(f, (a,))
    g_v = torch.randn(6, k, generator=g, dtype=torch.float64)
    g_p = torch.randn(6, k, generator=g, dtype=torch.float64)
    v, p = f(a)
    (torch.sum(v * g_v) + torch.sum(p * g_p)).backward()
    got = topk_gate_backward(idx, p.detach().float(), 10, g_v.float(),
                             g_p.float())
    torch.testing.assert_close(got.double(), a.grad, rtol=1e-5, atol=1e-6)
