"""The port's RWKV6 block and stack against the JAX package on the reduced
``rwkv6-1.6b`` config (2 layers, d_model 256, 4 heads x 64, vocab 512),
with the reference's own random weights carried across as numpy arrays:
weight carry-over both ways, ``rwkv_time_mix``, ``rwkv_channel_mix``,
``wkv_chunked``, ``forward_train`` and eight ``decode_step``s, plus the
port's own chunked-vs-step consistency.

Tolerances: 1e-4 absolute and relative on logits and block outputs (f32,
|logits| <= ~4, the chunked form sums through exp(+-la) factors in another
order); 1e-5 where both sides run the same per-token recurrence."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import (_flatten_with_paths,  # noqa: E402
                                 load_pytree)
from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint.io import (params_from_numpy,  # noqa: E402
                                       params_to_numpy, save_npz)
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("rwkv6-1.6b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jp).items()}
    return jcfg, jp, get_reduced("rwkv6-1.6b"), params_from_numpy(flat, "cpu")


def _layer(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["groups"][0]),
            {k: v[i] for k, v in tp["groups"][0].items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_weights_carry_over_both_ways(models, tmp_path):
    jcfg, jp, cfg, tp = models
    flat = _flatten_with_paths(jp)
    back = params_to_numpy(tp)
    assert set(back) == set(flat)
    assert {"groups/0/wr", "groups/0/u", "groups/0/mu", "groups/0/ln_x",
            "groups/0/ln1"} <= set(back)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]),
                                      err_msg=k)
    save_npz(str(tmp_path / "p.npz"), tp)
    loaded = _flatten_with_paths(load_pytree(str(tmp_path / "p.npz"), jp))
    for k in flat:
        np.testing.assert_array_equal(np.asarray(loaded[k]),
                                      np.asarray(flat[k]), err_msg=k)
    # the port's own init has the reference's keys, shapes and dtypes
    own = params_to_numpy(T.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu"))
    assert set(own) == set(flat)
    for k in own:
        assert own[k].shape == flat[k].shape and \
            own[k].dtype == flat[k].dtype, k


@pytest.mark.parametrize("s", [32, 7])
def test_time_mix_matches_reference(models, s):
    jcfg, jp, cfg, tp = models
    jl, tl = _layer(jp, tp, 1)
    rng = np.random.default_rng(s)
    h, hd, d = cfg.ssm.num_heads, cfg.ssm.head_dim, cfg.d_model
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    st = (rng.normal(size=(2, h, hd, hd)) * 0.1).astype(np.float32)
    xp = rng.normal(size=(2, 1, d)).astype(np.float32)
    jy, js, jx = JR.rwkv_time_mix(jl, jnp.asarray(x), jnp.asarray(st),
                                  jnp.asarray(xp), num_heads=h, head_dim=hd)
    ty, ts, tx = R.rwkv_time_mix(tl, torch.from_numpy(x),
                                 torch.from_numpy(st), torch.from_numpy(xp),
                                 num_heads=h, head_dim=hd)
    _close(ty, jy)
    _close(ts, js)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_channel_mix_matches_reference(models):
    jcfg, jp, cfg, tp = models
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    xp = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jy, jx = JR.rwkv_channel_mix(jl, jnp.asarray(x), jnp.asarray(xp))
    ty, tx = R.rwkv_channel_mix(tl, torch.from_numpy(x), torch.from_numpy(xp))
    _close(ty, jy, 1e-5)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("s", [32, 96])
def test_wkv_chunked_and_scan_match_reference(s):
    rng = np.random.default_rng(s)
    b, h, dk = 2, 3, 64
    r, k, v = (rng.normal(size=(b, s, h, dk)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.log1p(np.exp(rng.normal(size=(b, s, h, dk))))) \
        .astype(np.float32)
    u = (rng.normal(size=(h, dk)) * 0.1).astype(np.float32)
    st = (rng.normal(size=(b, h, dk, dk)) * 0.1).astype(np.float32)
    ja = [jnp.asarray(a) for a in (r, k, v, w, u, st)]
    ta = [torch.from_numpy(a) for a in (r, k, v, w, u, st)]
    jo, js = JR.wkv_chunked(*ja)
    to, ts = R.wkv_chunked(*ta)
    _close(to, jo)
    _close(ts, js)
    so, ss = R.wkv_scan(*ta)
    jso, jss = JR.wkv_scan(*ja)
    _close(so, jso, 1e-5)
    _close(ss, jss, 1e-5)
    _close(to, so)                      # chunked form == recurrence


@pytest.mark.parametrize("s", [32, 64])
def test_forward_train_matches_reference(models, s):
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s))
    jl, _ = JT.forward_train(jp, jcfg, jnp.asarray(toks))
    tl, aux = T.forward_train(tp, cfg, torch.from_numpy(toks))
    assert tl.shape == (2, s, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    assert float(aux["lb"]) == 0.0


def test_decode_steps_match_reference(models):
    """Eight steps from zero state: each step must start from the state the
    previous one left (the port writes it into the stacked caches in
    place)."""
    jcfg, jp, cfg, tp = models
    b, steps = 2, 8
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (b, steps))
    jc = JT.init_caches(jcfg, b, steps)
    tc = T.init_caches(cfg, b, steps, device="cpu")
    assert [sorted(c) for c in tc] == [sorted(c) for c in jc]
    for k in tc[0]:
        assert tuple(tc[0][k].shape) == jc[0][k].shape, k
    for t in range(steps):
        jl, jc, _ = JT.decode_step(jp, jcfg, jnp.asarray(toks[:, t]), jc,
                                   jnp.asarray(t, jnp.int32))
        tl, tc2, _ = T.decode_step(tp, cfg, torch.from_numpy(toks[:, t]), tc,
                                   t)
        assert tc2 is tc
        _close(tl, jl, 1e-5)
    for k in tc[0]:
        _close(tc[0][k], jc[0][k], 1e-5)
    assert float(tc[0]["wkv"].abs().max()) > 0


def test_chunked_forward_matches_step_by_step(models):
    """As tests/test_ssm_chunked.py does for the reference: the chunked
    full-sequence forward against per-token decode through the stack."""
    _, _, cfg, tp = models
    b, s = 2, 32
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    full, _ = T.forward_train(tp, cfg, toks)
    caches = T.init_caches(cfg, b, s, device="cpu")
    for pos in range(s - 1):
        lg, caches, _ = T.decode_step(tp, cfg, toks[:, pos], caches, pos)
        _close(lg, full[:, pos], 5e-4)
