"""The port's Mamba2 block (``repro_torch/models/mamba.py``) against the JAX
package's, on the reduced ``zamba2-7b`` SSM config (d_model 256, 8 heads x
64, state 32, conv 4): the chunked SSD scan against the reference's
``ssd_chunked`` at S = 32, 64 and 96; the per-token recurrence against the
reference's per-token scan (the oracle of tests/test_ssm_chunked.py) at
S = 1, 40 and 96; ``mamba_forward`` on both branches (S = 1, 7, 40: the
recurrence; 32, 96: the chunked scan) from a nonzero initial state, with
``A_log``, ``D`` and ``dt_bias`` perturbed by seeded noise in both packages
(their defaults 0, 1 and 0 would hide a mistake in those terms); and
``init_mamba`` / ``init_mamba_state``'s shapes and defaults.

Tolerance 1e-5 x (1 + |ref|): the same f32 formulas, the port's einsums
and matmuls summing in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from test_ssm_chunked import _ssd_ref  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
D_MODEL = 256


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / (1 + np.abs(want))
    assert err.max() <= TOL, (what, float(err.max()))


def _ssd_inputs(seed, b, s, h=3, hd=8, n=4):
    """a in (0, 1) as softplus decays make it, dt > 0, h0 nonzero."""
    rng = np.random.default_rng(seed)
    f = np.float32
    a = np.exp(-np.log1p(np.exp(rng.standard_normal((b, s, h))))).astype(f)
    xh = rng.standard_normal((b, s, h, hd)).astype(f)
    bt = rng.standard_normal((b, s, n)).astype(f)
    ct = rng.standard_normal((b, s, n)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    h0 = (rng.standard_normal((b, h, hd, n)) * 0.1).astype(f)
    return a, xh, bt, ct, dt, h0


@pytest.mark.parametrize("s", [32, 64, 96])
def test_ssd_chunked_matches_reference(s):
    args = _ssd_inputs(s, 2, s)
    want_y, want_h = jax.jit(JM.ssd_chunked)(*map(jnp.asarray, args))
    got_y, got_h = M.ssd_chunked(*map(torch.from_numpy, args))
    _close(got_y, want_y, "y")
    _close(got_h, want_h, "h")


@pytest.mark.parametrize("s", [1, 40, 96])
def test_ssd_sequential_matches_reference_scan(s):
    args = _ssd_inputs(100 + s, 2, s)
    want_y, want_h = jax.jit(_ssd_ref)(*map(jnp.asarray, args))
    got_y, got_h = M.ssd_sequential(*map(torch.from_numpy, args))
    _close(got_y, want_y, "y")
    _close(got_h, want_h, "h")


@pytest.fixture(scope="module")
def weights():
    """The reference's PRNGKey(0) weights with A_log, D and dt_bias
    perturbed (the same noise in both packages)."""
    cfg = jreduced("zamba2-7b").ssm
    p = {k: np.array(v) for k, v in
         JM.init_mamba(jax.random.PRNGKey(0), D_MODEL, cfg,
                       jnp.float32).items()}
    rng = np.random.default_rng(11)
    h = p["A_log"].shape[0]
    p["A_log"] = (p["A_log"] + rng.standard_normal(h)).astype(np.float32)
    p["D"] = (p["D"] + 0.5 * rng.standard_normal(h)).astype(np.float32)
    p["dt_bias"] = (p["dt_bias"] + rng.standard_normal(h)).astype(np.float32)
    return p


@pytest.mark.parametrize("s", [1, 7, 32, 40, 96])
def test_mamba_forward_matches_reference(weights, s):
    jcfg, cfg = jreduced("zamba2-7b").ssm, get_reduced("zamba2-7b").ssm
    rng = np.random.default_rng(s)
    inner = cfg.expand * D_MODEL
    x = rng.standard_normal((2, s, D_MODEL)).astype(np.float32)
    state = {"conv": rng.standard_normal(
                 (2, cfg.conv_dim - 1, inner)).astype(np.float32),
             "ssm": (0.1 * rng.standard_normal(
                 (2, inner // cfg.head_dim, cfg.head_dim, cfg.state_dim))
             ).astype(np.float32)}
    want, want_st = jax.jit(
        lambda p, xx, st: JM.mamba_forward(p, xx, st, jcfg, D_MODEL))(
        {k: jnp.asarray(v) for k, v in weights.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in state.items()})
    got, got_st = M.mamba_forward(
        {k: torch.from_numpy(v) for k, v in weights.items()},
        torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg, D_MODEL)
    _close(got, want, "y")
    for k in ("conv", "ssm"):
        assert got_st[k].dtype == torch.float32
        _close(got_st[k], want_st[k], k)


def test_init_matches_reference_shapes_and_defaults():
    jcfg, cfg = jreduced("zamba2-7b").ssm, get_reduced("zamba2-7b").ssm
    want = JM.init_mamba(jax.random.PRNGKey(0), D_MODEL, jcfg, jnp.float32)
    got = M.init_mamba(torch.Generator().manual_seed(0), D_MODEL, cfg,
                       torch.float32, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    assert not got["A_log"].any() and not got["dt_bias"].any()
    assert bool((got["D"] == 1).all())
    jst = JM.init_mamba_state(3, D_MODEL, jcfg)
    st = M.init_mamba_state(3, D_MODEL, cfg, "cpu")
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == jst[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()
