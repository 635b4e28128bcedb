"""The port's chunkwise WKV (plain version and autograd Function) against the
JAX package: ``ref_wkv_chunk`` and the Pallas kernel in interpret mode at
the shapes ``tests/test_kernels.py`` sweeps and at the chunk counts of the
card tests' ring edges (N = 2 and 3), torch's gradcheck in float64,
and the gradients against ``jax.grad`` of the reference oracle.

Tolerances: rtol/atol 3e-4 for the forward, as the JAX package holds its
kernel to its oracle (f32 sums over C and D in another order, carried over
N chunks of state); 1e-4 relative to the largest gradient for the backward
(the chunked gradient sums in another order than JAX's reverse scan)."""
import types

import numpy as np

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.wkv_chunk import (wkv_chunk_cuda,  # noqa: E402
                                           wkv_chunk_plain)

SHAPES = [(1, 1, 32, 64), (3, 4, 32, 64), (2, 2, 32, 128), (4, 8, 16, 32),
          (2, 3, 32, 64), (1, 2, 16, 64)]


def _inputs(bh, n, c, d, seed):
    rng = np.random.default_rng(seed)
    rt, kt, v, ke = (rng.normal(size=(bh, n, c, d)).astype(np.float32)
                     for _ in range(4))
    lae = -np.abs(rng.normal(size=(bh, n, d))).astype(np.float32)
    dg = rng.normal(size=(bh, n, c)).astype(np.float32)
    s0 = (rng.normal(size=(bh, d, d)) * 0.1).astype(np.float32)
    return [rt, kt, v, ke, lae, dg, s0]


@pytest.mark.parametrize("bh,n,c,d", SHAPES)
def test_plain_matches_reference_and_pallas(bh, n, c, d):
    args = _inputs(bh, n, c, d, bh * 100 + n)
    o, s = wkv_chunk_plain(*map(torch.from_numpy, args))
    ja = [jnp.asarray(x) for x in args]
    for jo, js in (ref.ref_wkv_chunk(*ja), jops.wkv_chunk(*ja)):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=3e-4,
                                   atol=3e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=3e-4,
                                   atol=3e-4)


def test_dispatch_runs_the_plain_version_on_the_cpu():
    args = [torch.from_numpy(x) for x in _inputs(2, 3, 16, 32, 7)]
    before = wkv_chunk_cuda.launches
    o, s = ops.wkv_chunk(*args)
    want = wkv_chunk_plain(*args)
    assert torch.equal(o, want[0]) and torch.equal(s, want[1])
    assert wkv_chunk_cuda.launches == before
    with pytest.raises(ValueError, match="rt on cpu"):
        wkv_chunk_cuda(*args)
    # meta: the plain version for its output shapes only (the dry run)
    o_m, s_m = ops.wkv_chunk(*[a.to("meta") for a in args])
    assert (o_m.device.type, o_m.shape, s_m.shape) == ("meta", o.shape,
                                                       s.shape)
    assert wkv_chunk_cuda.launches == before
    # any other device has no kernel
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(RuntimeError, match="no kernel for device xpu"):
        ops.wkv_chunk(other, *args[1:])


def test_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    bh, n, c, d = 2, 3, 4, 5
    args = [torch.randn(bh, n, c, d, generator=g, dtype=torch.float64)
            for _ in range(4)]
    args += [-torch.rand(bh, n, d, generator=g, dtype=torch.float64),
             torch.randn(bh, n, c, generator=g, dtype=torch.float64),
             torch.randn(bh, d, d, generator=g, dtype=torch.float64) * 0.1]
    args = [a.requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(ops.wkv_chunk, args, eps=1e-6,
                                    atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("bh,n,c,d", [(3, 4, 32, 64), (4, 8, 16, 32)])
def test_gradients_match_jax(bh, n, c, d):
    args = _inputs(bh, n, c, d, 11 + n)
    rng = np.random.default_rng(5)
    w_o = rng.normal(size=(bh, n, c, d)).astype(np.float32)
    w_s = rng.normal(size=(bh, d, d)).astype(np.float32)

    def jloss(*a):
        o, s = ref.ref_wkv_chunk(*a)
        return jnp.sum(o * w_o) + jnp.sum(s * w_s)

    jg = jax.grad(jloss, argnums=tuple(range(7)))(
        *[jnp.asarray(x) for x in args])
    ta = [torch.from_numpy(x).requires_grad_(True) for x in args]
    o, s = ops.wkv_chunk(*ta)
    (torch.sum(o * torch.from_numpy(w_o))
     + torch.sum(s * torch.from_numpy(w_s))).backward()
    for name, t, j in zip(("rt", "kt", "v", "ke", "lae", "dg", "s0"), ta, jg):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max()
        assert err <= 1e-4 * np.abs(j).max(), (name, err, np.abs(j).max())
