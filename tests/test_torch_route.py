"""The routing kernel's plain version (``kernels.route.route_plain``) against
the JAX package on the same numpy inputs: the Pallas router gate in
interpret mode, ``core.gates.distribution_gate`` and ``core.substitute`` in
precedence mode with the degraded and peer masks. Every int and bool output
equal; probs and TAE within 1e-6 (the same f32 formulas). The CUDA kernel
is held against route_plain on the card (tests/test_torch_cuda.py,
chip_smoke.py). Also the wrapper's launch plan and output views, which are
pure Python."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.gates import distribution_gate as jdist_gate  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.core.substitute import substitute as jsubstitute  # noqa: E402
from repro.kernels.topk_gate import topk_gate_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.route import (FLAG_OUTPUTS,  # noqa: E402
                                       WORD_OUTPUTS, Route, launch_plan,
                                       outputs, route_plain)

E, K, R, H, RHO = 16, 4, 6, 5, 2
TOL = 1e-6


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _tables(rng, e=E, r=R):
    table = np.full((e, r), -1, np.int32)
    q = np.zeros((e, r), np.float32)
    for i in range(e):
        n = int(rng.integers(1, r + 1))
        table[i, :n] = rng.choice([x for x in range(e) if x != i], n,
                                  replace=False)
        q[i, :n] = np.sort(rng.random(n))[::-1]
    return table, q


def _compare(logits, tau, beta, resident, table, q, *, k=K, h=H, rho=RHO,
             mode="buddy", quant_ok=None, peer_ok=None):
    """route_plain against the JAX reference chain; returns the port's
    Route."""
    got = route_plain(_t(logits), tau, beta, _t(resident), _t(table), _t(q),
                      k=k, h=h, rho=rho, substitute=mode != "none",
                      quant_ok=_t(quant_ok), peer_ok=_t(peer_ok))
    idx, vals, probs, tae, allow = topk_gate_pallas(
        jnp.asarray(logits), tau, k=k, interpret=True)
    dist_ok = jdist_gate(idx, jnp.asarray(resident), beta)
    pol = JPolicy(tau=tau, beta=beta, rho=rho, H=h, mode=mode)
    ref = jsubstitute(idx, vals, jnp.asarray(resident), jnp.asarray(table),
                      jnp.asarray(q), pol,
                      quant_ok=None if quant_ok is None
                      else jnp.asarray(quant_ok),
                      peer_ok=None if peer_ok is None
                      else jnp.asarray(peer_ok))
    exact = {"idx": idx, "allow": allow, "dist_ok": dist_ok,
             "new_idx": ref.indices, "substituted": ref.substituted,
             "missed": ref.missed, "degraded": ref.degraded,
             "peered": ref.peered, "dropped": ref.dropped}
    for name, want in exact.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(got.allow.numpy(), np.asarray(ref.allowed))
    np.testing.assert_array_equal(got.topk_logits.numpy(), np.asarray(vals))
    for name, want in (("probs", probs), ("tae", tae)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(want), rtol=0, atol=TOL,
                                   err_msg=name)
    assert got.idx.dtype == got.new_idx.dtype == torch.int32
    assert not got.dropped.any()
    return got


# (T, masks, mode, logits): masks "" none, "q" quant_ok, "qp" quant_ok and
# peer_ok; logits "normal" or "ties" (a coarse grid: many equal values)
CASES = [(1, "", "buddy", "normal"), (4, "", "buddy", "normal"),
         (4, "q", "buddy", "normal"), (4, "qp", "buddy", "ties"),
         (32, "qp", "buddy", "normal"), (32, "q", "none", "normal"),
         (32, "", "buddy", "ties"), (300, "qp", "buddy", "normal"),
         (300, "", "none", "ties"), (4, "qp", "none", "normal")]


@pytest.mark.parametrize("t,masks,mode,kind", CASES)
def test_route_plain_matches_reference(t, masks, mode, kind):
    rng = np.random.default_rng(t * 31 + len(masks) + len(mode) + len(kind))
    logits = rng.normal(size=(t, E)).astype(np.float32)
    if kind == "ties":
        # +0.0: lax.top_k orders -0.0 below +0.0, the port treats them as
        # the tie they compare as (tests/test_torch_kernels.py)
        logits = (np.round(logits * 1.5) + 0.0).astype(np.float32)
    resident = rng.random(E) < 0.5
    table, q = _tables(rng)
    quant_ok = rng.random(E) < 0.4 if "q" in masks else None
    peer_ok = rng.random(E) < 0.4 if "p" in masks else None
    # beta 1.1 lets the distribution gate pass, so the buddies run
    got = _compare(logits, 0.2, 1.1, resident, table, q, mode=mode,
                   quant_ok=quant_ok, peer_ok=peer_ok)
    if mode == "buddy" and t >= 4:
        assert got.substituted.any()
    if mode == "none":
        assert not got.substituted.any()


def _rows(picks, e=E):
    """Logits whose top-k rows are ``picks`` (distinct, descending)."""
    z = np.full((len(picks), e), -5.0, np.float32)
    for i, row in enumerate(picks):
        z[i, row] = np.arange(len(row), 0, -1)
    return z


@pytest.mark.parametrize("beta,want", [
    (0.25, False),                                   # delta == beta
    (float(np.nextafter(np.float32(0.25), np.float32(1))), True)])
def test_distribution_gate_at_beta(beta, want):
    """2 of 8 requested experts non-resident: delta = 0.25 exactly, and
    delta < beta fails at beta = 0.25 on both sides (one f32 ulp above, it
    passes)."""
    logits = _rows([[0, 1, 2, 3], [4, 5, 6, 7]])
    resident = np.ones(E, bool)
    resident[[0, 4]] = False
    table, q = _tables(np.random.default_rng(0))
    got = _compare(logits, -1.0, beta, resident, table, q)
    assert bool(got.dist_ok) is want
    assert bool(got.substituted.any()) is want


def test_distribution_gate_at_one_third():
    """1 of 3 requested experts non-resident against beta = 1/3: the f32
    quotient equals beta rounded to f32, so the gate stays shut."""
    resident = np.ones(E, bool)
    resident[0] = False
    table, q = _tables(np.random.default_rng(1))
    got = _compare(_rows([[0, 1, 2]]), -1.0, 1.0 / 3.0, resident, table, q,
                   k=3)
    assert not bool(got.dist_ok)


def test_ops_route_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    logits = _t(rng.normal(size=(6, E)).astype(np.float32))
    table, q = _tables(rng)
    resident = _t(rng.random(E) < 0.5)
    before = ops.launch_counts()
    got = ops.route(logits, 0.1, 1.1, resident, _t(table), _t(q), k=K)
    want = route_plain(logits, 0.1, 1.1, resident, _t(table), _t(q), k=K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.launch_counts() == before


# ------------------------------------------------- the wrapper's launch plan
@pytest.mark.parametrize("t", [1, 4, 32, 256, 257, 4096])
@pytest.mark.parametrize("k", [1, 6, 16])
def test_launch_plan(t, k):
    """One launch up to 256 tokens, two above; every output a contiguous
    view that starts on 16 bytes, inside its buffer, overlapping no other."""
    plan = launch_plan(t, k)
    assert plan.launches == (1 if t <= 256 else 2)
    assert len(plan.word_offsets) == len(WORD_OUTPUTS)
    assert len(plan.flag_offsets) == len(FLAG_OUTPUTS)
    assert all(4 * o % 16 == 0 for o in plan.word_offsets)
    assert all(o % 16 == 0 for o in plan.flag_offsets)
    words = torch.empty(plan.words, dtype=torch.int32)
    flags = torch.empty(plan.flags, dtype=torch.bool)
    out = outputs(words, flags, t, k)
    assert isinstance(out, Route)
    spans = {"words": [], "flags": []}
    for name, v in out._asdict().items():
        buf = "words" if v.element_size() == 4 else "flags"
        base = (words if buf == "words" else flags).data_ptr()
        start = v.data_ptr() - base
        assert v.is_contiguous() and start % 16 == 0, name
        spans[buf].append((start, start + v.numel() * v.element_size()))
        shape = {"tae": (t,), "allow": (t,), "dist_ok": ()}.get(name, (t, k))
        assert tuple(v.shape) == shape, name
    assert out.idx.dtype == out.new_idx.dtype == torch.int32
    assert out.probs.dtype == out.tae.dtype == torch.float32
    assert out.missed.dtype == out.dist_ok.dtype == torch.bool
    for buf, size in (("words", 4 * plan.words), ("flags", plan.flags)):
        s = sorted(spans[buf])
        assert all(a[1] <= b[0] for a, b in zip(s, s[1:])), buf
        assert s[-1][1] <= size, buf
