"""The routing kernel's plain version (``kernels.route.route_plain``) against
the JAX package on the same numpy inputs: the Pallas router gate in
interpret mode, ``core.gates.distribution_gate`` and ``core.substitute``
with its whole contract (precedence mode with the degraded and peer masks,
cost mode with its cost vectors, Psi's eta and kappa terms, the token
gate's temperature and margin). Every int and bool output equal; probs and
TAE within 1e-6 (the same f32 formulas). The CUDA kernel is held against
route_plain on the card (tests/test_torch_cuda.py, chip_smoke.py). Also
the wrapper's launch plan and output views, which are pure Python, and
``moe_forward``'s one routing call per layer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.gates import distribution_gate as jdist_gate  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.core.substitute import substitute as jsubstitute  # noqa: E402
from repro.kernels.topk_gate import topk_gate_pallas  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.route import (FLAG_OUTPUTS,  # noqa: E402
                                       WORD_OUTPUTS, Route, launch_plan,
                                       outputs, route_plain)
from repro_torch.models import moe as M  # noqa: E402

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
             mode="buddy", quant_ok=None, peer_ok=None, **policy):
    """route_plain against the JAX reference chain; returns the port's
    Route. ``policy``: route_plain's cost-mode, Psi and token-gate keyword
    arguments (numpy arrays for the vectors)."""
    vecs = ("fid_cost", "fetch_cost", "peer_cost", "hop")
    got = route_plain(_t(logits), tau, beta, _t(resident), _t(table), _t(q),
                      k=k, h=h, rho=rho, substitute=mode != "none",
                      quant_ok=_t(quant_ok), peer_ok=_t(peer_ok),
                      **{n: _t(v) if n in vecs else v
                         for n, v in policy.items()})
    idx, vals, probs, tae, allow = topk_gate_pallas(
        jnp.asarray(logits), tau, k=k, interpret=True)
    dist_ok = jdist_gate(idx, jnp.asarray(resident), beta)
    scalars = {n: v for n, v in policy.items() if n not in vecs}
    cost = scalars.pop("cost", False)
    pol = JPolicy(tau=tau, beta=beta, rho=rho, H=h, mode=mode,
                  miss_policy="cost" if cost else "precedence", **scalars)

    def j(a):
        return None if a is None else jnp.asarray(a)

    ref = jsubstitute(idx, vals, jnp.asarray(resident), jnp.asarray(table),
                      jnp.asarray(q), pol, router_logits=jnp.asarray(logits),
                      quant_ok=j(quant_ok), peer_ok=j(peer_ok),
                      **{n: j(policy.get(n)) for n in vecs})
    exact = {"idx": idx, "allow": ref.allowed, "dist_ok": dist_ok,
             "new_idx": ref.indices, "substituted": ref.substituted,
             "missed": ref.missed, "degraded": ref.degraded,
             "peered": ref.peered, "dropped": ref.dropped}
    for name, want in exact.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want), err_msg=name)
    if pol.temperature == 1.0 and pol.margin_gamma >= 1.0:
        # the token gate is then the router kernel's own TAE gate
        np.testing.assert_array_equal(got.allow.numpy(), np.asarray(allow))
    np.testing.assert_array_equal(got.topk_logits.numpy(), np.asarray(vals))
    for name, want in (("probs", probs), ("tae", tae)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(want), rtol=0, atol=TOL,
                                   err_msg=name)
    assert got.idx.dtype == got.new_idx.dtype == torch.int32
    if not cost:
        assert not got.dropped.any()
    return got


def _policy(rng, flags):
    """route_plain's keyword arguments for ``flags`` (CASES)."""
    kw = {}
    if "c" in flags:
        # fetch stalls around the drop cost (stall_per_quality x drop_loss
        # = 0.05), one forbidden: every outcome occurs
        fetch = (rng.random(E) * 0.08).astype(np.float32)
        fetch[0] = np.inf
        kw.update(cost=True, fetch_cost=fetch, stall_per_quality=0.05)
    if "d" in flags:
        fid = (rng.random(E) * 0.05).astype(np.float32)
        fid[rng.random(E) < 0.3] = np.inf
        kw["fid_cost"] = fid
    if "r" in flags:
        peer = (rng.random(E) * 0.05).astype(np.float32)
        peer[rng.random(E) < 0.3] = np.inf
        kw["peer_cost"] = peer
    if "h" in flags:
        # hop -1 is the cache's "not resident" sentinel (clamped to 0)
        kw.update(eta=0.5, kappa=0.2,
                  hop=rng.integers(-1, 4, E).astype(np.int32))
    if "g" in flags:
        kw.update(temperature=0.8, margin_gamma=0.4)
    return kw


# (T, flags, mode, logits): flags "q" quant_ok and "p" peer_ok (precedence
# masks); "c" cost mode with fetch_cost, "d" its fid_cost, "r" its
# peer_cost; "h" eta 0.5 and kappa 0.2 with a hop vector holding -1
# entries; "g" temperature 0.8 and margin_gamma 0.4. logits "normal" or
# "ties" (a coarse grid: many equal values)
CASES = [(1, "", "buddy", "normal"), (4, "", "buddy", "normal"),
         (4, "q", "buddy", "normal"), (4, "qp", "buddy", "ties"),
         (32, "qp", "buddy", "normal"), (32, "q", "none", "normal"),
         (32, "", "buddy", "ties"), (300, "qp", "buddy", "normal"),
         (300, "", "none", "ties"), (4, "qp", "none", "normal"),
         (4, "c", "buddy", "normal"), (32, "cd", "buddy", "normal"),
         (300, "cdr", "buddy", "normal"), (4, "cdr", "buddy", "ties"),
         (32, "qpcdr", "none", "normal"), (300, "c", "none", "normal"),
         (4, "h", "buddy", "normal"), (32, "qph", "buddy", "normal"),
         (300, "h", "buddy", "ties"), (4, "g", "buddy", "normal"),
         (32, "qpg", "buddy", "normal"), (300, "g", "none", "normal"),
         (32, "cdrhg", "buddy", "normal"), (300, "cdhg", "buddy", "ties")]


@pytest.mark.parametrize("t,masks,mode,kind", CASES)
def test_route_plain_matches_reference(t, masks, mode, kind):
    rng = np.random.default_rng(t * 31 + len(masks) + len(mode) + len(kind))
    # "g": wider logits, so that margins spread on both sides of 0.4
    logits = (rng.normal(size=(t, E)) * (4 if "g" in masks else 1)).astype(
        np.float32)
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
                   quant_ok=quant_ok, peer_ok=peer_ok, **_policy(rng, masks))
    if mode == "buddy" and t >= 4 and "g" not in masks:
        assert got.substituted.any()
    if mode == "none":
        assert not got.substituted.any()
    if "c" in masks:
        # no degraded or peer outcome without its cost vector; the argmin
        # picks among several outcomes
        assert "d" in masks or not got.degraded.any()
        assert "r" in masks or not got.peered.any()
        if t >= 32:
            assert sum(bool(m.any()) for m in (
                got.substituted, got.degraded, got.peered, got.missed,
                got.dropped)) >= 2
    if "g" in masks:
        # the margin co-gate shuts some gates that TAE alone opens
        assert not torch.equal(got.allow, got.tae > 0.2)


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
    view that starts on 16 bytes, inside its buffer, overlapping no other;
    the two-launch form's scratch segment (the rows' [T, 2] mean and std)
    after the outputs, on 16 bytes and inside the word buffer."""
    plan = launch_plan(t, k)
    assert plan.launches == (1 if t <= 256 else 2)
    assert (plan.scratch is None) == (plan.launches == 1)
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
    if plan.scratch is not None:
        assert 4 * plan.scratch % 16 == 0
        spans["words"].append((4 * plan.scratch, 4 * (plan.scratch + 2 * t)))
    for buf, size in (("words", 4 * plan.words), ("flags", plan.flags)):
        s = sorted(spans[buf])
        assert all(a[1] <= b[0] for a, b in zip(s, s[1:])), buf
        assert s[-1][1] <= size, buf


# ------------------------------------------- one routing call per MoE layer
ONE_CALL_POLICIES = {
    "cost": dict(miss_policy="cost", stall_per_quality=0.01),
    "cost_mode_none": dict(miss_policy="cost", mode="none"),
    "eta_kappa": dict(eta=0.5, kappa=0.2),
    "temperature_margin": dict(temperature=0.8, margin_gamma=0.4),
    "precedence": dict()}


@pytest.fixture
def route_calls(monkeypatch):
    """Counts the calls of ops.route and ops.topk_gate (both devices)."""
    calls = {"route": 0, "topk_gate": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("name", list(ONE_CALL_POLICIES))
def test_moe_forward_routes_in_one_call(route_calls, name):
    """With a policy and a buddy state, moe_forward routes a layer in one
    ops.route call whatever the policy, and never calls ops.topk_gate."""
    rng = np.random.default_rng(7)
    e, k = 16, 3
    cfg = MoEConfig(num_experts=e, top_k=k, d_ff=24)
    params = M.init_moe(torch.Generator().manual_seed(0), 32, cfg,
                        torch.float32, "cpu")
    table, q = _tables(rng)
    buddy = M.BuddyState(_t(rng.random(e) < 0.5), _t(table), _t(q),
                         _t(rng.integers(-1, 3, e).astype(np.int32)),
                         fetch_cost=_t((rng.random(e) * 0.01)
                                       .astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(4, 1, 32)).astype(np.float32))
    y, aux = M.moe_forward(params, x, cfg, buddy=buddy,
                           policy=BuddyPolicy(tau=0.0, beta=1.1,
                                              **ONE_CALL_POLICIES[name]))
    assert route_calls == {"route": 1, "topk_gate": 0}
    assert bool(torch.isfinite(y).all())
    if ONE_CALL_POLICIES[name].get("miss_policy") == "cost":
        assert int(aux.n_miss_drop) + int(aux.n_missed) > 0


def test_cost_mode_decode_routes_once_per_layer(route_calls):
    """A cost-mode serve step on the CPU: one ops.route call per MoE layer
    and step, no ops.topk_gate call."""
    from pathlib import Path

    from repro_torch.checkpoint.io import load_npz
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.core.buddies import load_tables
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import MarkovLM
    bench = Path(__file__).resolve().parents[1] / "results" / "bench"
    cfg = profiling()
    eng = ServeEngine(cfg, load_npz(str(bench / "model.npz"), "cpu"),
                      tables=load_tables(str(bench / "tables_a0.95_k16.npz")),
                      policy=BuddyPolicy(miss_policy="cost",
                                         stall_per_quality=2e-4),
                      cache=ExpertCache(cfg.num_layers, cfg.moe.num_experts,
                                        0.5))
    eng.generate(MarkovLM(cfg.vocab_size, seed=0).sample(2, 2), 2)
    assert route_calls == {"route": cfg.num_layers * eng.stats.steps,
                           "topk_gate": 0}
    assert eng.stats.steps > 0 and eng.stats.n_miss_drop > 0
