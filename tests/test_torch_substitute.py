"""The port's gates and full ``core.substitute`` (precedence with degraded and
peer splits, cost mode, eta/kappa Psi terms, mode 'none') against the JAX
package's on the same numpy inputs: every mask exactly equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gates as jgates  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.core.substitute import substitute as jsubstitute  # noqa: E402
from repro_torch.core import gates  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.core.substitute import substitute  # noqa: E402

E, K, R, T = 16, 4, 6, 40


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _setup(seed):
    rng = np.random.default_rng(seed)
    s = np.stack([rng.choice(E, K, replace=False)
                  for _ in range(T)]).astype(np.int32)
    topk_logits = np.sort(rng.normal(size=(T, K)), -1)[:, ::-1] \
        .astype(np.float32)
    router_logits = rng.normal(size=(T, E)).astype(np.float32)
    resident = rng.random(E) < 0.5
    table = np.full((E, R), -1, np.int32)
    q = np.zeros((E, R), np.float32)
    for i in range(E):
        n = int(rng.integers(1, R + 1))
        table[i, :n] = rng.choice([x for x in range(E) if x != i], n,
                                  replace=False)
        q[i, :n] = np.sort(rng.random(n))[::-1]
    hop = rng.integers(-1, 3, size=E).astype(np.int32)
    return dict(s=s, topk_logits=topk_logits, router_logits=router_logits,
                resident=resident, table=table, q=q, hop=hop, rng=rng)


CASES = {
    "precedence": (dict(tau=0.3, beta=0.9, rho=2, H=4), {}),
    "precedence_degraded_peer": (dict(tau=0.3, beta=0.9, rho=1, H=3),
                                 {"quant_ok": 0.5, "peer_ok": 0.5}),
    "eta_kappa": (dict(tau=0.1, beta=1.0, rho=3, H=6, eta=0.5, kappa=0.2),
                  {}),
    "mode_none": (dict(mode="none"), {"quant_ok": 0.5}),
    "mode_none_cost": (dict(mode="none", miss_policy="cost"),
                       {"fid_cost": 1.0, "fetch_cost": 1.0}),
    "cost": (dict(tau=0.1, beta=1.0, rho=3, H=6, miss_policy="cost",
                  stall_per_quality=0.05, drop_loss=0.5),
             {"fid_cost": 1.0, "fetch_cost": 1.0, "peer_cost": 1.0}),
    "random_mode": (dict(mode="random", tau=0.0, beta=1.0, rho=4), {}),
    "temperature_margin": (dict(tau=0.2, beta=1.0, temperature=0.8,
                                margin_gamma=0.5), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_substitute_matches_reference(case, seed):
    pol_kw, extra = CASES[case]
    d = _setup(seed)
    rng = d["rng"]
    opt = {}
    for name in extra:
        if name.endswith("_ok"):
            opt[name] = rng.random(E) < extra[name]
        else:   # a cost vector with some infinite entries
            c = (rng.random(E) * 0.1).astype(np.float32)
            c[rng.random(E) < 0.2] = np.inf
            opt[name] = c
    jpol, pol = JPolicy(**pol_kw), BuddyPolicy(**pol_kw)
    assert dataclasses.asdict(jpol) == dataclasses.asdict(pol)
    args = [d[k] for k in ("s", "topk_logits", "resident", "table", "q")]
    want = jsubstitute(*map(jnp.asarray, args), jpol,
                       router_logits=jnp.asarray(d["router_logits"]),
                       hop=jnp.asarray(d["hop"]),
                       **{k: jnp.asarray(v) for k, v in opt.items()})
    got = substitute(*map(_t, args), pol, router_logits=_t(d["router_logits"]),
                     hop=_t(d["hop"]), **{k: _t(v) for k, v in opt.items()})
    for name in ("indices", "substituted", "missed", "allowed", "dist_ok",
                 "degraded", "dropped", "peered"):
        w, g = getattr(want, name), getattr(got, name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{case}: {name}")


def test_cost_mode_requires_fetch_cost():
    d = _setup(0)
    args = [_t(d[k]) for k in ("s", "topk_logits", "resident", "table", "q")]
    with pytest.raises(ValueError):
        substitute(*args, BuddyPolicy(miss_policy="cost"))


@pytest.mark.parametrize("temperature,gamma", [(1.0, 1.0), (0.8, 0.4)])
def test_gates_match_reference(temperature, gamma):
    d = _setup(3)
    z = d["topk_logits"]
    np.testing.assert_allclose(
        gates.tae_from_logits(_t(z), temperature).numpy(),
        np.asarray(jgates.tae_from_logits(jnp.asarray(z), temperature)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        gates.token_gate(_t(z), 0.4, temperature, gamma).numpy(),
        np.asarray(jgates.token_gate(jnp.asarray(z), 0.4, temperature,
                                     gamma)))
    for beta in (0.3, 0.6):
        assert bool(gates.distribution_gate(_t(d["s"]), _t(d["resident"]),
                                            beta)) == \
            bool(jgates.distribution_gate(jnp.asarray(d["s"]),
                                          jnp.asarray(d["resident"]), beta))
    np.testing.assert_allclose(
        float(gates.distribution_delta(_t(d["s"]), _t(d["resident"]))),
        float(jgates.distribution_delta(jnp.asarray(d["s"]),
                                        jnp.asarray(d["resident"]))),
        rtol=1e-6)
