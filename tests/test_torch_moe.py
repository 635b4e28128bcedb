"""The port's ``moe_forward`` against the JAX package's on the same weights
and inputs, through all three dispatch branches (fused grouped, tiny-batch
gather, row-local capacity): every MoEAux mask and count exactly equal,
outputs allclose. Tolerance: 1e-5 on f32 outputs of size ~0.1-1 — the two
sides run the same f32 operations in another summation order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

D, F = 32, 64
TOL = 1e-5
MASKS = ("indices", "orig_indices", "sub_slots", "miss_slots", "deg_slots",
         "drop_slots", "peer_slots", "miss_per_expert")
COUNTS = ("n_substituted", "n_missed", "n_dropped", "n_degraded",
          "n_miss_drop", "n_peered")
# one compile per case instead of one per eager op
_jmoe = jax.jit(JM.moe_forward, static_argnames=(
    "cfg", "policy", "capacity_factor", "use_kernel", "dropless"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(e, k, shared, seed):
    kw = dict(num_experts=e, top_k=k, d_ff=F, num_shared_experts=shared)
    jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
    jp = JM.init_moe(jax.random.PRNGKey(seed), D, jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jcfg, cfg, jp, tp


def _buddy(e, rng, r=4, fetch_cost=False):
    resident = rng.random(e) < 0.5
    table = np.stack([np.roll(np.arange(e), -i - 1)[:r]
                      for i in range(e)]).astype(np.int32)
    q = np.sort(rng.random((e, r)).astype(np.float32), -1)[:, ::-1].copy()
    hop = np.zeros(e, np.int32)
    fc = (rng.random(e) * 0.01).astype(np.float32) if fetch_cost else None
    jb = JM.BuddyState(jnp.asarray(resident), jnp.asarray(table),
                       jnp.asarray(q), jnp.asarray(hop),
                       fetch_cost=None if fc is None else jnp.asarray(fc))
    tb = M.BuddyState(_t(resident), _t(table), _t(q), _t(hop),
                      fetch_cost=None if fc is None else _t(fc))
    return jb, tb


def _compare(want, got):
    (wy, wa), (gy, ga) = want, got
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=TOL, atol=TOL)
    for name in MASKS:
        np.testing.assert_array_equal(getattr(ga, name).numpy(),
                                      np.asarray(getattr(wa, name)),
                                      err_msg=name)
    for name in COUNTS:
        assert int(getattr(ga, name)) == int(getattr(wa, name)), name
    np.testing.assert_allclose(ga.topk_probs.numpy(),
                               np.asarray(wa.topk_probs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(ga.lb_loss), float(wa.lb_loss),
                               rtol=1e-5)


# name: (E, K, shared, x shape, policy kwargs or None, buddy?, extra kwargs,
#        reference arms (use_kernel values) to compare against). The
#        reference's kernel arms (Pallas in interpret mode) are slow on the
#        CPU: they are taken where they differ from its jnp arms (the fused
#        path's capacity drops) and once for each kernel besides.
CASES = {
    "fused_decode": (16, 3, 1, (4, 1), dict(tau=0.0, beta=1.1, rho=2, H=4,
                                            use_fused_dispatch=True),
                     True, {}, (False,)),
    "fused_decode_drop_fallback": (16, 3, 0, (4, 1), dict(
        tau=0.0, beta=1.1, rho=1, H=2, fallback="drop",
        use_fused_dispatch=True), True, {}, (False,)),
    "fused_prefill_capacity_drops": (4, 2, 1, (2, 16), dict(
        tau=0.0, beta=1.1, use_fused_dispatch=True), True,
        {"capacity_factor": 0.5}, (True,)),
    # skipped (dropped) slots are never binned, so they take no capacity
    "fused_prefill_drop_fallback_capacity": (4, 2, 0, (2, 16), dict(
        mode="none", fallback="drop", use_fused_dispatch=True), True,
        {"capacity_factor": 0.5}, (True,)),
    "fused_dropless": (4, 2, 0, (2, 8), dict(use_fused_dispatch=True), True,
                       {"dropless": True}, (False,)),
    "gather_decode": (16, 3, 2, (4, 1), dict(tau=0.0, beta=1.1, rho=2, H=4),
                      True, {}, (False,)),
    "gather_mode_none": (16, 3, 0, (4, 1), dict(mode="none"), True, {},
                         (False,)),
    "capacity_prefill": (8, 2, 1, (2, 8), dict(tau=0.1, beta=1.1, rho=2),
                         True, {}, (False,)),
    "capacity_drops": (4, 2, 0, (2, 16), dict(tau=0.0, beta=1.1), True,
                       {"capacity_factor": 0.5}, (False, True)),
    "capacity_drop_fallback": (8, 2, 0, (2, 8), dict(fallback="drop"), True,
                               {}, (False,)),
    "capacity_dropless": (8, 3, 0, (3, 5), dict(tau=0.0, beta=1.1), True,
                          {"dropless": True}, (False,)),
    "capacity_flat_tokens": (8, 2, 0, (12,), dict(tau=0.0, beta=1.1), True,
                             {}, (False,)),
    "no_policy_with_buddy": (8, 2, 1, (2, 8), None, True, {}, (False,)),
    "no_policy_no_buddy": (8, 2, 1, (2, 8), None, False, {}, (False,)),
    "cost_mode_fused_cpu": (16, 3, 0, (4, 1), dict(
        tau=0.0, beta=1.1, miss_policy="cost", stall_per_quality=0.01,
        use_fused_dispatch=True), "cost", {}, (False,)),
    "eta_gather_cpu": (16, 3, 0, (4, 1), dict(tau=0.0, beta=1.1, eta=0.3),
                       True, {}, (False,)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches_reference(case):
    e, k, shared, shape, pol_kw, with_buddy, extra, arms = CASES[case]
    jcfg, cfg, jp, tp = _params(e, k, shared, seed=len(case))
    rng = np.random.default_rng(len(case))
    x = (rng.normal(size=(*shape, D)) * 0.5).astype(np.float32)
    jb = tb = None
    if with_buddy:
        jb, tb = _buddy(e, rng, fetch_cost=with_buddy == "cost")
    jpol = JPolicy(**pol_kw) if pol_kw is not None else None
    pol = BuddyPolicy(**pol_kw) if pol_kw is not None else None
    got = M.moe_forward(tp, _t(x), cfg, policy=pol, buddy=tb, **extra)
    for use_kernel in arms:
        want = _jmoe(jp, jnp.asarray(x), jcfg, policy=jpol, buddy=jb,
                     use_kernel=use_kernel, **extra)
        _compare(want, got)
    assert tuple(got[0].shape) == x.shape


def test_kernel_path_equals_full_substitute():
    """substitute_precedence (the kernel's route) and the full plain
    core.substitute agree in precedence mode, degraded/peer splits
    included."""
    from repro_torch.core.substitute import substitute
    rng = np.random.default_rng(4)
    e, k, t = 16, 4, 30
    _, tb = _buddy(e, rng, r=6)
    tb = tb._replace(quant_ok=_t(rng.random(e) < 0.3),
                     peer_ok=_t(rng.random(e) < 0.3))
    logits = _t(rng.normal(size=(t, e)).astype(np.float32))
    for mode in ("buddy", "none"):
        pol = BuddyPolicy(tau=0.1, beta=1.1, rho=2, H=5, mode=mode)
        _, idx, topk_logits, _, allow = M.router_topk(
            torch.eye(e), logits, k, tau=pol.tau)
        a = M.substitute_precedence(idx, allow, tb, pol)
        b = substitute(idx, topk_logits, tb.resident, tb.table, tb.q, pol,
                       quant_ok=tb.quant_ok, peer_ok=tb.peer_ok)
        for name in ("indices", "substituted", "missed", "allowed",
                     "dist_ok", "degraded", "dropped", "peered"):
            assert torch.equal(getattr(a, name), getattr(b, name)), \
                f"{mode}: {name}"


def test_quant_tier_waits_for_its_slice():
    _, cfg, _, tp = _params(8, 2, 0, seed=0)
    with pytest.raises(NotImplementedError):
        M.moe_forward(tp, torch.zeros(2, 1, D), cfg,
                      policy=BuddyPolicy(quant_tier="int8"))


def test_init_moe_shapes_and_scales():
    e, fs = 8, 2 * F
    cfg = MoEConfig(num_experts=e, top_k=2, d_ff=F, num_shared_experts=2)
    gen = torch.Generator().manual_seed(0)
    p = M.init_moe(gen, D, cfg, torch.float32, "cpu")
    jp = JM.init_moe(jax.random.PRNGKey(0), D, JMoEConfig(
        **dataclasses.asdict(cfg)), jnp.float32)
    # the reference's scales: one dense matrix per stacked tensor
    scale = {("router",): (2 / (D + e)) ** 0.5,
             ("w1",): (2 / (D + e * F)) ** 0.5,
             ("w2",): (2 / (D + e * F)) ** 0.5,
             ("shared", "w1"): (2 / (D + fs)) ** 0.5,
             ("shared", "w2"): (2 / (D + fs)) ** 0.5}
    for path, std in scale.items():
        a, b = p, jp
        for key in path:
            a, b = a[key], b[key]
        assert tuple(a.shape) == b.shape and a.is_contiguous()
        # different random streams, same distribution: std within 15%
        assert abs(float(a.std()) / std - 1.0) < 0.15, path
