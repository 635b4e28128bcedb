"""The port's quant tier against the JAX package's, on the CPU: quantization
(q and scales bit-equal; fidelity rtol 1e-5, f32 sums in another order),
the TieredExpertStore (exact: a copy), the quant_ffn plain version (f32
1e-5; bf16 8e-3, one bf16 rounding of outputs near 1 apart), and
``moe_forward`` with the tier on the fused, gather and capacity branches
(masks and counts exact; outputs 1e-5 against the reference's kernel arm,
which scales after the matmul as the port does, and 1e-4 against its jnp
megastep, which dequantizes before the matmul). The engine tests live in
tests/test_torch_tier_engine.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quant_ffn import quant_ffn_pallas  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.runtime.tiers import TieredExpertStore as JStore  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import quantize as pq  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quant_ffn import quant_ffn_plain  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.runtime.tiers import TieredExpertStore  # noqa: E402

D, F = 32, 64
TOL = 1e-5
MEGASTEP_TOL = 1e-4
QKEYS = ("w1_q", "w1_s", "w3_q", "w3_s", "w2_q", "w2_s")
_jmoe = jax.jit(JM.moe_forward, static_argnames=(
    "cfg", "policy", "capacity_factor", "use_kernel", "dropless"))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ quantization
class _Cfg:
    """Two MoE groups and a dense one, as cfg.stack() gives them."""

    @staticmethod
    def stack():
        return [("attn_moe", 2), ("attn_dense", 1), ("attn_moe", 1)]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_reference(bits):
    rng = np.random.default_rng(bits)
    w = (rng.normal(size=(3, 40, 24)) * 0.05).astype(np.float32)
    w[1, :, 5] = 0.0                           # an all-zero channel: scale 1
    qm = 2 ** (bits - 1) - 1                   # a channel with scale 1/16
    w[2, :, 3] = 0.0                           # and two exact half ties:
    w[2, :3, 3] = np.array([qm, 2.5, -3.5]) / 16  # half to even, 2 and -4
    jqv, jsv = jq.quantize_per_channel(jnp.asarray(w), bits)
    q, s = pq.quantize_per_channel(_t(w), bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert q[2, :3, 3].tolist() == [qm, 2, -4]
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))
    np.testing.assert_array_equal(pq.dequantize(q, s).numpy(),
                                  np.asarray(jq.dequantize(jqv, jsv)))

    groups = []
    for r in (2, 1, 1):
        g = {"moe": {n: (rng.normal(size=(r, 4, *shp)) * 0.05)
                     .astype(np.float32)
                     for n, shp in (("w1", (D, F)), ("w3", (D, F)),
                                    ("w2", (F, D)))}}
        groups.append(g)
    groups[1] = {"ffn": {"w1": np.zeros((1, D, F), np.float32)}}
    jparams = {"groups": tuple(jax.tree.map(jnp.asarray, g) for g in groups)}
    pparams = {"groups": tuple(jax.tree.map(_t, g) for g in groups)}
    jout, jfid = jq.attach_quant_tier(_Cfg, jparams, bits)
    pout, pfid = pq.attach_quant_tier(_Cfg, pparams, bits)
    assert pfid.shape == jfid.shape == (3, 4)
    np.testing.assert_allclose(pfid, jfid, rtol=1e-5)
    for gi in (0, 2):
        for k in QKEYS:
            got = pout["groups"][gi]["moe"]["quant"][k]
            assert got.is_contiguous() and got[0].is_contiguous()
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jout["groups"][gi]["moe"]["quant"][k]))
    assert "quant" not in pout["groups"][1].get("moe", {})
    assert "quant" not in pparams["groups"][0]["moe"]     # a shallow copy
    with pytest.raises(ValueError):
        pq.qmax_for_bits(3)


def test_checkpoint_carries_the_replicas():
    """params_from_numpy brings groups/<i>/moe/quant across; the int8 leaves
    stay int8 when a float dtype is asked for."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(2, 4, D, F)) * 0.05).astype(np.float32)
    qd = jq.quantize_expert_ffn(jnp.asarray(w), jnp.asarray(w),
                                jnp.asarray(w.swapaxes(-1, -2)), 8)
    flat = {"embed": np.zeros((8, D), np.float32),
            "groups/0/moe/w1": w}
    flat.update({f"groups/0/moe/quant/{k}": np.array(v)
                 for k, v in qd.items()})
    tree = params_from_numpy(flat, "cpu", dtype="bfloat16")
    quant = tree["groups"][0]["moe"]["quant"]
    assert set(quant) == set(QKEYS)
    for k in QKEYS:
        want = np.asarray(qd[k])
        if k.endswith("_q"):
            assert quant[k].dtype == torch.int8
            np.testing.assert_array_equal(quant[k].numpy(), want)
        else:
            assert quant[k].dtype == torch.bfloat16
    assert tree["groups"][0]["moe"]["w1"].dtype == torch.bfloat16


# ---------------------------------------------------------- tiered store
STORE_CASES = {
    # (L, E, cache_rate, bits, coverage, d_model, d_ff, stall_per_fidelity)
    "int8_full_width_clamped": (2, 64, 0.5, 8, 1.0, 2048, 1408, 0.05),
    "int8_full_width_half": (2, 64, 0.5, 8, 0.5, 2048, 1408, 0.05),
    "int4_full_width": (3, 64, 0.5, 4, 1.0, 2048, 1408, 0.05),
    "int8_small": (2, 16, 0.75, 8, 0.3, 128, 64, 0.01),
}


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_tiered_store_matches_reference(case):
    l_n, e_n, rate, bits, cov, d, f, spf = STORE_CASES[case]
    kw = dict(bits=bits, d_model=d, d_ff=f, stall_per_fidelity=spf,
              coverage=cov)
    js, ps = JStore(l_n, e_n, rate, **kw), TieredExpertStore(l_n, e_n, rate,
                                                             **kw)
    assert ps.budget_split() == js.budget_split()
    assert ps.cache.capacity == js.cache.capacity
    rng = np.random.default_rng(len(case))
    fid = rng.random((l_n, e_n)) * 0.02
    act = rng.random((l_n, e_n))
    for s in (js, ps):
        s.attach_fidelity(fid)
        s.set_coverage(act)
    np.testing.assert_array_equal(ps.covered, js.covered)
    np.testing.assert_array_equal(ps.effective_fidelity(),
                                  js.effective_fidelity())
    resident = rng.random((l_n, e_n)) < rate
    eta = rng.random((l_n, e_n)) * 2e-3
    np.testing.assert_array_equal(ps.degraded_ok(resident, eta),
                                  js.degraded_ok(resident, eta))
    ps.note_degraded(3)
    js.note_degraded(3)
    assert ps.summary() == js.summary()
    if case == "int8_full_width_clamped":
        # full width: a 553.6 MB budget per layer, 8.67 MB per replica
        split = ps.budget_split()
        assert split["clamped"] and split["cache_slots_per_layer"] == 1
    if case == "int8_full_width_half":
        assert ps.budget_split()["cache_slots_per_layer"] == 15


# ------------------------------------------------------------- quant_ffn
def _quant_setup(rng, e, c, d, f):
    x = (rng.normal(size=(e, c, d)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=shp) * 0.05).astype(np.float32)
          for shp in ((e, d, f), (e, d, f), (e, f, d))]
    qd = jq.quantize_expert_ffn(*map(jnp.asarray, ws), 8)
    return x, [np.asarray(qd[k]) for k in QKEYS]


@pytest.mark.parametrize("e,c,d,f", [(1, 8, 32, 64), (4, 24, 128, 96),
                                     (3, 37, 200, 136), (2, 1, 40, 24)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quant_ffn_plain_matches_ref(e, c, d, f, dtype):
    rng = np.random.default_rng(e * 31 + c)
    x, quant = _quant_setup(rng, e, c, d, f)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = jref.ref_quant_ffn(jnp.asarray(x, jdt), *map(jnp.asarray, quant))
    got = quant_ffn_plain(_t(x).to(tdt), *map(_t, quant))
    assert got.dtype == tdt
    # bf16 x is exact in f32 and the compute is f32 on both sides; only the
    # final cast to bf16 rounds, the same way
    tol = TOL if dtype is np.float32 else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_quant_ffn_plain_matches_pallas():
    rng = np.random.default_rng(3)
    x, quant = _quant_setup(rng, 2, 20, 32, 72)
    want = quant_ffn_pallas(*map(jnp.asarray, (x, *quant)), block_c=8,
                            block_f=32, interpret=True)
    got = quant_ffn_plain(_t(x), *map(_t, quant))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_quant_ffn_counts_mark_unfilled_rows():
    """Rows at or past counts[e] come back zero whatever they hold, and an
    expert with no rows is all zero; ops.quant_ffn takes the plain version
    on the CPU and launches nothing."""
    rng = np.random.default_rng(7)
    e, c, d, f = 4, 6, 32, 48
    x, quant = _quant_setup(rng, e, c, d, f)
    counts = np.array([0, 3, 6, 1], np.int32)
    filled = np.arange(c)[None, :] < counts[:, None]
    want = np.asarray(jref.ref_quant_ffn(
        jnp.asarray(x * filled[..., None]), *map(jnp.asarray, quant)))
    before = ops.launch_counts()
    got = ops.quant_ffn(_t(x), *map(_t, quant), counts=_t(counts)).numpy()
    assert ops.launch_counts() == before
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[~filled], 0.0)
    np.testing.assert_array_equal(got[0], 0.0)


# ------------------------------------------------------------ moe_forward
def _params(e, k, shared, seed, bits):
    kw = dict(num_experts=e, top_k=k, d_ff=F, num_shared_experts=shared)
    jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
    jp = JM.init_moe(jax.random.PRNGKey(seed), D, jcfg, jnp.float32)
    jp = dict(jp, quant=jq.quantize_expert_ffn(jp["w1"], jp["w3"], jp["w2"],
                                               bits))
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    fid = jq.expert_fidelity(jp["w1"], jp["w3"], jp["w2"], jp["quant"])
    return jcfg, cfg, jp, tp, np.asarray(fid, np.float32)


def _buddy(e, rng, fid, cost: bool, r=4):
    resident = rng.random(e) < 0.4
    table = np.stack([np.roll(np.arange(e), -i - 1)[:r]
                      for i in range(e)]).astype(np.int32)
    q = np.sort(rng.random((e, r)).astype(np.float32), -1)[:, ::-1].copy()
    hop = np.zeros(e, np.int32)
    if cost:
        extra = dict(fid_cost=(0.05 * fid).astype(np.float32),
                     fetch_cost=(rng.random(e) * 2e-3).astype(np.float32))
    else:
        extra = dict(quant_ok=rng.random(e) < 0.6)
    jb = JM.BuddyState(*map(jnp.asarray, (resident, table, q, hop)),
                       **{k: jnp.asarray(v) for k, v in extra.items()})
    tb = M.BuddyState(*map(_t, (resident, table, q, hop)),
                      **{k: _t(v) for k, v in extra.items()})
    return jb, tb


MASKS = ("indices", "orig_indices", "sub_slots", "miss_slots", "deg_slots",
         "drop_slots", "peer_slots", "miss_per_expert")
COUNTS = ("n_substituted", "n_missed", "n_dropped", "n_degraded",
          "n_miss_drop", "n_peered")

# name: (E, K, shared, x shape, policy kwargs, cost?, bits, extra kwargs,
#        reference arms as (use_kernel, tolerance))
TIER_CASES = {
    "fused_decode_int8": (16, 3, 1, (4, 1), dict(
        tau=0.0, beta=1.1, rho=1, H=2, use_fused_dispatch=True), False, 8,
        {}, ((True, TOL), (False, MEGASTEP_TOL))),
    "fused_prefill_int4_capacity": (8, 2, 0, (2, 12), dict(
        tau=0.0, beta=1.1, rho=1, quant_tier="int4",
        use_fused_dispatch=True), False, 4, {"capacity_factor": 0.75},
        ((True, TOL),)),
    "fused_decode_drop_fallback": (16, 3, 0, (4, 1), dict(
        mode="none", fallback="drop", use_fused_dispatch=True), False, 8, {},
        ((False, MEGASTEP_TOL),)),
    "gather_decode_int8": (16, 3, 2, (4, 1), dict(tau=0.0, beta=1.1, rho=1,
                                                  H=2), False, 8, {},
                           ((False, TOL),)),
    "gather_mode_none_int4": (16, 2, 0, (5, 1), dict(
        mode="none", quant_tier="int4"), False, 4, {}, ((False, TOL),)),
    "capacity_prefill_int8": (8, 2, 1, (2, 8), dict(tau=0.1, beta=1.1,
                                                    rho=1), False, 8, {},
                              ((False, TOL), (True, TOL))),
    "capacity_drops_flat": (4, 2, 0, (12,), dict(tau=0.0, beta=1.1), False,
                            8, {"capacity_factor": 0.5}, ((False, TOL),)),
    "cost_mode_fused_cpu": (16, 3, 0, (4, 1), dict(
        tau=0.0, beta=1.1, miss_policy="cost", stall_per_quality=0.05,
        use_fused_dispatch=True), True, 8, {}, ((True, TOL),)),
    "cost_mode_gather_cpu": (16, 3, 0, (4, 1), dict(
        tau=0.0, beta=1.1, miss_policy="cost", stall_per_quality=0.05),
        True, 8, {}, ((False, TOL),)),
}


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_moe_forward_tier_matches_reference(case):
    e, k, shared, shape, pol_kw, cost, bits, extra, arms = TIER_CASES[case]
    pol_kw = dict({"quant_tier": "int8"}, **pol_kw)
    jcfg, cfg, jp, tp, fid = _params(e, k, shared, len(case), bits)
    rng = np.random.default_rng(len(case))
    x = (rng.normal(size=(*shape, D)) * 0.5).astype(np.float32)
    jb, tb = _buddy(e, rng, fid, cost)
    got = M.moe_forward(tp, _t(x), cfg, policy=BuddyPolicy(**pol_kw),
                        buddy=tb, **extra)
    (gy, ga) = got
    assert int(ga.n_degraded) > 0, "the tier served no slot"
    for use_kernel, tol in arms:
        wy, wa = _jmoe(jp, jnp.asarray(x), jcfg, policy=JPolicy(**pol_kw),
                       buddy=jb, use_kernel=use_kernel, **extra)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=tol,
                                   atol=tol, err_msg=f"use_kernel={use_kernel}")
        for name in MASKS:
            np.testing.assert_array_equal(getattr(ga, name).numpy(),
                                          np.asarray(getattr(wa, name)),
                                          err_msg=name)
        for name in COUNTS:
            assert int(getattr(ga, name)) == int(getattr(wa, name)), name
    assert tuple(gy.shape) == x.shape


def test_tier_is_gated_like_the_reference():
    """quant_ok and fid_cost pass only when the tier runs (policy on AND
    replicas in the params): without replicas the buddy's quant_ok is
    ignored, exactly as the reference ignores it."""
    jcfg, cfg, jp, tp, fid = _params(16, 3, 0, 1, 8)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 1, D)) * 0.5).astype(np.float32)
    jb, tb = _buddy(16, rng, fid, cost=False)
    tp_plain = {k: v for k, v in tp.items() if k != "quant"}
    jp_plain = {k: v for k, v in jp.items() if k != "quant"}
    for pol_kw in (dict(), dict(quant_tier="int8")):
        pol = BuddyPolicy(tau=0.0, beta=1.1, **pol_kw)
        gy, ga = M.moe_forward(tp_plain, _t(x), cfg, policy=pol, buddy=tb)
        wy, wa = _jmoe(jp_plain, jnp.asarray(x), jcfg,
                       policy=JPolicy(tau=0.0, beta=1.1, **pol_kw), buddy=jb)
        assert int(ga.n_degraded) == int(wa.n_degraded) == 0
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=TOL,
                                   atol=TOL)
    # tier off with replicas present: the same ungated case
    gy2, ga2 = M.moe_forward(tp, _t(x), cfg,
                             policy=BuddyPolicy(tau=0.0, beta=1.1), buddy=tb)
    assert int(ga2.n_degraded) == 0
    np.testing.assert_array_equal(gy2.numpy(), gy.numpy())
