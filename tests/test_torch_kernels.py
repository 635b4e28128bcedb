"""Plain PyTorch versions of the four ported kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and their oracles in
``repro.kernels.ref``, on the same numpy inputs. The CUDA kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.buddy_substitute import (  # noqa: E402
    buddy_substitute_cuda, buddy_substitute_plain)
from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,  # noqa: E402
                                            expert_ffn_plain, launch_plan)
from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,  # noqa: E402
                                             grouped_ffn_plain)
from repro_torch.kernels.quant_ffn import quant_ffn_cuda  # noqa: E402
from repro_torch.kernels.route import route_cuda  # noqa: E402
from repro_torch.kernels.topk_gate import (topk_gate_cuda,  # noqa: E402
                                           topk_gate_plain)

# f32: both sides sum the same products in another order -> ~1e-6 relative;
# bf16: the hidden product is rounded to bf16 between the matmuls on both
# sides, and one-ulp rounding flips can differ (as tests/test_kernels.py)
TOL = {np.float32: 2e-4, "bfloat16": 5e-2}


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


# ---------------------------------------------------------------- topk_gate
@pytest.mark.parametrize("t,e,k", [(1, 4, 1), (64, 8, 2), (300, 64, 6),
                                   (100, 16, 4), (5, 256, 16)])
def test_topk_gate_matches_pallas(t, e, k):
    rng = np.random.default_rng(t + e)
    z = rng.normal(size=(t, e)).astype(np.float32)
    tau = 0.4
    want = jops.topk_gate(jnp.asarray(z), tau, k=k)
    got = topk_gate_plain(_t(z), tau, k=k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("scale", [0.0, 1.0, 2.0])
def test_topk_gate_ties_to_smallest_index(scale):
    """Logits on a coarse grid tie often: the plain version, the Pallas
    kernel and lax.top_k all take the smallest index first. Signed zeros
    are normalized first: lax.top_k orders -0.0 below +0.0, while the plain
    version and the CUDA kernel treat them as the tie they compare as."""
    rng = np.random.default_rng(7)
    z = (np.round(rng.normal(size=(32, 16)) * scale) + 0.0).astype(np.float32)
    got = topk_gate_plain(_t(z), 0.5, k=5)
    for want in (jops.topk_gate(jnp.asarray(z), 0.5, k=5),
                 ref.ref_topk_gate(jnp.asarray(z), 0.5, k=5)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# --------------------------------------------------------- buddy_substitute
def _buddy_setup(rng, t, e, k, r):
    s = np.stack([rng.choice(e, k, replace=False)
                  for _ in range(t)]).astype(np.int32)
    gate = rng.random(t) < 0.7
    resident = rng.random(e) < 0.5
    table = np.full((e, r), -1, np.int32)
    q = np.zeros((e, r), np.float32)
    for i in range(e):
        n = int(rng.integers(1, r + 1))
        peers = rng.choice([x for x in range(e) if x != i], n, replace=False)
        table[i, :n] = peers
        q[i, :n] = np.sort(rng.random(n))[::-1]
    return s, gate, resident, table, q


@pytest.mark.parametrize("t,e,k,r,h,rho", [
    (1, 4, 1, 2, 2, 1),
    (17, 8, 2, 4, 4, 2),
    (100, 16, 4, 6, 4, 2),
    (256, 64, 6, 16, 8, 3),     # the paper's DeepSeek-V2-Lite regime
    (300, 8, 2, 8, 8, 8),
])
def test_buddy_substitute_matches_pallas(t, e, k, r, h, rho):
    rng = np.random.default_rng(t * 1000 + e)
    args = _buddy_setup(rng, t, e, k, r)
    want = jops.buddy_substitute(*map(jnp.asarray, args), h=h, rho=rho)
    oracle = ref.ref_buddy_substitute(*args, h=h, rho=rho)
    got = buddy_substitute_plain(*map(_t, args), h=h, rho=rho)
    for g, w, o, name in zip(got, want, oracle,
                             ("indices", "substituted", "missed")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(o), err_msg=name)


def test_buddy_substitute_equal_q_takes_lower_rank():
    """Equal Psi: the rank tie-break picks the earlier table entry."""
    s = np.array([[0, 1]], np.int32)
    resident = np.array([False, True, True, True])
    table = np.array([[3, 2, -1], [0, 2, 3], [0, 1, 3], [0, 1, 2]], np.int32)
    q = np.full((4, 3), 0.5, np.float32)
    got = buddy_substitute_plain(_t(s), _t(np.array([True])), _t(resident),
                                 _t(table), _t(q), h=3, rho=2)
    want = ref.ref_buddy_substitute(s, np.array([True]), resident, table, q,
                                    h=3, rho=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][0, 0]) == 3


def test_buddy_substitute_matches_core_substitute():
    """Kernel contract + gates computed the same way == the JAX package's
    core.substitute in precedence mode (the in-model reference)."""
    from repro.core.gates import distribution_gate, token_gate
    from repro.core.policy import BuddyPolicy
    from repro.core.substitute import substitute

    rng = np.random.default_rng(42)
    t, e, k, r = 50, 16, 4, 6
    s, _, resident, table, q = _buddy_setup(rng, t, e, k, r)
    logits = rng.normal(size=(t, k)).astype(np.float32)
    pol = BuddyPolicy(tau=0.3, beta=0.9, rho=k, H=r)
    res = substitute(jnp.asarray(s), jnp.asarray(logits),
                     jnp.asarray(resident), jnp.asarray(table),
                     jnp.asarray(q), pol)
    gate = np.asarray(token_gate(jnp.asarray(logits), pol.tau)) \
        & bool(distribution_gate(jnp.asarray(s), jnp.asarray(resident),
                                 pol.beta))
    got = buddy_substitute_plain(_t(s), _t(gate), _t(resident), _t(table),
                                 _t(q), h=pol.H, rho=pol.rho)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(res.indices))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(res.substituted))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(res.missed))


# --------------------------------------------------------------- expert_ffn
def _ffn_weights(rng, e, d, f):
    return [(rng.normal(size=shape) * 0.05).astype(np.float32)
            for shape in ((e, d, f), (e, d, f), (e, f, d))]


@pytest.mark.parametrize("e,c,d,f", [(1, 8, 32, 64), (4, 96, 128, 384),
                                     (8, 100, 64, 200), (3, 7, 40, 24)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_expert_ffn_matches_ref(e, c, d, f, dtype):
    rng = np.random.default_rng(e * 100 + c)
    x = (rng.normal(size=(e, c, d)) * 0.1).astype(np.float32)
    ws = _ffn_weights(rng, e, d, f)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = ref.ref_expert_ffn(*[jnp.asarray(a, jdt) for a in (x, *ws)])
    got = expert_ffn_plain(*[_t(a).to(tdt) for a in (x, *ws)])
    assert got.dtype == tdt and tuple(got.shape) == (e, c, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_expert_ffn_matches_pallas_tiles():
    """The Pallas kernel with ragged C/F tiles (its padding path) agrees."""
    rng = np.random.default_rng(3)
    e, c, d, f = 2, 20, 32, 48
    x = (rng.normal(size=(e, c, d)) * 0.1).astype(np.float32)
    ws = _ffn_weights(rng, e, d, f)
    want = jops.expert_ffn(*map(jnp.asarray, (x, *ws)), block_c=8,
                           block_f=32)
    got = expert_ffn_plain(*map(_t, (x, *ws)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# -------------------------------------------------------------- grouped_ffn
def _grouped_setup(rng, e, c, d, f):
    from repro.core.quantize import quantize_expert_ffn
    x = (rng.normal(size=(2 * e, c, d)) * 0.1).astype(np.float32)
    ws = _ffn_weights(rng, e, d, f)
    qd = quantize_expert_ffn(*map(jnp.asarray, ws), 8)
    quant = [np.asarray(qd[k]) for k in ("w1_q", "w1_s", "w3_q", "w3_s",
                                         "w2_q", "w2_s")]
    return x, ws, quant


@pytest.mark.parametrize("e,c,d,f", [(1, 8, 32, 64), (4, 24, 128, 96),
                                     (8, 10, 64, 200)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_grouped_ffn_int8_half_matches_ref(e, c, d, f, dtype):
    """Groups [0, E) follow expert_ffn numerics in x.dtype, [E, 2E) the
    int8 replica with post-matmul scales, all in f32."""
    rng = np.random.default_rng(e * 77 + c)
    x, ws, quant = _grouped_setup(rng, e, c, d, f)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = ref.ref_grouped_ffn(*[jnp.asarray(a, jdt) for a in (x, *ws)],
                               *map(jnp.asarray, quant))
    got = grouped_ffn_plain(*[_t(a).to(tdt) for a in (x, *ws)],
                            tuple(map(_t, quant)))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_grouped_ffn_matches_pallas():
    rng = np.random.default_rng(11)
    e, c, d, f = 2, 16, 32, 64
    x, ws, quant = _grouped_setup(rng, e, c, d, f)
    want = jops.grouped_ffn(*[jnp.asarray(a) for a in (x, *ws, *quant)],
                            block_c=16, block_f=32)
    got = grouped_ffn_plain(_t(x), *map(_t, ws), tuple(map(_t, quant)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("empty", ["fp", "degraded", "both"])
def test_grouped_ffn_empty_groups(empty):
    """Empty groups come back exactly zero, on both sides."""
    rng = np.random.default_rng(9)
    e, c, d, f = 2, 16, 32, 64
    x, ws, quant = _grouped_setup(rng, e, c, d, f)
    mask = np.ones((2 * e, 1, 1), np.float32)
    if empty in ("fp", "both"):
        mask[:e] = 0.0
    if empty in ("degraded", "both"):
        mask[e:] = 0.0
    x = x * mask
    want = np.asarray(ref.ref_grouped_ffn(
        *[jnp.asarray(a) for a in (x, *ws, *quant)]))
    got = grouped_ffn_plain(_t(x), *map(_t, ws), tuple(map(_t, quant))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got[mask[:, 0, 0] == 0.0], 0.0)


def test_grouped_ffn_counts_and_no_replicas():
    """Row counts mark rows past them unfilled (they were zero in the
    binned buffer, so nothing changes); without replicas the degraded half
    is empty and comes back zero."""
    rng = np.random.default_rng(5)
    e, c, d, f = 4, 6, 32, 48
    x, ws, _ = _grouped_setup(rng, e, c, d, f)
    counts = np.array([0, 3, 6, 1] + [0] * e, np.int32)
    x[np.arange(c)[None, :] >= counts[:, None]] = 0.0
    want = np.asarray(ref.ref_grouped_ffn(
        *[jnp.asarray(a) for a in (x, *ws)],
        jnp.zeros((e, d, f), jnp.int8), jnp.ones((e, f)),
        jnp.zeros((e, d, f), jnp.int8), jnp.ones((e, f)),
        jnp.zeros((e, f, d), jnp.int8), jnp.ones((e, d))))
    for cnt in (None, _t(counts)):
        got = grouped_ffn_plain(_t(x), *map(_t, ws), None, cnt).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(got[e:], 0.0)


# ------------------------------------------------- the shared FFN tile's plan
# (t_size, groups, C, D, F, fp class, int8 class): the main path's shapes
PATH_SHAPES = [(4, 64, 32, 2048, 1408, True, False),    # expert_ffn capacity
               (4, 128, 24, 2048, 1408, True, True),    # grouped_ffn decode
               (4, 128, 24, 2048, 1408, True, False),   # ... without a tier
               (4, 64, 24, 2048, 1408, False, True),    # quant_ffn gather
               (2, 64, 32, 2048, 1408, True, False)]    # bf16 activations


@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_launch_plan_path_shapes_take_16_byte_copies(shape):
    t, g, c, d, f, fp, q = shape
    plan = launch_plan(t, g, c, d, f, fp=fp, int8=q, ptrs=[0, 4096, 1 << 20])
    assert plan["instance"] == "vec16" and plan["stages"] >= 3
    assert plan["grid_gate_up"] == (-(-f // 128), -(-c // 32), g)
    assert plan["grid_down"] == (-(-d // 128), -(-c // 32), g)
    assert max(plan["smem_gate_up"], plan["smem_down"]) <= 227 * 1024


# the card tests' shapes (tests/test_torch_cuda.py): (t_size, groups, C, D,
# F, fp, int8, instance)
CARD_SHAPES = [(4, 1, 8, 32, 64, True, False, "vec16"),
               (4, 4, 37, 200, 136, True, False, "vec16"),
               (2, 4, 37, 200, 136, True, False, "vec16"),
               (4, 2, 70, 64, 33, True, False, "elem"),
               (2, 2, 70, 64, 33, True, False, "elem"),
               (4, 3, 1, 40, 24, True, False, "vec16"),
               (2, 3, 1, 40, 24, True, False, "vec16"),
               (4, 12, 12, 96, 80, True, True, "vec16"),
               (2, 12, 12, 96, 80, True, True, "vec16"),
               (4, 6, 33, 96, 80, True, True, "vec16"),
               (4, 4, 11, 64, 33, True, True, "elem"),
               (4, 4, 11, 200, 64, True, True, "elem"),
               (4, 4, 11, 64, 24, True, True, "elem"),
               (4, 3, 37, 200, 136, False, True, "elem"),
               (2, 2, 1, 40, 24, False, True, "elem"),
               (4, 5, 70, 64, 33, False, True, "elem")]


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_launch_plan_ragged_shapes(shape):
    """Rows that are not a multiple of 16 bytes take the element-copy
    instance of the same tile; the shared memory fits either way."""
    t, g, c, d, f, fp, q, instance = shape
    plan = launch_plan(t, g, c, d, f, fp=fp, int8=q)
    assert plan["instance"] == instance
    w = t if fp else 1
    assert plan["smem_gate_up"] == 4 * (32 * 16 * t + 2 * 16 * 128 * w)
    assert plan["smem_down"] == 4 * (32 * 16 * 4 + 16 * 128 * w)
    assert max(plan["smem_gate_up"], plan["smem_down"]) <= 227 * 1024


@pytest.mark.parametrize("ptr", [4, 8, 12, 4096 + 2])
def test_launch_plan_refuses_misaligned_pointers(ptr):
    with pytest.raises(ValueError, match="16-byte"):
        launch_plan(4, 64, 32, 2048, 1408, ptrs=[0, ptr])


# ----------------------------------------------------------------- dispatch
def test_ops_cpu_tensors_take_the_plain_versions():
    """CPU tensors never launch: the counts stay where they were."""
    rng = np.random.default_rng(1)
    before = ops.launch_counts()
    z = _t(rng.normal(size=(8, 16)).astype(np.float32))
    assert torch.equal(ops.topk_gate(z, 0.2, k=4)[0],
                       topk_gate_plain(z, 0.2, k=4)[0])
    s, gate, resident, table, q = map(_t, _buddy_setup(rng, 8, 16, 4, 6))
    for g, w in zip(ops.buddy_substitute(s, gate, resident, table, q),
                    buddy_substitute_plain(s, gate, resident, table, q)):
        assert torch.equal(g, w)
    x = _t((rng.normal(size=(2, 3, 8)) * 0.1).astype(np.float32))
    ws = list(map(_t, _ffn_weights(rng, 2, 8, 4)))
    assert torch.equal(ops.expert_ffn(x, *ws), expert_ffn_plain(x, *ws))
    xg = torch.cat([x, torch.zeros_like(x)])
    assert torch.equal(ops.grouped_ffn(xg, *ws),
                       grouped_ffn_plain(xg, *ws))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("name", ["topk_gate", "buddy_substitute",
                                  "expert_ffn", "grouped_ffn", "quant_ffn",
                                  "route"])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """A CUDA wrapper launches or raises: given CPU tensors it raises before
    building anything, and never falls back to the plain version."""
    rng = np.random.default_rng(2)
    z = _t(rng.normal(size=(4, 8)).astype(np.float32))
    x = _t(np.zeros((4, 3, 8), np.float32))
    ws = list(map(_t, _ffn_weights(rng, 2, 8, 4)))
    calls = {
        "topk_gate": lambda: topk_gate_cuda(z, 0.2, k=2),
        "buddy_substitute": lambda: buddy_substitute_cuda(
            *map(_t, _buddy_setup(rng, 4, 8, 2, 3))),
        "expert_ffn": lambda: expert_ffn_cuda(x[:2], *ws),
        "grouped_ffn": lambda: grouped_ffn_cuda(x, *ws),
        "quant_ffn": lambda: quant_ffn_cuda(
            x[:2], ws[0].to(torch.int8), ws[0][:, 0], ws[1].to(torch.int8),
            ws[1][:, 0], ws[2].to(torch.int8), ws[2][:, 0]),
        "route": lambda: route_cuda(
            z, 0.2, 1.1, *map(_t, _buddy_setup(rng, 4, 8, 2, 3)[2:]), k=2),
    }
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        calls[name]()
    assert ops.launch_counts() == before
