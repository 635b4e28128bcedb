"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, and the model path on the card against the same path on the CPU.
These need an NVIDIA GPU with the CUDA toolkit and skip elsewhere. This
file imports no JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import quantize  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.buddy_substitute import (  # noqa: E402
    buddy_substitute_cuda, buddy_substitute_plain)
from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,  # noqa: E402
                                            expert_ffn_plain, launch_plan)
from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,  # noqa: E402
                                             grouped_ffn_plain)
from repro_torch.kernels.quant_ffn import (quant_ffn_cuda,  # noqa: E402
                                           quant_ffn_plain, quant_operands)
from repro_torch.kernels import route as route_mod  # noqa: E402
from repro_torch.kernels.route import launch_plan as route_plan  # noqa
from repro_torch.kernels.route import (CLUSTER_T, ROWS_PER_CTA,  # noqa: E402
                                       Route, compiled_form, route_cuda,
                                       route_plain)
from repro_torch.kernels.topk_gate import (topk_gate_cuda,  # noqa: E402
                                           topk_gate_plain)
from repro_torch.kernels.wkv_chunk import (wkv_chunk_cuda,  # noqa: E402
                                           wkv_chunk_plain)
from repro_torch.kernels.wkv_chunk import stages as wkv_stages  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from _signed_zeros import ZEROS_ROW, signed_zero_rows  # noqa: E402

pytestmark = pytest.mark.cuda
# f32 sums over D or F in another order; bf16 hidden products may round one
# ulp apart before the second matmul
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("t,e,k", [(1, 4, 1), (4, 64, 6), (300, 64, 6),
                                   (33, 256, 16), (9, 40, 3)])
@pytest.mark.parametrize("grid", [False, True])
def test_topk_gate(dev, t, e, k, grid):
    z = torch.randn(t, e, generator=_gen(t + e))
    if grid:                          # many ties
        z = (z * 2).round() + 0.0
    z = z.to(dev)
    before = topk_gate_cuda.launches
    got = topk_gate_cuda(z, 0.3, k=k)
    assert topk_gate_cuda.launches == before + 1
    want = topk_gate_plain(z, 0.3, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[4], want[4])
    for g, w in zip(got[1:4], want[1:4]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def _buddy_inputs(seed, t, e, k, r, dev):
    g = _gen(seed)
    s = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(t)])
    table = torch.stack([torch.randperm(e, generator=g)[:r]
                         for _ in range(e)]).to(torch.int32)
    table[torch.rand(e, r, generator=g) < 0.2] = -1
    q = torch.rand(e, r, generator=g).sort(-1, descending=True).values
    return (s.to(torch.int32).to(dev), (torch.rand(t, generator=g) < 0.7)
            .to(dev), (torch.rand(e, generator=g) < 0.5).to(dev),
            table.to(dev), q.to(dev))


@pytest.mark.parametrize("t,e,k,r,h,rho", [(1, 4, 1, 2, 2, 1),
                                           (4, 64, 6, 8, 8, 3),
                                           (256, 64, 6, 16, 8, 3),
                                           (300, 8, 2, 8, 8, 8)])
def test_buddy_substitute(dev, t, e, k, r, h, rho):
    args = _buddy_inputs(t * 7 + e, t, e, k, r, dev)
    got = buddy_substitute_cuda(*args, h=h, rho=rho)
    want = buddy_substitute_plain(*args, h=h, rho=rho)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


ROUTE_INTS = ("idx", "allow", "dist_ok", "new_idx", "substituted", "missed",
              "degraded", "peered", "dropped")


def _route_check(args, kw):
    """route_cuda against route_plain on the card: one launch count per
    call, every int and bool output equal, probs and TAE within 1e-6."""
    before = route_cuda.launches
    got = route_cuda(*args, **kw)
    assert route_cuda.launches == before + 1
    want = route_plain(*args, **kw)
    for name in ROUTE_INTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("topk_logits", "probs", "tae"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=1e-6)
    return got


# the earlier cases, the CTA and cluster boundaries, and clusters of 3, 5
# and 7 CTAs
ROUTE_T = sorted({1, 4, 32, 33, 255, 256, 257, 4096, ROWS_PER_CTA,
                  ROWS_PER_CTA + 1, CLUSTER_T, CLUSTER_T + 1}
                 | {n * ROWS_PER_CTA - 1 for n in (3, 5, 7)
                    if n * ROWS_PER_CTA <= CLUSTER_T})


@pytest.mark.parametrize("t", ROUTE_T)
@pytest.mark.parametrize("case", ["plain", "ties_masks", "none_masks",
                                  "quant_only"])
def test_route(dev, t, case):
    e, k, r = 64, 6, 8
    g = _gen(t * 13 + len(case))
    z = torch.randn(t, e, generator=g)
    if "ties" in case:
        z = (z * 1.5).round() + 0.0
    table = torch.stack([torch.randperm(e, generator=g)[:r]
                         for _ in range(e)]).to(torch.int32)
    table[:, r // 2:][torch.rand(e, r - r // 2, generator=g) < 0.3] = -1
    q = torch.rand(e, r, generator=g).sort(-1, descending=True).values
    resident = torch.rand(e, generator=g) < 0.5
    masks = {}
    if case != "plain":
        masks["quant_ok"] = (torch.rand(e, generator=g) < 0.4).to(dev)
    if case in ("ties_masks", "none_masks"):
        masks["peer_ok"] = (torch.rand(e, generator=g) < 0.4).to(dev)
    args = (z.to(dev), 0.2, 1.1, resident.to(dev), table.to(dev), q.to(dev))
    got = _route_check(args, dict(k=k, h=8, rho=3,
                                       substitute=case != "none_masks",
                                       **masks))
    assert route_plan(t, k).launches == (1 if t <= CLUSTER_T else 2)
    if case == "none_masks":
        assert not got.substituted.any()


@pytest.mark.parametrize("t,e,k", [(1, 4, 2), (4, 64, 6), (33, 256, 16),
                                   (40, 8, 1), (300, 64, 6)])
def test_signed_zeros(dev, t, e, k):
    """Rows of mixed +-0.0, and rows whose k-th place falls among zeros of
    both signs: topk_gate and route on the card pick what their plain
    versions pick (-0.0 below +0.0, as lax.top_k), with the signs kept."""
    z = torch.from_numpy(signed_zero_rows(t * 3 + e, t, e, k)).to(dev)
    got, want = topk_gate_cuda(z, 0.3, k=k), topk_gate_plain(z, 0.3, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[4], want[4])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    g = _gen(t + e)
    table = torch.stack([torch.randperm(e, generator=g)[:min(8, e - 1)]
                         for _ in range(e)]).to(torch.int32)
    q = torch.rand(table.shape, generator=g).sort(-1, descending=True).values
    resident = torch.rand(e, generator=g) < 0.5
    args = (z, 0.2, 1.1, resident.to(dev), table.to(dev), q.to(dev))
    got = _route_check(args, dict(k=k, h=8, rho=3))
    assert torch.equal(got.topk_logits.view(torch.int32),
                       want[1].view(torch.int32))
    if t == 1:
        zeros = torch.from_numpy(ZEROS_ROW).to(dev)
        assert topk_gate_cuda(zeros, 0.3, k=2)[0].tolist() == [[1, 3]]


@pytest.mark.parametrize("t", [2, 258])
@pytest.mark.parametrize("above", [False, True])
def test_route_distribution_gate_at_beta(dev, t, above):
    """2 of 8 requested experts non-resident, delta = 0.25 exactly: the
    gate is shut at beta = 0.25 and open one f32 ulp above, in a cluster of
    one CTA and in the two-launch form."""
    e = 16
    z = torch.full((t, e), -5.0)
    z[0::2, :4] = torch.tensor([4.0, 3.0, 2.0, 1.0])
    z[1::2, 4:8] = torch.tensor([4.0, 3.0, 2.0, 1.0])
    resident = torch.ones(e, dtype=torch.bool)
    resident[[0, 4]] = False
    table = torch.stack([torch.roll(torch.arange(e), -i - 1)[:4]
                         for i in range(e)]).to(torch.int32)
    q = torch.full((e, 4), 0.5)
    beta = 0.25
    if above:
        beta = float(torch.nextafter(torch.tensor(0.25),
                                     torch.tensor(1.0)))
    got = _route_check((z.to(dev), -1.0, beta, resident.to(dev),
                             table.to(dev), q.to(dev)), dict(k=4, h=4))
    assert bool(got.dist_ok) is above
    assert bool(got.substituted.any()) is above


def test_route_form_is_launch_plan(dev):
    """The built csrc/route.cu runs each T as launch_plan says: one launch
    of ceil(T / ROWS_PER_CTA) CTAs up to CLUSTER_T, two launches above."""
    for t in range(1, 2 * CLUSTER_T + 2):
        plan = route_plan(t, 6)
        assert compiled_form(t) == (plan.launches, plan.ctas), t


@pytest.mark.parametrize("t", [ROWS_PER_CTA + 3, CLUSTER_T])
@pytest.mark.parametrize("above", [False, True])
def test_route_distribution_gate_on_the_last_cta(dev, t, above):
    """Only the rows of the cluster's last CTA request non-resident
    experts: the other CTAs' rows take experts 8-11 (resident), the last
    CTA's alternate {0, 1, 2, 3} and {4, 5, 6, 7}, 0 and 4 not resident.
    delta = 2 / 12 in f32: the gate is shut at beta = delta and open one
    f32 ulp above, in every CTA (the last CTA's rows substitute only when
    it is open)."""
    e = 16
    n = route_plan(t, 4).ctas
    assert n >= 2
    last = (n - 1) * ROWS_PER_CTA
    z = torch.full((t, e), -5.0)
    z[:last, 8:12] = torch.tensor([4.0, 3.0, 2.0, 1.0])
    z[last::2, :4] = torch.tensor([4.0, 3.0, 2.0, 1.0])
    z[last + 1::2, 4:8] = torch.tensor([4.0, 3.0, 2.0, 1.0])
    resident = torch.ones(e, dtype=torch.bool)
    resident[[0, 4]] = False
    table = torch.stack([torch.roll(torch.arange(e), -i - 1)[:4]
                         for i in range(e)]).to(torch.int32)
    q = torch.full((e, 4), 0.5)
    delta = torch.tensor(2.0) / torch.tensor(12.0)
    beta = float(torch.nextafter(delta, torch.tensor(1.0)) if above
                 else delta)
    got = _route_check((z.to(dev), -1.0, beta, resident.to(dev),
                        table.to(dev), q.to(dev)), dict(k=4, h=4))
    assert bool(got.dist_ok) is above
    assert bool(got.substituted[last:].any()) is above
    assert not got.substituted[:last].any()


def test_route_refused_launch_raises(dev, monkeypatch):
    """A launch the card refuses (its cudaError returned by route_launch)
    raises in route_cuda: no fallback to the grid form or to route_plain,
    and no launch counted."""
    class Refusing:
        @staticmethod
        def route_launch(*args):
            return 2            # cudaErrorMemoryAllocation

    monkeypatch.setattr(route_mod, "_lib", Refusing)
    g = _gen(5)
    e, r = 64, 8
    table = torch.stack([torch.randperm(e, generator=g)[:r]
                         for _ in range(e)]).to(torch.int32).to(dev)
    q = torch.rand(e, r, generator=g).to(dev)
    resident = (torch.rand(e, generator=g) < 0.5).to(dev)
    before = route_cuda.launches
    for t in (4, CLUSTER_T, CLUSTER_T + 1):
        z = torch.randn(t, e, generator=g).to(dev)
        with pytest.raises(RuntimeError, match="cudaError 2"):
            route_cuda(z, 0.2, 1.1, resident, table, q, k=6)
    assert route_cuda.launches == before


def _policy_inputs(g, e, dev):
    """hop (with the -1 sentinel) and the three cost vectors, some +inf."""
    hop = torch.randint(-1, 4, (e,), generator=g, dtype=torch.int32)
    costs = [torch.rand(e, generator=g) * 0.08 for _ in range(3)]
    for c in costs[1:]:
        c[torch.rand(e, generator=g) < 0.3] = float("inf")
    fetch, fid, peer = (c.to(dev) for c in costs)
    return hop.to(dev), fetch, fid, peer


ROUTE_POLICIES = {
    "cost": dict(cost=True),
    "cost_fid": dict(cost=True, fid=True),
    "cost_fid_peer": dict(cost=True, fid=True, peer=True),
    "cost_none": dict(cost=True, fid=True, peer=True, substitute=False),
    "eta_kappa": dict(eta=0.5, kappa=0.2),
    "temperature_margin": dict(temperature=0.8, margin_gamma=0.4),
    "everything": dict(cost=True, fid=True, peer=True, eta=0.5, kappa=0.2,
                       temperature=0.8, margin_gamma=0.4)}


# 256 and CLUSTER_T: every CTA of a full cluster with its own rows' eta
# statistics; ROWS_PER_CTA + 3: a last CTA of three rows
@pytest.mark.parametrize("t", sorted({4, 32, 256, 4096, ROWS_PER_CTA + 3,
                                      CLUSTER_T}))
@pytest.mark.parametrize("policy", list(ROUTE_POLICIES))
def test_route_policies(dev, t, policy):
    """Cost mode (with and without the degraded and peer costs, and in mode
    "none"), Psi's eta and kappa terms, the temperature and the margin
    co-gate: every int and bool output equal to route_plain's."""
    e, k, r = 64, 6, 8
    g = _gen(t * 17 + len(policy))
    # wider logits: margins spread on both sides of 0.4
    z = torch.randn(t, e, generator=g) * 3
    table = torch.stack([torch.randperm(e, generator=g)[:r]
                         for _ in range(e)]).to(torch.int32)
    table[:, r // 2:][torch.rand(e, r - r // 2, generator=g) < 0.3] = -1
    q = torch.rand(e, r, generator=g).sort(-1, descending=True).values
    resident = torch.rand(e, generator=g) < 0.5
    hop, fetch, fid, peer = _policy_inputs(g, e, dev)
    want = dict(ROUTE_POLICIES[policy])
    kw = dict(k=k, h=8, rho=3, hop=hop,
              substitute=want.pop("substitute", True))
    if want.pop("cost", False):
        kw.update(cost=True, fetch_cost=fetch, stall_per_quality=0.05)
        if want.pop("fid", False):
            kw["fid_cost"] = fid
        if want.pop("peer", False):
            kw["peer_cost"] = peer
    kw.update(want)
    args = (z.to(dev), 0.2, 1.1, resident.to(dev), table.to(dev), q.to(dev))
    got = _route_check(args, kw)
    if kw.get("cost") and t >= 32:
        # the argmin picks among several outcomes
        assert sum(bool(m.any()) for m in (
            got.substituted, got.degraded, got.peered, got.missed,
            got.dropped)) >= 3


@pytest.mark.parametrize("t", [4, 4096])
def test_route_neutral_policy_is_the_precedence_call(dev, t):
    """eta = kappa = 0, temperature 1 and margin_gamma 1, with hop and the
    cost vectors given but precedence mode: every output bit-equal to the
    plain precedence call's (probs and TAE included)."""
    e, k, r = 64, 6, 8
    g = _gen(t)
    z = torch.randn(t, e, generator=g).to(dev)
    table = torch.stack([torch.randperm(e, generator=g)[:r]
                         for _ in range(e)]).to(torch.int32).to(dev)
    q = torch.rand(e, r, generator=g).sort(-1, descending=True).values \
        .to(dev)
    resident = (torch.rand(e, generator=g) < 0.5).to(dev)
    quant_ok = (torch.rand(e, generator=g) < 0.4).to(dev)
    hop, fetch, fid, peer = _policy_inputs(g, e, dev)
    args = (z, 0.2, 1.1, resident, table, q)
    base = route_cuda(*args, k=k, quant_ok=quant_ok)
    neutral = route_cuda(*args, k=k, quant_ok=quant_ok, hop=hop,
                         fetch_cost=fetch, fid_cost=fid, peer_cost=peer,
                         eta=0.0, kappa=0.0, temperature=1.0,
                         margin_gamma=1.0)
    for name in Route._fields:
        assert torch.equal(getattr(neutral, name), getattr(base, name)), name


def _weights(g, e, d, f, dtype, dev):
    return [(torch.randn(e, a, b, generator=g) * 0.05).to(dtype).to(dev)
            for a, b in ((d, f), (d, f), (f, d))]


@pytest.mark.parametrize("e,c,d,f", [(1, 8, 32, 64), (4, 37, 200, 136),
                                     (2, 70, 64, 33), (3, 1, 40, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_ffn(dev, e, c, d, f, dtype):
    g = _gen(e * 100 + c)
    x = torch.randn(e, c, d, generator=g).to(dtype).to(dev)
    ws = _weights(g, e, d, f, dtype, dev)
    got = expert_ffn_cuda(x, *ws)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), expert_ffn_plain(x, *ws).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _replicas(ws):
    return quant_operands(
        quantize.quantize_expert_ffn(*(w.float() for w in ws), 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("replicas", [False, True])
def test_grouped_ffn(dev, dtype, replicas):
    g = _gen(int(replicas))
    e, c, d, f = 6, 12, 96, 80
    ws = _weights(g, e, d, f, dtype, dev)
    counts = torch.randint(0, c + 1, (2 * e,), generator=g, dtype=torch.int32)
    counts[1] = 0
    if not replicas:
        counts[e:] = 0
    x = torch.randn(2 * e, c, d, generator=g)
    x[torch.arange(c)[None, :] >= counts[:, None]] = 0.0
    x, counts = x.to(dtype).to(dev), counts.to(dev)
    quant = None
    if replicas:
        quant = _replicas(ws)
    for cnt in (None, counts):
        got = grouped_ffn_cuda(x, *ws, quant, cnt)
        want = grouped_ffn_plain(x, *ws, quant, cnt)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert torch.all(got[1] == 0)


# the shared FFN tile's row sub-tiles cover 1, 2, 4, 8, 16 and 32 rows: one
# group on each side of every edge, C = 33 (two row tiles)
ROW_EDGES = (0, 1, 7, 8, 9, 16, 17, 24, 32, 33)


@pytest.mark.parametrize("c", [n for n in ROW_EDGES if n])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_ffn_row_buckets(dev, c, dtype):
    g = _gen(c)
    e, d, f = 2, 64, 136
    assert launch_plan(dtype.itemsize, e, c, d, f)["instance"] == "vec16"
    x = torch.randn(e, c, d, generator=g).to(dtype).to(dev)
    ws = _weights(g, e, d, f, dtype, dev)
    torch.testing.assert_close(expert_ffn_cuda(x, *ws).float(),
                               expert_ffn_plain(x, *ws).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _grouped_case(g, e, c, d, f, counts, dtype, dev):
    ws = _weights(g, e, d, f, dtype, dev)
    counts = torch.tensor(counts, dtype=torch.int32)
    x = torch.randn(2 * e, c, d, generator=g)
    x[torch.arange(c)[None, :] >= counts[:, None]] = 0.0
    return x.to(dtype).to(dev), ws, _replicas(ws), counts.to(dev)


@pytest.mark.parametrize("count", ROW_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_row_buckets(dev, count, dtype):
    """An fp group and an int8 group with ``count`` rows side by side in
    one launch, beside a full fp group, an empty one and a 5-row int8
    group."""
    x, ws, quant, counts = _grouped_case(_gen(count), 3, 33, 96, 80,
                                         [count, 33, 0, count, 0, 5], dtype,
                                         dev)
    got = grouped_ffn_cuda(x, *ws, quant, counts)
    want = grouped_ffn_plain(x, *ws, quant, counts)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.all(got[2] == 0) and torch.all(got[4] == 0)


@pytest.mark.parametrize("d,f", [(64, 33), (200, 64), (64, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_ragged_strides(dev, d, f, dtype):
    """Rows that are not a multiple of 16 bytes (F = 33; int8 rows of D =
    200 or F = 24 bytes) take the element-copy instance of the same tile."""
    assert launch_plan(dtype.itemsize, 4, 11, d, f, int8=True)[
        "instance"] == "elem"
    x, ws, quant, counts = _grouped_case(_gen(d + f), 2, 11, d, f,
                                         [11, 3, 1, 9], dtype, dev)
    got = grouped_ffn_cuda(x, *ws, quant, counts)
    want = grouped_ffn_plain(x, *ws, quant, counts)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_ffn_kernels_refuse_misaligned_operands(dev):
    """A view 4 bytes into its storage is not 16-byte aligned: the FFN
    wrappers raise instead of launching."""
    e, c, d, f = 2, 8, 64, 48
    ws = _weights(_gen(1), e, d, f, torch.float32, dev)
    quant = _replicas(ws)

    def shifted(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype,
                           device=dev)[1:].view(t.shape).copy_(t)

    x = torch.randn(2 * e, c, d, device=dev)
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        expert_ffn_cuda(shifted(x[:e]), *ws)
    with pytest.raises(ValueError):
        expert_ffn_cuda(x[:e].contiguous(), shifted(ws[0]), *ws[1:])
    with pytest.raises(ValueError):
        grouped_ffn_cuda(shifted(x), *ws, quant)
    with pytest.raises(ValueError):
        grouped_ffn_cuda(x, *ws, (shifted(quant[0]),) + quant[1:])
    with pytest.raises(ValueError):
        quant_ffn_cuda(shifted(x[:e]), *quant)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("e,c,d,f,binned", [
    (64, 24, 2048, 1408, True),      # gather-branch decode: 24 slots binned
    (64, 32, 2048, 1408, False),     # every row filled
    (3, 37, 200, 136, True), (2, 1, 40, 24, False), (5, 70, 64, 33, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_ffn(dev, e, c, d, f, binned, dtype):
    g = _gen(e * 10 + c)
    quant = _replicas(_weights(g, e, d, f, torch.float32, dev))
    counts = None
    x = torch.randn(e, c, d, generator=g)
    if binned:
        # c slots over e experts, as the binning step lays them out
        counts = torch.bincount(torch.randint(0, e, (c,), generator=g),
                                minlength=e).to(torch.int32)
        x[torch.arange(c)[None, :] >= counts[:, None]] = 0.0
        counts = counts.to(dev)
    x = x.to(dtype).to(dev)
    before = quant_ffn_cuda.launches
    got = quant_ffn_cuda(x, *quant, counts)
    assert quant_ffn_cuda.launches == before + 1
    want = quant_ffn_plain(x, *quant, counts)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if binned:
        empty = (counts == 0).nonzero()[:, 0]
        assert torch.all(got[empty] == 0)


@pytest.mark.parametrize("e,c,d,f", [
    (64, 24, 2048, 1408),        # gather-branch decode: 24 slots binned
    (64, 192, 2048, 1408),       # a chunk step's slots (4 x 8 tokens x K)
    (3, 37, 200, 136), (2, 1, 40, 24), (5, 70, 64, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_ffn_equals_grouped_ffn_degraded_half(dev, e, c, d, f, dtype):
    """quant_ffn stages 64 deep, grouped_ffn 16 deep (its fp groups fix the
    launch's shared memory); both run one FMA chain per output in
    increasing k, so on the same int8 groups (the fp groups empty) their
    outputs are equal bit for bit."""
    assert launch_plan(dtype.itemsize, e, c, d, f, fp=False,
                       int8=True)["bk"] == 64
    assert launch_plan(dtype.itemsize, 2 * e, c, d, f, int8=True)["bk"] == 16
    g = _gen(e + c + d)
    ws = _weights(g, e, d, f, dtype, dev)
    quant = _replicas(ws)
    counts = torch.bincount(torch.randint(0, e, (c,), generator=g),
                            minlength=e).to(torch.int32)
    x = torch.randn(e, c, d, generator=g)
    x[torch.arange(c)[None, :] >= counts[:, None]] = 0.0
    x, counts = x.to(dtype).to(dev), counts.to(dev)
    got = quant_ffn_cuda(x, *quant, counts)
    both = grouped_ffn_cuda(torch.cat([torch.zeros_like(x), x]), *ws, quant,
                            torch.cat([torch.zeros_like(counts), counts]))
    assert torch.equal(got, both[e:])
    assert torch.all(both[:e] == 0)


# Mixtral-8x22B's widths (d_model 6144, d_ff 16384): the FFN tile's grid
# and offsets outside D in {2048, 4096}; two experts, a few rows each
WIDE_D, WIDE_F = 6144, 16384


def _wide_case(seed, groups, rows, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = [torch.randn(2, a, b, generator=g, device=dev).mul_(0.02)
          for a, b in ((WIDE_D, WIDE_F), (WIDE_D, WIDE_F), (WIDE_F, WIDE_D))]
    x = torch.randn(groups, rows, WIDE_D, generator=g, device=dev)
    return x, ws


@pytest.mark.parametrize("rows", [3, 8])
def test_expert_ffn_at_mixtral_8x22b_width(dev, rows):
    x, ws = _wide_case(rows, 2, rows, dev)
    assert launch_plan(4, 2, rows, WIDE_D, WIDE_F)["instance"] == "vec16"
    torch.testing.assert_close(expert_ffn_cuda(x, *ws),
                               expert_ffn_plain(x, *ws),
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


def _decode_live(g, e, b, k):
    """[E, B * K] live rows of a decode step's capacity buffer: B tokens'
    K distinct picks binned per token, laid out [E, B, cap] with cap = K
    (moe.py's row-local binning; a token's pick of e takes its first
    slot)."""
    live = torch.zeros(e, b, k, dtype=torch.bool)
    for t in range(b):
        live[torch.randperm(e, generator=g)[:k], t, 0] = True
    return live.view(e, b * k)


def _live_pattern(pattern, g, e, c):
    """[E, C] live rows of a small buffer, by fill pattern."""
    live = torch.rand(e, c, generator=g) < 0.3
    if pattern == "empty_expert":
        live[1] = False
    elif pattern == "two_tiles":                 # 33-40 rows: two row tiles
        live[0] = False
        live[0, torch.randperm(c, generator=g)[:36]] = True
    elif pattern == "all":
        live[:] = True
    elif pattern == "none":
        live[:] = False
    return live


# (pattern, dtype, instance): the decode buffer at its shape; the others
# small, in both instances of the tile (elem: rows not a multiple of 16 B)
LIVE_CASES = ([("decode", dt, "vec16") for dt in (torch.float32,
                                                  torch.bfloat16)]
              + [(p, dt, inst)
                 for p in ("empty_expert", "two_tiles", "all", "none", "nan")
                 for dt in (torch.float32, torch.bfloat16)
                 for inst in ("vec16", "elem")])


@pytest.mark.parametrize("pattern,dtype,instance", LIVE_CASES)
def test_expert_ffn_computes_live_rows(dev, pattern, dtype, instance):
    """Only the rows with an element other than +-0 are computed (NaN is
    live): they match the plain version and are the same bits as the same
    rows packed to the front of each expert; every other output row is
    zero; the device's count of rows computed is the live rows."""
    g = _gen(LIVE_CASES.index((pattern, dtype, instance)))
    if pattern == "decode":                      # 64 tokens x 2 picks
        e, c, d, f = 8, 128, WIDE_D, WIDE_F
        live = _decode_live(g, e, 64, 2)
        wg = torch.Generator(device=dev).manual_seed(38)
        ws = [torch.randn(e, a, b, generator=wg, device=dev).mul_(0.02)
              .to(dtype) for a, b in ((d, f), (d, f), (f, d))]
    else:
        e, c, (d, f) = 4, 48, (64, 136) if instance == "vec16" else (37, 24)
        live = _live_pattern(pattern, g, e, c)
        ws = _weights(g, e, d, f, dtype, dev)
    assert launch_plan(dtype.itemsize, e, c, d, f)["instance"] == instance
    x = torch.randn(e, c, d, generator=g)
    x[~live] = 0.0
    x[~live & (torch.rand(e, c, generator=g) < 0.5)] = -0.0
    nan = None
    if pattern == "nan":
        nan = tuple(int(i) for i in live.nonzero()[0])
        x[nan][d // 2] = float("nan")
    x = x.to(dtype).to(dev)
    before = ops.expert_ffn_rows()
    got = expert_ffn_cuda(x, *ws)
    want = expert_ffn_plain(x, *ws)
    finite = live.clone()
    if nan is not None:
        finite[nan] = False
        assert torch.isnan(got[nan]).all()
    finite = finite.to(dev)
    torch.testing.assert_close(got[finite].float(), want[finite].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.all(got[~live.to(dev)] == 0)
    # the same rows packed to the front of each expert, in row order
    packed = torch.zeros_like(x)
    front = torch.arange(c)[None, :] < live.sum(1, keepdim=True)
    packed[front.to(dev)] = x[live.to(dev)]
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got[live.to(dev)].view(bits),
                       expert_ffn_cuda(packed, *ws)[front.to(dev)].view(bits))
    after = ops.expert_ffn_rows()
    assert after["given"] - before["given"] == 2 * e * c
    assert after["computed"] - before["computed"] == 2 * int(live.sum())


def test_grouped_ffn_at_mixtral_8x22b_width(dev):
    """Two fp groups and two int8 groups, one of them empty."""
    x, ws = _wide_case(1, 4, 4, dev)
    quant = _replicas(ws)
    counts = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=dev)
    x[torch.arange(4, device=dev)[None, :] >= counts[:, None]] = 0.0
    got = grouped_ffn_cuda(x, *ws, quant, counts)
    torch.testing.assert_close(got, grouped_ffn_plain(x, *ws, quant, counts),
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    assert torch.all(got[2] == 0)


def test_quant_ffn_at_mixtral_8x22b_width(dev):
    x, ws = _wide_case(2, 2, 4, dev)
    quant = _replicas(ws)
    counts = torch.tensor([4, 1], dtype=torch.int32, device=dev)
    x[1, 1:] = 0.0
    torch.testing.assert_close(quant_ffn_cuda(x, *quant, counts),
                               quant_ffn_plain(x, *quant, counts),
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


def test_wrappers_check_their_operands(dev):
    z = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError):
        topk_gate_cuda(z.double(), 0.2, k=2)
    with pytest.raises(ValueError):
        topk_gate_cuda(z.t(), 0.2, k=2)            # not contiguous
    with pytest.raises(ValueError):
        topk_gate_cuda(torch.randn(4, 300, device=dev), 0.2, k=2)
    table = torch.zeros(8, 3, dtype=torch.int32, device=dev)
    route = (torch.ones(8, dtype=torch.bool, device=dev), table,
             torch.zeros(8, 3, device=dev))
    before = route_cuda.launches
    with pytest.raises(ValueError):
        route_cuda(z.double(), 0.2, 1.1, *route, k=2)
    with pytest.raises(ValueError):
        route_cuda(z, 0.2, 1.1, route[0], table.long(), route[2], k=2)
    with pytest.raises(ValueError):
        route_cuda(z, 0.2, 1.1, *route, k=2, quant_ok=route[0][:4])
    with pytest.raises(ValueError):
        route_cuda(z, 0.2, 1.1, *route, k=17)
    with pytest.raises(ValueError):                # cost mode, no fetch_cost
        route_cuda(z, 0.2, 1.1, *route, k=2, cost=True)
    with pytest.raises(ValueError):
        route_cuda(z, 0.2, 1.1, *route, k=2, hop=table[:, 0].long())
    with pytest.raises(ValueError):
        route_cuda(z, 0.2, 1.1, *route, k=2, cost=True,
                   fetch_cost=torch.zeros(8, device=dev).double())
    assert route_cuda.launches == before
    x = torch.randn(2, 3, 8, device=dev)
    ws = _weights(_gen(0), 2, 8, 4, torch.float32, dev)
    with pytest.raises(ValueError):
        expert_ffn_cuda(x.half(), *ws)
    with pytest.raises(ValueError):
        grouped_ffn_cuda(x, *ws)                   # needs 2E groups
    quant = _replicas(ws)
    with pytest.raises(ValueError):
        quant_ffn_cuda(torch.randn(3, 3, 8, device=dev), *quant)  # E 3 != 2
    with pytest.raises(ValueError):
        quant_ffn_cuda(x[:2], quant[0].float(), *quant[1:])   # not int8
    with pytest.raises(ValueError):
        quant_ffn_cuda(x[:2], *quant, torch.zeros(2, device=dev))  # counts


def _moe_case(devices, e, k, shape, policy, seed=0, tier=False):
    cfg = MoEConfig(num_experts=e, top_k=k, d_ff=48, num_shared_experts=1)
    p = M.init_moe(_gen(seed), 64, cfg, torch.float32, "cpu")
    if tier:
        p["quant"] = quantize.quantize_expert_ffn(p["w1"], p["w3"], p["w2"],
                                                  8)
    g = _gen(seed + 1)
    x = torch.randn(*shape, 64, generator=g) * 0.5
    table = torch.stack([torch.roll(torch.arange(e), -i - 1)[:4]
                         for i in range(e)]).to(torch.int32)
    buddy = M.BuddyState((torch.rand(e, generator=g) < 0.5), table,
                         torch.rand(e, 4, generator=g).sort(
                             -1, descending=True).values,
                         torch.zeros(e, dtype=torch.int32),
                         quant_ok=(torch.rand(e, generator=g) < 0.7)
                         if tier else None)
    # Psi's hop term (with the -1 sentinel) and cost mode's fetch stalls
    buddy = buddy._replace(
        hop=torch.randint(-1, 3, (e,), generator=g, dtype=torch.int32),
        fetch_cost=torch.rand(e, generator=g) * 0.01)
    out = []
    for d in devices:
        pd = {name: (v.to(d) if torch.is_tensor(v) else
                     {kk: vv.to(d) for kk, vv in v.items()})
              for name, v in p.items()}
        out.append(M.moe_forward(pd, x.to(d), cfg, policy=policy,
                                 buddy=M.BuddyState(*[
                                     None if a is None else a.to(d)
                                     for a in buddy])))
    return out


@pytest.mark.parametrize("fused,shape", [(True, (4, 1)), (False, (4, 1)),
                                         (False, (2, 16)), (True, (2, 16))])
def test_moe_forward_on_card_matches_cpu(dev, fused, shape):
    pol = BuddyPolicy(tau=0.0, beta=1.1, rho=2, H=4,
                      use_fused_dispatch=fused)
    before = ops.launch_counts()
    (cy, ca), (gy, ga) = _moe_case(("cpu", dev), 16, 3, shape, pol)
    after = ops.launch_counts()
    # one routing launch per layer, and neither standalone routing kernel
    assert after["route"] == before["route"] + 1
    assert after["topk_gate"] == before["topk_gate"]
    assert after["buddy_substitute"] == before["buddy_substitute"]
    torch.testing.assert_close(gy.cpu(), cy, rtol=1e-4, atol=1e-4)
    for name in ("indices", "orig_indices", "sub_slots", "miss_slots",
                 "miss_per_expert"):
        assert torch.equal(getattr(ga, name).cpu(), getattr(ca, name)), name
    assert int(ga.n_dropped) == int(ca.n_dropped)


@pytest.mark.parametrize("fused,shape", [(True, (4, 1)), (False, (4, 1)),
                                         (False, (2, 16))])
def test_moe_forward_with_tier_on_card_matches_cpu(dev, fused, shape):
    """The degraded outcome on the card: the grouped kernel's int8 half
    (fused) or quant_ffn (gather, capacity) against the CPU."""
    pol = BuddyPolicy(tau=0.0, beta=1.1, rho=1, H=2, quant_tier="int8",
                      use_fused_dispatch=fused)
    before = ops.launch_counts()
    (cy, ca), (gy, ga) = _moe_case(("cpu", dev), 16, 3, shape, pol, seed=3,
                                   tier=True)
    after = ops.launch_counts()
    kernel = "grouped_ffn" if fused else "quant_ffn"
    assert after[kernel] == before[kernel] + 1
    assert int(ca.n_degraded) > 0
    torch.testing.assert_close(gy.cpu(), cy, rtol=1e-4, atol=1e-4)
    for name in ("indices", "sub_slots", "miss_slots", "deg_slots",
                 "miss_per_expert"):
        assert torch.equal(getattr(ga, name).cpu(), getattr(ca, name)), name


@pytest.mark.parametrize("kw", [dict(miss_policy="cost"), dict(eta=0.3),
                                dict(kappa=0.1), dict(temperature=0.9),
                                dict(margin_gamma=0.5)])
def test_every_policy_on_card_matches_cpu(dev, kw):
    """The policies beyond precedence with Psi = q run on the card through
    the route kernel, one launch per layer, with the CPU's masks and
    outputs."""
    before = ops.launch_counts()
    (cy, ca), (gy, ga) = _moe_case(("cpu", dev), 16, 3, (4, 1),
                                   BuddyPolicy(tau=0.0, beta=1.1, **kw))
    after = ops.launch_counts()
    assert after["route"] == before["route"] + 1
    assert after["topk_gate"] == before["topk_gate"]
    torch.testing.assert_close(gy.cpu(), cy, rtol=1e-4, atol=1e-4)
    for name in ("indices", "orig_indices", "sub_slots", "miss_slots",
                 "drop_slots", "miss_per_expert"):
        assert torch.equal(getattr(ga, name).cpu(), getattr(ca, name)), name


def _wkv_close(got, want):
    # f32 sums over C and D in another order, carried across N chunks
    scale = 1.0 + float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


# the last four: the cp.async ring's edges, N = 1 (nothing to prefetch),
# N = 2 and odd N (the stage parity at the last chunk), two stages at D = 64
# and one at D = 128
@pytest.mark.parametrize("b,h,n,c,d", [(4, 32, 16, 32, 64),
                                       (2, 32, 8, 32, 128),
                                       (3, 1, 4, 16, 32), (1, 2, 1, 16, 128),
                                       (2, 3, 5, 32, 32), (1, 4, 1, 32, 64),
                                       (2, 3, 2, 32, 64), (1, 5, 3, 16, 64),
                                       (1, 3, 2, 32, 128)])
def test_wkv_chunk(dev, b, h, n, c, d):
    args = R.random_chunk_operands(_gen(b + n), b, h, n, c, d, dev)
    before = wkv_chunk_cuda.launches
    got = wkv_chunk_cuda(*args)
    assert wkv_chunk_cuda.launches == before + 1
    want = wkv_chunk_plain(*args)
    for g_, w_ in zip(got, want):
        _wkv_close(g_, w_)


def test_wkv_chunk_stage_depths(dev):
    assert (wkv_stages(32, 64), wkv_stages(16, 32), wkv_stages(32, 128),
            wkv_stages(24, 64)) == (2, 2, 1, 0)


def test_wkv_chunk_is_deterministic(dev):
    args = R.random_chunk_operands(_gen(3), 4, 32, 16, 32, 64, dev)
    first = wkv_chunk_cuda(*args)
    again = wkv_chunk_cuda(*args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_wkv_chunk_backward_on_card_matches_cpu(dev):
    args = R.random_chunk_operands(_gen(5), 2, 4, 4, 32, 64, "cpu")
    g = _gen(6)
    w_o = torch.randn(args[0].shape, generator=g)
    w_s = torch.randn(args[-1].shape, generator=g)
    grads = []
    for d in ("cpu", dev):
        a = [t.detach().to(d).requires_grad_(True) for t in args]
        o, s = ops.wkv_chunk(*a)
        (torch.sum(o * w_o.to(d)) + torch.sum(s * w_s.to(d))).backward()
        grads.append([t.grad.cpu() for t in a])
    for gc, gg in zip(*grads):
        assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


def test_wkv_chunk_checks_its_operands(dev):
    args = R.random_chunk_operands(_gen(0), 1, 2, 2, 16, 32, dev)
    with pytest.raises(ValueError):
        wkv_chunk_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        wkv_chunk_cuda(args[0].transpose(2, 3).contiguous().transpose(2, 3),
                       *args[1:])                  # not contiguous
    with pytest.raises(ValueError):
        wkv_chunk_cuda(*[t[..., :24].contiguous() if t.ndim == 4 else t
                         for t in args])           # head dim 24
    shifted = torch.empty(args[0].numel() + 1, device=dev)[1:] \
        .view(args[0].shape)
    with pytest.raises(ValueError):
        wkv_chunk_cuda(shifted, *args[1:])         # not 16-byte aligned


def test_rwkv_loss_and_grads_on_card_match_cpu(dev):
    from repro_torch.configs.rwkv6_1p6b import reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_and_grads
    cfg = reduced()
    params = T.init_params(cfg, _gen(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=_gen(1))
    out = []
    for d in ("cpu", dev):
        before = wkv_chunk_cuda.launches
        p = tree_map(lambda t: t.to(d), params)
        t = toks.to(d)
        out.append(loss_and_grads(p, cfg, t[:, :-1], t[:, 1:]))
        assert wkv_chunk_cuda.launches == before + (
            cfg.num_layers if d == dev else 0)
    (lc, _, gc), (lg, _, gg) = out
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(tree_leaves(gc), tree_leaves(gg)):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(a.abs().max())


# ---------------------------------------------------------------------------
# Chunked prefill and the continuous scheduler, card against CPU, on the
# committed profiling fixture (2 layers, d_model 128, 64 experts, top-6)
# ---------------------------------------------------------------------------
FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"


def _fixture(device):
    from repro_torch.checkpoint.io import load_npz
    from repro_torch.configs.deepseek_v2_lite_buddy import profiling
    from repro_torch.core.buddies import load_tables
    return (profiling(), load_npz(str(FIXTURE / "model.npz"), device),
            load_tables(str(FIXTURE / "tables_a0.95_k16.npz")))


@pytest.mark.parametrize("b,c,fused,tier", [(4, 5, True, False),
                                            (4, 5, False, True),
                                            (4, 80, True, True)])
def test_prefill_chunk_on_card_matches_cpu(dev, b, c, fused, tier):
    """Two chunk steps of mixed rows (a prefill, a decode row, a partial
    prefix, an inactive row): logits, caches and every per-slot mask. At
    4 x 80 = 320 tokens route runs the form launch_plan gives it (two
    launches above CLUSTER_T)."""
    import numpy as np
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves
    pol = BuddyPolicy(tau=0.1, beta=1.1, rho=3, use_fused_dispatch=fused,
                      quant_tier="int8" if tier else "off")
    rng = np.random.default_rng(c)
    counts = np.array([c, 1, c // 2, 0])
    valid = np.arange(c)[None, :] < counts[:, None]
    base = np.array([0, c + 3, 2, 1])
    runs = []
    for d in ("cpu", dev):
        cfg, params, tables = _fixture(d)
        if tier:
            params, _ = quantize.attach_quant_tier(cfg, params, 8)
        n, e = cfg.num_layers, cfg.moe.num_experts
        caches = T.init_caches(cfg, b, 2 * c + 4, device=d)
        r = np.random.default_rng(1)
        out = []
        pos = base.copy()
        for _ in range(2):
            toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (b, c)))
            bud = M.BuddyState(
                torch.from_numpy(r.random((n, e)) < 0.5).to(d),
                torch.from_numpy(tables.table).to(d),
                torch.from_numpy(tables.q).to(d),
                torch.zeros(n, e, dtype=torch.int32, device=d),
                quant_ok=(torch.from_numpy(r.random((n, e)) < 0.6).to(d)
                          if tier else None))
            before = ops.launch_counts()
            logits, caches, aux = T.prefill_chunk(
                params, cfg, toks.to(d), caches, pos, valid, policy=pol,
                buddies=bud, record=True)
            after = ops.launch_counts()
            out.append((logits.cpu(), aux["recorded"][0], after, before))
            pos = pos + counts
        runs.append((out, [a.cpu() for a in tree_leaves(caches)]))
    (cpu, ccache), (card, gcache) = runs
    assert route_plan(b * c, 6).launches == (2 if b * c > CLUSTER_T else 1)
    for (cl, cr, _, _), (gl, gr, after, before) in zip(cpu, card):
        assert after["route"] - before["route"] == 2          # per layer
        assert after["topk_gate"] == before["topk_gate"]
        assert after["buddy_substitute"] == before["buddy_substitute"]
        torch.testing.assert_close(gl[valid], cl[valid], rtol=1e-3,
                                   atol=1e-3)
        for k in ("indices", "substituted", "missed", "degraded"):
            assert torch.equal(gr[k].cpu(), cr[k]), k
    for g, w in zip(gcache, ccache):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_continuous_scheduler_on_card_matches_cpu(dev):
    """Chunked continuous serving of the fixture (cache-rate 0.5, buddy
    policy, fused dispatch): the same tokens per request and the same
    counters on the card as on the CPU."""
    import numpy as np
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.runtime.prefetch import PrevStepPredictor
    from repro_torch.serving import scheduler as S
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import MarkovLM
    out = []
    for d in ("cpu", dev):
        cfg, params, tables = _fixture(d)
        n, e = cfg.num_layers, cfg.moe.num_experts
        cache = ExpertCache(n, e, 0.5)
        eng = ServeEngine(cfg, params, tables=tables,
                          policy=BuddyPolicy(use_fused_dispatch=True),
                          cache=cache, predictor=PrevStepPredictor(n, e),
                          prefetch_k=cache.capacity // 2)
        lm, rng = MarkovLM(cfg.vocab_size, seed=1), np.random.default_rng(1)
        reqs = S.make_requests(
            [lm.sample(1, int(rng.integers(4, 12)))[0] for _ in range(6)],
            S.PoissonArrivals(3000.0, seed=2), 5)
        s = S.ContinuousScheduler(eng, slots=3, prefill_chunk=8).run(
            S.RequestQueue(reqs))
        out.append(({r.rid: r.tokens for r in reqs}, s))
    (ctok, cs), (gtok, gs) = out
    assert gs["completed"] == 6 and gtok == ctok
    assert gs["steps"] == cs["steps"]
    assert gs["engine"]["stats"] == cs["engine"]["stats"]
    assert gs["engine"]["ledger"] == cs["engine"]["ledger"]


# ---------------------------------------------------------------------------
# Paged KV and the prefix cache, card against CPU, on the same fixture
# ---------------------------------------------------------------------------
def _paged_engine(d, prefix=False):
    from repro_torch.serving.engine import ServeEngine
    cfg, params, tables = _fixture(d)
    return ServeEngine(cfg, params, tables=tables,
                       policy=BuddyPolicy(use_fused_dispatch=True),
                       paged_kv=True, kv_block=8, prefix_cache=prefix)


def test_paged_steps_on_card_match_cpu(dev):
    """Two chunk steps (a prefill from 0, a row prefilling mid-prompt, an
    inactive row), then two decode steps, through the engine's paged
    hooks: logits within 1e-3 and the same blocks written, their contents
    within 1e-4."""
    import numpy as np
    runs = []
    for d in ("cpu", dev):
        eng = _paged_engine(d)
        caches = eng.init_caches(3, 40)
        r = np.random.default_rng(2)
        pos, out = np.array([0, 11, 0]), []
        rows = np.array([True, True, False])
        for _ in range(2):
            toks = r.integers(0, eng.cfg.vocab_size, (3, 6))
            lg, caches = eng.prefill_rows(toks, rows, caches, base_pos=pos)
            out.append(lg[rows].cpu())
            pos = pos + 6
        for _ in range(2):
            tok = eng._tokens(r.integers(0, eng.cfg.vocab_size, 3))
            lg, caches = eng.step(tok, caches, pos, active=rows)
            out.append(lg[rows].cpu())
            pos = pos + 1
        runs.append((out, eng.kv_pool.tables.copy(),
                     [a.cpu() for g in caches for a in g["kv"].values()]))
    (cpu, ct, cc), (card, gt, gc) = runs
    np.testing.assert_array_equal(gt, ct)
    for g, w in zip(card, cpu):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
    for g, w in zip(gc, cc):
        written = w.flatten(2).abs().sum(-1) > 0          # [L, P]
        assert torch.equal(g.flatten(2).abs().sum(-1) > 0, written)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_paged_copy_on_write_on_card_keeps_the_source(dev):
    """The engine's batched in-place copy of a shared block: the copy
    equals the source bit for bit, and the source (the tree's block) and
    every other block are untouched."""
    eng = _paged_engine(dev, prefix=True)
    caches = eng.init_caches(2, 32)
    g = torch.Generator(device=dev).manual_seed(0)
    for grp in caches:
        for a in grp["kv"].values():
            a.copy_(torch.randn(a.shape, generator=g, device=dev))
    pool = eng.kv_pool
    pool.ensure_range(0, 0, 20)                 # 3 blocks, the last partial
    pool.drain_copies()
    pool.adopt(1, pool.row_blocks(0, 20))
    src = int(pool.tables[0, 2])
    before = [a.clone() for grp in caches for a in grp["kv"].values()]
    pool.ensure_range(1, 20, 21)                # copy-on-write of block 2
    dst = int(pool.tables[1, 2])
    assert dst != src and pool.cow_copies == 1
    eng._apply_kv_copies(caches)
    after = [a for grp in caches for a in grp["kv"].values()]
    for b, a in zip(before, after):
        assert torch.equal(a[:, dst], b[:, src])
        keep = torch.ones(a.shape[1], dtype=torch.bool)
        keep[dst] = False
        assert torch.equal(a[:, keep], b[:, keep])


def test_prefix_hit_on_card_matches_cold_recompute(dev):
    """A prompt whose first 20 tokens (not a multiple of the 8-token
    block) another row donated: adopting them and prefilling only the
    rest gives the last token's logits of a cold prefill of the whole
    prompt, within 1e-3."""
    import numpy as np
    rng = np.random.default_rng(9)
    donor = rng.integers(0, 512, 24)
    adopter = np.concatenate([donor[:20], rng.integers(0, 512, 4)])

    def prefill(eng, caches, row, prompt, start):
        last = None
        for p in range(start, len(prompt), 4):
            c = min(4, len(prompt) - p)
            toks = np.zeros((2, 4), np.int64)
            valid = np.zeros((2, 4), bool)
            toks[row, :c], valid[row, :c] = prompt[p:p + c], True
            base = np.zeros(2, np.int64)
            base[row] = p
            lg, caches = eng.prefill_rows(toks, valid.any(1), caches,
                                          base_pos=base, tok_valid=valid)
            last = lg[row, c - 1].cpu()
        return caches, last

    eng = _paged_engine(dev, prefix=True)
    caches = eng.init_caches(2, 32)
    caches, _ = prefill(eng, caches, 0, donor, 0)
    eng.insert_prefix(0, donor)
    assert eng.adopt_prefix(1, adopter) == 20
    _, hit = prefill(eng, caches, 1, adopter, 20)
    assert eng.kv_pool.cow_copies >= 1
    eng.kv_pool.check(eng.prefix_tree.block_holders())
    cold = _paged_engine(dev, prefix=True)
    _, want = prefill(cold, cold.init_caches(2, 32), 1, adopter, 0)
    torch.testing.assert_close(hit, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# Telemetry, the simulated mesh and live placement on the card, on the same
# fixture
# ---------------------------------------------------------------------------
def _observed_engine(d, **kw):
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.runtime.prefetch import PrevStepPredictor
    from repro_torch.serving.engine import ServeEngine
    cfg, params, tables = _fixture(d)
    n, e = cfg.num_layers, cfg.moe.num_experts
    policy = kw.pop("policy", BuddyPolicy(use_fused_dispatch=True))
    if "tier" not in kw:
        kw["cache"] = ExpertCache(n, e, 0.5)
    return ServeEngine(cfg, params, tables=tables, policy=policy,
                       predictor=PrevStepPredictor(n, e), prefetch_k=15,
                       **kw)


def test_telemetry_off_and_on_on_card_agree(dev):
    """The observer reads host arrays only: on the card, telemetry on gives
    the tokens, stats and ledger of telemetry off, one outcomes instant per
    MoE layer per step and one step span per step."""
    import numpy as np
    from repro_torch.runtime.telemetry import Telemetry
    from repro_torch.training.data import MarkovLM
    prompts = MarkovLM(512, seed=0).sample(4, 8)
    out = []
    for tele in (None, Telemetry.with_trace(num_layers=2, num_experts=64)):
        eng = _observed_engine(dev, telemetry=tele)
        toks = eng.generate(prompts, 6)
        s = eng.summary()
        out.append((toks, s["stats"], s["ledger"]))
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]
    evs = tele.trace.sorted_events()
    steps = out[1][1]["steps"]
    assert sum(e["kind"] == "outcomes" for e in evs) == 2 * steps
    assert sum(e["kind"] == "step" for e in evs) == steps


@pytest.mark.parametrize("miss_policy", ["precedence", "cost"])
def test_mesh_steps_on_card_match_cpu(dev, miss_policy):
    """A 4-device mesh: the peer inputs reach route on the card, and the
    tokens, stats, ledger and mesh summary equal the CPU's."""
    import numpy as np
    from repro_torch.training.data import MarkovLM
    prompts = MarkovLM(512, seed=0).sample(4, 8)
    pol = BuddyPolicy(use_fused_dispatch=True, miss_policy=miss_policy,
                      stall_per_quality=2e-4)
    out = []
    for d in ("cpu", dev):
        eng = _observed_engine(d, policy=pol, n_devices=4)
        before = ops.launch_counts()["route"]
        toks = eng.generate(prompts, 6)
        s = eng.summary()
        out.append((toks, s["stats"], s["ledger"], s["mesh"]))
        routes = ops.launch_counts()["route"] - before
        assert routes == (0 if d == "cpu" else 2 * s["stats"]["steps"])
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]
    assert out[1][3]["n_peer_borrow"] > 0


def test_placement_tick_on_card_moves_no_tensor(dev):
    """A placement controller ticking on the card re-picks the int8 tier's
    coverage on the host: the replicas stay where they were, and the
    tokens and placement summary equal the CPU's."""
    import numpy as np
    from repro_torch.runtime.placement import PlacementController
    from repro_torch.runtime.tiers import TieredExpertStore
    from repro_torch.serving import scheduler as S
    from repro_torch.training.data import MarkovLM
    out = []
    for d in ("cpu", dev):
        tier = TieredExpertStore(2, 64, 1.1, bits=8, d_model=128, d_ff=64,
                                 coverage=0.25)
        tier.set_coverage(np.random.default_rng(3).random((2, 64)))
        eng = _observed_engine(
            d, tier=tier, policy=BuddyPolicy(quant_tier="int8"),
            placement=PlacementController(refresh_interval_s=5e-5,
                                          hot_windows=1,
                                          replicate_margin=1.0))
        quant = [t for g in eng.params["groups"] if "quant" in g["moe"]
                 for t in g["moe"]["quant"].values()]
        ptrs = [t.data_ptr() for t in quant]
        lm, rng = MarkovLM(512, seed=1), np.random.default_rng(1)
        reqs = S.make_requests(
            [lm.sample(1, int(rng.integers(4, 12)))[0] for _ in range(12)],
            S.PoissonArrivals(2000.0, seed=2), 8)
        s = S.ContinuousScheduler(eng, slots=4, prefill_chunk=4).run(
            S.RequestQueue(reqs))
        assert [t.data_ptr() for t in quant] == ptrs
        out.append(([r.tokens for r in reqs], s["engine"]["placement"]))
    assert out[0] == out[1]
    assert out[1][1]["coverage_repicks"] > 0


# ---------------------------------------------------------------------------
# Mixtral-8x7B's shapes (8 experts x d_model 4096 x d_ff 14336, top-2), and
# reduced Mixtral (window 128) served on the card against the CPU
# ---------------------------------------------------------------------------
MIX_E, MIX_K, MIX_D, MIX_F = 8, 2, 4096, 14336


@pytest.fixture(scope="module")
def mixtral_weights():
    """w1, w3, w2 at Mixtral's width, random on the card (5.6 GB f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    g = torch.Generator(device="cuda").manual_seed(8)
    return [torch.randn(MIX_E, a, b, generator=g, device="cuda").mul_(0.02)
            for a, b in ((MIX_D, MIX_F), (MIX_D, MIX_F), (MIX_F, MIX_D))]


def _mixtral_rows(c, counts, g):
    """[groups, c, D] rows, each group's rows past its count zero."""
    x = torch.randn(len(counts), c, MIX_D, generator=g)
    x[torch.arange(c)[None, :] >= counts[:, None]] = 0.0
    return x.to("cuda")


@pytest.mark.parametrize("c", [8, 64])       # decode (4 x cap 2), chunk 8
def test_expert_ffn_at_mixtral_width(dev, mixtral_weights, c):
    g = _gen(c)
    counts = torch.randint(0, c + 1, (MIX_E,), generator=g)
    x = _mixtral_rows(c, counts, g)
    assert launch_plan(4, MIX_E, c, MIX_D, MIX_F)["instance"] == "vec16"
    torch.testing.assert_close(expert_ffn_cuda(x, *mixtral_weights),
                               expert_ffn_plain(x, *mixtral_weights),
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


def test_grouped_ffn_at_mixtral_width(dev, mixtral_weights):
    """A fused decode step's [2E, T*K, D] buffer: 8 slots over the fp half,
    the degraded half empty."""
    g = _gen(16)
    counts = torch.bincount(torch.randint(0, MIX_E, (4 * MIX_K,),
                                          generator=g),
                            minlength=2 * MIX_E).to(torch.int32)
    x = _mixtral_rows(4 * MIX_K, counts, g)
    counts = counts.to("cuda")
    got = grouped_ffn_cuda(x, *mixtral_weights, None, counts)
    torch.testing.assert_close(
        got, grouped_ffn_plain(x, *mixtral_weights, None, counts),
        rtol=TOL[torch.float32], atol=TOL[torch.float32])
    assert torch.all(got[MIX_E:] == 0)


def test_quant_ffn_at_mixtral_width(dev, mixtral_weights):
    """The int8 tier's degraded slots of a decode step binned by expert."""
    g = _gen(17)
    quant = _replicas(mixtral_weights)
    counts = torch.bincount(torch.randint(0, MIX_E, (4,), generator=g),
                            minlength=MIX_E).to(torch.int32)
    x = _mixtral_rows(4 * MIX_K, counts, g)
    counts = counts.to("cuda")
    got = quant_ffn_cuda(x, *quant, counts)
    torch.testing.assert_close(got, quant_ffn_plain(x, *quant, counts),
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    assert torch.all(got[(counts == 0).nonzero()[:, 0]] == 0)


@pytest.mark.parametrize("t", [4, 32])
def test_route_at_mixtral_shape(dev, t):
    """E = 8, K = 2 and a 7-deep buddy table, with the tier's mask."""
    g = _gen(t + 8)
    e, r = MIX_E, MIX_E - 1
    table = torch.stack([torch.randperm(e, generator=g)[:r]
                         for _ in range(e)]).to(torch.int32)
    table[:, 3:][torch.rand(e, r - 3, generator=g) < 0.3] = -1
    q = torch.rand(e, r, generator=g).sort(-1, descending=True).values
    args = (torch.randn(t, e, generator=g).to(dev), 0.2, 1.1,
            (torch.rand(e, generator=g) < 0.5).to(dev), table.to(dev),
            q.to(dev))
    _route_check(args, dict(k=MIX_K, h=8, rho=3, substitute=True,
                            quant_ok=(torch.rand(e, generator=g)
                                      < 0.5).to(dev)))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tier", [False, True])
def test_reduced_mixtral_engine_on_card_matches_cpu(dev, fused, tier):
    """Reduced Mixtral from weights made on the CPU, 4 x 124 prompt + 8
    new tokens (decode passes the 128-token window), on the capacity or
    fused path, without and with the int8 tier at coverage 0.5: equal
    tokens and counters, logits within 1e-3; route once per MoE layer per
    step on the card."""
    import numpy as np
    from repro_torch.configs.base import get_reduced
    from repro_torch.launch.serve import profile_buddies
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.cache import ExpertCache
    from repro_torch.runtime.prefetch import PrevStepPredictor
    from repro_torch.runtime.tiers import TieredExpertStore
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import MarkovLM
    cfg = get_reduced("mixtral-8x7b")
    n, e = cfg.num_layers, cfg.moe.num_experts
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tables, rec = profile_buddies(cfg, params, MarkovLM(cfg.vocab_size,
                                                        seed=0))
    prompts = MarkovLM(cfg.vocab_size, seed=3).sample(4, 124)
    out = []
    for d in ("cpu", dev):
        store = None
        if tier:
            store = TieredExpertStore(n, e, 0.5, bits=8, coverage=0.5,
                                      d_model=cfg.d_model, d_ff=cfg.moe.d_ff)
            store.set_coverage(rec.A)
        cache = store.cache if tier else ExpertCache(n, e, 0.5)
        eng = ServeEngine(
            cfg, tree_map(lambda t: t.to(d, copy=True), params),
            tables=tables, policy=BuddyPolicy(
                use_fused_dispatch=fused,
                quant_tier="int8" if tier else "off"),
            cache=None if tier else cache, tier=store,
            predictor=PrevStepPredictor(n, e),
            prefetch_k=max(1, cache.capacity // 2))
        logits, step = [], eng.step

        def logged(*a, **kw):
            res = step(*a, **kw)
            logits.append(res[0].detach().cpu())
            return res

        eng.step = logged
        before = ops.launch_counts()["route"]
        toks = eng.generate(prompts, 8)
        routes = ops.launch_counts()["route"] - before
        s = eng.summary()
        assert routes == (0 if d == "cpu" else n * s["stats"]["steps"])
        out.append((toks, s, torch.stack(logits)))
    (ct, cs, cl), (gt, gs, gl) = out
    assert np.array_equal(ct, gt)
    assert cs["stats"] == gs["stats"] and cs["ledger"] == gs["ledger"]
    torch.testing.assert_close(gl, cl, rtol=1e-3, atol=1e-3)
    if tier:
        assert gs["tier"]["degraded_tokens"] > 0
        fc = cs["tier"].pop("mean_fidelity_loss")
        fg = gs["tier"].pop("mean_fidelity_loss")
        assert cs["tier"] == gs["tier"]
        assert abs(fc - fg) <= 1e-5 * abs(fc)


# ---------------------------------------------------------------------------
# MoE training: the autograd Functions around topk_gate and expert_ffn, a
# reduced DeepSeek train step card against CPU, and the serve-only kernels'
# refusal to run where autograd would need their gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,d,f,empty", [(4, 37, 200, 136, 5),
                                           (64, 256, 256, 128, 64),
                                           (2, 8, 32, 64, 0)])
def test_expert_ffn_backward_on_card_matches_plain_autograd(dev, e, c, d, f,
                                                            empty):
    from repro_torch.kernels.expert_ffn import ExpertFFN
    g = _gen(e + c + d)
    x = torch.randn(e, c, d, generator=g)
    x[:, c - empty:] = 0                       # unfilled capacity rows
    x = x.to(dev)
    ws = _weights(g, e, d, f, torch.float32, dev)
    dy = torch.randn(e, c, d, generator=g).to(dev)
    grads = []
    for i, fn in enumerate((lambda *a: ExpertFFN.apply(expert_ffn_cuda, *a),
                            expert_ffn_plain)):
        before = expert_ffn_cuda.launches
        leaves = [t.detach().requires_grad_(True) for t in (x, *ws)]
        fn(*leaves).backward(dy)
        grads.append([t.grad for t in leaves])
        assert expert_ffn_cuda.launches == before + (i == 0)
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) \
            <= 1e-4 * float(want.abs().max())
    if empty:
        assert torch.all(grads[0][0][:, c - empty:] == 0)


@pytest.mark.parametrize("t,e,k", [(2048, 64, 6), (37, 8, 2), (5, 4, 1)])
def test_topk_gate_backward_on_card_matches_plain_autograd(dev, t, e, k):
    from repro_torch.kernels.topk_gate import TopkGate
    g = _gen(t + e)
    z = torch.randn(t, e, generator=g).to(dev)
    g_v = torch.randn(t, k, generator=g).to(dev)
    g_p = torch.randn(t, k, generator=g).to(dev)
    grads = []
    for fn in (lambda a: TopkGate.apply(topk_gate_cuda, a, 0.3, k),
               lambda a: topk_gate_plain(a, 0.3, k=k)):
        a = z.detach().requires_grad_(True)
        _, vals, probs, _, _ = fn(a)
        (torch.sum(vals * g_v) + torch.sum(probs * g_p)).backward()
        grads.append(a.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_on_card_match_cpu(dev, remat):
    """Reduced DeepSeek (4 experts, top-2): one forward and backward on
    the CPU (plain versions) and on the card (the kernels), with a jitter
    generator on each device: jitter 0 leaves the routing as the
    reference's. Under remat the kernels' forwards run twice per layer."""
    import dataclasses
    from repro_torch.configs.deepseek_v2_lite_buddy import reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.common import fold_in, tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_and_grads
    cfg = reduced()
    assert cfg.moe.router_jitter == 0
    params = T.init_params(cfg, _gen(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=_gen(1))
    out = []
    for d in ("cpu", dev):
        before = ops.launch_counts()
        p = tree_map(lambda t: t.to(d), params)
        t = toks.to(d)
        out.append(loss_and_grads(p, cfg, t[:, :-1], t[:, 1:],
                                  rng=fold_in(0, 1, d), remat=remat))
        after = ops.launch_counts()
        want = cfg.num_layers * (1 + remat) if d == dev else 0
        assert after["topk_gate"] - before["topk_gate"] == want
        assert after["expert_ffn"] - before["expert_ffn"] == want
    (lc, mc, gc), (lg, mg, gg) = out
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    assert abs(float(mg["lb"]) - float(mc["lb"])) <= 1e-5 * float(mc["lb"])
    for a, b in zip(tree_leaves(gc), tree_leaves(gg)):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(a.abs().max())
        assert bool(torch.isfinite(b).all())
    # with jitter on, the card's own generator: remat routes its recompute
    # the same, so the gradients equal those without remat
    jcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_jitter=0.5))
    p = tree_map(lambda t: t.to(dev), params)
    t = toks.to(dev)
    runs = [loss_and_grads(p, jcfg, t[:, :-1], t[:, 1:],
                           rng=fold_in(3, 1, dev), remat=r)
            for r in (False, True)]
    assert float(runs[0][0]) == float(runs[1][0])
    for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(runs[1][2])):
        assert torch.equal(a, b)


def test_serve_only_kernels_raise_under_grad_on_card(dev):
    g = _gen(9)
    e, k, c, d, f = 8, 2, 4, 64, 48
    ws = _weights(g, e, d, f, torch.float32, dev)
    quant = _replicas(ws)
    x = torch.randn(e, c, d, generator=g).to(dev)
    logits = torch.randn(4, e, generator=g).to(dev)
    resident = torch.ones(e, dtype=torch.bool, device=dev)
    table = torch.full((e, 2), -1, dtype=torch.int32, device=dev)
    q = torch.zeros(e, 2, device=dev)
    calls = {                                  # grouped_ffn's x is [2E, C, D]
        "grouped_ffn": lambda w, xx, z: ops.grouped_ffn(
            torch.cat([xx, xx]), w, *ws[1:]),
        "quant_ffn": lambda w, xx, z: ops.quant_ffn(xx, *quant),
        "route": lambda w, xx, z: ops.route(z, 0.3, 0.1, resident, table, q,
                                            k=k)}
    for name, call in calls.items():
        w1 = ws[0].detach().requires_grad_(True)
        xx = x.detach().requires_grad_(True)
        z = logits.detach().requires_grad_(True)
        with pytest.raises(RuntimeError, match=name):
            call(w1, xx, z)
        with torch.no_grad():                  # serving: no gradient needed
            call(w1, xx, z)
        call(ws[0], x, logits)                 # inputs that need none


@pytest.mark.parametrize("arch", ["zamba2-7b", "llama-3.2-vision-11b",
                                  "musicgen-large"])
def test_family_on_card_matches_cpu(dev, arch):
    """The reduced hybrid, VLM and audio configs (torch ops only, no
    kernel of this repo), weights from seed 0 made on the CPU: forward
    (S = 32, the hybrid's chunked scan), 4 decode steps (its per-token
    recurrence) and one forward and backward, with conditioning where the
    config has it, on the CPU and on the card."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_and_grads
    cfg = get_reduced(arch)
    params = T.init_params(cfg, _gen(0), "cpu")
    g = _gen(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    cond = (torch.randn(2, cfg.num_cond_tokens, cfg.cond_dim, generator=g)
            if cfg.num_cond_tokens else None)
    out = []
    ops.reset_launch_counts()
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d), params)
        c = None if cond is None else cond.to(d)
        t = toks.to(d)
        with torch.no_grad():
            fwd = T.forward_train(p, cfg, t[:, :-1], cond_embeds=c)[0]
            caches = T.init_caches(cfg, 2, 8, device=d)
            dec = torch.stack([T.decode_step(p, cfg, t[:, i], caches, i)[0]
                               for i in range(4)])
        loss, _, grads = loss_and_grads(p, cfg, t[:, :-1], t[:, 1:],
                                        cond_embeds=c)
        out.append((fwd.cpu(), dec.cpu(), float(loss), grads))
    assert not any(ops.launch_counts().values())
    (fc, dc, lc, gc), (fg, dg, lg, gg) = out
    torch.testing.assert_close(fg, fc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dg, dc, rtol=1e-4, atol=1e-4)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(tree_leaves(gc), tree_leaves(gg)):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(a.abs().max())


@pytest.mark.parametrize("arch,kind,b,s", [
    ("deepseek-v2-lite-buddy", "decode", 4, 16),
    ("mixtral-8x7b", "decode", 4, 16),
    ("deepseek-v2-lite-buddy", "train", 2, 32)])
def test_meta_counts_equal_card_counts(dev, arch, kind, b, s):
    """The launch tooling's op counter on a reduced MoE step traced on the
    meta device and run on the card: equal FLOPs, bytes, per-op tallies
    and kernel charges (each kernel charged by its cost function, whether
    its plain version or its launch ran), and the card's launches in the
    counted step equal to the charges."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.launch import dryrun
    cfg = get_reduced(arch)
    meta = dryrun.trace(dryrun.make_case(cfg, kind, b, s))[0].as_dict()
    case = dryrun.make_case(cfg, kind, b, s, device=dev)
    ops.reset_launch_counts()
    card = dryrun.trace(case)[0].as_dict()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert meta == card
    assert card["by_kernel"]
    for name, n in launches.items():
        assert n == card["by_kernel"].get(name, {}).get("calls", 0), name


@pytest.mark.parametrize("sq,skv,h,kv,off,causal,window", [
    (3000, 3000, 16, 8, 0, True, 0),          # 6 q chunks, 3 kv chunks
    (2500, 2500, 32, 8, 0, True, 700),        # chunks voided by the window
    (300, 1601, 32, 8, 0, False, 0)])         # cross: 447 keys of padding
def test_flash_attend_on_card_matches_whole_matrix(dev, sq, skv, h, kv, off,
                                                   causal, window):
    """The chunked online softmax against the whole-matrix softmax of
    ``_attend`` on the same card tensors (f32, head dim 128), and its
    gradients against autograd through ``_attend`` (each within 1e-4 of
    its largest entry)."""
    from repro_torch.models import attention as A
    gen = _gen(7)
    q, k, v = [torch.randn(shape, generator=gen).to(dev).requires_grad_()
               for shape in ((1, sq, h, 128), (1, skv, kv, 128),
                             (1, skv, kv, 128))]
    qpos = off + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    valid = torch.ones(sq, skv, dtype=torch.bool, device=dev)
    if causal:
        valid &= kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    w = torch.randn(1, sq, h, 128, generator=gen).to(dev)
    outs, grads = [], []
    for fn in (lambda: A._flash_attend(q, k, v, off, causal=causal,
                                       window=window),
               lambda: A._attend(q, k, v, valid[None])):
        out = fn()
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * w).sum(), (q, k, v)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
