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
from repro_torch.kernels.route import launch_plan as route_plan  # noqa
from repro_torch.kernels.route import (Route, route_cuda,  # noqa: E402
                                       route_plain)
from repro_torch.kernels.topk_gate import (topk_gate_cuda,  # noqa: E402
                                           topk_gate_plain)
from repro_torch.kernels.wkv_chunk import (wkv_chunk_cuda,  # noqa: E402
                                           wkv_chunk_plain)
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402

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


@pytest.mark.parametrize("t", [1, 4, 256, 257, 4096])
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
    assert route_plan(t, k).launches == (1 if t <= 256 else 2)
    if case == "none_masks":
        assert not got.substituted.any()


@pytest.mark.parametrize("t", [2, 258])
@pytest.mark.parametrize("above", [False, True])
def test_route_distribution_gate_at_beta(dev, t, above):
    """2 of 8 requested experts non-resident, delta = 0.25 exactly: the
    gate is shut at beta = 0.25 and open one f32 ulp above, in the one-block
    and in the two-launch form."""
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


@pytest.mark.parametrize("t", [4, 32, 256, 4096])
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


@pytest.mark.parametrize("b,h,n,c,d", [(4, 32, 16, 32, 64),
                                       (2, 32, 8, 32, 128),
                                       (3, 1, 4, 16, 32), (1, 2, 1, 16, 128),
                                       (2, 3, 5, 32, 32)])
def test_wkv_chunk(dev, b, h, n, c, d):
    args = R.random_chunk_operands(_gen(b + n), b, h, n, c, d, dev)
    before = wkv_chunk_cuda.launches
    got = wkv_chunk_cuda(*args)
    assert wkv_chunk_cuda.launches == before + 1
    want = wkv_chunk_plain(*args)
    for g_, w_ in zip(got, want):
        _wkv_close(g_, w_)


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
    4 x 80 = 320 tokens route runs its two-launch form."""
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
    assert route_plan(b * c, 6).launches == (2 if b * c > 256 else 1)
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
