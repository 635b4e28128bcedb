"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, and the model path on the card against the same path on the CPU.
These need an NVIDIA GPU with the CUDA toolkit and skip elsewhere. This
file imports no JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.buddy_substitute import (  # noqa: E402
    buddy_substitute_cuda, buddy_substitute_plain)
from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,  # noqa: E402
                                            expert_ffn_plain)
from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,  # noqa: E402
                                             grouped_ffn_plain)
from repro_torch.kernels.topk_gate import (topk_gate_cuda,  # noqa: E402
                                           topk_gate_plain)
from repro_torch.models import moe as M  # noqa: E402

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


def _quantize(w):
    s = w.abs().amax(1).clamp(min=1e-8) / 127.0
    return torch.round(w / s[:, None, :]).clamp(-127, 127).to(torch.int8), s


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
        (q1, s1), (q3, s3), (q2, s2) = (_quantize(w.float()) for w in ws)
        quant = (q1, s1, q3, s3, q2, s2)
    for cnt in (None, counts):
        got = grouped_ffn_cuda(x, *ws, quant, cnt)
        want = grouped_ffn_plain(x, *ws, quant, cnt)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert torch.all(got[1] == 0)


def test_wrappers_check_their_operands(dev):
    z = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError):
        topk_gate_cuda(z.double(), 0.2, k=2)
    with pytest.raises(ValueError):
        topk_gate_cuda(z.t(), 0.2, k=2)            # not contiguous
    with pytest.raises(ValueError):
        topk_gate_cuda(torch.randn(4, 300, device=dev), 0.2, k=2)
    x = torch.randn(2, 3, 8, device=dev)
    ws = _weights(_gen(0), 2, 8, 4, torch.float32, dev)
    with pytest.raises(ValueError):
        expert_ffn_cuda(x.half(), *ws)
    with pytest.raises(ValueError):
        grouped_ffn_cuda(x, *ws)                   # needs 2E groups


def _moe_case(devices, e, k, shape, policy, seed=0):
    cfg = MoEConfig(num_experts=e, top_k=k, d_ff=48, num_shared_experts=1)
    p = M.init_moe(_gen(seed), 64, cfg, torch.float32, "cpu")
    g = _gen(seed + 1)
    x = torch.randn(*shape, 64, generator=g) * 0.5
    table = torch.stack([torch.roll(torch.arange(e), -i - 1)[:4]
                         for i in range(e)]).to(torch.int32)
    buddy = M.BuddyState((torch.rand(e, generator=g) < 0.5), table,
                         torch.rand(e, 4, generator=g).sort(
                             -1, descending=True).values,
                         torch.zeros(e, dtype=torch.int32))
    out = []
    for d in devices:
        pd = {name: (v.to(d) if torch.is_tensor(v) else
                     {kk: vv.to(d) for kk, vv in v.items()})
              for name, v in p.items()}
        out.append(M.moe_forward(pd, x.to(d), cfg, policy=policy,
                                 buddy=M.BuddyState(*[a.to(d)
                                                      for a in buddy[:4]])))
    return out


@pytest.mark.parametrize("fused,shape", [(True, (4, 1)), (False, (4, 1)),
                                         (False, (2, 16)), (True, (2, 16))])
def test_moe_forward_on_card_matches_cpu(dev, fused, shape):
    pol = BuddyPolicy(tau=0.0, beta=1.1, rho=2, H=4,
                      use_fused_dispatch=fused)
    before = ops.launch_counts()
    (cy, ca), (gy, ga) = _moe_case(("cpu", dev), 16, 3, shape, pol)
    after = ops.launch_counts()
    assert after["topk_gate"] == before["topk_gate"] + 1
    assert after["buddy_substitute"] == before["buddy_substitute"] + 1
    torch.testing.assert_close(gy.cpu(), cy, rtol=1e-4, atol=1e-4)
    for name in ("indices", "orig_indices", "sub_slots", "miss_slots",
                 "miss_per_expert"):
        assert torch.equal(getattr(ga, name).cpu(), getattr(ca, name)), name
    assert int(ga.n_dropped) == int(ca.n_dropped)


@pytest.mark.parametrize("kw", [dict(miss_policy="cost"), dict(eta=0.3),
                                dict(kappa=0.1), dict(temperature=0.9),
                                dict(margin_gamma=0.5)])
def test_policies_outside_the_kernels_raise_on_card(dev, kw):
    with pytest.raises(NotImplementedError):
        _moe_case((dev,), 16, 3, (4, 1), BuddyPolicy(**kw))
