"""The launch tooling's roofline (``repro_torch.launch.roofline``): the
model FLOPs and the three terms against the reference's
``repro.launch.roofline``, and the op counter's conventions on small ops
(dot FLOPs, views, in-place ops, a kernel call charged as one unit)."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import base as ref_base  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import expert_ffn as ffn_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import route as route_mod  # noqa: E402
from repro_torch.kernels import topk_gate as gate_mod  # noqa: E402
from repro_torch.kernels import wkv_chunk as wkv_mod  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(base.ARCH_IDS))
def test_model_flops_match_reference(arch):
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    for shp in base.SHAPES.values():
        assert rl.model_flops(cfg, shp.kind, shp.seq_len, shp.global_batch) \
            == ref_rl.model_flops(ref_cfg, shp.kind, shp.seq_len,
                                  shp.global_batch)


REPORTS = [(3.1e12, 2.2e9, 4.5e8, 7.0e14, 256),
           (1.0e9, 9.0e10, 0.0, 2.0e11, 512),
           (5.0e13, 1.0e8, 3.0e10, 1.0e15, 256),
           (0.0, 0.0, 0.0, 0.0, 1)]


@pytest.mark.parametrize("flops,nbytes,coll,mflops,chips", REPORTS)
def test_finalize_matches_reference_with_its_constants(flops, nbytes, coll,
                                                       mflops, chips):
    """Given the reference's three constants (read from its module), every
    field finalize computes equals the reference's."""
    hw = rl.HardwareSpec(name="reference", hbm_bytes_per_s=ref_rl.HBM_BW,
                         peak_flops={"bfloat16": ref_rl.PEAK_FLOPS},
                         link_bytes_per_s=ref_rl.ICI_BW)
    kw = dict(arch="a", shape="s", mesh="16x16", chips=chips,
              flops_per_device=flops, bytes_per_device=nbytes,
              coll_bytes_per_device=coll, model_flops=mflops)
    got = rl.RooflineReport(**kw).finalize(hw)
    want = ref_rl.RooflineReport(**kw).finalize()
    for f in ("compute_s", "memory_s", "collective_s", "dominant",
              "useful_flop_ratio"):
        assert getattr(got, f) == getattr(want, f), f
    assert want.as_dict().items() <= got.as_dict().items()
    assert rl.summarize(got) == ref_rl.summarize(want)


def test_finalize_without_collectives_and_the_h100_peaks():
    r = rl.RooflineReport("a", "s", "16x16", 256, 67e12, 3.35e12, None, 0.0,
                          dtype="float32").finalize()
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, None)
    assert r.hardware == rl.H100.name and "700 W" in r.hardware
    assert rl.H100.peak(torch.bfloat16) == rl.H100.peak("bfloat16") == 989e12
    assert rl.H100.peak(torch.float32) == 67e12
    assert rl.H100.hbm_bytes_per_s == 3.35e12
    assert "n/a" in rl.summarize(r)


def _count(fn, *args):
    with rl.OpCounter() as c:
        out = fn(*args)
    return c, out


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dot_and_convolution_flops(device):
    def t(*shape):
        return torch.ones(*shape, device=device)
    cases = [
        (torch.mm, (t(3, 5), t(5, 7)), 2 * 3 * 7 * 5),
        (torch.bmm, (t(4, 3, 5), t(4, 5, 7)), 2 * 4 * 3 * 7 * 5),
        (torch.addmm, (t(7), t(3, 5), t(5, 7)), 2 * 3 * 7 * 5),
        (torch.baddbmm, (t(4, 3, 7), t(4, 3, 5), t(4, 5, 7)),
         2 * 4 * 3 * 7 * 5),
        (torch.matmul, (t(2, 3, 5), t(5, 7)), 2 * 2 * 3 * 7 * 5),
        (lambda a, b: torch.einsum("bij,bjk->bik", a, b),
         (t(4, 3, 5), t(4, 5, 7)), 2 * 4 * 3 * 7 * 5),
        (torch.nn.functional.conv1d, (t(2, 3, 10), t(6, 3, 4)),
         2 * 2 * 6 * 7),
        (lambda a, b: a * b + 1.0, (t(3, 5), t(3, 5)), 0),
    ]
    for fn, args, want in cases:
        c, _ = _count(fn, *args)
        assert c.flops == want, fn


def test_views_charge_nothing_and_ops_charge_their_tensors():
    x = torch.ones(4, 6)
    c, _ = _count(lambda a: a.view(6, 4).t()[:, 1:3].unsqueeze(0)
                  .expand(2, 4, 2).reshape(2, 4, 2).detach(), x)
    assert (c.flops, c.bytes) == (0, 0)
    c, _ = _count(lambda a: a.t().reshape(24), x)     # copies: not a view
    assert c.bytes == 2 * 4 * 6 * 4
    c, _ = _count(lambda a: a + a, x)                 # one read, one write
    assert c.bytes == 2 * 4 * 6 * 4
    c, _ = _count(lambda a: a.add_(1.0), x)           # in place: once
    assert c.bytes == 4 * 6 * 4
    c, _ = _count(lambda a: torch.empty_like(a), x)   # allocates only
    assert c.bytes == 0
    c, _ = _count(lambda a: a.to(torch.bfloat16), x)  # a real copy
    assert c.bytes == 4 * 6 * 4 + 4 * 6 * 2
    assert dict(c.by_op) == {"aten._to_copy.default":
                             {"calls": 1, "flops": 0, "bytes": 144}}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_call_is_charged_by_its_cost_alone(device):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 16, generator=g).to(device)
    w1 = torch.randn(3, 16, 8, generator=g).to(device)
    w3 = torch.randn(3, 16, 8, generator=g).to(device)
    w2 = torch.randn(3, 8, 16, generator=g).to(device)
    c, y = _count(ops.expert_ffn, x, w1, w3, w2)
    assert y.shape == x.shape and y.device.type == device
    flops, nbytes = ffn_mod.expert_ffn_cost(x, w1, w3, w2)
    assert (flops, nbytes) == (3 * 2 * 3 * 5 * 16 * 8,
                               4 * (2 * x.numel() + w1.numel() * 3))
    assert dict(c.by_kernel) == {"expert_ffn": {"calls": 1, "flops": flops,
                                                "bytes": nbytes}}
    assert dict(c.by_op) == {}                  # the plain version's ops
    assert (c.flops, c.bytes) == (flops, nbytes)
    logits = torch.randn(6, 8, generator=g).to(device)
    c, _ = _count(lambda: ops.topk_gate(logits, 0.5, k=2))
    assert dict(c.by_kernel)["topk_gate"] == {
        "calls": 1, "flops": 0,
        "bytes": gate_mod.topk_gate_cost(logits, k=2)[1]}
    assert c.flops == 0 and dict(c.by_op) == {}


def test_cost_functions_read_shapes_only():
    m = dict(device="meta")
    logits = torch.empty(4, 64, **m)
    table = torch.empty(64, 8, dtype=torch.int32, **m)
    res = torch.empty(64, dtype=torch.bool, **m)
    q = torch.empty(64, 8, **m)
    fetch = torch.empty(64, **m)
    _, b = route_mod.route_cost(logits, 0.5, 0.9, res, table, q, k=6,
                                fetch_cost=fetch, quant_ok=None)
    assert b == 4 * 256 + 64 + 2 * 64 * 8 * 4 + 64 * 4 + 21 * 24 + 20 + 1
    rt = torch.empty(8, 2, 16, 64, **m)
    f, b = wkv_mod.wkv_chunk_cost(rt, rt, rt, rt, torch.empty(8, 2, 64, **m),
                                  torch.empty(8, 2, 16, **m),
                                  torch.empty(8, 64, 64, **m))
    assert f == 8 * 2 * (2 * 16 * 16 * 64 * 2 + 2 * 16 * 64 * 64 * 2)
    assert b == 4 * (5 * rt.numel() + 8 * 2 * 64 + 8 * 2 * 16
                     + 2 * 8 * 64 * 64)


def test_meter_is_released():
    with rl.OpCounter() as c:
        assert ops._METER is c
        with pytest.raises(RuntimeError, match="another counter"):
            rl.OpCounter().__enter__()
    assert ops._METER is None
    before = c.as_dict()
    x = torch.ones(2, 3, 4)
    w = torch.ones(2, 4, 5)
    ops.expert_ffn(x, w, w, torch.ones(2, 5, 4))   # no meter: no charge
    assert c.as_dict() == before
