"""CPU tests of the benchmark's parts that need no model: the traffic
generator, the operation and byte counts, the result line, the module
guard and the refusal without a card."""
import json
import sys

import numpy as np
import pytest

from chipbench import bench, devtrace, run as run_mod, traffic, yardstick
from chipbench.families import moe_gqa


def _mix(name):
    return bench.load_cell(name)["mix"]


@pytest.mark.parametrize("cell", ["mixtral22.decode64", "mixtral22.prefill"])
def test_traffic_same_seed_same_requests(cell):
    mix = _mix(cell)
    a = traffic.requests(mix, 2**31 + 12345, 1000)
    b = traffic.requests(mix, 2**31 + 12345, 1000)
    assert len(a) == len(b) == mix["block"] * mix["blocks"]
    for (pa, oa), (pb, ob) in zip(a, b):
        assert oa == ob and np.array_equal(pa, pb)


@pytest.mark.parametrize("cell", ["mixtral22.decode64", "mixtral22.prefill"])
def test_traffic_every_seed_serves_the_same_work(cell):
    """Each block holds the block's sizes, in the same order whatever the
    seed; only the token ids change."""
    mix = _mix(cell)
    a = traffic.requests(mix, 7, 1000)
    b = traffic.requests(mix, 8, 1000)
    n = mix["block"]
    for i in range(0, len(a), n):
        assert sorted((len(p), o) for p, o in a[i:i + n]) == \
            sorted(traffic.block_sizes(mix))
    assert [(len(p), o) for p, o in a] == [(len(p), o) for p, o in b]
    assert not all(np.array_equal(p, q) for (p, _), (q, _) in zip(a, b))
    assert [len(p) for p, _ in a[:n]] != [len(p) for p, _ in a[n:2 * n]]


def test_traffic_quantiles_cover_the_ends():
    mix = _mix("mixtral22.decode64")
    sizes = traffic.block_sizes(mix)
    assert min(p for p, _ in sizes) == 8 and max(p for p, _ in sizes) == 32
    assert min(o for _, o in sizes) == 64 and max(o for _, o in sizes) == 256
    pre = traffic.block_sizes(_mix("mixtral22.prefill"))
    assert min(p for p, _ in pre) == 128 and max(p for p, _ in pre) == 2048
    assert traffic.quantile({"dist": "lognormal", "median": 512,
                             "sigma": 0.7, "min": 1, "max": 10**6},
                            5, 11) == 512


RC = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
      "vocab_size": 10, "num_layers": 3, "num_experts": 4, "top_k": 2,
      "expert_d_ff": 6, "num_shared_experts": 1, "sliding_window": 0}


def test_token_flops_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8: 2 * (64 + 32 + 32 + 64) = 384
    # scores and values over 5 keys: 4 * 2 heads * 4 * 5 = 160
    # router 2 * 8 * 4 = 64; 3 experts (2 routed + 1 shared) of
    # 3 matrices 8x6: 3 * 6 * 8 * 6 = 864
    # (the moe_gqa family's count: every layer alike)
    for layer in range(3):
        assert moe_gqa.layer_flops(RC, 5, layer) == 384 + 160 + 64 + 864
    assert yardstick.token_flops(moe_gqa, RC, 5, head=True) == \
        3 * (384 + 160 + 64 + 864) + 2 * 8 * 10
    windowed = dict(RC, sliding_window=3)
    assert moe_gqa.layer_flops(windowed, 5, 0) == 384 + 96 + 64 + 864


def test_ffn_need_and_bound_by_hand():
    flops, nbytes = yardstick.ffn_call_need(RC, rows=5, live=3)
    assert flops == 6 * 8 * 6 * 5
    assert nbytes == 4 * (3 * 8 * 6 * 3 + 2 * 8 * 5)
    pk = {"f32_flops": 1e3, "hbm_bytes_s": 1e3}
    assert yardstick.bound_s(flops, nbytes, pk) == max(flops, nbytes) / 1e3
    assert yardstick.peaks("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    with pytest.raises(ValueError):
        yardstick.peaks("some other card")


def test_result_line_schema():
    dt = {"busy_s": 1.5, "window_s": 2.0, "device_ops": [["k", 1.0]],
          "idle_gaps": [["sampling", 0.1]]}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 5}
    out = run_mod.result_line(True, 3, 0, {"out_tok_s": {"value": 1.0,
                                                       "unit": "tokens/s"}},
                              dict(dev), dt, {"logit_gap": [0.0, 1.0]})
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"]
    assert out["device"]["busy_s"] == 1.5 and out["device"]["window_s"] == 2
    plain = run_mod.result_line(False, 3, 1, {}, dict(dev), None, {})
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "check"]
    json.dumps(out)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("repro_torch_like", "jaxtyping", "reprox.sub"):
        monkeypatch.setitem(sys.modules, name, object())
    found = run_mod.forbidden_modules()
    assert not {"repro_torch_like", "jaxtyping", "reprox"} & set(found)
    monkeypatch.setitem(sys.modules, "repro.serving", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"repro", "jax"} <= set(run_mod.forbidden_modules())


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "mixtral22.decode64", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


class _Evt:
    def __init__(self, name, s, e, dev):
        self.name = name
        self.device_type = "DeviceType.CUDA" if dev else "DeviceType.CPU"
        self.time_range = type("R", (), {"start": s, "end": e})()


def test_devtrace_busy_gaps_and_labels():
    evts = [_Evt("chipbench.step", 0, 40, False),
            _Evt("chipbench.account", 30, 40, False),
            _Evt("chipbench.step", 50, 90, False),
            _Evt("k1", 5, 20, True), _Evt("k2", 10, 25, True),
            _Evt("k1", 55, 60, True), _Evt("chipbench.step", 1, 2, True)]
    out = devtrace.summarize(evts)
    assert out["busy_s"] == pytest.approx(25e-6)
    assert out["window_s"] == pytest.approx(90e-6)
    assert out["busy_by_step_s"] == pytest.approx([20e-6, 5e-6])
    assert out["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    labels = dict((round(g * 1e6), lab) for lab, g in out["idle_gaps"])
    assert labels[30] == "engine _account" and labels[5] == \
        "issue of the step"


def test_benchmark_json_names_what_exists():
    """Every cell's files, every metric's reader, and the contract's
    cross-references: each cell reports setup_s, another end-to-end
    metric and a per-layer one; a per-layer metric's cells report what it
    moves; names and units within their character sets."""
    import re
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    name_re = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit_re = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    cells = {w["name"]: w for w in spec["workloads"]}
    for c in spec["configs"]:
        assert (bench.ROOT / c["file"]).exists()
        assert json.loads((bench.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name_re.match(m["name"]) and unit_re.match(m["unit"])
        assert (bench.HERE / "metrics" / f"{m['name']}.py").exists()
    for name in cells:
        cell = bench.load_cell(name)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        assert all(m["moves"] in e2e for m in cell["per_layer"])
        limits = set(cell["cell"]["check"]["limits"])
        assert limits <= set(check_names()) and "logit_err" in limits
    n = len(cells)
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and n <= 24


def check_names():
    from chipbench import check
    return check.NAMES
