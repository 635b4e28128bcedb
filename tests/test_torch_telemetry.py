"""The port's telemetry and flight recorder (``runtime/telemetry.py``,
``runtime/trace.py``) and the engine's telemetry observer against the JAX
package's, on live reference calls:

  * the metric primitives, ExpertStats, CalibrationMeter and PrefetchMeter
    driven by one seeded stream of operations on both packages: equal
    snapshots before and after merging (exact: the same float arithmetic
    in the same order);
  * the recorder driven by one seeded stream of spans, instants and
    transfer events: byte-equal JSONL and Perfetto exports;
  * the engine on the committed fixture (results/bench/model.npz,
    tables_a0.95_k16.npz; cache-rate 0.5, PrevStepPredictor) with
    ``Telemetry.with_trace()``, batch ``generate`` and the continuous
    scheduler (ring, then paged KV with the prefix cache): the same
    tokens, an equal ``summary()`` (its ``telemetry`` section included)
    and byte-equal ``export_jsonl`` files; per-kind event counts that
    agree with the engine's counters;
  * telemetry off vs on in the port: the same tokens and an equal summary
    outside the telemetry section;
  * the wiring survives ``reset_runtime`` (the trace after a reset is
    still byte-equal to the reference's).

Every comparison is exact (the host-side timeline replays the same
decisions in the same order on both packages) but for two floats of the
int8 tier, held to rel 1e-5 as tests/test_torch_tier_engine.py holds the
first: ``tier/mean_fidelity_loss`` and the degraded calibration row's
``quality_cost_mean``, which is priced from that fidelity. Both come from
f32 quantization-error sums taken in another order on each package."""
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import load_pytree  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro.core.buddies import load_tables as jload_tables  # noqa: E402
from repro.core.policy import BuddyPolicy as JPolicy  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import telemetry as JTel  # noqa: E402
from repro.runtime import trace as JTr  # noqa: E402
from repro.runtime.cache import ExpertCache as JCache  # noqa: E402
from repro.runtime.prefetch import PrevStepPredictor as JPred  # noqa: E402
from repro.runtime.tiers import TieredExpertStore as JStore  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro.training.data import MarkovLM  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core.buddies import load_tables  # noqa: E402
from repro_torch.core.policy import BuddyPolicy  # noqa: E402
from repro_torch.runtime import telemetry as Tel  # noqa: E402
from repro_torch.runtime import trace as Tr  # noqa: E402
from repro_torch.runtime.cache import ExpertCache  # noqa: E402
from repro_torch.runtime.prefetch import PrevStepPredictor  # noqa: E402
from repro_torch.runtime.tiers import TieredExpertStore  # noqa: E402
from repro_torch.serving import scheduler as S  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
TABLES = str(FIXTURE / "tables_a0.95_k16.npz")
# the replica fidelity's f32 sums (see the module docstring)
FID_TOL = 1e-5
FID_PATHS = ("/tier/mean_fidelity_loss",
             "/telemetry/calibration/degraded/quality_cost_mean")


def _jsonable(x):
    return json.loads(json.dumps(x, default=str))


def _assert_summary(a, b, path=""):
    """Equal, exactly, but for the FID_PATHS floats (at FID_TOL)."""
    if any(path.endswith(p) for p in FID_PATHS):
        assert math.isclose(a, b, rel_tol=FID_TOL), f"{path}: {a} != {b}"
    elif isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_summary(a[k], b[k], f"{path}/{k}")
    else:
        assert a == b, f"{path}: {a} != {b}"


# ===========================================================================
# metric primitives and meters, differential
# ===========================================================================
def _metric_stream(mod, seed):
    """One seeded stream of operations on two registries, an ExpertStats,
    two calibration meters and two prefetch meters; returns every
    snapshot before and after merging the second of each pair into the
    first."""
    rng = np.random.default_rng(seed)
    regs = (mod.MetricsRegistry(), mod.MetricsRegistry())
    stats = mod.ExpertStats(3, 8, alpha=0.1)
    cals = (mod.CalibrationMeter(), mod.CalibrationMeter())
    pms = (mod.PrefetchMeter("a"), mod.PrefetchMeter("b"))
    tid = 0
    for _ in range(300):
        i = int(rng.integers(2))
        lab = {"kind": str(rng.choice(["demand", "peer", "late"]))}
        v = float(rng.exponential(1e-3))
        op = int(rng.integers(8))
        if op == 0:
            regs[i].counter("slots", **lab).inc(int(rng.integers(1, 5)))
        elif op == 1:
            regs[i].gauge("depth", **lab).set(v)
        elif op == 2:
            regs[i].histogram("stall_s", **lab).observe(
                v, n=int(rng.integers(1, 3)))
        elif op == 3:
            regs[i].ema("step_s", alpha=0.2, **lab).update(v)
        elif op == 4:
            pick = lambda: rng.choice(8, int(rng.integers(0, 4)),  # noqa: E731
                                      replace=False)
            stats.update(int(rng.integers(3)), pick(), pick(), pick(),
                         pick() if rng.random() < 0.5 else None)
        elif op == 5:
            cals[i].record(str(rng.choice(mod.CalibrationMeter.OUTCOMES)),
                           v, float(rng.exponential(1e-3)),
                           n=int(rng.integers(1, 4)),
                           quality_cost=float(rng.random()))
        elif op == 6:
            tid += 1
            t = types.SimpleNamespace(
                cause=str(rng.choice(["prefetch", "demand", "upgrade"])),
                layer=int(rng.integers(3)), expert=int(rng.integers(8)))
            for kind in ("submit", "escalate", "complete", "cancel"):
                if kind == "submit" or rng.random() < 0.5:
                    pms[i].on_transfer_event(kind, t)
            pms[i].add_expected_saving(v)
        else:
            pms[i].note_used(int(rng.integers(3)),
                             rng.choice(8, 2, replace=False))
            pms[i].note_uncovered_miss(int(rng.integers(3)),
                                       int(rng.integers(8)))

    def snap():
        h = regs[0].histogram("stall_s", kind="demand")
        return {"regs": [r.snapshot() for r in regs],
                "quantiles": [h.quantile(q) for q in (0.1, 0.5, 0.99)],
                "stats": stats.summary(top_k=4),
                "ema_arrays": [a.tolist() for a in (
                    stats.used_ema, stats.hit_ema, stats.miss_ema,
                    stats.degraded_ema)],
                "cals": [c.summary() for c in cals],
                "pms": [p.summary() for p in pms]}

    before = snap()
    regs[0].merge(regs[1])
    cals[0].merge(cals[1])
    pms[0].merge(pms[1])
    return _jsonable({"before": before, "after": snap()})


@pytest.mark.parametrize("seed", range(3))
def test_metric_primitives_match_reference(seed):
    ref, port = _metric_stream(JTel, seed), _metric_stream(Tel, seed)
    assert port == ref
    assert port["after"]["regs"][0] != port["before"]["regs"][0]


def _recorder_stream(mod, seed):
    rng = np.random.default_rng(seed)
    fr = mod.FlightRecorder()
    open_t = []
    for i in range(120):
        ts = float(rng.exponential(1e-3)) * (1 + i // 10)
        op = int(rng.integers(4))
        if op == 0:
            fr.instant(str(rng.choice(["requests", "engine", "layers"])),
                       int(rng.integers(4)), "outcomes", f"e{i}", ts,
                       hit=int(rng.integers(9)))
        elif op == 1:
            fr.span("layers", int(rng.integers(3)), "compute", "compute",
                    ts, ts + float(rng.exponential(1e-4)), tokens=i)
        else:
            link = None if rng.random() < 0.6 else "ici2"
            if open_t and rng.random() < 0.5:
                t, link = open_t.pop(int(rng.integers(len(open_t))))
                kind = str(rng.choice(["escalate", "complete", "cancel"]))
            else:
                t = types.SimpleNamespace(
                    tid=i, cause=str(rng.choice(["prefetch", "peer"])),
                    nbytes=int(rng.integers(1, 1 << 20)), layer=i % 3,
                    expert=i % 7, issue_s=ts, event_seq=i)
                kind = "submit"
                open_t.append((t, link))
            fr.transfer_event(kind, t, ts + 1e-5, link=link)
    return fr


@pytest.mark.parametrize("seed", range(2))
def test_recorder_exports_byte_equal(seed, tmp_path):
    ref, port = _recorder_stream(JTr, seed), _recorder_stream(Tr, seed)
    assert len(port) == len(ref) > 0
    out = {}
    for name, fr, mod in (("ref", ref, JTr), ("port", port, Tr)):
        jl, pf = tmp_path / f"{name}.jsonl", tmp_path / f"{name}.json"
        assert mod.export_trace(fr, str(jl)) == len(fr)
        n = mod.export_trace(fr, str(pf))
        assert n == len(fr.to_perfetto()["traceEvents"])
        assert mod.FlightRecorder.load_jsonl(str(jl)) == fr.sorted_events()
        out[name] = (jl.read_bytes(), pf.read_bytes())
    assert out["port"] == out["ref"]
    assert Tr.export_trace(None, str(tmp_path / "none.jsonl")) == 0


# ===========================================================================
# the engine's observer on the committed fixture
# ===========================================================================
@pytest.fixture(scope="module")
def weights():
    cfg = jprofiling()
    jp = load_pytree(str(FIXTURE / "model.npz"),
                     JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, profiling(), load_npz(str(FIXTURE / "model.npz"), "cpu")


# name: (policy kwargs, tier coverage or None)
CASES = {
    "gather": (dict(), None),
    # cost mode with the int8 tier on half the experts: degraded slots,
    # upgrades and the degraded calibration row
    "cost_fused_int8": (dict(miss_policy="cost", stall_per_quality=2e-4,
                             use_fused_dispatch=True, quant_tier="int8"),
                        0.5),
}


def _engine(weights, mod, name, telemetry=True, **engine_kw):
    """One engine of either package, with its Telemetry.with_trace()
    bundle (or none)."""
    policy_kw, coverage = CASES[name]
    cfg, jp, pcfg, tp = weights
    if mod == "jax":
        c, p, eng, cache, pred, pol, lt, store, tel = (
            cfg, jp, JEngine, JCache, JPred, JPolicy, jload_tables, JStore,
            JTel)
    else:
        c, p, eng, cache, pred, pol, lt, store, tel = (
            pcfg, tp, ServeEngine, ExpertCache, PrevStepPredictor,
            BuddyPolicy, load_tables, TieredExpertStore, Tel)
    n, e = c.num_layers, c.moe.num_experts
    tier = ec = None
    if coverage is not None:
        tier = store(n, e, 0.5, bits=8, d_model=c.d_model, d_ff=c.moe.d_ff,
                     coverage=coverage)
        tier.set_coverage(np.random.default_rng(3).random((n, e)))
        capacity = tier.cache.capacity
    else:
        ec = cache(n, e, 0.5)
        capacity = ec.capacity
    tele = (tel.Telemetry.with_trace(predictor_label="prev-step",
                                     num_layers=n, num_experts=e)
            if telemetry else None)
    return eng(c, p, tables=lt(TABLES), policy=pol(**policy_kw), cache=ec,
               tier=tier, predictor=pred(n, e),
               prefetch_k=max(1, capacity // 2), telemetry=tele,
               **engine_kw), tele


def _trace_bytes(tele, path):
    tele.trace.export_jsonl(str(path))
    return path.read_bytes()


def _check_event_counts(eng, tele):
    """One ``outcomes`` instant per MoE layer per step, one ``step`` span
    per step; the instants' sums equal the engine's hit and buddy counts,
    and the fetch calibration count its fetches."""
    evs = tele.trace.sorted_events()
    out = [e for e in evs if e["kind"] == "outcomes"]
    steps = [e for e in evs if e["kind"] == "step"]
    st = eng.stats
    assert len(out) == st.steps * eng.num_moe_layers
    assert len(steps) == st.steps
    assert sum(e["args"]["hit"] for e in out) == st.n_hit
    assert sum(e["args"]["buddy"] for e in out) == st.n_sub
    assert tele.calibration.summary()["fetch"]["n"] == st.n_miss_fetch


@pytest.mark.parametrize("name", list(CASES))
def test_generate_telemetry_matches_reference(weights, name, tmp_path):
    prompts = MarkovLM(512, seed=0).sample(4, 8)
    out = {}
    for mod in ("jax", "torch"):
        eng, tele = _engine(weights, mod, name)
        toks = np.asarray(eng.generate(prompts, 8))
        out[mod] = (toks, _jsonable(eng.summary()),
                    _trace_bytes(tele, tmp_path / f"{mod}.jsonl"))
        if mod == "torch":
            _check_event_counts(eng, tele)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    _assert_summary(out["torch"][1], out["jax"][1])
    assert out["torch"][2] == out["jax"][2]
    t = out["torch"][1]["telemetry"]
    assert t["trace_events"] > 0 and t["expert_stats"]["steps"]
    if name == "cost_fused_int8":
        assert t["calibration"]["degraded"]["n"] > 0


def _session_requests(mod):
    """Six requests, four of them on a 20-token shared prefix (the paged
    run's prefix hits), arriving in two waves."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, 512, 20)
    reqs = []
    for i, (n, t) in enumerate(zip((4, 6, 13, 5, 7, 3),
                                   (0.0, 0.0, 0.03, 0.035, 0.036, 0.04))):
        head = base if i < 4 else rng.integers(0, 512, 5)
        reqs.append(mod.ServeRequest(
            rid=i, prompt=np.concatenate([head, rng.integers(0, 512, n)])
            .astype(np.int64), max_new_tokens=3, arrival_s=t))
    return reqs


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged_prefix"])
def test_continuous_telemetry_matches_reference(weights, paged, tmp_path):
    kw = dict(paged_kv=True, kv_block=8, prefix_cache=True) if paged else {}
    out = {}
    for mod, smod in (("jax", JS), ("torch", S)):
        eng, tele = _engine(weights, mod, "gather", **kw)
        reqs = _session_requests(smod)
        s = smod.ContinuousScheduler(eng, slots=2, prefill_chunk=4).run(
            smod.RequestQueue(reqs))
        out[mod] = ([r.tokens for r in reqs], _jsonable(s),
                    _trace_bytes(tele, tmp_path / f"{mod}.jsonl"))
        if mod == "torch":
            _check_event_counts(eng, tele)
            lanes = {}
            for ev in tele.trace.sorted_events():
                if ev["track"] == "requests":
                    lanes.setdefault(ev["lane"], set()).add(ev["kind"])
            assert set(lanes) == set(range(6))
            for kinds in lanes.values():
                assert {"arrive", "queued", "prefill", "decode",
                        "retire"} <= kinds
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    s = out["torch"][1]
    assert s["completed"] == 6
    if paged:
        assert s["engine"]["prefix"]["hits"] >= 2
        m = s["engine"]["telemetry"]["metrics"]
        assert m["prefix_tokens"]["kind=hit"] > 0
        assert b'"prefix_hit"' in out["torch"][2]


def test_telemetry_off_vs_on_same_run(weights):
    prompts = MarkovLM(512, seed=2).sample(4, 6)
    runs = {}
    for on in (False, True):
        eng, _ = _engine(weights, "torch", "cost_fused_int8", telemetry=on)
        runs[on] = (eng.generate(prompts, 6), dict(eng.summary()))
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    on = runs[True][1]
    assert "telemetry" not in runs[False][1]
    on.pop("telemetry")
    assert _jsonable(on) == _jsonable(runs[False][1])


def test_wiring_survives_reset_runtime(weights, tmp_path):
    prompts = MarkovLM(512, seed=4).sample(4, 6)
    out = {}
    for mod in ("jax", "torch"):
        eng, tele = _engine(weights, mod, "cost_fused_int8")
        eng.generate(prompts, 3)
        n0 = len(tele.trace)
        eng.reset_runtime()
        assert eng.scheduler.trace is tele.trace
        assert eng.tier.telemetry is tele
        eng.generate(prompts, 3)
        assert len(tele.trace) > n0
        out[mod] = (_jsonable(eng.summary()),
                    _trace_bytes(tele, tmp_path / f"{mod}.jsonl"))
    _assert_summary(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
