"""Host spans of the port's serving path (``runtime/trace.py``
``HostRecorder``, docs/trace_schema.md "host"): on a tiny engine (reduced
Mixtral through the launcher's ``build_engine``), for the token-by-token
and the chunked loop of ``ContinuousScheduler``:

  * one ``serve.step`` per scheduler step, its parts under it in order and
    without overlap, every span inside its parent;
  * ``model.layer`` once per layer per step, each holding one
    ``model.attn``, ``model.route`` and ``model.dispatch``;
  * the counters (tokens fed, rows given to the expert kernel, routed rows
    of active tokens, tokens profiled) equal to the shapes and masks by
    hand; the request records and walls;
  * spans on against off: the same tokens, ``summary()`` and
    flight-recorder bytes; off records nothing and allocates nothing in
    ``trace.py``; the spans as ``torch.profiler`` ranges; the launcher's
    table and export.
"""
import json
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.moe import _capacity  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousScheduler,  # noqa: E402
                                           ReplayArrivals, RequestQueue,
                                           make_requests)

FLAGS = ["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu"]
STEP_PARTS = ["sched.admit", "sched.feed", "engine.issue", "engine.wait",
              "engine.replay", "engine.sample", "sched.emit",
              "sched.feedback"]
# (prefill chunk, fused dispatch): the decode loop through the capacity
# branch, the chunked loop through the dropless capacity branch and
# through the fused one
LOOPS = [(1, False), (4, False), (4, True)]


@pytest.fixture(autouse=True)
def _no_recorder_left():
    yield
    trace.stop_host()


def _engine(fused=False, telemetry=False):
    """The launcher's engine; ``telemetry``: with the flight recorder (the
    engine build writes nothing to the --trace-out path)."""
    args = serve.parse_args(FLAGS + (["--fused-dispatch"] if fused else [])
                            + (["--trace-out", "unused.jsonl"]
                               if telemetry else []))
    return serve.build_engine(args)


def _serve(eng, lm, chunk, n=6, slots=3):
    rng = np.random.default_rng(5)
    prompts = [lm.sample(1, int(rng.integers(3, 9)))[0] for _ in range(n)]
    reqs = make_requests(prompts, ReplayArrivals([0.0] * n),
                         [int(rng.integers(2, 5)) for _ in range(n)])
    sched = ContinuousScheduler(eng, slots=slots, prefill_chunk=chunk)
    out = sched.run(RequestQueue(reqs))
    return sched, reqs, out


def _end(r):
    return r["ts"] + r["dur"]


def _children(spans, parent):
    return [s for s in spans if s.get("args", {}).get("parent")
            == parent["seq"]]


@pytest.fixture(scope="module", params=LOOPS,
                ids=["decode", "chunked", "chunked_fused"])
def served(request):
    chunk, fused = request.param
    eng, lm = _engine(fused)
    h = trace.start_host()
    try:
        sched, reqs, out = _serve(eng, lm, chunk)
    finally:
        trace.stop_host()
    return chunk, fused, eng, h, sched, reqs


def test_one_serve_step_per_scheduler_step(served):
    chunk, _, _, h, sched, _ = served
    steps = h.spans("serve.step")
    assert len(steps) == sched.steps > 0
    assert [s["lane"] for s in steps] == list(range(sched.steps))
    assert all("parent" not in s.get("args", {}) for s in steps)


def test_step_parts_in_order_without_overlap(served):
    _, _, _, h, _, _ = served
    spans = h.spans()
    chunked = 0
    for st in h.spans("serve.step"):
        kids = _children(spans, st)
        names = [k["name"] for k in kids]
        if "sched.select" in names:         # a chunk step
            names.remove("sched.select")
            chunked += 1
            assert [k["name"] for k in kids].index("sched.select") == \
                STEP_PARTS.index("engine.sample")
        assert names == STEP_PARTS
        for a, b in zip(kids, kids[1:]):
            assert _end(a) <= b["ts"]
        assert all(k["lane"] == st["lane"] for k in kids)
    assert (chunked > 0) == (served[0] > 1)


def test_every_span_inside_its_parent(served):
    _, _, _, h, _, _ = served
    by_seq = {s["seq"]: s for s in h.spans()}
    n = 0
    for s in by_seq.values():
        p = s.get("args", {}).get("parent")
        if p is None:
            continue
        parent = by_seq[p]
        assert parent["ts"] <= s["ts"] and _end(s) <= _end(parent)
        assert parent["seq"] < s["seq"]
        n += 1
    assert n > 0


def test_layer_parts_once_per_layer_per_step(served):
    _, _, eng, h, _, _ = served
    spans = h.spans()
    n_layers = eng.cfg.num_layers
    for st in h.spans("serve.step"):
        issue = [k for k in _children(spans, st)
                 if k["name"] == "engine.issue"][0]
        layers = [k for k in _children(spans, issue)
                  if k["name"] == "model.layer"]
        assert [k["args"]["layer"] for k in layers] == list(range(n_layers))
        for lay in layers:
            parts = _children(spans, lay)
            assert [p["name"] for p in parts] == [
                "model.attn", "model.route", "model.dispatch"]
            assert {p["args"]["layer"] for p in parts} == \
                {lay["args"]["layer"]}
        names = [k["name"] for k in _children(spans, issue)]
        assert names[:2] == ["engine.state", "model.embed"]
        assert names[-1] == "model.head"


def test_counters_by_hand(served):
    chunk, fused, eng, h, sched, _ = served
    spans = h.spans()
    e_n, k_n = eng.cfg.moe.num_experts, eng.cfg.moe.top_k
    b = sched.slots
    # rows given to the expert kernel: the decode step's [E, B x cap]
    # capacity buffer or B x K slots fused; a chunk step's dropless
    # [E, B x C x K] buffer or B x C x K slots fused
    decode_rows = b * k_n if fused else \
        e_n * b * _capacity(1, k_n, e_n, 2.0)
    chunk_rows = b * chunk * k_n * (1 if fused else e_n)
    kernel = "grouped_ffn" if fused else "expert_ffn"
    seen = set()
    for st, occ in zip(h.spans("serve.step"), sched.occupancy):
        issue = [k for k in _children(spans, st)
                 if k["name"] == "engine.issue"][0]
        tokens = issue["args"]["tokens"]
        assert tokens >= occ
        if chunk == 1:
            assert tokens == occ
        disp = [s for s in spans if s["name"] == "model.dispatch"
                and issue["seq"] < s["seq"] and _end(s) <= _end(issue)]
        assert len(disp) == eng.cfg.num_layers
        for d in disp:
            a = d["args"]
            assert a["kernel"] == kernel
            assert a["routed"] == tokens * k_n
            assert a["rows"] in (decode_rows, chunk_rows)
            seen.add(a["rows"])
    assert decode_rows in seen and chunk_rows in seen


def test_chunk_counters_from_the_masks():
    """A chunk step by hand: rows 0 and 2 live with 3 and 1 valid tokens
    of a 4-token chunk, row 1 empty."""
    eng, lm = _engine()
    caches = eng.init_caches(3, 16)
    tokens = lm.sample(3, 4)
    valid = np.zeros((3, 4), bool)
    valid[0, :3] = valid[2, :1] = True
    h = trace.start_host()
    eng.prefill_rows(tokens, np.array([True, False, True]), caches,
                     base_pos=np.zeros(3, np.int64), tok_valid=valid)
    trace.stop_host()
    issue = h.spans("engine.issue")[0]
    assert issue["args"]["tokens"] == 4
    k_n, e_n = eng.cfg.moe.top_k, eng.cfg.moe.num_experts
    for d in h.spans("model.dispatch"):
        assert d["args"] == {"parent": d["args"]["parent"], "layer":
                             d["args"]["layer"], "kernel": "expert_ffn",
                             "rows": e_n * 3 * 4 * k_n, "routed": 4 * k_n}


def test_request_records_and_walls(served):
    _, _, _, h, _, reqs = served
    done = [r for r in reqs if r.tokens]
    assert done
    for r in done:
        recs = [e for e in h.events if e["track"] == trace.HOST_REQUEST_TRACK
                and e["lane"] == r.rid]
        assert [e["kind"] for e in recs] == ["admit", "request"]
        assert all(e["args"]["rid"] == r.rid for e in recs)
        admit, req = recs
        assert len(r.tokens) == len(r.wall_token_s) == req["args"]["tokens"]
        assert admit["ts"] == req["ts"] == r.wall_admitted_s
        assert req["ts"] + req["dur"] == pytest.approx(r.wall_token_s[-1])
        assert req["args"]["first_token_s"] == pytest.approx(
            r.wall_token_s[0] - r.wall_admitted_s)
        assert r.wall_admitted_s <= r.wall_token_s[0]
        assert np.all(np.diff(r.wall_token_s) > 0)


def test_profile_buddies_spans_count_the_tokens():
    eng, lm = _engine()
    h = trace.start_host()
    serve.profile_buddies(eng.cfg, eng.params, lm, steps=3, batch=2, seq=8)
    trace.stop_host()
    (top,) = h.spans("setup.profile_buddies")
    fwd = h.spans("setup.profile_forward")
    assert top["args"]["tokens"] == 3 * 2 * 8
    assert [f["args"] for f in fwd] == [{"parent": top["seq"],
                                         "tokens": 16}] * 3
    assert len(h.spans("model.layer")) == 3 * eng.cfg.num_layers


def _served_bytes(on, chunk, tmp_path):
    eng, lm = _engine(telemetry=True)
    h = trace.start_host() if on else None
    try:
        sched, reqs, out = _serve(eng, lm, chunk)
    finally:
        trace.stop_host()
    path = tmp_path / f"trace_{int(on)}.jsonl"
    eng.telemetry.trace.export_jsonl(str(path))
    out = json.loads(json.dumps(out, default=str))
    return [r.tokens for r in reqs], out, path.read_bytes(), h, reqs


@pytest.mark.parametrize("chunk", [1, 4], ids=["decode", "chunked"])
def test_spans_on_off_same_run(chunk, tmp_path):
    t_off, s_off, b_off, _, r_off = _served_bytes(False, chunk, tmp_path)
    t_on, s_on, b_on, h, _ = _served_bytes(True, chunk, tmp_path)
    assert t_on == t_off
    assert s_on == s_off
    assert b_on == b_off and len(b_on) > 0
    assert len(h.spans("serve.step")) > 0
    assert all(r.wall_token_s is None and r.wall_admitted_s == -1.0
               for r in r_off)


def test_off_records_and_allocates_nothing():
    assert trace.HOST is None
    with trace.span("model.attn", 3) as sp:
        assert sp is None
    assert trace.span("serve.step", step=0) is trace.span("engine.issue")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(2000):
            with trace.span("model.dispatch", i):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == []


def test_spans_are_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    eng, lm = _engine()
    caches = eng.init_caches(2, 8)
    tok = eng._tokens(lm.sample(2, 1)[:, 0])
    trace.start_host()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, caches = eng.step(tok, caches, 0)
        eng.sample_tokens(logits, True)
    trace.stop_host()
    names = {e.name for e in prof.events()}
    want = {"engine.issue", "engine.wait", "engine.replay", "engine.sample",
            "model.embed", "model.head"} | {
        f"model.{p}[{i}]" for p in ("layer", "attn", "route", "dispatch")
        for i in range(eng.cfg.num_layers)}
    assert want <= names


def test_start_twice_refused_and_stop_returns_it():
    h = trace.start_host()
    with pytest.raises(RuntimeError):
        trace.start_host()
    assert trace.stop_host() is h and trace.HOST is None
    assert trace.stop_host() is None


def test_dropped_span_takes_its_records_out():
    h = trace.start_host()
    with trace.span("serve.step", step=0):
        with trace.span("engine.issue"):
            pass
    with trace.span("serve.step", step=1) as sp:
        with trace.span("sched.admit"):
            pass
        sp.drop()
    trace.stop_host()
    assert [(s["name"], s["lane"]) for s in h.spans()] == [
        ("serve.step", 0), ("engine.issue", 0)]


def test_launcher_table_and_export(tmp_path, capsys):
    out = tmp_path / "t.jsonl"
    serve.main(FLAGS + ["--mode", "continuous", "--num-requests", "4",
                        "--steps", "3", "--prefill-chunk", "4",
                        "--trace-out", str(out)])
    text = capsys.readouterr().out
    assert "[host]   serve.step: " in text and "[host]   engine.issue: " \
        in text
    host = tmp_path / "t.host.jsonl"
    recs = trace.FlightRecorder.load_jsonl(str(host))
    assert {r["track"] for r in recs} == {"host", "host:requests"}
    assert {r["name"] for r in recs if r["kind"] == "span"} <= \
        set(trace.SPAN_NAMES)
    assert trace.HOST is None
    assert serve.host_trace_path("a/b.c/t.json") == "a/b.c/t.host.json"
    assert serve.host_trace_path("a/b.c/trace") == "a/b.c/trace.host"
