"""CPU tests of ``chipbench/spans.py``: the idle time of a synthetic
profiler trace put down to the innermost program span, and every reading
on a tiny run of each cell with the program's host spans on, against the
benchmark's own spans and the cell's shapes and masks."""
import numpy as np
import pytest

from chipbench import bench, devtrace, readers, spans, tiny

KINDS = {"mixtral22.decode64": "decode", "mixtral22.prefill": "prefill"}


class _Evt:
    def __init__(self, name, s, e, dev):
        self.name = name
        self.device_type = "DeviceType.CUDA" if dev else "DeviceType.CPU"
        self.time_range = type("R", (), {"start": s, "end": e})()


# two steps: the first issues from 0 to 30 (layer 0's attention 5-12,
# its dispatch 14-20, the head 24-28), waits and replays to 40; the second
# issues 50-60; kernels at 6-8, 10-11, 15-19, 26-27, 33-36, 52-54; the
# device-side copies of ranges (which span their kernels' gaps) are not ops
EVENTS = [_Evt("chipbench.step", 0, 40, False),
          _Evt("chipbench.account", 30, 40, False),
          _Evt("chipbench.step", 50, 70, False),
          _Evt("serve.step", 0, 45, False),
          _Evt("engine.issue", 0, 30, False),
          _Evt("model.layer[0]", 4, 22, False),
          _Evt("model.attn[0]", 5, 12, False),
          _Evt("model.dispatch[0]", 14, 20, False),
          _Evt("model.head", 24, 28, False),
          _Evt("engine.replay", 31, 40, False),
          _Evt("serve.step", 48, 70, False),
          _Evt("engine.issue", 50, 60, False),
          _Evt("k", 6, 8, True), _Evt("k", 10, 11, True),
          _Evt("k", 15, 19, True), _Evt("k", 26, 27, True),
          _Evt("k", 33, 36, True), _Evt("k", 52, 54, True),
          _Evt("engine.issue", 6, 27, True),
          _Evt("model.attn[0]", 6, 11, True)]


def test_idle_put_down_to_the_innermost_span():
    idle = spans.idle_by_span(EVENTS)
    us = {k: round(v * 1e6, 6) for k, v in idle.items()}
    # gaps: 0-6 (mid 3: issue), 8-10 (attn), 11-15 (mid 13: layer),
    # 19-26 (mid 22.5: issue), 27-33 (mid 30: issue ends at 30 -> issue),
    # 36-52 (mid 44: serve.step), 54-70 (mid 62: serve.step)
    assert us == {"engine.issue": 6 + 7 + 6, "model.attn[0]": 2,
                  "model.layer[0]": 4, "serve.step": 16 + 16,
                  "total": 6 + 2 + 4 + 7 + 6 + 16 + 16}
    dt = devtrace.summarize(spans.device_events(EVENTS))
    assert idle["total"] == pytest.approx(dt["window_s"] - dt["busy_s"])
    assert spans.idle_under(EVENTS, "engine.issue") * 1e6 == \
        pytest.approx(6 + 2 + 4 + 7 + 6)
    assert spans.idle_under(EVENTS, "model.layer") * 1e6 == \
        pytest.approx(2 + 4)
    assert spans.split_label("model.attn[12]") == ("model.attn", 12)
    assert spans.split_label("engine.issue") == ("engine.issue", None)
    # the device-side range copies would fill the issue's gaps
    raw = devtrace.summarize(EVENTS)
    assert raw["busy_s"] > dt["busy_s"]


@pytest.fixture(scope="module", params=list(KINDS))
def spanned(request):
    cell = tiny.cell(request.param)
    run = spans.SpannedRun(cell, 1234567890123, 1.5, False, "cpu")
    run.build()
    run.serve()
    return request.param, run


def test_every_reading_on_a_tiny_run(spanned):
    name, run = spanned
    kind = KINDS[name]
    got = spans.readings(run, kind)
    for key, value in got.items():
        if key.startswith("issue_idle_ms"):
            assert value is None            # no device trace on the CPU
        else:
            assert value is not None and value > 0, key
    parts = sum(got[f"{k}.{kind}"] for k in
                ("issue_ms", "device_wait_ms", "replay_ms", "sample_ms",
                 "sched_ms"))
    assert parts <= got[f"cycle_ms.{kind}"]       # one after another


def test_replay_and_sched_against_the_benchmarks_spans(spanned):
    """The program's ``_account`` (wait + replay) lies inside the
    benchmark's ``account_ms`` bracket, which also holds the benchmark's
    own copy of the step's records (on the CPU a real concatenation, some
    0.2-0.4 ms at these shapes; an async launch on the card); the
    scheduler's spans lie inside ``loop_host_ms``."""
    name, run = spanned
    kind = KINDS[name]
    rows = spans.step_parts(run, kind)
    wait = 1e3 * np.mean([spans._dur(p, "engine.wait") for _, _, p in rows])
    replay, account = spans.replay_ms(run, kind), readers.account_ms(run,
                                                                     kind)
    assert replay + wait <= account
    assert spans.sched_ms(run, kind) <= readers.loop_host_ms(run, kind)
    br = spans.brackets_ms(run, kind)
    parts = ("to_wait_ms", "wait_ms", "to_replay_ms", "replay_ms",
             "after_replay_ms")
    assert all(br[k] >= 0 for k in parts)
    assert sum(br[k] for k in parts) == pytest.approx(account, rel=1e-9)


def test_dispatch_fill_from_the_benchmarks_masks(spanned):
    """The fill by hand from the steps the benchmark stamped: routed rows
    of the valid tokens it saw over the rows of the cell's dispatch."""
    name, run = spanned
    kind = KINDS[name]
    steps = [st for st, _ in readers._steps(run, kind)]
    rc = run.rc
    e_n, k_n, b = rc["num_experts"], rc["top_k"], run.args.slots
    routed = sum(int(np.sum(st.valid)) for st in steps) * k_n
    if kind == "decode":
        from repro_torch.models.moe import _capacity
        given = len(steps) * e_n * b * _capacity(1, k_n, e_n, 2.0)
    else:
        given = sum(st.valid.size for st in steps) * k_n    # fused T x K
    assert spans.dispatch_fill(run, kind) == pytest.approx(
        100.0 * routed / given)


def test_profile_tok_s_inside_the_benchmarks_timing(spanned):
    _, run = spanned
    (top,) = [e for e in run.host.events
              if e["name"] == "setup.profile_buddies"]
    assert top["args"]["tokens"] == 4 * 4 * 64
    assert spans.profile_tok_s(run) >= 1024 / run.setup["profile_s"]


def test_a_run_without_spans_reads_none():
    run = bench.Run(tiny.cell("mixtral22.decode64"), 7, 0.5, False, "cpu")
    assert all(v is None for v in spans.readings(run, "decode").values())
