"""Metrics registry + cost-model calibration telemetry.

Three layers, all opt-in (a ``None`` telemetry leaves the runtime's code
path, outputs, and summaries bit-identical to pre-telemetry behavior):

  MetricsRegistry  counters / gauges / histograms / windowed EMAs with
                   labels — replaces ad-hoc summary accumulation. Metrics
                   are keyed by (name, sorted label items) and mergeable
                   (multi-engine benchmark aggregation).
  ExpertStats      per-(layer, expert) hit / miss / degraded EMAs — the
                   ledger-to-signal layer ROADMAP direction 3 ("online
                   expert replication + router shaping") trains on.
  CalibrationMeter for every miss, the cost model's PREDICTED stall-seconds
                   for the chosen outcome next to the REALIZED stall from
                   the transfer timeline, bucketed by outcome class — turns
                   "calibrate HardwareModel / stall_per_quality" into a
                   measured residual instead of a guess.
  PrefetchMeter    per-predictor prefetch precision / recall / expected
                   stall saved, driven by TransferScheduler events plus two
                   engine hooks (used-in-time, uncovered demand miss).

``Telemetry`` bundles the four with an optional FlightRecorder
(runtime/trace.py) and renders ``summary()`` — surfaced by the serving
engine as ``summary()["telemetry"]`` and reported by
benchmarks/bench_telemetry.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.trace import FlightRecorder

# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic accumulator; ``merge`` sums across registries."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def merge(self, other: "Counter") -> None:
        self.value += other.value

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value (``merge`` keeps the max — high-water
    semantics, the only aggregation meaningful across registries)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def merge(self, other: "Gauge") -> None:
        # last-write-wins has no meaning across registries; keep the max so
        # merged high-water gauges (queue depth, inflight) stay useful
        self.value = max(self.value, other.value)

    def snapshot(self):
        return self.value


class Histogram:
    """Log-spaced-bucket histogram for latency-like positive values.

    Default bounds span 1 us .. 100 s in quarter-decade steps — wide enough
    for both simulated stall seconds and modeled step times. Two histograms
    merge iff their bounds match (bucket-wise count addition; sum/count/min/
    max combine exactly)."""

    DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
        10.0 ** (-6 + 0.25 * i) for i in range(33))   # 1e-6 .. 1e2

    __slots__ = ("bounds", "counts", "sum", "n", "min", "max")

    def __init__(self, bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.bounds = tuple(bounds) if bounds is not None \
            else self.DEFAULT_BOUNDS
        assert all(a < b for a, b in zip(self.bounds, self.bounds[1:])), \
            "histogram bounds must be strictly increasing"
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self.sum = 0.0
        self.n = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float, n: int = 1) -> None:
        # bisect over a short tuple; values at a bound land in that bucket
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += n
        self.sum += v * n
        self.n += n
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge(self, other: "Histogram") -> None:
        assert self.bounds == other.bounds, \
            "cannot merge histograms with different bucket bounds"
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.sum += other.sum
        self.n += other.n
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound quantile estimate (conservative)."""
        assert 0.0 <= q <= 1.0
        if self.n == 0:
            return 0.0
        rank = q * self.n
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c > 0:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def snapshot(self) -> dict:
        return {"n": self.n, "sum": self.sum,
                "mean": self.sum / self.n if self.n else 0.0,
                "min": self.min if self.n else 0.0,
                "max": self.max if self.n else 0.0,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


class EMA:
    """Exponential moving average with a half-life expressed in updates.

    ``merge`` combines two EMAs as a count-weighted average — exact for
    equal-rate streams and the standard approximation otherwise (tested in
    tests/test_telemetry.py)."""

    __slots__ = ("alpha", "value", "n")

    def __init__(self, alpha: float = 0.1) -> None:
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self.value = 0.0
        self.n = 0

    def update(self, v: float) -> float:
        if self.n == 0:
            self.value = float(v)       # seed at the first sample, no pull
        else:                           # toward the arbitrary zero init
            self.value += self.alpha * (float(v) - self.value)
        self.n += 1
        return self.value

    def merge(self, other: "EMA") -> None:
        assert self.alpha == other.alpha, \
            "cannot merge EMAs with different decay rates"
        tot = self.n + other.n
        if tot == 0:
            return
        self.value = (self.value * self.n + other.value * other.n) / tot
        self.n = tot

    def snapshot(self) -> dict:
        return {"value": self.value, "n": self.n}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "ema": EMA}


class MetricsRegistry:
    """Labelled metric store. Metrics are created on first touch:

        reg.counter("stall_events", cause="demand").inc()
        reg.histogram("stall_s", cause="demand").observe(0.01)
        reg.ema("step_time_s", alpha=0.05).update(t)

    Keys are (name, sorted label items); a name is bound to ONE metric kind
    (mixing kinds under a name is a bug and asserts). ``snapshot`` renders
    {name: {label_repr: value}}; ``merge`` folds another registry in
    (kind-wise merge semantics above)."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._kind_of: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: dict, **ctor):
        assert self._kind_of.setdefault(name, kind) == kind, \
            f"metric {name!r} already registered as {self._kind_of[name]}"
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = _KINDS[kind](**ctor)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, bounds=None, **labels) -> Histogram:
        if bounds is None:
            return self._get("histogram", name, labels)
        return self._get("histogram", name, labels, bounds=bounds)

    def ema(self, name: str, alpha: float = 0.1, **labels) -> EMA:
        return self._get("ema", name, labels, alpha=alpha)

    def merge(self, other: "MetricsRegistry") -> None:
        for (name, lab), m in other._metrics.items():
            kind = other._kind_of[name]
            assert self._kind_of.setdefault(name, kind) == kind, \
                f"merge kind clash on metric {name!r}"
            mine = self._metrics.get((name, lab))
            if mine is None:
                # fresh copies so the merged registry owns its state
                if kind == "histogram":
                    mine = Histogram(m.bounds)
                elif kind == "ema":
                    mine = EMA(m.alpha)
                else:
                    mine = _KINDS[kind]()
                self._metrics[(name, lab)] = mine
            mine.merge(m)

    @staticmethod
    def _label_repr(lab: Tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in lab) if lab else ""

    def snapshot(self) -> dict:
        out: Dict[str, dict] = {}
        for (name, lab), m in sorted(self._metrics.items(),
                                     key=lambda kv: (kv[0][0],
                                                     str(kv[0][1]))):
            out.setdefault(name, {})[self._label_repr(lab)] = m.snapshot()
        return out


# ---------------------------------------------------------------------------
# Per-expert hit/miss/degraded EMAs (ROADMAP direction 3's training signal)
# ---------------------------------------------------------------------------
class ExpertStats:
    """[L, E] EMAs of per-step usage, hit, miss, and degraded indicators.

    Updated once per (layer, step) with the step's expert sets; rows decay
    every step so the EMAs track the traffic's CURRENT hot set — exactly
    the signal online replication / set_coverage re-picking needs."""

    def __init__(self, num_layers: int, num_experts: int,
                 alpha: float = 0.05) -> None:
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        shape = (num_layers, num_experts)
        self.used_ema = np.zeros(shape)
        self.hit_ema = np.zeros(shape)
        self.miss_ema = np.zeros(shape)
        self.degraded_ema = np.zeros(shape)
        self.steps = np.zeros(num_layers, np.int64)

    def update(self, layer: int, used, hit, missed, degraded=None) -> None:
        a = self.alpha
        for arr, experts in ((self.used_ema, used), (self.hit_ema, hit),
                             (self.miss_ema, missed),
                             (self.degraded_ema, degraded)):
            row = arr[layer]
            row *= (1.0 - a)
            if experts is not None and len(experts):
                # indicator EMA: each listed expert moves toward 1 this step
                row[np.unique(np.asarray(experts, np.int64))] += a
        self.steps[layer] += 1

    def summary(self, top_k: int = 5) -> dict:
        """Aggregates only — the full [L, E] arrays stay on the object for
        programmatic consumers (replication policies, set_coverage)."""
        flat_miss = self.miss_ema.ravel()
        order = np.argsort(-flat_miss)[:top_k]
        l_n = self.miss_ema.shape[1]
        return {
            "alpha": self.alpha,
            "steps": int(self.steps.max(initial=0)),
            "mean_used_ema": float(self.used_ema.mean()),
            "mean_miss_ema": float(self.miss_ema.mean()),
            "mean_degraded_ema": float(self.degraded_ema.mean()),
            "top_miss": [
                {"layer": int(i // l_n), "expert": int(i % l_n),
                 "miss_ema": float(flat_miss[i])}
                for i in order if flat_miss[i] > 0.0],
        }


# ---------------------------------------------------------------------------
# Miss-cost calibration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _OutcomeCal:
    n: int = 0
    predicted_sum_s: float = 0.0
    realized_sum_s: float = 0.0
    abs_residual_sum_s: float = 0.0
    sq_residual_sum: float = 0.0
    max_abs_residual_s: float = 0.0
    quality_cost_sum: float = 0.0


class CalibrationMeter:
    """Predicted-vs-realized stall per miss-outcome class.

    The engine records, at the instant a miss outcome is chosen, the cost
    model's predicted stall-seconds for that outcome (the fetch ETA for
    fetch; the ICI-link ETA for peer-HBM borrows; 0 for the transfer-free
    buddy/degraded/drop outcomes) and the realized stall the timeline then
    actually charged. The per-class residual (realized - predicted) is the
    direct calibration signal for ``HardwareModel`` (fetch and peer
    classes) and — via the recorded quality-cost column — for the
    ``stall_per_quality`` exchange rate."""

    OUTCOMES = ("buddy", "degraded", "peer", "fetch", "drop")

    def __init__(self) -> None:
        self.by_outcome: Dict[str, _OutcomeCal] = {
            o: _OutcomeCal() for o in self.OUTCOMES}

    def record(self, outcome: str, predicted_s: float, realized_s: float,
               n: int = 1, quality_cost: float = 0.0) -> None:
        c = self.by_outcome[outcome]
        r = realized_s - predicted_s
        c.n += n
        c.predicted_sum_s += predicted_s * n
        c.realized_sum_s += realized_s * n
        c.abs_residual_sum_s += abs(r) * n
        c.sq_residual_sum += r * r * n
        c.max_abs_residual_s = max(c.max_abs_residual_s, abs(r))
        c.quality_cost_sum += quality_cost * n

    def merge(self, other: "CalibrationMeter") -> None:
        for o, c in other.by_outcome.items():
            mine = self.by_outcome[o]
            mine.n += c.n
            mine.predicted_sum_s += c.predicted_sum_s
            mine.realized_sum_s += c.realized_sum_s
            mine.abs_residual_sum_s += c.abs_residual_sum_s
            mine.sq_residual_sum += c.sq_residual_sum
            mine.max_abs_residual_s = max(mine.max_abs_residual_s,
                                          c.max_abs_residual_s)
            mine.quality_cost_sum += c.quality_cost_sum

    def summary(self) -> dict:
        out = {}
        for o, c in self.by_outcome.items():
            if c.n == 0:
                out[o] = {"n": 0}
                continue
            out[o] = {
                "n": c.n,
                "predicted_mean_s": c.predicted_sum_s / c.n,
                "realized_mean_s": c.realized_sum_s / c.n,
                "residual_mean_s": (c.realized_sum_s - c.predicted_sum_s)
                / c.n,
                "residual_abs_mean_s": c.abs_residual_sum_s / c.n,
                "residual_rms_s": math.sqrt(c.sq_residual_sum / c.n),
                "residual_max_abs_s": c.max_abs_residual_s,
                "quality_cost_mean": c.quality_cost_sum / c.n,
            }
        return out


# ---------------------------------------------------------------------------
# Prefetch precision / recall
# ---------------------------------------------------------------------------
class PrefetchMeter:
    """Per-predictor prefetch quality. Attached to the TransferScheduler as
    an event listener (prefetch-cause events only) plus two engine hooks:

      note_used(layer, experts)   — a landed prefetch's expert was actually
                                    routed to at its layer (true positive;
                                    counted once per landed transfer)
      note_uncovered_miss(l, e)   — a demand miss with nothing in flight
                                    (the predictor never covered it)

    precision = used / issued          (issued bytes that paid off)
    recall    = used / (used + late + uncovered)
                                       (needed experts delivered IN TIME —
                                        a late prefetch is a recall miss:
                                        the layer still stalled)
    ``expected_stall_saved_s`` accumulates the cost model's P(use) x
    miss-cost score of every issued prefetch (cost-ranked mode), directly
    comparable to the realized stall the ledger charges."""

    def __init__(self, label: str = "") -> None:
        self.label = label
        self.n_issued = 0
        self.n_cancelled = 0
        self.n_landed = 0
        self.n_used = 0
        self.n_late = 0
        self.n_uncovered_miss = 0
        self.expected_stall_saved_s = 0.0
        self._landed: set = set()
        self._late: set = set()

    # -- scheduler event path -------------------------------------------
    def on_transfer_event(self, kind: str, t) -> None:
        if t.cause != "prefetch":
            return
        key = (t.layer, t.expert)
        if kind == "submit":
            self.n_issued += 1
        elif kind == "cancel":
            self.n_cancelled += 1
        elif kind == "escalate":
            self.n_late += 1
            self._late.add(key)
        elif kind == "complete":
            self.n_landed += 1
            # an escalated prefetch that now lands was LATE — the layer
            # already stalled for its tail, so it must not also be credited
            # as a used-in-time true positive when its expert is routed to
            if key in self._late:
                self._late.discard(key)
            else:
                self._landed.add(key)

    # -- engine hooks ---------------------------------------------------
    def add_expected_saving(self, seconds: float) -> None:
        self.expected_stall_saved_s += float(seconds)

    def note_used(self, layer: int, experts) -> None:
        for e in experts:
            key = (layer, int(e))
            if key in self._landed:
                self._landed.discard(key)
                self.n_used += 1

    def note_uncovered_miss(self, layer: int, expert: int) -> None:
        self.n_uncovered_miss += 1

    # -- reporting ------------------------------------------------------
    def precision(self) -> float:
        return self.n_used / self.n_issued if self.n_issued else 0.0

    def recall(self) -> float:
        needed = self.n_used + self.n_late + self.n_uncovered_miss
        return self.n_used / needed if needed else 0.0

    def merge(self, other: "PrefetchMeter") -> None:
        for f in ("n_issued", "n_cancelled", "n_landed", "n_used", "n_late",
                  "n_uncovered_miss"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.expected_stall_saved_s += other.expected_stall_saved_s

    def summary(self) -> dict:
        return {
            "predictor": self.label,
            "issued": self.n_issued, "cancelled": self.n_cancelled,
            "landed": self.n_landed, "used_in_time": self.n_used,
            "late": self.n_late, "uncovered_miss": self.n_uncovered_miss,
            "precision": self.precision(), "recall": self.recall(),
            "expected_stall_saved_s": self.expected_stall_saved_s,
        }


# ---------------------------------------------------------------------------
# The bundle the engine threads through
# ---------------------------------------------------------------------------
class Telemetry:
    """Everything the serving stack records when telemetry is ON.

    ``trace=None`` keeps the metrics/calibration layers without the event
    log (cheapest on-mode); ``Telemetry.with_trace()`` builds the full
    flight-recorder configuration. An engine holding ``telemetry=None``
    (the default) runs the exact pre-telemetry code path."""

    def __init__(self, *, trace: Optional[FlightRecorder] = None,
                 predictor_label: str = "",
                 num_layers: int = 0, num_experts: int = 0,
                 ema_alpha: float = 0.05) -> None:
        self.trace = trace
        self.metrics = MetricsRegistry()
        self.calibration = CalibrationMeter()
        self.prefetch = PrefetchMeter(predictor_label)
        self.expert_stats = (ExpertStats(num_layers, num_experts, ema_alpha)
                             if num_layers and num_experts else None)

    @classmethod
    def with_trace(cls, **kw) -> "Telemetry":
        return cls(trace=FlightRecorder(), **kw)

    def summary(self) -> dict:
        out = {
            "metrics": self.metrics.snapshot(),
            "calibration": self.calibration.summary(),
            "prefetch": self.prefetch.summary(),
        }
        if self.expert_stats is not None:
            out["expert_stats"] = self.expert_stats.summary()
        if self.trace is not None:
            out["trace_events"] = len(self.trace)
        return out


__all__: List[str] = [
    "Counter", "Gauge", "Histogram", "EMA", "MetricsRegistry",
    "ExpertStats", "CalibrationMeter", "PrefetchMeter", "Telemetry",
]
