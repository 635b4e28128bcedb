"""The benchmark's arithmetic: the card's peaks, the operations and bytes a
token or a kernel call needs (from the configuration's shapes alone), and
the statistics the metrics use. It reads nothing of the program."""
from __future__ import annotations

import numpy as np

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit
PEAKS = {
    "H100": {"f32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}
F32_BYTES = 4


def peaks(device_name: str) -> dict:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise ValueError(f"no peak table for {device_name!r}")


def layer_flops(rc: dict, ctx: int) -> float:
    """One token through one layer at context ``ctx`` (keys it attends
    to, itself included): projections, scores and values, router, its
    top-k experts and the shared experts; multiply-adds count 2."""
    d, hd = rc["d_model"], rc["head_dim"]
    h, kv = rc["num_heads"], rc["num_kv_heads"]
    window = rc.get("sliding_window") or 0
    keys = min(ctx, window) if window else ctx
    proj = 2 * d * (h * hd + 2 * kv * hd) + 2 * h * hd * d
    attend = 4 * h * hd * keys
    router = 2 * d * rc["num_experts"]
    experts = (rc["top_k"] + rc["num_shared_experts"]) * 6 * d \
        * rc["expert_d_ff"]
    return float(proj + attend + router + experts)


def head_flops(rc: dict) -> float:
    return float(2 * rc["d_model"] * rc["vocab_size"])


def token_flops(rc: dict, ctx: int, head: bool) -> float:
    return rc["num_layers"] * layer_flops(rc, ctx) \
        + (head_flops(rc) if head else 0.0)


def ffn_call_need(rc: dict, rows: int, live: int) -> tuple:
    """(flops, bytes) an expert FFN call needs: ``rows`` routed slots
    (filled rows only) through ``live`` experts; every live expert's
    three matrices read once, every row read and written once."""
    d, f = rc["d_model"], rc["expert_d_ff"]
    flops = 6.0 * d * f * rows
    nbytes = F32_BYTES * (3.0 * d * f * live + 2.0 * d * rows)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, pk: dict) -> float:
    return max(flops / pk["f32_flops"], nbytes / pk["hbm_bytes_s"])


def p95(xs) -> float:
    """95th percentile, numpy's linear interpolation."""
    return float(np.percentile(np.asarray(xs, np.float64), 95))
