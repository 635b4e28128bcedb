"""The benchmark's arithmetic: the card's peaks, the operations and bytes a
token (from the family's count of each layer, ``chipbench/families/``) or
an expert FFN call needs (from the configuration's shapes alone), and the
statistics the metrics use. It reads nothing of the program."""
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


def head_flops(rc: dict) -> float:
    return float(2 * rc["d_model"] * rc["vocab_size"])


def token_flops(family, rc: dict, ctx: int, head: bool) -> float:
    """One token at context ``ctx`` through every layer, by the family's
    count of each (``family.layer_flops``), and the head where asked."""
    return sum(family.layer_flops(rc, ctx, layer)
               for layer in range(rc["num_layers"])) \
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
