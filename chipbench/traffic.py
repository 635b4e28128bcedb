"""The one traffic generator: a mix is a JSON file of parameters under
``chipbench/traffic/``.

Sizes come in blocks of ``block`` requests. Every block holds the same
multiset of (prompt length, output length) pairs: ``block`` evenly spaced
quantiles of each distribution (uniform: from min to max, both taken;
lognormal: at (i + 0.5) / block), prompt quantile i paired with output
quantile ``pairing[i]``, each block in its own order; the pairing and the
orders are drawn from a fixed generator. ``--seed`` draws only the token
ids, so every seed serves the same sizes in the same order: which
requests the window holds does not change with the seed. Every request arrives at time
0; with ``slots`` decode rows the scheduler admits a request the step a
row frees, which is a closed loop of ``slots`` clients.

Distributions: ``{"dist": "uniform", "min": a, "max": b}`` (integers,
both ends included) and ``{"dist": "lognormal", "median": m, "sigma": s,
"min": a, "max": b}`` (rounded, clipped to [a, b]).
"""
from __future__ import annotations

import statistics

import numpy as np

PAIRING_SEED = 20240518


def quantile(spec: dict, i: int, n: int) -> int:
    """The i-th of n evenly spaced quantiles of ``spec``."""
    if spec["dist"] == "uniform":
        lo, hi = int(spec["min"]), int(spec["max"])
        return lo + int(round(i * (hi - lo) / max(1, n - 1)))
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist().inv_cdf((i + 0.5) / n)
        v = float(spec["median"]) * float(np.exp(float(spec["sigma"]) * z))
        return int(min(max(round(v), int(spec["min"])), int(spec["max"])))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def block_sizes(mix: dict) -> list:
    """The block's (prompt_len, output_len) pairs, in canonical order."""
    n = int(mix["block"])
    prompts = [quantile(mix["prompt_len"], i, n) for i in range(n)]
    outputs = [quantile(mix["output_len"], i, n) for i in range(n)]
    pairing = np.random.default_rng(PAIRING_SEED).permutation(n)
    return [(prompts[i], outputs[int(pairing[i])]) for i in range(n)]


def requests(mix: dict, seed: int, vocab_size: int) -> list:
    """[(prompt int64 array, max_new_tokens)] for ``mix["blocks"]``
    blocks, the token ids drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    order = np.random.default_rng(PAIRING_SEED + 1)
    base = block_sizes(mix)
    out = []
    for _ in range(int(mix["blocks"])):
        for j in order.permutation(len(base)):
            p_len, o_len = base[int(j)]
            out.append((rng.integers(0, vocab_size, size=p_len,
                                     dtype=np.int64), o_len))
    return out


def max_context(mix: dict) -> int:
    return max(p + o for p, o in block_sizes(mix))
