"""Random weights made by the benchmark from ``--seed``, in the layout the
port's MoE transformer takes as ``params``: one leaf per call of
``normal_`` on a generator on the device, in the configuration's dtype.
Both the program and the reference read these tensors; neither makes
them.

Layout (L layers, E experts, D model width, F expert width, H / KV heads
of width hd, V vocabulary; S shared experts of width F each)::

    embed [V, D]; final_norm [D]; lm_head [D, V]
    groups[0]: ln1, ln2 [L, D]; attn wq [L, D, H*hd], wk / wv [L, D, KV*hd],
               wo [L, H*hd, D]; moe router [L, D, E], w1 / w3 [L, E, D, F],
               w2 [L, E, F, D], shared w1 / w3 [L, D, S*F], w2 [L, S*F, D]
"""
from __future__ import annotations

import torch

# norms are 1 + NORM_JITTER * N(0, 1): a program that skipped a norm's
# gain would not agree with the reference
NORM_JITTER = 0.1


def shapes(run_cfg: dict) -> dict:
    """{leaf path: (shape, scale)}; scale None marks a norm gain."""
    d, v = run_cfg["d_model"], run_cfg["vocab_size"]
    n_l, e, f = run_cfg["num_layers"], run_cfg["num_experts"], \
        run_cfg["expert_d_ff"]
    hd = run_cfg["head_dim"]
    q_w, kv_w = run_cfg["num_heads"] * hd, run_cfg["num_kv_heads"] * hd

    def dense(i, o):
        return (2.0 / (i + o)) ** 0.5

    out = {
        "embed": ((v, d), 0.02),
        "final_norm": ((d,), None),
        "lm_head": ((d, v), dense(d, v)),
        "groups.0.ln1": ((n_l, d), None),
        "groups.0.ln2": ((n_l, d), None),
        "groups.0.attn.wq": ((n_l, d, q_w), dense(d, q_w)),
        "groups.0.attn.wk": ((n_l, d, kv_w), dense(d, kv_w)),
        "groups.0.attn.wv": ((n_l, d, kv_w), dense(d, kv_w)),
        "groups.0.attn.wo": ((n_l, q_w, d), dense(q_w, d)),
        "groups.0.moe.router": ((n_l, d, e), dense(d, e)),
        # the scale of one [D, E*F] matrix, as the program's own init
        "groups.0.moe.w1": ((n_l, e, d, f), (2.0 / (d + e * f)) ** 0.5),
        "groups.0.moe.w3": ((n_l, e, d, f), (2.0 / (d + e * f)) ** 0.5),
        "groups.0.moe.w2": ((n_l, e, f, d), (2.0 / (d + e * f)) ** 0.5),
    }
    fs = f * run_cfg["num_shared_experts"]
    if fs:
        out.update({
            "groups.0.moe.shared.w1": ((n_l, d, fs), dense(d, fs)),
            "groups.0.moe.shared.w3": ((n_l, d, fs), dense(d, fs)),
            "groups.0.moe.shared.w2": ((n_l, fs, d), dense(fs, d)),
        })
    return out


def make(run_cfg: dict, seed: int, device) -> dict:
    """The params tree, every leaf drawn on ``device`` from one generator
    seeded with ``seed``."""
    if run_cfg["dtype"] != "float32":
        raise ValueError("the harness makes float32 weights only")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params: dict = {"groups": ({},)}
    for path, (shape, scale) in shapes(run_cfg).items():
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if scale is None:
            t.normal_(1.0, NORM_JITTER, generator=gen)
        else:
            t.normal_(0.0, scale, generator=gen)
        keys = path.split(".")
        node = params
        if keys[0] == "groups":
            node = params["groups"][int(keys[1])]
            keys = keys[2:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return params

