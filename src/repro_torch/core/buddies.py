"""Buddy list construction via the Cumulative Frequency Threshold (§3.3).

Given q_{j|i} (Eq. 4), sort peers descending and keep the minimal prefix
whose cumulative mass >= alpha (Eqs. 5-6), capped at K_max, with
t_i(alpha) >= 1 for any active pivot. Supports per-layer alpha schedules
(layer-wise heterogeneity, §3.2).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np


class BuddyTables(NamedTuple):
    """Padded per-layer buddy profiles (the runtime lookup structure).

    table: [L, E, R_max] int32, rank-ordered buddy ids, -1 padding.
    q:     [L, E, R_max] float32, q_{j|i} for each entry (0 on padding).
    sizes: [L, E] int32, t_i(alpha) per pivot.
    """
    table: np.ndarray
    q: np.ndarray
    sizes: np.ndarray


def cft_prefix_size(q_row: np.ndarray, alpha: float) -> int:
    """t_i(alpha) = min{t | sum_{r<=t} q_{pi_i(r)|i} >= alpha} (Eq. 5)."""
    order = np.argsort(-q_row, kind="stable")
    cum = np.cumsum(q_row[order])
    t = int(np.searchsorted(cum, alpha - 1e-12) + 1)
    return max(1, min(t, len(q_row)))


def build_buddy_lists(q: np.ndarray, alpha: Union[float, Sequence[float]],
                      k_max: int = 16,
                      activity: Optional[np.ndarray] = None,
                      output_sim: Optional[np.ndarray] = None,
                      sim_gamma: float = 2.0) -> BuddyTables:
    """q: [L, E, E] conditional co-activation (rows ~sum to 1, diag 0).

    alpha: scalar or per-layer schedule. activity: [L, E] activation counts —
    pivots with zero activity get an empty (all -1) list.

    output_sim: optional [L, E, E] expert output-similarity matrices
    (core/similarity.py). The paper identifies buddies by co-activation AND
    output similarity (§1); when given, the ranking score becomes
    q_{j|i} * ((1+sim_ij)/2)^sim_gamma, renormalized per pivot before CFT.
    Returns padded BuddyTables with R_max = k_max.
    """
    l_n, e_n, _ = q.shape
    if output_sim is not None:
        w = ((1.0 + np.clip(output_sim, -1.0, 1.0)) / 2.0) ** sim_gamma
        q = q * w
        np.einsum("lii->li", q)[:] = 0.0
        q = q / np.maximum(q.sum(axis=2, keepdims=True), 1e-30)
    alphas = np.full(l_n, alpha, np.float64) if np.isscalar(alpha) \
        else np.asarray(alpha, np.float64)
    assert alphas.shape == (l_n,)

    table = np.full((l_n, e_n, k_max), -1, np.int32)
    qv = np.zeros((l_n, e_n, k_max), np.float32)
    sizes = np.zeros((l_n, e_n), np.int32)
    for l in range(l_n):
        for i in range(e_n):
            row = q[l, i].copy()
            row[i] = 0.0
            if activity is not None and activity[l, i] <= 0:
                continue
            if row.sum() <= 0:
                continue
            t = min(cft_prefix_size(row, alphas[l]), k_max)
            order = np.argsort(-row, kind="stable")[:t]
            table[l, i, :t] = order
            qv[l, i, :t] = row[order]
            sizes[l, i] = t
    return BuddyTables(table, qv, sizes)


def alpha_schedule(num_layers: int, early: float = 0.95,
                   late: float = 0.80) -> np.ndarray:
    """Monotone per-layer alpha: early layers tolerate broader substitution
    (higher coverage alpha), later specialized layers get tighter lists."""
    return np.linspace(early, late, num_layers)


def list_size_stats(tables: BuddyTables) -> dict:
    s = tables.sizes.astype(np.float64)
    return {"mean": float(s.mean()), "p50": float(np.percentile(s, 50)),
            "p90": float(np.percentile(s, 90)), "max": int(s.max())}


def save_tables(path: str, tables: BuddyTables) -> None:
    np.savez_compressed(path, table=tables.table, q=tables.q,
                        sizes=tables.sizes)


def load_tables(path: str) -> BuddyTables:
    d = np.load(path)
    return BuddyTables(d["table"], d["q"], d["sizes"])
