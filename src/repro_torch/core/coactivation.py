"""Offline profiling — expert activation and co-activation statistics (§3.2).

Per layer l we accumulate over a profiling corpus:
  A[i]    — activations: #tokens with i in S_l(x)                (Fig. 6)
  M[i,j]  — binary co-activations: #tokens with i,j in S_l(x)    (Figs. 7/9)
  W[i,j]  — probability-weighted co-activations:
            sum_x 1{i,j in S_l(x)} * min(p_i|x, p_j|x)           (§3.3 (i))

and derive the conditional co-activation distribution (Eq. 4):
  q_{j|i} = M[i,j] / sum_j' M[i,j'],  q_{i|i} = 0
with Laplace smoothing M <- M + eps (§3.3 (ii)) and optional warm-up
down-weighting (§3.3 (iii)).
"""
from __future__ import annotations

import numpy as np


class CoactivationRecorder:
    """Host-side accumulator (numpy). One instance per model; indexed by layer."""

    def __init__(self, num_layers: int, num_experts: int,
                 warmup_steps: int = 0, warmup_weight: float = 0.25):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.A = np.zeros((num_layers, num_experts), np.float64)
        self.M = np.zeros((num_layers, num_experts, num_experts), np.float64)
        self.W = np.zeros((num_layers, num_experts, num_experts), np.float64)
        self.steps = 0
        self.warmup_steps = warmup_steps
        self.warmup_weight = warmup_weight

    def update(self, layer: int, indices, probs=None) -> None:
        """indices: [T, K] int expert ids; probs: [T, K] renormalized top-k."""
        indices = np.asarray(indices).reshape(-1, np.asarray(indices).shape[-1])
        t_n, k_n = indices.shape
        w = self.warmup_weight if self.steps < self.warmup_steps else 1.0
        onehot = np.zeros((t_n, self.num_experts), np.float64)
        rows = np.repeat(np.arange(t_n), k_n)
        onehot[rows, indices.reshape(-1)] = 1.0
        self.A[layer] += w * onehot.sum(0)
        m = onehot.T @ onehot                     # [E, E]; diag = A increment
        np.fill_diagonal(m, 0.0)
        self.M[layer] += w * m
        if probs is not None:
            probs = np.asarray(probs, np.float64).reshape(t_n, k_n)
            pmat = np.zeros((t_n, self.num_experts), np.float64)
            pmat[rows, indices.reshape(-1)] = probs.reshape(-1)
            # min(p_i, p_j) outer for co-activated pairs, chunked over tokens
            for s in range(0, t_n, 2048):
                chunk = pmat[s:s + 2048]
                act = chunk > 0
                pm = np.minimum(chunk[:, :, None], chunk[:, None, :])
                pm *= (act[:, :, None] & act[:, None, :])
                self.W[layer] += w * pm.sum(0)
        np.fill_diagonal(self.W[layer], 0.0)

    def step_done(self) -> None:
        self.steps += 1

    def conditional(self, layer: int, eps: float = 1e-3,
                    weighted: bool = False) -> np.ndarray:
        """q_{j|i} (Eq. 4) with Laplace smoothing. Rows sum to 1, diag 0."""
        m = (self.W if weighted else self.M)[layer] + eps
        np.fill_diagonal(m, 0.0)
        denom = m.sum(axis=1, keepdims=True)
        return m / np.maximum(denom, 1e-30)

    # ------------------------------------------------------------------
    # Analysis helpers (Figs. 6/7/9 reproduction)
    # ------------------------------------------------------------------
    def activation_skew(self, layer: int) -> dict:
        a = np.sort(self.A[layer])[::-1]
        total = max(a.sum(), 1e-30)
        cum = np.cumsum(a) / total
        lorenz = np.cumsum(np.sort(self.A[layer])) / total
        gini = 1.0 - 2.0 * np.trapezoid(lorenz, dx=1.0 / len(a))
        return {
            "counts": self.A[layer].copy(),
            "top1_share": float(a[0] / total),
            "top8_share": float(cum[min(7, len(a) - 1)]),
            "gini": float(gini),
        }

    def topr_coverage(self, layer: int, r: int) -> np.ndarray:
        """Per-pivot fraction of co-activation mass covered by top-r peers
        (the §3.2 'top-r peers cover a large majority' claim)."""
        q = self.conditional(layer)
        qs = np.sort(q, axis=1)[:, ::-1]
        return qs[:, :r].sum(axis=1)

    def save(self, path: str) -> None:
        np.savez_compressed(path, A=self.A, M=self.M, W=self.W,
                            steps=self.steps)

    @classmethod
    def load(cls, path: str) -> "CoactivationRecorder":
        d = np.load(path)
        rec = cls(d["A"].shape[0], d["A"].shape[1])
        rec.A, rec.M, rec.W = d["A"], d["M"], d["W"]
        rec.steps = int(d["steps"])
        return rec
