"""The serving state the reference works out again, frozen here from the
port's launcher and runtime as they stood when the benchmark was defined:
the profiling token stream (a first-order Markov language of seed 0), the
co-activation counts of the router's top-k over it, the buddy lists by
the cumulative frequency threshold (the residency of every step is
``residency``'s). None of it imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

# the launcher's offline profiling: 4 batches of 4 x 64 tokens, buddy
# lists cut at 8 entries
PROFILE_STEPS, PROFILE_BATCH, PROFILE_SEQ, PROFILE_K_MAX = 4, 4, 64, 8
# the model's row-local capacity in a full-sequence forward
FULL_CAPACITY_FACTOR = 1.25


class MarkovTokens:
    """Block-structured first-order Markov token stream."""

    def __init__(self, vocab_size: int, num_blocks: int = 8,
                 peak: float = 0.85, switch_p: float = 0.03, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab_size = vocab_size
        self.num_blocks = num_blocks
        self.block_size = vocab_size // num_blocks
        self.switch_p = switch_p
        self.succ = rng.integers(0, self.block_size,
                                 size=(vocab_size, 8)).astype(np.int64)
        self.peak = peak
        self.rng = rng

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        rng = self.rng
        out = np.empty((batch, seq_len), np.int64)
        tok = rng.integers(0, self.vocab_size, size=batch)
        for t in range(seq_len):
            out[:, t] = tok
            blk = np.minimum(tok // self.block_size, self.num_blocks - 1)
            switch = rng.random(batch) < self.switch_p
            blk = np.where(switch,
                           rng.integers(0, self.num_blocks, size=batch), blk)
            peaked = rng.random(batch) < self.peak
            nxt_in = self.succ[tok, rng.integers(0, 8, size=batch)]
            nxt_rand = rng.integers(0, self.block_size, size=batch)
            nxt = np.where(peaked, nxt_in, nxt_rand)
            tok = np.minimum(blk * self.block_size + (nxt % self.block_size),
                             self.vocab_size - 1)
        return out


def full_capacity(s_n: int, k_n: int, e_n: int) -> int:
    cap = int(max(k_n, s_n * k_n / e_n * FULL_CAPACITY_FACTOR))
    return min(s_n * k_n, -(-cap // 8) * 8)


def cft_size(row: np.ndarray, alpha: float) -> int:
    order = np.argsort(-row, kind="stable")
    cum = np.cumsum(row[order])
    t = int(np.searchsorted(cum, alpha - 1e-12) + 1)
    return max(1, min(t, len(row)))


def buddy_lists(topk_by_layer: np.ndarray, e_n: int, alpha: float,
                k_max: int = PROFILE_K_MAX):
    """topk_by_layer [L, T, K] expert ids -> (table [L, E, k_max] int32
    with -1 padding, q [L, E, k_max] f32): co-activation counts M (diag
    0), q_{j|i} = (M + 1e-3) / row sum with q_{i|i} = 0, each pivot's
    peers by descending q (stable) cut at the cumulative alpha, pivots
    never activated left empty."""
    l_n = topk_by_layer.shape[0]
    table = np.full((l_n, e_n, k_max), -1, np.int32)
    qv = np.zeros((l_n, e_n, k_max), np.float32)
    for l in range(l_n):
        idx = topk_by_layer[l].reshape(-1, topk_by_layer.shape[-1])
        onehot = np.zeros((idx.shape[0], e_n), np.float64)
        onehot[np.repeat(np.arange(idx.shape[0]), idx.shape[1]),
               idx.reshape(-1)] = 1.0
        act = onehot.sum(0)
        m = onehot.T @ onehot
        np.fill_diagonal(m, 0.0)
        m = m + 1e-3
        np.fill_diagonal(m, 0.0)
        q = m / np.maximum(m.sum(axis=1, keepdims=True), 1e-30)
        for i in range(e_n):
            row = q[i].copy()
            row[i] = 0.0
            if act[i] <= 0 or row.sum() <= 0:
                continue
            t = min(cft_size(row, alpha), k_max)
            order = np.argsort(-row, kind="stable")[:t]
            table[l, i, :t] = order
            qv[l, i, :t] = row[order]
    return table, qv


def profile_tables(ref, rc: dict, alpha: float, device, follow=None):
    """The buddy tables from the reference's own profiling forwards over
    the seed-0 Markov stream: the router's top-k of every layer, with the
    full forward's row-local capacity. ``follow``: the subject's top-k of
    each profiling forward ([L, B * S, K] each), which the reference
    continues with and counts where its own differs. Returns (table, q,
    the top-k the tables were built from, one [L, B * S, K] a forward,
    the (layer, token) sets that differ, the sets compared)."""
    lm = MarkovTokens(rc["vocab_size"], seed=0)
    k_n, e_n = rc["top_k"], rc["num_experts"]
    cap = full_capacity(PROFILE_SEQ, k_n, e_n)
    pos = torch.arange(PROFILE_SEQ, device=device)
    seqs = [(b * PROFILE_SEQ, pos) for b in range(PROFILE_BATCH)]
    used, flips, sets = [], 0, 0
    for s in range(PROFILE_STEPS):
        toks = torch.as_tensor(lm.sample(PROFILE_BATCH, PROFILE_SEQ)
                               .reshape(-1), device=device)
        fol = None if follow is None else follow[s].to(device).long()
        _, own = ref.forward(toks, seqs, None, head_at=torch.zeros(
            1, dtype=torch.int64, device=device),
            capacity=(PROFILE_BATCH, cap), follow=fol)
        if fol is not None:
            flips += int((own.sort(-1).values != fol.sort(-1).values)
                         .any(-1).sum())
            sets += own.shape[0] * own.shape[1]
            own = fol
        used.append(own.cpu())
    topk_all = np.concatenate([u.numpy() for u in used], axis=1)
    table, q = buddy_lists(topk_all, e_n, alpha)
    return table, q, used, flips, sets
