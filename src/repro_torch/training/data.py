"""Synthetic LM data pipeline.

A first-order Markov language with block structure: the vocabulary is split
into topical blocks; within a block transitions are peaked, with occasional
block switches. This gives (a) learnable structure so training loss falls and
(b) *specializable* token sub-manifolds so MoE routers develop the uneven
activation / co-activation patterns the paper exploits (Figs. 6/7/9).
"""
from __future__ import annotations

import numpy as np


class MarkovLM:
    def __init__(self, vocab_size: int, num_blocks: int = 8,
                 peak: float = 0.85, switch_p: float = 0.03, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab_size = vocab_size
        self.num_blocks = num_blocks
        self.block_size = vocab_size // num_blocks
        self.switch_p = switch_p
        # per-block sparse transition: each token has ~8 likely successors
        self.succ = rng.integers(0, self.block_size,
                                 size=(vocab_size, 8)).astype(np.int64)
        self.peak = peak
        self._rng = rng

    def _block_of(self, tok):
        return np.minimum(tok // self.block_size, self.num_blocks - 1)

    def sample(self, batch: int, seq_len: int, rng=None) -> np.ndarray:
        rng = rng or self._rng
        out = np.empty((batch, seq_len), np.int64)
        tok = rng.integers(0, self.vocab_size, size=batch)
        for t in range(seq_len):
            out[:, t] = tok
            blk = self._block_of(tok)
            switch = rng.random(batch) < self.switch_p
            blk = np.where(switch,
                           rng.integers(0, self.num_blocks, size=batch), blk)
            peaked = rng.random(batch) < self.peak
            nxt_in = self.succ[tok, rng.integers(0, 8, size=batch)]
            nxt_rand = rng.integers(0, self.block_size, size=batch)
            nxt = np.where(peaked, nxt_in, nxt_rand)
            tok = blk * self.block_size + (nxt % self.block_size)
            tok = np.minimum(tok, self.vocab_size - 1)
        return out

    def batches(self, batch: int, seq_len: int, steps: int, seed: int = 1):
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            yield self.sample(batch, seq_len + 1, rng)


def split_inputs_targets(tokens: np.ndarray):
    return tokens[:, :-1], tokens[:, 1:]
