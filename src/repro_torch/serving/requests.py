"""Request / batch plumbing for the serving example (counterpart of
``repro/serving/requests.py``).

StaticBatcher is the paper's llama.cpp-style harness: fixed-size batches, a
global barrier between them. The continuous-batching scheduler that replaces
it under live traffic lives in ``repro_torch.serving.scheduler``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, List

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [P] int tokens
    max_new_tokens: int = 32
    output: np.ndarray = None   # filled by the scheduler


class StaticBatcher:
    """Pads a stream of requests into fixed-size batches (static batching —
    what the paper's llama.cpp harness does). Prompts are left-padded to a
    common length with token 0.

    Pad rows (rid=-1 copies of the first request, needed to keep the
    step shape fixed) are flagged False in the yielded row mask so the engine
    excludes them from throughput, transfer, and NLL accounting."""

    def __init__(self, batch_size: int, pad_id: int = 0):
        self.batch_size = batch_size
        self.pad_id = pad_id

    def batches(self, requests: Iterable[Request]):
        """Yields (chunk, token matrix [B, P], row mask [B])."""
        it = iter(requests)
        while True:
            chunk: List[Request] = list(itertools.islice(it, self.batch_size))
            if not chunk:
                return
            while len(chunk) < self.batch_size:   # pad with a copy
                chunk.append(Request(rid=-1, prompt=chunk[0].prompt.copy(),
                                     max_new_tokens=chunk[0].max_new_tokens))
            plen = max(len(r.prompt) for r in chunk)
            mat = np.full((len(chunk), plen), self.pad_id, np.int64)
            for i, r in enumerate(chunk):
                mat[i, plen - len(r.prompt):] = r.prompt
            mask = np.array([r.rid >= 0 for r in chunk], bool)
            yield chunk, mat, mask
