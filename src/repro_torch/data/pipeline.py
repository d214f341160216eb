"""Deterministic, resumable, host-sharded synthetic token pipeline (a copy of
``repro.data.pipeline``: numpy only, so both packages draw the same batches;
the trainer moves them to its device).

Every batch is a pure function of (seed, step, host_id) — there is no iterator
state to checkpoint beyond the step counter, which makes restart and *elastic
re-sharding* (resuming the same run on a different data-parallel size) exact: the
global batch for step N is identical no matter how many hosts produce slices of it.

Tokens follow a fixed random bigram chain over the vocab (plus noise), so a model
can actually learn next-token structure and the training-loss curve in the examples
means something.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.25            # probability a token ignores the bigram chain

    def _chain(self) -> np.ndarray:
        """The fixed bigram successor table (one per pipeline identity)."""
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        return rng.integers(0, self.vocab_size, self.vocab_size, dtype=np.int64)

    def global_batch_at(self, step: int) -> np.ndarray:
        """[global_batch, seq_len + 1] int32 — inputs and shifted labels."""
        chain = self._chain()
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.global_batch, self.seq_len
        toks = np.empty((B, S + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, B)
        noise_mask = rng.random((B, S)) < self.noise
        noise_toks = rng.integers(0, self.vocab_size, (B, S))
        for t in range(S):
            nxt = chain[toks[:, t]]
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_toks[:, t], nxt)
        return toks.astype(np.int32)

    def host_batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> np.ndarray:
        """This host's contiguous slice of the global batch (elastic-safe)."""
        assert self.global_batch % n_hosts == 0, (self.global_batch, n_hosts)
        per = self.global_batch // n_hosts
        return self.global_batch_at(step)[host_id * per:(host_id + 1) * per]

    def batch_dict(self, step: int, host_id: int = 0, n_hosts: int = 1) -> Dict:
        return {"tokens": self.host_batch_at(step, host_id, n_hosts)}
