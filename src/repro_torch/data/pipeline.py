"""Deterministic synthetic token pipeline (per-host sharded).

Every (step, host_shard) pair maps to the same tokens regardless of how
many hosts participate — the property that makes elastic re-sharding and
restart-after-failure exactly reproducible: a restarted job resumes the
stream at the same step with the same global batch.

Tokens follow a Zipf-like marginal with a deterministic mixing hash
(SplitMix64) so losses are stable across runs but not degenerate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticTokens", "make_batch_iterator"]

_MASK = (1 << 64) - 1


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int, shard: int = 0,
                 n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, shard-of-n)."""
        assert self.global_batch % n_shards == 0
        local = self.global_batch // n_shards
        rows = np.arange(local, dtype=np.uint64) + shard * local
        cols = np.arange(self.seq_len, dtype=np.uint64)
        base = (np.uint64(self.seed) * np.uint64(0x100000001B3)
                + np.uint64(step) * np.uint64(0x1000193)) & np.uint64(_MASK)
        grid = (rows[:, None] * np.uint64(self.seq_len * 2 + 1)
                + cols[None, :] + base) & np.uint64(_MASK)
        h = _splitmix64(grid)
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        # Zipf-ish: token = floor(V * u^a) has heavier mass on low ids
        tok = np.minimum((self.vocab * np.power(u, self.zipf_a)),
                         self.vocab - 1).astype(np.int32)
        return {"tokens": tok}


def make_batch_iterator(spec: SyntheticTokens, start_step: int = 0,
                        shard: int = 0, n_shards: int = 1
                        ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield spec.batch_at(step, shard, n_shards)
        step += 1
