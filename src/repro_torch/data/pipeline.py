"""Deterministic, shardable synthetic LM data (numpy only).

The corpus is a Zipf-Markov process: every token has ``branching``
successors with Zipfian weights derived from a hashed seed — low entropy
(learnable by a small teacher) but non-trivial. ``batch_at(step)`` depends
only on (seed, step, shard), so a restarted run resumes bit for bit and each
data-parallel shard draws a disjoint stream. The port keeps its own copy of
the JAX package's generator; both seed Philox from ``hash`` of a tuple of
ints, which Python computes the same in every process, so the two give the
same tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng(*keys: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=np.uint64(
        hash(tuple(keys)) & 0xFFFFFFFFFFFFFFFF)))


@dataclasses.dataclass
class ZipfMarkov:
    vocab: int
    branching: int = 16
    alpha: float = 1.2
    seed: int = 0

    def __post_init__(self):
        g = _rng(self.seed, 0xC0FFEE)
        self.succ = g.integers(0, self.vocab, (self.vocab, self.branching),
                               dtype=np.int32)
        w = np.arange(1, self.branching + 1, dtype=np.float64) ** -self.alpha
        self.probs = w / w.sum()

    def sample(self, n: int, length: int, stream_seed: int) -> np.ndarray:
        g = _rng(self.seed, stream_seed)
        out = np.empty((n, length), np.int32)
        tok = g.integers(0, self.vocab, n, dtype=np.int32)
        for t in range(length):
            out[:, t] = tok
            choice = g.choice(self.branching, size=n, p=self.probs)
            tok = self.succ[tok, choice]
        return out


@dataclasses.dataclass
class LMDataPipeline:
    """Sharded LM token pipeline with explicit, checkpointable state.
    ``chain_seed`` fixes the language (the transition table); ``seed`` only
    offsets the sample streams."""
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard: int = 0
    seed: int = 0
    step: int = 0
    chain_seed: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_shards == 0
        self.chain = ZipfMarkov(self.vocab, seed=self.chain_seed)
        self.local_batch = self.global_batch // self.n_shards

    def batch_at(self, step: int) -> np.ndarray:
        return self.chain.sample(
            self.local_batch, self.seq_len,
            stream_seed=(self.seed << 24)
            + (step * self.n_shards + self.shard) + 1)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed, "shard": self.shard}

    def restore(self, state: dict):
        assert state["seed"] == self.seed and state["shard"] == self.shard, \
            "pipeline identity mismatch on restore"
        self.step = int(state["step"])
