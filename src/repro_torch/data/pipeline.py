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


def procedural_images(n: int, n_patches: int, dim: int, seed: int,
                      n_classes: int = 10, class_id: int | None = None):
    """Procedural patch embeddings (n, n_patches, dim) f32 and their class
    labels (n,), the JAX package's generator bit for bit. Each class has a
    fixed low-rank structure plus noise, standing in for the image subsets
    of paper §5.2; a class-independent per-patch informativeness profile
    scales the signal (natural-image categories share saliency statistics,
    the premise of the paper's cross-class router agreement)."""
    g = _rng(seed, 0x1A4E)
    gp = _rng(0xBEEF)  # fixed across seeds and classes
    basis = gp.normal(size=(n_classes, 4, n_patches, dim)).astype(np.float32)
    profile = (0.15 + 1.85 * gp.random(n_patches)).astype(np.float32)
    labels = (np.full(n, class_id, np.int32) if class_id is not None
              else g.integers(0, n_classes, n, dtype=np.int32))
    coef = g.normal(size=(n, 4, 1, 1)).astype(np.float32)
    emb = (basis[labels] * coef).sum(1) / 2.0
    emb *= profile[None, :, None]
    emb += 0.35 * g.normal(size=emb.shape).astype(np.float32)
    return emb, labels
