"""Synthetic token pipeline for the LM architectures (a copy of
``repro/data/tokens.py``, numpy only: the streams are the reference's
for the same generator).

Clients get *archetype-conditioned Markov streams*: each archetype a has
a fixed random successor table ``perm_a`` over the vocabulary; the next
token is ``perm_a[current]`` with probability ``bias`` else uniform.
This is (a) genuinely learnable — a bigram model reaches accuracy ≈ bias
— and (b) conflicting across archetypes (different permutations pull the
shared weights in different directions), which is precisely the non-IID
regime FedCD targets (paper §3.2's next-word-prediction example).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Iterator, Tuple

import numpy as np


@lru_cache(maxsize=64)
def successor_table(vocab: int, archetype: int) -> np.ndarray:
    return np.random.default_rng(10_000 + archetype).permutation(vocab)


def archetype_token_batch(rng: np.random.Generator, archetype: int,
                          n_archetypes: int, batch: int, seq: int,
                          vocab: int, bias: float = 0.8) -> np.ndarray:
    """Markov stream: next = perm_a[cur] w.p. ``bias`` else uniform."""
    perm = successor_table(vocab, archetype)
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    for t in range(1, seq):
        follow = perm[toks[:, t - 1]]
        rand = rng.integers(0, vocab, batch)
        use = rng.random(batch) < bias
        toks[:, t] = np.where(use, follow, rand)
    return toks.astype(np.int32)


def lm_batch(rng: np.random.Generator, n_clients: int, per_client: int,
             seq: int, vocab: int, n_archetypes: int = 2,
             bias: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """Global batch grouped by client: rows [c*per_client:(c+1)*per_client]
    belong to client c, whose archetype is c % n_archetypes."""
    toks = np.concatenate([
        archetype_token_batch(rng, c % n_archetypes, n_archetypes,
                              per_client, seq + 1, vocab, bias)
        for c in range(n_clients)
    ])
    return toks[:, :-1], toks[:, 1:]


def token_stream(seed: int, n_clients: int, per_client: int, seq: int,
                 vocab: int, n_archetypes: int = 2) -> Iterator:
    rng = np.random.default_rng(seed)
    while True:
        yield lm_batch(rng, n_clients, per_client, seq, vocab, n_archetypes)
