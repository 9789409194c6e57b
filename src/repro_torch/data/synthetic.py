"""Deterministic synthetic data (a copy of `repro.data.synthetic`, numpy
only, so the two packages draw the same batches): a counter-based token
stream (same
construction idea as the SNN connectivity — any worker can materialize any
batch index without coordination, which is what makes the input pipeline
trivially elastic/restartable).

The stream is a Zipf-ish unigram mixture with short-range Markov structure,
so cross-entropy has learnable signal (quickstart trains visibly below the
unigram entropy) while requiring no external data."""
from __future__ import annotations

import numpy as np


def batch_tokens(seed: int, batch_index: int, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    """[batch, seq+1] int32; column t+1 is the label for column t."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, batch_index]))
    # Zipf unigram over a small active vocab (keeps tiny smokes learnable)
    active = min(vocab, 4096)
    ranks = np.arange(1, active + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(active, size=(batch, seq + 1), p=probs)
    # Markov bigram structure: with p=0.5, next token = f(prev)
    follow = (np.arange(active) * 31 + 7) % active
    mask = rng.random((batch, seq)) < 0.5
    for t in range(seq):
        nxt = follow[toks[:, t]]
        toks[:, t + 1] = np.where(mask[:, t], nxt, toks[:, t + 1])
    return toks.astype(np.int32)


def batch_embeds(seed: int, batch_index: int, batch: int, seq: int,
                 d_model: int) -> np.ndarray:
    """Frontend-stub embeddings for vlm/audio modalities ([B, T, d])."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, batch_index,
                                                        7]))
    return rng.standard_normal((batch, seq, d_model), dtype=np.float32)
