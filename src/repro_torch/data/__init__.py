"""The LM input pipeline (port of `repro.data`): the synthetic token
stream and the prefetching batcher.  This directory also holds the
committed references the card's checks read (`jax_reference.json`,
`lm_reference.json`, `train_reference.json`), found by path."""
from . import pipeline, synthetic

__all__ = ["pipeline", "synthetic"]
