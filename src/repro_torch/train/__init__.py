"""LM training (port of `repro.train`): the train state and its files,
the train step, and the fault-tolerant loop."""
from . import step, train_state, trainer

__all__ = ["step", "trainer", "train_state"]
