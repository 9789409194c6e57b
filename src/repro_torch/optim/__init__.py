"""The LM optimizer (port of `repro.optim`): AdamW with the JAX package's
formula, global-norm clipping and bf16 gradient compression with error
feedback, and the learning-rate schedules."""
from . import adamw, grad_utils, schedules

__all__ = ["adamw", "grad_utils", "schedules"]
