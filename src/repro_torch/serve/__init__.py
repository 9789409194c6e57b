"""Batched serving of the port's LM (port of `repro.serve`)."""
from . import engine, sampling

__all__ = ["engine", "sampling"]
