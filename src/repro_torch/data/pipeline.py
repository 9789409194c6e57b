"""Prefetching input pipeline (port of `repro.data.pipeline`).

Batches are produced host-side (numpy, deterministic per batch index, the
JAX package's own stream), copied to the Batcher's device, and prefetched
on a background thread so that host generation overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from . import synthetic


class Batcher:
    """Yields {'tokens', 'labels'} int32 [batch, seq] (the labels the
    tokens shifted by one), with 'embeds' fp32 [batch, seq, d] for the VLM
    modality and 'enc_embeds' fp32 [batch, max(seq // 2, 8), d] for the
    enc-dec family, on `device` (None: the card)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, start_index: int = 0, device=None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed = seed
        self.index = start_index           # restart-safe: index is state
        self.device = resolve_device(device)

    def make(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        toks = synthetic.batch_tokens(self.seed, index, self.batch,
                                      self.seq, cfg.vocab_size)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.modality in ("vlm",):
            b["embeds"] = synthetic.batch_embeds(self.seed, index,
                                                 self.batch, self.seq,
                                                 cfg.d_model)
        if cfg.family == "encdec":
            b["enc_embeds"] = synthetic.batch_embeds(
                self.seed, index, self.batch, max(self.seq // 2, 8),
                cfg.d_model)
        return b

    def put(self, b: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                for k, x in b.items()}

    def __iter__(self) -> Iterator:
        while True:
            b = self.put(self.make(self.index))
            self.index += 1
            yield b


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for x in it:
                q.put(x)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        x = q.get()
        if x is stop:
            return
        yield x
