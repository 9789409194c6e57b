"""Batched serving engine: continuous batching with per-slot refill (port
of `repro.serve.engine`).

Requests (prompts) are packed into a fixed batch of decode slots; a
finished slot is refilled from the queue immediately and individually:
the new prompt, left-padded with token 0 to the longest prompt of the
run, prefills through a fresh B=1 sub-cache (`lm.decode_step`), which is
then written into just that slot's cache rows and position.  The other
slots' caches, positions and greedy sampling are untouched, so a live
request's output does not depend on refill traffic.  Per-slot positions
live in cache['pos'] ([B] int64, `lm.init_cache(per_slot=True)`);
request and output bookkeeping stays on the host.

The caches are updated in place: the slot write-back copies into the
batch cache, and each attention layer writes its ring buffer in place.

The cache's 'enc_out' is always None, as in the JAX package's engine,
which takes no encoder input: an enc-dec model's cross-attention layers
(`seamless-m4t-medium`) then attend over their own normed states with
the cross weights, rotated, not causal and uncached, so that at a decode
step each token attends only to itself.  The engine reproduces this; a
caller with encoder input drives `lm.prefill` and `lm.decode_step`
itself.

`stats` counts the last `run`'s admissions (slot prefills), decode steps
and prompt tokens, and the host-clock seconds each part took; every
admission and decode step ends by reading its sampled tokens on the host,
which waits for the device, so the clocks include the device work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from ..models import lm
from . import sampling


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [T] int
    max_new: int = 16
    out: Optional[np.ndarray] = None


def _write_slot(full, one, b: int) -> None:
    """Copy a B=1 cache tree into row b of a batch cache tree, in place."""
    if isinstance(full, dict):
        for k in full:
            _write_slot(full[k], one[k], b)
    elif isinstance(full, (tuple, list)):
        for f, o in zip(full, one):
            _write_slot(f, o, b)
    else:
        full[b:b + 1].copy_(one)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: lm.LM, batch: int,
                 s_max: int, greedy: bool = True, seed: int = 0,
                 device=None):
        """`device` (None: the card) must be where `params` live."""
        dev = resolve_device(device)
        if params.embed.device.type != dev.type or dev.index not in (
                None, params.embed.device.index):
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine on {dev}")
        self.device = params.embed.device
        self.cfg, self.params = cfg, params
        self.batch, self.s_max = batch, s_max
        self.cache = lm.init_cache(cfg, batch, s_max, per_slot=True,
                                   device=self.device)
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = {}

    def prefill_slot(self, cache, tokens: torch.Tensor, b: int):
        """Prefill slot b alone: a fresh B=1 sub-cache at position 0, written
        back into row b of `cache` (in place).  Returns (logits [V],
        cache)."""
        sub = lm.init_cache(self.cfg, 1, self.s_max, device=self.device)
        logits, sub = lm.decode_step(self.cfg, self.params, sub, tokens)
        _write_slot(cache["layers"], sub["layers"], b)
        cache["pos"][b] = sub["pos"]
        return logits[0, -1], cache

    def decode(self, cache, tok: torch.Tensor):
        logits, cache = lm.decode_step(self.cfg, self.params, cache, tok)
        return logits[:, 0], cache

    @torch.no_grad()
    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests, refilling finished slots one at a time."""
        self.stats = dict(admissions=0, decode_steps=0, prompt_tokens=0,
                          prefill_s=0.0, decode_s=0.0)
        if not requests:
            return []
        B = self.batch
        queue = list(requests)
        t_pad = max(r.prompt.shape[0] for r in requests)
        self.cache = lm.init_cache(self.cfg, B, self.s_max, per_slot=True,
                                   device=self.device)
        live: List[Optional[Request]] = [None] * B
        gen: List[List[int]] = [[] for _ in range(B)]
        cur = np.zeros((B, 1), np.int64)
        while True:
            changed = True
            while changed:               # admit + retire until stable
                changed = False
                for b in range(B):
                    if live[b] is None and queue:
                        live[b] = queue.pop(0)
                        gen[b] = [self._admit(b, live[b], t_pad)]
                        cur[b, 0] = gen[b][0]
                        changed = True
                    r = live[b]
                    if r is not None and len(gen[b]) >= r.max_new:
                        r.out = np.asarray(gen[b][:r.max_new], np.int32)
                        live[b] = None
                        changed = True
            if not any(r is not None for r in live):
                break
            t0 = time.perf_counter()
            logits, self.cache = self.decode(
                self.cache, torch.from_numpy(cur).to(self.device))
            tok = self._sample(logits).tolist()
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
            for b in range(B):
                if live[b] is not None:
                    gen[b].append(int(tok[b]))
                    cur[b, 0] = int(tok[b])
        return requests

    def _admit(self, b: int, req: Request, t_pad: int) -> int:
        """Prefill only slot b with the request's (left-padded) prompt;
        returns the first sampled token."""
        t0 = time.perf_counter()
        toks = np.zeros((1, t_pad), np.int64)
        toks[0, t_pad - req.prompt.shape[0]:] = req.prompt
        logit, self.cache = self.prefill_slot(
            self.cache, torch.from_numpy(toks).to(self.device), b)
        tok = int(self._sample(logit[None])[0])
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["admissions"] += 1
        self.stats["prompt_tokens"] += t_pad
        return tok

    def _sample(self, logits):
        if self.greedy:
            return sampling.greedy(logits)
        return sampling.temperature(self.generator, logits)


@torch.no_grad()
def teacher_forced_logits(cfg: ModelConfig, params: lm.LM, prompt, tokens,
                          t_pad: int, s_max: int) -> torch.Tensor:
    """The logits the serving path computes for `prompt` followed by
    `tokens`, each step fed the given token instead of the sampled one:
    the slot prefill's (the prompt left-padded with 0 to `t_pad`, through a
    B=1 cache from position 0), then one decode step per token.  Returns
    [len(tokens) + 1, V] fp32 on the CPU."""
    dev = params.embed.device
    cache = lm.init_cache(cfg, 1, s_max, device=dev)
    toks = np.zeros((1, t_pad), np.int64)
    toks[0, t_pad - len(prompt):] = prompt
    logits, cache = lm.decode_step(cfg, params, cache,
                                   torch.from_numpy(toks).to(dev))
    rows = [logits[0, -1]]
    for tok in tokens:
        step = torch.tensor([[int(tok)]], dtype=torch.int64, device=dev)
        logits, cache = lm.decode_step(cfg, params, cache, step)
        rows.append(logits[0, 0])
    return torch.stack(rows).to(torch.float32).cpu()


@torch.no_grad()
def lockstep_teacher_forced_logits(cfg: ModelConfig, params: lm.LM, batch,
                                   tokens, s_max: int) -> torch.Tensor:
    """The logits of a lockstep run from a frontend input: `lm.prefill` of
    `batch` ('tokens' or 'embeds', and 'enc_embeds' for an enc-dec model:
    tensors on the params' device) into a fresh cache of `s_max` slots,
    then one `lm.decode_step` per column of `tokens` [B, n], each fed that
    column instead of the sampled tokens.  Returns [n + 1, B, V] fp32 on
    the CPU (row 0 the prefill's last position)."""
    dev = params.embed.device
    B = next(iter(batch.values())).shape[0]
    cache = lm.init_cache(cfg, B, s_max, device=dev)
    logits, cache = lm.prefill(cfg, params, cache, batch)
    rows = [logits]
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=dev)
    for i in range(tokens.shape[1]):
        logits, cache = lm.decode_step(cfg, params, cache,
                                       tokens[:, i:i + 1])
        rows.append(logits[:, 0])
    return torch.stack(rows).to(torch.float32).cpu()
