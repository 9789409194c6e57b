"""LM-side micro-benchmarks (port of `repro.bench.suites.lm_throughput`):
train tokens/s and decode tokens/s for a reduced config, on the card by
default.  Wall-clock only: the final loss is floating-point and
version-sensitive, so it is reported but not gated.

Train: `train.step.make_train_step` with a cosine schedule, AdamW,
batches from `data.pipeline.Batcher(seed=1)`; one step first (its build
and warm-up), then `steps` timed.  Decode: `lm.decode_step` in lockstep
under `no_grad`, greedy, one warm-up step then 50 (20 quick) timed.
"""
from __future__ import annotations

import json

import torch

from ...configs import get_smoke_config
from ...core.engine import resolve_device
from ...data import pipeline
from ...models import lm
from ...optim import schedules
from ...train import step as step_mod
from ...train.train_state import create
from .. import report as R
from .. import timing


def bench(arch: str = "qwen3-0.6b", steps: int = 10, batch: int = 8,
          seq: int = 128, quick: bool = False, device=None):
    if quick:
        steps, batch, seq = 5, 4, 64
    dev = resolve_device(device)
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    state = create(params)
    step = step_mod.make_train_step(
        cfg, lr_schedule=schedules.cosine(3e-4, 10, 1000))
    data = iter(pipeline.Batcher(cfg, batch, seq, seed=1, device=dev))

    state, m = step(state, next(data))          # warm-up
    timing.synchronize(m)
    with timing.Timer() as tw:
        for _ in range(steps):
            state, m = step(state, next(data))
        timing.synchronize(m)
    row = dict(kind="train", arch=arch, steps=steps,
               tokens_per_s=int(steps * batch * seq / tw.s),
               wall_s=round(tw.s, 2), final_loss=round(float(m["loss"]), 3))
    print("[lm]", json.dumps(row), flush=True)

    # decode throughput
    with torch.no_grad():
        cache = lm.init_cache(cfg, batch, 64, device=dev)
        tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
        _, cache = lm.decode_step(cfg, params, cache, tok)   # warm-up
        n = 20 if quick else 50
        with timing.Timer() as td:
            for _ in range(n):
                lg, cache = lm.decode_step(cfg, params, cache, tok)
                tok = lg.argmax(-1).to(torch.int32)
            timing.synchronize(tok)
    row2 = dict(kind="decode", arch=arch,
                tokens_per_s=int(n * batch / td.s), wall_s=round(td.s, 2))
    print("[lm]", json.dumps(row2), flush=True)
    return [row, row2]


def run_suite(quick: bool = False, device=None) -> dict:
    rows = bench(quick=quick, device=device)
    wall = dict(train_tokens_per_s=rows[0]["tokens_per_s"],
                train_wall_s=rows[0]["wall_s"],
                decode_tokens_per_s=rows[1]["tokens_per_s"],
                decode_wall_s=rows[1]["wall_s"])
    config = dict(quick=quick, arch=rows[0]["arch"])
    return R.make_report("lm_throughput", config, {}, wall,
                         extra=dict(rows=rows), device=device)
