"""Fault-tolerant training loop (port of `repro.train.trainer`):
resume-from-latest, periodic atomic checkpoints, a non-finite-loss guard
(restore the last checkpoint) and the loss history.  It steps eagerly; a
CUDA graph of the step is later speed work.  Over an `LmMesh` (a state
placed by `train_state.create(..., mesh=)`) every rank runs the loop: the
primary writes the checkpoints (`train_state.save` gathers the blocks),
every rank resumes from the latest file, placed by its own mesh, whatever
the mesh that wrote it, and only the primary logs."""
from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Iterator, Optional

from . import train_state as ts_mod
from .train_state import TrainState


class Trainer:
    def __init__(self, step_fn: Callable, state: TrainState,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
                 log_every: int = 10, log_fn=print):
        self.step_fn = step_fn
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        from ..cluster import runtime
        self.log = log_fn if runtime.is_primary() else (lambda *a: None)
        self.history = []

    def maybe_resume(self) -> int:
        if not self.ckpt_dir:
            return 0
        path = ts_mod.latest(self.ckpt_dir)
        if path:
            self.state = ts_mod.load(path, self.state)
            self.log(f"[trainer] resumed from {path} "
                     f"(step {int(self.state.step)})")
        return int(self.state.step)

    def checkpoint(self):
        if not self.ckpt_dir:
            return
        step = int(self.state.step)
        path = os.path.join(self.ckpt_dir, f"lm_{step}.npz")
        ts_mod.save(path, self.state)

    def run(self, data: Iterator, n_steps: int) -> Dict:
        t0 = time.time()
        last = t0
        for _ in range(n_steps):
            batch = next(data)
            self.state, metrics = self.step_fn(self.state, batch)
            step = int(self.state.step)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                # restore the last checkpoint rather than go on from
                # parameters the step has already overwritten
                self.log(f"[trainer] non-finite loss at step {step}; "
                         "restoring last checkpoint")
                resumed = self.maybe_resume()
                if resumed == 0:
                    raise FloatingPointError("non-finite loss, no ckpt")
                continue
            self.history.append(loss)
            if step % self.log_every == 0:
                now = time.time()
                self.log(f"[trainer] step {step} loss {loss:.4f} "
                         f"({(now - last):.2f}s)")
                last = now
            if self.ckpt_every and step % self.ckpt_every == 0:
                self.checkpoint()
        self.checkpoint()
        return {"steps": int(self.state.step),
                "final_loss": self.history[-1] if self.history else None,
                "wall_s": time.time() - t0}
