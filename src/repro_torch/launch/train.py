"""Training launcher (port of `repro.launch.train`).

  python -m repro_torch.launch.train --arch <id> [--smoke] --steps N
      [--batch B --seq T] [--lr LR] [--ckpt-dir DIR] [--microbatch M]
      [--compress-grads] [--device cuda|cpu]

Trains on the card (`--device cuda`, the default; it raises without one)
or on the CPU: the port's own random init (a generator seeded 0), the
JAX package's synthetic stream (`data.pipeline.Batcher`, seed 1), a WSD
schedule, AdamW, resume from the latest checkpoint in `--ckpt-dir`.
Prints the parameter count, the run's summary, every step's loss and the
kernel launch counts.  `--production-mesh` (the JAX package's sharded
production mesh) is refused: the port's LM sharding rules are ROADMAP
queue 1 item 13.7.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.optim import schedules
from repro_torch.train import step as step_mod
from repro_torch.train.train_state import create
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="bind the production mesh (not ported: raises)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the LM sharding rules and the production "
            "mesh are not ported yet (ROADMAP queue 1 item 13.7); the port "
            "does not run them unsharded in their place")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    dev = resolve_device(args.device)
    sched = schedules.wsd(args.lr, warmup=min(100, args.steps // 10 + 1),
                          stable=args.steps, decay=max(args.steps // 10, 1))
    step = step_mod.make_train_step(cfg, lr_schedule=sched,
                                    microbatch=args.microbatch,
                                    compress_grads=args.compress_grads)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    print(f"[train] {cfg.name}: {lm.param_count(params)/1e6:.1f}M params "
          f"on {dev}", flush=True)
    state = create(params, use_error_feedback=args.compress_grads)
    tr = Trainer(step, state, ckpt_dir=args.ckpt_dir)
    start = tr.maybe_resume()
    data = iter(pipeline.prefetch(iter(pipeline.Batcher(
        cfg, args.batch, args.seq, seed=1, start_index=start, device=dev))))
    ops.reset_launch_counts()
    print(tr.run(data, args.steps - start), flush=True)
    print(f"[train] losses {json.dumps(tr.history)}")
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"[train] launches {json.dumps(launched)}")
    return tr


if __name__ == "__main__":
    main()
