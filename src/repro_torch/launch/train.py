"""Training launcher (port of `repro.launch.train`).

  python -m repro_torch.launch.train --arch <id> [--smoke] --steps N
      [--batch B --seq T] [--lr LR] [--ckpt-dir DIR] [--microbatch M]
      [--compress-grads] [--device cuda|cpu]

Trains on the card (`--device cuda`, the default; it raises without one)
or on the CPU: the port's own random init (a generator seeded 0), the
JAX package's synthetic stream (`data.pipeline.Batcher`, seed 1), a WSD
schedule, AdamW, resume from the latest checkpoint in `--ckpt-dir`.
Prints the parameter count, the run's summary, every step's loss and the
kernel launch counts.

`--production-mesh` binds the JAX package's production mesh, 16x16
('data', 'model'), to the job this process is a rank of (torchrun, or the
REPRO_CLUSTER_* variables: `cluster.runtime`): each rank holds its blocks
of the state by the LM sharding rules (`dist.lm_blocks`) and takes its
rows of every batch.  The job must have 256 ranks; under any other it
raises, naming the job's size (nothing runs unsharded in its place).
Only the primary prints.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.cluster import runtime
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data import pipeline
from repro_torch.dist.mesh import bind, make_production_mesh
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
                    help="bind the 16x16 production mesh to this job's 256 "
                         "ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    mesh = None
    if args.production_mesh:
        runtime.ensure_initialized(device=args.device)
        mesh = bind(make_production_mesh())
    say = print if runtime.is_primary() else (lambda *a, **k: None)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    sched = schedules.wsd(args.lr, warmup=min(100, args.steps // 10 + 1),
                          stable=args.steps, decay=max(args.steps // 10, 1))
    step = step_mod.make_train_step(cfg, lr_schedule=sched,
                                    microbatch=args.microbatch,
                                    compress_grads=args.compress_grads,
                                    mesh=mesh)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    where = dev if mesh is None else (f"{mesh.size} ranks of "
                                      f"{mesh.shape}, {mesh.backend}")
    say(f"[train] {cfg.name}: {lm.param_count(params)/1e6:.1f}M params "
        f"on {where}", flush=True)
    state = create(params, use_error_feedback=args.compress_grads, mesh=mesh)
    tr = Trainer(step, state, ckpt_dir=args.ckpt_dir)
    start = tr.maybe_resume()
    data = iter(pipeline.prefetch(iter(pipeline.Batcher(
        cfg, args.batch, args.seq, seed=1, start_index=start, device=dev,
        mesh=mesh))))
    ops.reset_launch_counts()
    say(tr.run(data, args.steps - start), flush=True)
    say(f"[train] losses {json.dumps(tr.history)}")
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    say(f"[train] launches {json.dumps(launched)}")
    return tr


if __name__ == "__main__":
    main()
