"""What each rank of `test_torch_train_sharded.py`'s gloo jobs runs (a
module of its own, so that the ranks import neither pytest nor JAX).

`mesh_rank`: for each arch at SMOKE in fp32, on the weights of
`convert.numpy_params(cfg, 0)`, the sharded loss and gradients of
`train_reference.json`'s loss batch (gathered whole on the primary) and
three sharded `make_train_step` steps of its trajectory; then, on the
primary alone, the same in one process, and one result line an arch.
At 2x2 also the bf16 loss and gradients of `args['bf16']`'s archs, and
the reference's other trajectories (`args['configs']`).
`save_rank`: two sharded steps through a checkpointing `Trainer`.
`resume_rank`: a `Trainer` resuming a checkpoint under this job's mesh for
one step.  `production_rank`: the launcher's `--production-mesh` under
this job, printing what it raised.
"""
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench.subproc import emit
from repro_torch.cluster import runtime
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline, synthetic
from repro_torch.dist import lm_blocks, sharding
from repro_torch.dist.mesh import make_lm_mesh
from repro_torch.models import convert, lm, moe
from repro_torch.optim import schedules
from repro_torch.train import step as step_mod
from repro_torch.train import train_state as ts
from repro_torch.train.trainer import Trainer

REF = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" \
    / "train_reference.json"
AXES = ("data", "model")


def reference() -> dict:
    return json.loads(REF.read_text())


def params_of(cfg, ref):
    return convert.lm_params_from_jax(
        convert.numpy_params(cfg, ref["weights_seed"]), cfg, "cpu")


def loss_batch(cfg, ref) -> dict:
    """train_reference.json's loss batch (tokens, labels with four
    masked), as tensors."""
    bk = ref["batch"]
    toks = synthetic.batch_tokens(bk["seed"], bk["index"], bk["B"], bk["T"],
                                  cfg.vocab_size)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    for i, t in bk["masked"]:
        b["labels"][i, t] = -100
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


def loss_and_grads(cfg, params, batch, xent_chunk):
    pd = dict(params.named_parameters())
    loss, metrics = lm.loss_fn(cfg, params, batch, xent_chunk=xent_chunk)
    gs = torch.autograd.grad(loss, list(pd.values()), allow_unused=True,
                             materialize_grads=True)
    return float(metrics.get("loss", loss)), dict(zip(pd, gs))


def trajectory(cfg, ref, mesh=None, steps=None, config="plain"):
    """`ref`'s trajectory of `config` (plain, microbatch, compress):
    (losses, gradient norms, learning rates, the slot products run, the
    state)."""
    tr = ref["trajectory"]
    kw = tr["configs"][config]
    state = ts.create(params_of(cfg, ref), mesh=mesh,
                      use_error_feedback=kw.get("compress_grads", False))
    step = step_mod.make_train_step(cfg, lr_schedule=schedules.wsd(
        *tr["wsd"]), mesh=mesh, **kw)
    data = iter(pipeline.Batcher(cfg, tr["B"], tr["T"],
                                 seed=tr["batcher_seed"], device="cpu",
                                 mesh=mesh))
    out = {"loss": [], "grad_norm": [], "lr": []}
    moe.reset_slot_counts()
    for _ in range(steps or tr["steps"]):
        state, m = step(state, next(data))
        for k in out:
            out[k].append(float(m[k]))
    return out, moe.slot_counts(), state


def mesh_rank(args: dict) -> None:
    torch.set_num_threads(1)
    ref = reference()
    mesh = make_lm_mesh(args["shape"], AXES)
    for arch in args["archs"]:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        t0 = time.perf_counter()
        params = ts.create(params_of(cfg, ref), mesh=mesh).params
        batch = {k: lm_blocks.rows(x, k, mesh)
                 for k, x in loss_batch(cfg, ref).items()}
        with sharding.use_mesh(mesh):
            loss, grads = loss_and_grads(cfg, params, batch,
                                         ref["xent_chunk"])
        whole = lm_blocks.gather(grads, mesh, like=params)
        traj, slots, state = trajectory(cfg, ref, mesh)
        mine = torch.tensor([[lm_blocks.resident_bytes(state),
                              lm_blocks.expected_bytes(cfg, mesh,
                                                       mesh.coords),
                              slots]])
        ranks = runtime.gather(mine)
        sharded_s = time.perf_counter() - t0
        if not runtime.is_primary():
            continue
        one = params_of(cfg, ref)
        one.requires_grad_(True)
        loss1, grads1 = loss_and_grads(cfg, one, loss_batch(cfg, ref),
                                       ref["xent_chunk"])
        leaf_err = {n: float((whole[n] - g).abs().max()
                             / g.abs().max().clamp_min(1e-30))
                    for n, g in grads1.items()}
        traj1, slots1, _ = trajectory(cfg, ref)
        emit(dict(arch=arch, shape=list(args["shape"]), loss=loss,
                  loss_one=loss1, leaf_err=leaf_err, traj=traj,
                  traj_one=traj1, ranks=ranks.tolist(), slots_one=slots1,
                  n_layers=cfg.n_layers, sharded_s=sharded_s))
    for arch in args.get("bf16", ()):
        cfg = get_smoke_config(arch).scaled(dtype="bfloat16")
        params = ts.create(params_of(cfg, ref), mesh=mesh).params
        batch = {k: lm_blocks.rows(x, k, mesh)
                 for k, x in loss_batch(cfg, ref).items()}
        with sharding.use_mesh(mesh):
            loss, grads = loss_and_grads(cfg, params, batch,
                                         ref["xent_chunk"])
        whole = lm_blocks.gather(grads, mesh, like=params)
        if runtime.is_primary():
            one = params_of(cfg, ref)
            one.requires_grad_(True)
            loss1, grads1 = loss_and_grads(cfg, one, loss_batch(cfg, ref),
                                           ref["xent_chunk"])
            leaf_err = {n: float((whole[n].float() - g.float()).abs().max()
                                 / g.float().abs().max().clamp_min(1e-30))
                        for n, g in grads1.items()}
            emit(dict(arch=arch, config="bfloat16", loss=loss,
                      loss_one=loss1, leaf_err=leaf_err))
    for arch, config in args.get("configs", ()):
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        traj, _, state = trajectory(cfg, ref, mesh, config=config)
        mine = torch.tensor([[lm_blocks.resident_bytes(state),
                              lm_blocks.expected_bytes(
                                  cfg, mesh, mesh.coords,
                                  error_feedback=state.ef_residual
                                  is not None)]])
        ranks = runtime.gather(mine)
        if runtime.is_primary():
            emit(dict(arch=arch, config=config, traj=traj,
                      ranks=ranks.tolist()))


def save_rank(args: dict) -> None:
    """Two sharded steps of `args['arch']`'s trajectory through a Trainer
    that checkpoints every two steps into `args['dir']`."""
    torch.set_num_threads(1)
    ref = reference()
    tr = ref["trajectory"]
    mesh = make_lm_mesh(args["shape"], AXES)
    cfg = get_smoke_config(args["arch"]).scaled(dtype="float32")
    state = ts.create(params_of(cfg, ref), mesh=mesh)
    step = step_mod.make_train_step(cfg, lr_schedule=schedules.wsd(
        *tr["wsd"]), mesh=mesh)
    trainer = Trainer(step, state, ckpt_dir=args["dir"], ckpt_every=2,
                      log_every=100)
    trainer.run(iter(pipeline.Batcher(cfg, tr["B"], tr["T"],
                                      seed=tr["batcher_seed"], device="cpu",
                                      mesh=mesh)), 2)
    if runtime.is_primary():
        emit(dict(losses=trainer.history))


def resume_rank(args: dict) -> None:
    """A fresh state placed on this job's mesh resumes from the latest file
    of `args['dir']` and takes the next step."""
    torch.set_num_threads(1)
    ref = reference()
    tr = ref["trajectory"]
    mesh = make_lm_mesh(args["shape"], AXES)
    cfg = get_smoke_config(args["arch"]).scaled(dtype="float32")
    state = ts.create(lm.LM(cfg, torch.device("meta")), mesh=mesh)
    step = step_mod.make_train_step(cfg, lr_schedule=schedules.wsd(
        *tr["wsd"]), mesh=mesh)
    trainer = Trainer(step, state, ckpt_dir=args["dir"], ckpt_every=0,
                      log_every=100)
    start = trainer.maybe_resume()
    moe.reset_slot_counts()
    trainer.run(iter(pipeline.Batcher(cfg, tr["B"], tr["T"],
                                      seed=tr["batcher_seed"],
                                      start_index=start, device="cpu",
                                      mesh=mesh)), 1)
    ranks = runtime.gather(torch.tensor([[moe.slot_counts()]]))
    if runtime.is_primary():
        emit(dict(start=start, losses=trainer.history,
                  step=int(trainer.state.step), slots=ranks.tolist()))


def production_rank(args: dict) -> None:
    from repro_torch.launch import train
    try:
        train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                    "--device", "cpu", "--production-mesh"])
    except (ValueError, RuntimeError) as e:
        if runtime.is_primary():
            emit(dict(raised=type(e).__name__, message=str(e)))
        return
    if runtime.is_primary():
        emit(dict(raised=None))
