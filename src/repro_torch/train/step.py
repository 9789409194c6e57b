"""Train-step factory (port of `repro.train.step`): loss -> gradients ->
(clip, compress) -> AdamW, with optional micro-batch accumulation.

The step runs eagerly: autograd computes the gradients (`torch.autograd.
grad`, nothing accumulates in `.grad`), and every layer is recomputed in
the backward (`models.transformer.apply_stack`), as the JAX package's
per-layer remat does.  It updates `state.params` in place and returns the
new state with the metrics `loss`, `grad_norm`, `lr`, `xent` and `aux`
(0-dim tensors on the parameters' device).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..models import convert, lm
from ..optim import adamw, grad_utils
from .train_state import TrainState, param_dict

F32 = torch.float32


def make_loss_fn(cfg: ModelConfig):
    """loss(params, batch) -> (loss, metrics).  Recompute lives in the
    layer stack and the chunked cross-entropy (the JAX package's `remat`
    argument, which it ignores, is left out)."""

    def loss(params, batch):
        return lm.loss_fn(cfg, params, batch)

    return loss


def make_train_step(cfg: ModelConfig, *, lr_schedule: Callable,
                    grad_clip: float = 1.0, weight_decay: float = 0.1,
                    microbatch: Optional[int] = None,
                    compress_grads: bool = False):
    """Returns step(state, batch) -> (state, metrics)."""
    loss_fn = make_loss_fn(cfg)
    groups = [leaf.names for leaf in convert.jax_leaf_groups(cfg)]

    def grads_of(params, batch):
        pd = param_dict(params)
        l, metrics = loss_fn(params, batch)
        gs = torch.autograd.grad(l, list(pd.values()), allow_unused=True,
                                 materialize_grads=True)
        return (l.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(pd, gs)))

    def accumulate(params, batch):
        """Split the global batch into microbatches of `microbatch` rows,
        averaging the gradients in sequence: acc + g.float() / k from
        fp32 zeros, k the number of microbatches."""
        n = microbatch
        B = batch["labels"].shape[0]
        assert B % n == 0, (B, n)
        k = B // n
        acc = {name: torch.zeros(w.shape, dtype=F32, device=w.device)
               for name, w in param_dict(params).items()}
        lsum = torch.zeros((), dtype=F32, device=acc[next(iter(acc))].device)
        for i in range(k):
            mb = {key: x[i * n:(i + 1) * n] for key, x in batch.items()}
            l, _, g = grads_of(params, mb)
            for name, a in acc.items():
                a.add_(g[name].to(F32) / k)
            lsum = lsum + l / k
        return lsum, {"xent": lsum, "aux": torch.zeros_like(lsum)}, acc

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> tuple:
        if microbatch:
            l, metrics, grads = accumulate(state.params, batch)
        else:
            l, metrics, grads = grads_of(state.params, batch)
        grads, gnorm = grad_utils.clip_by_global_norm(grads, grad_clip,
                                                      groups)
        ef = state.ef_residual
        if compress_grads and ef is not None:
            grads, ef = grad_utils.compress_with_feedback(grads, ef)
        _, opt = adamw.update(grads, state.opt, param_dict(state.params),
                              lr=lr_schedule, weight_decay=weight_decay)
        new_state = TrainState(params=state.params, opt=opt,
                               step=state.step + 1, ef_residual=ef)
        metrics = dict(metrics, loss=l, grad_norm=gnorm,
                       lr=lr_schedule(opt.step))
        return new_state, metrics

    return step
