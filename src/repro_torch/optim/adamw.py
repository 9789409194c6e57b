"""AdamW with the JAX package's formula (port of `repro.optim.adamw`).

    m <- b1 m + (1 - b1) g          v <- b2 v + (1 - b2) g g
    p <- p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

in fp32, m and v in fp32, the new p cast back to its dtype, in the
operations the JAX package's jitted step runs: XLA folds the two
divisions of m into one, m / ((1 - b1^t) (sqrt(v / (1 - b2^t)) + eps)).
This is not `torch.optim.AdamW`, which decays p before the step and
divides in another order.  A tree is a dict of tensors keyed by the port's
parameter names; `update` writes the new parameters into `params` in place
(they may be `torch.nn.Parameter`s) and returns them with the new state.
`b ** step` is the device's `pow` (within an fp32 ulp of XLA-CPU's).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor                  # [] int32
    m: Dict[str, torch.Tensor]          # like params, fp32
    v: Dict[str, torch.Tensor]          # like params, fp32


def init(params: Dict[str, torch.Tensor]) -> AdamWState:
    first = next(iter(params.values()))
    zeros = lambda: {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                     for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=zeros(), v=zeros())


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], state: AdamWState,
           params: Dict[str, torch.Tensor], *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1) -> Tuple[Dict, AdamWState]:
    """Returns (params, new_state).  Updates in place, leaf by leaf, so
    that no leaf's old and new moments are held at once: the parameters,
    and the moment tensors of `state`, which the new state shares.  lr is
    a scalar or a callable of the new step."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    sf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=sf.device), sf)
    for k, p in params.items():
        m, v = state.m[k], state.v[k]
        gf = grads[k].to(F32)                   # (the gradient itself if fp32)
        m.mul_(b1).add_(gf * (1.0 - b1))        # b1 m + (1 - b1) g
        v.mul_(b2).add_((gf * (1.0 - b2)).mul_(gf))   # b2 v + (1 - b2) g g
        del gf
        # m / (b1c (sqrt(v / b2c) + eps)) + wd p, then p - lr step
        denom = torch.div(v, b2c).sqrt_().add_(eps).mul_(b1c)
        pf = p.to(F32)
        upd = torch.div(m, denom).add_(pf * weight_decay)
        del denom
        p.copy_(pf.sub_(upd.mul_(lr_t)).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v)
