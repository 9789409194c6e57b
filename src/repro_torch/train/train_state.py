"""Train state and layout-free LM checkpoints (port of
`repro.train.train_state`), in the JAX package's file format, so that a
checkpoint moves both ways between the packages.

`TrainState.params` is the `models.lm.LM` module (the train step updates
it in place); the optimizer's m and v, and the error-feedback residual,
are dicts of fp32 tensors keyed by the module's parameter names.

A file is an npz: `leaf_i` for the i-th leaf of the JAX `TrainState` in
`jax.tree.flatten` order (params, then opt.step, opt.m, opt.v, then step,
then ef_residual when present; each tree in the JAX parameter tree's leaf
order, `models.convert.jax_leaf_groups`, a pattern unit's layers stacked
into one leaf), bf16 through a uint16 view, and `meta`, JSON of
`n_leaves`, `step`, the leaves' `dtypes` and `extra`.  Writes are atomic
(a temporary file, then a rename).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..models import convert
from ..optim import adamw, grad_utils


class TrainState(NamedTuple):
    params: torch.nn.Module
    opt: adamw.AdamWState
    step: torch.Tensor                  # [] int32 (global step, == opt.step)
    ef_residual: Optional[Dict[str, torch.Tensor]] = None


def param_dict(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def create(params: torch.nn.Module,
           use_error_feedback: bool = False) -> TrainState:
    """A fresh state at step 0 over `params` (an `LM`), whose parameters
    this turns trainable (`requires_grad`)."""
    params.requires_grad_(True)
    pd = param_dict(params)
    ef = grad_utils.init_error_feedback(pd) if use_error_feedback else None
    opt = adamw.init(pd)
    return TrainState(params=params, opt=opt, step=opt.step.clone(),
                      ef_residual=ef)


def _trees(state: TrainState) -> list:
    """The state's parts in `jax.tree.flatten` order: a dict of tensors
    (a tree over the parameter names) or a 0-dim tensor."""
    parts = [param_dict(state.params), state.opt.step, state.opt.m,
             state.opt.v, state.step]
    if state.ef_residual is not None:
        parts.append(state.ef_residual)
    return parts


def _leaves(state: TrainState) -> List[tuple]:
    """The file's leaves in order: (the part of `_trees` it belongs to, the
    parameter names it holds or None for a scalar, stacked or not, its
    tensors)."""
    groups = convert.jax_leaf_groups(state.params.cfg)
    out = []
    for k, part in enumerate(_trees(state)):
        if isinstance(part, torch.Tensor):
            out.append((k, None, False, [part]))
        else:
            out.extend((k, g.names, g.stacked, [part[n] for n in g.names])
                       for g in groups)
    return out


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.uint16).numpy()
    return x.numpy()


def save(path: str, state: TrainState, extra: Optional[dict] = None) -> str:
    payload, dtypes = {}, []
    for i, (_, _, stacked, ts) in enumerate(_leaves(state)):
        a = np.stack([_to_numpy(t) for t in ts]) if stacked \
            else _to_numpy(ts[0])
        dtypes.append(str(ts[0].dtype).replace("torch.", ""))
        payload[f"leaf_{i}"] = a
    meta = dict(n_leaves=len(payload), step=int(state.step), dtypes=dtypes,
                extra=extra or {})
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, meta=json.dumps(meta), **payload)
    os.replace(tmp, path)
    return path


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy (0-dim kept)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load(path: str, template: TrainState) -> TrainState:
    """The state saved at `path`, in the layout of `template`, whose
    parameters are overwritten in place; m, v, the steps and the residual
    are new tensors on the template's devices.  Raises on a count, shape
    or dtype that differs from the template's."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        arrays = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    leaves = _leaves(template)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"{path}: {meta['n_leaves']} leaves, the template "
                         f"has {len(leaves)}")
    parts = [None if isinstance(p, torch.Tensor) else {}
             for p in _trees(template)]
    for i, (k, names, stacked, ts) in enumerate(leaves):
        want = str(ts[0].dtype).replace("torch.", "")
        if meta["dtypes"][i] != want:
            raise ValueError(f"{path}: leaf {i} is {meta['dtypes'][i]}, "
                             f"the template's {want}")
        a = _from_numpy(arrays[i], want)
        vals = list(a) if stacked else [a]
        if len(vals) != len(ts) or any(tuple(v.shape) != tuple(t.shape)
                                       for v, t in zip(vals, ts)):
            raise ValueError(f"{path}: leaf {i} has shape "
                             f"{tuple(a.shape)}, not the template's")
        vals = [v.to(t.device) for v, t in zip(vals, ts)]
        if names is None:
            parts[k] = vals[0]
        else:
            parts[k].update(zip(names, vals))
    with torch.no_grad():
        for name, w in param_dict(template.params).items():
            w.copy_(parts[0][name])
    return TrainState(params=template.params,
                      opt=adamw.AdamWState(step=parts[1], m=parts[2],
                                           v=parts[3]),
                      step=parts[4],
                      ef_residual=parts[5] if len(parts) > 5 else None)


def latest(directory: str, prefix: str = "lm_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    return os.path.join(directory,
                        max(cands, key=lambda f: int(f[len(prefix):-4])))
