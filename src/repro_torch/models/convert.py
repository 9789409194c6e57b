"""Carry LM parameters between the JAX package's tree and the port.

The JAX package's `lm.init_params` returns a nested dict:
  {'embed', 'final_norm', 'stack': {'units': {'layer{i}': {...}} | None,
                                    'rem': [{...}, ...]}}
with each unit leaf stacked on a leading [n_units] axis ('unembed' where
the embeddings are untied; for the enc-dec family also 'enc_norm' and
'enc_stack', the same layout over `lm.encoder_view(cfg)`: 'units.layer0'
stacked on [n_encoder_layers], 'rem' empty).  The port holds one `Layer`
per entry of `cfg.layers` (see `transformer`).

* `lm_params_from_jax(tree, cfg, device)` loads such a tree of numpy
  arrays (or anything `np.asarray` takes) into a new `LM`.  Each leaf is
  cast to its parameter's dtype by round-to-nearest-even, so an fp32 tree
  gives the same bf16 bits as JAX's `astype(bfloat16)`.
* `lm_params_to_tree(params, cfg)` goes the other way (numpy leaves in the
  parameters' own dtypes; bf16 as `ml_dtypes.bfloat16`).
* `jax_leaf_groups(cfg)` lists the port's parameter names by the JAX
  tree's leaves, in `jax.tree.leaves` order (what the global norm and the
  train-state files follow).
* `numpy_params(cfg, seed)` draws an fp32 tree in the JAX layout from a
  numpy seed, with the JAX package's distributions (and biases, gains,
  lerp weights and decays moved off their constants, so that a comparison
  exercises them): the weights that both packages load where their
  outputs are compared (random final-norm gains, so that the greedy tokens
  vary).

numpy's `bfloat16` leaves (`ml_dtypes`) are read through a uint16 view,
since `torch.from_numpy` refuses them.  No JAX is imported here.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from . import lm


#: The port's layer stacks: their parameters' first name, and the config
#: each is built from.
STACKS = {"stack": lambda cfg: cfg, "enc_stack": lm.encoder_view}


def _layer_key(cfg: ModelConfig, k: int) -> Tuple:
    """Where port layer k of a stack over `cfg` lives in the JAX tree:
    ('units', 'layer{i}', u) or ('rem', r)."""
    P = len(cfg.pattern)
    if k < cfg.n_units * P:
        return ("units", f"layer{k % P}", k // P)
    return ("rem", k - cfg.n_units * P)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _jax_leaf(tree, cfg: ModelConfig, name: str):
    """The JAX tree's array for the port parameter `name`."""
    parts = name.split(".")
    if parts[0] not in STACKS:
        return tree[parts[0]]
    k, rest = int(parts[2]), parts[3:]
    where = _layer_key(STACKS[parts[0]](cfg), k)
    stack = tree[parts[0]]
    if where[0] == "units":
        return np.asarray(_get(stack["units"][where[1]], rest))[where[2]]
    return _get(stack["rem"][where[1]], rest)


def _to_torch(x) -> torch.Tensor:
    a = np.array(x, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_jax(tree, cfg: ModelConfig, device=None) -> lm.LM:
    """A new `LM` on `device` (None: the card) holding the JAX tree's
    parameters."""
    params = lm.LM(cfg, resolve_device(device))
    with torch.no_grad():
        for name, w in params.named_parameters():
            src = _to_torch(_jax_leaf(tree, cfg, name))
            if tuple(src.shape) != tuple(w.shape):
                raise ValueError(f"{name}: JAX leaf {tuple(src.shape)}, "
                                 f"port parameter {tuple(w.shape)}")
            w.copy_(src)
    return params


def _assemble(cfg: ModelConfig, leaves: Dict[str, np.ndarray]):
    """The JAX-layout tree from per-port-parameter arrays (unit layers
    stacked on a leading [n_units] axis)."""
    tree: Dict[str, Any] = {}
    units: Dict[str, Dict[str, Dict]] = {}
    rems: Dict[str, list] = {}

    def put(d, path, value):
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = value

    for name, arr in leaves.items():
        parts = name.split(".")
        if parts[0] not in STACKS:
            tree[parts[0]] = arr
            continue
        scfg = STACKS[parts[0]](cfg)
        rem = rems.setdefault(parts[0],
                              [dict() for _ in range(scfg.n_remainder)])
        where = _layer_key(scfg, int(parts[2]))
        if where[0] == "units":
            put(units.setdefault(parts[0], {}),
                [where[1]] + parts[3:] + [where[2]], arr)
        else:
            put(rem[where[1]], parts[3:], arr)

    def stacked(d, n):
        if all(isinstance(k, int) for k in d):
            return np.stack([d[u] for u in range(n)])
        return {k: stacked(v, n) for k, v in d.items()}

    for top in rems:
        n = STACKS[top](cfg).n_units
        tree[top] = {"units": stacked(units[top], n) if n else None,
                     "rem": rems[top]}
    return tree


def lm_params_to_tree(params: lm.LM, cfg: ModelConfig):
    """The JAX-layout tree of numpy arrays holding `params` (bf16 leaves
    as `ml_dtypes.bfloat16`, which numpy itself lacks)."""
    leaves = {}
    for name, w in params.named_parameters():
        w = w.detach().cpu()
        if w.dtype == torch.bfloat16:
            import ml_dtypes
            leaves[name] = w.view(torch.uint16).numpy().view(
                ml_dtypes.bfloat16)
        else:
            leaves[name] = w.numpy().copy()
    return _assemble(cfg, leaves)


class JaxLeaf(NamedTuple):
    """A leaf of the JAX parameter tree: the port's parameters it holds
    (in unit order), stacked on a leading [n_units] axis or not, and its
    path as the JAX package's sharding rules read it
    ('/stack/units/layer0/mixer/wq', '/stack/rem/0/norm1', '/embed')."""
    names: List[str]
    stacked: bool
    path: str = ""


def jax_leaf_groups(cfg: ModelConfig) -> List[JaxLeaf]:
    """The JAX tree's leaves in `jax.tree.leaves` order (dict keys sorted,
    lists in order), each with the port's parameter names it holds: a
    pattern unit's leaf is the stack of its layers' parameters, any other
    leaf one parameter."""
    leaves: Dict[tuple, list] = {}
    for name, _ in lm.LM(cfg, torch.device("meta")).named_parameters():
        parts = name.split(".")
        path, u = (parts[0],), 0
        if parts[0] in STACKS:
            where = _layer_key(STACKS[parts[0]](cfg), int(parts[2]))
            if where[0] == "units":
                path, u = (parts[0], "units", where[1], *parts[3:]), where[2]
            else:
                path = (parts[0], "rem", where[1], *parts[3:])
        leaves.setdefault(path, []).append((u, name))
    return [JaxLeaf([name for _, name in sorted(v)], "units" in path[1:2],
                    "/" + "/".join(str(k) for k in path))
            for path, v in sorted(leaves.items())]


def numpy_params(cfg: ModelConfig, seed: int):
    """fp32 weights in the JAX layout from `np.random.default_rng(seed)`:
    fan-in normals clipped at 3 sigma for matrices (the MoE router and the
    untied `unembed` too), N(0, 1/d) for the embedding, the Griffin Lambda
    for `log_lambda`, N(0, 0.1^2) for the biases and RWKV's `bonus_u`,
    1 + N(0, 0.1^2) for the layers' norm gains (qk-norm's, RWKV's group
    norm's, the 'xa' layers' `norm3` and the encoder's `enc_norm` too),
    U(0, 1) for RWKV's lerp weights `mu_*`, U(-6, 0) for its `decay_w0`
    (per-step decays from 0.9975 down to 0.37), and N(0, 1) for the final
    norm's gains.  With gains of 1 there, a random model with
    tied embeddings predicts the token it was given; random gains make its
    greedy tokens vary, so that comparing them means something."""
    rng = np.random.default_rng(seed)
    shapes = lm.LM(cfg, torch.device("meta"))
    leaves = {}
    for name, w in shapes.named_parameters():
        shape, leaf = tuple(w.shape), name.split(".")[-1]
        if leaf == "embed":
            x = rng.standard_normal(shape) * shape[-1] ** -0.5
        elif leaf == "final_norm":
            x = rng.standard_normal(shape)
        elif leaf.startswith("norm") or leaf in ("q_gamma", "k_gamma",
                                                 "ln_gamma", "enc_norm"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf.startswith("mu_"):
            x = rng.uniform(0.0, 1.0, shape)
        elif leaf == "decay_w0":
            x = rng.uniform(-6.0, 0.0, shape)
        elif leaf == "bonus_u":
            x = 0.1 * rng.standard_normal(shape)
        elif leaf in ("conv_b", "ba", "bi"):
            x = 0.1 * rng.standard_normal(shape)
        elif leaf == "log_lambda":
            a = np.linspace(0.9, 0.999, shape[0])
            x = np.log(np.expm1(-np.log(a) / 8.0))
        else:
            x = np.clip(rng.standard_normal(shape), -3.0, 3.0) \
                * shape[-2] ** -0.5
        leaves[name] = x.astype(np.float32)
    return _assemble(cfg, leaves)
