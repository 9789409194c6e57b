"""The LM's train state in blocks over an `LmMesh`, and the collectives
its step runs at each use of a block.

**Layout.**  Every port parameter is placed by the spec of its JAX leaf
(`models.convert.jax_leaf_groups`): a pattern unit's parameters by the
stacked leaf [n_units, ...] and its spec, the others by their own shape.
Of each parameter the rank holds exactly the part its device holds of the
JAX leaf (`LeafPlace.block`): where the spec shards the unit axis (a
stacked vector [L, d] gets ('data', 'model') on a 2x2 mesh), a layer the
rank's block of units leaves out is held by other ranks only, and the
rank keeps an empty block of it.  AdamW's m and v, and the error-feedback
residual, are blocks of the same layout; so each rank's resident bytes
are its blocks' (`resident_bytes`, `expected_bytes`, which counts them
from the JAX leaves alone).

**Use.**  The step's activations are the rank's rows of the batch over the
'batch' axes (`rows`), full width at layer boundaries; ranks that differ
only in 'model' hold the same rows and compute the same values.  The model
code reaches each parameter through `use`, `linear` or `experts`:

- *gather at use* (`use`): the block all-gathered over the axes its spec
  names; its backward sums the ranks' gradients over the 'batch' axes in
  rank order (each has its rows' part) and keeps the rank's block: a
  reduce-scatter.
- *column-parallel product* (`linear`, for a [d_in, d_out] weight whose
  spec puts d_out on 'model' and d_in on the FSDP axes or nowhere): the
  d_in block gathered over the FSDP axes, the rank's output columns,
  all-gathered over 'model' in rank order.  Its backward sums dx over
  'model' and reduce-scatters dW over the FSDP axes.  Any other weight is
  gathered at use: embeddings on their fallback, vectors, routers, and
  experts outside expert parallelism.
- *expert parallelism* (`experts`, `copy_to_model`, `gather_from_model`):
  a 'model' rank's E/M experts gathered over the FSDP axes only; their
  slot inputs enter through `copy_to_model` (identity; backward: the sum
  over 'model'), their outputs leave through `gather_from_model`
  (all-gathered over 'model' in expert order; backward: the rank's
  slice).
- `batch_sum`: a statistic summed over the 'batch' axes in rank order
  (the MoE load balance, the loss's label count); its backward is the
  identity, since every rank's loss carries the whole statistic.

Every cross-rank sum adds the ranks' parts in rank order, in fp32, so that
the ranks of a group hold the same bits.  With no mesh bound
(`dist.sharding.use_mesh`) every helper is the plain expression it stands
for: the one-process path keeps its bits.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import sharding as shd

F32 = torch.float32


# ---------------------------------------------------------------------------
# where a parameter's block lies
# ---------------------------------------------------------------------------


class LeafPlace(NamedTuple):
    """A port parameter's place: the JAX leaf holding it (`path`, `spec`,
    stacked on [n_units] at `unit` or not) and its own shape `full`."""
    name: str
    path: str
    spec: tuple
    stacked: bool
    unit: int
    n_units: int
    full: Tuple[int, ...]

    @property
    def dims(self) -> tuple:
        """The spec entries of the parameter's own dimensions."""
        return self.spec[1:] if self.stacked else self.spec

    def block(self, mesh, coords) -> Optional[Tuple[range, ...]]:
        """The ranges of the parameter the device at `coords` holds, or
        None where its block of the leaf's units leaves this one out."""
        if self.stacked and self.unit not in shd.block_range(
                self.n_units, self.spec[0], mesh, coords):
            return None
        return tuple(shd.block_range(n, e, mesh, coords)
                     for n, e in zip(self.full, self.dims))

    def block_shape(self, mesh, coords) -> Tuple[int, ...]:
        """The block's shape; an empty block (0 along the first
        dimension) where the device's units leave this one out."""
        lens = tuple(len(shd.block_range(n, e, mesh, coords))
                     for n, e in zip(self.full, self.dims))
        return lens if self.block(mesh, coords) is not None else \
            (0,) + lens[1:]

    @property
    def T(self) -> "LeafPlace":
        """The place of the transpose of an unstacked 2-D parameter."""
        assert not self.stacked and len(self.full) == 2
        return self._replace(spec=self.spec[::-1], full=self.full[::-1])


def param_places(cfg, mesh) -> Dict[str, LeafPlace]:
    """Each port parameter's place under `mesh` (any object with a
    `.shape` of axis sizes: bound or not)."""
    from ..models import convert, lm
    shapes = {n: tuple(w.shape) for n, w in lm.LM(
        cfg, torch.device("meta")).named_parameters()}
    out = {}
    for leaf in convert.jax_leaf_groups(cfg):
        own = shapes[leaf.names[0]]
        shape = ((len(leaf.names),) + own) if leaf.stacked else own
        spec = shd.infer_param_spec(leaf.path, shape, mesh)
        for u, name in enumerate(leaf.names):
            out[name] = LeafPlace(name, leaf.path, spec, leaf.stacked, u,
                                  len(leaf.names), own)
    return out


def expected_bytes(cfg, mesh, coords, error_feedback: bool = False) -> int:
    """The bytes of the train state a device at `coords` holds, counted
    from the JAX leaves and their specs alone: each leaf's block (the
    product of its dimensions' block lengths) times its itemsize, for the
    parameters, m and v (fp32) and, if asked, the residual (fp32)."""
    from ..models import convert, lm
    meta = dict(lm.LM(cfg, torch.device("meta")).named_parameters())
    total = 0
    for leaf in convert.jax_leaf_groups(cfg):
        w = meta[leaf.names[0]]
        shape = ((len(leaf.names),) + tuple(w.shape)) if leaf.stacked \
            else tuple(w.shape)
        spec = shd.infer_param_spec(leaf.path, shape, mesh)
        n = math.prod(len(shd.block_range(d, e, mesh, coords))
                      for d, e in zip(shape, spec))
        per = w.element_size() + 8 + (4 if error_feedback else 0)
        total += n * per
    return total


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _group_for(axes, mesh) -> str:
    """The smallest of the mesh's axis sets ('batch', 'model', 'world')
    holding every axis of `axes`; 'self' where there is none."""
    axes = set(axes) & set(mesh.axis_names)
    if not axes:
        return "self"
    for name in ("batch", "model", "world"):
        if axes <= set(mesh.group_axes(name)):
            return name
    return "world"


def _slices(ranges, within=None) -> tuple:
    """Slices of `ranges`, relative to the ranges `within` start at."""
    if within is None:
        return tuple(slice(r.start, r.stop) for r in ranges)
    return tuple(slice(r.start - w.start, r.stop - w.start)
                 for r, w in zip(ranges, within))


def _sum_parts(parts, dtype) -> torch.Tensor:
    """The parts added in order, in fp32 (integers in their own type),
    cast to `dtype`."""
    wide = F32 if dtype.is_floating_point else dtype
    acc = parts[0].to(wide)
    for p in parts[1:]:
        acc = acc + p.to(wide)
    return acc.to(dtype)


def _gather(block: torch.Tensor, place: LeafPlace, mesh, group: str):
    """The block all-gathered over `group`: (the region its members hold
    together, as a tensor; that region's ranges).  Dimensions sharded over
    axes outside the group keep the rank's range."""
    members = (mesh.rank,) if group == "self" else mesh.group(group).ranks
    blocks = [place.block(mesh, mesh.coords_of(r)) for r in members]
    held = [b for b in blocks if b is not None]
    if not held:
        raise ValueError(f"{place.name}: no rank of the {group!r} group "
                         f"holds unit {place.unit}")
    covered = tuple(range(min(b[k].start for b in held),
                          max(b[k].stop for b in held))
                    for k in range(len(place.full)))
    if len(members) == 1:
        return block, covered
    sizes = [0 if b is None else math.prod(len(r) for r in b)
             for b in blocks]
    n = max(sizes)
    flat = block.reshape(-1)
    if flat.numel() < n:
        flat = torch.cat([flat, flat.new_zeros(n - flat.numel())])
    parts = mesh.wire.all_gather(flat, group=mesh.group(group).pg).wait()
    parts = parts.view(len(members), n)
    out = block.new_empty(tuple(len(r) for r in covered))
    for b, k, part in zip(blocks, sizes, parts):
        if b is not None:
            out[_slices(b, covered)] = part[:k].view(
                tuple(len(r) for r in b))
    return out, covered


def _reduce_to_block(g: torch.Tensor, place: LeafPlace, mesh, covered,
                     block_shape) -> torch.Tensor:
    """The rank's block of the sum over the 'batch' axes of each rank's
    `g` (over the ranges `covered`), added in rank order: an all-to-all
    of each peer's block, then the sum."""
    grp = mesh.group("batch")
    blocks = [place.block(mesh, mesh.coords_of(r)) for r in grp.ranks]
    mine = blocks[grp.ranks.index(mesh.rank)]
    if grp.size == 1:
        if mine is None:
            return g.new_zeros(block_shape)
        return g[_slices(mine, covered)].contiguous()
    sizes = [0 if b is None else math.prod(len(r) for r in b)
             for b in blocks]
    n = max(sizes)
    send = g.new_zeros((grp.size, n))
    for q, (b, k) in enumerate(zip(blocks, sizes)):
        if b is not None:
            send[q, :k] = g[_slices(b, covered)].reshape(-1)
    recv = mesh.wire.all_to_all(send, group=grp.pg)
    if mine is None:
        return g.new_zeros(block_shape)
    k = sizes[grp.ranks.index(mesh.rank)]
    return _sum_parts([recv[p, :k] for p in range(grp.size)],
                      g.dtype).view(block_shape)


def _over(x: torch.Tensor, mesh, group: str) -> list:
    """Every rank of `group`'s x, in rank order."""
    grp = mesh.group(group)
    if grp.size == 1:
        return [x]
    parts = mesh.wire.all_gather(x.contiguous().unsqueeze(0),
                                 group=grp.pg).wait()
    return list(parts.unbind(0))


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, place, mesh, group):
        full, covered = _gather(block, place, mesh, group)
        ctx.place, ctx.mesh, ctx.covered = place, mesh, covered
        ctx.block_shape = tuple(block.shape)
        return full if full is not block else block.view_as(block)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_to_block(g.contiguous(), ctx.place, ctx.mesh,
                                 ctx.covered, ctx.block_shape),
                None, None, None)


class _ColumnParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block, place, mesh):
        w, covered = _gather(block, place, mesh, _group_for(
            shd._entry_axes(place.dims[0]), mesh))
        y = x @ w
        parts = _over(y, mesh, "model")
        ctx.save_for_backward(x, w)
        ctx.place, ctx.mesh, ctx.covered = place, mesh, covered
        ctx.block_shape = tuple(block.shape)
        return torch.cat(parts, dim=-1) if len(parts) > 1 else y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cols = ctx.covered[1]
        g = g[..., cols.start:cols.stop]
        dx = _sum_parts(_over(g @ w.T, ctx.mesh, "model"), x.dtype)
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return (dx, _reduce_to_block(dw, ctx.place, ctx.mesh, ctx.covered,
                                     ctx.block_shape), None, None)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_parts(_over(g, ctx.mesh, "model"), g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, y.shape[dim]
        parts = _over(y, mesh, "model")
        return torch.cat(parts, dim=dim) if len(parts) > 1 else \
            y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        j = ctx.mesh.group("model").ranks.index(ctx.mesh.rank)
        return g.narrow(ctx.dim, j * ctx.n, ctx.n), None, None


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_parts(_over(x, mesh, "batch"), x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# what the model code calls
# ---------------------------------------------------------------------------


def _place_of(w) -> LeafPlace:
    place = getattr(w, "place", None)
    if place is None:
        raise ValueError("a mesh is bound, and this parameter was not "
                         "placed on it (`dist.lm_blocks.place`)")
    return place


def use(w: torch.Tensor) -> torch.Tensor:
    """The whole parameter for its use: `w` itself with no mesh bound,
    else its block gathered at use."""
    mesh = shd.get_mesh()
    if mesh is None:
        return w
    place = _place_of(w)
    return _GatherAtUse.apply(w, place, mesh, _group_for(
        shd.spec_axes(place.spec), mesh))


def _column_parallel(place: LeafPlace, mesh) -> bool:
    if len(place.full) != 2 or (place.stacked and place.spec[0]):
        return False
    d_in, d_out = (shd._entry_axes(e) for e in place.dims)
    return d_out == ("model",) and set(d_in) <= set(
        mesh.group_axes("batch"))


def linear(x: torch.Tensor, w: torch.Tensor, cast=None,
           transposed: bool = False) -> torch.Tensor:
    """x @ w (w cast to `cast` first, transposed if asked): with no mesh
    bound exactly that expression; over a mesh the column-parallel product
    where w's spec gives its pattern, else w gathered at use."""
    mesh = shd.get_mesh()
    if mesh is None:
        ww = w.T if transposed else w
        return x @ (ww if cast is None else ww.to(cast))
    place = _place_of(w)
    if transposed:
        place, w = place.T, w.t()
    if _column_parallel(place, mesh):
        return _ColumnParallel.apply(x, w if cast is None else w.to(cast),
                                     place, mesh)
    full = _GatherAtUse.apply(w, place, mesh, _group_for(
        shd.spec_axes(place.spec), mesh))
    return x @ (full if cast is None else full.to(cast))


def expert_parallel(n_experts: int) -> bool:
    """The JAX package's choice: experts over 'model' where E divides its
    size (`moe.py`: `E % axis_size("experts") == 0`); False with no mesh
    bound."""
    return shd.get_mesh() is not None and \
        n_experts % max(shd.axis_size("experts"), 1) == 0


def expert_range(n_experts: int) -> range:
    """The experts this rank's slot products run: all with no mesh bound
    or outside expert parallelism, else its E/M of them."""
    mesh = shd.get_mesh()
    if not expert_parallel(n_experts):
        return range(n_experts)
    return shd.block_range(n_experts, shd.LOGICAL_AXES["experts"], mesh,
                           mesh.coords)


def experts(w: torch.Tensor) -> torch.Tensor:
    """An expert weight [E, ...] for the rank's slot products: `w` with no
    mesh bound; under expert parallelism the rank's E/M experts, gathered
    over the FSDP axes only; otherwise gathered at use."""
    mesh = shd.get_mesh()
    if mesh is None:
        return w
    place = _place_of(w)
    if not expert_parallel(place.full[0]):
        return use(w)
    if shd._entry_axes(place.dims[0]) != ("model",):
        raise ValueError(
            f"{place.name}: expert parallelism over 'model', and the spec "
            f"{place.spec} does not shard the experts over it")
    rest = [a for e in place.dims[1:] for a in shd._entry_axes(e)]
    return _GatherAtUse.apply(w, place, mesh, _group_for(rest, mesh))


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x as the input of the rank's share of a 'model'-parallel region:
    the identity, whose backward sums the ranks' gradients over 'model'
    (no mesh: x)."""
    mesh = shd.get_mesh()
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def gather_from_model(y: torch.Tensor, dim: int) -> torch.Tensor:
    """The 'model' ranks' y concatenated along `dim` in rank order; its
    backward keeps the rank's part (no mesh: y)."""
    mesh = shd.get_mesh()
    return y if mesh is None else _GatherFromModel.apply(y, dim, mesh)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the 'batch' axes in rank order (no mesh: x); the
    backward passes the gradient to the rank's own x."""
    mesh = shd.get_mesh()
    return x if mesh is None else _BatchSum.apply(x, mesh)


def batch_ranks() -> int:
    """The ranks over the bound mesh's 'batch' axes (1 with no mesh): how
    many ranks' rows make the global batch."""
    mesh = shd.get_mesh()
    return 1 if mesh is None else mesh.group("batch").size


def rows(x: torch.Tensor, name: str, mesh) -> torch.Tensor:
    """The rank's rows of a global batch entry: its block under
    `infer_batch_spec`.  Raises where the rows do not divide over the
    'batch' axes' ranks (nothing runs replicated in their place)."""
    spec = shd.infer_batch_spec(name, tuple(x.shape), mesh)
    n = mesh.group("batch").size
    if n > 1 and (not spec or spec[0] is None):
        raise ValueError(f"{name}: {x.shape[0]} rows do not divide over "
                         f"the 'batch' axes' {n} ranks")
    r = shd.block_range(x.shape[0], spec[0] if spec else None, mesh,
                        mesh.coords)
    return x[r.start:r.stop]


# ---------------------------------------------------------------------------
# placing and gathering whole trees
# ---------------------------------------------------------------------------


def _block_of(full: torch.Tensor, place: LeafPlace, mesh) -> torch.Tensor:
    b = place.block(mesh, mesh.coords)
    if b is None:
        return torch.empty(place.block_shape(mesh, mesh.coords),
                           dtype=full.dtype, device=mesh.device)
    if full.is_meta:
        return torch.empty(tuple(len(r) for r in b), dtype=full.dtype,
                           device=mesh.device)
    return full.detach()[_slices(b)].to(mesh.device, copy=True) \
        .contiguous()


def place(obj, mesh):
    """The rank's blocks of an `LM` (its parameters replaced in place by
    their blocks, each carrying its `LeafPlace` as `.place`; returned) or
    of a whole `TrainState` (a new state over the placed parameters, m, v
    and the residual cut alike).  A parameter on the `meta` device gives
    an uninitialised block."""
    if hasattr(obj, "opt"):                       # a TrainState
        from ..optim import adamw
        params = place(obj.params, mesh)
        places = {n: w.place for n, w in params.named_parameters()}

        def sliced(d):
            if d is None:
                return None
            return {n: _block_of(t, places[n], mesh) for n, t in d.items()}
        return obj._replace(
            params=params,
            opt=adamw.AdamWState(step=obj.opt.step.to(mesh.device),
                                 m=sliced(obj.opt.m), v=sliced(obj.opt.v)),
            step=obj.step.to(mesh.device),
            ef_residual=sliced(obj.ef_residual))
    places = param_places(obj.cfg, mesh)
    for name, w in list(obj.named_parameters()):
        if hasattr(w, "place"):
            continue
        new = torch.nn.Parameter(_block_of(w, places[name], mesh),
                                 requires_grad=w.requires_grad)
        new.place = places[name]
        mod, _, attr = name.rpartition(".")
        setattr(obj.get_submodule(mod) if mod else obj, attr, new)
    obj.mesh = mesh
    return obj


def gather_tensor(block: torch.Tensor, place: LeafPlace, mesh
                  ) -> Optional[torch.Tensor]:
    """The whole parameter-shaped tensor from every rank's block, on the
    primary's CPU; None on the other ranks.  A collective of the job."""
    blocks = [place.block(mesh, mesh.coords_of(r)) for r in
              range(mesh.size)]
    sizes = [0 if b is None else math.prod(len(r) for r in b)
             for b in blocks]
    n = max(sizes)
    flat = block.reshape(-1)
    if flat.numel() < n:
        flat = torch.cat([flat, flat.new_zeros(n - flat.numel())])
    parts = mesh.wire.gather(flat)
    if parts is None:
        return None
    parts = parts.view(mesh.size, n)
    out = torch.empty(place.full, dtype=block.dtype)
    for b, k, part in zip(blocks, sizes, parts):
        if b is not None:
            out[_slices(b)] = part[:k].view(tuple(len(r) for r in b))
    return out


def gather(obj, mesh, like=None):
    """Whole leaves on the primary (None on the other ranks): of a placed
    `LM`, {name: parameter}; of a dict of blocks keyed by parameter names,
    laid out as the parameters of `like` (a placed `LM`)."""
    if isinstance(obj, torch.nn.Module):
        items = [(n, w.detach(), w.place) for n, w in obj.named_parameters()]
    else:
        places = {n: w.place for n, w in like.named_parameters()}
        items = [(n, t.detach(), places[n]) for n, t in obj.items()]
    out = {n: gather_tensor(t, p, mesh) for n, t, p in items}
    return out if mesh.rank == 0 else None


def resident_bytes(state) -> int:
    """The bytes of a (placed) train state's tensors on this rank: the
    parameters, m, v and the residual."""
    ts = [w for w in state.params.parameters()]
    ts += list(state.opt.m.values()) + list(state.opt.v.values())
    if state.ef_residual is not None:
        ts += list(state.ef_residual.values())
    return sum(t.numel() * t.element_size() for t in ts)


def replica_leader(place: LeafPlace, mesh) -> bool:
    """True on the one rank of each set of ranks holding the same block
    (their coordinates 0 on every axis the spec does not name): where a
    sum over the job counts each block once."""
    named = set(shd.spec_axes(place.spec))
    return all(v == 0 for a, v in mesh.coords.items() if a not in named)


def sum_over_job(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over every rank of the job in rank order (fp32)."""
    return _sum_parts(_over(x, mesh, "world"), x.dtype)


def cache_specs(cfg, batch: int, s_max: int, mesh) -> list:
    """The cache's leaves by the JAX package's `lm.init_cache` tree, in its
    leaf order: (path, the JAX leaf's shape, its `infer_cache_spec`, the
    port cache's keys of each layer's tensor it stacks: ('layers', k,
    'kv', 0), ...; ('pos',)).  A pattern unit's layers stack on a leading
    [n_units] axis, as the JAX tree's do."""
    from ..models import transformer
    from ..models.convert import _layer_key
    caches = transformer.init_caches(cfg, batch, s_max, torch.float32,
                                     torch.device("meta"))
    leaves: Dict[tuple, list] = {}

    def walk(x, keys, jax_keys, u):
        if isinstance(x, torch.Tensor):
            leaves.setdefault(jax_keys, []).append((u, keys, tuple(x.shape)))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, keys + (k,), jax_keys + (k,), u)
        else:
            for i, v in enumerate(x):
                walk(v, keys + (i,), jax_keys + (i,), u)

    for k, c in enumerate(caches):
        where = _layer_key(cfg, k)
        if where[0] == "units":
            walk(c, ("layers", k), ("layers", "units", where[1]), where[2])
        else:
            walk(c, ("layers", k), ("layers", "rem", where[1]), 0)
    leaves[("pos",)] = [(0, ("pos",), ())]
    out = []
    for jk, v in sorted(leaves.items()):
        stacked = "units" in jk[1:2]
        shape = ((len(v),) + v[0][2]) if stacked else v[0][2]
        path = shd.path_str(jk)
        out.append((path, shape, shd.infer_cache_spec(path, shape, mesh),
                    [keys for _, keys, _ in sorted(v)]))
    return out
