"""The port's LM sharding rules against the JAX package's, without devices.

For each of the ten architectures at full `CONFIG` on five meshes
((16, 16), (2, 16, 16), (2, 2), (2, 4), (4, 1)) the port's spec of every
parameter leaf (by `models.convert.jax_leaf_groups`' paths and stacked
shapes), of every m / v leaf, of every `init_cache` leaf and of every
batch entry equals `repro.dist.sharding`'s `infer_*_spec` on a
`jax.sharding.AbstractMesh`; shapes come from the `meta` device on the
port's side and `jax.eval_shape` on JAX's.  The MoE archs' expert
parallelism is chosen alike on each mesh.

Each port parameter's block (`dist.lm_blocks.LeafPlace.block`, with the
stacked vectors whose unit axis is sharded and the 'rem' leaves) equals
the block its JAX leaf's `NamedSharding.devices_indices_map` gives the
device at the same row-major position, and the state bytes a device holds
(`lm_blocks.expected_bytes`) equal the sum of its JAX shards' shapes: one
subprocess with 512 forced host devices, every device of the small meshes
and 16 of each production mesh.
"""
import functools
import json
import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.dist import sharding as jshd
from repro.launch import input_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import lm_blocks as blk
from repro_torch.dist import sharding as shd
from repro_torch.dist.mesh import LmMesh, make_production_mesh
from repro_torch.models import convert

sys.path.insert(0, os.path.dirname(__file__))
from _mp_helpers import run_with_devices  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
#: (batch, s_max) of the caches compared: FSDP-divisible, and one row
CACHES = ((32, 1024), (1, 2048))
#: (B, T) of the batches compared
BATCHES = ((32, 128), (3, 16))
MOE_ARCHS = tuple(a for a in ARCH_IDS if get_config(a).moe is not None)
#: devices checked on the production meshes (all on the small ones)
SAMPLED = 16


def _meshes(key):
    shape, axes = MESHES[key]
    return AbstractMesh(shape, axes), LmMesh(axes, shape)


def _spec(p) -> tuple:
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _jax_state(arch, key):
    am, _ = _meshes(key)
    return input_specs.abstract_train_state(jax_config(arch), am)


def _jax_leaves(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jshd._path_str(kp), tuple(x.shape), _spec(x.sharding.spec))
            for kp, x in leaves]


def _port_param_leaves(arch, pm):
    cfg = get_config(arch)
    places = blk.param_places(cfg, pm)
    out = []
    for leaf in convert.jax_leaf_groups(cfg):
        p = places[leaf.names[0]]
        shape = ((p.n_units,) + p.full) if p.stacked else p.full
        out.append((leaf.path, shape, p.spec))
    return out


def test_production_mesh_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, key):
    state = _jax_state(arch, key)
    want = _jax_leaves(state.params)
    got = _port_param_leaves(arch, _meshes(key)[1])
    assert got == want


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_specs_equal_jax(arch, key):
    """m and v are blocks of the parameters' layout in the port; JAX's
    inherit the parameters' shardings."""
    state = _jax_state(arch, key)
    got = [(p, s, spec) for p, s, spec in
           _port_param_leaves(arch, _meshes(key)[1])]
    for tree in (state.opt.m, state.opt.v):
        assert got == _jax_leaves(tree)
        assert all(x.dtype == np.float32 for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_jax(arch, key):
    am, pm = _meshes(key)
    for batch, s_max in CACHES:
        want = _jax_leaves(input_specs.abstract_cache(jax_config(arch), batch,
                                                      s_max, am))
        got = [(p, s, spec) for p, s, spec, _ in blk.cache_specs(
            get_config(arch), batch, s_max, pm)]
        assert got == want, (batch, s_max)


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_jax(arch, key):
    am, pm = _meshes(key)
    d = get_config(arch).d_model
    for B, T in BATCHES:
        for name, shape in (("tokens", (B, T)), ("labels", (B, T)),
                            ("embeds", (B, T, d)),
                            ("enc_embeds", (B, max(T // 2, 8), d))):
            assert shd.infer_batch_spec(name, shape, pm) == _spec(
                jshd.infer_batch_spec(name, shape, am)), (name, shape)


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_choice_equals_jax(arch, key):
    am, pm = _meshes(key)
    E = get_config(arch).moe.n_experts
    with jshd.use_mesh(am):
        want = E % max(jshd.axis_size("experts"), 1) == 0
    assert not blk.expert_parallel(E)           # no mesh bound
    with shd.use_mesh(pm):
        assert blk.expert_parallel(E) == want


@pytest.mark.parametrize("key", MESHES)
def test_greedy_entry_and_axis_size_equal_jax(key):
    am, pm = _meshes(key)
    for dim in (1, 2, 3, 4, 8, 16, 32, 48, 64, 512, 49155):
        for logical in ("batch", "data", "model", "experts", "seq", None):
            assert shd._greedy_entry(dim, logical, pm) == \
                jshd._greedy_entry(dim, logical, am), (dim, logical)
    with jshd.use_mesh(am), shd.use_mesh(pm):
        for logical in shd.LOGICAL_AXES:
            assert shd.axis_size(logical) == jshd.axis_size(logical)
    assert shd.get_mesh() is None and shd.axis_size("batch") == 1


# ---------------------------------------------------------------------------
# blocks against NamedSharding on concrete (forced host) devices
# ---------------------------------------------------------------------------

_BLOCKS_CODE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_lm_sharding_rules as T
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import lm_blocks as blk
from repro_torch.models import convert
from repro.configs import get_config as jax_config
from repro.models import lm as jlm
out = {{}}
devs = jax.devices()
for key, (shape, axes) in T.MESHES.items():
    n = int(np.prod(shape))
    mesh = Mesh(np.array(devs[:n]).reshape(shape), axes)
    _, pm = T._meshes(key)
    ranks = range(n) if n <= 16 else sorted(set(
        np.linspace(0, n - 1, T.SAMPLED).astype(int).tolist()))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        places = blk.param_places(cfg, pm)
        checked, bad, jax_bytes = 0, [], {{r: 0 for r in ranks}}
        jleaves = jax.tree.leaves(jax.eval_shape(
            lambda key: jlm.init_params(jax_config(arch), key),
            jax.random.key(0)))
        for k, leaf in enumerate(convert.jax_leaf_groups(cfg)):
            p0 = places[leaf.names[0]]
            full = ((p0.n_units,) + p0.full) if p0.stacked else p0.full
            sh = NamedSharding(mesh, P(*p0.spec))
            idx = sh.devices_indices_map(full)
            item = jleaves[k].dtype.itemsize
            assert tuple(jleaves[k].shape) == full, (leaf.path, full)
            for r in ranks:
                d = mesh.devices.flat[r]
                sl = [range(*s.indices(m)) for s, m in zip(idx[d], full)]
                jax_bytes[r] += int(np.prod([len(x) for x in sl])) * (item + 8)
                c = pm.coords_of(r)
                for name in leaf.names:
                    p = places[name]
                    got = p.block(pm, c)
                    if p.stacked:
                        want = None if p.unit not in sl[0] else tuple(sl[1:])
                    else:
                        want = tuple(sl)
                    checked += 1
                    if got != want:
                        bad.append([name, r, str(got), str(want)])
        byte_bad = [[r, blk.expected_bytes(cfg, pm, pm.coords_of(r)), b]
                    for r, b in jax_bytes.items()
                    if blk.expected_bytes(cfg, pm, pm.coords_of(r)) != b]
        out[f"{{arch}}|{{key}}"] = dict(checked=checked, bad=bad[:5],
                                       n_bad=len(bad), devices=len(ranks),
                                       bytes_bad=byte_bad[:5])
print("BLOCKS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_blocks():
    code = _BLOCKS_CODE.format(tests=os.path.dirname(os.path.abspath(
        __file__)))
    out = run_with_devices(code, 512, timeout=600)
    line = [x for x in out.splitlines() if x.startswith("BLOCKS ")][-1]
    return json.loads(line[len("BLOCKS "):])


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_blocks_equal_jax_shards(jax_blocks, arch, key):
    r = jax_blocks[f"{arch}|{key}"]
    assert r["checked"] > 0 and r["devices"] > 0
    assert r["n_bad"] == 0, r["bad"]
    assert not r["bytes_bad"], r["bytes_bad"]


def test_stacked_vectors_shard_their_unit_axis():
    """A stacked vector [L, d] gets ('data', 'model') at 2x2 for granite:
    layer u's gains live on the data rank whose units hold u only, and the
    others keep an empty block of it."""
    _, pm = _meshes("2x2")
    cfg = get_config("granite-moe-3b-a800m")
    p = blk.param_places(cfg, pm)["stack.layers.0.norm1"]
    assert p.spec == ("data", "model") and p.stacked
    owners = [r for r in range(4) if p.block(pm, pm.coords_of(r))]
    assert owners == [0, 1]
    assert p.block_shape(pm, pm.coords_of(2)) == (0,)
    assert p.block_shape(pm, pm.coords_of(0)) == (cfg.d_model // 2,)
    q = blk.param_places(cfg, pm)["stack.layers.31.norm1"]
    assert [r for r in range(4) if q.block(pm, pm.coords_of(r))] == [2, 3]
