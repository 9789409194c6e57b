"""The chunk kernel's draw order and modulus arithmetic, on the CPU.

`csrc/stream.cu` draws a slot's lanes in order of need: lane 0 (the
ring) only where the candidate's ring set can reach the chunk's columns,
lane 1 (the member, so the column) only where the ring is in that set,
lane 2 only where the column lies in the chunk's column interval.  Its
plain model (`kernels.ref.chunk_prefilter`) must never reject a slot the
reference (`kernels.ref.chunk_tables`) keeps: checked over every chunk of
the three profiles, both placements and K = 1-3 on the SMALL and WIDE
grids (where wrap-around aliases offsets and rings onto one column), and
on candidates of an 8x8 full-width chunk, where the shares it passes are
reported.  A chunk's candidate rows ascend (the kernel's keys rely on
it).  The kernel's remainders and quotients come from host
constants (`kernels.ref.fastmod_table`, Lemire's exact 32-bit scheme):
checked against Python's % and // for every modulus these configurations
produce.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, GridConfig, connectivity
from repro_torch.core import stream_engine as SE
from repro_torch.kernels import ref

SMALL = dict(grid_x=2, grid_y=3, neurons_per_column=12,
             synapses_per_neuron=8, seed=7)
WIDE = dict(grid_x=2, grid_y=2, neurons_per_column=40,
            synapses_per_neuron=16, seed=7)
GRIDS = {"small": SMALL, "wide": WIDE}
PROFILES = ["ring3", "ring:max_ring=1", "gaussian:sigma=1.5"]
FULL_8X8 = GridConfig(grid_x=8, grid_y=8)
STRIDE_8X8 = 8      # every 8th candidate of the 8x8 chunk


def _source(cfg: GridConfig, eng: EngineConfig, chunk: int):
    """The chunk source of (cfg, eng, K = chunk) from the candidates
    alone (no synapse generated; e_start and row_cap are not read
    here)."""
    src_gid, cand = SE._candidates(cfg, eng, chunk)
    _, q, n_chunks = connectivity.stream_geometry(cfg, eng, chunk)
    e_start = torch.zeros((cand.shape[0], n_chunks + 1), dtype=torch.int32)
    return SE.make_chunk_source(cfg, eng, q, torch.from_numpy(src_gid),
                                torch.from_numpy(cand), e_start, 1)


def _check_stages(pf: ref.Prefilter) -> None:
    assert not (pf.keep & ~pf.lane1).any(), "lane 1 rejects a kept slot"
    assert not (pf.lane1 & ~pf.lane0).any(), "lane 1 passes what lane 0 drops"


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("placement", ["block", "scatter"])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_prefilter_never_rejects_a_kept_slot(grid, profile, placement,
                                             chunk):
    cfg = GridConfig(**GRIDS[grid], connectivity=profile)
    eng = EngineConfig(n_shards=2, placement=placement)
    source = _source(cfg, eng, chunk)
    kept = 0
    for c in range(source.geom.n_chunks):
        pf = ref.chunk_prefilter(source, c)
        _check_stages(pf)
        kept += int(pf.keep.sum())
    # every synapse of the network is kept in exactly one chunk
    assert kept == cfg.n_neurons * cfg.synapses_per_neuron


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("placement", ["block", "scatter"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_chunk_candidate_rows_ascend(grid, placement, chunk):
    """Within a chunk the candidates' source-table rows ascend with their
    position, so the kernel's key (row << jbits | j) orders a row's
    synapses as generation order does (position, then j)."""
    cfg = GridConfig(**GRIDS[grid])
    for h in (1, 2, 3):
        _, cand = SE._candidates(cfg, EngineConfig(n_shards=h,
                                                   placement=placement),
                                 chunk)
        for rows in cand.reshape(-1, cand.shape[-1]):
            live = rows[rows >= 0]
            assert (np.diff(live) > 0).all()
            assert (rows[live.shape[0]:] == -1).all()


def test_prefilter_shares_at_8x8():
    """The 8x8 full-width plan's interior chunk (K = 1, H = 1), every
    STRIDE_8X8-th candidate: the model passes about 8% of the excitatory
    slots after lane 0 (the paper's ring fractions over the 49 halo
    columns) and about 2.5% of all slots after lane 1 (the chunk's one
    column of 49, and the column's inhibitory sources)."""
    eng = EngineConfig(n_shards=1)
    _, q, n_chunks = connectivity.stream_geometry(FULL_8X8, eng, 1)
    c = n_chunks // 2
    table = connectivity.candidate_sources(FULL_8X8, eng, 0)
    gids = connectivity.chunk_candidates(FULL_8X8, eng, 0, c * q,
                                         (c + 1) * q)[::STRIDE_8X8]
    cand = np.full((1, n_chunks, gids.shape[0]), -1, dtype=np.int32)
    cand[0, c] = np.searchsorted(table, gids)
    source = SE.make_chunk_source(
        FULL_8X8, eng, q, torch.from_numpy(table[None].astype(np.int64)),
        torch.from_numpy(cand),
        torch.zeros((1, n_chunks + 1), dtype=torch.int32), 1)
    pf = ref.chunk_prefilter(source, c)
    _check_stages(pf)
    M = FULL_8X8.synapses_per_neuron
    exc = torch.from_numpy(gids % FULL_8X8.neurons_per_column
                           < FULL_8X8.n_exc_per_column)
    slots, exc_slots = gids.shape[0] * M, int(exc.sum()) * M
    shares = dict(
        lane0_of_exc=float(pf.lane0[0][exc].sum()) / exc_slots,
        lane1_of_exc=float(pf.lane1[0][exc].sum()) / exc_slots,
        lane0=float(pf.lane0.sum()) / slots,
        lane1=float(pf.lane1.sum()) / slots,
        kept=float(pf.keep.sum()) / slots)
    print("8x8 interior chunk, prefilter pass shares:", shares)
    assert 0.07 < shares["lane0_of_exc"] < 0.09
    assert 0.018 < shares["lane1_of_exc"] < 0.023
    assert 0.02 < shares["lane1"] < 0.03
    assert shares["kept"] <= shares["lane1"]


def _moduli():
    """Every modulus the kernel's fastmod table holds for the configs of
    this module and the 8x8 full width."""
    out = set()
    for grid in list(GRIDS.values()) + [dict(grid_x=8, grid_y=8)]:
        for profile in PROFILES:
            cfg = GridConfig(**grid, connectivity=profile)
            for h in (1, 2, 3, 4):
                source = SE.make_chunk_source(
                    cfg, EngineConfig(n_shards=h), 1,
                    torch.zeros((h, 1), dtype=torch.int64),
                    torch.zeros((h, 1, 1), dtype=torch.int32),
                    torch.zeros((h, 2), dtype=torch.int32), 1)
                out.update(source.fastmod[:, 0].tolist())
    return sorted(out)


MODULI = _moduli()


def _numerators(m: int, rng) -> np.ndarray:
    edge = [0, 1, m - 1, m, m + 1, 2 ** 32 - 1, 2 ** 32 - m]
    edge += [k << 16 for k in (1, 2, m % 65536, 65535)]
    edge += [(k << 16) - 1 for k in (1, 65535)]
    a = np.concatenate([np.asarray([e for e in edge if 0 <= e < 2 ** 32],
                                   dtype=np.uint64),
                        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)])
    return a


@pytest.mark.parametrize("m", MODULI)
def test_fastmod_constants_exact(m):
    rng = np.random.default_rng(m)
    (m_, r32, c), = ref.fastmod_table([m]).tolist()
    c &= (1 << 64) - 1
    assert m_ == m and r32 == (1 << 32) % m
    a = _numerators(m, rng)
    np.testing.assert_array_equal(ref.fastmod_u32(a, m, c), a % np.uint64(m))
    np.testing.assert_array_equal(ref.fastdiv_u32(a, c), a // np.uint64(m))
    x = rng.integers(0, 2 ** 63, 4096, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 4096, dtype=np.uint64)
    x = np.concatenate([x, np.asarray([0, m, 2 ** 64 - 1, 2 ** 32,
                                       2 ** 32 - 1, (2 ** 32) * m],
                                      dtype=np.uint64)])
    np.testing.assert_array_equal(ref.fastmod64(x, m, r32, c),
                                  x % np.uint64(m))


def test_fastmod_moduli_cover_the_configs():
    """The table's moduli include each config's npc, nexc, delay span, H
    and every ring's size (1 and 8 r), and nothing at or above 2^16."""
    assert {1, 2, 3, 4, 5, 8, 10, 12, 16, 24, 32, 40, 800, 1000} <= set(
        MODULI)
    assert max(MODULI) < 1 << 16
    with pytest.raises(ValueError):
        ref.fastmod_constants(1 << 16)
