"""The HO edge band's launch geometry (``mevp_rdma_cuda.HoBandConfig``,
``HO_BANDS``, ``launch_config``) and the HO kernels' cached host packing
(``coupled_cuda._ho_scalars``, ``_ho_tables``), on the CPU.

The kernel (``csrc/mevp_rdma_ho.cuh``) runs clusters of ``along`` x
``across`` blocks: block (x, y) of cluster c of band z owns the rows x
seg cells at window index x seg along the band and y rows across it, and
writes the patch cells of its window's interior. ``_patch_writes``
replays that arithmetic in numpy, as the kernel computes it, and counts the
writes each patch cell gets."""

import weakref

import numpy as np
import pytest

from nextsimdg_tpu_torch.benchmarks import mevp_large
from nextsimdg_tpu_torch.dynamics import mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.mesh import RectMesh
from nextsimdg_tpu_torch.dynamics.mevp import MEVPParams

HO_CONST_COUNTS = (29, 33, 37)  # closed, A-weighted or metric, metric A-weighted


def _patch_writes(config, axis, h, nx, ny, ring):
    """Writes per patch cell of one band (the lo band: both take the same
    geometry) by the kernel's blocks: (counts over the patch, the blocks
    that hold no band cell across)."""
    hx = 0 if ring and axis == 1 else h
    rows, cols = rdma.band_shape(axis, h, nx, ny, hx)
    along_n, across_n = (cols, rows) if axis == 0 else (rows, cols)
    (pr0, prn), (pc0, pcn) = ((h, h), (0, ny)) if axis == 0 else ((hx, nx), (h, h))
    n_sub, seg, r = h, config.seg, config.rows(h)
    w = config.along * seg
    counts = np.zeros((prn, pcn), dtype=int)
    empty = 0
    l, c = np.meshgrid(np.arange(seg), np.arange(r), indexing="ij")  # along, across within a block
    for cluster in range(config.clusters(along_n, n_sub)):
        for bx in range(config.along):
            own0 = cluster * (w - 2 * n_sub) - n_sub + bx * seg
            for by in range(config.across):
                a, x = own0 + l, by * r + c
                empty += int(by * r >= across_n)
                i, j = (x, a) if axis == 0 else (a, x)
                keep = ((i >= pr0) & (i < pr0 + prn) & (j >= pc0) & (j < pc0 + pcn)
                        & (bx * seg + l >= n_sub) & (bx * seg + l < w - n_sub))
                np.add.at(counts, (i[keep] - pr0, j[keep] - pc0), 1)
    return counts, empty


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("h", [8, 16, 32, 64])
@pytest.mark.parametrize("axis", [0, 1])
def test_shipped_ho_band_geometry_writes_every_patch_cell_once(axis, h, n, ring):
    """The launch the host picks for the bands of a 512^2 or 2048^2 rank
    block at h = 8 to 64 (closed, or wrapping along the band) writes every
    patch cell from exactly one block of exactly one cluster, and every
    block of a cluster holds a cell of the band across."""
    hx = 0 if ring and axis == 1 else h
    along = rdma.band_shape(axis, h, n, n, hx)[1 - axis]
    config = rdma.launch_config(axis, rdma.HO_PLANES, h, along)
    counts, empty = _patch_writes(config, axis, h, n, n, ring)
    assert counts.min() == 1 and counts.max() == 1 and empty == 0


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("config", mevp_large.HO_RDMA_BAND_CONFIGS, ids=str)
def test_swept_ho_band_geometries_write_every_patch_cell_once(config, axis):
    """So does every configuration of the sweep that fits the 512^2 block
    at the smallest ghost width it takes of 16, 32 and 64."""
    h = next((h for h in (16, 32, 64) if _fits(config, axis, h)), None)
    assert h is not None
    counts, empty = _patch_writes(config, axis, h, 512, 512, False)
    assert counts.min() == 1 and counts.max() == 1 and empty == 0


def _fits(config, axis, h, n_consts=rdma.HO_MAX_CONSTS):
    try:
        config.check(axis, h, h, n_consts)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("n_consts", HO_CONST_COUNTS)
def test_shipped_ho_band_configs_fit_the_cards_shared_memory_for_every_form(n_consts):
    """Each ``HO_BANDS`` row's configuration fits the card's 227 KB a block
    at every ghost width it takes, for every form's const count (29, 33,
    37), with the 17 state planes; its staged consts would not fit above
    h = 32, where the L2 row takes over."""
    for h_max, _, config in rdma.HO_BANDS:
        for h in range(1, h_max + 1):
            for axis in (0, 1):
                assert config.shared_bytes(h, axis, n_consts) <= rdma.MAX_SHARED_BYTES
                config.check(axis, h, h, n_consts)
    staged = [c for h_max, _, c in rdma.HO_BANDS if c.staged]
    assert staged and all(h_max <= 32 for h_max, _, c in rdma.HO_BANDS if c.staged)
    assert not rdma.HO_BANDS[-1][2].staged and rdma.HO_BANDS[-1][0] == rdma.MAX_SUB
    for config in staged:  # h = 64: the staged planes of any shipped block shape overflow
        assert config.shared_bytes(64, 0, n_consts) > rdma.MAX_SHARED_BYTES or not _fits(config, 0, 64, n_consts)


def test_ho_band_config_limits_match_the_kernel():
    """``HoBandConfig.check`` refuses what ``rdma_band_ho_valid`` and the
    card refuse: more than 16 blocks a cluster, more blocks across than
    the band has cells or a block across with none, threads beyond 384
    (256 with L2 consts) or not a multiple of 32, no window interior along the band, too much
    shared memory; ``rows`` and ``shared_bytes`` are the kernel's."""
    ok = rdma.HoBandConfig(8, 2, 14, 384)
    ok.check(0, 16, 16)
    assert ok.rows(16) == 24 and ok.cluster == 16
    assert ok.shared_bytes(16) == (17 + 37) * 26 * 16 * 4
    assert ok.shared_bytes(16, 1, 29) == (17 + 29) * 26 * 16 * 4
    assert rdma.HoBandConfig(8, 2, 14, 256, staged=False).shared_bytes(16) == 17 * 26 * 16 * 4
    assert rdma.HoBandConfig(3, 5, 8, 32).rows(8) == 5  # 24 cells: 5, 5, 5, 5, 4
    assert ok.cells_per_thread(16) == 1 and rdma.HoBandConfig(8, 2, 20, 256).cells_per_thread(16) == 2
    for bad, h in (
        (rdma.HoBandConfig(4, 5, 8, 64), 8),  # 20 blocks
        (rdma.HoBandConfig(2, 25, 8, 64), 8),  # 25 blocks across 24 cells
        (rdma.HoBandConfig(1, 7, 40, 64), 2),  # 6 cells over 7 blocks
        (rdma.HoBandConfig(1, 5, 40, 64), 2),  # 6 cells, 2 a block: the fourth block holds none
        (rdma.HoBandConfig(2, 2, 8, 512), 8),
        (rdma.HoBandConfig(2, 2, 8, 288, staged=False), 8),
        (rdma.HoBandConfig(2, 2, 8, 100), 8),
        (rdma.HoBandConfig(2, 2, 8, 64), 8),  # a window of 16 cells, all ring at n_sub = 8
        (rdma.HoBandConfig(1, 1, 200, 256), 8),  # 1.1 MB of shared memory
        (rdma.HoBandConfig(4, 4, 32, 384), 64),  # staged at h = 64
    ):
        with pytest.raises(ValueError):
            bad.check(0, h, h)


def test_launch_config_picks_per_ghost_width_and_block_size():
    """``launch_config`` takes the first ``HO_BANDS`` row that holds the
    ghost width and the band's length, for both axes; the CG1 form keeps
    its ``BANDS``."""
    for axis in (0, 1):
        for h in (1, 8, 16, 17, 32, 33, 64):
            for along in (32 * h, 512 + 2 * h, 2048, 2048 + 2 * h, 4096):
                row = next(c for h_max, a_min, c in rdma.HO_BANDS if h <= h_max and along >= a_min)
                assert rdma.launch_config(axis, rdma.HO_PLANES, h, along) == row
        assert rdma.launch_config(axis) == rdma.BANDS
    by_block = {n: rdma.launch_config(0, rdma.HO_PLANES, 16, n) for n in (512, 2048)}
    rows_16 = [(a_min, c) for h_max, a_min, c in rdma.HO_BANDS if h_max == 16]
    if len(rows_16) > 1:  # a size threshold at h = 16: the two blocks take different rows
        assert by_block[512] != by_block[2048]


def _same_as_fresh(packed, pack, *args) -> bool:
    """Whether ``packed`` holds what ``pack(*args)`` packs on empty caches
    (the NaN widths of a metric mesh equal)."""
    saved, saved_of = dict(cc._HO_PACKED), cc._HO_TABLES_OF
    cc._HO_PACKED.clear()
    cc._HO_TABLES_OF = weakref.WeakKeyDictionary()
    try:
        fresh = pack(*args)
        assert fresh is not packed
        return np.array_equal(np.array(list(packed)), np.array(list(fresh)), equal_nan=True)
    finally:
        cc._HO_PACKED.clear()
        cc._HO_PACKED.update(saved)
        cc._HO_TABLES_OF = saved_of


def test_ho_packers_cache_on_the_values_that_define_them():
    """``_ho_scalars`` and ``_ho_tables`` return one packed array per set of
    values: a new solver with the same params, widths and dt (a round's
    band solver) gets the same array, which holds what a fresh packing
    holds; another dt, width, parameter or a metric mesh gets another."""
    mesh = RectMesh(16, 16, 4e3, 4e3)
    solver = mevp_ho.MEVPSolverHO(mesh)
    scalars, tables = cc._ho_scalars(solver, 600.0), cc._ho_tables(solver)
    again = mevp_ho.MEVPSolverHO(RectMesh(16, 16, 4e3, 4e3, periodic_x=True))
    assert cc._ho_scalars(again, 600.0) is scalars and cc._ho_tables(again) is tables
    assert _same_as_fresh(scalars, cc._ho_scalars, solver, 600.0)
    assert _same_as_fresh(tables, cc._ho_tables, solver)
    cases = [
        (mevp_ho.MEVPSolverHO(mesh), 300.0),
        (mevp_ho.MEVPSolverHO(RectMesh(16, 16, 2e3, 4e3)), 600.0),
        (mevp_ho.MEVPSolverHO(mesh, MEVPParams(alpha=500.0)), 600.0),
        (mevp_ho.MEVPSolverHO(RectMesh(16, 16, np.linspace(3e3, 5e3, 16), 4e3)), 600.0),
    ]
    others = [cc._ho_scalars(s, dt) for s, dt in cases]
    assert len({id(o) for o in [scalars, *others]}) == 1 + len(others)
    for other, case in zip(others, cases):
        assert _same_as_fresh(other, cc._ho_scalars, *case)
    assert list(others[0])[-1] == 300.0 and list(others[0])[:-1] == list(scalars)[:-1]
    assert np.isnan(list(others[3])[:4]).all()


def test_ho_band_consts_are_checked_and_packed_once_per_dict():
    """The HO band's const pointers come from the rank thread's last dict
    while it holds the same planes (a step's rounds), and are checked and
    packed anew for another dict or a replaced plane; a dict of the wrong
    consts or shape raises."""
    import torch

    solver = mevp_ho.MEVPSolverHO(RectMesh(8, 8, 4e3, 4e3))
    shape, device = (12, 8), torch.device("cpu")
    consts = {name: torch.zeros(shape) for name in solver.const_names()}
    ptrs = rdma._ho_band_consts(solver, consts, shape, device)
    assert rdma._ho_band_consts(solver, consts, shape, device) is ptrs
    assert ptrs[0] == consts["strength"].data_ptr()
    other = dict(consts)
    assert rdma._ho_band_consts(solver, other, shape, device) is not ptrs
    other["strength"] = torch.ones(shape)
    assert rdma._ho_band_consts(solver, other, shape, device)[0] == other["strength"].data_ptr()
    with pytest.raises(ValueError):
        rdma._ho_band_consts(solver, consts, (10, 8), device)
    with pytest.raises(NotImplementedError):
        rdma._ho_band_consts(solver, {k: v for k, v in consts.items() if k != "strength"}, shape, device)
