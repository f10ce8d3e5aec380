"""The HO (CG2/dG1) solver on a rank grid's rdma schedule: the port against
the JAX package.

At float64 on the CPU, the same seeded numpy inputs go through the JAX
package's single-domain HO step ("xla") and through the port's HO solver
on ``nextsimdg_tpu_torch.parallel``'s rank grid with ``backend="rdma"``
(K7's 17-plane round, ``kernels.mevp_rdma_cuda``: the 17 state strips, the
interior pass on the rank's own block, the HO bands re-run and patched),
whose ranks are threads of this process: x strips on (4, 1), y strips on
(1, 4), the two-phase corner exchange on (2, 2), closed and periodic; the
graded and spherical views and the A-weighted form; the ring and a
periodic box whose periodic axis is not split over ranks (the interior
pass's periodic form, the other axis's bands wrapping along the band);
the coupled HO step with ``mevp_backend="rdma"``; and the plain HO band
against a plain run on the widened block.

Twins of ``tests/test_shardmap.py``'s
``test_ho_rdma_halo_exchange_matches_per_subcycle`` and
``test_ho_rdma_coupled_matches_single_device``, held against the JAX
package's single-device step (its own test holds its "rdma-interpret"
round to that step at 1e-12; the interpreted round is not run here: it
takes tens of seconds a case on the CPU). Where a periodic axis is not
split over ranks the JAX round's bands run on a closed shim mesh; the
port follows the single-device step there, as its CG1 round does.

Tolerances: exactly 0 between the port's rdma schedule, its blocked
schedule and its single domain (the same operations on the same values);
1e-8 of each plane's max against the JAX package after the subcycles and
1e-10 on a coupled step, as ``tests/test_torch_grid_ho.py`` and
``tests/test_torch_grid_ho_coupled.py`` hold theirs.
"""

import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.dynamics import RectMesh, mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.mesh import block_mesh
from test_torch_grid_ho import check, port_ho_step
from test_torch_grid_ho_coupled import check as check_coupled
from test_torch_grid_ho_coupled import port_coupled

torch.set_num_threads(1)

N_SUB = 11  # rounds of 4 + 4 + 3
H = 4


def assert_same(got, ref):
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r, err_msg=f"plane {i}")


@pytest.mark.parametrize("shape, kind", [
    ((4, 1), "uniform"),   # x strips
    ((1, 4), "uniform"),   # y strips
    ((2, 2), "uniform"),   # both, the corners through the extended y strips
    ((2, 2), "periodic"),  # the strips round the rings of ranks
])
def test_ho_rdma_halo_exchange_matches_per_subcycle(shape, kind):
    """11 subcycles in rounds of h = 4: the rdma schedule equals the blocked
    schedule and the single domain exactly, and JAX's single-device HO
    step within 1e-8."""
    got = port_ho_step(kind, N_SUB, backend="rdma", shape=shape, h=H)
    assert_same(got, port_ho_step(kind, N_SUB, backend="blocked", shape=shape, h=H))
    check(got, kind, N_SUB)


@pytest.mark.parametrize("kind, weighted", [("graded", False), ("spherical", False), ("graded", True)])
def test_ho_rdma_metric_and_weighted_forms_equal_blocked(kind, weighted):
    """The metric forms (graded and spherical ``LocalMeshView`` blocks: the
    four width planes widened with the other consts) and the A-weighted
    form (the four a_{k}) on 2 x 2 ranks."""
    got = port_ho_step(kind, N_SUB, weighted=weighted, backend="rdma", h=H)
    assert_same(got, port_ho_step(kind, N_SUB, weighted=weighted, backend="blocked", h=H))
    check(got, kind, N_SUB, weighted=weighted)


@pytest.mark.parametrize("kind, shape", [
    ("ring", (1, 2)),      # the ring's axis on one rank: the interior wraps, the y bands wrap along x
    ("ring", (2, 1)),      # a ring of two ranks, y on one rank
    ("periodic", (1, 2)),  # a periodic box, x on one rank
    ("periodic", (2, 1)),  # and y on one rank
])
def test_ho_rdma_unsplit_periodic_axis_equals_one_domain(kind, shape):
    """A periodic axis of one rank wraps inside the round (the interior
    pass's periodic form, the bands of the other axis along the band): the
    single domain exactly and JAX's single-device step within 1e-8."""
    check(port_ho_step(kind, N_SUB, backend="rdma", shape=shape, h=H), kind, N_SUB)


def test_ho_rdma_coupled_matches_single_device():
    """The coupled HO step with ``mevp_backend="rdma"`` on 2 x 2 ranks (n =
    16, h = 4, 10 subcycles): the blocked step exactly, the port's single
    domain exactly and JAX's single-device coupled step within 1e-10."""
    model, got = port_coupled("uniform", (2, 2), mevp_backend="rdma", mevp_block_halo=4)
    assert model.is_high_order and model.schedule("cpu") == ("rdma", "tiled")
    blocked = port_coupled("uniform", (2, 2), mevp_backend="blocked", mevp_block_halo=4)[1]
    for name, plane in got.items():
        np.testing.assert_array_equal(plane, blocked[name], err_msg=name)
    check_coupled(got, "uniform")


@pytest.mark.parametrize("axis", [0, 1])
def test_ho_plain_band_patches_what_the_widened_block_gives(axis):
    """The plain HO band (``rdma_band_reference`` on an ``MEVPSolverHO``) at
    n_sub = 3 < h = 4 patches exactly the rows (x, on a block split along
    x only) or columns (y, split along both, the corners from the extended
    y ghosts) that n_sub plain subcycles on the whole widened block give."""
    rng = np.random.default_rng(7)
    nx, ny, h, n_sub = 12, 10, H, 3
    split = (True, axis == 1)
    hx, hy = h, h * split[1]
    scale = torch.tensor([0.2] * 8 + [500.0] * 9, dtype=torch.float64)[:, None, None]
    wide = torch.from_numpy(rng.normal(0.0, 1.0, (17, nx + 2 * hx, ny + 2 * hy))) * scale
    own = wide[:, hx: hx + nx, hy: hy + ny].contiguous()
    src = rdma.RoundSources(
        own=tuple(own), h=h, split=split,
        gx=(wide[:, :hx, hy: hy + ny].contiguous(), wide[:, hx + nx:, hy: hy + ny].contiguous()),
    )
    if split[1]:
        src.gy = (wide[:, :, :hy].contiguous(), wide[:, :, hy + ny:].contiguous())
    mesh = RectMesh(nx, ny, 4e3, 4e3)
    solver = mevp_ho.MEVPSolverHO(mesh)
    consts_w = {name: torch.from_numpy(rng.uniform(0.1, 2.0, wide.shape[1:])) for name in solver.const_names()}
    consts_w["strength"] = consts_w["strength"] * 2e4
    state = torch.zeros_like(own)
    got = rdma.rdma_band_reference(solver, src, axis, consts_w, 600.0, n_sub, state)
    assert got is state
    whole = rdma.subcycles_reference(
        mevp_ho.MEVPSolverHO(block_mesh(nx + 2 * hx, ny + 2 * hy, mesh)), wide, consts_w, 600.0, n_sub,
    )[:, hx: hx + nx, hy: hy + ny]
    patch = (slice(None), slice(None), slice(0, h)) if axis else (slice(None), slice(0, h))
    far = (slice(None), slice(None), slice(ny - h, ny)) if axis else (slice(None), slice(nx - h, nx))
    for where in (patch, far):
        assert torch.equal(got[where], whole[where])
    inner = (slice(None), slice(None), slice(h, ny - h)) if axis else (slice(None), slice(h, nx - h))
    assert not got[inner].any()  # nothing else is written


def test_ho_rdma_solver_runs_the_round_and_refuses_what_it_does_not_take(monkeypatch):
    """``MEVPSolverHO(backend="rdma", spmd=...)`` builds, its schedule the
    rdma one and its inner solver without an exchange; a round of more
    than h subcycles, a block narrower than 2h and a source of another
    plane count raise."""
    from nextsimdg_tpu_torch.parallel import RankGrid

    grid = RankGrid(2, 2, "cpu")
    solver = mevp_ho.MEVPSolverHO(RectMesh(16, 16, 4e3, 4e3), backend="rdma", spmd=grid.ranks[0].axes)
    assert (solver.schedule(), solver.block_halo) == ("rdma", 8)
    local = solver.local()
    assert type(local) is mevp_ho.MEVPSolverHO and not local.on_rank_grid
    carry = torch.zeros((17, 16, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="subcycles"):
        rdma.mevp_round_rdma_reference(local, carry, {}, {}, 600.0, 9, 8, (None, None))
    with pytest.raises(ValueError, match="2h"):
        rdma.mevp_round_rdma_reference(local, carry, {}, {}, 600.0, 4, 9, (grid.ranks[0].axes[0], None))
    # On CUDA tensors (the CPU check patched to answer as for them) a
    # source of 6 planes raises before any launch.
    src = rdma.RoundSources(own=tuple(carry[:6]), h=4, split=(True, False))
    monkeypatch.setattr(cc, "_on_cpu", lambda t: False)
    with pytest.raises(ValueError, match="state planes"):
        rdma.rdma_stage(src, 0)
    with pytest.raises(ValueError, match="state planes"):
        rdma.rdma_band(local, src, 0, {k: None for k in local.const_names()}, 600.0, 4, carry)
