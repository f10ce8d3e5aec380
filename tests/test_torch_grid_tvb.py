"""TVB and the staged transport on a rank grid: the port against the JAX package.

At float64 on the CPU, the same seeded numpy inputs go through the JAX
package's single-domain coupled step and through the port's
``build_sharded_coupled_model``, whose ranks are threads of this process:

* the HO (CG2/dG1) solver with the TVB limiter on a uniform grid, closed
  and periodic in both axes, on the blocked and the rdma schedules, with
  the spmd tiled transport (the CG2 samples and the global walls inside
  the widened block) and with the staged route;
* the HO solver with TVB on the spherical window with the coastline, and
  CG1 and HO with TVB on the 360 degree ring (1 x 2 ranks, x not split),
  whose transport is the staged route (``coupled_cuda.spmd_staged_transport``:
  psi widened by one ring a stage, the halo forms of ``dg1_rk_stage`` and
  ``dg1_limit``, here their plain versions);
* ``transport_backend="xla"`` on a uniform grid (the positivity-only halo
  stage).

And the plain halo forms alone: on every block of a 3 x 3 grid (an
interior block, and each wall side), ``dg1_rk_stage_halo_reference`` and
``dg1_limit_halo_reference`` on the block widened by one ring equal the
single domain's stage and limiter restricted to the block, on graded,
spherical and ring meshes with a coastline, with the CG1 velocity and the
quadrature samples.

Tolerances: exactly 0 between the port's grid and its single domain (the
same operations on the same values; a wall face's flux is a zeroed mask
times the flux here, a zeroed flux there, which differ at most in the sign
of a zero); 1e-10 of each plane's max against the JAX package on a coupled
step, as the JAX templates (``tests/test_shardmap.py``'s TVB staged and
tiled tests) hold theirs.
"""

import numpy as np
import pytest
import torch

import test_torch_grid_ho_coupled as ho
import test_torch_grid_metric as cg1
from test_torch_kernels import widened_block
from nextsimdg_tpu_torch import modules
from nextsimdg_tpu_torch.dynamics import synthetic_coastline
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.transport import DGTransport, QuadVelocity, face_masks_from_land
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model

torch.set_num_threads(1)



def tvb_m(kind: str, n: int = ho.N) -> float:
    """The TVB constant M of mesh ``kind`` at n x n: its tolerance M dx^2 is
    0.1 at the median element width, the seeded slopes' size, so that the
    limiter cuts some slopes and keeps others (one significant digit)."""
    width = float(np.median(np.broadcast_to(np.asarray(ho.mesh_of(kind, n).dx, dtype=float), (n, n))))
    return float(f"{0.1 / width**2:.0e}")



# -- the HO solver with TVB -------------------------------------------------------------
@pytest.mark.parametrize("kind, mevp, transport", [
    ("uniform", "rdma", "tiled"), ("periodic", "blocked", "tiled"),
    ("uniform", "blocked", "xla"), ("periodic", "blocked", "xla"),
])
def test_ho_tvb_on_a_uniform_grid_matches_jax_and_one_domain(kind, mevp, transport):
    """The HO grid with TVB on a uniform mesh, closed or a ring of ranks on
    both axes: the spmd tiled transport with the widened samples and the
    walls by index, or the staged route."""
    model, got = ho.port_coupled(kind, (2, 2), mevp_backend=mevp, mevp_block_halo=4, tvb_m=tvb_m(kind),
                                 transport_backend=transport)
    assert model.schedule("cpu") == (mevp, transport)
    ho.check(got, kind, tvb_m=tvb_m(kind))


def test_ho_tvb_on_a_spherical_grid_runs_staged_and_matches_jax():
    """The HO spherical window with the coastline and TVB: the staged route
    with the widened samples, metric planes and the block's tolerance
    planes."""
    model, got = ho.port_coupled("spherical", (2, 2), coast=True, mevp_block_halo=4, tvb_m=tvb_m("spherical"))
    assert model.schedule("cpu") == ("blocked", "xla")
    ho.check(got, "spherical", coast=True, tvb_m=tvb_m("spherical"))


def test_ho_tvb_on_the_ring_matches_jax_and_one_domain():
    """The HO 360 degree ring with the coastline and TVB on 1 x 2 ranks: x
    is not split, so the ring's wrap reaches the ghost ring through the
    one-rank ring of the exchange."""
    model, got = ho.port_coupled("ring", (1, 2), coast=True, mevp_block_halo=4, tvb_m=tvb_m("ring"))
    assert model.schedule("cpu") == ("blocked", "xla")
    ho.check(got, "ring", coast=True, tvb_m=tvb_m("ring"))


# -- CG1 -----------------------------------------------------------------------------------
def test_tvb_on_the_ring_matches_jax_and_one_domain():
    """CG1 on the ring with the coastline and TVB, 1 x 2 ranks."""
    m = tvb_m("ring")
    model, got = cg1.port_coupled("ring", (1, 2), coast=True, tvb_m=m, mevp_block_halo=4)
    assert model.schedule("cpu") == ("blocked", "xla")
    cg1.assert_states_equal(got, cg1.port_coupled("ring", coast=True, tvb_m=m)[1])
    cg1.assert_states_close(got, cg1.jax_coupled("ring", coast=True, tvb_m=m), 1e-10)


@pytest.mark.parametrize("with_tvb", [False, True])
def test_staged_transport_on_a_uniform_grid_matches_jax_and_one_domain(with_tvb):
    """``transport_backend="xla"`` on a uniform 2 x 2 grid: the halo stage
    positivity-limited, and with TVB unlimited with the halo limiter (the
    tolerances two scalars)."""
    m = tvb_m("uniform") if with_tvb else None
    model, got = cg1.port_coupled("uniform", (2, 2), transport_backend="xla", mevp_block_halo=4, tvb_m=m)
    assert model.schedule("cpu") == ("blocked", "xla")
    cg1.assert_states_equal(got, cg1.port_coupled("uniform", tvb_m=m)[1])
    cg1.assert_states_close(got, cg1.jax_coupled("uniform", tvb_m=m), 1e-10)


# -- the plain halo forms on a widened block --------------------------------------------
GRID = (3, 3)
NB = 24  # the global mesh: 3 x 3 blocks of 8 x 8


@pytest.mark.parametrize("velocity", ["cg1", "qv"])
@pytest.mark.parametrize("kind, coast", [("graded", False), ("graded", True), ("spherical", True), ("ring", False)])
def test_halo_forms_equal_the_single_domain_on_each_block(kind, coast, velocity):
    """On each block of a 3 x 3 grid: the positivity-limited halo stage
    (a == 0), the TVB form's blended unlimited stage and the halo limiter
    on the block widened by one ring, against the single domain's stage and
    limiter restricted to the block, exactly; with the coastline's face
    masks, or open faces (ones: only the walls close a face)."""
    mesh = cg1.mesh_of(kind, NB)
    periodic = (mesh.periodic_x, mesh.periodic_y)
    grid = RankGrid(*GRID, "cpu")
    ocean = synthetic_coastline(NB) if coast else np.ones((NB, NB))
    m = tvb_m(kind, NB)
    _, sharded = build_sharded_coupled_model(mesh, grid, n_subcycles=2, ocean_mask=ocean, tvb_m=m)
    single = DGTransport(mesh, tvb_m=m)
    rng = np.random.default_rng(7)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    shape = (NB, NB)
    psi = t(np.concatenate([rng.uniform(0.2, 2.0, (1, 3, *shape)), rng.normal(0.0, 0.4, (2, 3, *shape))]))
    base = t(np.concatenate([rng.uniform(0.2, 2.0, (1, 3, *shape)), rng.normal(0.0, 0.4, (2, 3, *shape))]))
    fx, fy = face_masks_from_land(t(ocean), *periodic) if coast else (torch.ones(shape, dtype=torch.float64),) * 2
    u = v = qv = None
    if velocity == "cg1":
        u, v = t(rng.normal(0.0, 0.3, shape)), t(rng.normal(0.0, 0.3, shape))
    else:
        qv = QuadVelocity(*(t(rng.normal(0.0, 0.3, (n, *shape))) for n in (4, 4, 2, 2)))
    dt = 2000.0
    stages = {
        "limited": cc.dg1_rk_stage_reference(single, psi, base, u, v, fx, fy, 0.0, 1.0, dt, qv=qv),
        "tvb": cc.dg1_rk_stage_reference(single, psi, base, u, v, fx, fy, 0.5, 0.5, dt, qv=qv, tvb=True),
    }
    limited = single.limit(stages["tvb"])
    cut = single.limit_slopes(stages["tvb"])[1:] != stages["tvb"][1:]
    assert 0.05 < float(cut.double().mean()) < 0.95  # TVB cuts some slopes, keeps others
    bx, by = NB // GRID[0], NB // GRID[1]
    walls_seen = set()
    for rank, model in zip(grid.ranks, sharded.models):
        ix, iy = rank.coords
        own = (Ellipsis, slice(ix * bx, (ix + 1) * bx), slice(iy * by, (iy + 1) * by))
        wide = lambda f: widened_block(f, rank.coords, (bx, by), periodic)
        walls = tt.spmd_walls(model, 1)
        walls_seen |= {side for side, w in zip(("fwd_x", "bwd_x", "fwd_y", "bwd_y"), walls) if w >= 0}
        local = model.widened_transport(1)
        metric = model.widened_metric(1, device="cpu", dtype=torch.float64)
        qv_w = None if qv is None else QuadVelocity(*(wide(f) for f in (qv.vx_vol, qv.vy_vol, qv.vn_x, qv.vn_y)))
        u_w, v_w = (None, None) if u is None else (wide(u), wide(v))
        for name, (a, b) in {"limited": (0.0, 1.0), "tvb": (0.5, 0.5)}.items():
            got = cc.dg1_rk_stage_halo_reference(
                local, wide(psi), base[own], u_w, v_w, wide(fx), wide(fy), walls, a, b, dt, qv=qv_w,
                metric=metric, tvb=name == "tvb",
            )
            assert torch.equal(got, stages[name][own]), (name, rank.coords)
        stage = stages["tvb"]
        got = cc.dg1_limit_halo_reference(model.transport, stage[own], wide(stage[0]), walls)
        assert torch.equal(got, limited[own]), rank.coords
    # Every wall side on a closed axis, and none on the ring's x axis.
    assert walls_seen == ({"fwd_y", "bwd_y"} if kind == "ring" else {"fwd_x", "bwd_x", "fwd_y", "bwd_y"})


def test_qv_walls_form_fits_the_card_at_the_paths_shapes():
    """The spmd transport's TVB form in the qv form: at the exchange width
    of rk2 with TVB (H = 16, three substeps a launch) a launch fits the
    H100's shared memory at every substep count on the 1024^2 path's 512^2
    blocks and on small ones; the CG2 samples stay in global memory, so
    the window holds the coefficients only."""
    loader = modules.get_loader()
    loader.set_implementation(*ho.HO)
    try:
        grid = RankGrid(2, 2, "cpu")
        model, _ = build_sharded_coupled_model(ho.mesh_of("uniform", 1024), grid, n_subcycles=2, tvb_m=0.0)
    finally:
        loader.reset()
    assert tt.transport_tiled_spmd_config(model) == (16, 3)
    tr = model.transport
    for n in (512, 96):
        elements = (n + 32) ** 2
        for k in (1, 2, 3):
            halo = tt.tvb_halo(k, tt.rings_per_substep(tr), True, 3, elements, 3, 2)
            assert (halo - 1) // tt.rings_per_substep(tr) >= min(k, 3) or halo == tt.rings_per_substep(tr) + 1
            group = tt.window_tracers(halo, True, 3, elements, 3, 2)
            config = tt.launch_config(halo, True, group, elements, 3, 2)
            n_bytes = tt.shared_bytes(config.tile, halo, group, config.buffers, True, 3, 2)
            assert n_bytes <= tt.SHARED_LIMIT and config.tile >= 16, (n, k, config)
            assert n_bytes < tt.shared_bytes(config.tile, halo, group, config.buffers, False, 3, 2)
