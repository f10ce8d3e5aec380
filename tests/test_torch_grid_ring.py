"""The rank grid on periodic axes, with TVB and the other physics: the port against the JAX package.

At float64 on the CPU, the same seeded numpy inputs go through the JAX
package (its single-domain step, and its ``shard_map`` programs on the
8-device CPU mesh of ``tests/conftest.py``, whose ``lax.ppermute`` over a
ring permutation is the periodic condition) and through
``nextsimdg_tpu_torch.parallel``, whose grid axes are rings where the
mesh's are periodic: the exchange forms of the stencil on rings of four,
two and one rank (the two-rank ring, whose two neighbours are one rank,
keeps its strips apart), the rank-aware ``boundary_mask``, the mEVP on the
360 degree ring and a periodic box on every schedule (the rdma round with
the ring's axis split and not split), the coupled step on the ring and on
periodic axes with the spmd tiled transport, ThermoWinton's 3 layers on
the grid, and TVB on the staged and the tiled spmd transport.

Tolerances as in ``test_torch_grid_metric.py``: exactly 0 between the
port's grid and its single domain, and between its schedules; 1e-8 of
each plane's max against the JAX package after many mEVP subcycles; 1e-10
on a coupled step; exact for the exchanges and masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics import stencil as jax_stencil
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.dynamics.mevp import MEVPSolver as JaxMEVPSolver
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu_torch.dynamics import RectMesh, stencil, synthetic_coastline
from nextsimdg_tpu_torch.dynamics.mevp import MEVPSolver
from nextsimdg_tpu_torch.parallel import RankGrid, run_ranks
from test_torch_grid_metric import (
    N, assert_states_close, assert_states_equal, check_mevp, jax_coupled, jax_mevp, mesh_of,
    port_block_mesh, port_coupled, port_mevp, port_single_coupled,
)

torch.set_num_threads(1)

TIMEOUT = 60.0


def seeded_plane(shape=(16, 16), seed=0):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape)


def ring_grid(shape, periodic):
    """A CPU rank grid of ``shape`` whose axes are rings where ``periodic``
    says, set as ``build_sharded_coupled_model`` sets them."""
    grid = RankGrid(*shape, "cpu", timeout=TIMEOUT)
    grid.periodic = periodic
    return grid


def on_port_ring(shape, fn, *arrays, periodic=(True, True)):
    """``fn(rank, *blocks)`` on every rank of a port grid of ``shape`` whose
    axes are rings where ``periodic`` says; the gathered result as numpy."""
    grid = ring_grid(shape, periodic)
    parts = [grid.split(torch.from_numpy(np.ascontiguousarray(a))) for a in arrays]
    out = run_ranks(grid.ring, lambda rank: fn(rank, *(p[rank.rank] for p in parts)))
    return grid.gather(out).numpy()


def on_jax_mesh(shape, fn, *arrays):
    spec = P("X", "Y")
    mapped = jax.shard_map(fn, mesh=make_spatial_mesh(shape), in_specs=(spec,) * len(arrays),
                           out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(mapped)(*(jnp.asarray(a) for a in arrays)))


# -- the exchange on a ring -----------------------------------------------------------
RING_CASES = {
    "shift_p": (lambda f, ax, s: s.shift_p(s.shift_p(f, 0, True, ax[0]), 1, True, ax[1])),
    "shift_m": (lambda f, ax, s: s.shift_m(s.shift_m(f, 0, True, ax[0]), 1, True, ax[1])),
    "halo_widen": (lambda f, ax, s: s.halo_widen(s.halo_widen(f, 2, 0, True, ax[0]), 2, 1, True, ax[1])),
}


@pytest.mark.parametrize("shape", [(4, 2), (2, 1), (1, 2), (1, 1)])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_exchange_forms_match_jax(case, shape):
    """On a ring of 4, 2 or 1 ranks an axis wraps round the ranks, as
    ``lax.ppermute`` over the JAX package's ring permutation does, and an
    axis of one rank is its own neighbour (exact)."""
    fn = RING_CASES[case]
    f = seeded_plane()
    ref = on_jax_mesh(shape, lambda x: fn(x, ("X", "Y"), jax_stencil), f)
    got = on_port_ring(shape, lambda rank, x: fn(x, rank.axes, stencil), f)
    np.testing.assert_array_equal(got, ref)
    if case != "halo_widen":  # on the whole domain: the periodic roll
        np.testing.assert_array_equal(got, np.asarray(fn(torch.from_numpy(f), (None, None), stencil)))


def test_a_two_rank_ring_keeps_its_two_strips_apart():
    """On a ring of two ranks both neighbours are the other rank: the strip
    sent to the -1 side and the one sent to the +1 side of one exchange
    reach it under their own sides (the mailbox key holds the side)."""

    def exchange(rank):
        axis = rank.axes[0]
        base = 10.0 * rank.rank
        handle = axis.start(torch.full((1,), base + 1.0), torch.full((1,), base + 2.0))
        from_prev, from_next = axis.wait(handle)
        return float(from_prev[0]), float(from_next[0])

    grid = ring_grid((2, 1), (True, False))
    # Rank r receives from its -1 neighbour that rank's to_next (base + 2)
    # and from its +1 neighbour that rank's to_prev (base + 1).
    assert run_ranks(grid.ring, exchange) == [(12.0, 11.0), (2.0, 1.0)]
    single = ring_grid((1, 1), (True, False))
    assert run_ranks(single.ring, exchange) == [(2.0, 1.0)]
    closed = RankGrid(2, 1, "cpu", timeout=TIMEOUT)
    assert run_ranks(closed.ring, exchange) == [(0.0, 11.0), (2.0, 0.0)]


def test_a_grid_takes_its_ring_once():
    """A grid is closed until its axes are set, and they are set once: the
    models built on it exchange through it, so a mesh with other periodic
    axes needs a grid of its own."""
    grid = RankGrid(2, 2, "cpu", timeout=TIMEOUT)
    assert grid.periodic == (False, False)
    assert [rank.neighbour(0, 1) for rank in grid.ranks] == [2, 3, None, None]
    grid.periodic = (True, False)
    grid.periodic = (True, False)
    assert [rank.neighbour(0, 1) for rank in grid.ranks] == [2, 3, 0, 1]
    with pytest.raises(ValueError, match="already periodic"):
        grid.periodic = (True, True)


@pytest.mark.parametrize("periodic", [(True, False), (True, True)])
def test_boundary_mask_on_a_ring_matches_jax(periodic):
    n, shape = 16, (4, 2)
    px, py = periodic
    local_jax = JaxRectMesh(nx=4, ny=8, dx=1e3, dy=1e3, periodic_x=px, periodic_y=py)
    solver = JaxMEVPSolver(local_jax, JaxMEVPParams(), spmd=("X", "Y"))
    ref = on_jax_mesh(shape, lambda x: x * solver.boundary_mask(jnp.float64), np.ones((n, n)))

    def mask(rank, x):
        mesh = RectMesh(4, 8, 1e3, 1e3, periodic_x=px, periodic_y=py)
        return x * MEVPSolver(mesh, spmd=rank.axes).boundary_mask(device="cpu", dtype=torch.float64)

    got = on_port_ring(shape, mask, np.ones((n, n)), periodic=periodic)
    np.testing.assert_array_equal(got, ref)
    assert got[:, 0].sum() == (n if py else 0) and got[0, 1:].sum() == n - 1


# -- the mEVP on rings ---------------------------------------------------------------
@pytest.mark.parametrize("backend, shape", [
    ("xla", (4, 2)), ("blocked", (4, 2)), ("rdma", (4, 1)), ("rdma", (1, 4)), ("rdma", (2, 2)),
])
def test_mevp_on_the_spherical_ring_matches_jax_and_one_domain(backend, shape):
    """The 360 degree ring (``test_shardmap_metric.py``'s ring templates):
    the metric views on a grid whose x axis is a ring; the rdma round with
    the ring's axis split (its ghosts come round the ranks) and not split
    (its interior pass and its y bands wrap)."""
    check_mevp(port_mevp("ring", 20, backend=backend, shape=shape), "ring", 20)


def test_rdma_ring_matches_jax_rdma_interpret():
    """The literal twin of the JAX ring rdma test: x strips on a 4 x 1
    device mesh, 11 subcycles (rounds of 4 + 4 + 3)."""
    ref = jax_mevp("ring", 11, backend="rdma-interpret", shape=(4, 1))
    check_mevp(port_mevp("ring", 11, backend="rdma", shape=(4, 1)), "ring", 11, jax_ref=ref)


@pytest.mark.parametrize("backend, shape", [
    ("blocked", (4, 2)), ("rdma", (2, 2)), ("rdma", (2, 1)), ("rdma", (1, 2)),
])
def test_mevp_on_a_periodic_box_matches_jax_and_one_domain(backend, shape):
    """Both axes periodic (``test_shardmap.py``'s periodic blocked and rdma
    templates): rings of 4, 2 and 1 rank."""
    check_mevp(port_mevp("periodic", 12, backend=backend, shape=shape), "periodic", 12)


def test_blocked_periodic_matches_jax_blocked():
    ref = jax_mevp("periodic", 12, backend="blocked", shape=(4, 2))
    check_mevp(port_mevp("periodic", 12, backend="blocked", shape=(4, 2)), "periodic", 12, jax_ref=ref)


# -- the coupled step -------------------------------------------------------------------
@pytest.mark.parametrize("backend, shape, coast", [
    ("blocked", (4, 2), False), ("blocked", (4, 2), True), ("rdma", (2, 2), True), ("rdma", (1, 2), True),
])
def test_coupled_step_on_the_ring_matches_jax_and_one_domain(backend, shape, coast):
    """The ring's coupled step on the blocked and rdma schedules with the
    spmd tiled transport; with the coastline its masks shift through the
    exchange."""
    model, got = port_coupled("ring", shape, coast=coast, mevp_backend=backend, mevp_block_halo=4)
    assert model.schedule("cpu") == (backend, "tiled")
    assert_states_equal(got, port_single_coupled("ring", coast=coast))
    assert_states_close(got, jax_coupled("ring", (4, 2), coast=coast), 1e-10)
    if coast:
        land = synthetic_coastline(N) == 0.0
        assert np.all(got["velocity"]["u"][land] == 0.0)


def test_coupled_step_on_the_ring_matches_jax_blocked_and_tiled_interpret():
    """The literal twin of the JAX ring coupled test on its blocked inner
    kernel and tiled transport."""
    _, got = port_coupled("ring", (4, 2), mevp_backend="blocked", mevp_block_halo=4)
    ref = jax_coupled("ring", (4, 2), mevp_backend="blocked-interpret", mevp_block_halo=4,
                      transport_backend="tiled-interpret")
    assert_states_close(got, ref, 1e-10)


@pytest.mark.parametrize("transport", ["tiled", "xla"])
def test_coupled_step_on_periodic_axes_matches_jax_sharded(transport):
    """``test_shardmap.py``'s periodic step (its default schedules) and its
    tiled transport on periodic axes."""
    model, got = port_coupled("periodic", (4, 2), mevp_backend="blocked" if transport == "tiled" else "xla",
                              mevp_block_halo=4, transport_backend=transport)
    assert model.transport_schedule() == transport
    assert_states_equal(got, port_single_coupled("periodic"))
    assert_states_close(got, jax_coupled("periodic", (4, 2)), 1e-10)


def test_thermo_winton_with_three_layers_on_a_grid_matches_jax():
    """ThermoWinton's (3, nx, ny) ice temperatures split and gathered over
    the ranks, selected through both registries (reset after)."""
    registry = ("Nextsim::IThermodynamics", "Nextsim::ThermoWinton")
    model, got = port_coupled("uniform", (4, 2), registry=registry, nlayers=3, mevp_block_halo=4)
    assert got["tice"].shape == (3, N, N)
    assert_states_close(got, jax_coupled("uniform", (4, 2), registry=registry, nlayers=3), 1e-10)
    assert not np.allclose(got["tice"], -5.0)


@pytest.mark.parametrize("kind, tvb_m, transport", [
    ("uniform", 50.0, "xla"), ("uniform", 50.0, "tiled"), ("uniform", 0.0, "tiled"),
    ("periodic", 50.0, "tiled"),
])
def test_tvb_on_a_grid_matches_jax_and_one_domain(kind, tvb_m, transport):
    """TVB on the staged spmd transport (the limiter's neighbour means
    through the exchange, walls only at the global walls) and on the spmd
    tiled one (the global walls inside the widened block: the wall-delta
    masks), against the single domain and JAX's staged sharded step."""
    shape = (2, 2) if transport == "tiled" else (4, 2)
    model, got = port_coupled(kind, shape, tvb_m=tvb_m, mevp_block_halo=4, transport_backend=transport)
    assert model.transport_schedule() == transport
    assert_states_equal(got, port_single_coupled(kind, tvb_m=tvb_m))
    assert_states_close(got, jax_coupled(kind, (4, 2), tvb_m=tvb_m), 1e-10)


def test_tiled_tvb_on_a_grid_matches_jax_tiled_interpret():
    """The literal twin of the JAX spmd tiled TVB test: its wall-delta mask
    planes in the tiled transport (interpret mode) on a 2 x 2 mesh."""
    _, got = port_coupled("uniform", (2, 2), tvb_m=50.0, mevp_block_halo=4, transport_backend="tiled")
    ref = jax_coupled("uniform", (2, 2), tvb_m=50.0, transport_backend="tiled-interpret",
                      mevp_backend="blocked-interpret", mevp_block_halo=4)
    assert_states_close(got, ref, 1e-10)


def test_blocks_of_a_ring_are_rect_meshes_with_the_global_axes():
    grid = RankGrid(2, 2, "cpu")
    from nextsimdg_tpu_torch.parallel import build_sharded_coupled_model

    model, sharded = build_sharded_coupled_model(mesh_of("periodic", N), grid, n_subcycles=2)
    assert grid.periodic == (True, True)
    assert (model.mesh.periodic_x, model.mesh.periodic_y, model.mesh.uniform) == (True, True, True)
    with pytest.raises(ValueError, match="already periodic"):
        build_sharded_coupled_model(mesh_of("ring", N), grid, n_subcycles=2)
    grid = RankGrid(2, 2, "cpu")
    model, _ = build_sharded_coupled_model(mesh_of("ring", N), grid, n_subcycles=2)
    assert grid.periodic == (True, False) and model.mesh.is_local_view
    view = port_block_mesh(mesh_of("ring", N), (2, 2), (1, 0))
    assert (view.periodic_x, view.periodic_y, view.coords) == (True, False, (1, 0))
