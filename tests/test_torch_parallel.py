"""The decomposed coupled step on a rank grid: the port against the JAX package.

At float64 on the CPU, the same numpy inputs go through the JAX package's
``shard_map`` programs on the 8-device CPU mesh of ``tests/conftest.py``
and through ``nextsimdg_tpu_torch.parallel``, whose rank blocks are
threads of this process exchanging halos in memory: the exchange forms of
``shift_p``/``shift_m``, ``halo_widen`` and ``is_global_edge`` (exact),
the rank-aware ``boundary_mask`` (exact), the blocked mEVP exchange against
JAX's ``"blocked"`` and the port's single-domain solver, the plain rdma
round (K7's plain version) against JAX's ``"rdma-interpret"``, the spmd
tiled transport against JAX's ``"tiled-interpret"``, and the coupled step
with physics, with and without a coastline, on the blocked and rdma
schedules, against JAX's sharded step. Also: indivisible grids, a failing
or hung rank (every rank stops within its time limit), and what raises.
Tolerances: exact where the same operations run on the same values (the
exchanges, masks, and the port's schedules against each other, to 1e-12
of the plane's max); 1e-12 for the rdma round against JAX's, as JAX's own
test holds it; 1e-8 of the plane's max where JAX's XLA programs fuse the
mEVP subcycles differently (the shared divide amplifies an ulp), and 1e-10
for the coupled step, as ``tests/test_shardmap.py`` holds JAX's.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics import stencil as jax_stencil
from nextsimdg_tpu.dynamics.landmask import synthetic_coastline as jax_synthetic_coastline
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing as JaxDynamicsForcing
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.dynamics.mevp import MEVPSolver as JaxMEVPSolver
from nextsimdg_tpu.dynamics.mevp import VelocityState as JaxVelocityState
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu.parallel import sharding as jax_sharding
from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model as jax_build_sharded
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, stencil, synthetic_coastline
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, MEVPSolver, VelocityState
from nextsimdg_tpu_torch.parallel import (
    RankAborted, RankGrid, build_sharded_coupled_model, pick_mesh_shape, run_ranks,
)

torch.set_num_threads(1)

DT = 600.0
VELOCITY = ("u", "v", "s11", "s22", "s12")
TRACERS = ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice")
#: Seconds a rank waits for a neighbour before the grid counts as hung.
TIMEOUT = 30.0


def assert_planes_close(got, ref, rtol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def on_port_grid(shape, fn, *arrays, timeout=TIMEOUT):
    """``fn(rank, *blocks)`` on every rank of a port grid of ``shape`` (the
    blocks of the global numpy ``arrays``); the gathered result as numpy."""
    grid = RankGrid(*shape, "cpu", timeout=timeout)
    parts = [grid.split(torch.from_numpy(np.ascontiguousarray(a))) for a in arrays]
    out = run_ranks(grid.ring, lambda rank: fn(rank, *(p[rank.rank] for p in parts)))
    if isinstance(out[0], tuple):
        return tuple(grid.gather([o[k] for o in out]).numpy() for k in range(len(out[0])))
    return grid.gather(out).numpy()


def on_jax_mesh(shape, fn, *arrays, spmd=("X", "Y")):
    """``fn(*blocks)`` under ``shard_map`` on a device mesh of ``shape``."""
    spec = P(*spmd)
    mapped = jax.shard_map(
        fn, mesh=make_spatial_mesh(shape), in_specs=(spec,) * len(arrays), out_specs=spec,
        check_vma=False,
    )
    return jax.tree.map(np.asarray, jax.jit(mapped)(*(jnp.asarray(a) for a in arrays)))


def seeded_plane(shape=(16, 16), seed=0):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape)


# -- the exchange forms of the stencil --------------------------------------------
STENCIL_CASES = {
    "shift_p x": (lambda f, ax: jax_stencil.shift_p(f, 0, False, ax[0]),
                  lambda f, ax: stencil.shift_p(f, 0, False, ax[0])),
    "shift_p y": (lambda f, ax: jax_stencil.shift_p(f, 1, False, ax[1]),
                  lambda f, ax: stencil.shift_p(f, 1, False, ax[1])),
    "shift_m x": (lambda f, ax: jax_stencil.shift_m(f, 0, False, ax[0]),
                  lambda f, ax: stencil.shift_m(f, 0, False, ax[0])),
    "shift_m y": (lambda f, ax: jax_stencil.shift_m(f, 1, False, ax[1]),
                  lambda f, ax: stencil.shift_m(f, 1, False, ax[1])),
    # The widened blocks are gathered as they are: the global result stacks
    # them, strips and corners included.
    "halo_widen x": (lambda f, ax: jax_stencil.halo_widen(f, 2, 0, False, ax[0]),
                     lambda f, ax: stencil.halo_widen(f, 2, 0, False, ax[0])),
    "halo_widen y": (lambda f, ax: jax_stencil.halo_widen(f, 3, 1, False, ax[1]),
                     lambda f, ax: stencil.halo_widen(f, 3, 1, False, ax[1])),
    "halo_widen xy": (
        lambda f, ax: jax_stencil.halo_widen(jax_stencil.halo_widen(f, 3, 0, False, ax[0]), 3, 1, False, ax[1]),
        lambda f, ax: stencil.halo_widen(stencil.halo_widen(f, 3, 0, False, ax[0]), 3, 1, False, ax[1]),
    ),
}


@pytest.mark.parametrize("case", list(STENCIL_CASES))
def test_exchange_forms_match_jax_on_a_4x2_grid(case):
    jax_fn, port_fn = STENCIL_CASES[case]
    f = seeded_plane()
    ref = on_jax_mesh((4, 2), lambda x: jax_fn(x, ("X", "Y")), f)
    got = on_port_grid((4, 2), lambda rank, x: port_fn(x, rank.axes), f)
    np.testing.assert_array_equal(got, ref)


def test_exchange_forms_without_an_exchange_act_on_the_whole_domain():
    f = torch.from_numpy(seeded_plane())
    for axis in (0, 1):
        np.testing.assert_array_equal(
            stencil.halo_widen(f, 2, axis, False).numpy(),
            np.asarray(jax_stencil.halo_widen(jnp.asarray(f.numpy()), 2, axis, False)),
        )
        np.testing.assert_array_equal(
            stencil.halo_widen(f, 2, axis, True).numpy(),
            np.asarray(jax_stencil.halo_widen(jnp.asarray(f.numpy()), 2, axis, True)),
        )
    assert stencil.is_global_edge("first") and stencil.is_global_edge("last")
    with pytest.raises(ValueError, match="wider"):
        stencil.halo_widen(f, 17, 0, False)


def test_is_global_edge_reads_the_rank_coordinates():
    def edges(rank):
        return [stencil.is_global_edge(side, ax) for ax in rank.axes for side in ("first", "last")]

    grid = RankGrid(4, 2, "cpu", timeout=TIMEOUT)
    got = run_ranks(grid.ring, edges)
    for rank, flags in zip(grid.ranks, got):
        ix, iy = rank.coords
        assert flags == [ix == 0, ix == 3, iy == 0, iy == 1]


@pytest.mark.parametrize("shape", [(4, 2), (1, 4), (4, 1), (2, 2)])
def test_boundary_mask_pins_only_the_global_walls(shape):
    n = 16
    px, py = shape
    spmd = ("X" if px > 1 else None, "Y" if py > 1 else None)
    local = JaxRectMesh(nx=n // px, ny=n // py, dx=4e3, dy=4e3)
    jax_solver = JaxMEVPSolver(local, JaxMEVPParams(), spmd=spmd)
    ref = on_jax_mesh(shape, lambda x: x * jax_solver.boundary_mask(jnp.float64), np.ones((n, n)), spmd=spmd)

    def mask(rank, x):
        solver = MEVPSolver(RectMesh(n // px, n // py, 4e3, 4e3), spmd=rank.axes)
        return x * solver.boundary_mask(device="cpu", dtype=torch.float64)

    got = on_port_grid(shape, mask, np.ones((n, n)))
    np.testing.assert_array_equal(got, ref)
    expected = np.ones((n, n))
    expected[0, :] = expected[:, 0] = 0.0
    np.testing.assert_array_equal(got, expected)


# -- the mEVP exchange schedules ----------------------------------------------------
def mevp_inputs(n=32, seed=0):
    """Global numpy planes: a moving state, h, a and a sheared forcing."""
    rng = np.random.default_rng(seed)
    planes = {k: rng.normal(0.0, s, (n, n)) for k, s in zip(VELOCITY, (0.2, 0.2, 500.0, 500.0, 200.0))}
    planes["h"] = rng.uniform(0.5, 2.5, (n, n))
    planes["a"] = rng.uniform(0.4, 1.0, (n, n))
    planes["u_atm"] = 10.0 + rng.normal(0.0, 1.0, (n, n))
    planes["v_atm"] = np.full((n, n), 3.0)
    planes["u_ocean"] = np.full((n, n), 0.02)
    planes["v_ocean"] = rng.normal(0.0, 0.01, (n, n))
    return planes


FORCING = ("u_atm", "v_atm", "u_ocean", "v_ocean")
MEVP_INPUTS = VELOCITY + ("h", "a") + FORCING


def jax_mevp_step(shape, backend, n_subcycles, block_halo=None, n=32, spmd=("X", "Y")):
    planes = mevp_inputs(n)
    px, py = shape
    if backend == "single":
        solver = JaxMEVPSolver(JaxRectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n), JaxMEVPParams(), backend="xla")
        state = JaxVelocityState(*(jnp.asarray(planes[k]) for k in VELOCITY))
        forcing = JaxDynamicsForcing(*(jnp.asarray(planes[k]) for k in FORCING))
        out = solver.step(state, jnp.asarray(planes["h"]), jnp.asarray(planes["a"]), forcing,
                          solver.boundary_mask(jnp.float64), DT, n_subcycles)
        return tuple(np.asarray(x) for x in out)
    local = JaxRectMesh(nx=n // px, ny=n // py, dx=512e3 / n, dy=512e3 / n)
    kwargs = {} if block_halo is None else {"block_halo": block_halo}
    solver = JaxMEVPSolver(local, JaxMEVPParams(), backend=backend, spmd=spmd, **kwargs)

    def step(u, v, s11, s22, s12, h, a, ua, va, uo, vo):
        out = solver.step(JaxVelocityState(u, v, s11, s22, s12), h, a, JaxDynamicsForcing(ua, va, uo, vo),
                          solver.boundary_mask(jnp.float64), DT, n_subcycles)
        return tuple(getattr(out, k) for k in VELOCITY)

    return on_jax_mesh(shape, step, *(planes[k] for k in MEVP_INPUTS), spmd=spmd)


def port_mevp_step(shape, backend, n_subcycles, block_halo=4, n=32):
    planes = mevp_inputs(n)
    px, py = shape
    if backend == "single":
        solver = MEVPSolver(RectMesh(n, n, 512e3 / n, 512e3 / n))
        t = lambda k: torch.from_numpy(planes[k])
        out = solver.step(VelocityState(*(t(k) for k in VELOCITY)), t("h"), t("a"),
                          DynamicsForcing(*(t(k) for k in FORCING)),
                          solver.boundary_mask(device="cpu", dtype=torch.float64), DT, n_subcycles)
        return tuple(getattr(out, k).numpy() for k in VELOCITY)

    def step(rank, u, v, s11, s22, s12, h, a, ua, va, uo, vo):
        solver = MEVPSolver(RectMesh(n // px, n // py, 512e3 / n, 512e3 / n), backend=backend,
                            spmd=rank.axes, block_halo=block_halo)
        out = solver.step(VelocityState(u, v, s11, s22, s12), h, a, DynamicsForcing(ua, va, uo, vo),
                          solver.boundary_mask(device="cpu", dtype=torch.float64), DT, n_subcycles)
        return tuple(getattr(out, k) for k in VELOCITY)

    return on_port_grid(shape, step, *(planes[k] for k in MEVP_INPUTS))


@functools.lru_cache(maxsize=None)
def port_single_mevp(n_subcycles):
    return port_mevp_step((1, 1), "single", n_subcycles)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_blocked_mevp_matches_jax_blocked_and_the_single_domain_solver(shape):
    ref = jax_mevp_step(shape, "blocked", 11, block_halo=4)
    got = port_mevp_step(shape, "blocked", 11)
    for name, g, r, s in zip(VELOCITY, got, ref, port_single_mevp(11)):
        assert_planes_close(g, r, 1e-8, name)
        assert_planes_close(g, s, 1e-12, name)


@pytest.mark.parametrize("backend, halo", [("xla", 4), ("blocked", 7), ("rdma", 3)])
def test_every_port_schedule_matches_the_single_domain_solver(backend, halo):
    got = port_mevp_step((4, 2), backend, 11, block_halo=halo)
    for name, g, s in zip(VELOCITY, got, port_single_mevp(11)):
        assert_planes_close(g, s, 1e-12, name)


@pytest.mark.parametrize("shape, spmd", [((4, 1), ("X", None)), ((1, 4), (None, "Y")), ((4, 2), ("X", "Y"))])
def test_plain_rdma_round_matches_jax_rdma_interpret(shape, spmd):
    ref = jax_mevp_step(shape, "rdma-interpret", 11, block_halo=4, spmd=spmd)
    got = port_mevp_step(shape, "rdma", 11)  # rounds of 4 + 4 + 3
    for name, g, r in zip(VELOCITY, got, ref):
        assert_planes_close(g, r, 1e-12, name)


def test_rdma_round_limits_raise():
    with pytest.raises(ValueError, match="at least 2h"):
        port_mevp_step((4, 2), "rdma", 3, block_halo=3, n=16)  # blocks of 4 x 8
    with pytest.raises(ValueError, match="block_halo"):
        MEVPSolver(RectMesh(8, 8, 1e3, 1e3), backend="rdma", spmd=RankGrid(2, 2, "cpu").ranks[0].axes,
                   block_halo=9)


# -- the coupled step -----------------------------------------------------------------
N = 16


def coupled_inputs(seed=0):
    """A global CoupledState, physics forcing and dynamics forcing as numpy."""
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([rng.uniform(lo, hi, (1, N, N)), rng.normal(0.0, 0.05 * hi, (2, N, N))])
    state = dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.3, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=np.full((N, N), -1.6), sss=np.full((N, N), 32.0), tice=np.full((1, N, N), -1.0),
        new_ice=np.zeros((N, N)),
        velocity={k: rng.normal(0.0, s, (N, N)) for k, s in zip(VELOCITY, (0.3, 0.3, 500.0, 500.0, 200.0))},
    )
    full = lambda v: np.full((N, N), v)
    phys = dict(tair=-10.0 + rng.normal(0.0, 1.0, (N, N)), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    dyn = dict(u_atm=8.0 + rng.normal(0.0, 1.0, (N, N)), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    return state, phys, dyn


def to_jax(state, phys, dyn):
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    velocity = JaxVelocityState(**{k: j(state["velocity"][k]) for k in VELOCITY})
    return (
        JaxCoupledState(velocity=velocity, **{k: j(v) for k, v in state.items() if k != "velocity"}),
        JaxForcing(**{k: j(v) for k, v in phys.items()}),
        JaxDynamicsForcing(**{k: j(v) for k, v in dyn.items()}),
    )


def jax_mesh():
    return JaxRectMesh(nx=N, ny=N, dx=512e3 / N, dy=512e3 / N)


@functools.lru_cache(maxsize=None)
def jax_sharded_step(coast: bool, shape=(2, 2), **kwargs):
    """JAX's sharded coupled step on the seeded inputs, as numpy leaves."""
    kwargs = kwargs or dict(mevp_backend="rdma-interpret", mevp_block_halo=4)
    ocean = jax_synthetic_coastline(N) if coast else None
    _, step = jax_build_sharded(
        jax_mesh(), make_spatial_mesh(shape), degree=1, n_subcycles=10, ocean_mask=ocean, **kwargs
    )
    return interop.coupled_state_to_numpy(step(*to_jax(*coupled_inputs()), DT))


def port_sharded_step(coast: bool, shape=(2, 2), n_steps=1, **kwargs):
    state, phys, dyn = coupled_inputs()
    grid = RankGrid(*shape, "cpu", timeout=TIMEOUT)
    ocean = synthetic_coastline(N) if coast else None
    model, sharded = build_sharded_coupled_model(
        RectMesh(N, N, 512e3 / N, 512e3 / N), grid, n_subcycles=10, ocean_mask=ocean, **kwargs
    )
    blocks = sharded.run_blocks(
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float64),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float64),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float64),
        DT, n_steps,
    )
    return model, interop.coupled_state_from_rank_blocks(blocks, grid)


def assert_states_close(got, ref, rtol):
    for name in TRACERS:
        assert_planes_close(got[name], ref[name], rtol, name)
    for name in VELOCITY:
        assert_planes_close(got["velocity"][name], ref["velocity"][name], rtol, name)


@pytest.mark.parametrize("coast", [False, True])
@pytest.mark.parametrize("backend", ["rdma", "blocked"])
def test_coupled_step_matches_jax_sharded_rdma_step(backend, coast):
    model, got = port_sharded_step(coast, mevp_backend=backend, mevp_block_halo=4)
    assert (model.mevp_schedule(), model.transport_schedule()) == (backend, "tiled")
    assert_states_close(got, jax_sharded_step(coast), 1e-10)
    if coast:
        land = synthetic_coastline(N) == 0.0
        assert np.all(got["velocity"]["u"][land] == 0.0)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_spmd_tiled_transport_matches_jax_tiled_interpret(shape):
    model, got = port_sharded_step(False, shape, mevp_backend="xla", transport_backend="tiled")
    assert model.transport_schedule() == "tiled"
    ref = jax_sharded_step(False, shape, transport_backend="tiled-interpret")
    assert_states_close(got, ref, 1e-10)


def test_coupled_step_on_every_schedule_equals_the_single_domain_step():
    state, phys, dyn = coupled_inputs()
    single = CoupledModel(RectMesh(N, N, 512e3 / N, 512e3 / N), n_subcycles=10)
    t = lambda cls, d: cls(d, device="cpu", dtype=torch.float64)
    ref = interop.coupled_state_to_numpy(single.step(
        t(interop.coupled_state_from_numpy, state), t(interop.forcing_from_numpy, phys),
        t(interop.dynamics_forcing_from_numpy, dyn), DT,
    ))
    for shape, kwargs in (
        ((2, 2), dict(mevp_backend="xla", transport_backend="xla")),
        ((4, 2), dict(mevp_backend="auto", mevp_block_halo=2)),
        ((1, 4), dict(mevp_backend="rdma", mevp_block_halo=2)),
    ):
        _, got = port_sharded_step(False, shape, **kwargs)
        assert_states_close(got, ref, 1e-12)


def test_resident_blocks_over_steps_equal_the_global_step_repeated():
    grid = RankGrid(2, 2, "cpu", timeout=TIMEOUT)
    model, sharded = build_sharded_coupled_model(
        RectMesh(N, N, 512e3 / N, 512e3 / N), grid, n_subcycles=10, mevp_block_halo=4,
    )
    state, phys, dyn = coupled_inputs()
    t = lambda cls, d: cls(d, device="cpu", dtype=torch.float64)
    state = t(interop.coupled_state_from_numpy, state)
    phys, dyn = t(interop.forcing_from_numpy, phys), t(interop.dynamics_forcing_from_numpy, dyn)
    stepped = state
    for _ in range(3):
        stepped = sharded(stepped, phys, dyn, DT)
    resident = sharded.grid.gather_tree(sharded.run_blocks(
        sharded.grid.split_tree(state), sharded.grid.split_tree(phys), sharded.grid.split_tree(dyn), DT, 3
    ))
    assert_states_close(interop.coupled_state_to_numpy(resident), interop.coupled_state_to_numpy(stepped), 1e-14)
    assert model.mevp_schedule() == "blocked"


def test_interop_rank_blocks_round_trip():
    state, phys, _ = coupled_inputs()
    grid = RankGrid(4, 2, "cpu")
    blocks = interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float64)
    assert blocks[5].hice.shape == (3, 4, 8) and blocks[5].velocity.u.shape == (4, 8)
    back = interop.coupled_state_from_rank_blocks(blocks, grid)
    assert_states_close(back, state, 0.0)
    forcing = interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float64)
    np.testing.assert_array_equal(grid.gather([f.tair for f in forcing]).numpy(), phys["tair"])


# -- grids, failures, and what raises --------------------------------------------------
def test_indivisible_grid_raises():
    with pytest.raises(ValueError, match="not divisible"):
        build_sharded_coupled_model(RectMesh(10, 10, 1e3, 1e3), RankGrid(4, 2, "cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        RankGrid(4, 2, "cpu").split(torch.zeros(10, 16))
    with pytest.raises(ValueError):
        RankGrid(0, 2, "cpu")


@pytest.mark.parametrize("n_ranks, nx, ny, expected", [
    (4, 4096, 4096, (2, 2)), (8, 32, 32, (2, 4)), (4, 5, 8, (1, 4)), (2, 7, 8, (1, 2)), (1, 3, 3, (1, 1)),
])
def test_pick_mesh_shape_takes_the_squarest_dividing_factorization(n_ranks, nx, ny, expected):
    assert pick_mesh_shape(n_ranks, nx, ny) == expected


@pytest.mark.parametrize("n_ranks, nx, ny", [(4, 5, 7), (8, 9, 11), (6, 7, 5)])
def test_pick_mesh_shape_falls_back_as_jax_does(n_ranks, nx, ny):
    assert pick_mesh_shape(n_ranks, nx, ny) == jax_sharding.pick_mesh_shape(n_ranks, nx, ny)


def _failing(where: str):
    """A rank function in which rank 2 fails (or hangs) at ``where`` while
    the others exchange."""
    release = threading.Event()

    def fn(rank):
        x = torch.ones(4, 4, dtype=torch.float64)
        if rank.rank == 2 and where == "start":
            raise RuntimeError("rank 2 failed")
        for _ in range(3):
            x = stencil.halo_widen(x, 1, 0, False, rank.axes[0])[1:-1] + 1.0
        if rank.rank == 2 and where == "hang":
            release.wait(10 * TIMEOUT)  # never posts its next strip
        if rank.rank == 2 and where == "exchange":
            raise RuntimeError("rank 2 failed")
        x = stencil.halo_widen(x, 1, 1, False, rank.axes[1])[:, 1:-1]
        return rank.max(x.amax().reshape(1))

    return fn, release


@pytest.mark.parametrize("where", ["start", "exchange", "hang"])
def test_a_failing_or_hung_rank_stops_every_rank(where):
    fn, release = _failing(where)
    grid = RankGrid(2, 2, "cpu", timeout=2.0)
    t0 = time.perf_counter()
    try:
        expected = TimeoutError if where == "hang" else RuntimeError
        with pytest.raises(expected) as info:
            run_ranks(grid.ring, fn)
        assert not isinstance(info.value, RankAborted)
    finally:
        release.set()
    # Stated limit: an exception stops every rank at once (under a second);
    # a hang takes the ring's timeout of 2 s for the waiting ranks to give
    # up, and 2 s more of grace before the hung rank is left behind.
    assert time.perf_counter() - t0 < (5.0 if where == "hang" else 1.0)
    # The grid runs again after a failure.
    fn_ok, _ = _failing("none")
    assert [float(r[0]) for r in run_ranks(grid.ring, fn_ok)] == [4.0] * 4


@pytest.mark.parametrize("kind", ["high_order", "high_order_tvb"])
def test_unported_configurations_raise_on_a_rank_grid(kind):
    """The HO solver runs on a rank grid's blocked schedule since M10b part
    2a (tests/test_torch_grid_ho.py, tests/test_torch_grid_ho_coupled.py)
    and on its rdma schedule since part 2b's first half (it builds here on
    a closed box and a 360 degree ring; tests/test_torch_grid_ho_rdma.py);
    HO with TVB runs on a card since part 2b's second half (here a step on
    the card raises nothing and stays finite; tests/test_torch_grid_tvb.py).
    Periodic axes, graded and spherical meshes and TVB run on the grid since
    M10b part 1 (tests/test_torch_grid_metric.py, tests/test_torch_grid_ring.py).
    The name is from when these raised."""
    if kind == "high_order_tvb" and not torch.cuda.is_available():
        pytest.skip("HO with TVB on a card's rank grid needs a CUDA device")
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        if kind == "high_order":
            for mesh in (RectMesh(16, 16, 4e3, 4e3),
                         SphericalMesh(16, 16, lon0=0.0, lon1=360.0, lat0=68.0, lat1=78.0, periodic_x=True)):
                model, _ = build_sharded_coupled_model(mesh, RankGrid(2, 2, "cpu"), mevp_backend="rdma")
                assert model.is_high_order and model.mevp_schedule() == "rdma"
            return
        grid = RankGrid(2, 2, "cuda")
        model, sharded = build_sharded_coupled_model(RectMesh(N, N, 4e3, 4e3), grid, n_subcycles=2, tvb_m=2.0)
    finally:
        loader.reset()
    state = model.initial_state(hice0=1.0, cice0=0.9, device="cuda", dtype=torch.float32)
    state = grid.gather_tree([state] * 4)
    phys, dyn = coupled_inputs()[1:]
    out = sharded(state, interop.forcing_from_numpy(phys, device="cuda", dtype=torch.float32),
                  interop.dynamics_forcing_from_numpy(dyn, device="cuda", dtype=torch.float32), DT)
    assert model.schedule("cuda") == ("blocked", "tiled") and bool(torch.isfinite(out.hice).all())


#: The mEVP kernels, and the halo entries that the width-1 ("xla") schedule
#: launches on a card for the CG1 and the HO solver.
MEVP_KERNELS = ("mevp_stress", "mevp_velocity", "mevp_tiled", "mevp_single", "ho_single", "ho_tiled",
                "rdma_stage", "rdma_band", "ho_stress", "ho_velocity")
XLA_HALO_ENTRIES = {
    False: {("mevp_stress", "mevp_stress_halo"), ("mevp_velocity", "mevp_velocity_halo")},
    True: {("ho_stress", None), ("ho_velocity", None)},
}


@pytest.mark.parametrize("mevp_backend, transport_backend, high_order", [
    pytest.param("xla", "tiled", False, id="xla-tiled"),
    pytest.param("blocked", "xla", False, id="blocked-xla"),
    pytest.param("xla", "tiled", True, id="xla-tiled-ho"),
])
def test_plain_rank_grid_schedules_refuse_the_card(monkeypatch, mevp_backend, transport_backend, high_order):
    """The width-1 exchange schedules take the card's kernels: with every
    launch recorded in place of launching (the CPU check patched to answer
    as it does for CUDA tensors), a step reaches them and raises nothing.
    The mEVP's ("xla") launches the halo forms of mevp_stress and
    mevp_velocity (with the HO solver ho_stress and ho_velocity), and no
    other mEVP kernel, once a subcycle and rank each; the transport's
    ("xla") the halo forms of dg1_rk_stage, the blocked mEVP skipped (it
    returns the carry). The name is from when these raised."""
    loader = modules.get_loader()
    if high_order:
        loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        grid = RankGrid(2, 2, "cpu", timeout=TIMEOUT)
        model, sharded = build_sharded_coupled_model(
            RectMesh(N, N, 512e3 / N, 512e3 / N), grid, n_subcycles=2,
            mevp_backend=mevp_backend, transport_backend=transport_backend,
        )
    finally:
        loader.reset()
    state, phys, dyn = coupled_inputs()
    blocks = (
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float32),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float32),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float32),
    )
    if high_order:  # the rank blocks of an HO state at rest
        blocks = ([model.initial_state(hice0=1.0, cice0=0.9, device="cpu", dtype=torch.float32)] * 4, *blocks[1:])
    monkeypatch.setattr(cc, "_on_cpu", lambda t: False)
    calls = []
    monkeypatch.setattr(cc, "_launch", lambda name, *args, entry=None: calls.append((name, entry)))
    monkeypatch.setattr(cc, "_stream", lambda device: 0)
    if mevp_backend == "xla":
        # The transport is not this case's: skipped (it returns the tracers).
        monkeypatch.setattr(cc, "_k_of_speeds", lambda model, speeds, dt: 1)
        monkeypatch.setattr(tt, "transport_substeps_tiled_spmd", lambda model, tracers, *args, **kwargs: tracers)
        sharded.run_blocks(*blocks, DT, 1)
        mevp_calls = [call for call in calls if call[0] in MEVP_KERNELS]
        assert set(mevp_calls) == XLA_HALO_ENTRIES[high_order]
        assert len(mevp_calls) == 2 * 2 * 4  # two halves a subcycle, 2 subcycles, 4 ranks
        return
    monkeypatch.setattr(MEVPSolver, "spmd_subcycles", lambda self, carry, consts, dt, n: tuple(carry))
    sharded.run_blocks(*blocks, DT, 1)
    assert set(calls) == {("dg1_sample_cfl", None), ("dg1_rk_stage", "dg1_rk_stage_halo")}


def test_rank_grid_backends_are_checked():
    grid = RankGrid(2, 2, "cpu")
    mesh = RectMesh(16, 16, 4e3, 4e3)
    with pytest.raises(ValueError, match="mevp_backend"):
        build_sharded_coupled_model(mesh, grid, mevp_backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        MEVPSolver(RectMesh(8, 8, 4e3, 4e3), backend="rdma")  # no rank grid
    with pytest.raises(NotImplementedError, match="RankExchange"):
        CoupledModel(mesh, spmd=("X", "Y"))
