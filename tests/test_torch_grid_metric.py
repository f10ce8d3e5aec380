"""The rank grid on graded and spherical meshes: the port against the JAX package.

At float64 on the CPU, the same seeded numpy inputs go through the JAX
package (its single-domain solver, and its ``shard_map`` programs on the
8-device CPU mesh of ``tests/conftest.py`` with ``LocalMeshView`` blocks)
and through ``nextsimdg_tpu_torch.parallel``'s rank grid, whose ranks each
hold a ``LocalMeshView`` of the global mesh: the view's metric planes
against the global planes' slices (bit for bit, at float64 and float32),
its static metric raising, the mEVP on the width-1 ("xla"), blocked and
rdma schedules (the A-weighted and adaptive forms included), the coupled
step with the spmd tiled transport, free drift, and TVB, which runs the
staged route on a metric grid (on a card the halo forms of dg1_rk_stage
and dg1_limit, whose launches a test records).

Tolerances: exactly 0 between the port's grid and its single domain, and
between its schedules (the same operations on the same values); 1e-8 of
each plane's max against the JAX package after many mEVP subcycles (XLA
fuses the subcycle differently, and the shared divide amplifies an ulp);
1e-10 on a coupled step, as the JAX templates hold theirs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics.mesh import LocalMeshView as JaxLocalMeshView
from nextsimdg_tpu.dynamics.mesh import SphericalMesh as JaxSphericalMesh
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing as JaxDynamicsForcing
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.dynamics.mevp import MEVPSolver as JaxMEVPSolver
from nextsimdg_tpu.dynamics.mevp import VelocityState as JaxVelocityState
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model as jax_build_sharded
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.mesh import LocalMeshView, device_metric_planes
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from nextsimdg_tpu_torch.dynamics.transport import DGTransport
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model, run_ranks

torch.set_num_threads(1)

DT = 600.0
VELOCITY = ("u", "v", "s11", "s22", "s12")
FORCING = ("u_atm", "v_atm", "u_ocean", "v_ocean")
MEVP_INPUTS = VELOCITY + ("h", "a") + FORCING
TRACERS = ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice")
TIMEOUT = 60.0


# -- meshes: each as a (kind, n, periodic) key, built on either side ------------------
def mesh_of(kind: str, n: int, side: str = "port"):
    """The global mesh ``kind`` at n x n: "graded" (dx refined in the middle
    columns, dy toward y0), "spherical" (the lon-lat window 20W-20E,
    60N-80N), "ring" (the 360 degree ring at 55N-75N, periodic in x),
    "periodic" (uniform, both axes periodic) or "uniform"."""
    rect, sphere = (RectMesh, SphericalMesh) if side == "port" else (JaxRectMesh, JaxSphericalMesh)
    if kind == "graded":
        dx = 512e3 / n * (1.0 + 0.5 * np.cos(np.linspace(0, np.pi, n)))
        dy = 512e3 / n * np.linspace(0.6, 1.4, n)
        return rect(n, n, dx, dy) if side == "port" else rect(nx=n, ny=n, dx=dx, dy=dy)
    if kind == "spherical":
        return sphere(n, n, -20.0, 20.0, 60.0, 80.0) if side == "port" else sphere(
            nx=n, ny=n, lon0=-20.0, lon1=20.0, lat0=60.0, lat1=80.0
        )
    if kind == "ring":
        return sphere(n, n, 0.0, 360.0, 55.0, 75.0, periodic_x=True) if side == "port" else sphere(
            nx=n, ny=n, lon0=0.0, lon1=360.0, lat0=55.0, lat1=75.0, periodic_x=True
        )
    periodic = kind == "periodic"
    if side == "port":
        return rect(n, n, 512e3 / n, 512e3 / n, periodic_x=periodic, periodic_y=periodic)
    return rect(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n, periodic_x=periodic, periodic_y=periodic)


def assert_planes_close(got, ref, rtol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


# -- the mEVP step --------------------------------------------------------------------
def mevp_inputs(n=32, seed=0):
    """Global numpy planes: a moving state, h, a and a sheared forcing."""
    rng = np.random.default_rng(seed)
    planes = {k: rng.normal(0.0, s, (n, n)) for k, s in zip(VELOCITY, (0.2, 0.2, 500.0, 500.0, 200.0))}
    planes["h"] = rng.uniform(0.5, 2.5, (n, n))
    planes["a"] = rng.uniform(0.02, 1.0, (n, n))
    planes["u_atm"] = 10.0 + rng.normal(0.0, 1.0, (n, n))
    planes["v_atm"] = np.full((n, n), 3.0)
    planes["u_ocean"] = np.full((n, n), 0.02)
    planes["v_ocean"] = rng.normal(0.0, 0.01, (n, n))
    return planes


def _params(side, weighted, adaptive):
    cls = MEVPParams if side == "port" else JaxMEVPParams
    return cls(a_weighted_stress=weighted, adaptive_alpha=adaptive)


@functools.lru_cache(maxsize=None)
def jax_mevp(kind, n_sub, weighted=False, adaptive=False, backend="xla", shape=None, h=4, n=32):
    """The JAX package's mEVP step on the seeded inputs: its single-domain
    "xla" solver (``shape`` None), or under ``shard_map`` on a device mesh
    of ``shape`` with ``LocalMeshView`` blocks (uniform: ``RectMesh``
    blocks) on ``backend``."""
    planes = mevp_inputs(n)
    mesh = mesh_of(kind, n, "jax")
    params = _params("jax", weighted, adaptive)
    j = lambda k: jnp.asarray(planes[k])
    if shape is None:
        solver = JaxMEVPSolver(mesh, params, backend="xla")
        out = solver.step(JaxVelocityState(*(j(k) for k in VELOCITY)), j("h"), j("a"),
                          JaxDynamicsForcing(*(j(k) for k in FORCING)), solver.boundary_mask(jnp.float64), DT, n_sub)
        return tuple(np.asarray(getattr(out, k)) for k in VELOCITY)
    px, py = shape
    spmd = ("X" if px > 1 or py == 1 else None, "Y" if py > 1 else None)
    if mesh.uniform:
        local = JaxRectMesh(nx=n // px, ny=n // py, dx=mesh.dx, dy=mesh.dy,
                            periodic_x=mesh.periodic_x, periodic_y=mesh.periodic_y)
    else:
        local = JaxLocalMeshView(mesh, px, py)
    solver = JaxMEVPSolver(local, params, backend=backend, spmd=spmd, block_halo=h)

    def step(u, v, s11, s22, s12, hh, aa, ua, va, uo, vo):
        out = solver.step(JaxVelocityState(u, v, s11, s22, s12), hh, aa, JaxDynamicsForcing(ua, va, uo, vo),
                          solver.boundary_mask(jnp.float64), DT, n_sub)
        return tuple(getattr(out, k) for k in VELOCITY)

    spec = P(*spmd)
    mapped = jax.shard_map(step, mesh=make_spatial_mesh(shape), in_specs=(spec,) * len(MEVP_INPUTS),
                           out_specs=spec, check_vma=False)
    out = jax.jit(mapped)(*(j(k) for k in MEVP_INPUTS))
    return tuple(np.asarray(x) for x in out)


def port_block_mesh(mesh, shape, coords):
    """A rank's block as ``build_sharded_coupled_model`` makes it."""
    px, py = shape
    if mesh.uniform:
        return RectMesh(mesh.nx // px, mesh.ny // py, mesh.dx, mesh.dy,
                        periodic_x=mesh.periodic_x, periodic_y=mesh.periodic_y)
    return LocalMeshView(mesh, px, py, coords)


def port_mevp(kind, n_sub, weighted=False, adaptive=False, backend=None, shape=None, h=4, n=32):
    """The port's mEVP step on the seeded inputs: its single domain
    (``backend`` None) or on a rank grid of ``shape`` on ``backend``."""
    planes = {k: torch.from_numpy(v) for k, v in mevp_inputs(n).items()}
    mesh = mesh_of(kind, n)
    params = _params("port", weighted, adaptive)

    def step(solver, b):
        out = solver.step(VelocityState(*(b[k] for k in VELOCITY)), b["h"], b["a"],
                          DynamicsForcing(*(b[k] for k in FORCING)),
                          solver.boundary_mask(device="cpu", dtype=torch.float64), DT, n_sub)
        return tuple(getattr(out, k) for k in VELOCITY)

    if backend is None:
        return tuple(x.numpy() for x in step(MEVPSolver(mesh, params), planes))
    grid = RankGrid(*shape, "cpu", timeout=TIMEOUT)
    grid.periodic = (mesh.periodic_x, mesh.periodic_y)
    parts = {k: grid.split(v) for k, v in planes.items()}

    def body(rank):
        solver = MEVPSolver(port_block_mesh(mesh, shape, rank.coords), params, backend=backend,
                            spmd=rank.axes, block_halo=h)
        return step(solver, {k: p[rank.rank] for k, p in parts.items()})

    out = run_ranks(grid.ring, body)
    return tuple(grid.gather([o[p] for o in out]).numpy() for p in range(5))


@functools.lru_cache(maxsize=None)
def port_single_mevp(kind, n_sub, weighted=False, adaptive=False, n=32):
    return port_mevp(kind, n_sub, weighted, adaptive, n=n)


def check_mevp(got, kind, n_sub, weighted=False, adaptive=False, jax_ref=None, n=32):
    """``got`` equals the port's single domain exactly and the JAX
    package's (``jax_ref``, default its single domain) within 1e-8."""
    jax_ref = jax_mevp(kind, n_sub, weighted, adaptive, n=n) if jax_ref is None else jax_ref
    for name, g, s, r in zip(VELOCITY, got, port_single_mevp(kind, n_sub, weighted, adaptive, n), jax_ref):
        np.testing.assert_array_equal(g, s, err_msg=name)
        assert_planes_close(g, r, 1e-8, name)


# -- the coupled step -------------------------------------------------------------------
N = 16


def coupled_inputs(seed=0, n=N, nlayers=1):
    """A global CoupledState, physics forcing and dynamics forcing as numpy."""
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([rng.uniform(lo, hi, (1, n, n)), rng.normal(0.0, 0.05 * hi, (2, n, n))])
    state = dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.3, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=np.full((n, n), -1.6), sss=np.full((n, n), 32.0), tice=np.full((nlayers, n, n), -5.0),
        new_ice=np.zeros((n, n)),
        velocity={k: rng.normal(0.0, s, (n, n)) for k, s in zip(VELOCITY, (0.3, 0.3, 500.0, 500.0, 200.0))},
    )
    full = lambda v: np.full((n, n), v)
    phys = dict(tair=-10.0 + rng.normal(0.0, 1.0, (n, n)), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    dyn = dict(u_atm=8.0 + rng.normal(0.0, 1.0, (n, n)), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    return state, phys, dyn


def _jax_leaves(state, phys, dyn):
    from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
    from nextsimdg_tpu.state import Forcing as JaxForcing

    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    velocity = JaxVelocityState(**{k: j(state["velocity"][k]) for k in VELOCITY})
    return (
        JaxCoupledState(velocity=velocity, **{k: j(v) for k, v in state.items() if k != "velocity"}),
        JaxForcing(**{k: j(v) for k, v in phys.items()}),
        JaxDynamicsForcing(**{k: j(v) for k, v in dyn.items()}),
    )


@functools.lru_cache(maxsize=None)
def jax_coupled(kind, shape=None, coast=False, registry=None, nlayers=1, **kwargs):
    """The JAX package's coupled step on the seeded inputs, as numpy: its
    single domain (``shape`` None) or its sharded step on a device mesh of
    ``shape``; ``coast``: with the synthetic coastline. ``registry``:
    (interface, implementation) to select first (reset after)."""
    from nextsimdg_tpu.dynamics.landmask import synthetic_coastline as jax_synthetic_coastline

    ocean = jax_synthetic_coastline(N) if coast else None
    loader = JaxModuleRegistry.get_loader()
    if registry is not None:
        loader.set_implementation(*registry)
    try:
        mesh = mesh_of(kind, N, "jax")
        if shape is None:
            step = functools.partial(JaxCoupledModel(mesh, degree=1, n_subcycles=10, ocean_mask=ocean, **kwargs).step,
                                     dt=DT)
        else:
            _, sharded = jax_build_sharded(mesh, make_spatial_mesh(shape), degree=1, n_subcycles=10,
                                           ocean_mask=ocean, **kwargs)
            step = lambda s, p, d: sharded(s, p, d, DT)
        return interop.coupled_state_to_numpy(step(*_jax_leaves(*coupled_inputs(nlayers=nlayers))))
    finally:
        if registry is not None:
            loader.reset()


def port_coupled(kind, shape=None, coast=False, registry=None, nlayers=1, **kwargs):
    """(model, the port's coupled step as numpy): its single domain
    (``shape`` None) or a rank grid of ``shape`` (rank 0's model)."""
    from nextsimdg_tpu_torch.dynamics import synthetic_coastline

    ocean = synthetic_coastline(N) if coast else None
    loader = modules.get_loader()
    if registry is not None:
        loader.set_implementation(*registry)
    try:
        mesh = mesh_of(kind, N)
        state, phys, dyn = coupled_inputs(nlayers=nlayers)
        if shape is None:
            model = CoupledModel(mesh, n_subcycles=10, ocean_mask=ocean, **kwargs)
            t = lambda f, d: f(d, device="cpu", dtype=torch.float64)
            out = model.step(t(interop.coupled_state_from_numpy, state), t(interop.forcing_from_numpy, phys),
                             t(interop.dynamics_forcing_from_numpy, dyn), DT)
            return model, interop.coupled_state_to_numpy(out)
        grid = RankGrid(*shape, "cpu", timeout=TIMEOUT)
        model, sharded = build_sharded_coupled_model(mesh, grid, n_subcycles=10, ocean_mask=ocean, **kwargs)
        blocks = sharded.run_blocks(
            interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float64),
            interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float64),
            interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float64),
            DT, 1,
        )
        return model, interop.coupled_state_from_rank_blocks(blocks, grid)
    finally:
        if registry is not None:
            loader.reset()


def assert_states_close(got, ref, rtol):
    for name in TRACERS:
        assert_planes_close(got[name], ref[name], rtol, name)
    for name in VELOCITY:
        assert_planes_close(got["velocity"][name], ref["velocity"][name], rtol, name)


def assert_states_equal(got, ref):
    for name in TRACERS:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for name in VELOCITY:
        np.testing.assert_array_equal(got["velocity"][name], ref["velocity"][name], err_msg=name)


# -- the view -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["graded", "spherical", "ring"])
def test_view_planes_are_bit_identical_slices_of_the_global_planes(kind, dtype):
    """A rank's metric planes equal the single domain's slices bit for bit:
    the mesh planes (against the JAX package's static planes), the mEVP's
    node areas (the view slices an apron of the area where the JAX package
    exchanges it), the transport's planes and TVB tolerances, and the
    widened window's inside."""
    mesh, jmesh = mesh_of(kind, 16), mesh_of(kind, 16, "jax")
    shape = (mesh.nx, mesh.ny)
    static = {
        "dx": jmesh.dx, "dy": jmesh.dy, "area": jmesh.cell_area,
        "face_x": jmesh.face_len_x, "face_y": jmesh.face_len_y,
    }
    full = device_metric_planes(mesh, device="cpu", dtype=dtype)
    solver = MEVPSolver(mesh).metric_planes(device="cpu", dtype=dtype)
    transport = DGTransport(mesh, tvb_m=3.0)
    tr_planes = transport.metric_planes(device="cpu", dtype=dtype)
    tol = transport.tvb_tolerances(device="cpu", dtype=dtype)
    for px, py in ((4, 2), (1, 4), (2, 1)):
        bx, by = 16 // px, 16 // py
        for ix in range(px):
            for iy in range(py):
                view = LocalMeshView(mesh, px, py, (ix, iy))
                block = (slice(ix * bx, (ix + 1) * bx), slice(iy * by, (iy + 1) * by))
                planes = device_metric_planes(view, device="cpu", dtype=dtype)
                for name, plane in planes.items():
                    assert torch.equal(plane, full[name][block]), name
                    if dtype == torch.float64:
                        np.testing.assert_array_equal(
                            plane.numpy(), np.broadcast_to(np.asarray(static[name]), shape)[block]
                        )
                for name, plane in MEVPSolver(view).metric_planes(device="cpu", dtype=dtype).items():
                    assert torch.equal(plane, solver[name][block]), name
                view_tr = DGTransport(view, tvb_m=3.0)
                for name, plane in view_tr.metric_planes(device="cpu", dtype=dtype).items():
                    assert torch.equal(plane, tr_planes[name][block]), name
                for got, ref in zip(view_tr.tvb_tolerances(device="cpu", dtype=dtype), tol):
                    assert torch.equal(got, ref[block])
                window, inside = view.window_metric(3, device="cpu", dtype=dtype)
                for name, plane in planes.items():
                    assert torch.equal(window[name][3:-3, 3:-3], plane), name
                    assert torch.all(window[name][~inside] == 0.0)


def test_view_static_metric_raises():
    view = LocalMeshView(mesh_of("graded", 16), 4, 2, (1, 1))
    for attr in ("dx", "dy", "cell_area", "face_len_x", "face_len_y"):
        with pytest.raises(TypeError):
            getattr(view, attr)
    with pytest.raises(TypeError):
        view.node_coords()
    with pytest.raises(ValueError):
        LocalMeshView(RectMesh(16, 16, 1.0, 1.0), 4, 2, (0, 0))
    with pytest.raises(ValueError):
        LocalMeshView(mesh_of("graded", 16), 3, 2, (0, 0))
    assert (view.nx, view.ny, view.uniform) == (4, 8, False)


# -- the mEVP schedules ---------------------------------------------------------------
@pytest.mark.parametrize("backend, shape", [("xla", (4, 2)), ("blocked", (4, 2)), ("rdma", (2, 2))])
@pytest.mark.parametrize("kind", ["graded", "spherical"])
def test_mevp_on_a_metric_grid_matches_jax_and_one_domain(kind, backend, shape):
    check_mevp(port_mevp(kind, 20, backend=backend, shape=shape), kind, 20)


def test_blocked_mevp_matches_jax_blocked_interpret_on_a_graded_grid():
    """The literal twin: JAX's fused blocked inner kernel (interpret mode)
    on ``LocalMeshView`` blocks of a 4 x 2 device mesh."""
    got = port_mevp("graded", 20, backend="blocked", shape=(4, 2))
    check_mevp(got, "graded", 20, jax_ref=jax_mevp("graded", 20, backend="blocked-interpret", shape=(4, 2)))


def test_rdma_round_matches_jax_rdma_interpret_on_a_graded_grid():
    """The metric const planes widened and read by the rdma round (11
    subcycles: rounds of 4 + 4 + 3) on x strips, against JAX's
    ``"rdma-interpret"`` on a 4 x 1 device mesh."""
    ref = jax_mevp("graded", 11, backend="rdma-interpret", shape=(4, 1))
    check_mevp(port_mevp("graded", 11, backend="rdma", shape=(4, 1)), "graded", 11, jax_ref=ref)


@pytest.mark.parametrize("weighted, adaptive", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("kind", ["graded", "uniform"])
def test_momentum_forms_of_the_rdma_round_equal_the_blocked_round(kind, weighted, adaptive):
    """The A-weighted and adaptive forms on the rdma schedule equal the
    blocked schedule exactly, the single domain exactly and JAX's within
    1e-8 (``test_shardmap_metric.py``'s A-weighted graded blocked test and
    ``test_shardmap.py``'s adaptive blocked one)."""
    rdma = port_mevp(kind, 11, weighted, adaptive, backend="rdma", shape=(2, 2))
    blocked = port_mevp(kind, 11, weighted, adaptive, backend="blocked", shape=(4, 2))
    for g, b in zip(rdma, blocked):
        np.testing.assert_array_equal(g, b)
    check_mevp(rdma, kind, 11, weighted, adaptive)


# -- the coupled step -------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_coupled_metric(kind):
    # Graded: the JAX package's default schedules (width-1 halos, staged
    # transport); spherical: its blocked inner kernel and tiled transport,
    # both in interpret mode (test_shardmap_metric.py's two templates).
    if kind == "graded":
        return jax_coupled(kind, (4, 2))
    return jax_coupled(kind, (4, 2), mevp_backend="blocked-interpret", mevp_block_halo=4,
                       transport_backend="tiled-interpret")


@functools.lru_cache(maxsize=None)
def port_single_coupled(kind, **kwargs):
    return port_coupled(kind, **dict(kwargs))[1]


@pytest.mark.parametrize("backend", ["blocked", "rdma", "xla"])
@pytest.mark.parametrize("kind", ["graded", "spherical"])
def test_coupled_step_on_a_metric_grid_matches_jax_sharded(kind, backend):
    kwargs = dict(mevp_backend=backend, mevp_block_halo=4)
    if backend == "xla":
        kwargs["transport_backend"] = "xla"
    model, got = port_coupled(kind, (4, 2) if backend != "rdma" else (2, 2), **kwargs)
    assert model.schedule("cpu") == (backend, "xla" if backend == "xla" else "tiled")
    assert_states_equal(got, port_single_coupled(kind))
    assert_states_close(got, jax_coupled_metric(kind), 1e-10)


@pytest.mark.parametrize("kind", ["uniform", "spherical"])
def test_free_drift_on_a_grid_matches_one_domain_and_jax(kind):
    registry = ("Nextsim::IDynamics", "Nextsim::FreeDrift")
    model, got = port_coupled(kind, (2, 2), registry=registry)
    assert model.schedule("cpu") == ("free-drift", "tiled")
    assert_states_equal(got, port_coupled(kind, registry=registry)[1])
    assert_states_close(got, jax_coupled(kind, registry=registry), 1e-10)


def test_tvb_on_a_metric_grid_runs_staged_and_matches_one_domain():
    """TVB on a spherical grid runs the staged route with width-1 exchanges
    (``coupled_cuda.spmd_staged_transport``: psi and the stage's means
    widened by one ring, the plain versions of the halo forms of
    dg1_rk_stage and dg1_limit), as the JAX package runs TVB on a metric
    mesh."""
    model, got = port_coupled("spherical", (2, 2), tvb_m=2.0, mevp_block_halo=4)
    assert model.schedule("cpu") == ("blocked", "xla")
    assert_states_equal(got, port_coupled("spherical", tvb_m=2.0)[1])
    assert_states_close(got, jax_coupled("spherical", tvb_m=2.0), 1e-10)


def test_tvb_on_a_metric_grid_is_refused_on_a_card(monkeypatch):
    """TVB on a spherical grid takes the card's staged route and raises
    nothing (the name is from when it was refused): the CPU check patched
    to answer as it does for CUDA tensors, every kernel launch recorded in
    place of launching, the mEVP subcycles skipped (they return the carry)
    and the plain halo forms patched to raise. Each rank samples its CFL
    speeds in its velocity widened by one ring (dg1_sample_cfl), then every
    stage is dg1_rk_stage's halo form on the CG1 velocity and dg1_limit's
    halo form with the block's tolerance planes. transport_tiled still
    refuses TVB on a metric mesh at construction."""
    from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt

    grid = RankGrid(2, 2, "cpu", timeout=TIMEOUT)
    model, sharded = build_sharded_coupled_model(mesh_of("spherical", N), grid, n_subcycles=2, tvb_m=2.0)
    assert model.schedule("cpu") == ("blocked", "xla")
    state, phys, dyn = coupled_inputs()
    blocks = (
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float32),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float32),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float32),
    )
    calls = []

    def refused(*args, **kw):
        raise AssertionError("a plain halo form ran on the card's path")

    monkeypatch.setattr(cc, "_on_cpu", lambda t: False)
    monkeypatch.setattr(cc, "_launch", lambda name, *args, entry=None: calls.append((name, entry, args)))
    monkeypatch.setattr(cc, "_stream", lambda device: 0)
    monkeypatch.setattr(cc, "dg1_rk_stage_halo_reference", refused)
    monkeypatch.setattr(cc, "dg1_limit_halo_reference", refused)
    monkeypatch.setattr(MEVPSolver, "spmd_subcycles", lambda self, carry, consts, dt, n: tuple(carry))
    sharded.run_blocks(*blocks, DT, 1)
    entries = {(name, entry) for name, entry, _ in calls}
    assert entries == {("dg1_sample_cfl", None), ("dg1_rk_stage", "dg1_rk_stage_halo"),
                       ("dg1_limit", "dg1_limit_halo")}
    stages = [args for name, _, args in calls if name == "dg1_rk_stage"]
    limits = [args for name, _, args in calls if name == "dg1_limit"]
    assert len(stages) == len(limits) and len(stages) % (4 * 2) == 0  # 4 ranks, rk2
    assert all(args[2] is not None and args[6] is not None and args[7] is None for args in stages)  # u, metric
    assert all(args[2] is not None for args in limits)  # the tolerance planes
    with pytest.raises(NotImplementedError, match="staged"):
        build_sharded_coupled_model(mesh_of("spherical", N), RankGrid(2, 2, "cpu"), tvb_m=2.0,
                                    transport_backend="tiled")
    assert tt.transport_tiled_spmd_config(model) is None
