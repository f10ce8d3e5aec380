"""dG0 and dG2 transport, and rk3 on every schedule, against the JAX package.

Float64 on the CPU at 16^2 (the convergence twin at 32^2), inputs drawn
from a numpy seed and handed to both packages: the operator (``rhs``,
``limit_positivity``, ``step`` with rk1, rk2, rk3, limited and not) on a
uniform mesh and on a spherical one with a coastline, ``sample_velocity``,
``project``, ``run`` and ``total_mass``, the coupled step at dG0 and dG2,
the rank grid's 2 x 2 step with rk3 against JAX's sharded step, the HO
step at dG2, state interop at K = 1 and 6, the schedules that rk3 and the
new degrees take, and twins of ``tests/test_limiter.py`` and of the
solid-body rotation test of ``tests/test_transport.py``.

Tolerances: 1e-12 of the plane's max for one operation or step; 1e-14 for
the sampling and the projection (the same numpy float64 values cast);
1e-10 for 20 steps of ``run`` and the mass; 1e-8 of each plane's max
after mEVP subcycles (the shared divide amplifies rounding differences);
1e-10 for the rank grid's step, as ``tests/test_torch_parallel.py`` holds
it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics.mesh import SphericalMesh as JaxSphericalMesh
from nextsimdg_tpu.dynamics import mevp_ho as jax_ho
from nextsimdg_tpu.dynamics import transport as jax_transport
from nextsimdg_tpu.dynamics.landmask import synthetic_coastline as jax_synthetic_coastline
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing as JaxDynamicsForcing
from nextsimdg_tpu.dynamics.mevp import VelocityState as JaxVelocityState
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model as jax_build_sharded
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, synthetic_coastline, transport
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model

torch.set_num_threads(1)

N = 16
DX = 512e3 / N
DT = 600.0
RTOL_OP = 1e-12
RTOL_SAMPLE = 1e-14
RTOL_RUN = 1e-10
RTOL_SUBCYCLES = 1e-8
N_SUBCYCLES = 15
VELOCITY = ("u", "v", "s11", "s22", "s12")
HO = "Nextsim::MEVPHighOrder"
K = {0: 1, 1: 3, 2: 6}


def assert_close(got, ref, rtol, name=""):
    """|got - ref| <= rtol |ref| + rtol max|ref| elementwise."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def j64(a):
    return jnp.asarray(np.asarray(a), dtype=jnp.float64)


def meshes(kind):
    """(port mesh, JAX mesh, ocean mask or None) of a uniform square or a
    spherical lon-lat window with the synthetic coastline."""
    if kind == "uniform":
        return RectMesh(N, N, DX, DX), JaxRectMesh(nx=N, ny=N, dx=DX, dy=DX), None
    window = dict(lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)
    return (
        SphericalMesh(N, N, **window), JaxSphericalMesh(N, N, **window),
        synthetic_coastline(N),
    )


def transports(kind, degree, scheme=None):
    tmesh, jmesh, ocean = meshes(kind)
    return (
        transport.DGTransport(tmesh, degree=degree, scheme=scheme),
        jax_transport.DGTransport(jmesh, degree=degree, scheme=scheme),
        ocean,
    )


def tracers(degree, seed=3, n_tracers=3, spread=0.4):
    """(K, T, N, N) coefficients: means in [0, 1], higher moments of
    ``spread`` (many polynomials dip below zero)."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.0, 1.0, (1, n_tracers, N, N))
    rest = rng.normal(0.0, spread, (K[degree] - 1, n_tracers, N, N))
    return np.concatenate([mean, rest])


def quad_velocities(ttr, jtr, seed=7, scale=0.3):
    """The CG1 velocity of a seed at both packages' quadrature points."""
    rng = np.random.default_rng(seed)
    u, v = rng.normal(0.0, scale, (2, N, N))
    return (
        transport.velocity_from_cg(ttr.mesh, ttr.basis, t64(u), t64(v)),
        jax_transport.velocity_from_cg(jtr.mesh, jtr.basis, j64(u), j64(v)),
    )


def face_masks(ocean):
    """Both packages' coastline face masks, or None."""
    if ocean is None:
        return None, None
    return (
        transport.face_masks_from_land(t64(ocean)),
        jax_transport.face_masks_from_land(j64(ocean)),
    )


# -- the operator -------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["uniform", "spherical_coast"])
@pytest.mark.parametrize("degree", [0, 2])
def test_rhs_matches_jax(degree, kind):
    ttr, jtr, ocean = transports(kind, degree)
    tq, jq = quad_velocities(ttr, jtr)
    tmask, jmask = face_masks(ocean)
    psi = tracers(degree)
    got = ttr.rhs(t64(psi), tq, tmask)
    ref = jtr.rhs(j64(psi), jq, jmask)
    assert_close(got, ref, RTOL_OP)


@pytest.mark.parametrize("kind", ["uniform", "spherical_coast"])
@pytest.mark.parametrize("degree", [0, 2])
def test_limit_positivity_matches_jax(degree, kind):
    ttr, jtr, _ = transports(kind, degree)
    psi = tracers(degree, spread=1.5)
    got = ttr.limit_positivity(t64(psi))
    ref = jtr.limit_positivity(j64(psi))
    assert_close(got, ref, RTOL_OP)
    if degree == 0:
        assert torch.equal(got, t64(psi))
    else:
        assert not np.allclose(got.numpy(), psi)  # the limiter acted


@pytest.mark.parametrize("limit", [False, True])
@pytest.mark.parametrize("scheme", ["rk1", "rk2", "rk3"])
@pytest.mark.parametrize("degree", [0, 2])
def test_step_matches_jax(degree, scheme, limit):
    ttr, jtr, _ = transports("uniform", degree, scheme)
    tq, jq = quad_velocities(ttr, jtr)
    psi = tracers(degree)
    got = ttr.step(t64(psi), tq, 300.0, limit=limit)
    ref = jtr.step(j64(psi), jq, 300.0, limit=limit)
    assert_close(got, ref, RTOL_OP)


def test_default_scheme_follows_the_degree():
    for degree, scheme in {0: "rk1", 1: "rk2", 2: "rk3"}.items():
        assert transport.DGTransport(RectMesh(4, 4, 1.0, 1.0), degree=degree).scheme == scheme


def rotation(x, y):
    return -2 * np.pi * (y - 0.5), 2 * np.pi * (x - 0.5)


def gaussian(x, y):
    return np.exp(-((x - 0.5) ** 2 + (y - 0.7) ** 2) / 0.01)


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_sample_velocity_and_project_match_jax(degree):
    tmesh, jmesh = RectMesh(N, N, 1.0 / N, 1.0 / N), JaxRectMesh(nx=N, ny=N, dx=1.0 / N, dy=1.0 / N)
    ttr, jtr = transport.DGTransport(tmesh, degree), jax_transport.DGTransport(jmesh, degree)
    tq = transport.sample_velocity(tmesh, ttr.basis, rotation, device="cpu", dtype=torch.float64)
    jq = jax_transport.sample_velocity(jmesh, jtr.basis, rotation, dtype=jnp.float64)
    for name in ("vx_vol", "vy_vol", "vn_x", "vn_y"):
        assert_close(getattr(tq, name), getattr(jq, name), RTOL_SAMPLE, name)
    got = ttr.project(gaussian, device="cpu", dtype=torch.float64)
    assert_close(got, jtr.project(gaussian, dtype=jnp.float64), RTOL_SAMPLE)
    assert got.shape == (K[degree], N, N)
    f32 = ttr.project(gaussian, device="cpu", dtype=torch.float32)
    assert np.array_equal(f32.numpy(), np.asarray(jtr.project(gaussian, dtype=jnp.float32)))


@pytest.mark.parametrize("degree", [0, 2])
def test_run_and_total_mass_match_jax(degree):
    tmesh, jmesh = RectMesh(N, N, 1.0 / N, 1.0 / N), JaxRectMesh(nx=N, ny=N, dx=1.0 / N, dy=1.0 / N)
    ttr, jtr = transport.DGTransport(tmesh, degree), jax_transport.DGTransport(jmesh, degree)
    tq = transport.sample_velocity(tmesh, ttr.basis, rotation, device="cpu", dtype=torch.float64)
    jq = jax_transport.sample_velocity(jmesh, jtr.basis, rotation, dtype=jnp.float64)
    psi0 = ttr.project(gaussian, device="cpu", dtype=torch.float64)
    dt = 0.2 / (N * 2 * np.pi)
    cc.reset_launches()
    got = ttr.run(psi0, tq, dt, 20)
    ref = jtr.run(jtr.project(gaussian, dtype=jnp.float64), jq, dt, 20)
    assert_close(got, ref, RTOL_RUN)
    assert abs(float(ttr.total_mass(got)) - float(jtr.total_mass(ref))) <= RTOL_RUN * float(
        jtr.total_mass(ref)
    )
    assert not any(cc.launches.values())  # the plain version on the CPU
    # Several tracers at once: each is the one-tracer run.
    both = ttr.run(torch.stack([psi0, 2.0 * psi0], dim=1), tq, dt, 3)
    assert torch.equal(both[:, 0], ttr.run(psi0, tq, dt, 3))


@pytest.mark.parametrize("degree", [0, 2])
def test_velocity_sampling_and_cfl_stay_generic(degree):
    """velocity_from_cg and cfl_substeps at the degree's points (3-point
    Gauss at dG2): equal to the JAX ones, k exactly."""
    ttr, jtr, _ = transports("uniform", degree)
    tq, jq = quad_velocities(ttr, jtr, scale=40.0)
    for name in ("vx_vol", "vy_vol", "vn_x", "vn_y"):
        assert_close(getattr(tq, name), getattr(jq, name), RTOL_OP, name)
    assert tq.vx_vol.shape[0] == (9 if degree == 2 else 4)
    got = transport.cfl_substeps(tq, DT, ttr.mesh, degree)
    assert int(got) == int(jax_transport.cfl_substeps(jq, DT, jtr.mesh, degree)) > 1
    speeds = cc.dg1_sample_cfl(ttr, *quad_inputs(40.0))
    assert torch.equal(speeds, torch.stack(transport.max_speeds(tq)))


def quad_inputs(scale, seed=7):
    rng = np.random.default_rng(seed)
    u, v = rng.normal(0.0, scale, (2, N, N))
    return t64(u), t64(v)


# -- the coupled step ---------------------------------------------------------------
def seeded_state(degree, seed=0, speed=0.3):
    """A CoupledState of K-coefficient tracers as numpy leaves."""
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([
        rng.uniform(lo, hi, (1, N, N)), rng.normal(0.0, 0.05 * hi, (K[degree] - 1, N, N))
    ])
    return dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.3, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=np.full((N, N), -1.6), sss=np.full((N, N), 32.0),
        tice=np.full((1, N, N), -1.0), new_ice=np.zeros((N, N)),
        velocity=dict(
            u=rng.normal(0.0, speed, (N, N)), v=rng.normal(0.0, speed, (N, N)),
            s11=rng.normal(0.0, 500.0, (N, N)), s22=rng.normal(0.0, 500.0, (N, N)),
            s12=rng.normal(0.0, 200.0, (N, N)),
        ),
    )


def seeded_forcing(seed=1):
    rng = np.random.default_rng(seed)
    full = lambda v: np.full((N, N), v)
    dyn = dict(
        u_atm=10.0 + rng.normal(0.0, 1.0, (N, N)), v_atm=full(3.0),
        u_ocean=full(0.02), v_ocean=rng.normal(0.0, 0.01, (N, N)),
    )
    phys = dict(
        tair=-10.0 + rng.normal(0.0, 1.0, (N, N)), dew2m=full(-12.0), pair=full(1e5),
        sw_in=full(10.0), lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    return dyn, phys


def to_jax(state, dyn, phys):
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    velocity = JaxVelocityState(**{k: j(state["velocity"][k]) for k in VELOCITY})
    return (
        JaxCoupledState(velocity=velocity, **{k: j(v) for k, v in state.items() if k != "velocity"}),
        JaxDynamicsForcing(**{k: j(v) for k, v in dyn.items()}),
        JaxForcing(**{k: j(v) for k, v in phys.items()}),
    )


def to_port(state, dyn, phys):
    kw = dict(device="cpu", dtype=torch.float64)
    return (
        interop.coupled_state_from_numpy(state, **kw),
        interop.dynamics_forcing_from_numpy(dyn, **kw), interop.forcing_from_numpy(phys, **kw),
    )


def flat(d):
    """(name, array) of a coupled_state_to_numpy dict, velocity planes
    included (an HO velocity's CG2 planes too)."""
    for name, value in d.items():
        if name != "velocity":
            yield name, np.asarray(value)
    for name, value in d["velocity"].items():
        if isinstance(value, dict):
            for k, plane in value.items():
                yield f"velocity.{name}.{k}", np.asarray(plane)
        else:
            yield f"velocity.{name}", np.asarray(value)


def assert_states_close(got, ref, rtol):
    got, ref = dict(flat(interop.coupled_state_to_numpy(got))), dict(flat(interop.coupled_state_to_numpy(ref)))
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert_close(got[name], ref[name], rtol, name)


@pytest.mark.parametrize("degree", [0, 2])
def test_coupled_step_matches_jax(degree):
    """Two coupled steps with physics, 15 subcycles, CFL substeps."""
    port = CoupledModel(RectMesh(N, N, DX, DX), degree=degree, n_subcycles=N_SUBCYCLES)
    jmodel = JaxCoupledModel(
        JaxRectMesh(nx=N, ny=N, dx=DX, dy=DX), degree=degree, n_subcycles=N_SUBCYCLES
    )
    state, (dyn, phys) = seeded_state(degree), seeded_forcing()
    tstate, tdyn, tphys = to_port(state, dyn, phys)
    jstate, jdyn, jphys = to_jax(state, dyn, phys)
    got = port.run(tstate, tphys, tdyn, DT, 2)
    for _ in range(2):
        jstate = jmodel.step(jstate, jphys, jdyn, dt=DT)
    assert got.n_dg_dofs == K[degree]
    assert_states_close(got, jstate, RTOL_SUBCYCLES)
    initial = port.initial_state(hice0=1.0, device="cpu", dtype=torch.float64)
    assert initial.hice.shape == (K[degree], N, N) and float(initial.hice[0, 0, 0]) == 1.0


@pytest.mark.parametrize("degree", [0, 2])
def test_rank_grid_step_matches_jax_sharded_step(degree):
    """The 2 x 2 rank grid's step with physics and a coastline (dG2: rk3)
    on its "auto" schedules (the blocked mEVP, the spmd tiled transport)
    against JAX's sharded step on its spmd tiled transport."""
    state, (dyn, phys) = seeded_state(degree), seeded_forcing()
    grid = RankGrid(2, 2, "cpu", timeout=60.0)
    model, sharded = build_sharded_coupled_model(
        RectMesh(N, N, DX, DX), grid, degree=degree, n_subcycles=10,
        ocean_mask=synthetic_coastline(N), mevp_block_halo=4,
    )
    assert model.transport.scheme == {0: "rk1", 2: "rk3"}[degree]
    assert (model.mevp_schedule(), model.transport_schedule()) == ("blocked", "tiled")
    blocks = sharded.run_blocks(
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float64),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float64),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float64),
        DT, 1,
    )
    got = interop.coupled_state_from_rank_blocks(blocks, grid)
    _, step = jax_build_sharded(
        JaxRectMesh(nx=N, ny=N, dx=DX, dy=DX), make_spatial_mesh((2, 2)), degree=degree,
        n_subcycles=10, ocean_mask=jax_synthetic_coastline(N), mevp_backend="blocked",
        mevp_block_halo=4, transport_backend="tiled-interpret",
    )
    jstate, jdyn, jphys = to_jax(state, dyn, phys)
    ref = interop.coupled_state_to_numpy(step(jstate, jphys, jdyn, DT))
    got_np, ref_np = dict(flat(got)), dict(flat(ref))
    for name in ref_np:
        assert_close(got_np[name], ref_np[name], 1e-10, name)


def test_ho_step_at_dg2_matches_jax():
    """The coupled HO step at dG2 (rk3 on the CG2 samples at 3 x 3 points)
    with physics, against the JAX model on its tiled transport kernel in
    interpret mode."""
    JaxModuleRegistry.get_loader().set_implementation("Nextsim::IDynamics", HO)
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
    try:
        jmodel = JaxCoupledModel(
            JaxRectMesh(nx=N, ny=N, dx=DX, dy=DX), degree=2, n_subcycles=N_SUBCYCLES,
            transport_backend="tiled-interpret",
        )
        port = CoupledModel(RectMesh(N, N, DX, DX), degree=2, n_subcycles=N_SUBCYCLES)
    finally:
        JaxModuleRegistry.get_loader().reset()
        modules.get_loader().reset()
    assert jmodel.is_high_order and port.is_high_order
    assert port.schedule("cpu")[1] == "tiled"
    state, (dyn, phys) = seeded_state(2), seeded_forcing()
    rng = np.random.default_rng(5)
    ho = lambda: {k: rng.normal(0.0, 0.1, (N, N)) for k in ("v", "b", "l", "c")}
    state["velocity"] = dict(
        u=ho(), v=ho(), **{k: rng.normal(0.0, 300.0, (3, N, N)) for k in ("s11", "s22", "s12")}
    )
    tstate, tdyn, tphys = to_port(state, dyn, phys)
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    jfield = lambda d: jax_ho.HOField(**{k: j(v) for k, v in d.items()})
    vel = state["velocity"]
    jstate = JaxCoupledState(
        velocity=jax_ho.HOVelocityState(
            u=jfield(vel["u"]), v=jfield(vel["v"]), s11=j(vel["s11"]), s22=j(vel["s22"]),
            s12=j(vel["s12"]),
        ),
        **{k: j(v) for k, v in state.items() if k != "velocity"},
    )
    _, jdyn, jphys = to_jax(seeded_state(2), dyn, phys)
    got = port.step(tstate, tphys, tdyn, DT)
    ref = jmodel.step(jstate, jphys, jdyn, dt=DT)
    assert_states_close(got, ref, RTOL_SUBCYCLES)


@pytest.mark.parametrize("degree", [0, 2])
def test_interop_carries_k_coefficient_states(degree):
    state = seeded_state(degree)
    port = interop.coupled_state_from_numpy(state, device="cpu", dtype=torch.float64)
    assert port.hice.shape == (K[degree], N, N) and port.n_dg_dofs == K[degree]
    back = interop.coupled_state_to_numpy(port)
    for name in ("hice", "cice", "hsnow"):
        assert np.array_equal(back[name], state[name])
    back = interop.coupled_state_to_numpy(to_jax(state, *seeded_forcing())[0])
    assert np.array_equal(back["hsnow"], state["hsnow"])
    with pytest.raises(KeyError):
        interop.coupled_state_from_numpy({"hice": state["hice"]}, device="cpu", dtype=torch.float64)


def test_rk3_and_the_new_degrees_take_the_tiled_transport():
    """Where the JAX package takes its tiled transport kernel, rk3 does too:
    on one device from the tiled threshold, with the HO solver at every
    size, and on a rank grid (the spmd form, H = 16 where the block holds
    it); K1's schedule keeps its staged transport."""
    big = RectMesh(64, 64, 4e3, 4e3)
    for degree in (0, 2):
        assert CoupledModel(big, degree=degree).schedule("cpu") == ("pallas-tiled", "tiled")
        assert CoupledModel(big, degree=degree, mevp_backend="pallas").schedule("cpu") == ("pallas", "xla")
    assert CoupledModel(RectMesh(8, 8, 4e3, 4e3), degree=2).schedule("cpu") == ("pallas", "xla")
    grid = RankGrid(2, 2, "cpu")
    model, _ = build_sharded_coupled_model(RectMesh(64, 64, 4e3, 4e3), grid, degree=2)
    assert model.transport_schedule() == "tiled"
    assert tt.transport_tiled_spmd_config(model) == (16, 5)


@pytest.mark.parametrize("degree", [0, 1, 2])
@pytest.mark.parametrize("scheme", ["rk1", "rk2", "rk3"])
def test_tiled_and_staged_transport_run_the_plain_version_on_the_cpu(degree, scheme):
    """transport_tiled's and dg1_rk_stage's wrappers on CPU tensors: the
    plain k x step(limit=True), no launch."""
    ttr = transport.DGTransport(RectMesh(N, N, DX, DX), degree=degree, scheme=scheme)
    psi = t64(tracers(degree))
    u, v = quad_inputs(0.3)
    cc.reset_launches()
    ref = cc.transport_substeps_reference(ttr, psi, u, v, 200.0, 2)
    assert torch.equal(tt.transport_substeps_tiled(ttr, psi, u, v, 200.0, 2), ref)
    assert torch.equal(cc.transport_substeps(ttr, psi, u, v, 200.0, 2), ref)
    assert not any(cc.launches.values())


# -- twins of tests/test_limiter.py and the rotation test ------------------------------
def pointwise_min(tr, psi):
    """The polynomial's minimum over the volume and face points."""
    mins = None
    for table in (tr._psi_vol, tr._psi_x0, tr._psi_x1, tr._psi_y0, tr._psi_y1):
        values = torch.einsum("kq,kxy->qxy", torch.as_tensor(table, dtype=psi.dtype), psi)
        m = values.min(dim=0).values
        mins = m if mins is None else torch.minimum(mins, m)
    return mins


def test_limiter_restores_positivity_and_conserves_mean():
    tr = transport.DGTransport(RectMesh(4, 4, 0.25, 0.25), degree=2)
    psi = torch.zeros((6, 4, 4), dtype=torch.float64)
    psi[0], psi[1], psi[4] = 0.1, 1.0, -0.8
    assert float(pointwise_min(tr, psi).min()) < 0
    limited = tr.limit_positivity(psi)
    np.testing.assert_allclose(limited[0].numpy(), 0.1, rtol=1e-12)
    assert float(pointwise_min(tr, limited).min()) >= -1e-12


def test_limiter_noop_on_positive_fields():
    tr = transport.DGTransport(RectMesh(4, 4, 0.25, 0.25), degree=2)
    psi = torch.zeros((6, 4, 4), dtype=torch.float64)
    psi[0], psi[1] = 1.0, 0.1
    np.testing.assert_allclose(tr.limit_positivity(psi).numpy(), psi.numpy(), rtol=1e-12)


def test_limited_advection_keeps_tracer_nonnegative():
    """A sharp blob under dG2, carried by a uniform flow on a closed mesh
    (it stays clear of the walls): unlimited steps undershoot, limited
    ones do not, and the limiter conserves the mass."""
    n = 32
    mesh = RectMesh(n, n, 1.0 / n, 1.0 / n)
    tr = transport.DGTransport(mesh, degree=2)
    flow = lambda x, y: (np.ones_like(x), np.zeros_like(y))
    vel = transport.sample_velocity(mesh, tr.basis, flow, device="cpu", dtype=torch.float64)
    blob = lambda x, y: np.where((np.abs(x - 0.4) < 0.15) & (np.abs(y - 0.5) < 0.15), 1.0, 0.0)
    psi0 = tr.project(blob, device="cpu", dtype=torch.float64)
    unlimited = limited = psi0
    for _ in range(30):
        unlimited = tr.step(unlimited, vel, 1.0 / 320)
        limited = tr.step(limited, vel, 1.0 / 320, limit=True)
    assert float(pointwise_min(tr, unlimited).min()) < -1e-3
    assert float(pointwise_min(tr, limited).min()) >= -1e-10
    np.testing.assert_allclose(float(tr.total_mass(limited)), float(tr.total_mass(psi0)), rtol=1e-12)


def rotate_error(degree: int, n: int, steps: int) -> tuple:
    mesh = RectMesh(n, n, 1.0 / n, 1.0 / n)
    tr = transport.DGTransport(mesh, degree=degree)
    vel = transport.sample_velocity(mesh, tr.basis, rotation, device="cpu", dtype=torch.float64)
    blob = lambda x, y: np.exp(-((x - 0.5) ** 2 + (y - 0.7) ** 2) / (2 * 0.07**2))
    psi0 = tr.project(blob, device="cpu", dtype=torch.float64)
    psi = tr.run(psi0, vel, 1.0 / steps, steps)
    err = float(torch.sqrt(torch.mean((psi[0] - psi0[0]) ** 2)))
    return err, abs(float(tr.total_mass(psi)) - float(tr.total_mass(psi0)))


def test_solid_body_rotation_convergence_with_order():
    """One full revolution at 32^2: each degree halves the L2 error of the
    one below, and the closed walls keep the mass to rounding."""
    steps = 1200
    (err0, drift0), (err1, drift1), (err2, drift2) = (rotate_error(d, 32, steps) for d in (0, 1, 2))
    assert err1 < 0.5 * err0, (err0, err1)
    assert err2 < 0.5 * err1, (err1, err2)
    initial_mass = 2 * np.pi * 0.07**2
    for drift in (drift0, drift1, drift2):
        assert drift < 1e-12 * initial_mass, drift


def test_rk3_float32_mass_drift_matches_jax():
    """Config 2's set-up at 32^2 for 200 unlimited dG2 (rk3) steps in
    float32, the port's plain ``run`` and the JAX one: rk3's last stage
    blends with float32(1/3) and float32(2/3), whose sum exceeds 1 by
    2.98e-8, so both gain mass, each by at most that excess a step and the
    two within it of each other. Run with -s to print the drifts."""
    from nextsimdg_tpu_torch.benchmarks.run_benchmarks import advection_setup

    n, steps = 32, 200
    excess = float(np.float32(1.0 / 3.0)) + float(np.float32(2.0 / 3.0)) - 1.0
    tr, vel, psi0, dt = advection_setup(n, 2, "cpu", torch.float32)
    jmesh = JaxRectMesh(nx=n, ny=n, dx=1.0 / n, dy=1.0 / n)
    jtr = jax_transport.DGTransport(jmesh, degree=2)
    jvel = jax_transport.sample_velocity(jmesh, jtr.basis, rotation, dtype=jnp.float32)
    jpsi0 = jtr.project(gaussian, dtype=jnp.float32)
    assert np.array_equal(psi0.numpy(), np.asarray(jpsi0))
    mass = lambda p: float(tr.total_mass(torch.tensor(np.asarray(p), dtype=torch.float64)))
    m0 = mass(psi0)
    port = (mass(tr.run(psi0, vel, dt, steps)) - m0) / (m0 * steps)
    ref = (mass(jtr.run(jpsi0, jvel, dt, steps)) - m0) / (m0 * steps)
    print(f"rk3 float32 mass drift a step at {n}^2 over {steps} steps: port {port:.4e}, JAX {ref:.4e}")
    assert 0.0 < port <= excess and 0.0 < ref <= excess, (port, ref, excess)
    assert abs(port - ref) <= 0.5 * excess, (port, ref, excess)
