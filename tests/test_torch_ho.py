"""The higher-order (CG2 velocity, dG1 stress) solver: the port against the
JAX package.

At float64 on the CPU, the same numpy inputs go through the JAX package's
``MEVPSolverHO`` and ``CoupledModel`` with ``Nextsim::MEVPHighOrder``
selected, and through ``nextsimdg_tpu_torch``. The JAX K5 and K6 kernels
run in interpret mode, as the JAX package's own tests run them. Every test
that selects the HO solver resets both packages' registries in ``finally``.
Tolerances: exact for the tables, gathers and masks; 1e-12 of each plane's
max for one operation; 1e-8 of each plane's max after many subcycles,
where the shared divide amplifies rounding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics import cg2basis as jax_cg2
from nextsimdg_tpu.dynamics import mevp_ho as jax_ho
from nextsimdg_tpu.dynamics.dgbasis import dg_basis as jax_dg_basis
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing as JaxDynamicsForcing
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, cg2basis, dg_basis, landmask
from nextsimdg_tpu_torch.dynamics import mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import ho_single_cuda, ho_tiled_cuda
from nextsimdg_tpu_torch.dynamics.mevp import MEVPParams

torch.set_num_threads(1)

NX, NY = 24, 20
DX = 4e3
DT = 600.0
N_SUBCYCLES = 15
RTOL_OP = 1e-12
RTOL_SUBCYCLES = 1e-8
PLANES = ("v", "b", "l", "c")
HO = "Nextsim::MEVPHighOrder"


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


def fields(rng, scale, nx=NX, ny=NY, mean=0.0):
    """A CG2 field as {plane: ndarray}."""
    return {k: mean + rng.normal(0.0, scale, (nx, ny)) for k in PLANES}


def t_field(d):
    return mevp_ho.HOField(**{k: t64(d[k]) for k in PLANES})


def j_field(d):
    return jax_ho.HOField(**{k: j64(d[k]) for k in PLANES})


def solvers(backend="xla", nx=NX, ny=NY):
    port = mevp_ho.MEVPSolverHO(RectMesh(nx, ny, DX, DX), MEVPParams())
    ref = jax_ho.MEVPSolverHO(
        JaxRectMesh(nx=nx, ny=ny, dx=DX, dy=DX), JaxMEVPParams(), backend=backend
    )
    return port, ref


def ho_inputs(seed, nx=NX, ny=NY):
    """Seeded velocity, stresses, h (some nodes below min_ice_mass), A and
    CG2 forcing as numpy leaves."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.0, 2.0, (nx, ny))
    h[: nx // 4, : ny // 3] = 1e-4  # light ice: nodes held at rest
    return dict(
        u=fields(rng, 0.2, nx, ny), v=fields(rng, 0.2, nx, ny),
        s11=rng.normal(0.0, 2e3, (3, nx, ny)), s22=rng.normal(0.0, 2e3, (3, nx, ny)),
        s12=rng.normal(0.0, 1e3, (3, nx, ny)),
        h=h, a=rng.uniform(0.3, 1.0, (nx, ny)),
        u_atm=fields(rng, 2.0, nx, ny, 8.0), v_atm=fields(rng, 2.0, nx, ny, 3.0),
        u_ocean=fields(rng, 0.05, nx, ny), v_ocean=fields(rng, 0.05, nx, ny),
    )


def port_args(d):
    state = mevp_ho.HOVelocityState(
        u=t_field(d["u"]), v=t_field(d["v"]), s11=t64(d["s11"]), s22=t64(d["s22"]),
        s12=t64(d["s12"]),
    )
    forcing = mevp_ho.HODynamicsForcing(
        **{k: t_field(d[k]) for k in ("u_atm", "v_atm", "u_ocean", "v_ocean")}
    )
    return state, t64(d["h"]), t64(d["a"]), forcing


def jax_args(d):
    state = jax_ho.HOVelocityState(
        u=j_field(d["u"]), v=j_field(d["v"]), s11=j64(d["s11"]), s22=j64(d["s22"]),
        s12=j64(d["s12"]),
    )
    forcing = jax_ho.HODynamicsForcing(
        **{k: j_field(d[k]) for k in ("u_atm", "v_atm", "u_ocean", "v_ocean")}
    )
    return state, j64(d["h"]), j64(d["a"]), forcing


def assert_fields_close(got, ref, rtol, name):
    for k in PLANES:
        assert_close(getattr(got, k), getattr(ref, k), rtol, f"{name}.{k}")


def assert_carry_close(got, ref, rtol):
    assert_fields_close(got[0], ref[0], rtol, "u")
    assert_fields_close(got[1], ref[1], rtol, "v")
    for name, g, r in zip(("s11", "s22", "s12"), got[2:], ref[2:]):
        assert_close(g, r, rtol, name)


# -- tables and the local-node machinery -------------------------------------------
def test_cg2_tables_equal_exactly():
    got, ref = cg2basis.cg2_tables(), jax_cg2.cg2_tables()
    for field in dataclasses.fields(ref):
        assert np.array_equal(getattr(got, field.name), getattr(ref, field.name)), field.name
    assert np.array_equal(cg2basis.cg2_sampling_table(1), jax_cg2.cg2_sampling_table(1))
    assert cg2basis.LOCAL_NODE_SOURCE == jax_cg2.LOCAL_NODE_SOURCE
    assert cg2basis.PLANES == jax_cg2.PLANES
    x = np.linspace(0.0, 1.0, 7)
    for n in range(9):
        assert np.array_equal(cg2basis.shape(n, x, x[::-1]), jax_cg2.shape(n, x, x[::-1]))


def test_gather_and_scatter_are_adjoint_and_match_jax():
    rng = np.random.default_rng(0)
    port, ref = solvers()
    f = fields(rng, 1.0)
    got = port.gather_local(t_field(f))
    assert np.array_equal(got.numpy(), np.asarray(ref.gather_local(j_field(f))))
    contribs = rng.normal(0.0, 1.0, (9, NX, NY))
    scattered = port.scatter_local(t64(contribs))
    jscattered = ref.scatter_local(j64(contribs))
    for k in PLANES:
        assert np.array_equal(getattr(scattered, k).numpy(), np.asarray(getattr(jscattered, k)))
    # <gather(f), c> == <f, scatter(c)>
    lhs = float((got * t64(contribs)).sum())
    rhs = sum(float((t64(f[k]) * getattr(scattered, k)).sum()) for k in PLANES)
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_strain_divergence_thickness_and_mask_match_jax():
    d = ho_inputs(1)
    port, ref = solvers()
    got = port.strain_rates(t_field(d["u"]), t_field(d["v"]))
    want = ref.strain_rates(j_field(d["u"]), j_field(d["v"]))
    for name, g, r in zip(("e11", "e22", "e12"), got, want):
        assert_close(g, r, RTOL_OP, name)
    got = port.stress_divergence(t64(d["s11"]), t64(d["s22"]), t64(d["s12"]))
    want = ref.stress_divergence(j64(d["s11"]), j64(d["s22"]), j64(d["s12"]))
    for name, g, r in zip(("fu", "fv"), got, want):
        assert_fields_close(g, r, RTOL_OP, name)
    assert_fields_close(port.node_thickness(t64(d["h"])), ref.node_thickness(j64(d["h"])), RTOL_OP, "h")
    weights = port.node_weights(device="cpu", dtype=torch.float64)
    assert_fields_close(weights, ref.node_weights(dtype=jnp.float64), RTOL_OP, "W")
    mask = port.boundary_mask(device="cpu", dtype=torch.float64)
    jmask = ref.boundary_mask(dtype=jnp.float64)
    for k in PLANES:
        assert np.array_equal(getattr(mask, k).numpy(), np.asarray(getattr(jmask, k))), k


def test_step_consts_match_jax_on_all_29_planes():
    d = ho_inputs(2)
    port, ref = solvers()
    mask = port.boundary_mask(device="cpu", dtype=torch.float64)
    got = port.step_consts(*port_args(d), mask, DT)
    want = ref.step_consts(*jax_args(d), ref.boundary_mask(dtype=jnp.float64), DT)
    assert sorted(got) == sorted(want) == sorted(mevp_ho.HO_CONSTS)
    assert len(got) == 29
    for name in want:
        assert_close(got[name], want[name], RTOL_OP, name)
    # The light ice holds some nodes at rest, and not all.
    active = got["active_c"].numpy()
    assert (active == 0).any() and (active == 1).any()


def test_stress_then_velocity_update_is_jax_subcycle_body():
    d = ho_inputs(3)
    port, ref = solvers()
    mask = port.boundary_mask(device="cpu", dtype=torch.float64)
    state, h, a, forcing = port_args(d)
    consts = port.step_consts(state, h, a, forcing, mask, DT)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    s11, s22, s12 = port.stress_update(carry, consts)
    u, v = port.velocity_update((state.u, state.v, s11, s22, s12), consts, DT)
    jstate, jh, ja, jforcing = jax_args(d)
    jconsts = ref.step_consts(jstate, jh, ja, jforcing, ref.boundary_mask(dtype=jnp.float64), DT)
    want = ref.subcycle_body((jstate.u, jstate.v, jstate.s11, jstate.s22, jstate.s12), jconsts, DT)
    assert_carry_close((u, v, s11, s22, s12), want, RTOL_OP)
    got = port.subcycle_body(carry, consts, DT)
    assert all(torch.equal(x, y) for x, y in zip(got[2:], (s11, s22, s12)))


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret", "pallas-tiled-interpret"])
def test_step_matches_the_jax_solver_and_its_kernels(backend):
    """15 subcycles of the port's MEVPSolverHO.step against JAX's XLA path,
    K5 (pallas-interpret) and K6 (pallas-tiled-interpret)."""
    nx, ny = (16, 16) if backend != "xla" else (NX, NY)
    d = ho_inputs(4, nx, ny)
    port, ref = solvers(backend=backend, nx=nx, ny=ny)
    expected = {"xla": "xla", "pallas-interpret": "single-interpret"}
    assert ref._kernel_choice() == expected.get(backend, "tiled-interpret")
    mask = port.boundary_mask(device="cpu", dtype=torch.float64)
    got = port.step(*port_args(d), mask, DT, N_SUBCYCLES)
    want = ref.step(*jax_args(d), ref.boundary_mask(dtype=jnp.float64), DT, N_SUBCYCLES)
    assert_carry_close(
        (got.u, got.v, got.s11, got.s22, got.s12),
        (want.u, want.v, want.s11, want.s22, want.s12), RTOL_SUBCYCLES,
    )


def test_kernel_wrappers_run_the_plain_version_on_the_cpu():
    d = ho_inputs(5)
    port, _ = solvers()
    state, h, a, forcing = port_args(d)
    consts = port.step_consts(state, h, a, forcing, port.boundary_mask(device="cpu", dtype=torch.float64), DT)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    cc.reset_launches()
    ref = mevp_ho.ho_subcycles_reference(port, carry, consts, DT, 3)
    for run in (ho_single_cuda.ho_subcycles_single, ho_tiled_cuda.ho_subcycles_tiled):
        got = run(port, carry, consts, DT, 3)
        assert_carry_close(got, ref, 0.0)
    assert all(count == 0 for count in cc.launches.values())
    meta = (mevp_ho.HOField(*(x.to("meta") for x in state.u.planes())),) + carry[1:]
    with pytest.raises(ValueError, match="not supported"):
        ho_tiled_cuda.ho_subcycles_tiled(port, meta, consts, DT, 3)
    # The flat kernel layout round-trips.
    flat = cc.ho_flatten(carry)
    assert flat.shape == (17, NX, NY)
    assert_carry_close(cc.ho_unflatten(flat), carry, 0.0)


# -- CG2 sampling at the transport's quadrature points -------------------------------
def test_velocity_to_quad_matches_jax_and_is_exact_for_a_quadratic():
    d = ho_inputs(6)
    mesh = RectMesh(NX, NY, DX, DX)
    got = mevp_ho.ho_velocity_to_quad(mesh, dg_basis(1), t_field(d["u"]), t_field(d["v"]))
    want = jax_ho.ho_velocity_to_quad(
        JaxRectMesh(nx=NX, ny=NY, dx=DX, dy=DX), jax_dg_basis(1), j_field(d["u"]), j_field(d["v"])
    )
    for name in ("vx_vol", "vy_vol", "vn_x", "vn_y"):
        assert_close(getattr(got, name), getattr(want, name), RTOL_OP, name)

    # u = 1 + x^2 + y/2, v = 0.3 y^2 - x on a unit-ish mesh: CG2 is exact.
    n, h = 8, 0.125
    mesh = RectMesh(n, n, h, h)
    fu = lambda x, y: 1.0 + x * x + 0.5 * y
    fv = lambda x, y: 0.3 * y * y - x
    kw = dict(device="cpu", dtype=torch.float64)
    u = mevp_ho.HOField.from_function(mesh, fu, **kw)
    v = mevp_ho.HOField.from_function(mesh, fv, **kw)
    basis = dg_basis(1)
    qv = mevp_ho.ho_velocity_to_quad(mesh, basis, u, v)
    x0 = np.arange(n)[:, None] * h
    inner = (slice(None), slice(None, -1), slice(None, -1))  # away from the implicit wall nodes
    xq = np.stack([x0 + x * h + 0.0 * x0.T for x in basis.xq_vol])
    yq = np.stack([x0.T + y * h + 0.0 * x0 for y in basis.yq_vol])
    assert_close(qv.vx_vol[inner], fu(xq, yq)[inner], RTOL_OP)
    assert_close(qv.vy_vol[inner], fv(xq, yq)[inner], RTOL_OP)
    ys = np.stack([x0.T + s * h + 0.0 * x0 for s in basis.s_edge])  # left face x = x0
    assert_close(qv.vn_x[:, :, :-1], fu(x0 + 0.0 * ys, ys)[:, :, :-1], RTOL_OP)


# -- the coupled HO step -------------------------------------------------------------
def select_ho():
    JaxModuleRegistry.get_loader().set_implementation("Nextsim::IDynamics", HO)
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)


def reset_registries():
    JaxModuleRegistry.get_loader().reset()
    modules.get_loader().reset()


def coupled_inputs(seed, nx=NX, ny=NY):
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([
        rng.uniform(lo, hi, (1, nx, ny)), rng.normal(0.0, 0.05 * hi, (2, nx, ny))
    ])
    state = dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.3, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=rng.uniform(-1.78, -1.5, (nx, ny)), sss=np.full((nx, ny), 32.0),
        tice=rng.uniform(-15.0, -2.0, (1, nx, ny)), new_ice=np.zeros((nx, ny)),
        velocity=dict(
            u=fields(rng, 0.1, nx, ny), v=fields(rng, 0.1, nx, ny),
            s11=rng.normal(0.0, 500.0, (3, nx, ny)), s22=rng.normal(0.0, 500.0, (3, nx, ny)),
            s12=rng.normal(0.0, 200.0, (3, nx, ny)),
        ),
    )
    dyn = dict(
        u_atm=10.0 + rng.normal(0.0, 1.0, (nx, ny)), v_atm=np.full((nx, ny), 3.0),
        u_ocean=np.full((nx, ny), 0.02), v_ocean=rng.normal(0.0, 0.01, (nx, ny)),
    )
    phys = dict(
        tair=rng.uniform(-25.0, -5.0, (nx, ny)), dew2m=rng.uniform(-27.0, -7.0, (nx, ny)),
        pair=np.full((nx, ny), 1e5), sw_in=np.full((nx, ny), 5.0),
        lw_in=np.full((nx, ny), 240.0), mld=np.full((nx, ny), 10.0),
        snowfall=np.full((nx, ny), 1e-4), wind=rng.uniform(2.0, 10.0, (nx, ny)),
    )
    return state, dyn, phys


def to_jax(state, dyn, phys):
    vel = state["velocity"]
    velocity = jax_ho.HOVelocityState(
        u=j_field(vel["u"]), v=j_field(vel["v"]),
        s11=j64(vel["s11"]), s22=j64(vel["s22"]), s12=j64(vel["s12"]),
    )
    jstate = JaxCoupledState(velocity=velocity, **{k: j64(v) for k, v in state.items() if k != "velocity"})
    return (
        jstate, JaxForcing(**{k: j64(v) for k, v in phys.items()}),
        JaxDynamicsForcing(**{k: j64(v) for k, v in dyn.items()}),
    )


def to_port(state, dyn, phys):
    kw = dict(device="cpu", dtype=torch.float64)
    return (
        interop.coupled_state_from_numpy(state, **kw), interop.forcing_from_numpy(phys, **kw),
        interop.dynamics_forcing_from_numpy(dyn, **kw),
    )


def flat_leaves(d):
    """(name, ndarray) of a coupled_state_to_numpy dict, the HO velocity
    planes included."""
    for name, value in d.items():
        if name != "velocity":
            yield name, value
    for name, value in d["velocity"].items():
        if isinstance(value, dict):
            for k in PLANES:
                yield f"velocity.{name}.{k}", value[k]
        else:
            yield f"velocity.{name}", value


@pytest.mark.parametrize("coast", [False, True], ids=["open", "coastline"])
def test_coupled_ho_step_with_physics_matches_jax(coast):
    """Two coupled steps with thermodynamics, HO solver selected in both
    packages (JAX on its tiled transport kernel in interpret mode), with
    and without the synthetic coastline: all 20 leaves."""
    ocean = landmask.synthetic_coastline(NX, NY) if coast else None
    select_ho()
    try:
        jmodel = JaxCoupledModel(
            JaxRectMesh(nx=NX, ny=NY, dx=DX, dy=DX), degree=1, n_subcycles=N_SUBCYCLES,
            ocean_mask=ocean, transport_backend="tiled-interpret",
        )
        port = CoupledModel(
            RectMesh(NX, NY, DX, DX), degree=1, n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
        )
    finally:
        reset_registries()
    assert jmodel.is_high_order and port.is_high_order
    assert jmodel._tiled_transport_mode() == "interpret"
    state, dyn, phys = coupled_inputs(7)
    got = port.run(*to_port(state, dyn, phys), DT, 2)
    ref = to_jax(state, dyn, phys)
    ref_state = ref[0]
    for _ in range(2):
        ref_state = jmodel.step(ref_state, ref[1], ref[2], dt=DT)
    got_np = dict(flat_leaves(interop.coupled_state_to_numpy(got)))
    ref_np = dict(flat_leaves(interop.coupled_state_to_numpy(ref_state)))
    assert sorted(got_np) == sorted(ref_np) and len(ref_np) == 18
    for name in ref_np:
        assert_close(got_np[name], ref_np[name], RTOL_SUBCYCLES, name)
    assert (ref_np["new_ice"] > 0).any()
    assert float(np.abs(ref_np["velocity.u.c"]).max()) > 0.0


@pytest.mark.parametrize("scheme", ["rk2", "rk3"])
def test_coupled_ho_step_on_the_staged_transport_matches_jax(scheme):
    """Two coupled HO steps with physics on ``transport_backend="xla"`` in
    both packages (JAX's staged transport; the port's dg1_rk_stage schedule
    in its qv form, whose plain version runs on the CPU), rk2 and rk3: all
    18 leaves to 1e-8 of each plane's max."""
    select_ho()
    try:
        jmodel = JaxCoupledModel(
            JaxRectMesh(nx=NX, ny=NY, dx=DX, dy=DX), degree=1, n_subcycles=N_SUBCYCLES,
            transport_backend="xla",
        )
        port = CoupledModel(
            RectMesh(NX, NY, DX, DX), degree=1, n_subcycles=N_SUBCYCLES, transport_backend="xla",
        )
    finally:
        reset_registries()
    jmodel.transport.scheme = port.transport.scheme = scheme
    assert jmodel.is_high_order and port.is_high_order
    assert jmodel._tiled_transport_mode() is None
    assert port.transport_schedule() == "xla"
    state, dyn, phys = coupled_inputs(17)
    got = port.run(*to_port(state, dyn, phys), DT, 2)
    ref_state, ref_phys, ref_dyn = to_jax(state, dyn, phys)
    for _ in range(2):
        ref_state = jmodel.step(ref_state, ref_phys, ref_dyn, dt=DT)
    got_np = dict(flat_leaves(interop.coupled_state_to_numpy(got)))
    ref_np = dict(flat_leaves(interop.coupled_state_to_numpy(ref_state)))
    assert sorted(got_np) == sorted(ref_np) and len(ref_np) == 18
    for name in ref_np:
        assert_close(got_np[name], ref_np[name], RTOL_SUBCYCLES, name)
    assert float(np.abs(ref_np["hice"][1:]).max()) > 0.0


@pytest.mark.parametrize("scheme", ["rk1", "rk2", "rk3"])
def test_staged_transport_takes_the_cg2_samples_on_the_cpu(scheme):
    """``transport_substeps`` and ``dg1_rk_stage`` with the HO path's
    quadrature velocity (``qv``) run their plain versions on CPU tensors:
    equal to ``transport_substeps_reference`` and ``dg1_rk_stage_reference``
    with the same ``qv``, and u and v are not read."""
    rng = np.random.default_rng(18)
    port = ho_model()
    tr = port.transport
    tr.scheme = scheme
    qv = mevp_ho.ho_velocity_to_quad(
        port.mesh, tr.basis, t_field(fields(rng, 0.3)), t_field(fields(rng, 0.3))
    )
    state, _, _ = coupled_inputs(19)
    psi = torch.stack([t64(state[name]) for name in ("hice", "cice", "hsnow")], dim=1)
    faces = tuple(t64((rng.uniform(size=(NX, NY)) > 0.1).astype(float)) for _ in range(2))
    got = cc.transport_substeps(tr, psi, None, None, 200.0, 3, faces, qv=qv)
    ref = cc.transport_substeps_reference(tr, psi, None, None, 200.0, 3, faces, qv=qv)
    assert torch.equal(got, ref)
    stage = (tr, psi, psi.flip(-1), None, None, *faces, 0.5, 0.5, 200.0)
    assert torch.equal(cc.dg1_rk_stage(*stage, qv=qv), cc.dg1_rk_stage_reference(*stage, qv=qv))
    assert not torch.equal(got, psi)


def test_coastline_keeps_land_and_pins_every_node_that_touches_it():
    ocean = landmask.synthetic_coastline(NX, NY)
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
    try:
        port = CoupledModel(RectMesh(NX, NY, DX, DX), n_subcycles=10, ocean_mask=ocean)
    finally:
        modules.get_loader().reset()
    state, dyn, phys = coupled_inputs(8)
    for name in ("hice", "cice", "hsnow"):  # flat tracers: the limiter leaves land alone
        state[name][1:] = 0.0
    start = to_port(state, dyn, phys)
    out = port.step(*start, DT)
    land = torch.as_tensor(ocean == 0.0)
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        before, after = getattr(start[0], name), getattr(out, name)
        assert torch.equal(after[..., land], before[..., land]), name
    mask = port.node_mask(device="cpu", dtype=torch.float64)
    assert isinstance(mask, mevp_ho.HOField)
    assert port.node_mask(device="cpu", dtype=torch.float64) is mask  # built once
    # Every plane: pinned where a touching element is land.
    o = np.pad(ocean, ((1, 0), (1, 0)))  # element (i-1, j-1) at [i, j]
    touching = {
        "v": (o[1:, 1:] * o[:-1, 1:] * o[1:, :-1] * o[:-1, :-1]) == 0.0,
        "b": (o[1:, 1:] * o[1:, :-1]) == 0.0,
        "l": (o[1:, 1:] * o[:-1, 1:]) == 0.0,
        "c": ocean == 0.0,
    }
    for k in PLANES:
        pinned = torch.as_tensor(touching[k])
        assert bool(pinned.any()) and bool((getattr(mask, k)[pinned] == 0.0).all()), k
        for name in ("u", "v"):
            assert bool((getattr(getattr(out.velocity, name), k)[pinned] == 0.0).all()), (name, k)
    assert float(out.velocity.u.c.abs().max()) > 0.0


def test_ho_state_interop_round_trip():
    state, _, _ = coupled_inputs(9)
    port_state = interop.coupled_state_from_numpy(state, device="cpu", dtype=torch.float64)
    assert isinstance(port_state.velocity, mevp_ho.HOVelocityState)
    back = interop.coupled_state_to_numpy(port_state)
    for (name, g), (_, r) in zip(flat_leaves(back), flat_leaves(state)):
        assert np.array_equal(g, r), name
    jax_back = interop.coupled_state_to_numpy(to_jax(state, *coupled_inputs(9)[1:])[0])
    for (name, g), (_, r) in zip(flat_leaves(jax_back), flat_leaves(state)):
        assert np.array_equal(g, r), name
    f32 = interop.coupled_state_from_numpy(state, device="cpu", dtype=torch.float32)
    assert f32.velocity.u.b.dtype == torch.float32
    bad = dict(state, velocity=dict(state["velocity"], u={"v": state["velocity"]["u"]["v"]}))
    with pytest.raises(KeyError):
        interop.coupled_state_from_numpy(bad, device="cpu", dtype=torch.float64)


# -- schedules and what stays unported -------------------------------------------------
def ho_model(mesh=None, **kwargs):
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
    try:
        return CoupledModel(mesh or RectMesh(NX, NY, DX, DX), **kwargs)
    finally:
        modules.get_loader().reset()


@pytest.mark.parametrize(
    "mevp_backend, transport_backend, expected",
    [
        ("pallas", "auto", ("single", "tiled")),
        ("pallas-tiled", "auto", ("tiled", "tiled")),
        ("auto", "xla", ("single", "xla")),
        ("auto", "tiled", ("single", "tiled")),
    ],
)
def test_ho_schedules(mevp_backend, transport_backend, expected):
    port = ho_model(mevp_backend=mevp_backend, transport_backend=transport_backend)
    assert (port.mevp_schedule(), port.transport_schedule()) == expected


@pytest.mark.parametrize(
    "transport_backend, expected",
    [("auto", ("single", "tiled")), ("xla", ("single", "xla")), ("tiled", ("single", "tiled"))],
)
def test_ho_rk3_takes_the_staged_transport(transport_backend, expected):
    """rk3 takes the staged dg1_rk_stage (its qv form) where it is asked
    for ("xla"); "auto" advects rk3 with transport_tiled, which runs rk3,
    as it does rk1 and rk2; an explicit backend is kept."""
    port = ho_model(transport_backend=transport_backend)
    port.transport.scheme = "rk3"
    assert (port.mevp_schedule(), port.transport_schedule()) == expected


@pytest.mark.parametrize("sms, expected", [(None, "single"), (132, "single"), (16, "tiled")])
def test_ho_auto_takes_ho_tiled_where_the_card_does_not_hold_the_grid(sms, expected):
    """400^2 is below HO_SINGLE_MAX_ELEMENTS; ho_single holds it on 132
    SMs but not on 16 (its tiles would outgrow a block's shared memory), so
    "auto" falls back to ho_tiled there. An explicit "pallas" keeps
    ho_single (whose wrapper then refuses the grid on such a card)."""
    n = 400
    assert n * n < mevp_ho.HO_SINGLE_MAX_ELEMENTS
    assert ho_single_cuda.holds(n, n, 132) and not ho_single_cuda.holds(n, n, 16)
    mesh = RectMesh(n, n, DX, DX)
    assert ho_model(mesh).mevp_schedule(sms) == expected
    assert ho_model(mesh).mevp.schedule(sms) == expected
    assert ho_model(mesh, mevp_backend="pallas").mevp_schedule(sms) == "single"


@pytest.mark.parametrize(
    "device, sms, expected", [("cpu", 16, "single"), ("cuda", 132, "single"), ("cuda", 16, "tiled")]
)
def test_ho_schedule_of_a_step_asks_its_card(monkeypatch, device, sms, expected):
    """The HO step's schedule on a CUDA device counts its SMs (forced
    here): ho_tiled where ho_single does not hold the 400^2 grid."""
    from nextsimdg_tpu_torch import coupled

    monkeypatch.setattr(coupled, "sm_count", lambda d: sms)
    assert ho_model(RectMesh(400, 400, DX, DX)).schedule(device) == (expected, "tiled")


@pytest.mark.parametrize("side", ["below", "at"])
def test_ho_auto_follows_its_threshold(side):
    nx = -(-mevp_ho.HO_SINGLE_MAX_ELEMENTS // 64) - (side == "below")
    port = ho_model(RectMesh(nx, 64, DX, DX))
    single = nx * 64 < mevp_ho.HO_SINGLE_MAX_ELEMENTS
    assert single == (side == "below")
    assert port.mevp_schedule() == ("single" if single else "tiled")


@pytest.mark.parametrize(
    "build, match",
    [(lambda: ho_model(mevp_params=MEVPParams(adaptive_alpha=True)), "CG1 solver only")],
    ids=["adaptive_alpha"],
)
def test_unported_ho_options_raise(build, match):
    with pytest.raises(NotImplementedError, match=match):
        build()
    assert modules.get_loader().selected_name("Nextsim::IDynamics") == "Nextsim::MEVPDynamics"


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(mevp_params=MEVPParams(a_weighted_stress=True)),
        dict(mesh=RectMesh(NX, NY, DX, DX, periodic_x=True)),
        dict(mesh=RectMesh(NX, NY, DX * (1.0 + 0.1 * np.arange(NX)), DX)),
        dict(mesh=SphericalMesh(NX, NY, 0.0, 10.0, 60.0, 70.0)),
    ],
    ids=["a_weighted_stress", "periodic", "graded", "spherical"],
)
def test_ported_ho_options_run(kwargs):
    """The A-weighted, periodic, graded and spherical HO options run: a
    coupled step equals its plain dynamics phase and physics, and differs
    from the closed, unweighted step on the uniform mesh on the same
    inputs."""
    port, plain = ho_model(n_subcycles=4, **kwargs), ho_model(n_subcycles=4)
    start = to_port(*coupled_inputs(11))
    got = port.step(*start, DT)
    ref = port.step_thermo(
        port.step_dynamics(start[0], start[2], DT, phase=cc.fused_dynamics_reference), start[1], DT
    )
    other = plain.step(*start, DT)
    got_np = dict(flat_leaves(interop.coupled_state_to_numpy(got)))
    ref_np = dict(flat_leaves(interop.coupled_state_to_numpy(ref)))
    other_np = dict(flat_leaves(interop.coupled_state_to_numpy(other)))
    assert all(np.array_equal(got_np[name], ref_np[name]) for name in ref_np)
    assert not np.array_equal(got_np["velocity.u.v"], other_np["velocity.u.v"])


def test_ho_step_on_the_cpu_is_the_plain_version():
    port = ho_model(n_subcycles=4, mevp_backend="pallas-tiled")
    state, dyn, phys = coupled_inputs(10)
    start = to_port(state, dyn, phys)
    cc.reset_launches()
    got = port.step(*start, DT)
    ref = port.step_thermo(
        port.step_dynamics(start[0], start[2], DT, phase=cc.fused_dynamics_reference), start[1], DT
    )
    assert all(count == 0 for count in cc.launches.values())
    for (name, g), (_, r) in zip(
        flat_leaves(interop.coupled_state_to_numpy(got)), flat_leaves(interop.coupled_state_to_numpy(ref))
    ):
        assert np.array_equal(g, r), name
    init = port.initial_state(hice0=1.0, device="cpu", dtype=torch.float32)
    assert isinstance(init.velocity, mevp_ho.HOVelocityState)
    assert init.velocity.s11.shape == (3, NX, NY) and init.velocity.u.c.dtype == torch.float32
