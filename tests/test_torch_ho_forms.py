"""The higher-order solver's A-weighted and periodic forms: the port against
the JAX package.

At float64 on the CPU, the same numpy inputs go through the JAX package's
plain (``backend="xla"``) ``MEVPSolverHO`` and staged ``CoupledModel`` with
``Nextsim::MEVPHighOrder`` selected, and through ``nextsimdg_tpu_torch``'s
plain versions: the local-node machinery, the CG2 sampling and the masks on
every combination of periodic axes, the 33 const planes of
``a_weighted_stress``, whole solver steps (twins of the JAX package's own
HO tests of these forms, at small extents: the port has no 64/128 rule) and
coupled HO steps with physics on a ring, with and without the TVB limiter
and a coastline. Every test that selects the HO solver resets both
registries in ``finally``. Tolerances: exact for the gathers, scatters and
masks; 1e-12 of each plane's max for one operation; 1e-8 of each plane's
max after 10-15 subcycles, where the shared divide amplifies rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics import mevp_ho as jax_ho
from nextsimdg_tpu.dynamics.dgbasis import dg_basis as jax_dg_basis
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, dg_basis, landmask, mevp_ho
from nextsimdg_tpu_torch.dynamics.mevp import MEVPParams

from test_torch_ho import (
    HO, PLANES, assert_carry_close, assert_close, coupled_inputs, fields, flat_leaves, j64, j_field,
    jax_args, port_args, t64, t_field, to_jax, to_port,
)

torch.set_num_threads(1)

NX, NY = 16, 24
DX = 4e3
DT = 600.0
RTOL_OP = 1e-12
RTOL_SUBCYCLES = 1e-8
#: Every combination of periodic axes.
AXES = {"closed": (False, False), "x": (True, False), "y": (False, True), "xy": (True, True)}


def solvers(periodic=(False, False), weighted=False, nx=NX, ny=NY, dx=DX, **params):
    """The port's and JAX's plain HO solvers on one mesh and form."""
    px, py = periodic
    port = mevp_ho.MEVPSolverHO(
        RectMesh(nx, ny, dx, dx, periodic_x=px, periodic_y=py),
        MEVPParams(a_weighted_stress=weighted, **params),
    )
    ref = jax_ho.MEVPSolverHO(
        JaxRectMesh(nx=nx, ny=ny, dx=dx, dy=dx, periodic_x=px, periodic_y=py),
        JaxMEVPParams(a_weighted_stress=weighted, **params), backend="xla",
    )
    return port, ref


def ho_inputs(seed, nx=NX, ny=NY):
    """Seeded velocity, stresses, h (light ice in a corner), A with partial
    cover (a quarter of the rows below 0.06: some nodes below a_dyn_min)
    and CG2 forcing whose wind varies along the seams, as numpy leaves."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.0, 2.0, (nx, ny))
    h[: nx // 4, : ny // 3] = 1e-4
    a = rng.uniform(0.3, 1.0, (nx, ny))
    a[-(nx // 4):] = rng.uniform(0.0, 0.06, (nx // 4, ny))
    return dict(
        u=fields(rng, 0.2, nx, ny), v=fields(rng, 0.2, nx, ny),
        s11=rng.normal(0.0, 2e3, (3, nx, ny)), s22=rng.normal(0.0, 2e3, (3, nx, ny)),
        s12=rng.normal(0.0, 1e3, (3, nx, ny)), h=h, a=a,
        u_atm=fields(rng, 2.0, nx, ny, 8.0), v_atm=fields(rng, 2.0, nx, ny, 3.0),
        u_ocean=fields(rng, 0.05, nx, ny), v_ocean=fields(rng, 0.05, nx, ny),
    )


def carry_of(state):
    return (state.u, state.v, state.s11, state.s22, state.s12)


# -- the local-node machinery, sampling and masks on every combination of axes ------
@pytest.mark.parametrize("axes", list(AXES))
def test_gather_and_scatter_are_adjoint_on_a_ring_and_match_jax(axes):
    rng = np.random.default_rng(0)
    port, ref = solvers(AXES[axes])
    f = fields(rng, 1.0, NX, NY)
    got = port.gather_local(t_field(f))
    assert np.array_equal(got.numpy(), np.asarray(ref.gather_local(j_field(f))))
    contribs = rng.normal(0.0, 1.0, (9, NX, NY))
    scattered = port.scatter_local(t64(contribs))
    jscattered = ref.scatter_local(j64(contribs))
    for k in PLANES:
        assert np.array_equal(getattr(scattered, k).numpy(), np.asarray(getattr(jscattered, k)))
    lhs = float((got * t64(contribs)).sum())
    rhs = sum(float((t64(f[k]) * getattr(scattered, k)).sum()) for k in PLANES)
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    # Only on a doubly periodic mesh does no node weight fall beyond an edge.
    weights = port.node_weights(device="cpu", dtype=torch.float64)
    total = sum(float(getattr(weights, k).sum()) for k in PLANES)
    assert (abs(total - NX * NY * DX * DX) <= 1e-12 * total) == (axes == "xy")


@pytest.mark.parametrize("axes", ["x", "y", "xy"])
def test_velocity_to_quad_and_vertex_forcing_on_a_ring_match_jax(axes):
    rng = np.random.default_rng(1)
    px, py = AXES[axes]
    d = ho_inputs(1)
    mesh = RectMesh(NX, NY, DX, DX, periodic_x=px, periodic_y=py)
    jmesh = JaxRectMesh(nx=NX, ny=NY, dx=DX, dy=DX, periodic_x=px, periodic_y=py)
    for degree in (1, 2):
        got = mevp_ho.ho_velocity_to_quad(mesh, dg_basis(degree), t_field(d["u"]), t_field(d["v"]))
        want = jax_ho.ho_velocity_to_quad(jmesh, jax_dg_basis(degree), j_field(d["u"]), j_field(d["v"]))
        for name in ("vx_vol", "vy_vol", "vn_x", "vn_y"):
            assert_close(getattr(got, name), getattr(want, name), RTOL_OP, f"{name} dG{degree}")
    vertex = rng.normal(0.0, 1.0, (NX, NY))
    got = mevp_ho.HOField.from_vertex_field(t64(vertex), px, py)
    want = jax_ho.HOField.from_vertex_field(j64(vertex), px, py)
    for k in PLANES:
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k


@pytest.mark.parametrize("axes", list(AXES))
def test_boundary_mask_pins_closed_axes_only(axes):
    port, ref = solvers(AXES[axes])
    mask = port.boundary_mask(device="cpu", dtype=torch.float64)
    jmask = ref.boundary_mask(dtype=jnp.float64)
    for k in PLANES:
        assert np.array_equal(getattr(mask, k).numpy(), np.asarray(getattr(jmask, k))), k
    px, py = AXES[axes]
    assert bool((mask.v[0] == 0).all()) != px and bool((mask.v[:, 0] == 0).all()) != py
    assert bool((mask.c == 1).all())


@pytest.mark.parametrize("axes", ["closed", "xy"])
def test_step_consts_match_jax_on_all_33_weighted_planes(axes):
    d = ho_inputs(2)
    port, ref = solvers(AXES[axes], weighted=True)
    mask = port.boundary_mask(device="cpu", dtype=torch.float64)
    got = port.step_consts(*port_args(d), mask, DT)
    want = ref.step_consts(*jax_args(d), ref.boundary_mask(dtype=jnp.float64), DT)
    assert sorted(got) == sorted(want) == sorted(mevp_ho.HO_WEIGHTED_CONSTS)
    assert len(got) == 33 and port.const_names() == mevp_ho.HO_WEIGHTED_CONSTS
    for name in want:
        assert_close(got[name], want[name], RTOL_OP, name)
    # Partial cover: a_{k} inside [0, 1], and some nodes pinned by a_dyn_min.
    for k in PLANES:
        a_k = got[f"a_{k}"]
        assert bool((a_k >= 0).all() and (a_k <= 1).all()) and bool((a_k < 0.05).any())
    plain = solvers(AXES[axes])[0].step_consts(*port_args(d), mask, DT)
    assert int(got["active_c"].sum()) < int(plain["active_c"].sum())


# -- whole solver steps: twins of the JAX package's tests of these forms --------------
def test_ho_weighted_matches_jax_and_full_cover_is_unweighted():
    """The twin of the JAX HO A-weighted test: 10 subcycles from rest with a
    cover ramp from 0.002 to 0.952 against JAX's plain solver at 1e-8; and
    at A = 1 the weighted step reproduces the unweighted one exactly."""
    n = 16
    port, ref = solvers(weighted=True, nx=n, ny=n, dx=512e3 / n, use_coriolis=False)
    plain, _ = solvers(nx=n, ny=n, dx=512e3 / n, use_coriolis=False)
    kw = dict(device="cpu", dtype=torch.float64)
    h = torch.full((n, n), 2.0, **kw)
    a = 0.002 + 0.95 * torch.arange(n, **kw)[:, None].expand(n, n) / (n - 1)
    const = lambda val: mevp_ho.HOField.from_function(port.mesh, lambda x, y: val + 0 * x, **kw)
    jconst = lambda val: jax_ho.HOField.from_function(ref.mesh, lambda x, y: val + 0 * x, jnp.float64)
    forcing = mevp_ho.HODynamicsForcing(const(8.0), const(2.0), const(0.02), const(0.0))
    jforcing = jax_ho.HODynamicsForcing(jconst(8.0), jconst(2.0), jconst(0.02), jconst(0.0))
    state = mevp_ho.HOVelocityState.zeros(n, n, **kw)
    mask = port.boundary_mask(**kw)
    got = port.step(state, h, a, forcing, mask, DT, 10)
    want = ref.step(
        jax_ho.HOVelocityState.zeros(n, n, jnp.float64), jnp.asarray(h.numpy()), jnp.asarray(a.numpy()),
        jforcing, ref.boundary_mask(dtype=jnp.float64), DT, 10,
    )
    assert_carry_close(carry_of(got), carry_of(want), RTOL_SUBCYCLES)
    ones = torch.ones((n, n), **kw)
    weighted = port.step(state, h, ones, forcing, mask, DT, 10)
    unweighted = plain.step(state, h, ones, forcing, mask, DT, 10)
    for g, r in zip(weighted.u.planes() + weighted.v.planes(), unweighted.u.planes() + unweighted.v.planes()):
        assert torch.equal(g, r)
    assert all(torch.equal(g, r) for g, r in zip(carry_of(weighted)[2:], carry_of(unweighted)[2:]))
    assert float(got.u.c.abs().max()) > 0.0


@pytest.mark.parametrize("axes", ["x", "y", "xy"])
def test_ho_periodic_step_matches_jax(axes):
    """The twin of the JAX HO periodic test at small extents: 10 subcycles
    from rest with a wind that varies along x (so the seam carries signal)
    against JAX's plain solver at 1e-8; the seam rows move."""
    nx, ny = NX, NY
    port, ref = solvers(AXES[axes], nx=nx, ny=ny, dx=512e3 / nx)
    kw = dict(device="cpu", dtype=torch.float64)
    gx = np.sin(np.linspace(0, 2 * np.pi, nx, endpoint=False))[:, None] * np.ones((1, ny)) * 8.0 + 8.0
    wind = {k: gx for k in PLANES}
    const = lambda v: {k: np.full((nx, ny), v) for k in PLANES}
    d = dict(u_atm=wind, v_atm=const(3.0), u_ocean=const(0.02), v_ocean=const(0.0))
    forcing = mevp_ho.HODynamicsForcing(**{k: t_field(v) for k, v in d.items()})
    jforcing = jax_ho.HODynamicsForcing(**{k: j_field(v) for k, v in d.items()})
    h, a = np.full((nx, ny), 2.0), np.full((nx, ny), 0.95)
    got = port.step(mevp_ho.HOVelocityState.zeros(nx, ny, **kw), t64(h), t64(a), forcing,
                    port.boundary_mask(**kw), DT, 10)
    want = ref.step(jax_ho.HOVelocityState.zeros(nx, ny, jnp.float64), j64(h), j64(a), jforcing,
                    ref.boundary_mask(dtype=jnp.float64), DT, 10)
    assert_carry_close(carry_of(got), carry_of(want), RTOL_SUBCYCLES)
    px, py = AXES[axes]
    if px:
        assert float(got.u.v[0].abs().max()) > 1e-6
    if py:
        assert float(got.u.v[:, 0].abs().max()) > 1e-6


@pytest.mark.parametrize("axes", ["closed", "xy"])
def test_ho_a_weighted_step_matches_jax(axes):
    """The A-weighted half of the JAX banded test: a 32^2 cover of
    0.9 + 0.1 sin cos, 12 subcycles from rest, against JAX's plain solver at
    1e-8 (and on a doubly periodic mesh)."""
    n = 32
    port, ref = solvers(AXES[axes], weighted=True, nx=n, ny=n, dx=8e3)
    kw = dict(device="cpu", dtype=torch.float64)
    const = lambda v: {k: np.full((n, n), v) for k in PLANES}
    d = dict(u_atm=const(10.0), v_atm=const(3.0), u_ocean=const(0.02), v_ocean=const(0.0))
    forcing = mevp_ho.HODynamicsForcing(**{k: t_field(v) for k, v in d.items()})
    jforcing = jax_ho.HODynamicsForcing(**{k: j_field(v) for k, v in d.items()})
    h = np.full((n, n), 2.0)
    a = np.clip(0.9 + 0.1 * np.sin(np.arange(n)[:, None] * 0.7) * np.cos(np.arange(n)[None, :] * 0.3), 0.0, 1.0)
    got = port.step(mevp_ho.HOVelocityState.zeros(n, n, **kw), t64(h), t64(a), forcing,
                    port.boundary_mask(**kw), DT, 12)
    want = ref.step(jax_ho.HOVelocityState.zeros(n, n, jnp.float64), j64(h), j64(a), jforcing,
                    ref.boundary_mask(dtype=jnp.float64), DT, 12)
    assert_carry_close(carry_of(got), carry_of(want), RTOL_SUBCYCLES)


@pytest.mark.parametrize("axes, weighted", [("xy", False), ("x", True), ("y", True)])
def test_ho_step_on_seeded_inputs_matches_jax(axes, weighted):
    """15 subcycles from a seeded, moving, partly covered state, with light
    ice and Coriolis, against JAX's plain solver at 1e-8."""
    d = ho_inputs(4)
    port, ref = solvers(AXES[axes], weighted=weighted)
    got = port.step(*port_args(d), port.boundary_mask(device="cpu", dtype=torch.float64), DT, 15)
    want = ref.step(*jax_args(d), ref.boundary_mask(dtype=jnp.float64), DT, 15)
    assert_carry_close(carry_of(got), carry_of(want), RTOL_SUBCYCLES)


# -- the coupled HO step with physics ----------------------------------------------
def coupled_pair(mesh_axes=(False, False), ocean=None, weighted=False, tvb_m=None):
    """The port's and JAX's coupled models with the HO solver selected (the
    JAX one on its staged transport), both registries reset after."""
    px, py = mesh_axes
    JaxModuleRegistry.get_loader().set_implementation("Nextsim::IDynamics", HO)
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
    try:
        jmodel = JaxCoupledModel(
            JaxRectMesh(nx=NX, ny=NY, dx=DX, dy=DX, periodic_x=px, periodic_y=py), degree=1,
            n_subcycles=15, ocean_mask=ocean, transport_backend="xla", tvb_m=tvb_m,
            mevp_params=JaxMEVPParams(a_weighted_stress=weighted),
        )
        port = CoupledModel(
            RectMesh(NX, NY, DX, DX, periodic_x=px, periodic_y=py), degree=1, n_subcycles=15,
            ocean_mask=ocean, tvb_m=tvb_m, mevp_params=MEVPParams(a_weighted_stress=weighted),
        )
    finally:
        JaxModuleRegistry.get_loader().reset()
        modules.get_loader().reset()
    assert jmodel.is_high_order and port.is_high_order
    return port, jmodel


def assert_coupled_steps_match(port, jmodel, seed, n_steps=2):
    """n coupled steps with physics in both: all 18 leaves to 1e-8 of each
    plane's max; returns the JAX leaves."""
    state, dyn, phys = coupled_inputs(seed, NX, NY)
    got = port.run(*to_port(state, dyn, phys), DT, n_steps)
    ref_state, ref_phys, ref_dyn = to_jax(state, dyn, phys)
    for _ in range(n_steps):
        ref_state = jmodel.step(ref_state, ref_phys, ref_dyn, dt=DT)
    got_np = dict(flat_leaves(interop.coupled_state_to_numpy(got)))
    ref_np = dict(flat_leaves(interop.coupled_state_to_numpy(ref_state)))
    assert sorted(got_np) == sorted(ref_np) and len(ref_np) == 18
    for name in ref_np:
        assert_close(got_np[name], ref_np[name], RTOL_SUBCYCLES, name)
    return ref_np


@pytest.mark.parametrize(
    "axes, tvb_m, coast",
    [("xy", None, False), ("xy", 0.0, False), ("x", None, True), ("y", 2e-10, True)],
    ids=["xy", "xy-tvd", "x-coastline", "y-tvb-coastline"],
)
def test_coupled_ho_step_on_a_ring_matches_jax(axes, tvb_m, coast):
    """Two coupled HO steps with physics on a periodic RectMesh, with and
    without the TVB limiter (M = 0 and a middle M) and the coastline,
    against JAX's staged path: the velocity crosses the seam and the
    tracers move."""
    ocean = landmask.synthetic_coastline(NX, NY) if coast else None
    port, jmodel = coupled_pair(AXES[axes], ocean, tvb_m=tvb_m)
    assert port.transport.limits_slopes == (tvb_m is not None)
    ref = assert_coupled_steps_match(port, jmodel, 21)
    if not coast:  # the coastline pins the seam nodes
        px, _ = AXES[axes]
        seam = ref["velocity.u.v"][0] if px else ref["velocity.u.v"][:, 0]
        assert float(np.abs(seam).max()) > 0.0
    assert float(np.abs(ref["hice"][1:]).max()) > 0.0


@pytest.mark.parametrize("axes", ["closed", "xy"])
def test_coupled_a_weighted_ho_step_matches_jax(axes):
    """Two coupled A-weighted HO steps with physics against JAX's."""
    port, jmodel = coupled_pair(AXES[axes], weighted=True)
    assert_coupled_steps_match(port, jmodel, 22)


def test_ho_on_a_ring_runs_every_transport_schedule_on_the_cpu():
    """The HO step on a periodic mesh is accepted on every transport
    backend ("auto" and "tiled" take transport_tiled's qv form on a card,
    "xla" the staged dg1_rk_stage), each the plain step on the CPU."""
    state, dyn, phys = coupled_inputs(23, NX, NY)
    start = to_port(state, dyn, phys)
    outs = []
    for backend in ("auto", "tiled", "xla"):
        modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
        try:
            port = CoupledModel(RectMesh(NX, NY, DX, DX, periodic_x=True, periodic_y=True),
                                n_subcycles=4, transport_backend=backend, tvb_m=0.0)
        finally:
            modules.get_loader().reset()
        assert port.transport_schedule() == ("xla" if backend == "xla" else "tiled")
        outs.append(port.step(*start, DT))
    for out in outs[1:]:
        assert all(torch.equal(getattr(out, n), getattr(outs[0], n)) for n in ("hice", "cice", "hsnow"))


def test_ho_on_a_spherical_ring_matches_jax():
    """Two coupled HO steps with physics on the 360 degree lon-lat ring
    (periodic in x, a spherical metric) against JAX's staged path: the
    velocity crosses the seam."""
    from nextsimdg_tpu.dynamics.mesh import SphericalMesh as JaxSphericalMesh
    from nextsimdg_tpu_torch.dynamics import SphericalMesh

    ring = dict(lon0=0.0, lon1=360.0, lat0=60.0, lat1=70.0, periodic_x=True)
    JaxModuleRegistry.get_loader().set_implementation("Nextsim::IDynamics", HO)
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
    try:
        jmodel = JaxCoupledModel(JaxSphericalMesh(NX, NY, **ring), degree=1, n_subcycles=15,
                                 transport_backend="xla")
        port = CoupledModel(SphericalMesh(NX, NY, **ring), degree=1, n_subcycles=15)
    finally:
        JaxModuleRegistry.get_loader().reset()
        modules.get_loader().reset()
    ref = assert_coupled_steps_match(port, jmodel, 24)
    assert float(np.abs(ref["velocity.u.v"][0]).max()) > 0.0
