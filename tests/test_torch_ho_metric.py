"""The higher-order solver on graded and spherical meshes: the port against
the JAX package.

At float64 on the CPU, the same numpy inputs go through the JAX package's
plain (``backend="xla"``) ``MEVPSolverHO`` and staged ``CoupledModel`` with
``Nextsim::MEVPHighOrder`` selected, and through ``nextsimdg_tpu_torch``'s
plain versions, on a tensor-graded ``RectMesh``, a closed lon-lat window
and a 360 degree lon-lat ring (periodic in x): twins of the JAX package's
own metric HO tests, the 33 and 37 const planes of ``step_consts``, whole
solver steps and coupled HO steps with physics on the spherical coastline
mesh and the ring, with and without the TVB limiter, on both transport
schedules. Every test that selects the HO solver resets both registries in
``finally``. Tolerances: 1e-12 for exact strains and forces and for one
operation; 1e-8 of each plane's max after 15 subcycles, where the shared
divide amplifies rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics import mevp_ho as jax_ho
from nextsimdg_tpu.dynamics.mesh import SphericalMesh as JaxSphericalMesh
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, landmask, mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import ho_single_cuda, ho_tiled_cuda
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, MEVPParams
from nextsimdg_tpu_torch.state import Forcing

from test_torch_ho import (
    HO, PLANES, assert_carry_close, assert_close, coupled_inputs, flat_leaves, j64, j_field,
    jax_args, port_args, t64, t_field, to_jax, to_port,
)
from test_torch_ho_forms import carry_of, ho_inputs

torch.set_num_threads(1)

NX, NY = 16, 12
DT = 600.0
RTOL_OP = 1e-12
RTOL_SUBCYCLES = 1e-8
#: The metric meshes as (port, JAX) constructor arguments: a tensor-graded
#: RectMesh (dx graded along x, dy along y), a closed lon-lat window and the
#: 360 degree ring.
MESHES = {
    "graded": dict(dx=4e3 * (1.0 + 0.05 * np.arange(NX)), dy=3e3 * (1.0 + 0.04 * np.arange(NY)[::-1])),
    "spherical": dict(lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0),
    "ring": dict(lon0=0.0, lon1=360.0, lat0=60.0, lat1=85.0, periodic_x=True),
}


def meshes(kind, nx=NX, ny=NY):
    """The port's and JAX's mesh of a kind."""
    kw = MESHES[kind]
    if kind == "graded":
        return RectMesh(nx, ny, kw["dx"], kw["dy"]), JaxRectMesh(nx=nx, ny=ny, dx=kw["dx"], dy=kw["dy"])
    return SphericalMesh(nx, ny, **kw), JaxSphericalMesh(nx, ny, **kw)


def solvers(kind, weighted=False, **params):
    """The port's and JAX's plain HO solvers on one metric mesh and form."""
    mesh, jmesh = meshes(kind)
    return (
        mevp_ho.MEVPSolverHO(mesh, MEVPParams(a_weighted_stress=weighted, **params)),
        jax_ho.MEVPSolverHO(jmesh, JaxMEVPParams(a_weighted_stress=weighted, **params), backend="xla"),
    )


def select_ho():
    JaxModuleRegistry.get_loader().set_implementation("Nextsim::IDynamics", HO)
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)


def reset_registries():
    JaxModuleRegistry.get_loader().reset()
    modules.get_loader().reset()


# -- twins of the JAX package's tests of the metric HO solver -------------------------
def test_ho_strain_exact_on_graded_mesh():
    """The twin of the JAX test: the strain of a linear velocity is exact on
    a tensor-graded mesh, each element with its own widths."""
    dx, dy = 1.0 + 0.2 * np.arange(8), 2.0 - 0.1 * np.arange(8)
    solver = mevp_ho.MEVPSolverHO(RectMesh(8, 8, dx, dy))
    kw = dict(device="cpu", dtype=torch.float64)
    u = mevp_ho.HOField.from_function(solver.mesh, lambda x, y: 2.0 * x + 0.3 * y, **kw)
    v = mevp_ho.HOField.from_function(solver.mesh, lambda x, y: -0.5 * x + 0.7 * y, **kw)
    e11, e22, e12 = solver.strain_rates(u, v)
    interior = (slice(None, -1), slice(None, -1))
    np.testing.assert_allclose(e11[0].numpy()[interior], 2.0, rtol=RTOL_OP)
    np.testing.assert_allclose(e22[0].numpy()[interior], 0.7, rtol=RTOL_OP)
    np.testing.assert_allclose(e12[0].numpy()[interior], -0.1, rtol=RTOL_OP)


def test_ho_stress_divergence_exact_on_graded_mesh():
    """The twin of the JAX test: F/W equals div sigma for sigma11 = x on a
    graded mesh (each element's x-slope coefficient its own width)."""
    dx = 1.0 + 0.15 * np.arange(10)
    solver = mevp_ho.MEVPSolverHO(RectMesh(10, 10, dx, 1.7))
    xn = np.concatenate([[0.0], np.cumsum(dx)])
    xc = 0.5 * (xn[:-1] + xn[1:])
    s11 = torch.zeros((3, 10, 10), dtype=torch.float64)
    s11[0] = t64(np.broadcast_to(xc[:, None], (10, 10)))
    s11[1] = t64(np.broadcast_to(dx[:, None], (10, 10)))
    zero = torch.zeros_like(s11)
    fu, _ = solver.stress_divergence(s11, zero, zero)
    weights = solver.node_weights(device="cpu", dtype=torch.float64)
    for k in PLANES:
        f = (getattr(fu, k) / getattr(weights, k)).numpy()
        np.testing.assert_allclose(f[2:-2, 2:-2], 1.0, rtol=1e-10, err_msg=k)


def test_ho_coupled_runs_on_spherical_mesh():
    """The twin of the JAX test: two float32 coupled HO steps on a lon-lat
    window, finite, float32, and the ice moves."""
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
    try:
        model = CoupledModel(SphericalMesh(12, 12, 0.0, 10.0, 70.0, 78.0), degree=1, n_subcycles=10)
    finally:
        modules.get_loader().reset()
    assert isinstance(model.mevp, mevp_ho.MEVPSolverHO)
    kw = dict(device="cpu", dtype=torch.float32)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, **kw)
    full = lambda v: torch.full((12, 12), v, **kw)
    pf = Forcing(tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                 lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    df = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    for _ in range(2):
        state = model.step(state, pf, df, DT)
    for _, leaf in flat_leaves(interop.coupled_state_to_numpy(state)):
        assert np.all(np.isfinite(leaf))
    assert state.hice.dtype == torch.float32
    assert float(state.velocity.u.v.abs().max()) > 0.0


def test_ho_kernel_wrappers_run_the_plain_version_on_a_graded_mesh():
    """The twin of the JAX metric-kernel test: on the CPU ho_single's and
    ho_tiled's wrappers run the plain version on a graded mesh (exactly
    15 plain subcycles), which matches JAX's plain solver at 1e-8."""
    port, ref = solvers("graded")
    kw = dict(device="cpu", dtype=torch.float64)
    const = lambda v: mevp_ho.HOField.from_function(port.mesh, lambda x, y: v + 0 * x, **kw)
    jconst = lambda v: jax_ho.HOField.from_function(ref.mesh, lambda x, y: v + 0 * x, jnp.float64)
    forcing = mevp_ho.HODynamicsForcing(const(10.0), const(3.0), const(0.0), const(0.0))
    jforcing = jax_ho.HODynamicsForcing(jconst(10.0), jconst(3.0), jconst(0.0), jconst(0.0))
    h, a = np.full((NX, NY), 2.0), np.full((NX, NY), 0.95)
    state = mevp_ho.HOVelocityState.zeros(NX, NY, **kw)
    consts = port.step_consts(state, t64(h), t64(a), forcing, port.boundary_mask(**kw), DT)
    carry = carry_of(state)
    plain = mevp_ho.ho_subcycles_reference(port, carry, consts, DT, 15)
    for run in (ho_single_cuda.ho_subcycles_single, ho_tiled_cuda.ho_subcycles_tiled):
        got = run(port, carry, consts, DT, 15)
        for g, r in zip(cc.ho_flatten(got), cc.ho_flatten(plain)):
            assert torch.equal(g, r)
    want = ref.step(jax_ho.HOVelocityState.zeros(NX, NY, jnp.float64), j64(h), j64(a), jforcing,
                    ref.boundary_mask(dtype=jnp.float64), DT, 15)
    assert_carry_close(plain, carry_of(want), RTOL_SUBCYCLES)
    assert float(plain[0].c.abs().max()) > 0.0


# -- step_consts and whole solver steps against the JAX package -----------------------
@pytest.mark.parametrize(
    "kind, weighted", [("graded", False), ("graded", True), ("spherical", False), ("ring", True)],
)
def test_step_consts_match_jax_on_every_metric_plane(kind, weighted):
    """All 33 (37 A-weighted) const planes: the 29 (33), then dx, dy and
    their reciprocals, the lumped masses taking the element areas."""
    d = ho_inputs(5, NX, NY)
    port, ref = solvers(kind, weighted)
    mask = port.boundary_mask(device="cpu", dtype=torch.float64)
    got = port.step_consts(*port_args(d), mask, DT)
    want = ref.step_consts(*jax_args(d), ref.boundary_mask(dtype=jnp.float64), DT)
    expected = (mevp_ho.HO_WEIGHTED_CONSTS if weighted else mevp_ho.HO_CONSTS) + mevp_ho.HO_METRIC_CONSTS
    assert sorted(got) == sorted(want) == sorted(expected)
    assert port.const_names() == expected and len(got) == (37 if weighted else 33)
    assert ref._n_consts() == len(got)
    for name in want:
        assert_close(got[name], want[name], RTOL_OP, name)


@pytest.mark.parametrize(
    "kind, weighted", [("graded", False), ("spherical", True), ("ring", False), ("ring", True)],
)
def test_ho_metric_step_matches_jax(kind, weighted):
    """15 subcycles from a seeded, moving, partly covered state, with light
    ice and Coriolis, against JAX's plain solver at 1e-8."""
    d = ho_inputs(6, NX, NY)
    port, ref = solvers(kind, weighted)
    got = port.step(*port_args(d), port.boundary_mask(device="cpu", dtype=torch.float64), DT, 15)
    want = ref.step(*jax_args(d), ref.boundary_mask(dtype=jnp.float64), DT, 15)
    assert_carry_close(carry_of(got), carry_of(want), RTOL_SUBCYCLES)
    if kind == "ring":  # the seam carries signal
        assert float(got.u.v[0].abs().max()) > 1e-6


# -- the coupled HO step with physics --------------------------------------------------
def coupled_pair(kind, tvb_m=None, transport_backend="auto", jax_transport="xla", coast=True):
    """The port's and JAX's coupled HO models on a metric mesh with the
    synthetic coastline, both registries reset after."""
    mesh, jmesh = meshes(kind)
    ocean = landmask.synthetic_coastline(NX, NY) if coast else None
    select_ho()
    try:
        jmodel = JaxCoupledModel(jmesh, degree=1, n_subcycles=15, ocean_mask=ocean,
                                 transport_backend=jax_transport, tvb_m=tvb_m)
        port = CoupledModel(mesh, degree=1, n_subcycles=15, ocean_mask=ocean, tvb_m=tvb_m,
                            transport_backend=transport_backend)
    finally:
        reset_registries()
    assert jmodel.is_high_order and port.is_high_order
    return port, jmodel


@pytest.mark.parametrize(
    "kind, tvb_m, transport_backend, jax_transport",
    [
        ("spherical", None, "auto", "tiled-interpret"),
        ("spherical", 0.0, "auto", "xla"),
        ("ring", None, "xla", "xla"),
        ("ring", 2e-10, "auto", "xla"),
    ],
    ids=["spherical", "spherical-tvd", "ring-staged", "ring-tvb"],
)
def test_coupled_ho_metric_step_matches_jax(kind, tvb_m, transport_backend, jax_transport):
    """Two coupled HO steps with physics on the spherical coastline mesh and
    the ring, with and without the TVB limiter, on "auto" and the staged
    schedule (JAX's tiled kernel in interpret mode where it runs the same
    transport), against JAX: all 18 leaves at 1e-8 of each plane's max; the
    tracers move and land is untouched."""
    port, jmodel = coupled_pair(kind, tvb_m, transport_backend, jax_transport)
    state, dyn, phys = coupled_inputs(31, NX, NY)
    got = port.run(*to_port(state, dyn, phys), DT, 2)
    ref_state, ref_phys, ref_dyn = to_jax(state, dyn, phys)
    for _ in range(2):
        ref_state = jmodel.step(ref_state, ref_phys, ref_dyn, dt=DT)
    got_np = dict(flat_leaves(interop.coupled_state_to_numpy(got)))
    ref_np = dict(flat_leaves(interop.coupled_state_to_numpy(ref_state)))
    assert sorted(got_np) == sorted(ref_np) and len(ref_np) == 18
    for name in ref_np:
        assert_close(got_np[name], ref_np[name], RTOL_SUBCYCLES, name)
    land = port.ocean_mask == 0.0
    assert np.array_equal(got_np["hice"][0][land], state["hice"][0][land])
    assert float(np.abs(got_np["hice"][0] - state["hice"][0]).max()) > 0.0


@pytest.mark.parametrize("kind", ["spherical", "ring", "graded"])
@pytest.mark.parametrize("tvb_m", [None, 0.0], ids=["no-tvb", "tvb"])
def test_ho_transport_schedule_on_a_metric_mesh(kind, tvb_m):
    """"auto" takes transport_tiled on the CG2 samples, except with the TVB
    limiter on a graded or spherical mesh, whose per-element tolerance only
    the staged transport takes (as the JAX gate transport_tiled_config
    has it); an explicit "tiled" raises there at construction."""
    mesh, _ = meshes(kind)
    modules.get_loader().set_implementation("Nextsim::IDynamics", HO)
    try:
        model = CoupledModel(mesh, tvb_m=tvb_m)
        assert model.transport_schedule() == ("tiled" if tvb_m is None else "xla")
        assert CoupledModel(mesh, tvb_m=tvb_m, transport_backend="xla").transport_schedule() == "xla"
        if tvb_m is None:
            assert CoupledModel(mesh, transport_backend="tiled").transport_schedule() == "tiled"
        else:
            with pytest.raises(NotImplementedError, match="staged transport"):
                CoupledModel(mesh, tvb_m=tvb_m, transport_backend="tiled")
    finally:
        modules.get_loader().reset()
    assert model.mevp_schedule() == "single" and model.is_high_order
    assert cc.kernel_form(model.mevp) & cc.HO_FORM_METRIC


def test_only_adaptive_alpha_still_raises_on_a_metric_mesh():
    """Every metric mesh builds the HO solver, closed, periodic and
    A-weighted; adaptive alpha raises, as in the JAX package."""
    for kind in MESHES:
        for weighted in (False, True):
            solver = mevp_ho.MEVPSolverHO(meshes(kind)[0], MEVPParams(a_weighted_stress=weighted))
            assert solver.const_names()[-4:] == mevp_ho.HO_METRIC_CONSTS
    with pytest.raises(NotImplementedError, match="CG1 solver only"):
        mevp_ho.MEVPSolverHO(meshes("ring")[0], MEVPParams(adaptive_alpha=True))
