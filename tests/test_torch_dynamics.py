"""The port's dynamics modules against the JAX package, at float64 on the CPU.

The same inputs, drawn from a numpy seed, go through the JAX function and
its counterpart in ``nextsimdg_tpu_torch``. Tolerances: exact for the
tables and shifts; rtol 1e-12 (atol 1e-12 x the plane's max |value|) for a
single operation; 1e-8 of each plane's max over many mEVP subcycles, where
the shared divide amplifies rounding differences; k equal exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.dynamics import dgbasis as jax_dgbasis
from nextsimdg_tpu.dynamics import mesh as jax_mesh
from nextsimdg_tpu.dynamics import mevp as jax_mevp
from nextsimdg_tpu.dynamics import stencil as jax_stencil
from nextsimdg_tpu.dynamics import transport as jax_transport
from nextsimdg_tpu_torch.dynamics import dgbasis, mesh, mevp, stencil, transport

torch.set_num_threads(1)

N = 16
DX = 512e3 / N
DT = 600.0
RTOL_OP = 1e-12
RTOL_SUBCYCLES = 1e-8


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


@pytest.fixture
def meshes():
    return (
        mesh.RectMesh(N, N, DX, DX),
        jax_mesh.RectMesh(nx=N, ny=N, dx=DX, dy=DX),
    )


@pytest.fixture
def fields():
    """Seeded velocity, stress, thickness, concentration and forcing planes."""
    rng = np.random.default_rng(7)
    f = lambda scale, shape=(N, N): rng.normal(0.0, scale, shape)
    return dict(
        u=f(0.3), v=f(0.3), s11=f(2e3), s22=f(2e3), s12=f(1e3),
        h=rng.uniform(0.0, 2.5, (N, N)), a=rng.uniform(0.0, 1.0, (N, N)),
        u_atm=8.0 + f(2.0), v_atm=2.0 + f(2.0), u_ocean=f(0.05), v_ocean=f(0.05),
    )


def solvers(meshes, params=None):
    tmesh, jmesh = meshes
    jp = jax_mevp.MEVPParams() if params is None else params
    tp = mevp.MEVPParams(**dataclasses.asdict(jp))
    return mevp.MEVPSolver(tmesh, tp), jax_mevp.MEVPSolver(jmesh, jp, backend="xla")


def inputs(fields, meshes):
    """(torch, jax) versions of (state, h, a, forcing, mask)."""
    tsolver, jsolver = solvers(meshes)
    vel = ("u", "v", "s11", "s22", "s12")
    frc = ("u_atm", "v_atm", "u_ocean", "v_ocean")
    tstate = mevp.VelocityState(**{k: t64(fields[k]) for k in vel})
    jstate = jax_mevp.VelocityState(**{k: j64(fields[k]) for k in vel})
    tforce = mevp.DynamicsForcing(**{k: t64(fields[k]) for k in frc})
    jforce = jax_mevp.DynamicsForcing(**{k: j64(fields[k]) for k in frc})
    tmask = tsolver.boundary_mask(device="cpu", dtype=torch.float64)
    jmask = jsolver.boundary_mask(dtype=jnp.float64)
    return (
        (tstate, t64(fields["h"]), t64(fields["a"]), tforce, tmask),
        (jstate, j64(fields["h"]), j64(fields["a"]), jforce, jmask),
    )


# -- tables, mesh, shifts -------------------------------------------------------
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_dgbasis_tables_equal_exactly(degree):
    got, ref = dgbasis.dg_basis(degree), jax_dgbasis.dg_basis(degree)
    for field in dataclasses.fields(ref):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name
    assert dgbasis.MASS_DIAG.tobytes() == jax_dgbasis.MASS_DIAG.tobytes()


def test_mesh_uniform_closed_and_rejects_the_rest():
    m = mesh.RectMesh(8, 12, 1000.0, 2000.0)
    ref = jax_mesh.RectMesh(nx=8, ny=12, dx=1000.0, dy=2000.0)
    assert (m.dx, m.dy, m.cell_area, m.n_elements) == (ref.dx, ref.dy, ref.cell_area, ref.n_elements)
    assert m.uniform and not m.periodic_x and not m.periodic_y
    # Graded meshes are ported (tests/test_torch_geometry.py), and periodic
    # axes (tests/test_torch_tvb_periodic.py); mismatched spacings are
    # refused.
    assert not mesh.RectMesh(8, 8, np.linspace(1.0, 2.0, 8), 1.0).uniform
    with pytest.raises(ValueError):
        mesh.RectMesh(8, 8, np.linspace(1.0, 2.0, 7), 1.0)
    ring = mesh.RectMesh(8, 8, 1.0, 1.0, periodic_x=True)
    jring = jax_mesh.RectMesh(nx=8, ny=8, dx=1.0, dy=1.0, periodic_x=True)
    assert (ring.periodic_x, ring.periodic_y) == (jring.periodic_x, jring.periodic_y) == (True, False)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2, 3])
def test_shifts_equal_exactly(axis, periodic):
    a = np.random.default_rng(axis).normal(size=(3, 2, 5, 7))
    for t_shift, j_shift in ((stencil.shift_p, jax_stencil.shift_p),
                             (stencil.shift_m, jax_stencil.shift_m)):
        got = t_shift(t64(a), axis, periodic).numpy()
        assert np.array_equal(got, np.asarray(j_shift(j64(a), axis, periodic)))
    assert stencil.is_global_edge("first") is True
    assert stencil.is_global_edge("last") is True


# -- mEVP -------------------------------------------------------------------------
def test_boundary_mask_and_cell_to_node(meshes, fields):
    tsolver, jsolver = solvers(meshes)
    got = tsolver.boundary_mask(device="cpu", dtype=torch.float64)
    assert np.array_equal(got.numpy(), np.asarray(jsolver.boundary_mask(dtype=jnp.float64)))
    assert_close(mevp.cell_to_node(t64(fields["h"])), jax_mevp.cell_to_node(j64(fields["h"])), RTOL_OP)


def test_step_consts(meshes, fields):
    tsolver, jsolver = solvers(meshes)
    targs, jargs = inputs(fields, meshes)
    got = tsolver.step_consts(*targs, DT)
    ref = jsolver.step_consts(*jargs, DT)
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert_close(got[name], ref[name], RTOL_OP, name)


def test_strain_rates_and_stress_divergence(meshes, fields):
    tsolver, jsolver = solvers(meshes)
    got = tsolver.strain_rates(t64(fields["u"]), t64(fields["v"]))
    ref = jsolver.strain_rates(j64(fields["u"]), j64(fields["v"]))
    for g, r, name in zip(got, ref, ("e11", "e22", "e12")):
        assert_close(g, r, RTOL_OP, name)
    stress = ("s11", "s22", "s12")
    got = tsolver.stress_divergence(*(t64(fields[k]) for k in stress))
    ref = jsolver.stress_divergence(*(j64(fields[k]) for k in stress))
    for g, r, name in zip(got, ref, ("fu", "fv")):
        assert_close(g, r, RTOL_OP, name)


def test_subcycle_body_and_its_halves(meshes, fields):
    tsolver, jsolver = solvers(meshes)
    targs, jargs = inputs(fields, meshes)
    tconsts = tsolver.step_consts(*targs, DT)
    jconsts = jsolver.step_consts(*jargs, DT)
    names = ("u", "v", "s11", "s22", "s12")
    tcarry = tuple(getattr(targs[0], k) for k in names)
    jcarry = tuple(getattr(jargs[0], k) for k in names)
    got = tsolver.subcycle_body(tcarry, tconsts, DT)
    ref = jsolver.subcycle_body(jcarry, jconsts, DT)
    for g, r, name in zip(got, ref, names):
        assert_close(g, r, RTOL_OP, name)
    # The two halves (the plain versions of the two mEVP kernels) compose
    # to the subcycle exactly.
    s11, s22, s12, c_w, inv_drag = tsolver.stress_update(tcarry, tconsts)
    u, v = tsolver.velocity_update(
        (tcarry[0], tcarry[1], s11, s22, s12), tconsts, c_w, inv_drag, DT
    )
    for g, r in zip((u, v, s11, s22, s12), got):
        assert torch.equal(g, r)


@pytest.mark.parametrize("use_coriolis", [True, False])
def test_mevp_step_over_subcycles(meshes, fields, use_coriolis):
    params = jax_mevp.MEVPParams(use_coriolis=use_coriolis)
    tsolver, jsolver = solvers(meshes, params)
    targs, jargs = inputs(fields, meshes)
    got = tsolver.step(*targs, DT, n_subcycles=15)
    ref = jsolver.step(*jargs, DT, n_subcycles=15)
    for name in ("u", "v", "s11", "s22", "s12"):
        assert_close(getattr(got, name), getattr(ref, name), RTOL_SUBCYCLES, name)


@pytest.mark.parametrize("option", ["a_weighted_stress", "adaptive_alpha"])
def test_mevp_options_not_ported_raise(meshes, option):
    """Both forms run on one domain and, since M10b part 1, on every rank
    grid schedule (the rdma schedule's rdma_band too); what a rank grid
    refuses is a schedule it has no counterpart of."""
    mevp.MEVPSolver(meshes[0], mevp.MEVPParams(**{option: True}))
    solver = mevp.MEVPSolver(
        meshes[0], mevp.MEVPParams(**{option: True}), backend="rdma", spmd=(object(), None)
    )
    assert solver.schedule() == "rdma"
    with pytest.raises(ValueError, match="backend"):
        mevp.MEVPSolver(
            meshes[0], mevp.MEVPParams(**{option: True}), backend="pallas", spmd=(object(), None)
        )


# -- transport --------------------------------------------------------------------
def transports(meshes, scheme=None):
    tmesh, jmesh = meshes
    return (
        transport.DGTransport(tmesh, degree=1, scheme=scheme),
        jax_transport.DGTransport(jmesh, degree=1, scheme=scheme),
    )


def tracers(seed=3, n_tracers=3):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.0, 1.0, (1, n_tracers, N, N))
    slopes = rng.normal(0.0, 0.4, (2, n_tracers, N, N))
    return np.concatenate([mean, slopes])


def quad_velocities(meshes, fields, scale=1.0):
    ttr, jtr = transports(meshes)
    u, v = scale * fields["u"], scale * fields["v"]
    return (
        transport.velocity_from_cg(meshes[0], ttr.basis, t64(u), t64(v)),
        jax_transport.velocity_from_cg(meshes[1], jtr.basis, j64(u), j64(v)),
    )


def test_apply_table(fields):
    table = np.array([[1.0, 0.0, 0.5], [0.0, 0.0, -2.0]])
    arr = np.stack([fields["u"], fields["v"]])
    got = transport.apply_table(table, t64(arr))
    assert np.array_equal(got.numpy(), np.asarray(jax_transport.apply_table(table, j64(arr))))


def test_velocity_from_cg(meshes, fields):
    tq, jq = quad_velocities(meshes, fields)
    for name in ("vx_vol", "vy_vol", "vn_x", "vn_y"):
        assert_close(getattr(tq, name), getattr(jq, name), RTOL_OP, name)


@pytest.mark.parametrize(
    "scale, k_floor, k_expected",
    # k from the CFL number, from the floor, and capped at 64.
    [(0.01, 1, 1), (40.0, 1, 5), (300.0, 1, 32), (40.0, 20, 20), (3000.0, 1, 64)],
)
def test_cfl_substeps_equal(meshes, fields, scale, k_floor, k_expected):
    tq, jq = quad_velocities(meshes, fields, scale)
    got = transport.cfl_substeps(tq, DT, meshes[0], 1, k_floor=k_floor)
    ref = jax_transport.cfl_substeps(jq, DT, meshes[1], 1, k_floor=k_floor)
    assert got.dtype == torch.int32
    assert int(got) == int(ref) == k_expected


@pytest.mark.parametrize("masked", [False, True])
def test_rhs(meshes, fields, masked):
    ttr, jtr = transports(meshes)
    tq, jq = quad_velocities(meshes, fields)
    psi = tracers()
    masks = None
    if masked:
        rng = np.random.default_rng(11)
        masks = [(rng.uniform(size=(N, N)) > 0.2).astype(float) for _ in range(2)]
    got = ttr.rhs(t64(psi), tq, None if masks is None else [t64(m) for m in masks])
    ref = jtr.rhs(j64(psi), jq, None if masks is None else [j64(m) for m in masks])
    assert_close(got, ref, RTOL_OP)


def test_limit_positivity(meshes):
    ttr, jtr = transports(meshes)
    psi = tracers()
    psi[1:] *= 3.0  # push many corners negative
    got = ttr.limit_positivity(t64(psi))
    ref = jtr.limit_positivity(j64(psi))
    assert_close(got, ref, RTOL_OP)


@pytest.mark.parametrize("scheme", ["rk1", "rk2", "rk3"])
@pytest.mark.parametrize("limit", [False, True])
def test_transport_step(meshes, fields, scheme, limit):
    ttr, jtr = transports(meshes, scheme)
    tq, jq = quad_velocities(meshes, fields)
    psi = tracers()
    got = ttr.step(t64(psi), tq, 300.0, limit=limit)
    ref = jtr.step(j64(psi), jq, 300.0, limit=limit)
    assert_close(got, ref, RTOL_OP)


def test_transport_rejects_unported_degrees(meshes):
    """Every degree of the JAX package (0, 1, 2) is ported, on closed and
    periodic meshes, and since M10b part 1 on a ring of ranks too; a degree
    the JAX package has not raises."""
    from nextsimdg_tpu_torch.parallel import RankGrid

    ring = mesh.RectMesh(N, N, DX, DX, periodic_x=True)
    grid = RankGrid(2, 1, "cpu")
    grid.periodic = (True, False)
    axes = grid.ranks[0].axes
    for degree in (0, 2):
        assert transport.DGTransport(meshes[0], degree=degree).basis.degree == degree
        assert transport.DGTransport(ring, degree=degree).mesh.periodic_x
        on_ring = transport.DGTransport(ring, degree=degree, spmd=axes)
        assert on_ring.basis.degree == degree and on_ring.spmd[0].periodic
    with pytest.raises(ValueError, match="degree"):
        transport.DGTransport(meshes[0], degree=3)
