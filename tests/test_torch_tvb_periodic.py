"""The TVB slope limiter and periodic axes: the port against the JAX package.

At float64 on the CPU, the same seeded numpy inputs go through the JAX
package and ``nextsimdg_tpu_torch``: ``DGTransport.limit_slopes`` on every
mesh kind and periodic combination (exact to 1e-12), twins of the JAX
package's transport, limiter, graded-mesh and spherical tests on periodic
meshes, the coupled step on each periodic combination with and without TVB
and a coastline at dG1 and dG2 (1e-8 of each plane's max after 15
subcycles, where the shared divide amplifies rounding), free drift on a
periodic mesh, the node masks and the schedule rules. The CUDA forms are
held against these plain versions on the card (``tests/test_torch_kernels.py``,
marked ``cuda``, and ``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.dynamics import mesh as jax_mesh
from nextsimdg_tpu.dynamics import mevp as jax_mevp
from nextsimdg_tpu.dynamics import stencil as jax_stencil
from nextsimdg_tpu.dynamics import transport as jax_transport
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import landmask, mevp, stencil, transport
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.mesh import EARTH_RADIUS, RectMesh, SphericalMesh

torch.set_num_threads(1)

N = 16
DT = 600.0
RTOL_OP = 1e-12
RTOL = 1e-8
VELOCITY = ("u", "v", "s11", "s22", "s12")
#: (periodic_x, periodic_y) by name.
PERIODIC = {"closed": (False, False), "x": (True, False), "y": (False, True), "xy": (True, True)}


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


def description(kind, periodic, n=N):
    """A mesh description (interop.mesh_from_description) of each kind."""
    px, py = PERIODIC[periodic]
    if kind == "uniform":
        return dict(kind="rect", nx=n, ny=n + 2, dx=4e3, dy=5e3, periodic_x=px, periodic_y=py)
    if kind == "graded":
        return dict(
            kind="rect", nx=n, ny=n + 2, dx=30e3 * (1.0 + 0.05 * np.arange(n)),
            dy=32e3 * (1.0 + 0.03 * np.arange(n + 2)[::-1]), periodic_x=px, periodic_y=py,
        )
    lon1 = 360.0 if px else 40.0
    return dict(kind="spherical", nx=n, ny=n + 2, lon0=0.0, lon1=lon1, lat0=60.0, lat1=85.0,
                periodic_x=px)


def jax_mesh_of(d):
    if d["kind"] == "rect":
        return jax_mesh.RectMesh(
            nx=d["nx"], ny=d["ny"], dx=d["dx"], dy=d["dy"],
            periodic_x=d.get("periodic_x", False), periodic_y=d.get("periodic_y", False),
        )
    return jax_mesh.SphericalMesh(
        d["nx"], d["ny"], lon0=d["lon0"], lon1=d["lon1"], lat0=d["lat0"], lat1=d["lat1"],
        periodic_x=d.get("periodic_x", False),
    )


MESH_CASES = [
    (kind, periodic)
    for kind in ("uniform", "graded", "spherical")
    for periodic in PERIODIC
    if kind != "spherical" or periodic in ("closed", "x")
]


# -- limit_slopes -----------------------------------------------------------------------------
@pytest.mark.parametrize("kind, periodic", MESH_CASES, ids=[f"{k}-{p}" for k, p in MESH_CASES])
def test_limit_slopes_equals_jax(kind, periodic):
    """Seeded moments at dG1 and dG2 (two tracers), M = 0 (pure TVD), an M
    that cuts some elements and keeps others (from the moments' median
    against the mean width), and M = 50: the port's limiter equals JAX's to
    1e-12; the first two cut at least one element, the middle one keeps at
    least one."""
    desc = description(kind, periodic)
    tmesh, jmesh = interop.mesh_from_description(desc), jax_mesh_of(desc)
    assert (tmesh.periodic_x, tmesh.periodic_y) == (jmesh.periodic_x, jmesh.periodic_y)
    rng = np.random.default_rng(11)
    width = float(np.mean(np.asarray(tmesh.dx)))
    for degree, n_dofs in ((1, 3), (2, 6)):
        psi = rng.normal(0.0, 1.0, (n_dofs, 2, desc["nx"], desc["ny"]))
        psi[0] += 3.0
        m_mid = float(np.median(np.abs(psi[1]))) / width**2
        for m in (0.0, m_mid, 50.0):
            got = transport.DGTransport(tmesh, degree=degree, tvb_m=m).limit_slopes(t64(psi))
            ref = jax_transport.DGTransport(jmesh, degree=degree, tvb_m=m).limit_slopes(j64(psi))
            assert_close(got, ref, RTOL_OP, f"dG{degree} M={m}")
            cut = got.numpy()[1:3] != psi[1:3]
            assert np.array_equal(got.numpy()[0], psi[0])
            if m != 50.0:
                assert cut.any(), m
            if m == m_mid:
                assert not cut.all()


def test_limit_slopes_takes_wall_masks_as_jax():
    """Explicit wall-delta masks (fwd_x, bwd_x, fwd_y, bwd_y) replace the
    mesh's walls, as in the JAX package."""
    desc = description("uniform", "closed")
    tmesh, jmesh = interop.mesh_from_description(desc), jax_mesh_of(desc)
    rng = np.random.default_rng(5)
    psi = rng.normal(0.0, 1.0, (3, 2, desc["nx"], desc["ny"]))
    masks = [(rng.uniform(size=(desc["nx"], desc["ny"])) > 0.7).astype(float) for _ in range(4)]
    got = transport.DGTransport(tmesh, tvb_m=0.0).limit_slopes(t64(psi), [t64(m) for m in masks])
    ref = jax_transport.DGTransport(jmesh, tvb_m=0.0).limit_slopes(j64(psi), [j64(m) for m in masks])
    assert_close(got, ref, RTOL_OP)
    assert not torch.equal(got, transport.DGTransport(tmesh, tvb_m=0.0).limit_slopes(t64(psi)))


def test_tvb_tolerances_evaluate_left_to_right():
    """M dx^2 as tvb_m * dx * dx: floats on a uniform mesh, planes of the
    per-element widths cast to the dtype first elsewhere."""
    tr = transport.DGTransport(RectMesh(4, 6, 3e3, 5e3), tvb_m=0.7)
    assert tr.tvb_tolerances(device="cpu", dtype=torch.float32) == (0.7 * 3e3 * 3e3, 0.7 * 5e3 * 5e3)
    sphere = SphericalMesh(4, 6, 0.0, 360.0, 60.0, 80.0, periodic_x=True)
    tol_x, tol_y = transport.DGTransport(sphere, tvb_m=0.7).tvb_tolerances(device="cpu", dtype=torch.float32)
    dx = torch.as_tensor(sphere.dx).to(torch.float32)
    assert torch.equal(tol_x, (0.7 * dx * dx).expand(4, 6))
    assert torch.equal(tol_y, torch.full((4, 6), 0.7 * sphere.dy * sphere.dy, dtype=torch.float32))
    assert tol_x.is_contiguous() and transport.DGTransport(sphere).tvb_m is None


# -- twins of the JAX package's transport tests on periodic meshes -----------------------------
def periodic_unit_square(n, **kwargs):
    return (RectMesh(n, n, 1.0 / n, 1.0 / n, periodic_x=True, periodic_y=True),
            jax_mesh.RectMesh(nx=n, ny=n, dx=1.0 / n, dy=1.0 / n, periodic_x=True, periodic_y=True))


def pair(tmesh, jmesh, **kwargs):
    return transport.DGTransport(tmesh, **kwargs), jax_transport.DGTransport(jmesh, **kwargs)


def sampled(tmesh, jmesh, tr, jtr, fn):
    return (transport.sample_velocity(tmesh, tr.basis, fn, device="cpu", dtype=torch.float64),
            jax_transport.sample_velocity(jmesh, jtr.basis, fn, dtype=jnp.float64))


def test_constant_field_is_steady_on_a_periodic_mesh():
    """Twin of tests/test_transport.py::test_constant_field_is_steady_under_divergence_free_velocity."""
    tmesh, jmesh = periodic_unit_square(16)
    tr, jtr = pair(tmesh, jmesh, degree=2)
    vel, jvel = sampled(tmesh, jmesh, tr, jtr, lambda x, y: (np.ones_like(x), 0.5 * np.ones_like(x)))
    psi = tr.project(lambda x, y: np.ones_like(x), device="cpu", dtype=torch.float64)
    out = tr.run(psi, vel, 0.001, 50)
    np.testing.assert_allclose(out[0].numpy(), 1.0, rtol=1e-10)
    np.testing.assert_allclose(out[1:].numpy(), 0.0, atol=1e-10)
    assert_close(out, jtr.run(j64(psi), jvel, 0.001, 50), RTOL_OP)


def _gaussian(x, y, cx=0.5, cy=0.5, width=0.07):
    return np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * width**2))


def test_periodic_translation_returns_to_start():
    """Twin of tests/test_transport.py::test_periodic_translation_returns_to_start:
    dG2 once around the periodic square, small error and exact mass; the
    first steps equal JAX's."""
    n = 32
    tmesh, jmesh = periodic_unit_square(n)
    tr, jtr = pair(tmesh, jmesh, degree=2)
    vel, jvel = sampled(tmesh, jmesh, tr, jtr, lambda x, y: (np.ones_like(x), np.zeros_like(y)))
    psi0 = tr.project(_gaussian, device="cpu", dtype=torch.float64)
    steps = 640
    assert_close(tr.run(psi0, vel, 1.0 / steps, 8), jtr.run(j64(psi0), jvel, 1.0 / steps, 8), RTOL_OP)
    psi = tr.run(psi0, vel, 1.0 / steps, steps)
    err = float(np.sqrt(np.mean((psi[0].numpy() - psi0[0].numpy()) ** 2)))
    assert err < 5e-3, err
    np.testing.assert_allclose(float(tr.total_mass(psi)), float(tr.total_mass(psi0)), rtol=1e-12)


def test_substeps_on_a_periodic_channel_match_jax():
    """Twin of tests/test_transport.py::test_transport_substeps_stabilize_high_cfl:
    the free-drift-like channel (p* = 0), periodic in both axes, at CFL
    ~0.65; transport_substeps=2 advects twice with dt/2 from the post-mEVP
    velocity, and the step equals JAX's."""
    n, dx, dt = 64, 1000.0, 800.0
    tmesh = RectMesh(n, 8, dx, dx, periodic_x=True, periodic_y=True)
    jmesh = jax_mesh.RectMesh(nx=n, ny=8, dx=dx, dy=dx, periodic_x=True, periodic_y=True)
    tp = mevp.MEVPParams(p_star=0.0, use_coriolis=False)
    jp = jax_mevp.MEVPParams(p_star=0.0, use_coriolis=False)
    bump = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(n) / n)
    full = lambda v: np.full((n, 8), v)
    dyn = dict(u_atm=full(10.0), v_atm=full(0.0), u_ocean=full(0.0), v_ocean=full(0.0))
    model = CoupledModel(tmesh, n_subcycles=40, mevp_params=tp, transport_substeps=2, auto_substeps=False)
    state = model.initial_state(hice0=1.0, cice0=0.8, device="cpu", dtype=torch.float64)
    hice = state.hice.clone()
    hice[0] = t64(bump)[:, None]
    state = dataclasses.replace(state, hice=hice)
    df = interop.dynamics_forcing_from_numpy(dyn, device="cpu", dtype=torch.float64)
    out = model.step(state, None, df, dt, do_thermo=False)
    for _ in range(5):
        out = model.step(out, None, df, dt, do_thermo=False)
    assert bool(torch.isfinite(out.hice).all()) and float(out.hice[0].min()) > -1e-6
    jmodel = JaxCoupledModel(jmesh, degree=1, mevp_params=jp, n_subcycles=40, transport_substeps=2,
                             auto_substeps=False)
    jstate = dataclasses.replace(
        jmodel.initial_state(hice0=1.0, cice0=0.8, dtype=jnp.float64), hice=j64(state.hice)
    )
    jdf = jax_mevp.DynamicsForcing(**{k: j64(v) for k, v in dyn.items()})
    got = model.step(state, None, df, dt, do_thermo=False)
    ref = jmodel.step(jstate, None, jdf, dt, do_thermo=False)
    assert_close(got.hice, ref.hice, RTOL)
    assert_close(got.velocity.u, ref.velocity.u, RTOL)


def test_tvb_limiter_preserves_linears_periodic():
    """Twin of tests/test_transport.py::test_tvb_limiter_preserves_linears_periodic."""
    tmesh, jmesh = periodic_unit_square(16)
    tr, jtr = pair(tmesh, jmesh, degree=2, tvb_m=0.0)
    psi = tr.project(lambda x, y: 2.0 + np.sin(2 * np.pi * x), device="cpu", dtype=torch.float64)
    out = tr.limit_slopes(psi)
    assert torch.equal(out[0], psi[0])
    assert_close(out, jtr.limit_slopes(j64(psi)), RTOL_OP)
    lin = tr.project(lambda x, y: 3.0 * x - 1.0 * y, device="cpu", dtype=torch.float64)
    out_lin = tr.limit_slopes(lin)
    np.testing.assert_allclose(out_lin[1][1:-1, 1:-1].numpy(), lin[1][1:-1, 1:-1].numpy(), rtol=0, atol=1e-12)


def _square(x, y):
    return ((np.abs(x - 0.5) < 0.15) & (np.abs(y - 0.5) < 0.2)).astype(float)


def test_tvb_limiter_bounds_dg2_square_wave():
    """Twin of tests/test_transport.py::test_tvb_limiter_bounds_dg2_square_wave:
    positivity alone rings above 1, TVB keeps the means bounded, mass is
    exact; the first steps equal JAX's."""
    n = 32
    tmesh, jmesh = periodic_unit_square(n)
    results = {}
    for name, tvb_m in (("pos_only", None), ("tvb", 0.0)):
        tr, jtr = pair(tmesh, jmesh, degree=2, tvb_m=tvb_m)
        vel, jvel = sampled(tmesh, jmesh, tr, jtr, lambda x, y: (np.ones_like(x), np.zeros_like(y)))
        psi = tr.project(_square, device="cpu", dtype=torch.float64)
        jpsi = j64(psi)
        mass0 = float(tr.total_mass(psi))
        dt = 1.0 / 320
        for step in range(160):
            psi = tr.step(psi, vel, dt, limit=True)
            if step < 4:
                jpsi = jtr.step(jpsi, jvel, dt, limit=True)
                assert_close(psi, jpsi, RTOL_OP, name)
        results[name] = psi[0].numpy()
        np.testing.assert_allclose(float(tr.total_mass(psi)), mass0, rtol=1e-12)
    assert results["pos_only"].max() - 1.0 > 1e-3
    assert results["tvb"].max() - 1.0 < 1e-4
    assert results["tvb"].min() > -1e-12


def _pointwise_min(tr, psi):
    values = transport.apply_table(tr._limit_table, psi)
    return float(values.min())


def test_limited_advection_keeps_tracer_nonnegative():
    """Twin of tests/test_limiter.py::test_limited_advection_keeps_tracer_nonnegative."""
    n = 32
    tmesh, jmesh = periodic_unit_square(n)
    tr, jtr = pair(tmesh, jmesh, degree=2)
    vel, jvel = sampled(tmesh, jmesh, tr, jtr, lambda x, y: (np.ones_like(x), np.zeros_like(y)))
    blob = lambda x, y: np.where((np.abs(x - 0.5) < 0.15) & (np.abs(y - 0.5) < 0.15), 1.0, 0.0)
    psi0 = tr.project(blob, device="cpu", dtype=torch.float64)
    unlimited, limited = psi0, psi0
    dt = 1.0 / 320
    for _ in range(60):
        unlimited = tr.step(unlimited, vel, dt)
        limited = tr.step(limited, vel, dt, limit=True)
    assert _pointwise_min(tr, unlimited) < -1e-3
    assert _pointwise_min(tr, limited) >= -1e-10
    np.testing.assert_allclose(float(tr.total_mass(limited)), float(tr.total_mass(psi0)), rtol=1e-12)
    ref = j64(psi0)
    for _ in range(4):
        ref = jtr.step(ref, jvel, dt, limit=True)
    got = psi0
    for _ in range(4):
        got = tr.step(got, vel, dt, limit=True)
    assert_close(got, ref, RTOL_OP)


def graded_spacings(n, lo=0.5, hi=2.0):
    """tests/test_graded_mesh.py's smoothly graded widths."""
    s = np.linspace(0.0, 1.0, n)
    return lo + (hi - lo) * 0.5 * (1.0 - np.cos(np.pi * s))


def graded_pair(n, dx, dy):
    return (RectMesh(n, n, dx, dy, periodic_x=True, periodic_y=True),
            jax_mesh.RectMesh(nx=n, ny=n, dx=dx, dy=dy, periodic_x=True, periodic_y=True))


def test_graded_periodic_transport_conserves_mass_exactly():
    """Twin of tests/test_graded_mesh.py::test_graded_transport_conserves_mass_exactly."""
    n = 24
    tmesh, jmesh = graded_pair(n, graded_spacings(n, 0.5, 2.0), graded_spacings(n, 1.0, 1.5))
    tr, jtr = pair(tmesh, jmesh, degree=2)
    vel, jvel = sampled(tmesh, jmesh, tr, jtr, lambda x, y: (0.7 * np.ones_like(x), -0.4 * np.ones_like(y)))
    lx, ly = jmesh.lx, jmesh.ly
    blob = lambda x, y: np.exp(-((x - 0.4 * lx) ** 2 + (y - 0.6 * ly) ** 2) / (0.02 * lx * ly))
    psi0 = tr.project(blob, device="cpu", dtype=torch.float64)
    psi, ref = psi0, j64(psi0)
    for step in range(40):
        psi = tr.step(psi, vel, 0.05, limit=True)
        if step < 4:
            ref = jtr.step(ref, jvel, 0.05, limit=True)
    np.testing.assert_allclose(float(tr.total_mass(psi)), float(tr.total_mass(psi0)), rtol=1e-12)
    assert bool(torch.isfinite(psi).all())
    four = psi0
    for _ in range(4):
        four = tr.step(four, vel, 0.05, limit=True)
    assert_close(four, ref, RTOL_OP)


def test_graded_periodic_constant_preserved():
    """Twin of tests/test_graded_mesh.py::test_graded_constant_preserved."""
    n = 16
    tmesh, jmesh = graded_pair(n, graded_spacings(n), graded_spacings(n))
    tr, jtr = pair(tmesh, jmesh, degree=1)
    vel, jvel = sampled(tmesh, jmesh, tr, jtr, lambda x, y: (np.ones_like(x), 0.5 * np.ones_like(y)))
    psi = tr.project(lambda x, y: np.ones_like(x), device="cpu", dtype=torch.float64)
    ref = j64(psi)
    for _ in range(20):
        psi = tr.step(psi, vel, 0.05)
        ref = jtr.step(ref, jvel, 0.05)
    np.testing.assert_allclose(psi[0].numpy(), 1.0, rtol=1e-10)
    np.testing.assert_allclose(psi[1:].numpy(), 0.0, atol=1e-10)
    assert_close(psi, ref, RTOL_OP)


def test_rigid_rotation_on_the_ring_converges():
    """Twin of tests/test_spherical.py::test_rigid_rotation_zonal_advection_converges:
    u = omega R cos(phi) on a 360 degree ring (periodic in x) rotates any
    zonal profile; the dG1 error converges at about second order, and the
    first steps equal JAX's."""
    omega = 2.0e-5
    errors = []
    for nx in (24, 48):
        ny = nx // 2
        tmesh = SphericalMesh(nx, ny, 0.0, 360.0, 60.0, 75.0, periodic_x=True)
        jmesh = jax_mesh.SphericalMesh(nx, ny, lon0=0.0, lon1=360.0, lat0=60.0, lat1=75.0, periodic_x=True)
        tr, jtr = pair(tmesh, jmesh, degree=1)
        fn = lambda x, y: (omega * EARTH_RADIUS * np.cos(y / EARTH_RADIUS), 0.0 * x)
        vel, jvel = sampled(tmesh, jmesh, tr, jtr, fn)
        lat2d, lon2d = jmesh.lonlat_centers()
        profile = lambda lon: 1.0 + 0.5 * np.sin(np.radians(lon))
        psi = torch.zeros((3, nx, ny), dtype=torch.float64)
        psi[0] = t64(profile(lon2d))
        t_total, n_steps = np.radians(45.0) / omega, 200
        ref = j64(psi)
        for step in range(n_steps):
            psi = tr.step(psi, vel, t_total / n_steps)
            if step < 3:
                ref = jtr.step(ref, jvel, t_total / n_steps)
                if step == 2:
                    four = ref
        errors.append(float(np.max(np.abs(psi[0].numpy() - profile(lon2d - 45.0)))))
        again = torch.zeros_like(psi)
        again[0] = t64(profile(lon2d))
        for _ in range(3):
            again = tr.step(again, vel, t_total / n_steps)
        assert_close(again, four, RTOL_OP)
    order = np.log2(errors[0] / errors[1])
    assert order > 1.5, (errors, order)


# -- the coupled step -----------------------------------------------------------------------
def fronted_state(n_dofs, nx, ny, seed=0):
    """A seeded state with fronts: a patch of thicker, denser ice, so that
    the TVB limiter has slopes to cut."""
    rng = np.random.default_rng(seed)
    patch = np.zeros((nx, ny))
    patch[nx // 4: 3 * nx // 4, ny // 3: 2 * ny // 3] = 1.0

    def coeffs(lo, hi, jump):
        c = rng.normal(0.0, 0.05 * hi, (n_dofs, nx, ny))
        c[0] = rng.uniform(lo, hi, (nx, ny)) + jump * patch
        return c

    state = dict(
        hice=coeffs(0.5, 1.0, 1.0), cice=coeffs(0.3, 0.6, 0.35), hsnow=coeffs(0.0, 0.1, 0.1),
        sst=rng.uniform(-1.78, -1.5, (nx, ny)), sss=np.full((nx, ny), 32.0),
        tice=rng.uniform(-15.0, -2.0, (1, nx, ny)), new_ice=np.zeros((nx, ny)),
        velocity={k: rng.normal(0.0, s, (nx, ny)) for k, s in zip(VELOCITY, (0.3, 0.3, 500.0, 500.0, 200.0))},
    )
    full = lambda v: np.full((nx, ny), v)
    dyn = dict(u_atm=10.0 + rng.normal(0.0, 1.0, (nx, ny)), v_atm=full(3.0),
               u_ocean=full(0.02), v_ocean=rng.normal(0.0, 0.01, (nx, ny)))
    phys = dict(
        tair=rng.uniform(-25.0, -5.0, (nx, ny)), dew2m=rng.uniform(-27.0, -7.0, (nx, ny)),
        pair=full(1e5), sw_in=full(5.0), lw_in=full(240.0), mld=full(10.0), snowfall=full(1e-4),
        wind=rng.uniform(2.0, 10.0, (nx, ny)),
    )
    return state, dyn, phys


def to_port(state, dyn, phys):
    kw = dict(device="cpu", dtype=torch.float64)
    return (interop.coupled_state_from_numpy(state, **kw), interop.forcing_from_numpy(phys, **kw),
            interop.dynamics_forcing_from_numpy(dyn, **kw))


def to_jax(state, dyn, phys):
    velocity = jax_mevp.VelocityState(**{k: j64(state["velocity"][k]) for k in VELOCITY})
    return (JaxCoupledState(velocity=velocity, **{k: j64(v) for k, v in state.items() if k != "velocity"}),
            JaxForcing(**{k: j64(v) for k, v in phys.items()}),
            jax_mevp.DynamicsForcing(**{k: j64(v) for k, v in dyn.items()}))


def assert_states_close(got, ref, rtol=RTOL):
    for name in ref:
        if name == "velocity":
            for k in VELOCITY:
                assert_close(got[name][k], ref[name][k], rtol, f"velocity.{k}")
        else:
            assert_close(got[name], ref[name], rtol, name)


#: (mesh kind, periodic axes, tvb_m, coastline, degree): every periodic
#: combination with and without TVB, with and without a coastline, at dG1
#: and dG2, on the uniform, graded and spherical meshes.
COUPLED_CASES = [
    ("uniform", "x", 0.0, True, 1),
    ("uniform", "y", 0.0, False, 2),
    ("uniform", "xy", None, True, 2),
    ("uniform", "xy", 0.0, True, 1),
    ("graded", "xy", 0.0, False, 1),
    ("graded", "y", None, True, 1),
    ("spherical", "x", 0.0, True, 2),
    ("spherical", "x", None, False, 1),
    ("uniform", "closed", 0.0, True, 2),
]


@pytest.mark.parametrize(
    "kind, periodic, tvb_m, coastline, degree", COUPLED_CASES,
    ids=[f"{k}-{p}-{'tvb' if t is not None else 'pos'}-{'coast' if c else 'open'}-dG{d}"
         for k, p, t, c, d in COUPLED_CASES],
)
def test_coupled_step_matches_jax(kind, periodic, tvb_m, coastline, degree):
    """One coupled step with thermodynamics, 15 subcycles: the port on the
    CPU against the JAX model, all 12 leaves at 1e-8 of each plane's max;
    with TVB the limiter cuts slopes of the fronted state."""
    desc = description(kind, periodic)
    nx, ny = desc["nx"], desc["ny"]
    ocean = landmask.synthetic_coastline(nx, ny) if coastline else None
    n_dofs = {1: 3, 2: 6}[degree]
    state, dyn, phys = fronted_state(n_dofs, nx, ny)
    JaxModuleRegistry.get_loader().reset()
    jmodel = JaxCoupledModel(jax_mesh_of(desc), degree=degree, n_subcycles=15, ocean_mask=ocean, tvb_m=tvb_m)
    port = CoupledModel(interop.mesh_from_description(desc), degree=degree, n_subcycles=15,
                        ocean_mask=ocean, tvb_m=tvb_m)
    got = interop.coupled_state_to_numpy(port.step(*to_port(state, dyn, phys), DT))
    ref = interop.coupled_state_to_numpy(jmodel.step(*to_jax(state, dyn, phys), dt=DT))
    assert_states_close(got, ref)
    if tvb_m is not None:
        tr = port.transport
        hice = t64(state["hice"])
        assert not torch.equal(tr.limit_slopes(hice)[1:3], hice[1:3])


def test_periodic_node_mask_and_faces_wrap():
    """No wall on a periodic axis: boundary_mask pins only the closed
    axes' first row or column, as JAX's; with a coastline the node and face
    masks wrap, equal to JAX's."""
    for periodic, (px, py) in PERIODIC.items():
        tmesh = RectMesh(N, N + 2, 4e3, 4e3, periodic_x=px, periodic_y=py)
        jmesh = jax_mesh.RectMesh(nx=N, ny=N + 2, dx=4e3, dy=4e3, periodic_x=px, periodic_y=py)
        got = mevp.MEVPSolver(tmesh).boundary_mask(device="cpu", dtype=torch.float64)
        ref = jax_mevp.MEVPSolver(jmesh).boundary_mask(jnp.float64)
        assert np.array_equal(got.numpy(), np.asarray(ref)), periodic
        assert bool((got[0] == 0.0).all()) == (not px) and bool((got[:, 0] == 0.0).all()) == (not py)
        ocean = landmask.synthetic_coastline(N, N + 2)
        port = CoupledModel(tmesh, ocean_mask=ocean)
        JaxModuleRegistry.get_loader().reset()
        jmodel = JaxCoupledModel(jmesh, ocean_mask=ocean)
        assert np.array_equal(port.node_mask(device="cpu", dtype=torch.float64).numpy(),
                              np.asarray(jmodel.node_mask(jnp.float64))), periodic
        for g, r in zip(port.face_masks(device="cpu", dtype=torch.float64), jmodel.face_masks(jnp.float64)):
            assert np.array_equal(g.numpy(), np.asarray(r)), periodic


@pytest.fixture
def free_drift():
    """Nextsim::FreeDrift selected in both packages' registries, reset after."""
    loader, jloader = modules.get_loader(), JaxModuleRegistry.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::FreeDrift")
    jloader.set_implementation("Nextsim::IDynamics", "Nextsim::FreeDrift")
    try:
        yield
    finally:
        loader.reset()
        jloader.reset()


@pytest.mark.parametrize("periodic", ["x", "xy"])
def test_free_drift_on_a_periodic_mesh_matches_jax(free_drift, periodic):
    desc = description("uniform", periodic)
    state, dyn, phys = fronted_state(3, desc["nx"], desc["ny"])
    port = CoupledModel(interop.mesh_from_description(desc), n_subcycles=5)
    jmodel = JaxCoupledModel(jax_mesh_of(desc), degree=1, n_subcycles=5)
    assert port.is_free_drift
    got = interop.coupled_state_to_numpy(port.step(*to_port(state, dyn, phys), DT, do_thermo=False))
    ref = interop.coupled_state_to_numpy(jmodel.step(*to_jax(state, dyn, phys), dt=DT, do_thermo=False))
    assert_states_close(got, ref)
    # No wall on a periodic axis: its first row (column) of nodes moves.
    px, py = PERIODIC[periodic]
    assert np.any(got["velocity"]["u"][0]) == px and np.any(got["velocity"]["v"][:, 0]) == py


# -- schedules, raises and descriptions ---------------------------------------------------------
@pytest.mark.parametrize("kind", ["graded", "spherical"])
def test_tvb_on_a_non_uniform_mesh_takes_the_staged_transport(kind):
    """Its tolerance is a plane: "auto" takes "xla" at every size, an
    explicit "tiled" raises; without TVB "tiled" stays."""
    desc = description(kind, "x", n=80)
    tmesh = interop.mesh_from_description(desc)
    assert tmesh.n_elements >= 64 * 64
    assert CoupledModel(tmesh, tvb_m=1.0).transport_schedule() == "xla"
    assert CoupledModel(tmesh, tvb_m=1.0, mevp_backend="pallas-tiled").transport_schedule() == "xla"
    assert CoupledModel(tmesh).transport_schedule() == "tiled"
    with pytest.raises(NotImplementedError, match="staged"):
        CoupledModel(tmesh, tvb_m=1.0, transport_backend="tiled")
    assert CoupledModel(tmesh, degree=0, tvb_m=1.0, transport_backend="tiled").transport_schedule() == "tiled"


def test_periodic_axes_change_no_schedule():
    for periodic in PERIODIC:
        desc = description("uniform", periodic, n=80)
        port = CoupledModel(interop.mesh_from_description(desc), tvb_m=0.0)
        assert (port.mevp_schedule(), port.transport_schedule()) == ("pallas-tiled", "tiled"), periodic
        sphere = interop.mesh_from_description(description("spherical", "x" if periodic != "closed" else "closed"))
        assert CoupledModel(sphere).mevp_schedule() == "single"


def test_the_tvb_periodic_step_on_the_cpu_is_the_plain_version():
    """CPU tensors run the plain versions on every schedule: no launch."""
    desc = description("uniform", "xy")
    state, dyn, phys = fronted_state(3, desc["nx"], desc["ny"])
    port = CoupledModel(interop.mesh_from_description(desc), n_subcycles=5, tvb_m=0.0,
                        mevp_backend="pallas-tiled", transport_backend="tiled")
    cc.reset_launches()
    ts, tp, td = to_port(state, dyn, phys)
    got = port.step_dynamics(ts, td, DT)
    ref = port.step_dynamics(ts, td, DT, phase=cc.fused_dynamics_reference)
    assert all(count == 0 for count in cc.launches.values())
    assert torch.equal(got.hice, ref.hice) and torch.equal(got.velocity.u, ref.velocity.u)


def test_mesh_descriptions_take_periodic_axes():
    ring = interop.mesh_from_description(description("spherical", "x"))
    assert isinstance(ring, SphericalMesh) and ring.periodic_x and not ring.periodic_y
    rect = interop.mesh_from_description(description("graded", "y"))
    assert not rect.periodic_x and rect.periodic_y and not rect.uniform
    closed = interop.mesh_from_description(dict(kind="rect", nx=4, ny=4, dx=1.0, dy=1.0))
    assert not closed.periodic_x and not closed.periodic_y
    with pytest.raises(KeyError):
        interop.mesh_from_description({**description("spherical", "x"), "periodic_y": True})


@pytest.mark.parametrize("axis", [0, 1])
def test_halo_widen_wraps_a_periodic_axis(axis):
    """halo_widen on a periodic axis takes the strips from the opposite
    side, equal to JAX's; a halo wider than the axis raises."""
    a = np.random.default_rng(axis).normal(size=(3, 6, 7))
    got = stencil.halo_widen(t64(a), 3, axis + 1, True)
    ref = jax_stencil.halo_widen(j64(a), 3, axis + 1, True)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got.narrow(axis + 1, 0, 3), t64(a).narrow(axis + 1, a.shape[axis + 1] - 3, 3))
    with pytest.raises(ValueError, match="wider"):
        stencil.halo_widen(t64(a), 8, axis + 1, True)


def test_ho_on_a_periodic_mesh_pins_closed_axes_only():
    """The HO solver runs on a periodic RectMesh and on the 360 degree ring
    (a spherical mesh, periodic in x): the node mask pins the closed axis's
    wall and no node of the periodic one."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        ring = CoupledModel(RectMesh(N, N, 4e3, 4e3, periodic_y=True))
        sphere = CoupledModel(SphericalMesh(N, N, 0.0, 360.0, 60.0, 80.0, periodic_x=True))
    finally:
        loader.reset()
    assert ring.is_high_order and ring.mevp.mesh.periodic_y
    mask = ring.node_mask(device="cpu", dtype=torch.float64)
    assert bool((mask.v[1:, 0] == 1).all()) and bool((mask.v[0] == 0).all())
    assert sphere.is_high_order and sphere.mevp.mesh.periodic_x
    mask = sphere.node_mask(device="cpu", dtype=torch.float64)
    assert bool((mask.v[:, 1:] == 1).all()) and bool((mask.v[:, 0] == 0).all())


@pytest.mark.parametrize("degree, transport_backend", [(1, "tiled"), (2, "xla")])
def test_ho_step_with_tvb_matches_jax(degree, transport_backend):
    """The HO solver with the TVB limiter on a uniform, closed mesh (legal in
    the JAX package: its transport runs on the CG2 velocity's quadrature
    samples), from fronted tracers, with physics: the port on the CPU
    against the JAX model, every leaf at 1e-8 of its plane's max."""
    mesh = RectMesh(N, N + 2, 4e3, 4e3)
    jmesh = jax_mesh.RectMesh(nx=N, ny=N + 2, dx=4e3, dy=4e3)
    loader, jloader = modules.get_loader(), JaxModuleRegistry.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    jloader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        port = CoupledModel(mesh, degree=degree, n_subcycles=15, tvb_m=0.0, transport_backend=transport_backend)
        jmodel = JaxCoupledModel(jmesh, degree=degree, n_subcycles=15, tvb_m=0.0)
    finally:
        loader.reset()
        jloader.reset()
    assert port.is_high_order and port.transport_schedule() == transport_backend
    fronted, dyn, phys = fronted_state({1: 3, 2: 6}[degree], N, N + 2)
    tracers = {k: fronted[k] for k in ("hice", "cice", "hsnow")}
    pstate = dataclasses.replace(
        port.initial_state(hice0=1.0, cice0=0.8, hsnow0=0.1, device="cpu", dtype=torch.float64),
        **{k: t64(v) for k, v in tracers.items()},
    )
    jstate = dataclasses.replace(
        jmodel.initial_state(hice0=1.0, cice0=0.8, hsnow0=0.1, dtype=jnp.float64),
        **{k: j64(v) for k, v in tracers.items()},
    )
    _, pphys, pdyn = to_port(fronted, dyn, phys)
    _, jphys, jdyn = to_jax(fronted, dyn, phys)
    got = interop.coupled_state_to_numpy(port.step(pstate, pphys, pdyn, DT))
    ref = interop.coupled_state_to_numpy(jmodel.step(jstate, jphys, jdyn, dt=DT))
    def leaves(tree, prefix=""):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from leaves(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value

    got_leaves, ref_leaves = dict(leaves(got)), dict(leaves(ref))
    assert sorted(got_leaves) == sorted(ref_leaves) and len(ref_leaves) == 18
    for name, value in ref_leaves.items():
        assert_close(got_leaves[name], value, RTOL, name)
    assert not torch.equal(port.transport.limit_slopes(pstate.hice)[1:3], pstate.hice[1:3])
