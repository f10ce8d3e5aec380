"""Graded and spherical meshes with coastlines: the port against the JAX package.

At float64 on the CPU, the same numpy inputs go through the JAX package and
``nextsimdg_tpu_torch``: the meshes' metric planes, the coastline masks,
the mEVP step that the JAX package runs in its single-call kernel (K4,
``mevp_subcycles_pallas``) and in its tiled one (K2), both in interpret
mode, the metric transport, and the coupled step with thermodynamics on a
spherical mesh with a coastline (the path of ``coupled_1m_spherical``).
Tolerances: exact for the metric planes, masks and k; 1e-12 of the
plane's max for one transport operation; 1e-8 of each plane's max after
many mEVP subcycles, where the shared divide amplifies rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.dynamics import landmask as jax_landmask
from nextsimdg_tpu.dynamics import mesh as jax_mesh
from nextsimdg_tpu.dynamics import mevp as jax_mevp
from nextsimdg_tpu.dynamics import transport as jax_transport
from nextsimdg_tpu.modules import ModuleRegistry
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu_torch import coupled, interop
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import landmask, mesh, mevp, transport
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import mevp_single_cuda as ms

torch.set_num_threads(1)

N = 16
DT = 600.0
RTOL_OP = 1e-12
RTOL_SUBCYCLES = 1e-8
VELOCITY = ("u", "v", "s11", "s22", "s12")

#: The graded mesh of tests/test_metric_kernels.py and a pan-Arctic-style
#: spherical window, as mesh descriptions both packages are built from.
GRADED = dict(
    kind="rect", nx=N, ny=N,
    dx=30e3 * (1.0 + 0.05 * np.arange(N)), dy=32e3 * (1.0 + 0.03 * np.arange(N)[::-1]),
)
SPHERE = dict(kind="spherical", nx=N, ny=N, lon0=0.0, lon1=12.0, lat0=68.0, lat1=78.0)
UNIFORM = dict(kind="rect", nx=N, ny=N, dx=4e3, dy=4e3)


def jax_mesh_of(d):
    if d["kind"] == "rect":
        return jax_mesh.RectMesh(nx=d["nx"], ny=d["ny"], dx=d["dx"], dy=d["dy"])
    return jax_mesh.SphericalMesh(
        d["nx"], d["ny"], lon0=d["lon0"], lon1=d["lon1"], lat0=d["lat0"], lat1=d["lat1"]
    )


def coast(n=N):
    """The coastline of tests/test_metric_kernels.py: land in the lower-left
    quarter and a 2 x 2 island."""
    mask = np.ones((n, n))
    mask[: n // 4, : n // 4] = 0.0
    mask[n // 2 : n // 2 + 2, n // 2 : n // 2 + 2] = 0.0
    return mask


COASTS = {"quarter": coast, "synthetic": lambda: landmask.synthetic_coastline(N)}


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


# -- meshes and coastlines --------------------------------------------------------
@pytest.mark.parametrize("desc", [GRADED, SPHERE], ids=["graded", "spherical"])
def test_metric_planes_and_properties_equal_exactly(desc):
    tmesh, jmesh = interop.mesh_from_description(desc), jax_mesh_of(desc)
    assert not tmesh.uniform and not jmesh.uniform
    got = mesh.device_metric_planes(tmesh, device="cpu", dtype=torch.float64)
    ref = jax_mesh.device_metric_planes(jmesh, jnp.float64)
    assert set(got) == set(ref)
    for name in ref:
        assert np.array_equal(got[name].numpy(), np.asarray(ref[name])), name
    for prop in ("dx", "dy", "cell_area", "face_len_x", "face_len_y"):
        a, b = getattr(tmesh, prop), getattr(jmesh, prop)
        assert np.array_equal(np.asarray(a), np.asarray(b)) and type(a) is type(b), prop
    for name, (col, row) in jmesh.metric_factors().items():
        assert np.array_equal(tmesh.metric_factors()[name][0], col)
        assert np.array_equal(tmesh.metric_factors()[name][1], row)
    # The float32 planes cast the factors before the multiply, as JAX does.
    got32 = mesh.device_metric_planes(tmesh, device="cpu", dtype=torch.float32)
    ref32 = jax_mesh.device_metric_planes(jmesh, jnp.float32)
    for name in ref32:
        assert np.array_equal(got32[name].numpy(), np.asarray(ref32[name])), name


def test_mesh_descriptions_and_what_stays_unported():
    sphere = interop.mesh_from_description({**SPHERE, "radius": 6.0e6})
    assert isinstance(sphere, mesh.SphericalMesh) and sphere.radius == 6.0e6
    uniform = interop.mesh_from_description(UNIFORM)
    assert uniform.uniform and (uniform.dx, uniform.dy) == (4e3, 4e3)
    with pytest.raises(KeyError):
        interop.mesh_from_description({**GRADED, "lon0": 0.0})
    with pytest.raises(KeyError):
        interop.mesh_from_description({"kind": "polar", "nx": 4, "ny": 4})
    # A 360 degree ring is periodic in x (tests/test_torch_tvb_periodic.py),
    # from a description too.
    ring = interop.mesh_from_description({**SPHERE, "lon1": 360.0, "periodic_x": True})
    jring = jax_mesh.SphericalMesh(N, N, 0.0, 360.0, 68.0, 78.0, periodic_x=True)
    assert ring.periodic_x and not ring.periodic_y and jring.periodic_x
    assert np.array_equal(np.asarray(ring.dx), np.asarray(jring.dx))
    with pytest.raises(ValueError):
        mesh.SphericalMesh(8, 8, 0.0, 10.0, 60.0, 90.0)


@pytest.mark.parametrize("n", [16, 64, 200])
def test_synthetic_coastline_equals_exactly(n, tmp_path):
    got, ref = landmask.synthetic_coastline(n), jax_landmask.synthetic_coastline(n)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert 0.7 < got.mean() < 0.95
    path = tmp_path / "mask.npy"
    np.save(path, got)
    assert np.array_equal(landmask.load_ocean_mask(str(path), n, n), ref)
    assert np.array_equal(landmask.load_ocean_mask("synthetic", n, n), ref)
    with pytest.raises(ValueError):
        landmask.load_ocean_mask(str(path), n, n + 1)


@pytest.mark.parametrize("coast_name", sorted(COASTS))
def test_face_masks_and_node_mask_equal_exactly(coast_name):
    ocean = COASTS[coast_name]()
    got = transport.face_masks_from_land(t64(ocean))
    ref = jax_transport.face_masks_from_land(j64(ocean))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    port = CoupledModel(interop.mesh_from_description(SPHERE), ocean_mask=ocean)
    jmodel = JaxCoupledModel(jax_mesh_of(SPHERE), ocean_mask=ocean)
    node = port.node_mask(device="cpu", dtype=torch.float64)
    assert np.array_equal(node.numpy(), np.asarray(jmodel.node_mask(jnp.float64)))
    faces = port.face_masks(device="cpu", dtype=torch.float64)
    for g, r in zip(faces, jmodel.face_masks(jnp.float64)):
        assert np.array_equal(g.numpy(), np.asarray(r))
    # Built once per (device, dtype).
    assert port.node_mask(device="cpu", dtype=torch.float64) is node
    with pytest.raises(ValueError, match="shape"):
        CoupledModel(interop.mesh_from_description(SPHERE), ocean_mask=ocean[:-1])


# -- the mEVP step: K4 and K2 of the JAX package ----------------------------------
def mevp_inputs(desc, seed=11):
    """(port solver, its inputs), (JAX params, its inputs) on one mesh."""
    rng = np.random.default_rng(seed)
    f = lambda scale: rng.normal(0.0, scale, (N, N))
    fields = dict(
        u=f(0.3), v=f(0.3), s11=f(2e3), s22=f(2e3), s12=f(1e3),
        h=rng.uniform(0.2, 2.5, (N, N)), a=rng.uniform(0.3, 1.0, (N, N)),
        u_atm=10.0 + f(2.0), v_atm=3.0 + f(2.0), u_ocean=f(0.05), v_ocean=f(0.05),
    )
    tsolver = mevp.MEVPSolver(interop.mesh_from_description(desc), mevp.MEVPParams())
    frc = ("u_atm", "v_atm", "u_ocean", "v_ocean")
    tin = (
        mevp.VelocityState(**{k: t64(fields[k]) for k in VELOCITY}),
        t64(fields["h"]), t64(fields["a"]),
        mevp.DynamicsForcing(**{k: t64(fields[k]) for k in frc}),
        tsolver.boundary_mask(device="cpu", dtype=torch.float64),
    )
    jin = (
        jax_mevp.VelocityState(**{k: j64(fields[k]) for k in VELOCITY}),
        j64(fields["h"]), j64(fields["a"]),
        jax_mevp.DynamicsForcing(**{k: j64(fields[k]) for k in frc}),
    )
    return tsolver, tin, jin


@pytest.mark.parametrize("backend", ["pallas-interpret", "pallas-tiled-interpret"])
@pytest.mark.parametrize("desc", [GRADED, SPHERE], ids=["graded", "spherical"])
def test_mevp_step_matches_the_jax_kernels(desc, backend):
    """12 subcycles of the port's MEVPSolver.step == JAX's K4
    (pallas-interpret) and K2 (pallas-tiled-interpret) on the metric consts."""
    tsolver, tin, jin = mevp_inputs(desc)
    jsolver = jax_mevp.MEVPSolver(jax_mesh_of(desc), jax_mevp.MEVPParams(), backend=backend)
    assert jsolver._kernel_choice() == ("single" if backend == "pallas-interpret" else "tiled")
    got = tsolver.step(*tin, DT, 12)
    ref = jsolver.step(*jin, jsolver.boundary_mask(jnp.float64), DT, 12)
    for name in VELOCITY:
        assert_close(getattr(got, name), getattr(ref, name), RTOL_SUBCYCLES, name)


@pytest.mark.parametrize("desc", [GRADED, SPHERE], ids=["graded", "spherical"])
def test_step_consts_carry_the_metric_planes(desc):
    tsolver, tin, jin = mevp_inputs(desc, seed=2)
    jsolver = jax_mevp.MEVPSolver(jax_mesh_of(desc), jax_mevp.MEVPParams(), backend="xla")
    got = tsolver.step_consts(*tin, DT)
    ref = jsolver.step_consts(*jin, jsolver.boundary_mask(jnp.float64), DT)
    assert sorted(got) == sorted(ref) == sorted(mevp.UNIFORM_CONSTS + mevp.METRIC_CONSTS)
    for name in ref:
        assert_close(got[name], ref[name], RTOL_OP, name)
    # Built once per (device, dtype), like the JAX package's per-step planes.
    again = tsolver.step_consts(*tin, DT)
    assert again["inv_dx"] is got["inv_dx"] and again["inv_w"] is got["inv_w"]


def test_mevp_single_wrapper_runs_the_plain_version_on_the_cpu():
    tsolver, tin, _ = mevp_inputs(SPHERE)
    consts = tsolver.step_consts(*tin, DT)
    carry = tuple(getattr(tin[0], k) for k in VELOCITY)
    cc.reset_launches()
    got = ms.mevp_subcycles_single(tsolver, carry, consts, DT, 5)
    ref = ms.mevp_single_reference(tsolver, carry, consts, DT, 5)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert all(count == 0 for count in cc.launches.values())
    meta = tuple(c.to("meta") for c in carry)
    with pytest.raises(ValueError, match="not supported"):
        ms.mevp_subcycles_single(tsolver, meta, consts, DT, 5)


def test_the_kernels_take_the_sorted_const_set_of_the_mesh():
    tsolver, tin, _ = mevp_inputs(SPHERE)
    consts = tsolver.step_consts(*tin, DT)
    carry = tuple(getattr(tin[0], k).float() for k in VELOCITY)
    consts32 = {k: v.float() for k, v in consts.items()}
    cc._check_mevp(tsolver, carry, dict(reversed(list(consts32.items()))))
    uniform = {k: consts32[k] for k in mevp.UNIFORM_CONSTS}
    with pytest.raises(NotImplementedError, match="consts"):
        cc._check_mevp(tsolver, carry, uniform)
    flat = mevp.MEVPSolver(mesh.RectMesh(N, N, 4e3, 4e3))
    with pytest.raises(NotImplementedError, match="consts"):
        cc._check_mevp(flat, carry, consts32)
    cc._check_mevp(flat, carry, uniform)
    # The geometric scalars and table entries are not used on this mesh.
    scalars = list(cc._mevp_scalars(tsolver, DT))
    # dt, then the adaptive form's alpha_min and c_stab, close MevpScalars.
    assert np.isnan(scalars[0]) and np.isnan(scalars[12]) and scalars[-3] == DT
    assert np.all(np.isnan(list(cc._dg1_tables(CoupledModel(tsolver.mesh).transport))[-4:]))


# -- the transport with metric planes and coastlines ------------------------------
def transport_inputs(desc, seed=5, scale=1.0):
    rng = np.random.default_rng(seed)
    u, v = rng.normal(0.0, 0.3 * scale, (2, N, N))
    psi = np.concatenate([rng.uniform(0.1, 1.0, (1, 3, N, N)), rng.normal(0.0, 0.2, (2, 3, N, N))])
    ttr = transport.DGTransport(interop.mesh_from_description(desc))
    jtr = jax_transport.DGTransport(jax_mesh_of(desc), degree=1)
    tq = transport.velocity_from_cg(ttr.mesh, ttr.basis, t64(u), t64(v))
    jq = jax_transport.velocity_from_cg(jtr.mesh, jtr.basis, j64(u), j64(v))
    return ttr, jtr, tq, jq, psi


@pytest.mark.parametrize("coast_name", sorted(COASTS))
@pytest.mark.parametrize("desc", [GRADED, SPHERE], ids=["graded", "spherical"])
def test_rhs_and_limited_step_match_with_metric_and_coastline(desc, coast_name):
    ttr, jtr, tq, jq, psi = transport_inputs(desc)
    ocean = COASTS[coast_name]()
    tmasks = transport.face_masks_from_land(t64(ocean))
    jmasks = jax_transport.face_masks_from_land(j64(ocean))
    got_metric = ttr.metric_planes(device="cpu", dtype=torch.float64)
    for name, ref in jtr.metric_planes(jnp.float64).items():
        assert np.array_equal(got_metric[name].numpy(), np.asarray(ref)), name
    assert_close(ttr.rhs(t64(psi), tq, tmasks), jtr.rhs(j64(psi), jq, jmasks), RTOL_OP)
    got = ttr.step(t64(psi), tq, 300.0, limit=True, face_masks=tmasks)
    ref = jtr.step(j64(psi), jq, 300.0, limit=True, face_masks=jmasks)
    assert_close(got, ref, RTOL_OP)
    assert_close(ttr.total_mass(got[:, 0]), jtr.total_mass(ref[:, 0]), RTOL_OP)


def test_cfl_substeps_use_the_thinnest_row():
    """k from the minimum widths equals JAX's; the poleward rows are the
    thinnest, so the widest row's width would give fewer substeps."""
    ttr, jtr, tq, jq, _ = transport_inputs(SPHERE, scale=40.0)
    got = transport.cfl_substeps(tq, DT, ttr.mesh, 1)
    ref = jax_transport.cfl_substeps(jq, DT, jtr.mesh, 1)
    assert int(got) == int(ref) >= 2
    wide = mesh.RectMesh(N, N, float(np.max(ttr.mesh.dx)), ttr.mesh.dy)
    assert int(transport.cfl_substeps(tq, DT, wide, 1)) < int(got)


# -- the coupled step (coupled_1m_spherical's path) -------------------------------
def seeded_state(seed):
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([
        rng.uniform(lo, hi, (1, N, N)), rng.normal(0.0, 0.05 * hi, (2, N, N))
    ])
    return dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.3, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=rng.uniform(-1.78, -1.5, (N, N)), sss=np.full((N, N), 32.0),
        tice=rng.uniform(-15.0, -2.0, (1, N, N)), new_ice=np.zeros((N, N)),
        velocity={k: rng.normal(0.0, s, (N, N)) for k, s in zip(VELOCITY, (0.3, 0.3, 500.0, 500.0, 200.0))},
    )


def seeded_forcings(seed):
    rng = np.random.default_rng(seed)
    dyn = dict(
        u_atm=10.0 + rng.normal(0.0, 1.0, (N, N)), v_atm=np.full((N, N), 3.0),
        u_ocean=np.full((N, N), 0.02), v_ocean=rng.normal(0.0, 0.01, (N, N)),
    )
    phys = dict(
        tair=rng.uniform(-25.0, -5.0, (N, N)), dew2m=rng.uniform(-27.0, -7.0, (N, N)),
        pair=np.full((N, N), 1e5), sw_in=np.full((N, N), 5.0), lw_in=np.full((N, N), 240.0),
        mld=np.full((N, N), 10.0), snowfall=np.full((N, N), 1e-4),
        wind=rng.uniform(2.0, 10.0, (N, N)),
    )
    return dyn, phys


def to_jax(state, dyn, phys):
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    velocity = jax_mevp.VelocityState(**{k: j(state["velocity"][k]) for k in VELOCITY})
    jstate = JaxCoupledState(
        velocity=velocity, **{k: j(v) for k, v in state.items() if k != "velocity"}
    )
    return (
        jstate, JaxForcing(**{k: j(v) for k, v in phys.items()}),
        jax_mevp.DynamicsForcing(**{k: j(v) for k, v in dyn.items()}),
    )


def to_port(state, dyn, phys):
    kw = dict(device="cpu", dtype=torch.float64)
    return (
        interop.coupled_state_from_numpy(state, **kw), interop.forcing_from_numpy(phys, **kw),
        interop.dynamics_forcing_from_numpy(dyn, **kw),
    )


@pytest.mark.parametrize("desc", [SPHERE, UNIFORM], ids=["spherical", "uniform"])
def test_coupled_step_with_coastline_matches_the_jax_kernels(desc):
    """One step with thermodynamics, 10 subcycles, synthetic coastline: the
    port on the CPU against JAX's K4 (or, on the uniform mesh, its fused
    K1) and tiled transport in interpret mode; all 12 leaves."""
    ocean = landmask.synthetic_coastline(N)
    ModuleRegistry.get_loader().reset()
    jmodel = JaxCoupledModel(
        jax_mesh_of(desc), degree=1, n_subcycles=10, ocean_mask=ocean,
        mevp_backend="pallas-interpret", transport_backend="tiled-interpret",
    )
    if desc is SPHERE:
        assert jmodel._fused_dynamics_mode() is None
        assert jmodel.mevp._kernel_choice() == "single"
        assert jmodel._tiled_transport_mode() == "interpret"
    else:
        assert jmodel._fused_dynamics_mode() == "interpret"
    port = CoupledModel(
        interop.mesh_from_description(desc), degree=1, n_subcycles=10, ocean_mask=ocean,
        mevp_backend="pallas",
    )
    assert port.mevp_schedule() == ("single" if desc is SPHERE else "pallas")
    state, (dyn, phys) = seeded_state(0), seeded_forcings(1)
    got = port.step(*to_port(state, dyn, phys), DT)
    jstate, jphys, jdyn = to_jax(state, dyn, phys)
    ref = jmodel.step(jstate, jphys, jdyn, dt=DT)
    got_np, ref_np = interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref)
    names = [n for n in ref_np if n != "velocity"] + [f"velocity.{k}" for k in VELOCITY]
    assert len(names) == 12
    for name in names:
        g = got_np["velocity"][name[9:]] if name.startswith("velocity.") else got_np[name]
        r = ref_np["velocity"][name[9:]] if name.startswith("velocity.") else ref_np[name]
        assert_close(g, r, RTOL_SUBCYCLES, name)
    assert (ref_np["new_ice"] > 0).any()


def spherical_model(ocean, **kwargs):
    port = CoupledModel(
        interop.mesh_from_description(SPHERE), degree=1, n_subcycles=10, ocean_mask=ocean,
        **kwargs,
    )
    state = port.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device="cpu", dtype=torch.float64)
    dyn, phys = seeded_forcings(4)
    _, pf, df = to_port(seeded_state(0), dyn, phys)
    return port, state, pf, df


def test_spherical_landmask_conservation():
    """Ice volume is conserved under pure transport on a spherical mesh
    with a coastline (impermeable faces x exact zone areas)."""
    port, state, pf, df = spherical_model(coast())
    mass0 = float(port.transport.total_mass(state.hice))
    out = port.run(state, pf, df, DT, 3, do_thermo=False)
    np.testing.assert_allclose(float(port.transport.total_mass(out.hice)), mass0, rtol=1e-10)
    assert bool(torch.isfinite(out.hice).all())
    assert float(out.velocity.u.abs().max()) > 0.0


def test_land_keeps_its_state_and_coastal_nodes_stay_at_rest():
    ocean = landmask.synthetic_coastline(N)
    port, state, pf, df = spherical_model(ocean)
    out = port.step(state, pf, df, DT)
    land = torch.as_tensor(ocean == 0.0)
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        before, after = getattr(state, name), getattr(out, name)
        assert torch.equal(after[..., land], before[..., land]), name
    ocean_t = torch.as_tensor(ocean)
    pad = torch.nn.functional.pad(ocean_t, (1, 0, 1, 0))  # element (i-1, j-1) at [i, j]
    all_ocean = pad[1:, 1:] * pad[:-1, 1:] * pad[1:, :-1] * pad[:-1, :-1]
    touching = all_ocean == 0.0
    assert bool(touching.any())
    for name in ("u", "v"):
        assert bool((getattr(out.velocity, name)[touching] == 0.0).all())
    assert float(out.velocity.u.abs().max()) > 0.0
    assert not torch.equal(out.tice[..., ~land], state.tice[..., ~land])


# -- kernel schedules on non-uniform meshes --------------------------------------
@pytest.mark.parametrize(
    "mevp_backend, transport_backend, expected",
    [
        ("pallas", "auto", ("single", "xla")),  # 16^2 is below the tiled transport's size
        ("pallas", "tiled", ("single", "tiled")),  # not coupled to the mEVP schedule here
        ("pallas-tiled", "xla", ("pallas-tiled", "xla")),
        ("auto", "auto", ("single", "xla")),
    ],
)
def test_schedules_on_a_spherical_mesh(mevp_backend, transport_backend, expected):
    port = CoupledModel(
        interop.mesh_from_description(SPHERE), mevp_backend=mevp_backend,
        transport_backend=transport_backend,
    )
    assert (port.mevp_schedule(), port.transport_schedule()) == expected


@pytest.mark.parametrize("side", ["below", "at"])
def test_auto_on_a_spherical_mesh_follows_its_threshold(side):
    nx = -(-coupled.SINGLE_MAX_ELEMENTS // 64) - (side == "below")
    port = CoupledModel(mesh.SphericalMesh(nx, 64, -40.0, 40.0, 55.0, 85.0))
    single = nx * 64 < coupled.SINGLE_MAX_ELEMENTS
    assert single == (side == "below")
    assert port.mevp_schedule() == ("single" if single else "pallas-tiled")


@pytest.mark.parametrize("sms, expected", [(None, "single"), (132, "single"), (78, "pallas-tiled")])
def test_auto_on_a_spherical_mesh_asks_whether_the_card_holds_the_grid(sms, expected):
    """900^2 is below SINGLE_MAX_ELEMENTS; mevp_single holds it on 132 SMs
    but not on 78 (the tiles outnumber the SMs or outgrow a block's shared
    memory), so "auto" falls back to mevp_tiled there, as the JAX package
    falls back where ``pallas_supported`` is false. An explicit "pallas"
    keeps mevp_single (whose wrapper then refuses the grid on such a
    card)."""
    n = 900
    assert n * n < coupled.SINGLE_MAX_ELEMENTS
    assert ms.holds(n, n, 132) and not ms.holds(n, n, 78)
    sphere = mesh.SphericalMesh(n, n, -40.0, 40.0, 55.0, 85.0)
    assert CoupledModel(sphere).mevp_schedule(sms) == expected
    assert CoupledModel(sphere, mevp_backend="pallas").mevp_schedule(sms) == "single"
    uniform = CoupledModel(mesh.RectMesh(n, n, 4e3, 4e3))  # "auto" takes no single kernel there
    assert uniform.mevp_schedule(sms) == "pallas-tiled"


@pytest.mark.parametrize(
    "device, sms, expected",
    [("cpu", 78, ("single", "tiled")), ("cuda", 132, ("single", "tiled")), ("cuda", 78, ("pallas-tiled", "tiled"))],
)
def test_the_schedule_of_a_step_asks_its_card(monkeypatch, device, sms, expected):
    """``CoupledModel.schedule(device)``, which the step runs and the
    scripts report, counts the SMs of a CUDA device (forced here) and asks
    none of the CPU."""
    monkeypatch.setattr(coupled, "sm_count", lambda d: sms)
    n = 900
    port = CoupledModel(mesh.SphericalMesh(n, n, -40.0, 40.0, 55.0, 85.0), transport_backend="tiled")
    assert port.schedule(device) == expected


def test_the_spherical_step_on_the_cpu_is_the_plain_version():
    port, state, pf, df = spherical_model(coast(), mevp_backend="pallas", transport_backend="tiled")
    cc.reset_launches()
    got = port.step(state, pf, df, DT)
    ref = port.step_thermo(
        port.step_dynamics(state, df, DT, phase=cc.fused_dynamics_reference), pf, DT
    )
    assert all(count == 0 for count in cc.launches.values())
    got_np, ref_np = interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref)
    for name in ("hice", "cice", "hsnow", "sst", "tice", "new_ice"):
        assert np.array_equal(got_np[name], ref_np[name]), name
    for name in VELOCITY:
        assert np.array_equal(got_np["velocity"][name], ref_np["velocity"][name]), name
