"""The momentum forms of the CG1 solver and free drift: the port against the JAX package.

``MEVPParams(a_weighted_stress=True)`` (both surface stresses scaled by the
nodal concentration, nodes below ``a_dyn_min`` held at rest),
``MEVPParams(adaptive_alpha=True)`` (per-node alpha = beta) and
``Nextsim::FreeDrift``, at float64 on the CPU: the same numpy inputs go
through the JAX package and ``nextsimdg_tpu_torch``, parameters converted
by ``interop.mevp_params_from_dict``. Tolerances: 1e-8 of each plane's max
after many subcycles or a coupled step, where the divides amplify rounding
(the JAX tests' own bound for their kernels); exact where the JAX tests
assert bit identity. The CUDA kernels of each form are held against these
plain versions on the card (``tests/test_torch_kernels.py``, marked
``cuda``, and ``chip_smoke.py``).
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
from nextsimdg_tpu.dynamics.freedrift import FreeDriftSolver as JaxFreeDriftSolver
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model as jax_build_sharded
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.config import Configurator, ConfiguredModule
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import FreeDriftSolver, landmask, mevp
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import mevp_single_cuda as ms
from nextsimdg_tpu_torch.dynamics.mesh import RectMesh, SphericalMesh
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model

torch.set_num_threads(1)

N = 16
DT = 600.0
RTOL = 1e-8
VELOCITY = ("u", "v", "s11", "s22", "s12")
TRACERS = ("hice", "cice", "hsnow")
DYNAMICS = "Nextsim::IDynamics"
FREE_DRIFT = "Nextsim::FreeDrift"
#: The forms as MEVPParams keyword sets.
FORMS = {
    "weighted": dict(a_weighted_stress=True),
    "adaptive": dict(adaptive_alpha=True),
    "both": dict(a_weighted_stress=True, adaptive_alpha=True),
}


def assert_close(got, ref, rtol=RTOL, name=""):
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


def params_pair(**kwargs):
    """(port, JAX) MEVPParams of the same fields."""
    jp = jax_mevp.MEVPParams(**kwargs)
    return interop.mevp_params_from_dict(dataclasses.asdict(jp)), jp


def box(n=N, wind=8.0, a_value=0.9, h0=2.0):
    """The planes of test_a_weighted.py's box: uniform h and A, wind
    (wind, 2) and a 0.02 m/s current."""
    full = lambda v: np.full((n, n), v)
    return dict(h=full(h0), a=full(a_value), u_atm=full(wind), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))


def port_step(mesh, params, planes, n_subcycles, state=None):
    """One MEVPSolver step on the planes of ``box`` (from rest by default)."""
    solver = mevp.MEVPSolver(mesh, params)
    n = mesh.nx
    state = mevp.VelocityState.zeros(n, n, device="cpu", dtype=torch.float64) if state is None else state
    forcing = mevp.DynamicsForcing(*(t64(planes[k]) for k in ("u_atm", "v_atm", "u_ocean", "v_ocean")))
    mask = solver.boundary_mask(device="cpu", dtype=torch.float64)
    return solver.step(state, t64(planes["h"]), t64(planes["a"]), forcing, mask, DT, n_subcycles)


# -- twins of tests/test_a_weighted.py ------------------------------------------------
def test_full_cover_matches_unweighted_exactly():
    """At A = 1 the nodal weights are exactly 1.0, so the weighted step is
    bit-identical to the unweighted one."""
    mesh, planes = RectMesh(N, N, 512e3 / N, 512e3 / N), box(a_value=1.0)
    plain = port_step(mesh, mevp.MEVPParams(), planes, 20)
    weighted = port_step(mesh, mevp.MEVPParams(a_weighted_stress=True), planes, 20)
    for name in VELOCITY:
        assert torch.equal(getattr(weighted, name), getattr(plain, name)), name


def test_weighting_reduces_partial_cover_drift():
    """At 60% cover with no internal stress both stresses are scaled by
    0.6: the first step's speed is smaller than unweighted, and nonzero."""
    mesh, planes = RectMesh(N, N, 512e3 / N, 512e3 / N), box(a_value=0.6)
    params = mevp.MEVPParams(p_star=0.0, use_coriolis=False)
    speed = lambda out: float(torch.hypot(out.u, out.v).max())
    plain = speed(port_step(mesh, params, planes, 20))
    weighted = speed(port_step(mesh, dataclasses.replace(params, a_weighted_stress=True), planes, 20))
    assert 0.0 < weighted < plain


def test_low_concentration_nodes_pinned():
    """Nodes whose lumped concentration is below a_dyn_min stay at rest;
    the packed half moves."""
    mesh, planes = RectMesh(N, N, 512e3 / N, 512e3 / N), box()
    planes["a"] = np.where(np.arange(N)[:, None] < N // 2, 1e-3, 0.9) * np.ones((N, N))
    out = port_step(mesh, mevp.MEVPParams(a_weighted_stress=True), planes, 50)
    u, v = out.u.numpy(), out.v.numpy()
    assert np.all(u[1: N // 2, 1:] == 0.0) and np.all(v[1: N // 2, 1:] == 0.0)
    assert np.max(np.abs(u[N // 2 + 2:, 1:])) > 0.0


def sharded_inputs(seed=0):
    """A global CoupledState with partial cover, physics and dynamics forcing."""
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([rng.uniform(lo, hi, (1, N, N)), rng.normal(0.0, 0.05 * hi, (2, N, N))])
    state = dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.02, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=np.full((N, N), -1.6), sss=np.full((N, N), 32.0), tice=np.full((1, N, N), -1.0),
        new_ice=np.zeros((N, N)),
        velocity={k: rng.normal(0.0, s, (N, N)) for k, s in zip(VELOCITY, (0.3, 0.3, 500.0, 500.0, 200.0))},
    )
    full = lambda v: np.full((N, N), v)
    phys = dict(tair=-10.0 + rng.normal(0.0, 1.0, (N, N)), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    dyn = dict(u_atm=8.0 + rng.normal(0.0, 1.0, (N, N)), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    return state, phys, dyn


def to_port(state, phys, dyn):
    kw = dict(device="cpu", dtype=torch.float64)
    return (
        interop.coupled_state_from_numpy(state, **kw), interop.forcing_from_numpy(phys, **kw),
        interop.dynamics_forcing_from_numpy(dyn, **kw),
    )


def to_jax(state, phys, dyn):
    velocity = jax_mevp.VelocityState(**{k: j64(state["velocity"][k]) for k in VELOCITY})
    return (
        JaxCoupledState(velocity=velocity, **{k: j64(v) for k, v in state.items() if k != "velocity"}),
        JaxForcing(**{k: j64(v) for k, v in phys.items()}),
        jax_mevp.DynamicsForcing(**{k: j64(v) for k, v in dyn.items()}),
    )


def assert_states_close(got, ref, rtol=RTOL):
    for name in ref:
        if name == "velocity":
            for k in VELOCITY:
                assert_close(got[name][k], ref[name][k], rtol, f"velocity.{k}")
        else:
            assert_close(got[name], ref[name], rtol, name)


@pytest.mark.parametrize("form", ["weighted", "adaptive"])
def test_blocked_rank_grid_matches_the_single_domain_and_jax_sharded_step(form):
    """The a_node plane and the adaptive form survive the blocked schedule's
    const widening: the 2 x 2 rank grid's coupled step equals the
    single-domain step, and the weighted one JAX's shard_map step (its
    "blocked" schedule on the 8-device CPU mesh's 2 x 2 part)."""
    tp, jp = params_pair(**FORMS[form])
    mesh = RectMesh(N, N, 512e3 / N, 512e3 / N)
    state, phys, dyn = sharded_inputs()
    single = CoupledModel(mesh, n_subcycles=10, mevp_params=tp)
    ref = interop.coupled_state_to_numpy(single.step(*to_port(state, phys, dyn), DT))
    grid = RankGrid(2, 2, "cpu", timeout=120.0)
    model, sharded = build_sharded_coupled_model(
        mesh, grid, n_subcycles=10, mevp_params=tp, mevp_block_halo=4,
    )
    assert model.mevp_schedule() == "blocked"
    blocks = sharded.run_blocks(
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float64),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float64),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float64), DT, 1,
    )
    got = interop.coupled_state_from_rank_blocks(blocks, grid)
    assert_states_close(got, ref, 1e-12)
    if form == "weighted":
        jmesh = jax_mesh.RectMesh(nx=N, ny=N, dx=512e3 / N, dy=512e3 / N)
        _, jstep = jax_build_sharded(jmesh, make_spatial_mesh((2, 2)), degree=1, n_subcycles=10, mevp_params=jp)
        assert_states_close(got, interop.coupled_state_to_numpy(jstep(*to_jax(state, phys, dyn), DT)))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_rdma_schedule_raises_for_the_forms(form, monkeypatch):
    """Since M10b part 1 the rdma schedule runs every form (its rounds:
    tests/test_torch_grid_metric.py); rdma_band's form instances are built
    for the shipped launch bound only, so a launch of more threads a block
    raises before any work (the CPU check patched to answer as for CUDA
    tensors; nothing is launched)."""
    from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma

    grid = RankGrid(2, 2, "cpu")
    model, _ = build_sharded_coupled_model(
        RectMesh(N, N, 1e3, 1e3), grid, mevp_backend="rdma", mevp_block_halo=4,
        mevp_params=mevp.MEVPParams(**FORMS[form]),
    )
    assert model.mevp_schedule() == "rdma"
    solver, h = model.mevp.local(), 4
    nx, ny = model.mesh.nx, model.mesh.ny
    plane = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    own = tuple(plane(nx, ny) for _ in range(5))
    src = rdma.RoundSources(own=own, h=h, split=(True, True), gx=(plane(5, h, ny),) * 2,
                            gy=(plane(5, nx + 2 * h, h),) * 2)
    consts_w = {name: plane(nx + 2 * h, ny + 2 * h)
                for name in mevp.const_names(solver.params.a_weighted_stress, True)}
    monkeypatch.setattr(cc, "_on_cpu", lambda t: False)
    with pytest.raises(ValueError, match="at most 256 threads"):
        rdma.rdma_band(solver, src, 0, consts_w, DT, h, [x.clone() for x in own], rdma.BandConfig(1, 16, 512))


def test_wind8_box_weighted_stays_finite():
    """test_a_weighted.py's acid test, in the port: the wind-8 box with
    A-weighted stresses, transport driving the marginal ice zone to zero
    concentration at finite thickness; with a_dyn_min the run stays finite
    and bounded. 200 steps of the JAX test's 2000, for the CPU's time: by
    then the zone has formed (min cice below 1e-6), and the JAX model's own
    run (float32, as here) has its max |u| at 2.10 m/s, which the port must
    match to 1e-3. (That run's max |u| passes 5 m/s on the way, 5.53 m/s at
    step 400, and is back at 2.17 m/s at step 2000, where the JAX test holds
    it below 5.)"""
    n = 32
    params = dict(a_weighted_stress=True)
    model = CoupledModel(
        RectMesh(n, n, 2000.0, 2000.0), degree=1, n_subcycles=20, mevp_params=mevp.MEVPParams(**params),
    )
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device="cpu", dtype=torch.float32)
    full = lambda v: torch.full((n, n), v, dtype=torch.float32)
    df = mevp.DynamicsForcing(u_atm=full(8.0), v_atm=full(8.0), u_ocean=full(0.1), v_ocean=full(0.0))
    state = model.run(state, None, df, DT, 200, do_thermo=False)
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    for name in VELOCITY:
        assert bool(torch.isfinite(getattr(state.velocity, name)).all()), name
    assert float(state.cice[0].max()) <= 1.0 + 1e-6 and float(state.cice[0].min()) < 1e-6
    jmodel = JaxCoupledModel(
        jax_mesh.RectMesh(nx=n, ny=n, dx=2000.0, dy=2000.0), degree=1, n_subcycles=20,
        mevp_params=jax_mevp.MEVPParams(**params),
    )
    jfull = lambda v: jnp.full((n, n), v, jnp.float32)
    jdf = jax_mevp.DynamicsForcing(u_atm=jfull(8.0), v_atm=jfull(8.0), u_ocean=jfull(0.1), v_ocean=jfull(0.0))
    jstate = jmodel.run(jmodel.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05), None, jdf, 600.0, 200, do_thermo=False)
    ref = float(jnp.max(jnp.abs(jstate.velocity.u)))
    got = float(state.velocity.u.abs().max())
    assert abs(got - ref) <= 1e-3 * ref and got < 5.0, (got, ref)


# -- twins of tests/test_mevp.py (adaptive alpha) -------------------------------------
def box_planes(n=32, wind=10.0):
    """test_mevp.py's _box_setup: h = 2, A = 1, wind (wind, 0), no current."""
    full = lambda v: np.full((n, n), v)
    return dict(h=full(2.0), a=full(1.0), u_atm=full(wind), v_atm=full(0.0), u_ocean=full(0.0), v_ocean=full(0.0))


def test_adaptive_alpha_equivalent_to_fixed_when_clamped():
    """c_stab = 0 puts the adaptive alpha = beta on alpha_min = 1500: only
    the divides' order differs from the fixed form."""
    mesh, planes = RectMesh(N, N, 512e3 / N, 512e3 / N), box_planes(N)
    fixed = mevp.MEVPParams(use_coriolis=False)
    adapt = mevp.MEVPParams(use_coriolis=False, adaptive_alpha=True, alpha_min=1500.0, c_stab=0.0)
    sf = sa = None
    for _ in range(3):
        sf = port_step(mesh, fixed, planes, 300, sf)
        sa = port_step(mesh, adapt, planes, 300, sa)
    np.testing.assert_allclose(sa.u.numpy(), sf.u.numpy(), rtol=0, atol=1e-14)


def test_adaptive_alpha_reaches_the_same_vp_fixed_point():
    """The port's adaptive run (12 steps of 1000 subcycles) reaches the VP
    fixed point of JAX's deeply converged fixed-alpha run (alpha = beta =
    200, 30 steps of 2000) to 1e-8, and is converged to 1e-10."""
    mesh, planes = RectMesh(N, N, 512e3 / N, 512e3 / N), box_planes(N)
    params = mevp.MEVPParams(use_coriolis=False, adaptive_alpha=True)
    state, deltas = None, []
    for _ in range(12):
        nxt = port_step(mesh, params, planes, 1000, state)
        if state is not None:
            deltas.append(float((nxt.u - state.u).abs().max()))
        state = nxt
    jmesh = jax_mesh.RectMesh(nx=N, ny=N, dx=512e3 / N, dy=512e3 / N)
    jsolver = jax_mevp.MEVPSolver(jmesh, jax_mevp.MEVPParams(use_coriolis=False, alpha=200.0, beta=200.0))
    jforcing = jax_mevp.DynamicsForcing(*(j64(planes[k]) for k in ("u_atm", "v_atm", "u_ocean", "v_ocean")))
    mask = jsolver.boundary_mask(dtype=jnp.float64)
    jstate = jax_mevp.VelocityState.zeros(N, N, dtype=jnp.float64)
    for _ in range(30):
        jstate = jsolver.step(jstate, j64(planes["h"]), j64(planes["a"]), jforcing, mask, dt=DT, n_subcycles=2000)
    fixed_u = np.asarray(jstate.u)
    rel = np.max(np.abs(state.u.numpy() - fixed_u)) / np.max(np.abs(fixed_u))
    assert rel < 1e-8, rel
    assert deltas[-1] < 1e-10, deltas


def test_adaptive_alpha_free_drift_unchanged():
    """Zero ice strength: zeta = 0, alpha sits on its floor, and free drift
    reaches the analytic drag balance."""
    params = mevp.MEVPParams(p_star=0.0, use_coriolis=False, adaptive_alpha=True, alpha_min=40.0)
    mesh, planes = RectMesh(32, 32, 512e3 / 32, 512e3 / 32), box_planes(32)
    state = None
    for _ in range(40):
        state = port_step(mesh, params, planes, 60, state)
    expected = np.sqrt((params.rho_atm * params.cd_atm) / (params.rho_ocean * params.cd_ocean)) * 10.0
    np.testing.assert_allclose(state.u.numpy()[8:-8, 8:-8], expected, rtol=2e-2)


def test_adaptive_alpha_graded_mesh_stable_and_converges():
    """On a graded mesh (1 to 32 km cells) the adaptive form is stable from
    a low floor and converges."""
    n = 32
    dxs = np.roll(1e3 + 31e3 * 0.5 * (1 - np.cos(2 * np.pi * (np.arange(n) + 0.5) / n)), n // 2)
    mesh = RectMesh(n, n, dxs, dxs.copy())
    full = lambda v: np.full((n, n), v)
    planes = dict(h=full(2.0), a=full(1.0), u_atm=full(15.0), v_atm=full(5.0), u_ocean=full(0.0), v_ocean=full(0.0))
    params = mevp.MEVPParams(use_coriolis=False, adaptive_alpha=True, alpha_min=25.0)
    state, deltas = None, []
    for _ in range(12):
        nxt = port_step(mesh, params, planes, 120, state)
        if state is not None:
            deltas.append(float((nxt.u - state.u).abs().max()))
        state = nxt
    assert bool(torch.isfinite(state.u).all())
    assert deltas[-1] < 0.05 * max(deltas), deltas


# -- the plain step against JAX's, form by form ----------------------------------------
SPHERE = dict(lon0=0.0, lon1=12.0, lat0=68.0, lat1=78.0)


def mevp_case(mesh_kind, seed=11):
    """(port mesh, JAX mesh, fields, node mask) with partial cover (A from
    0.01, some nodes below a_dyn_min) and on the spherical mesh a coastline
    (the node mask pins every node that touches land)."""
    rng = np.random.default_rng(seed)
    f = lambda scale: rng.normal(0.0, scale, (N, N))
    a = rng.uniform(0.3, 1.0, (N, N))
    a[: N // 4] = rng.uniform(0.0, 0.06, (N // 4, N))
    fields = dict(
        u=f(0.3), v=f(0.3), s11=f(2e3), s22=f(2e3), s12=f(1e3),
        h=rng.uniform(0.2, 2.5, (N, N)), a=a,
        u_atm=10.0 + f(2.0), v_atm=3.0 + f(2.0), u_ocean=f(0.05), v_ocean=f(0.05),
    )
    mask = np.ones((N, N))
    mask[0, :] = mask[:, 0] = 0.0
    if mesh_kind == "uniform":
        tmesh, jmesh = RectMesh(N, N, 4e3, 4e3), jax_mesh.RectMesh(nx=N, ny=N, dx=4e3, dy=4e3)
    else:
        tmesh, jmesh = SphericalMesh(N, N, **SPHERE), jax_mesh.SphericalMesh(N, N, **SPHERE)
        ocean = landmask.synthetic_coastline(N)
        pad = np.pad(ocean, ((1, 0), (1, 0)))  # element (i-1, j-1) of node (i, j); walls as land
        mask *= ocean * pad[:-1, 1:] * pad[1:, :-1] * pad[:-1, :-1]
    return tmesh, jmesh, fields, mask


def both_inputs(fields, mask):
    frc = ("u_atm", "v_atm", "u_ocean", "v_ocean")
    tin = (
        mevp.VelocityState(**{k: t64(fields[k]) for k in VELOCITY}), t64(fields["h"]), t64(fields["a"]),
        mevp.DynamicsForcing(**{k: t64(fields[k]) for k in frc}), t64(mask),
    )
    jin = (
        jax_mevp.VelocityState(**{k: j64(fields[k]) for k in VELOCITY}), j64(fields["h"]), j64(fields["a"]),
        jax_mevp.DynamicsForcing(**{k: j64(fields[k]) for k in frc}), j64(mask),
    )
    return tin, jin


@pytest.mark.parametrize("mesh_kind", ["uniform", "spherical"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_step_consts_and_15_subcycles_match_jax(form, mesh_kind):
    """step_consts plane by plane (a_node, the pinned active, the weighted
    b_u and b_v) and 15 subcycles against JAX's plain solver at 1e-8 of
    each plane's max; on a uniform mesh also against JAX's single-call
    kernel (K4) in interpret mode."""
    tp, jp = params_pair(**FORMS[form])
    tmesh, jmesh, fields, mask = mevp_case(mesh_kind)
    tin, jin = both_inputs(fields, mask)
    tsolver = mevp.MEVPSolver(tmesh, tp)
    jsolver = jax_mevp.MEVPSolver(jmesh, jp, backend="xla")
    got = tsolver.step_consts(*tin, DT)
    ref = jsolver.step_consts(*jin, DT)
    assert tuple(got) == mevp.const_names(tp.a_weighted_stress, tmesh.uniform)
    assert set(got) == set(ref)
    for name in ref:
        assert_close(got[name], ref[name], 1e-12, name)
    if tp.a_weighted_stress:
        a_node = got["a_node"].numpy()
        assert ((a_node > 0) & (a_node < tp.a_dyn_min)).any() and (a_node > 0.5).any()
        assert np.all(got["active"].numpy()[a_node < tp.a_dyn_min] == 0.0)
    out = tsolver.step(*tin, DT, 15)
    for backend in ("xla", "pallas-interpret") if mesh_kind == "uniform" else ("xla",):
        jsolver = jax_mevp.MEVPSolver(jmesh, jp, backend=backend)
        jref = jsolver.step(*jin, DT, 15)
        for name in VELOCITY:
            assert_close(getattr(out, name), getattr(jref, name), RTOL, f"{backend} {name}")


@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_kernel_wrappers_run_the_plain_halves_on_the_cpu(form):
    """On CPU tensors the K1 wrappers, mevp_tiled and mevp_single run the
    plain versions: mevp_stress returns beta last in the adaptive form and
    mevp_velocity takes it; velocity_update refuses a beta in the fixed
    form and needs one in the adaptive form."""
    from nextsimdg_tpu_torch.dynamics.kernels import mevp_tiled_cuda as mt

    tp, _ = params_pair(**FORMS[form])
    tmesh, _, fields, mask = mevp_case("uniform")
    tin, _ = both_inputs(fields, mask)
    solver = mevp.MEVPSolver(tmesh, tp)
    consts = solver.step_consts(*tin, DT)
    carry = tuple(getattr(tin[0], k) for k in VELOCITY)
    halves = cc.mevp_stress(solver, carry, consts)
    assert len(halves) == (6 if tp.adaptive_alpha else 5)
    uv = cc.mevp_velocity(solver, (*carry[:2], *halves[:3]), consts, *halves[3:5], DT, *halves[5:])
    ref = solver.subcycle_body(carry, consts, DT)
    for g, r in zip((*uv, *halves[:3]), ref):
        assert torch.equal(g, r)
    wrong = None if tp.adaptive_alpha else halves[4]
    with pytest.raises(ValueError, match="adaptive"):
        solver.velocity_update((*carry[:2], *halves[:3]), consts, *halves[3:5], DT, wrong)
    for run in (cc.mevp_subcycles, mt.mevp_subcycles_tiled, ms.mevp_subcycles_single):
        for g, r in zip(run(solver, carry, consts, DT, 3), cc.mevp_subcycles_reference(solver, carry, consts, DT, 3)):
            assert torch.equal(g, r)


# -- the coupled step -----------------------------------------------------------------------
def coupled_inputs(seed=0):
    return sharded_inputs(seed)


@pytest.mark.parametrize("form", ["weighted", "both"])
def test_coupled_step_with_physics_matches_jax(form):
    """One coupled step with thermodynamics, 15 subcycles, partial cover:
    the port on the CPU against the JAX model's staged path and its fused
    kernel (K1) in interpret mode, all 12 leaves at 1e-8."""
    tp, jp = params_pair(**FORMS[form])
    mesh = RectMesh(N, N, 512e3 / N, 512e3 / N)
    jmesh = jax_mesh.RectMesh(nx=N, ny=N, dx=512e3 / N, dy=512e3 / N)
    state, phys, dyn = coupled_inputs()
    got = interop.coupled_state_to_numpy(
        CoupledModel(mesh, n_subcycles=15, mevp_params=tp).step(*to_port(state, phys, dyn), DT)
    )
    for backend in ("auto", "pallas-interpret"):
        jmodel = JaxCoupledModel(jmesh, degree=1, n_subcycles=15, mevp_params=jp, mevp_backend=backend)
        assert (jmodel._fused_dynamics_mode() == "interpret") == (backend != "auto")
        ref = interop.coupled_state_to_numpy(jmodel.step(*to_jax(state, phys, dyn), dt=DT))
        assert_states_close(got, ref)


@pytest.fixture
def free_drift():
    """Nextsim::FreeDrift selected in both packages' registries, reset after."""
    loader, jloader = modules.get_loader(), JaxModuleRegistry.get_loader()
    loader.set_implementation(DYNAMICS, FREE_DRIFT)
    jloader.set_implementation(DYNAMICS, FREE_DRIFT)
    try:
        yield
    finally:
        loader.reset()
        jloader.reset()


@pytest.mark.parametrize("do_thermo", [False, True])
def test_free_drift_coupled_step_matches_jax(free_drift, do_thermo):
    """The free-drift coupled step (the drag balance, then the CFL count and
    the limited transport) against JAX's staged path at 1e-8; the stresses
    come out zero."""
    mesh = RectMesh(N, N, 512e3 / N, 512e3 / N)
    jmesh = jax_mesh.RectMesh(nx=N, ny=N, dx=512e3 / N, dy=512e3 / N)
    port = CoupledModel(mesh, n_subcycles=5)
    jmodel = JaxCoupledModel(jmesh, degree=1, n_subcycles=5)
    assert port.is_free_drift and isinstance(jmodel.mevp, JaxFreeDriftSolver)
    assert port.schedule("cpu") == ("free-drift", "xla")
    state, phys, dyn = coupled_inputs()
    got = interop.coupled_state_to_numpy(port.step(*to_port(state, phys, dyn), DT, do_thermo=do_thermo))
    ref = interop.coupled_state_to_numpy(jmodel.step(*to_jax(state, phys, dyn), dt=DT, do_thermo=do_thermo))
    assert_states_close(got, ref)
    assert not np.any(got["velocity"]["s11"]) and np.any(got["velocity"]["u"])


def test_free_drift_on_a_rank_grid_raises(free_drift, monkeypatch):
    """Since M10b part 1 free drift runs on a rank grid (its step against
    one domain's: tests/test_torch_grid_metric.py), and with the staged
    transport on a card too: the CPU check patched to answer as for CUDA
    tensors and every kernel launch recorded in place of launching, a step
    reaches dg1_sample_cfl and dg1_rk_stage's halo form and raises nothing.
    What still raises is a schedule that a rank grid has no counterpart of.
    (The name is from when the staged transport raised on a card.)"""
    grid = RankGrid(2, 2, "cpu")
    model, sharded = build_sharded_coupled_model(
        RectMesh(N, N, 1e3, 1e3), grid, n_subcycles=2, transport_backend="xla",
    )
    assert model.is_free_drift and model.schedule("cpu") == ("free-drift", "xla")
    state, phys, dyn = coupled_inputs()
    blocks = (
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float32),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float32),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float32),
    )
    calls = []
    monkeypatch.setattr(cc, "_on_cpu", lambda t: False)
    monkeypatch.setattr(cc, "_launch", lambda name, *args, entry=None: calls.append((name, entry)))
    monkeypatch.setattr(cc, "_stream", lambda device: 0)
    sharded.run_blocks(*blocks, DT, 1)
    assert set(calls) == {("dg1_sample_cfl", None), ("dg1_rk_stage", "dg1_rk_stage_halo")}
    with pytest.raises(ValueError, match="mevp_backend"):
        build_sharded_coupled_model(RectMesh(N, N, 1e3, 1e3), grid, mevp_backend="pallas")


# -- twins of tests/test_dynamics_module.py ----------------------------------------------
def test_default_dynamics_is_mevp():
    model = CoupledModel(RectMesh(8, 8, 1e3, 1e3))
    assert type(model.mevp) is mevp.MEVPSolver and not model.is_free_drift


def test_freedrift_selected_from_config():
    loader = modules.get_loader()
    try:
        Configurator.add_stream("[Modules]\nNextsim::IDynamics = Nextsim::FreeDrift\n")
        loader.set_all_defaults()
        ConfiguredModule.parse_configurator()
        model = CoupledModel(RectMesh(8, 8, 1e3, 1e3))
        assert isinstance(model.mevp, FreeDriftSolver) and model.mevp_schedule() == "free-drift"
    finally:
        Configurator.clear()
        loader.reset()
    assert type(CoupledModel(RectMesh(8, 8, 1e3, 1e3)).mevp) is mevp.MEVPSolver


def test_freedrift_coupled_step_reaches_drag_balance(free_drift):
    """20 steps of 8 m/s wind: the interior speed near the drag balance, no
    internal stress."""
    n = 8
    model = CoupledModel(RectMesh(n, n, 512e3 / n, 512e3 / n), degree=1, n_subcycles=5)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device="cpu", dtype=torch.float64)
    full = lambda v: torch.full((n, n), v, dtype=torch.float64)
    df = mevp.DynamicsForcing(u_atm=full(8.0), v_atm=full(0.0), u_ocean=full(0.0), v_ocean=full(0.0))
    out = model.run(state, None, df, DT, 20, do_thermo=False)
    expected = np.sqrt((1.225 * 1.2e-3) / (1026.0 * 5.5e-3)) * 8.0
    assert abs(np.median(out.velocity.u.numpy()[2:-2, 2:-2]) - expected) < 0.3 * expected
    np.testing.assert_allclose(out.velocity.s11.numpy(), 0.0, atol=1e-12)


# -- mevp_single's tiles and "auto" with the thirteenth plane -----------------------------
@pytest.mark.parametrize("sms", [132, 78, 16])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_single_holds_and_auto_count_the_thirteenth_plane(form, sms):
    """The a_node plane is a const plane: it joins the resident set where
    every plane fits (last in RESIDENT_ORDER) and is read from L2 where
    not, so the tiling, holds() and "auto"'s choice on a spherical mesh are
    those of the unweighted form on cards of 132, 78 and 16 SMs, and every
    resident set fits a block's shared memory."""
    tp, _ = params_pair(**FORMS[form])
    weighted = tp.a_weighted_stress
    for n in (128, 512, 640, 1024):
        held = ms.holds(n, n, sms)
        model = CoupledModel(SphericalMesh(n, n, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0), mevp_params=tp)
        expected = "single" if held and n * n < 1024 * 1024 + 1 else "pallas-tiled"
        assert model.mevp_schedule(sms) == expected, n
        if not held:
            continue
        config = ms.tiling(n, n, sms)
        resident = config.resident(True, weighted)
        names = mevp.const_names(weighted, False)
        assert ("a_node" in resident) == (weighted and len(resident) == len(names) == 13)
        assert config.shared_bytes(True, weighted) <= ms.SHARED_LIMIT
        assert resident[:2] == config.resident(True)[:2]
