"""The port's dynamics phase and coupled step against the JAX package.

Float64 on the CPU, 16 x 16 elements, 15 mEVP subcycles, inputs drawn from
a numpy seed and carried across by ``nextsimdg_tpu_torch.interop``. The
JAX fused kernel and its ghost-zone tiled mEVP and transport kernels run in
interpret mode, as their own tests run them.
Tolerances: 1e-8 of each plane's max |value| after subcycles (the shared
divide amplifies rounding differences), exact where the same operations
run on the same values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.coupled import _clamp_dg as jax_clamp_dg
from nextsimdg_tpu.coupled import _rescale_dg as jax_rescale_dg
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics.kernels.coupled_pallas import fused_dynamics_pallas
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing as JaxDynamicsForcing
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.dynamics.mevp import VelocityState as JaxVelocityState
from nextsimdg_tpu.modules import ModuleRegistry
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu.state import PrognosticState as JaxPrognosticState
from nextsimdg_tpu_torch import coupled, interop
from nextsimdg_tpu_torch.coupled import CoupledModel, _clamp_dg, _rescale_dg
from nextsimdg_tpu_torch.dynamics import RectMesh
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda
from nextsimdg_tpu_torch.dynamics.transport import cfl_substeps, velocity_from_cg

torch.set_num_threads(1)

N = 16
N_SUBCYCLES = 15
DT = 600.0
RTOL = 1e-8
VELOCITY = ("u", "v", "s11", "s22", "s12")
TRACERS = ("hice", "cice", "hsnow")


def assert_planes_close(got, ref, rtol=RTOL, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def assert_states_close(got: dict, ref: dict, rtol=RTOL):
    for name in ref:
        if name == "velocity":
            for k in VELOCITY:
                assert_planes_close(got[name][k], ref[name][k], rtol, f"velocity.{k}")
        else:
            assert_planes_close(got[name], ref[name], rtol, name)


def seeded_state(seed=0, speed=0.3):
    """A CoupledState as numpy leaves: perturbed dG1 tracers, a moving
    velocity and nonzero stresses."""
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([
        rng.uniform(lo, hi, (1, N, N)), rng.normal(0.0, 0.05 * hi, (2, N, N))
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
    return dict(
        u_atm=10.0 + rng.normal(0.0, 1.0, (N, N)), v_atm=np.full((N, N), 3.0),
        u_ocean=np.full((N, N), 0.02), v_ocean=rng.normal(0.0, 0.01, (N, N)),
    )


def to_jax_state(d):
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    velocity = JaxVelocityState(**{k: j(d["velocity"][k]) for k in VELOCITY})
    return JaxCoupledState(velocity=velocity, **{k: j(v) for k, v in d.items() if k != "velocity"})


def to_jax_forcing(d):
    return JaxDynamicsForcing(**{k: jnp.asarray(v, dtype=jnp.float64) for k, v in d.items()})


def models(dx=512e3 / N, **kwargs):
    """(port, JAX staged, JAX fused-interpret) models of one configuration."""
    port = CoupledModel(RectMesh(N, N, dx, dx), degree=1, n_subcycles=N_SUBCYCLES, **kwargs)
    jmesh = JaxRectMesh(nx=N, ny=N, dx=dx, dy=dx)
    staged = JaxCoupledModel(jmesh, degree=1, n_subcycles=N_SUBCYCLES, **kwargs)
    fused = JaxCoupledModel(
        jmesh, degree=1, n_subcycles=N_SUBCYCLES, mevp_backend="pallas-interpret", **kwargs
    )
    assert fused._fused_dynamics_mode() == "interpret"
    return port, staged, fused


@pytest.mark.parametrize("masked", [False, True])
def test_fused_dynamics_reference_matches_the_fused_tpu_kernel(masked):
    """The plain dynamics phase == fused_dynamics_pallas in interpret mode,
    with k > 1 CFL substeps and, optionally, coastline face masks."""
    port, _, fused = models(dx=2000.0)
    state_np, forcing_np = seeded_state(speed=0.5), seeded_forcing()
    masks_np = None
    if masked:
        rng = np.random.default_rng(5)
        masks_np = [(rng.uniform(size=(N, N)) > 0.15).astype(float) for _ in range(2)]

    state = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(forcing_np, device="cpu", dtype=torch.float64)
    mask = port.node_mask(device="cpu", dtype=torch.float64)
    consts = port.mevp.step_consts(
        state.velocity, state.hice[0], torch.clamp(state.cice[0], 0.0, 1.0), forcing, mask, DT
    )
    carry = tuple(getattr(state.velocity, k) for k in VELOCITY)
    tracers = torch.stack([state.hice, state.cice, state.hsnow], dim=1)
    t_masks = None if masks_np is None else [torch.tensor(m) for m in masks_np]
    got_carry, got_tr = coupled_cuda.fused_dynamics_reference(
        port, carry, tracers, consts, DT, N_SUBCYCLES, face_masks=t_masks
    )

    jstate, jforcing = to_jax_state(state_np), to_jax_forcing(forcing_np)
    jmask = fused.node_mask(jnp.float64)
    jconsts = fused.mevp.step_consts(
        jstate.velocity, jstate.hice[0], jnp.clip(jstate.cice[0], 0.0, 1.0), jforcing, jmask, DT
    )
    jtracers = jnp.stack([jstate.hice, jstate.cice, jstate.hsnow], axis=1)
    j_masks = None if masks_np is None else tuple(jnp.asarray(m) for m in masks_np)
    ref_carry, ref_tr = fused_dynamics_pallas(
        fused, tuple(getattr(jstate.velocity, k) for k in VELOCITY), jtracers, jconsts,
        DT, N_SUBCYCLES, face_masks=j_masks, interpret=True,
    )

    for g, r, name in zip(got_carry, ref_carry, VELOCITY):
        assert_planes_close(g.numpy(), r, name=name)
    assert_planes_close(got_tr.numpy(), ref_tr, name="tracers")
    qv = velocity_from_cg(port.mesh, port.transport.basis, got_carry[0], got_carry[1])
    assert int(cfl_substeps(qv, DT, port.mesh, 1)) > 1  # the substep loop ran


def test_fused_dynamics_on_cpu_is_the_plain_version():
    port, _, _ = models()
    state = interop.coupled_state_from_numpy(seeded_state(), device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(seeded_forcing(), device="cpu", dtype=torch.float64)
    mask = port.node_mask(device="cpu", dtype=torch.float64)
    consts = port.mevp.step_consts(state.velocity, state.hice[0], state.cice[0], forcing, mask, DT)
    carry = tuple(getattr(state.velocity, k) for k in VELOCITY)
    tracers = torch.stack([state.hice, state.cice, state.hsnow], dim=1)
    coupled_cuda.reset_launches()
    got = coupled_cuda.fused_dynamics(port, carry, tracers, consts, DT, 3)
    ref = coupled_cuda.fused_dynamics_reference(port, carry, tracers, consts, DT, 3)
    for g, r in zip((*got[0], got[1]), (*ref[0], ref[1])):
        assert torch.equal(g, r)
    assert all(count == 0 for count in coupled_cuda.launches.values())
    meta = tracers.to("meta")
    with pytest.raises(ValueError, match="not supported"):
        coupled_cuda.fused_dynamics(port, carry, meta, consts, DT, 3)


@pytest.mark.parametrize("jax_model", ["staged", "fused"])
def test_coupled_step_and_run_match_the_jax_model(jax_model):
    port, staged, fused = models()
    jmodel = staged if jax_model == "staged" else fused
    state_np, forcing_np = seeded_state(), seeded_forcing()
    state = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(forcing_np, device="cpu", dtype=torch.float64)
    jstate, jforcing = to_jax_state(state_np), to_jax_forcing(forcing_np)

    got = state
    ref = jstate
    for _ in range(2):
        got = port.step(got, None, forcing, DT, do_thermo=False)
        ref = jmodel.step(ref, None, jforcing, dt=DT, do_thermo=False)
    assert_states_close(interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref))

    got_run = port.run(state, None, forcing, DT, 2, do_thermo=False)
    for name in TRACERS:
        assert torch.equal(getattr(got_run, name), getattr(got, name))
    if jax_model == "staged":
        ref_run = jmodel.run(jstate, None, jforcing, DT, 2, do_thermo=False)
        assert_states_close(
            interop.coupled_state_to_numpy(got_run), interop.coupled_state_to_numpy(ref_run)
        )


def test_fixed_substeps_and_the_bench_initial_state():
    """auto_substeps=False pins k = transport_substeps; the initial state
    is the JAX model's."""
    port, staged, _ = models(transport_substeps=2, auto_substeps=False)
    kwargs = dict(hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0)
    state = port.initial_state(**kwargs, device="cpu", dtype=torch.float64)
    jstate = staged.initial_state(**kwargs, dtype=jnp.float64)
    assert_states_close(interop.coupled_state_to_numpy(state), interop.coupled_state_to_numpy(jstate), 0.0)
    forcing_np = seeded_forcing()
    forcing = interop.dynamics_forcing_from_numpy(forcing_np, device="cpu", dtype=torch.float64)
    got = port.step(state, None, forcing, DT, do_thermo=False)
    ref = staged.step(jstate, None, to_jax_forcing(forcing_np), dt=DT, do_thermo=False)
    assert_states_close(interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref))
    # do_dynamics=False and do_thermo=False leave the state as it is.
    assert port.step(got, None, forcing, DT, do_dynamics=False, do_thermo=False) is got


def test_clamp_and_rescale_dg_match():
    rng = np.random.default_rng(9)
    coeffs = rng.normal(0.5, 0.6, (3, N, N))
    new_mean = rng.normal(0.5, 0.6, (N, N))
    new_mean[:2] = 0.0
    coeffs[0, 2:4] = 0.0  # old mean zero: ratio 0
    for lo, hi in ((0.0, None), (0.0, 1.0)):
        got = _clamp_dg(torch.tensor(coeffs), lo, hi).numpy()
        assert np.array_equal(got, np.asarray(jax_clamp_dg(jnp.asarray(coeffs), lo, hi)))
    got = _rescale_dg(torch.tensor(coeffs), torch.tensor(new_mean)).numpy()
    assert np.array_equal(got, np.asarray(jax_rescale_dg(jnp.asarray(coeffs), jnp.asarray(new_mean))))


def test_interop_round_trip():
    state_np = seeded_state()
    state = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
    back = interop.coupled_state_to_numpy(state)
    assert_states_close(back, state_np, 0.0)
    assert_states_close(interop.coupled_state_to_numpy(to_jax_state(state_np)), state_np, 0.0)
    f32 = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float32)
    assert f32.velocity.s12.dtype == torch.float32
    forcing = interop.dynamics_forcing_from_numpy(seeded_forcing(), device="cpu", dtype=torch.float64)
    assert np.array_equal(forcing.u_atm.numpy(), seeded_forcing()["u_atm"])
    jparams = JaxMEVPParams(alpha=900.0, use_coriolis=False)
    params = interop.mevp_params_from_dict(dataclasses.asdict(jparams))
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    with pytest.raises(KeyError):
        interop.mevp_params_from_dict({"alpha": 1.0})
    with pytest.raises(KeyError):
        interop.coupled_state_from_numpy({"hice": state_np["hice"]}, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(spmd=("x", "y"), mevp_params=coupled.MEVPParams(a_weighted_stress=True)),
        dict(spmd=("x", None)), dict(tvb_m=0.0, spmd="rank"), dict(degree=2, tvb_m=1.0, spmd="rank"),
    ],
)
def test_unported_options_raise(kwargs):
    """JAX device-mesh axis names raise. The TVB limiter on a rank grid
    (``spmd="rank"``: rank 0 of a 2 x 2 grid) runs since M10b part 1, and
    with the HO solver selected since M10b part 2a (on CPU tensors; on a
    card it raises at the step, ``tests/test_torch_grid_ho_coupled.py``);
    the HO solver's rdma schedule builds since M10b part 2b's first half."""
    from nextsimdg_tpu_torch import modules

    if kwargs.get("spmd") != "rank":
        with pytest.raises(NotImplementedError):
            CoupledModel(RectMesh(N, N, 1e3, 1e3), **kwargs)
        return
    from nextsimdg_tpu_torch.parallel import RankGrid

    kwargs = dict(kwargs, spmd=RankGrid(2, 2, "cpu").ranks[0])
    model = CoupledModel(RectMesh(N, N, 1e3, 1e3), **kwargs)
    assert model.transport.tvb_m == kwargs["tvb_m"] and model.exchange is kwargs["spmd"]
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        model = CoupledModel(RectMesh(N, N, 1e3, 1e3), **kwargs)
        assert model.is_high_order and model.mevp_schedule() == "blocked"
        assert model.transport.tvb_m == kwargs["tvb_m"]
        model = CoupledModel(RectMesh(N, N, 1e3, 1e3), mevp_backend="rdma", **kwargs)
        assert model.is_high_order and model.mevp_schedule() == "rdma"
    finally:
        loader.reset()


def test_thermodynamics_not_ported_raises():
    """The column physics runs (do_thermo=True is the default) and needs
    the physics forcing: without one the step raises and names it."""
    port = CoupledModel(RectMesh(N, N, 1e3, 1e3), n_subcycles=1)
    state = port.initial_state(device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(seeded_forcing(), device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="Forcing"):
        port.step(state, None, forcing, DT)
    with pytest.raises(ValueError, match="Forcing"):
        port.step(state, None, forcing, DT, do_dynamics=False)


# -- the coupled thermo + dynamics step (BASELINE config 4's path) --------------
def seeded_physics_forcing(seed=3):
    """Config-4-like physics forcing with cold, varied air; the sea surface
    of ``thermo_state`` sits at and above freezing, so ice forms in some
    cells and not in others."""
    rng = np.random.default_rng(seed)
    return dict(
        tair=rng.uniform(-25.0, -5.0, (N, N)), dew2m=rng.uniform(-27.0, -7.0, (N, N)),
        pair=np.full((N, N), 1e5), sw_in=np.full((N, N), 5.0), lw_in=np.full((N, N), 240.0),
        mld=np.full((N, N), 10.0), snowfall=np.full((N, N), 1e-4),
        wind=rng.uniform(2.0, 10.0, (N, N)),
    )


def thermo_state(seed=0):
    state = seeded_state(seed)
    rng = np.random.default_rng(seed + 7)
    state["sst"] = rng.uniform(-1.78, -1.5, (N, N))
    state["tice"] = rng.uniform(-15.0, -2.0, (1, N, N))
    return state


def jax_tiled_model(**kwargs):
    """The JAX model on its ghost-zone tiled kernels (interpret mode) and the
    registry's default physics chain."""
    ModuleRegistry.get_loader().reset()
    model = JaxCoupledModel(
        JaxRectMesh(nx=N, ny=N, dx=4e3, dy=4e3), degree=1, n_subcycles=N_SUBCYCLES,
        mevp_backend="pallas-tiled-interpret", transport_backend="tiled-interpret", **kwargs,
    )
    assert model.mevp._kernel_choice() == "tiled"
    assert model._tiled_transport_mode() == "interpret"
    assert model._fused_dynamics_mode() is None
    return model


@pytest.mark.parametrize("seed", [0, 1])
def test_coupled_thermo_step_matches_the_jax_tiled_kernels(seed):
    """The full step, do_thermo=True: the port on the CPU against JAX's
    mevp_subcycles_tiled + transport_substeps_tiled in interpret mode."""
    port = CoupledModel(RectMesh(N, N, 4e3, 4e3), degree=1, n_subcycles=N_SUBCYCLES)
    jmodel = jax_tiled_model()
    state_np, forcing_np, phys_np = thermo_state(seed), seeded_forcing(seed + 1), seeded_physics_forcing(seed + 2)
    state = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(forcing_np, device="cpu", dtype=torch.float64)
    phys = interop.forcing_from_numpy(phys_np, device="cpu", dtype=torch.float64)
    jphys = JaxForcing(**{k: jnp.asarray(v, dtype=jnp.float64) for k, v in phys_np.items()})
    jforcing = to_jax_forcing(forcing_np)

    got, ref = state, to_jax_state(state_np)
    for _ in range(2):
        got = port.step(got, phys, forcing, DT)
        ref = jmodel.step(ref, jphys, jforcing, dt=DT)
    got_np, ref_np = interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref)
    assert_states_close(got_np, ref_np)
    # Every physics branch that config 4 takes ran: ice formed somewhere.
    assert (ref_np["new_ice"] > 0).any() and (ref_np["new_ice"] == 0).any()
    assert not np.array_equal(ref_np["tice"], state_np["tice"])

    got_run = port.run(state, phys, forcing, DT, 2)
    for name in ("hice", "cice", "hsnow", "tice", "new_ice"):
        assert torch.equal(getattr(got_run, name), getattr(got, name))


def test_step_thermo_is_the_physics_on_the_cell_means():
    """step_thermo == NextsimPhysics.step on the means, with the moments
    rescaled; the JAX step with do_dynamics=False agrees."""
    port = CoupledModel(RectMesh(N, N, 4e3, 4e3), n_subcycles=1)
    state_np, phys_np = thermo_state(2), seeded_physics_forcing(4)
    state = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
    phys = interop.forcing_from_numpy(phys_np, device="cpu", dtype=torch.float64)
    got = port.step(state, phys, None, DT, do_dynamics=False)
    prog = interop.prognostic_state_from_numpy(
        {k: state_np[k] if k in ("sst", "sss", "tice") else state_np[k][0]
         for k in ("hice", "cice", "hsnow", "sst", "sss", "tice")},
        device="cpu", dtype=torch.float64,
    )
    updated, diags = port.physics.step(prog, phys, state.new_ice, DT)
    assert torch.equal(got.hice[0], updated.hice) and torch.equal(got.new_ice, diags.new_ice)
    assert torch.equal(got.hice, _rescale_dg(state.hice, updated.hice))
    assert got.velocity is state.velocity
    jmodel = jax_tiled_model()
    jphys = JaxForcing(**{k: jnp.asarray(v, dtype=jnp.float64) for k, v in phys_np.items()})
    ref = jmodel.step(to_jax_state(state_np), jphys, None, dt=DT, do_dynamics=False)
    assert_states_close(interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref))


def test_physics_interop_round_trip():
    phys_np = seeded_physics_forcing()
    phys = interop.forcing_from_numpy(phys_np, device="cpu", dtype=torch.float32)
    assert phys.tair.dtype == torch.float32
    back = interop.forcing_to_numpy(interop.forcing_from_numpy(phys_np, device="cpu", dtype=torch.float64))
    assert all(np.array_equal(back[k], phys_np[k]) for k in phys_np)
    jphys = JaxForcing(**{k: jnp.asarray(v) for k, v in phys_np.items()})
    assert all(np.array_equal(interop.forcing_to_numpy(jphys)[k], phys_np[k]) for k in phys_np)
    prog_np = {k: np.full((N, N), 0.5) for k in ("hice", "cice", "hsnow", "sst", "sss")}
    prog_np["tice"] = np.full((1, N, N), -3.0)
    prog = interop.prognostic_state_from_numpy(prog_np, device="cpu", dtype=torch.float64)
    assert all(np.array_equal(interop.prognostic_state_to_numpy(prog)[k], prog_np[k]) for k in prog_np)
    jprog = JaxPrognosticState(**{k: jnp.asarray(v) for k, v in prog_np.items()})
    assert all(np.array_equal(interop.prognostic_state_to_numpy(jprog)[k], prog_np[k]) for k in prog_np)
    with pytest.raises(KeyError):
        interop.forcing_from_numpy({"tair": phys_np["tair"]}, device="cpu", dtype=torch.float64)


# -- the kernel schedule (mevp_backend, transport_backend) ----------------------
@pytest.mark.parametrize(
    "mevp_backend, transport_backend, expected",
    [
        ("pallas", "auto", ("pallas", "xla")),
        ("pallas", "tiled", ("pallas", "xla")),  # K1's whole-phase schedule
        ("pallas-tiled", "tiled", ("pallas-tiled", "tiled")),
        ("pallas-tiled", "xla", ("pallas-tiled", "xla")),
    ],
)
def test_explicit_backends_are_honoured(mevp_backend, transport_backend, expected):
    port = CoupledModel(
        RectMesh(N, N, 1e3, 1e3), mevp_backend=mevp_backend, transport_backend=transport_backend
    )
    assert (port.mevp_schedule(), port.transport_schedule()) == expected


@pytest.mark.parametrize("side", ["below", "at", "above"])
def test_auto_backends_follow_the_element_threshold(side):
    threshold = coupled.TILED_MIN_ELEMENTS
    nx = {"below": threshold // 64 - 1, "at": threshold // 64, "above": threshold // 64 + 1}[side]
    port = CoupledModel(RectMesh(nx, 64, 1e3, 1e3))
    tiled = side != "below"
    assert port.mevp_schedule() == ("pallas-tiled" if tiled else "pallas")
    assert port.transport_schedule() == ("tiled" if tiled else "xla")
    if tiled:
        port.transport.scheme = "rk3"  # the tiled transport kernel runs rk3 too
        assert port.transport_schedule() == "tiled"


@pytest.mark.parametrize("kwargs", [dict(mevp_backend="xla"), dict(transport_backend="banded")])
def test_unknown_backends_raise(kwargs):
    with pytest.raises(ValueError, match="backend"):
        CoupledModel(RectMesh(N, N, 1e3, 1e3), **kwargs)


@pytest.mark.parametrize("mevp_backend", ["pallas", "pallas-tiled"])
def test_every_schedule_runs_the_plain_version_on_the_cpu(mevp_backend):
    """CPU tensors always take the plain PyTorch versions, whatever the
    schedule: the same step, no kernel launched."""
    from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc

    port = CoupledModel(
        RectMesh(N, N, 4e3, 4e3), n_subcycles=3, mevp_backend=mevp_backend,
        transport_backend="tiled",
    )
    state = interop.coupled_state_from_numpy(thermo_state(), device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(seeded_forcing(), device="cpu", dtype=torch.float64)
    phys = interop.forcing_from_numpy(seeded_physics_forcing(), device="cpu", dtype=torch.float64)
    cc.reset_launches()
    got = port.step(state, phys, forcing, DT)
    ref = port.step_thermo(
        port.step_dynamics(state, forcing, DT, phase=cc.fused_dynamics_reference), phys, DT
    )
    assert all(count == 0 for count in cc.launches.values())
    assert_states_close(interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref), 0.0)


# -- the registry and the signature, as the JAX package has them -----------------
def test_registry_selected_thermodynamics_reaches_the_default_physics():
    """The model's default physics resolves its modules from the registry on
    first use, as JAX's does: with ThermoWinton selected in both registries
    (3 ice layers), two coupled steps at f64 match JAX's, and the port ran
    ThermoWinton. Both registries are reset in ``finally``."""
    from nextsimdg_tpu_torch import modules

    winton = ("Nextsim::IThermodynamics", "Nextsim::ThermoWinton")
    state_np, forcing_np, phys_np = thermo_state(4), seeded_forcing(5), seeded_physics_forcing(6)
    rng = np.random.default_rng(8)
    state_np["tice"] = np.sort(rng.uniform(-15.0, -2.0, (3, N, N)), axis=0)
    ModuleRegistry.get_loader().set_implementation(*winton)
    modules.get_loader().set_implementation(*winton)
    try:
        port = CoupledModel(RectMesh(N, N, 4e3, 4e3), degree=1, n_subcycles=N_SUBCYCLES)
        jmodel = JaxCoupledModel(JaxRectMesh(nx=N, ny=N, dx=4e3, dy=4e3), degree=1, n_subcycles=N_SUBCYCLES)
        got = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
        forcing = interop.dynamics_forcing_from_numpy(forcing_np, device="cpu", dtype=torch.float64)
        phys = interop.forcing_from_numpy(phys_np, device="cpu", dtype=torch.float64)
        ref = to_jax_state(state_np)
        jphys = JaxForcing(**{k: jnp.asarray(v, dtype=jnp.float64) for k, v in phys_np.items()})
        for _ in range(2):
            got = port.step(got, phys, forcing, DT)
            ref = jmodel.step(ref, jphys, to_jax_forcing(forcing_np), dt=DT)
    finally:
        ModuleRegistry.get_loader().reset()
        modules.get_loader().reset()
    assert type(port.physics.thermo).__name__ == "ThermoWinton"
    assert type(jmodel.physics._thermo).__name__ == "ThermoWinton"
    got_np, ref_np = interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref)
    assert_states_close(got_np, ref_np)
    assert not np.allclose(ref_np["tice"][1:], state_np["tice"][1:])  # the interior layers moved


def test_coupled_model_takes_its_arguments_in_the_jax_order():
    """The same parameters in the same order, so that a positional call
    means the same in both packages (mevp_block_halo right after
    mevp_backend)."""
    import inspect

    port = list(inspect.signature(CoupledModel.__init__).parameters)
    ref = list(inspect.signature(JaxCoupledModel.__init__).parameters)
    assert port == ref
    assert port.index("mevp_block_halo") == port.index("mevp_backend") + 1
