"""The port's one-launch dynamics phase (``fused_dynamics``) on the CPU.

What can be held here: the kernel's tiling and what it holds, its CFL
count's arithmetic (a plain mirror against the port's host count and the
JAX package's ``cfl_substeps`` at float32), the schedule that takes it,
its plain path, and the slice against the JAX package's
``fused_dynamics_pallas`` in interpret mode (float64, 16 x 16 elements, 15
subcycles, k > 1, a coastline; 1e-8 of each plane's max, as the other
parity tests of the dynamics phase). The kernel itself runs on a card
only: its tests are the ``cuda``-marked ones in ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics.transport import QuadVelocity as JaxQuadVelocity
from nextsimdg_tpu.dynamics.transport import cfl_substeps as jax_cfl_substeps
from nextsimdg_tpu_torch import coupled, interop
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import fused_dynamics_cuda as fd
from nextsimdg_tpu_torch.dynamics.mesh import SphericalMesh
from nextsimdg_tpu_torch.dynamics.mevp import MEVPParams
from nextsimdg_tpu_torch.dynamics.transport import substeps_from_speeds
from nextsimdg_tpu_torch.modules import get_loader

from test_torch_coupled import (
    N, N_SUBCYCLES, DT, VELOCITY, assert_states_close, seeded_forcing,
    seeded_state, to_jax_forcing, to_jax_state,
)

torch.set_num_threads(1)

H100_SMS = 132
DX = 2000.0  # 2 km elements: the seeded velocity needs k > 1 substeps


# -- tiling and what the kernel holds -----------------------------------------
def test_the_headline_grid_is_held_on_132_sms():
    config = fd.tiling(256, 256, H100_SMS)
    assert config.tile == (16, 32) and config.tiles == (16, 8) and config.threads == 512
    assert config.resident == fd.HEADLINE.const_planes == 7  # the 7 consts in shared memory
    assert config.shared_bytes == (5 + 7 + 18 + 2) * 18 * 34 * 4 <= fd.SHARED_LIMIT - fd.STATIC_BYTES
    assert fd.holds(256, 256, H100_SMS) and fd.holds(256, 256, H100_SMS, masked=False)
    assert config.exchange_words == 128 * (5 * 48 + 36 * 48 + 2)


def test_a_grid_too_large_is_not_held():
    side = fd.largest_square(H100_SMS)
    assert 400 <= side < 1024
    assert fd.holds(side, side, H100_SMS) and not fd.holds(side + 1, side + 1, H100_SMS)
    assert fd.tiling(side, side, H100_SMS).resident == 0  # the consts from L2 there
    with pytest.raises(ValueError, match="does not fit"):
        fd.tiling(1024, 1024, H100_SMS)
    assert not fd.holds(256, 256, 16)  # too few SMs for the tiles


#: The forms beside the headline's: (Form, the largest square held on 132
#: SMs, with the coastline or without: the forms' instances always take the
#: masks' planes).
FORMS = {
    "periodic x": (fd.Form(periodic=(True, False)), 528),
    "periodic both": (fd.Form(periodic=(True, True)), 528),
    "A-weighted": (fd.Form(weighted=True), 528),
    "adaptive": (fd.Form(adaptive=True), 528),
    "dG0": (fd.Form(degree=0, stages=1), 728),
    "dG2": (fd.Form(degree=2, stages=3), 300),
    "TVB dG1": (fd.Form(tvb=True), 528),
    "TVB dG2": (fd.Form(degree=2, stages=3, tvb=True), 300),
    "every form": (fd.Form(degree=2, stages=3, tvb=True, adaptive=True, weighted=True, periodic=(True, True)), 288),
}


@pytest.mark.parametrize("name", list(FORMS))
def test_each_form_holds_the_headline_grid_and_its_largest_square(name):
    """At 256^2 on 132 SMs every form keeps the headline's tiles and its 8
    consts (a_node the eighth) resident; its shared bytes (the masks' planes
    with or without a coastline) and exchange words follow its tracer
    buffers (K coefficients x 3 tracers, two buffers, three for rk3); its
    largest square falls with the buffers (dG2 rk3: 300^2, its consts
    resident in shared memory; dG0: 728^2, by 8 cells a thread of 512; the
    headline's 528^2)."""
    form, largest = FORMS[name]
    config = fd.tiling(256, 256, H100_SMS, False, form)
    k = (1, 3, 6)[form.degree]
    buffers = 3 if form.stages == 3 else 2
    assert not form.headline and config.tile == (16, 32) and config.tiles == (16, 8)
    assert config.threads == (256 if form.degree == 2 else 512)
    assert config.resident == form.const_planes == 8
    assert config.shared_bytes == (5 + 8 + buffers * 3 * k + 2) * 18 * 34 * 4 <= fd.SHARED_LIMIT - fd.STATIC_BYTES
    assert config.exchange_words == 128 * (5 * 48 + 2 * 3 * k * 96 + 2)
    assert config.masked and config == fd.tiling(256, 256, H100_SMS, True, form)
    assert fd.largest_square(H100_SMS, True, form) == fd.largest_square(H100_SMS, False, form) == largest
    assert fd.holds(largest, largest, H100_SMS, False, form)
    if form.degree == 2:  # its consts always resident
        assert fd.tiling(largest, largest, H100_SMS, False, form).resident == 8


def test_a_periodic_axis_takes_only_tiles_that_divide_it():
    form = fd.Form(periodic=(True, True))
    config = fd.tiling(200, 136, H100_SMS, False, form)
    assert 200 % config.tile[0] == 0 and 136 % config.tile[1] == 0 and config.n_tiles <= H100_SMS
    closed = fd.tiling(200, 136, H100_SMS, False, fd.Form(weighted=True))
    assert 136 % closed.tile[1] != 0  # the closed form keeps its ragged tiles


def test_ragged_tiles():
    """200 x 136: the last column of tiles is ragged; every tile is at most
    one an SM, at most 8 cells a thread of at most 512."""
    nx, ny = 200, 136
    config = fd.tiling(nx, ny, H100_SMS)
    tr, tc = config.tile
    assert ny % tc != 0 and config.n_tiles <= H100_SMS
    assert config.tiles == (-(-nx // tr), -(-ny // tc))
    assert (config.tiles[0] - 1) * tr < nx and (config.tiles[1] - 1) * tc < ny
    rows = config.threads // tc
    assert config.threads <= fd.MAX_THREADS and config.threads % 32 == 0 and -(-tr // rows) <= fd.MAX_CELLS


# -- the CFL count ------------------------------------------------------------
@pytest.mark.parametrize("degree", [0, 1, 2])
@pytest.mark.parametrize("k_floor", [1, 3])
def test_the_kernel_k_arithmetic_matches_the_host_and_jax(k_floor, degree):
    """The plain mirror of the kernel's k (float32 operations, the Python
    scalars rounded first) equals the port's host count on float32 CPU
    tensors and JAX's ``cfl_substeps`` at float32, on speeds at the ceil's
    boundaries of each degree's c_stab = 0.85 / (2p + 1); float64 arithmetic
    would not (the sweep is that sharp)."""
    mesh, dt = RectMesh(256, 256, DX, DX), 600.0
    speeds = fd.ceil_boundary_speeds(dt, mesh, degree)
    mine = fd.substeps_plain(speeds[:, 0], speeds[:, 1], dt, mesh, degree, k_floor=k_floor)
    host = np.array([
        int(substeps_from_speeds(torch.tensor(sx), torch.tensor(sy), dt, mesh, degree, k_floor=k_floor))
        for sx, sy in speeds
    ])
    np.testing.assert_array_equal(mine, host)

    # Eager, as the source reads: under jit XLA rewrites the division by a
    # constant, and 4% of this sweep then lands on the other side of a ceil.
    jmesh = JaxRectMesh(nx=256, ny=256, dx=DX, dy=DX)
    zero = jnp.zeros(1, dtype=jnp.float32)
    jax_k = jax.vmap(lambda sx, sy: jax_cfl_substeps(
        JaxQuadVelocity(vx_vol=sx[None], vy_vol=sy[None], vn_x=zero, vn_y=zero), dt, jmesh, degree,
        k_floor=k_floor,
    ))(jnp.asarray(speeds[:, 0]), jnp.asarray(speeds[:, 1]))
    np.testing.assert_array_equal(mine, np.asarray(jax_k))

    nu = (speeds[:, 0].astype(np.float64) / DX + speeds[:, 1].astype(np.float64) / DX) * dt
    k64 = np.clip(np.maximum(np.ceil(nu / (0.85 / (2 * degree + 1))), k_floor), 1, fd.K_MAX)
    assert np.any(k64 != mine)
    assert mine.max() == fd.K_MAX and mine.min() == k_floor


def test_non_finite_speeds_give_the_floor_as_on_the_host():
    mesh = RectMesh(16, 16, DX, DX)
    for sx, sy in ((np.nan, 0.0), (np.inf, 0.0), (3e38, 3e38)):
        got = fd.substeps_plain(np.float32(sx), np.float32(sy), DT, mesh, k_floor=2)
        host = int(substeps_from_speeds(torch.tensor(sx, dtype=torch.float32), torch.tensor(sy, dtype=torch.float32),
                                        DT, mesh, 1, k_floor=2))
        assert int(got) == host


# -- the schedule ---------------------------------------------------------------
def card(monkeypatch, sms=H100_SMS):
    """Steps that ask a CUDA device see ``sms`` SMs (no card is touched)."""
    monkeypatch.setattr(coupled, "sm_count", lambda device: sms)


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_the_headline_takes_fused_on_a_card_that_holds_it(monkeypatch, backend):
    card(monkeypatch)
    model = CoupledModel(RectMesh(256, 256, DX, DX), mevp_backend=backend)
    assert model.schedule("cuda") == ("fused", "xla")
    assert model.mevp_schedule(H100_SMS) == "fused" and model.transport_schedule(H100_SMS) == "xla"
    masked = CoupledModel(RectMesh(256, 256, DX, DX), mevp_backend=backend,
                          ocean_mask=np.ones((256, 256)))
    assert masked.schedule("cuda") == ("fused", "xla")
    # Without a card to ask, every answer stays the split schedules'.
    expected = ("pallas", "xla") if backend == "pallas" else ("pallas-tiled", "tiled")
    assert model.schedule("cpu") == expected
    assert (model.mevp_schedule(), model.transport_schedule()) == expected


def test_fused_is_not_taken_where_the_grid_is_not_held(monkeypatch):
    card(monkeypatch)
    big = CoupledModel(RectMesh(1024, 1024, DX, DX), mevp_backend="pallas")
    assert big.schedule("cuda") == ("pallas", "xla")  # K1's split schedule
    assert CoupledModel(RectMesh(1024, 1024, DX, DX)).schedule("cuda") == ("pallas-tiled", "tiled")
    card(monkeypatch, 16)
    assert CoupledModel(RectMesh(256, 256, DX, DX)).schedule("cuda") == ("pallas-tiled", "tiled")


def test_auto_takes_fused_below_its_threshold(monkeypatch):
    card(monkeypatch)
    side = int(np.sqrt(coupled.FUSED_MAX_ELEMENTS - 1))
    for n in (64, min(side, fd.largest_square(H100_SMS))):
        assert CoupledModel(RectMesh(n, n, DX, DX)).schedule("cuda")[0] == "fused"
    assert CoupledModel(RectMesh(16, 16, DX, DX)).schedule("cuda")[0] == "fused"


def _graded_mesh():
    widths = np.linspace(1500.0, 2500.0, 256)
    return RectMesh(256, 256, widths, DX)


@pytest.mark.parametrize(
    "kwargs, expected",
    [
        (dict(mevp_params=MEVPParams(adaptive_alpha=True)), ("fused", "xla")),
        (dict(mevp_params=MEVPParams(a_weighted_stress=True)), ("fused", "xla")),
        (dict(degree=2), ("fused", "xla")),
        (dict(degree=0), ("fused", "xla")),
        (dict(tvb_m=0.0), ("fused", "xla")),
        (dict(periodic=True), ("fused", "xla")),
        (dict(mesh="graded"), ("single", "tiled")),
        (dict(mesh="spherical"), ("single", "tiled")),
        (dict(solver="Nextsim::MEVPHighOrder"), ("single", "tiled")),
        (dict(solver="Nextsim::FreeDrift"), ("free-drift", "tiled")),
    ],
)
def test_fused_is_not_taken_for_the_forms_it_lacks(monkeypatch, kwargs, expected):
    """Since the forms were built, the kernel lacks only what the TPU kernel
    lacks too: a graded or spherical mesh, the HO solver and free drift (and
    a rank grid); the six forms it refused before (adaptive, A-weighted,
    dG2, dG0, TVB, periodic) now take it on "pallas"."""
    card(monkeypatch)
    periodic = kwargs.pop("periodic", False)
    kind = kwargs.pop("mesh", "uniform")
    solver = kwargs.pop("solver", None)
    mesh = {
        "uniform": lambda: RectMesh(256, 256, DX, DX, periodic_x=periodic, periodic_y=periodic),
        "graded": _graded_mesh,
        "spherical": lambda: SphericalMesh(256, 256, -40.0, 40.0, 55.0, 85.0),
    }[kind]()
    loader = get_loader()
    try:
        if solver is not None:
            loader.set_implementation("Nextsim::IDynamics", solver)
        model = CoupledModel(mesh, mevp_backend="pallas", **kwargs)
    finally:
        loader.reset()
    taken = expected[0] == "fused"
    assert (fd.form_refusal(model) is None) == taken
    assert fd.holds_model(model, H100_SMS) == taken
    assert model.schedule("cuda") == expected


def test_the_other_solvers_and_meshes_keep_their_schedules(monkeypatch):
    card(monkeypatch)
    sphere = CoupledModel(SphericalMesh(256, 256, -40.0, 40.0, 55.0, 85.0), mevp_backend="pallas")
    assert sphere.schedule("cuda") == ("single", "tiled")
    rk3 = CoupledModel(RectMesh(256, 256, DX, DX), mevp_backend="pallas")
    rk3.transport.scheme = "rk3"  # any scheme at any degree: its stages at run time
    assert rk3.schedule("cuda") == ("fused", "xla")
    assert fd.form_of(rk3) == fd.Form(stages=3)
    loader = get_loader()
    try:
        for solver, expected in (("Nextsim::FreeDrift", "free-drift"), ("Nextsim::MEVPHighOrder", "single")):
            loader.set_implementation("Nextsim::IDynamics", solver)
            model = CoupledModel(RectMesh(256, 256, DX, DX), mevp_backend="pallas")
            assert fd.form_refusal(model) is not None
            assert model.schedule("cuda")[0] == expected
    finally:
        loader.reset()


def test_an_explicit_request_the_kernel_does_not_hold_raises():
    """On any device: the wrapper refuses a form it lacks (and ``tiling`` a
    grid it cannot hold, above)."""
    model = CoupledModel(SphericalMesh(N, N, -40.0, 40.0, 55.0, 85.0), n_subcycles=2)
    _, consts, carry, tracers = phase_inputs(model)
    with pytest.raises(ValueError, match="graded or spherical mesh"):
        fd.fused_dynamics_single(model, carry, tracers, consts, DT, 2)


# -- the plain path --------------------------------------------------------------
def phase_inputs(model, seed=0, speed=0.5):
    """(state, consts, carry, tracers) of a seeded float64 state."""
    state = interop.coupled_state_from_numpy(seeded_state(seed, speed), device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(seeded_forcing(), device="cpu", dtype=torch.float64)
    mask = model.node_mask(device="cpu", dtype=torch.float64)
    consts = model.mevp.step_consts(
        state.velocity, state.hice[0], torch.clamp(state.cice[0], 0.0, 1.0), forcing, mask, DT
    )
    carry = tuple(getattr(state.velocity, k) for k in VELOCITY)
    tracers = torch.stack([state.hice, state.cice, state.hsnow], dim=1)
    return state, consts, carry, tracers


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("auto", [True, False])
def test_the_fused_phase_on_the_cpu_is_the_plain_version(masked, auto):
    ocean = None
    if masked:
        ocean = np.ones((N, N))
        ocean[5:9, 6:11] = 0.0
    model = CoupledModel(RectMesh(N, N, DX, DX), n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
                         auto_substeps=auto, transport_substeps=1 if auto else 3)
    _, consts, carry, tracers = phase_inputs(model)
    faces = model.face_masks(device="cpu", dtype=torch.float64)
    cc.reset_launches()
    got = cc.dynamics_phase(model, carry, tracers, consts, DT, N_SUBCYCLES, faces, mevp="fused", transport="xla")
    ref = cc.fused_dynamics_reference(model, carry, tracers, consts, DT, N_SUBCYCLES, faces)
    for g, r in zip((*got[0], got[1]), (*ref[0], ref[1])):
        assert torch.equal(g, r)
    single = fd.fused_dynamics_single(model, carry, tracers, consts, DT, N_SUBCYCLES, faces)
    assert torch.equal(single[1], ref[1])
    assert all(count == 0 for count in cc.launches.values())
    speed_x, speed_y, k = single[2].tolist()
    assert k == (fd.substeps_plain(speed_x, speed_y, DT, model.mesh) if auto else 3)
    assert k > 1


# -- the slice against the JAX package ------------------------------------------
def test_the_fused_slice_matches_the_jax_fused_kernel(monkeypatch):
    """``CoupledModel.step`` on a model whose schedule on an H100 is
    "fused" (the plain path here) against the JAX model on
    ``"pallas-interpret"``, which runs ``fused_dynamics_pallas``: float64,
    16^2, 15 subcycles, k > 1, a coastline; two steps."""
    card(monkeypatch)
    ocean = np.ones((N, N))
    ocean[4:8, 9:13] = 0.0
    ocean[12:, :3] = 0.0
    port = CoupledModel(RectMesh(N, N, DX, DX), degree=1, n_subcycles=N_SUBCYCLES, ocean_mask=ocean)
    assert port.schedule("cuda") == ("fused", "xla")
    jmodel = JaxCoupledModel(
        JaxRectMesh(nx=N, ny=N, dx=DX, dy=DX), degree=1, n_subcycles=N_SUBCYCLES,
        mevp_backend="pallas-interpret", ocean_mask=ocean,
    )
    assert jmodel._fused_dynamics_mode() == "interpret"
    state_np, forcing_np = seeded_state(speed=0.5), seeded_forcing()
    got = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(forcing_np, device="cpu", dtype=torch.float64)
    ref, jforcing = to_jax_state(state_np), to_jax_forcing(forcing_np)
    ks = []
    for _ in range(2):
        consts = port.mevp.step_consts(
            got.velocity, got.hice[0], torch.clamp(got.cice[0], 0.0, 1.0), forcing,
            port.node_mask(device="cpu", dtype=torch.float64), DT,
        )
        carry = tuple(getattr(got.velocity, k) for k in VELOCITY)
        tracers = torch.stack([got.hice, got.cice, got.hsnow], dim=1)
        faces = port.face_masks(device="cpu", dtype=torch.float64)
        ks.append(fd.fused_dynamics_single(port, carry, tracers, consts, DT, N_SUBCYCLES, faces)[2][2].item())
        got = port.step(got, None, forcing, DT, do_thermo=False)
        ref = jmodel.step(ref, None, jforcing, dt=DT, do_thermo=False)
    assert min(ks) > 1
    assert_states_close(interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref))
