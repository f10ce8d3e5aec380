"""The CUDA kernels of the dynamics phase against their plain versions.

K1's four kernels, the ghost-zone tiled ``mevp_tiled`` and
``transport_tiled``, and the single-launch ``mevp_single``, which must also
equal K1's schedule on the same inputs (they run the same element bodies;
expected 0, failure above 1e-6 of the plane's max), on uniform meshes and
on a spherical one with its metric planes and a coastline. The HO kernels
``ho_single`` and ``ho_tiled`` (in cluster shapes of 1 to 16 blocks)
against their plain version and
each other (the same bodies: expected 0), and the ``qv`` form of ``transport_tiled``
that advects with the CG2 velocity's quadrature samples. On a 2 x 2 rank
grid of 200 x 136 blocks on one card, K7's ``rdma_stage`` and ``rdma_band``
against their plain versions launch by launch (``rdma_band`` also in
one-block tiles and in clusters of 2 to 16 blocks), the rdma round against the
blocked one and the single-device ``mevp_tiled`` (bit for bit: the same
bodies on the same values), and the decomposed coupled step against the
single-device step (expected 0) and the decomposed plain step. The
ceiling probe's ``chain`` kernel against its plain version for every link
and both unrolls, at 512^2 and a ragged shape.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
elsewhere. On a machine with one, run them with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``
(``tests/conftest.py`` imports jax, which the port does not need).
Tolerances (float32): 1e-5 of the plane's max |value| for one launch
(the kernels run the plain version's operations in its order; the margin
covers an ulp where PyTorch's own kernels round differently); exact for
the CFL speeds and k; after 100 subcycles 1e-3 of the plane's max on the
mEVP planes and 1e-5 on the tracers.
"""

import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.benchmarks import roofline
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, synthetic_coastline
from nextsimdg_tpu_torch import modules
from nextsimdg_tpu_torch.dynamics import mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import ho_single_cuda as hs
from nextsimdg_tpu_torch.dynamics.kernels import ho_tiled_cuda as ht
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.kernels import mevp_single_cuda as ms
from nextsimdg_tpu_torch.dynamics.kernels import mevp_tiled_cuda as mt
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from nextsimdg_tpu_torch.dynamics.transport import substeps_from_speeds
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model, run_ranks
from nextsimdg_tpu_torch.state import Forcing

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

N = 64
DT = 600.0
TOL_LAUNCH = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def assert_close(got, ref, tol):
    got, ref = got.double(), ref.double()
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol * scale


def setup(device, n=N, n_subcycles=100, ny=None, spherical=False):
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (n, n if ny is None else ny)
    if spherical:  # a pan-Arctic window with a coastline: metric consts, land
        mesh = SphericalMesh(*shape, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)
        model = CoupledModel(mesh, n_subcycles=n_subcycles, ocean_mask=synthetic_coastline(*shape))
    else:
        model = CoupledModel(RectMesh(*shape, 2000.0, 2000.0), n_subcycles=n_subcycles)
    carry = tuple(t(rng.normal(0.0, s, shape)) for s in (0.2, 0.2, 1e3, 1e3, 1e3))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(8.0, 2.0, shape)), v_atm=t(rng.normal(2.0, 2.0, shape)),
        u_ocean=t(rng.normal(0.0, 0.05, shape)), v_ocean=t(rng.normal(0.0, 0.05, shape)),
    )
    h, a = t(rng.uniform(0.2, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), h, a, forcing, mask, DT)
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (2, 3, *shape))]))
    return model, carry, consts, psi, rng


def test_mevp_kernels_match_plain(device):
    model, carry, consts, _, _ = setup(device)
    ref = model.mevp.stress_update(carry, consts)
    got = cc.mevp_stress(model.mevp, carry, consts)
    for g, r in zip(got, ref):
        assert_close(g, r, TOL_LAUNCH)
    carry_v = (carry[0], carry[1], *ref[:3])
    ref_uv = model.mevp.velocity_update(carry_v, consts, ref[3], ref[4], DT)
    got_uv = cc.mevp_velocity(model.mevp, carry_v, consts, ref[3], ref[4], DT)
    for g, r in zip(got_uv, ref_uv):
        assert_close(g, r, TOL_LAUNCH)
    # The wrappers work on copies: the inputs are untouched.
    assert torch.equal(carry[2], setup(device)[1][2])


@pytest.mark.parametrize("speed", [0.2, 5.0])
def test_dg1_sample_cfl_gives_equal_speeds_and_k(device, speed):
    model, carry, _, _, _ = setup(device)
    u, v = carry[0] * speed, carry[1] * speed
    got = cc.dg1_sample_cfl(model.transport, u, v)
    ref = cc.dg1_sample_cfl_reference(model.transport, u, v)
    assert torch.equal(got, ref)
    k = lambda s: int(substeps_from_speeds(s[0], s[1], DT, model.mesh, 1))
    assert k(got) == k(ref)


@pytest.mark.parametrize("a, b", [(0.0, 1.0), (0.5, 0.5), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0)])
def test_dg1_rk_stage_matches_plain(device, a, b):
    model, carry, _, psi, rng = setup(device)
    base = psi.flip(-1).contiguous()
    face_x, face_y = (
        torch.tensor((rng.uniform(size=(N, N)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    args = (model.transport, psi, base, carry[0], carry[1], face_x, face_y, a, b, 300.0)
    assert_close(cc.dg1_rk_stage(*args), cc.dg1_rk_stage_reference(*args), TOL_LAUNCH)


@pytest.mark.parametrize("scheme", ["rk1", "rk2", "rk3"])
def test_fused_dynamics_matches_plain_and_counts_launches(device, scheme):
    model, carry, consts, psi, _ = setup(device)
    model.transport.scheme = scheme
    cc.reset_launches()
    got_carry, got_tr = cc.fused_dynamics(model, carry, psi, consts, DT, 100)
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100)
    for g, r in zip(got_carry, ref_carry):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    stages = {"rk1": 1, "rk2": 2, "rk3": 3}[scheme]
    assert counts["mevp_stress"] == counts["mevp_velocity"] == 100
    assert counts["dg1_sample_cfl"] == 1
    assert counts["dg1_rk_stage"] % stages == 0 and counts["dg1_rk_stage"] >= stages


def test_wrappers_raise_on_what_the_kernels_do_not_take(device):
    model, carry, consts, psi, _ = setup(device)
    with pytest.raises(TypeError, match="float32"):
        cc.mevp_stress(model.mevp, tuple(c.double() for c in carry), consts)
    with pytest.raises(ValueError, match="contiguous"):
        cc.dg1_sample_cfl(model.transport, carry[0].t(), carry[1])
    with pytest.raises(ValueError, match="shape"):
        cc.dg1_sample_cfl(model.transport, carry[0][:-1], carry[1][:-1])
    with pytest.raises(ValueError, match="alias"):
        cc._dg1_rk_stage_(
            psi, psi, carry[0], carry[1], carry[0], carry[0], None, psi, 0.0, 1.0, 1.0,
            cc._dg1_tables(model.transport), cc._stream(device),
        )


def assert_same_schedule(got, ref):
    got, ref = got.double(), ref.double()
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("tile, halo, threads", [
    (64, 8, 1024), (16, 4, 256), (8, 3, 512),
    mt.SMALL, mt.LARGE,  # the shipped configurations: windows 80 wide, and 64 wide two blocks an SM
    (48, 8, 512), (60, 2, 1024), (30, 5, 200),
])
def test_mevp_tiled_matches_plain_and_k1_on_a_ragged_grid(device, tile, halo, threads, spherical):
    model, carry, consts, _, _ = setup(device, n=100, ny=136, n_subcycles=11, spherical=spherical)
    cc.reset_launches()
    got = mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, 11, tile, halo, threads)
    assert cc.launches["mevp_tiled"] == -(-11 // halo)
    ref = mt.mevp_subcycles_tiled_reference(model.mevp, carry, consts, DT, 11)
    k1 = cc.mevp_subcycles(model.mevp, carry, consts, DT, 11)
    for g, r, q in zip(got, ref, k1):
        assert_close(g, r, 1e-3)
        assert_same_schedule(g, q)
    # inputs untouched
    assert torch.equal(carry[2], setup(device, n=100, ny=136, spherical=spherical)[1][2])
    if threads <= 512 and 2 * (mt.shared_bytes(tile, halo) + 1024) <= 233472:
        assert mt.max_blocks(device, tile, halo, threads, spherical) >= 2


@pytest.mark.parametrize("scheme, k", [("rk2", 1), ("rk2", 4), ("rk1", 3)])
def test_transport_tiled_matches_plain_and_k1_on_a_ragged_grid(device, scheme, k):
    model, carry, _, psi, rng = setup(device, n=40, ny=72)
    model.transport.scheme = scheme
    faces = tuple(
        torch.tensor((rng.uniform(size=(40, 72)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    args = (model.transport, psi, carry[0], carry[1], DT / k, k, faces)
    cc.reset_launches()
    got = tt.transport_substeps_tiled(*args, tile=16)
    assert cc.launches["transport_tiled"] == -(-k // tt.K_MAX)
    assert_close(got, tt.transport_substeps_tiled_reference(*args), 1e-5)
    assert_same_schedule(got, cc.transport_substeps(*args))


def test_tiled_dynamics_phase_matches_plain_and_counts_launches(device):
    model, carry, consts, psi, _ = setup(device, n=40, ny=72)
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(
        model, carry, psi, consts, DT, 100, mevp="pallas-tiled", transport="tiled"
    )
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100)
    for g, r in zip(got_carry, ref_carry):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert counts["mevp_tiled"] == 13 and counts["dg1_sample_cfl"] == 1
    assert counts["transport_tiled"] >= 1
    assert counts["mevp_stress"] == counts["dg1_rk_stage"] == 0


def test_tiled_wrappers_raise_on_what_the_kernels_do_not_take(device):
    model, carry, consts, psi, _ = setup(device)
    model.transport.scheme = "rk3"
    with pytest.raises(NotImplementedError, match="rk3"):
        tt.transport_substeps_tiled(model.transport, psi, carry[0], carry[1], DT, 1)
    model.transport.scheme = "rk2"
    with pytest.raises(RuntimeError, match="CUDA error"):  # more shared memory than a block has
        mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, 8, tile=256, halo=8)
    with pytest.raises(TypeError, match="float32"):
        mt.mevp_subcycles_tiled(model.mevp, tuple(c.double() for c in carry), consts, DT, 8)


@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("n_sub", [1, 13])
def test_mevp_single_matches_plain_k1_and_tiled(device, spherical, n_sub):
    model, carry, consts, _, _ = setup(device, n=40, ny=72, spherical=spherical)
    assert len(consts) == (12 if spherical else 7)
    cc.reset_launches()
    got = ms.mevp_subcycles_single(model.mevp, carry, consts, DT, n_sub)
    assert cc.launches["mevp_single"] == 1
    ref = ms.mevp_single_reference(model.mevp, carry, consts, DT, n_sub)
    k1 = cc.mevp_subcycles(model.mevp, carry, consts, DT, n_sub)
    tiled = mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, n_sub)
    for g, r, q, w in zip(got, ref, k1, tiled):
        assert_close(g, r, TOL_LAUNCH if n_sub == 1 else 1e-3)
        assert_same_schedule(g, q)
        assert_same_schedule(g, w)
    assert torch.equal(carry[2], setup(device, n=40, ny=72, spherical=spherical)[1][2])


def test_mevp_single_refuses_a_grid_that_cannot_be_resident(device):
    model, carry, consts, _, _ = setup(device)
    limit = ms.max_blocks(False, device)
    assert limit >= 132
    got = ms.mevp_subcycles_single(model.mevp, carry, consts, DT, 3, blocks=7)
    assert_same_schedule(got[0], ms.mevp_subcycles_single(model.mevp, carry, consts, DT, 3)[0])
    with pytest.raises(RuntimeError, match="CUDA error"):
        ms.mevp_subcycles_single(model.mevp, carry, consts, DT, 3, blocks=limit + 1)
    with pytest.raises(NotImplementedError, match="consts"):
        ms.mevp_subcycles_single(model.mevp, carry, {**consts, "a_node": carry[0]}, DT, 3)


@pytest.mark.parametrize("k", [1, 4])
def test_metric_transport_kernels_match_plain_and_each_other(device, k):
    model, carry, _, psi, _ = setup(device, n=40, ny=72, spherical=True)
    faces = model.face_masks(device=device, dtype=torch.float32)
    u, v = carry[0] * 5.0, carry[1] * 5.0
    args = (model.transport, psi, u, v, DT / k, k, faces)
    got = tt.transport_substeps_tiled(*args, tile=16)
    assert_close(got, tt.transport_substeps_tiled_reference(*args), 1e-5)
    assert_same_schedule(got, cc.transport_substeps(*args))
    base = psi.flip(-1).contiguous()
    stage = (model.transport, psi, base, u, v, *faces, 0.5, 0.5, DT / k)
    assert_close(cc.dg1_rk_stage(*stage), cc.dg1_rk_stage_reference(*stage), TOL_LAUNCH)


def test_spherical_dynamics_phase_matches_plain_and_counts_launches(device):
    model, carry, consts, psi, _ = setup(device, n=40, ny=72, spherical=True)
    faces = model.face_masks(device=device, dtype=torch.float32)
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(
        model, carry, psi, consts, DT, 100, faces, mevp="single", transport="tiled"
    )
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100, faces)
    for g, r in zip(got_carry, ref_carry):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert counts["mevp_single"] == 1 and counts["dg1_sample_cfl"] == 1
    assert counts["transport_tiled"] >= 1 and counts["mevp_stress"] == 0


def ho_setup(device, nx=40, ny=72, seed=0):
    """An HO solver and seeded carry and consts (some nodes without ice)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (nx, ny)
    solver = mevp_ho.MEVPSolverHO(RectMesh(nx, ny, 4e3, 4e3))
    field = lambda s, m=0.0: mevp_ho.HOField(*(t(m + rng.normal(0.0, s, shape)) for _ in range(4)))
    state = mevp_ho.HOVelocityState(
        u=field(0.2), v=field(0.2), s11=t(rng.normal(0.0, 1e3, (3, *shape))),
        s22=t(rng.normal(0.0, 1e3, (3, *shape))), s12=t(rng.normal(0.0, 5e2, (3, *shape))),
    )
    forcing = mevp_ho.HODynamicsForcing(field(2.0, 8.0), field(2.0, 2.0), field(0.05), field(0.05))
    h = t(rng.uniform(0.0, 2.0, shape))
    a = t(rng.uniform(0.3, 1.0, shape))
    mask = solver.boundary_mask(device=device, dtype=torch.float32)
    consts = solver.step_consts(state, h, a, forcing, mask, DT)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    return solver, carry, consts


def ho_planes(carry):
    return [*carry[0].planes(), *carry[1].planes(), *carry[2:]]


@pytest.mark.parametrize("n_sub", [1, 13])
@pytest.mark.parametrize("config", [
    ht.SHIPPED, ht.CLUSTER_2X2,  # the shipped window a block, and 2 x 2 clusters
    ht.LaunchConfig(1, 2, 48, 8, 512),
    ht.LaunchConfig(2, 2, 16, 4, 256), ht.LaunchConfig(2, 2, 16, 4, 32),  # 32 threads: many cells each
    ht.LaunchConfig(4, 4, 8, 3, 128),  # 16 blocks a cluster: the non-portable size
    ht.LaunchConfig(2, 4, 12, 2, 128), ht.LaunchConfig(3, 1, 20, 5, 256),
], ids=str)
def test_ho_kernels_match_plain_and_each_other(device, n_sub, config):
    solver, carry, consts = ho_setup(device)
    cc.reset_launches()
    single = hs.ho_subcycles_single(solver, carry, consts, DT, n_sub)
    tiled = ht.ho_subcycles_tiled(solver, carry, consts, DT, n_sub, config)
    assert cc.launches["ho_single"] == 1 and cc.launches["ho_tiled"] == -(-n_sub // config.halo)
    ref = hs.ho_single_reference(solver, carry, consts, DT, n_sub)
    for g, w, r in zip(ho_planes(single), ho_planes(tiled), ho_planes(ref)):
        assert_close(g, r, TOL_LAUNCH if n_sub == 1 else 1e-3)
        assert_same_schedule(g, w)
    again = ho_setup(device)[1]
    assert all(torch.equal(x, y) for x, y in zip(ho_planes(carry), ho_planes(again)))


def test_ho_kernels_raise_on_what_they_do_not_take(device):
    solver, carry, consts = ho_setup(device)
    with pytest.raises(NotImplementedError, match="consts"):
        hs.ho_subcycles_single(solver, carry, {**consts, "a_v": consts["active_v"]}, DT, 3)
    with pytest.raises(RuntimeError, match="CUDA error"):  # more shared memory than a block has
        ht.ho_subcycles_tiled(solver, carry, consts, DT, 4, ht.LaunchConfig(1, 1, 64, 8, 512))
    with pytest.raises(ValueError, match="launch configuration"):  # more blocks than a cluster has
        ht.ho_subcycles_tiled(solver, carry, consts, DT, 4, ht.LaunchConfig(4, 8, 16, 4, 256))
    assert ht.max_clusters(device, ht.SHIPPED) >= 1
    with pytest.raises(RuntimeError, match="CUDA error"):
        hs.ho_subcycles_single(solver, carry, consts, DT, 2, blocks=hs.max_blocks(device) + 1)
    double = tuple(carry[:2]) + tuple(x.double() for x in carry[2:])
    with pytest.raises(TypeError, match="float32"):
        ht.ho_subcycles_tiled(solver, double, consts, DT, 3)


@pytest.mark.parametrize("k", [1, 4])
def test_transport_tiled_qv_form_matches_plain(device, k):
    solver, carry, _ = ho_setup(device)
    model, _, _, psi, rng = setup(device, n=40, ny=72)
    faces = tuple(
        torch.tensor((rng.uniform(size=(40, 72)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    scaled = tuple(mevp_ho.HOField(*(5.0 * x for x in f.planes())) for f in carry[:2])
    qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, *scaled)
    args = (model.transport, psi, None, None, DT / k, k, faces)
    cc.reset_launches()
    got = tt.transport_substeps_tiled(*args, tile=16, qv=qv)
    assert cc.launches["transport_tiled"] == -(-k // tt.K_MAX)
    assert_close(got, tt.transport_substeps_tiled_reference(*args, qv=qv), 1e-5)


def test_ho_dynamics_phase_matches_plain_and_counts_launches(device):
    modules.get_loader().set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        model = CoupledModel(RectMesh(40, 72, 4e3, 4e3), n_subcycles=20, mevp_backend="pallas-tiled")
    finally:
        modules.get_loader().reset()
    _, carry, _ = ho_setup(device)
    psi = setup(device, n=40, ny=72)[3]
    state = mevp_ho.HOVelocityState(*carry)
    consts = model.mevp.step_consts(
        state, psi[0, 0], psi[0, 1].clamp(0.0, 1.0), mevp_ho.HODynamicsForcing(*(carry[0],) * 4),
        model.node_mask(device=device, dtype=torch.float32), DT,
    )
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 20, mevp="tiled", transport="tiled")
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 20)
    for g, r in zip(ho_planes(got_carry), ho_planes(ref_carry)):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert counts["ho_tiled"] == -(-20 // ht.launch_config(40, 72).halo) and counts["transport_tiled"] >= 1
    assert counts["dg1_sample_cfl"] == counts["mevp_tiled"] == 0
    with pytest.raises(NotImplementedError, match="transport_tiled"):
        cc.dynamics_phase(model, carry, psi, consts, DT, 2, mevp="tiled", transport="xla")


# -- K7 and the decomposed step on a 2 x 2 rank grid of one card ------------------
RANKS = (2, 2)
LOCAL = (200, 136)  # per rank: a multiple of no tile
GLOBAL = (RANKS[0] * LOCAL[0], RANKS[1] * LOCAL[1])
VELOCITY = ("u", "v", "s11", "s22", "s12")


def rank_grid_inputs(device, seed=0):
    """Seeded global mEVP planes, forcing, h and a on the card."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    planes = {k: t(rng.normal(0.0, s, GLOBAL)) for k, s in zip(VELOCITY, (0.2, 0.2, 1e3, 1e3, 1e3))}
    for k, (m, s) in {"u_atm": (8.0, 2.0), "v_atm": (2.0, 2.0), "u_ocean": (0.0, 0.05), "v_ocean": (0.0, 0.05)}.items():
        planes[k] = t(rng.normal(m, s, GLOBAL))
    planes["h"], planes["a"] = t(rng.uniform(0.2, 2.0, GLOBAL)), t(rng.uniform(0.3, 1.0, GLOBAL))
    return planes


def on_rank_grid(device, backend, fn, h=8, seed=0):
    """``fn(rank, solver, carry, consts)`` on every rank of a 2 x 2 grid on
    ``device`` (its solver on ``backend``, its block of the seeded inputs and
    its step consts); returns (grid, results in rank order)."""
    grid = RankGrid(*RANKS, device, timeout=120)
    parts = {k: grid.split(x) for k, x in rank_grid_inputs(device, seed).items()}
    mesh = RectMesh(*LOCAL, 2000.0, 2000.0)

    def body(rank):
        r = rank.rank
        solver = MEVPSolver(mesh, MEVPParams(), backend=backend, spmd=rank.axes, block_halo=h)
        carry = tuple(parts[k][r] for k in VELOCITY)
        forcing = DynamicsForcing(*(parts[k][r] for k in ("u_atm", "v_atm", "u_ocean", "v_ocean")))
        mask = solver.boundary_mask(device=device, dtype=torch.float32)
        consts = solver.step_consts(VelocityState(*carry), parts["h"][r], parts["a"][r], forcing, mask, DT)
        return fn(rank, solver, carry, consts)

    return grid, run_ranks(grid.ring, body)


@pytest.mark.parametrize("n_sub", [1, 8])
def test_rdma_kernels_match_plain_launch_by_launch(device, n_sub):
    h = 8

    def round_checked(rank, solver, carry, consts):
        axes, consts_w = solver.rdma_round_inputs(consts)
        checked = []

        def stage(src, axis):
            got = rdma.rdma_stage(src, axis)
            checked.append(("rdma_stage", got, rdma.rdma_stage_reference(src, axis)))
            return got

        def band(local, src, axis, consts_w, dt, n, state):
            ref = rdma.rdma_band_reference(local, src, axis, consts_w, dt, n, [x.clone() for x in state])
            got = rdma.rdma_band(local, src, axis, consts_w, dt, n, [x.clone() for x in state])
            checked.extend(("rdma_band", g, r) for g, r in zip(got, ref))
            return got

        out = rdma._round(
            solver.local(), carry, consts, consts_w, DT, n_sub, h, axes, stage, band,
            mt.mevp_subcycles_tiled,
        )
        return checked, out

    cc.reset_launches()
    _, results = on_rank_grid(device, "rdma", round_checked, h=h)
    torch.cuda.synchronize()
    assert cc.launches["rdma_stage"] == 2 * 4 and cc.launches["rdma_band"] == 2 * 4
    for checked, _ in results:
        assert [name for name, _, _ in checked].count("rdma_band") == 2 * 5
        for name, got, ref in checked:
            assert_close(got, ref, TOL_LAUNCH)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("config", [
    rdma.BandConfig(1, 40, 256), rdma.BandConfig(2, 16, 128), rdma.BandConfig(16, 8, 128),
    rdma.BandConfig(1, 64, 1024), rdma.launch_config(0), rdma.launch_config(1),
], ids=str)
def test_rdma_band_launch_configurations_match_plain(device, axis, config):
    """rdma_band on the cone, in one-block tiles and in clusters of 2 to 16
    blocks along the band, under either launch bound (256 and 1024
    threads), against its plain version on the whole bands."""
    h, n_sub = 8, 7

    def band(rank, solver, carry, consts):
        axes, consts_w = solver.rdma_round_inputs(consts)
        ghosts = [torch.full((5, h, carry[0].shape[1]), 0.5, device=device) for _ in range(2)]
        wide = [torch.full((5, carry[0].shape[0] + 2 * h, h), -0.25, device=device) for _ in range(2)]
        src = rdma.RoundSources(own=tuple(carry), h=h, split=(True, True), gx=tuple(ghosts), gy=tuple(wide))
        state = [torch.zeros_like(c) for c in carry]
        ref = rdma.rdma_band_reference(solver.local(), src, axis, consts_w, DT, n_sub, [x.clone() for x in state])
        got = rdma.rdma_band(solver.local(), src, axis, consts_w, DT, n_sub, [x.clone() for x in state], config)
        return got, ref

    cc.reset_launches()
    _, results = on_rank_grid(device, "rdma", band, h=h)
    torch.cuda.synchronize()
    assert cc.launches["rdma_band"] == 4
    for got, ref in results:
        for g, r in zip(got, ref):
            assert_close(g, r, TOL_LAUNCH)


@pytest.mark.parametrize("h, n_subcycles", [(4, 11), (8, 100), (16, 37)])
def test_rdma_round_equals_blocked_and_single_device(device, h, n_subcycles):
    run = lambda rank, solver, carry, consts: solver.spmd_subcycles(carry, consts, DT, n_subcycles)
    cc.reset_launches()
    grid, rdma_out = on_rank_grid(device, "rdma", run, h=h)
    rdma_counts = dict(cc.launches)
    _, blocked_out = on_rank_grid(device, "blocked", run, h=h)
    assert rdma_counts["rdma_stage"] == rdma_counts["rdma_band"] == 2 * 4 * -(-n_subcycles // h)
    # The single-device schedule on the global grid.
    g = rank_grid_inputs(device)
    model = CoupledModel(RectMesh(*GLOBAL, 2000.0, 2000.0), n_subcycles=n_subcycles)
    carry = tuple(g[k] for k in VELOCITY)
    forcing = DynamicsForcing(g["u_atm"], g["v_atm"], g["u_ocean"], g["v_ocean"])
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), g["h"], g["a"], forcing, mask, DT)
    single = mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, n_subcycles)
    for p in range(5):
        got = grid.gather([planes[p] for planes in rdma_out])
        assert torch.equal(got, grid.gather([planes[p] for planes in blocked_out]))
        assert_same_schedule(got, single[p])


def coupled_inputs(device, mesh):
    n = mesh.nx, mesh.ny
    full = lambda value: torch.full(n, value, device=device, dtype=torch.float32)
    phys = Forcing(
        tair=full(-15.0), dew2m=full(-17.0), pair=full(1e5), sw_in=full(5.0),
        lw_in=full(240.0), mld=full(10.0), snowfall=full(1e-4), wind=full(6.0),
    )
    dyn = DynamicsForcing(u_atm=full(6.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0))
    return phys, dyn


def state_leaves(state):
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        yield name, getattr(state, name)
    for name in VELOCITY:
        yield name, getattr(state.velocity, name)


@pytest.mark.parametrize("backend", ["auto", "rdma"])
@pytest.mark.parametrize("coast", [False, True])
def test_decomposed_step_equals_single_device_and_matches_plain(device, backend, coast):
    mesh = RectMesh(*GLOBAL, 4e3, 4e3)
    ocean = synthetic_coastline(*GLOBAL) if coast else None
    single = CoupledModel(mesh, n_subcycles=20, ocean_mask=ocean)
    state = single.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    phys, dyn = coupled_inputs(device, mesh)
    grid = RankGrid(*RANKS, device, timeout=120)
    model, step = build_sharded_coupled_model(
        mesh, grid, n_subcycles=20, ocean_mask=ocean, mevp_backend=backend, mevp_block_halo=8,
    )
    assert (model.mevp_schedule(), model.transport_schedule()) == (
        "rdma" if backend == "rdma" else "blocked", "tiled"
    )
    cc.reset_launches()
    got = step(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    expected = single.step(state, phys, dyn, DT)
    # The plain path on every rank: plain subcycles and transport with
    # width-1 exchanges (the "xla" schedules, which take the plain phase).
    blocks = [grid.split_tree(x) for x in (state, phys, dyn)]

    def plain_rank(rank):
        m, (s, p, d) = step.models[rank.rank], (b[rank.rank] for b in blocks)
        return m.step_thermo(m.step_dynamics(s, d, DT, phase=cc.fused_dynamics_reference), p, DT)

    plain = grid.gather_tree(run_ranks(grid.ring, plain_rank), device)
    for (name, g), (_, e), (_, p) in zip(state_leaves(got), state_leaves(expected), state_leaves(plain)):
        assert_same_schedule(g, e)
        assert_close(g, p, 1e-3 if name in VELOCITY else 1e-5)
    assert counts["mevp_tiled"] > 0 and counts["transport_tiled"] > 0
    assert counts["dg1_sample_cfl"] == 4
    if backend == "rdma":
        assert counts["rdma_stage"] > 0 and counts["rdma_band"] > 0


def test_rdma_wrappers_raise_on_what_the_kernels_do_not_take(device):
    def bad_calls(rank, solver, carry, consts):
        axes, consts_w = solver.rdma_round_inputs(consts)
        src = rdma.RoundSources(own=tuple(carry), h=8, split=(True, True))
        errors = []
        for call in (
            lambda: rdma.rdma_stage(src, 1),  # the x ghosts have not arrived
            lambda: rdma.rdma_band(solver.local(), src, 0, consts_w, DT, 9, list(carry)),
            lambda: rdma.mevp_round_rdma(solver.local(), carry, consts, consts_w, DT, 9, 8, axes),
            lambda: rdma.rdma_stage(rdma.RoundSources(tuple(c.double() for c in carry), 8, (True, True)), 0),
        ):
            try:
                call()
            except (ValueError, TypeError) as exc:
                errors.append(type(exc))
        return errors

    _, results = on_rank_grid(device, "rdma", bad_calls)
    assert all(errors == [ValueError, ValueError, ValueError, TypeError] for errors in results)


@pytest.mark.parametrize("shape", [(512, 512), (1000, 968)])
@pytest.mark.parametrize("unroll, iters", [(16, 10), (64, 2)])
@pytest.mark.parametrize("link", roofline.LINKS)
def test_chain_matches_plain(device, shape, unroll, iters, link):
    """mul_add, div, sqrt and the shifts round each operation as PyTorch's
    CUDA kernels do: expected 0, failure above 1e-6 of the plane's max. fma
    and fma_imm round once per link: within 2 L 2^-24 of the plane's max of
    the float64 chain over L links (the chain contracts, |a| < 1)."""
    rng = np.random.default_rng(3)
    t = lambda x: torch.tensor(x, device=device, dtype=torch.float32)
    a, b = t(rng.uniform(0.5, 0.9999, shape)), t(rng.uniform(-1e-3, 1e-3, shape))
    cc.reset_launches()
    got = roofline.chain(a, b, link, iters, unroll)
    torch.cuda.synchronize()
    assert cc.launches["chain"] == 1
    if link in ("fma", "fma_imm"):
        ref = roofline.chain_reference(a.double(), b.double(), link, iters, unroll)
        assert_close(got, ref, 2 * unroll * iters * 2.0**-24)
    else:
        assert_close(got, roofline.chain_reference(a, b, link, iters, unroll), 1e-6)


def test_chain_refuses_what_the_kernel_does_not_take(device):
    a = torch.ones(64, 64, device=device)
    with pytest.raises(ValueError, match="link"):
        roofline.chain(a, a, "exp", 1)
    with pytest.raises(ValueError, match="unroll"):
        roofline.chain(a, a, "fma", 1, unroll=32)
    with pytest.raises(TypeError, match="float32"):
        roofline.chain(a.double(), a.double(), "fma", 1)
    with pytest.raises(ValueError, match="contiguous"):
        roofline.chain(a.t(), a, "fma", 1)
    with pytest.raises(ValueError, match="planes"):
        roofline.chain(a[None], a[None], "fma", 1)


def test_window_sync_probe_times_each_cluster_shape(device):
    """The barrier probe of ``mevp_large --barriers`` launches one wave of
    each cluster shape (a block alone, 2 x 2, 16 along a row) and reports a
    finite cost per barrier; a cluster larger than 16 blocks is refused."""
    from nextsimdg_tpu_torch.benchmarks import mevp_large

    shapes = ((1, 1, 128, 0), (2, 2, 128, 1024), (1, 16, 64, 0))
    out = mevp_large.sweep_barriers(device, shapes=shapes, n_barriers=64)
    assert set(out) == set(shapes) and all(np.isfinite(ns) for ns in out.values())
    with pytest.raises(RuntimeError, match="CUDA error"):
        mevp_large.sweep_barriers(device, shapes=((4, 8, 128, 0),), n_barriers=1)
