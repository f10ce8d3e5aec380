"""The CUDA kernels of the dynamics phase against their plain versions.

K1's four kernels (``dg1_rk_stage`` also in its ``qv`` form, blended and
not, at the paths' shapes on uniform and spherical coastline meshes and on
a ragged grid, and the staged ``qv`` transport against ``transport_tiled``'s
bit for bit), the ghost-zone tiled ``mevp_tiled`` and
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

K7's HO round: ``rdma_stage`` at 17 planes and ``rdma_band``'s HO form in
each of its forms (closed, metric, A-weighted, the ring along the band)
against their plain versions launch by launch, the HO rdma round against
the blocked round and the decomposed HO rdma step against the
single-device step (bit for bit).

The periodic forms of K1's four kernels, mevp_tiled, mevp_single and
transport_tiled, and the TVB forms (``dg1_rk_stage``'s unlimited stage,
``dg1_limit`` and transport_tiled's TVB form), against their plain versions
and each other, on periodic and closed uniform and spherical meshes. The
HO kernels' A-weighted, periodic and metric forms (graded, spherical and
the 360 degree ring), and the periodic metric qv forms of ``dg1_rk_stage``
and ``transport_tiled``, likewise.

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

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from nextsimdg_tpu_torch.benchmarks import roofline
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, synthetic_coastline
from nextsimdg_tpu_torch import modules
from nextsimdg_tpu_torch.dynamics import mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import fused_dynamics_cuda as fd
from nextsimdg_tpu_torch.dynamics.kernels import ho_single_cuda as hs
from nextsimdg_tpu_torch.dynamics.kernels import ho_tiled_cuda as ht
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.kernels import mevp_single_cuda as ms
from nextsimdg_tpu_torch.dynamics.kernels import mevp_tiled_cuda as mt
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from nextsimdg_tpu_torch.dynamics.transport import QuadVelocity, substeps_from_speeds
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


def setup(device, n=N, n_subcycles=100, ny=None, spherical=False, degree=1, mevp_params=MEVPParams(),
          periodic=(False, False), tvb_m=None):
    """(model, carry, consts, tracers, rng) on seeded inputs. With a
    momentum form (``mevp_params``) the cover is partial: the first quarter
    of the rows has A below 0.06, some nodes below a_dyn_min; and the last
    half of the rows is calm (velocities 1e-4 of the rest), where the
    adaptive alpha rises above its floor. ``periodic``: (x, y) axes (the
    spherical window then spans 360 degrees, periodic in x); ``tvb_m``: the
    TVB limiter's M."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (n, n if ny is None else ny)
    if spherical:  # a pan-Arctic window with a coastline: metric consts, land
        lon = (0.0, 360.0) if periodic[0] else (-40.0, 40.0)
        mesh = SphericalMesh(*shape, lon0=lon[0], lon1=lon[1], lat0=55.0, lat1=85.0,
                             periodic_x=periodic[0])
        model = CoupledModel(
            mesh, degree=degree, n_subcycles=n_subcycles, ocean_mask=synthetic_coastline(*shape),
            mevp_params=mevp_params, tvb_m=tvb_m,
        )
    else:
        model = CoupledModel(
            RectMesh(*shape, 2000.0, 2000.0, periodic_x=periodic[0], periodic_y=periodic[1]),
            degree=degree, n_subcycles=n_subcycles, mevp_params=mevp_params, tvb_m=tvb_m,
        )
    carry = tuple(t(rng.normal(0.0, s, shape)) for s in (0.2, 0.2, 1e3, 1e3, 1e3))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(8.0, 2.0, shape)), v_atm=t(rng.normal(2.0, 2.0, shape)),
        u_ocean=t(rng.normal(0.0, 0.05, shape)), v_ocean=t(rng.normal(0.0, 0.05, shape)),
    )
    h, a = t(rng.uniform(0.2, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    if mevp_params != MEVPParams():
        a[: shape[0] // 4] = t(rng.uniform(0.0, 0.06, (shape[0] // 4, shape[1])))
        calm = shape[0] // 2
        carry = (carry[0].clone(), carry[1].clone(), *carry[2:])
        carry[0][calm:] *= 1e-4
        carry[1][calm:] *= 1e-4
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), h, a, forcing, mask, DT)
    k = model.transport.basis.n_dofs
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (k - 1, 3, *shape))]))
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


def quad_velocity(model, rng, device, scale=0.3):
    """The quadrature velocity of a seeded CG2 velocity (the HO path's qv)."""
    shape = (model.mesh.nx, model.mesh.ny)
    field = lambda: mevp_ho.HOField(*(
        torch.tensor(rng.normal(0.0, scale, shape), device=device, dtype=torch.float32) for _ in range(4)
    ))
    return mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, field(), field())


@pytest.mark.parametrize("form", ["cg1", "qv"])
@pytest.mark.parametrize("a, b", [(0.0, 1.0), (0.5, 0.5), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0)])
def test_dg1_rk_stage_matches_plain(device, a, b, form):
    model, carry, _, psi, rng = setup(device)
    base = psi.flip(-1).contiguous()
    face_x, face_y = (
        torch.tensor((rng.uniform(size=(N, N)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    args = (model.transport, psi, base, carry[0], carry[1], face_x, face_y, a, b, 300.0)
    qv = quad_velocity(model, rng, device) if form == "qv" else None
    cc.reset_launches()
    got = cc.dg1_rk_stage(*args, qv=qv)
    assert cc.launches["dg1_rk_stage"] == 1
    assert_close(got, cc.dg1_rk_stage_reference(*args, qv=qv), TOL_LAUNCH)


@pytest.mark.parametrize("n_tracers", [1, 2, 4])
def test_dg1_rk_stage_refuses_other_tracer_counts(device, n_tracers):
    """The kernel's warps are laid out for the model's 3 tracers (hice,
    cice, hsnow); another count raises rather than launching."""
    model, carry, _, psi, _ = setup(device)
    psi = psi[:, :1].repeat(1, n_tracers, 1, 1).contiguous()
    ones = torch.ones_like(carry[0])
    with pytest.raises(ValueError, match="3 tracers"):
        cc.dg1_rk_stage(model.transport, psi, psi, carry[0], carry[1], ones, ones, 0.5, 0.5, 300.0)


@pytest.mark.parametrize("a, b", [(0.0, 1.0), (0.5, 0.5)])
@pytest.mark.parametrize("form", ["cg1", "qv"])
@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("shape", [(256, 256), (1024, 1024), (1001, 1003)])  # 1001 x 1003: no multiple of the tile or of 4
def test_dg1_rk_stage_matches_plain_at_the_paths_shapes(device, shape, spherical, form, a, b):
    """One launch per case against the plain version: uniform meshes with
    random face masks, and the spherical window with the synthetic
    coastline (its metric planes and face masks); the velocity from the CG1
    nodes or the CG2 samples; blended or not."""
    model, carry, _, psi, rng = setup(device, n=shape[0], ny=shape[1], spherical=spherical, n_subcycles=1)
    if spherical:
        faces = model.face_masks(device=device, dtype=torch.float32)
    else:
        faces = tuple(
            torch.tensor((rng.uniform(size=shape) > 0.1).astype(np.float32), device=device)
            for _ in range(2)
        )
    qv = quad_velocity(model, rng, device) if form == "qv" else None
    args = (model.transport, psi, psi.flip(-1).contiguous(), carry[0], carry[1], *faces, a, b, 300.0)
    assert_close(cc.dg1_rk_stage(*args, qv=qv), cc.dg1_rk_stage_reference(*args, qv=qv), TOL_LAUNCH)


@pytest.mark.parametrize("ny", [72, 70])  # 16-byte window copies, and 4-byte ones
@pytest.mark.parametrize("scheme, k", [("rk2", 1), ("rk2", 4), ("rk1", 3)])
def test_staged_qv_transport_equals_transport_tiled(device, scheme, k, ny):
    """The staged transport (one dg1_rk_stage a stage) and transport_tiled
    run the same element bodies on the same CG2 samples: equal bit for
    bit, and within 1e-5 of the plain version."""
    model, _, _, psi, rng = setup(device, n=40, ny=ny)
    model.transport.scheme = scheme
    faces = tuple(
        torch.tensor((rng.uniform(size=(40, ny)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    qv = quad_velocity(model, rng, device, scale=1.0)
    args = (model.transport, psi, None, None, DT / k, k, faces)
    cc.reset_launches()
    staged = cc.transport_substeps(*args, qv=qv)
    assert cc.launches["dg1_rk_stage"] == k * {"rk1": 1, "rk2": 2}[scheme]
    assert torch.equal(staged, tt.transport_substeps_tiled(*args, qv=qv))
    assert_close(staged, cc.transport_substeps_reference(*args, qv=qv), 1e-5)


@pytest.mark.parametrize("scheme", ["rk2", "rk3"])
def test_ho_staged_dynamics_phase_matches_plain(device, scheme):
    """The HO dynamics phase at 256^2 on ("single", "xla"): ho_single, then
    the staged transport in its qv form (rk3 too), against the plain
    phase."""
    modules.get_loader().set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        model = CoupledModel(
            RectMesh(256, 256, 4e3, 4e3), n_subcycles=100, mevp_backend="pallas", transport_backend="xla",
        )
    finally:
        modules.get_loader().reset()
    model.transport.scheme = scheme
    assert (model.mevp_schedule(), model.transport_schedule()) == ("single", "xla")
    _, carry, consts = ho_setup(device, 256, 256)
    psi = setup(device, n=256)[3]
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 100, mevp="single", transport="xla")
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100)
    for g, r in zip(ho_planes(got_carry), ho_planes(ref_carry)):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    stages = {"rk2": 2, "rk3": 3}[scheme]
    assert counts["ho_single"] == 1 and counts["dg1_rk_stage"] >= stages
    assert counts["dg1_rk_stage"] % stages == 0 and counts["transport_tiled"] == 0


@pytest.mark.parametrize("scheme", ["rk1", "rk2", "rk3"])
def test_fused_dynamics_matches_plain_and_counts_launches(device, scheme):
    """``coupled_cuda.fused_dynamics``: one fused_dynamics launch at every
    scheme (rk2 the headline's instance, rk1 and rk3 the forms' kernel with
    the scheme's stages at run time), against the plain phase and K1's
    split schedule (2N + 1 + stages x k launches, the same bodies)."""
    model, carry, consts, psi, _ = setup(device)
    model.transport.scheme = scheme
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100)
    cc.reset_launches()
    got_carry, got_tr = cc.fused_dynamics(model, carry, psi, consts, DT, 100)
    counts = dict(cc.launches)
    for g, r in zip(got_carry, ref_carry):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert counts["fused_dynamics"] == 1 and sum(counts.values()) == 1
    cc.reset_launches()
    split_carry, split_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 100, mevp="pallas", transport="xla")
    stages = {"rk1": 1, "rk2": 2, "rk3": 3}[scheme]
    assert cc.launches["mevp_stress"] == cc.launches["mevp_velocity"] == 100
    assert cc.launches["dg1_sample_cfl"] == 1
    assert cc.launches["dg1_rk_stage"] % stages == 0 and cc.launches["dg1_rk_stage"] >= stages
    for g, s_ in zip(got_carry, split_carry):
        assert_same_schedule(g, s_)
    assert_same_schedule(got_tr, split_tr)


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


#: transport_tiled launches besides the one the host picks: the persistent
#: walk over many small tiles by either copy form, the two-block
#: alternative and the block-per-tile shape.
TRANSPORT_LAUNCHES = [
    {"tile": 16}, {"tile": 8}, {"tile": 8, "copy": "scalar"},
    {"config": tt.TWO_BLOCKS, "tile": 8}, {"config": tt.PER_TILE, "tile": 8},
]


def transport_launches(ny):
    """The launches a test runs on a grid ny wide: 16-byte copies need ny % 4 == 0."""
    return [{}] + TRANSPORT_LAUNCHES + ([{"tile": 8, "copy": "vector"}] if ny % 4 == 0 else [])


@pytest.mark.parametrize("ny", [72, 70])  # 16-byte window copies, and 4-byte ones (ny % 4 != 0)
@pytest.mark.parametrize("scheme, k", [("rk2", 1), ("rk2", 4), ("rk1", 1), ("rk1", 4), ("rk1", 3)])
def test_transport_tiled_matches_plain_and_k1_on_a_ragged_grid(device, scheme, k, ny):
    model, carry, _, psi, rng = setup(device, n=40, ny=ny)
    model.transport.scheme = scheme
    faces = tuple(
        torch.tensor((rng.uniform(size=(40, ny)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    args = (model.transport, psi, carry[0], carry[1], DT / k, k, faces)
    ref = tt.transport_substeps_tiled_reference(*args)
    k1 = cc.transport_substeps(*args)
    for launch in transport_launches(ny):
        cc.reset_launches()
        got = tt.transport_substeps_tiled(*args, **launch)
        assert cc.launches["transport_tiled"] == -(-k // tt.K_MAX)
        assert_close(got, ref, 1e-5)
        assert torch.equal(got, k1), launch
    # Loading and storing the windows alone gives the input back.
    assert torch.equal(tt.transport_substeps_tiled(*args, compute=False), psi)


def test_transport_tiled_shared_bytes_agree_with_the_kernel(device):
    """The host's sizing against the kernel's own layout, at each degree's
    window of 1 and 3 tracers (K x the tracers coefficient planes) and for
    rk3's second scratch buffer."""
    lib = cc._library()
    cases = itertools.product(
        (8, 28, 31, 32), (2, 3, 4, 5, 7, 10), (1, 2), (False, True), (1, 3, 6), (1, 3), (2, 3)
    )
    for tile, halo, buffers, qv, n_dofs, group, stages in cases:
        assert lib.nst_transport_tiled_shared_bytes(
            tile, halo, n_dofs * group, buffers, int(qv), stages
        ) == tt.shared_bytes(tile, halo, group, buffers, qv, n_dofs, stages)
    assert tt.blocks_per_sm(device, tt.SHIPPED, tt.halo_for(1, 2)) == 1
    assert tt.blocks_per_sm(device, tt.TWO_BLOCKS, tt.halo_for(1, 2)) == 2


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
    with pytest.raises(ValueError, match="tracers"):  # a window of 2 of the 3 tracers
        tt.transport_substeps_tiled(model.transport, psi, carry[0], carry[1], DT, 1, group=2)
    with pytest.raises(RuntimeError, match="CUDA error"):  # 768 threads: dG2's body takes 384
        tt.transport_substeps_tiled(
            setup(device, degree=2)[0].transport, setup(device, degree=2)[3], carry[0], carry[1],
            DT, 1, threads=768,
        )
    with pytest.raises(RuntimeError, match="CUDA error"):  # more shared memory than a block has
        mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, 8, tile=256, halo=8)
    with pytest.raises(TypeError, match="float32"):
        mt.mevp_subcycles_tiled(model.mevp, tuple(c.double() for c in carry), consts, DT, 8)


#: A forced mevp_single tile per grid: few cells a tile (40 x 72: 90 tiles
#: of 4 x 8), and tiles of many cells (600^2: 72 tiles of 50 x 100, five
#: rows a thread; 1024^2: 128 tiles of 128 x 64, eight rows a thread).
SINGLE_TILES = {(40, 72): (4, 8), (600, 600): (50, 100), (1024, 1024): (128, 64)}


@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("n_sub", [1, 13])
@pytest.mark.parametrize("shape", list(SINGLE_TILES))
def test_mevp_single_matches_plain_k1_and_tiled(device, spherical, n_sub, shape):
    """The tiles the host picks and a forced tile shape equal K1's schedule
    and mevp_tiled bit for bit, and the plain version within the launch
    tolerance; at 1024^2 the const planes but one come from global memory."""
    model, carry, consts, _, _ = setup(device, n=shape[0], ny=shape[1], spherical=spherical)
    assert len(consts) == (12 if spherical else 7)
    config = ms.tiling(*shape, ms.sm_count(device))
    assert config.n_tiles <= ms.max_blocks(device, config, spherical)
    ref = ms.mevp_single_reference(model.mevp, carry, consts, DT, n_sub)
    k1 = cc.mevp_subcycles(model.mevp, carry, consts, DT, n_sub)
    tiled = mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, n_sub)
    for run in ({}, {"tile": SINGLE_TILES[shape]}):
        cc.reset_launches()
        got = ms.mevp_subcycles_single(model.mevp, carry, consts, DT, n_sub, **run)
        assert cc.launches["mevp_single"] == 1
        for g, r, q, w in zip(got, ref, k1, tiled):
            assert_close(g, r, TOL_LAUNCH if n_sub == 1 else 1e-3)
            assert_same_schedule(g, q)
            assert_same_schedule(g, w)
    again = setup(device, n=shape[0], ny=shape[1], spherical=spherical)[1]
    assert all(torch.equal(c, a) for c, a in zip(carry, again))


#: The momentum forms (MEVPParams) of the CG1 kernels' template instances.
FORMS = {
    "weighted": MEVPParams(a_weighted_stress=True),
    "adaptive": MEVPParams(adaptive_alpha=True, alpha_min=20.0),
    "both": MEVPParams(a_weighted_stress=True, adaptive_alpha=True, alpha_min=20.0),
}


@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("form", list(FORMS))
def test_momentum_forms_match_plain_in_each_kernel(device, form, spherical):
    """Each form of the four CG1 kernels with partial cover: mevp_stress and
    mevp_velocity launch by launch against the plain halves (TOL_LAUNCH;
    the adaptive form's beta too), K1's schedule over 11 subcycles against
    plain (1e-3), and mevp_tiled (shipped and small tiles) and mevp_single
    (the tiles the host picks and a forced tile) against K1's schedule bit
    for bit (the same bodies)."""
    params = FORMS[form]
    model, carry, consts, _, _ = setup(device, n=100, ny=136, n_subcycles=11, spherical=spherical, mevp_params=params)
    solver = model.mevp
    if params.a_weighted_stress:
        a_node = consts["a_node"]
        assert bool(((a_node > 0) & (a_node < params.a_dyn_min)).any()) and float(a_node.max()) > 0.5
    ref = solver.stress_update(carry, consts)
    got = cc.mevp_stress(solver, carry, consts)
    assert len(got) == len(ref) == (6 if params.adaptive_alpha else 5)
    for g, r in zip(got, ref):
        assert_close(g, r, TOL_LAUNCH)
    if params.adaptive_alpha:
        assert bool((ref[5] > params.alpha_min).any())
    carry_v = (carry[0], carry[1], *ref[:3])
    ref_uv = solver.velocity_update(carry_v, consts, *ref[3:5], DT, *ref[5:])
    got_uv = cc.mevp_velocity(solver, carry_v, consts, *ref[3:5], DT, *ref[5:])
    for g, r in zip(got_uv, ref_uv):
        assert_close(g, r, TOL_LAUNCH)
    plain = cc.mevp_subcycles_reference(solver, carry, consts, DT, 11)
    k1 = cc.mevp_subcycles(solver, carry, consts, DT, 11)
    for g, r in zip(k1, plain):
        assert_close(g, r, 1e-3)
    runs = [
        mt.mevp_subcycles_tiled(solver, carry, consts, DT, 11),
        mt.mevp_subcycles_tiled(solver, carry, consts, DT, 11, 16, 4, 256),
        ms.mevp_subcycles_single(solver, carry, consts, DT, 11),
        ms.mevp_subcycles_single(solver, carry, consts, DT, 11, tile=(10, 17)),
    ]
    for got in runs:
        for g, q in zip(got, k1):
            assert_same_schedule(g, q)


@pytest.mark.parametrize("form", list(FORMS))
def test_momentum_forms_raise_on_what_the_kernels_do_not_take(device, form):
    """A const set without a_node in the weighted form (or with it in the
    adaptive one) and a beta in the wrong form are refused."""
    params = FORMS[form]
    model, carry, consts, _, _ = setup(device, n_subcycles=3, mevp_params=params)
    wrong = dict(consts)
    if params.a_weighted_stress:
        del wrong["a_node"]
    else:
        wrong["a_node"] = carry[0]
    for run in (cc.mevp_subcycles, mt.mevp_subcycles_tiled, ms.mevp_subcycles_single):
        with pytest.raises(NotImplementedError, match="consts"):
            run(model.mevp, carry, wrong, DT, 3)
    halves = cc.mevp_stress(model.mevp, carry, consts)
    beta = None if params.adaptive_alpha else carry[0]
    with pytest.raises(ValueError, match="adaptive"):
        cc.mevp_velocity(model.mevp, (*carry[:2], *halves[:3]), consts, *halves[3:5], DT, beta)


def test_mevp_single_refuses_a_grid_that_cannot_be_resident(device):
    model, carry, consts, _, _ = setup(device)
    config = ms.tiling(N, N, ms.sm_count(device))
    limit = ms.max_blocks(device, config, False)
    assert limit >= config.n_tiles
    got = ms.mevp_subcycles_single(model.mevp, carry, consts, DT, 3, tile=(32, 32))
    assert_same_schedule(got[0], ms.mevp_subcycles_single(model.mevp, carry, consts, DT, 3)[0])
    with pytest.raises(ValueError, match="resident"):  # 256 tiles outnumber the SMs
        ms.mevp_subcycles_single(model.mevp, carry, consts, DT, 3, tile=(4, 4))
    with pytest.raises(NotImplementedError, match="consts"):
        ms.mevp_subcycles_single(model.mevp, carry, {**consts, "a_node": carry[0]}, DT, 3)
    n = ms.largest_square(ms.sm_count(device)) + 1
    big = setup(device, n=n, n_subcycles=3)
    with pytest.raises(ValueError, match="shared memory"):
        ms.mevp_subcycles_single(big[0].mevp, big[1], big[2], DT, 3)


@pytest.mark.parametrize("n, halo", [(1024, 0), (4096, 0), (1000, 0), (998, 0), (2048, 8), (1024, 3)])
def test_dg1_sample_cfl_streams_equal_speeds_at_the_paths_shapes(device, n, halo):
    """The streaming max at the paths' shapes (16-byte loads where the rows
    allow, 4-byte loads at 998 and on the odd halo) and on a rank block
    widened by its halo: speeds equal to the plain version's, nothing
    zeroed before, the scratch's count back at 0."""
    rng = np.random.default_rng(n + halo)
    shape = (n + 2 * halo, n + 2 * halo)
    transport = CoupledModel(RectMesh(n, n, 2000.0, 2000.0)).transport
    u, v = (torch.tensor(rng.normal(0.0, 0.3, shape), device=device, dtype=torch.float32) for _ in range(2))
    speeds = torch.full((2,), float("nan"), device=device)
    stream = cc._stream(device)
    cc.reset_launches()
    cc._dg1_sample_cfl_(u, v, speeds, cc._dg1_tables(transport), stream, halo=halo)
    assert cc.launches["dg1_sample_cfl"] == 1
    assert torch.equal(speeds, cc.dg1_sample_cfl_reference(transport, u, v, halo=halo))
    assert int(cc._cfl_scratch_of(device, stream)[0]) == 0
    if not halo:
        assert torch.equal(cc.dg1_sample_cfl(transport, u, v), speeds)


@pytest.mark.parametrize("ny", [72, 70])
@pytest.mark.parametrize("k", [1, 4])
def test_metric_transport_kernels_match_plain_and_each_other(device, k, ny):
    model, carry, _, psi, _ = setup(device, n=40, ny=ny, spherical=True)
    faces = model.face_masks(device=device, dtype=torch.float32)
    u, v = carry[0] * 5.0, carry[1] * 5.0
    args = (model.transport, psi, u, v, DT / k, k, faces)
    ref = tt.transport_substeps_tiled_reference(*args)
    k1 = cc.transport_substeps(*args)
    for launch in transport_launches(ny):
        got = tt.transport_substeps_tiled(*args, **launch)
        assert_close(got, ref, 1e-5)
        assert torch.equal(got, k1), launch
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


def ho_setup(device, nx=40, ny=72, seed=0, periodic=(False, False), weighted=False):
    """An HO solver and seeded carry and consts (some nodes without ice).
    ``periodic``: the mesh's (x, y) axes; ``weighted``: the A-weighted form,
    with the first quarter of the rows below 0.06 cover (some nodes below
    a_dyn_min). The wind varies from cell to cell, along the seams too."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (nx, ny)
    solver = mevp_ho.MEVPSolverHO(
        RectMesh(nx, ny, 4e3, 4e3, periodic_x=periodic[0], periodic_y=periodic[1]),
        MEVPParams(a_weighted_stress=weighted),
    )
    field = lambda s, m=0.0: mevp_ho.HOField(*(t(m + rng.normal(0.0, s, shape)) for _ in range(4)))
    state = mevp_ho.HOVelocityState(
        u=field(0.2), v=field(0.2), s11=t(rng.normal(0.0, 1e3, (3, *shape))),
        s22=t(rng.normal(0.0, 1e3, (3, *shape))), s12=t(rng.normal(0.0, 5e2, (3, *shape))),
    )
    forcing = mevp_ho.HODynamicsForcing(field(2.0, 8.0), field(2.0, 2.0), field(0.05), field(0.05))
    h = t(rng.uniform(0.0, 2.0, shape))
    a = t(rng.uniform(0.3, 1.0, shape))
    if weighted:
        a[: nx // 4] = t(rng.uniform(0.0, 0.06, (nx // 4, ny)))
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
    # ho_single: tiles that could not all be resident (4 x 4 tiles of a 40 x
    # 72 grid outnumber the SMs; a 700^2 grid's state outgrows their shared
    # memory) are refused before any launch.
    with pytest.raises(ValueError, match="resident"):
        hs.ho_subcycles_single(solver, carry, consts, DT, 2, tile=(4, 4))
    big = ho_setup(device, 700, 700)
    with pytest.raises(ValueError, match="shared memory"):
        hs.ho_subcycles_single(*big, DT, 2)
    double = tuple(carry[:2]) + tuple(x.double() for x in carry[2:])
    with pytest.raises(TypeError, match="float32"):
        ht.ho_subcycles_tiled(solver, double, consts, DT, 3)


@pytest.mark.parametrize("n_sub", [1, 13])
@pytest.mark.parametrize("shape", [(40, 72), (600, 600)])  # few tiles; tiles of ~2700 elements
def test_ho_single_tiles_and_syncs_match_ho_tiled(device, n_sub, shape):
    """The tiles the host picks and a forced tile shape equal ho_tiled bit
    for bit; at 600^2 the tiles are large and the consts stay in global
    memory."""
    solver, carry, consts = ho_setup(device, *shape)
    tiled = ht.ho_subcycles_tiled(solver, carry, consts, DT, n_sub)
    config = hs.tiling(*shape, hs.sm_count(device))
    assert config.n_tiles <= hs.max_blocks(device, config)
    assert config.consts_shared == (shape == (40, 72))
    runs = [{}, {"tile": (-(-shape[0] // 12), -(-shape[1] // 10))}]
    for run in runs:
        cc.reset_launches()
        got = hs.ho_subcycles_single(solver, carry, consts, DT, n_sub, **run)
        assert cc.launches["ho_single"] == 1
        for g, w in zip(ho_planes(got), ho_planes(tiled)):
            assert torch.equal(g, w), run


@pytest.mark.parametrize("ny", [72, 70])
@pytest.mark.parametrize("k", [1, 4])
def test_transport_tiled_qv_form_matches_plain(device, k, ny):
    solver, carry, _ = ho_setup(device, 40, ny)
    model, _, _, psi, rng = setup(device, n=40, ny=ny)
    faces = tuple(
        torch.tensor((rng.uniform(size=(40, ny)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    scaled = tuple(mevp_ho.HOField(*(5.0 * x for x in f.planes())) for f in carry[:2])
    qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, *scaled)
    args = (model.transport, psi, None, None, DT / k, k, faces)
    ref = tt.transport_substeps_tiled_reference(*args, qv=qv)
    first = None
    for launch in transport_launches(ny):
        cc.reset_launches()
        got = tt.transport_substeps_tiled(*args, qv=qv, **launch)
        assert cc.launches["transport_tiled"] == -(-k // tt.K_MAX)
        assert_close(got, ref, 1e-5)
        first = got if first is None else first
        assert torch.equal(got, first), launch  # every launch the same schedule


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
    # The staged transport on the same CG2 samples: the same tracers, bit for bit.
    cc.reset_launches()
    staged_carry, staged_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 20, mevp="tiled", transport="xla")
    assert cc.launches["dg1_rk_stage"] >= 2 and cc.launches["transport_tiled"] == 0
    assert torch.equal(staged_tr, got_tr)


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


# -- dG0 and dG2, rk3 on transport_tiled, and the no-limit instance ---------------------
@pytest.mark.parametrize("speed", [0.2, 5.0])
@pytest.mark.parametrize("degree", [0, 2])
def test_dg1_sample_cfl_at_every_degree(device, degree, speed):
    """The speeds at the degree's points (3 x 3 and 3 a face at dG2)
    exactly, and k equal, at 256^2 and in a widened rank block."""
    model, carry, _, _, _ = setup(device, n=256, degree=degree, n_subcycles=1)
    u, v = carry[0] * speed, carry[1] * speed
    got = cc.dg1_sample_cfl(model.transport, u, v)
    ref = cc.dg1_sample_cfl_reference(model.transport, u, v)
    assert torch.equal(got, ref)
    k = lambda s: int(substeps_from_speeds(s[0], s[1], DT, model.mesh, degree))
    assert k(got) == k(ref)
    speeds = torch.empty(2, device=device)
    cc._dg1_sample_cfl_(u, v, speeds, cc._dg1_tables(model.transport), cc._stream(device), halo=8)
    assert torch.equal(speeds, cc.dg1_sample_cfl_reference(model.transport, u, v, halo=8))


@pytest.mark.parametrize("a, b", [(0.0, 1.0), (0.75, 0.25)])
@pytest.mark.parametrize("form", ["cg1", "qv"])
@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("degree", [0, 2])
def test_dg1_rk_stage_at_every_degree_matches_plain(device, degree, spherical, form, a, b):
    """One launch of each form at dG0 and dG2: uniform with random face
    masks or spherical with the coastline, CG1 or qv velocity, blended or
    not; on a ragged 101 x 70 grid (4-byte copies)."""
    model, carry, _, psi, rng = setup(device, n=101, ny=70, spherical=spherical, degree=degree, n_subcycles=1)
    if spherical:
        faces = model.face_masks(device=device, dtype=torch.float32)
    else:
        faces = tuple(
            torch.tensor((rng.uniform(size=(101, 70)) > 0.1).astype(np.float32), device=device)
            for _ in range(2)
        )
    qv = quad_velocity(model, rng, device) if form == "qv" else None
    args = (model.transport, psi, psi.flip(-1).contiguous(), carry[0], carry[1], *faces, a, b, 300.0)
    cc.reset_launches()
    got = cc.dg1_rk_stage(*args, qv=qv)
    assert cc.launches["dg1_rk_stage"] == 1
    assert_close(got, cc.dg1_rk_stage_reference(*args, qv=qv), TOL_LAUNCH)


@pytest.mark.parametrize("a, b", [(0.0, 1.0), (1.0 / 3.0, 2.0 / 3.0)])
@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_dg1_rk_stage_no_limit_instance_matches_plain(device, degree, spherical, a, b):
    """The no-limit instance (DGTransport.run): one tracer, the qv form, no
    face masks."""
    model, carry, _, psi, rng = setup(device, n=128, spherical=spherical, degree=degree, n_subcycles=1)
    psi = psi[:, :1].contiguous()
    ones = torch.ones_like(carry[0])
    qv = quad_velocity(model, rng, device)
    args = (model.transport, psi, psi.flip(-1).contiguous(), None, None, None, None, a, b, 300.0)
    got = cc.dg1_rk_stage(*args, qv=qv, limit=False)
    assert_close(got, cc.dg1_rk_stage_reference(*args, qv=qv, limit=False), TOL_LAUNCH)
    psi3 = setup(device, n=128, degree=degree)[3]  # the coupled step's 3 tracers
    with pytest.raises(ValueError, match="one tracer"):
        cc.dg1_rk_stage(model.transport, psi3, psi3, *args[3:], qv=qv, limit=False)
    with pytest.raises(ValueError, match="without face masks"):
        cc.dg1_rk_stage(*args[:5], ones, ones, *args[7:], qv=qv, limit=False)


@pytest.mark.parametrize("degree", [1, 2])
def test_transport_run_matches_plain_and_counts_launches(device, degree):
    """BASELINE config 2 at 128^2 for 20 steps on the kernels against
    DGTransport.step on the card."""
    from nextsimdg_tpu_torch.benchmarks.run_benchmarks import advection_setup

    tr, vel, psi, dt = advection_setup(128, degree, device)
    cc.reset_launches()
    got = tr.run(psi, vel, dt, 20)
    assert cc.launches["dg1_rk_stage"] == 20 * (degree + 1)
    assert_close(got, cc.transport_run_reference(tr, psi, vel, dt, 20), 1e-5)


@pytest.mark.parametrize("form", ["cg1", "qv"])
@pytest.mark.parametrize("ny", [72, 70])  # 16-byte window copies, and 4-byte ones
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("degree, scheme", [(0, "rk1"), (1, "rk3"), (2, "rk3"), (2, "rk2")])
def test_staged_transport_equals_transport_tiled_at_every_degree(device, degree, scheme, k, ny, form):
    """rk3 and the new degrees: the staged transport (one dg1_rk_stage a
    stage) and transport_tiled run the same element bodies, so they agree
    bit for bit, on the CG1 velocity and on the CG2 samples, and within
    1e-5 of the plain version; transport_tiled's window of one tracer
    equals its window of all three."""
    model, carry, _, psi, rng = setup(device, n=40, ny=ny, degree=degree, n_subcycles=1)
    model.transport.scheme = scheme
    faces = tuple(
        torch.tensor((rng.uniform(size=(40, ny)) > 0.1).astype(np.float32), device=device)
        for _ in range(2)
    )
    qv = quad_velocity(model, rng, device, scale=1.0) if form == "qv" else None
    u, v = (None, None) if form == "qv" else (carry[0], carry[1])
    args = (model.transport, psi, u, v, DT / k, k, faces)
    cc.reset_launches()
    staged = cc.transport_substeps(*args, qv=qv)
    assert cc.launches["dg1_rk_stage"] == k * {"rk1": 1, "rk2": 2, "rk3": 3}[scheme]
    for group in (None, 1, 3):
        assert torch.equal(staged, tt.transport_substeps_tiled(*args, qv=qv, group=group)), group
    assert_close(staged, cc.transport_substeps_reference(*args, qv=qv), 1e-5)


@pytest.mark.parametrize("degree", [0, 2])
@pytest.mark.parametrize("mevp, transport", [("pallas", "xla"), ("pallas-tiled", "tiled")])
def test_dynamics_phase_at_every_degree_matches_plain(device, degree, mevp, transport):
    """The dynamics phase at dG0 (rk1) and dG2 (rk3) on K1's schedule and
    on the tiled one against the plain phase, with its launches."""
    model, carry, consts, psi, _ = setup(device, n=64, ny=72, degree=degree)
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 100, mevp=mevp, transport=transport)
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100)
    for g, r in zip(got_carry, ref_carry):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert counts["dg1_sample_cfl"] == 1
    staged = "dg1_rk_stage" if transport == "xla" else "transport_tiled"
    assert counts[staged] > 0 and counts["transport_tiled" if transport == "xla" else "dg1_rk_stage"] == 0


@pytest.mark.parametrize("degree", [0, 2])
def test_rank_grid_rk3_step_equals_single_device_and_matches_plain(device, degree):
    """The 2 x 2 decomposed step with the coastline at dG0 and dG2 (rk3 on
    the spmd transport_tiled) against the single-device step (expected 0)
    and the decomposed plain step."""
    mesh = RectMesh(*GLOBAL, 4e3, 4e3)
    ocean = synthetic_coastline(*GLOBAL)
    single = CoupledModel(mesh, degree=degree, n_subcycles=20, ocean_mask=ocean)
    state = single.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    phys, dyn = coupled_inputs(device, mesh)
    grid = RankGrid(*RANKS, device, timeout=120)
    model, step = build_sharded_coupled_model(
        mesh, grid, degree=degree, n_subcycles=20, ocean_mask=ocean, mevp_block_halo=8,
    )
    assert model.transport_schedule() == "tiled"
    cc.reset_launches()
    got = step(state, phys, dyn, DT)
    torch.cuda.synchronize()
    assert cc.launches["transport_tiled"] > 0 and cc.launches["dg1_rk_stage"] == 0
    expected = single.step(state, phys, dyn, DT)
    blocks = [grid.split_tree(x) for x in (state, phys, dyn)]

    def plain_rank(rank):
        m, (s, p, d) = step.models[rank.rank], (b[rank.rank] for b in blocks)
        return m.step_thermo(m.step_dynamics(s, d, DT, phase=cc.fused_dynamics_reference), p, DT)

    plain = grid.gather_tree(run_ranks(grid.ring, plain_rank), device)
    for (name, g), (_, e), (_, p) in zip(state_leaves(got), state_leaves(expected), state_leaves(plain)):
        assert_same_schedule(g, e)
        assert_close(g, p, 1e-3 if name in VELOCITY else 1e-5)


# -- periodic axes and the TVB limiter -----------------------------------------------
PERIODIC = {"x": (True, False), "y": (False, True), "xy": (True, True)}
#: (periodic axes, spherical): the uniform mesh on each combination and the
#: 360 degree ring.
PERIODIC_MESHES = [("x", False), ("y", False), ("xy", False), ("x", True)]


@pytest.mark.parametrize("periodic, spherical", PERIODIC_MESHES)
def test_periodic_mevp_kernels_match_plain_and_each_other(device, periodic, spherical):
    """The periodic forms of mevp_stress, mevp_velocity (one launch each
    against the plain halves), and 13 subcycles of K1's schedule, mevp_tiled
    and mevp_single (tiles that divide the periodic axes) against the plain
    subcycles and each other."""
    model, carry, consts, _, _ = setup(device, n=64, ny=72, spherical=spherical, periodic=PERIODIC[periodic])
    assert cc.wrap_bits(model.mesh) != 0
    ref = model.mevp.stress_update(carry, consts)
    for g, r in zip(cc.mevp_stress(model.mevp, carry, consts), ref):
        assert_close(g, r, TOL_LAUNCH)
    carry_v = (carry[0], carry[1], *ref[:3])
    ref_uv = model.mevp.velocity_update(carry_v, consts, ref[3], ref[4], DT)
    for g, r in zip(cc.mevp_velocity(model.mevp, carry_v, consts, ref[3], ref[4], DT), ref_uv):
        assert_close(g, r, TOL_LAUNCH)
    plain = cc.mevp_subcycles_reference(model.mevp, carry, consts, DT, 13)
    k1 = cc.mevp_subcycles(model.mevp, carry, consts, DT, 13)
    cc.reset_launches()
    tiled = mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, 13, 16, 4, 256)
    single = ms.mevp_subcycles_single(model.mevp, carry, consts, DT, 13)
    assert cc.launches["mevp_tiled"] == 4 and cc.launches["mevp_single"] == 1
    for p, q, w, o in zip(plain, k1, tiled, single):
        assert_close(q, p, 1e-3)
        assert_same_schedule(w, q)
        assert_same_schedule(o, q)


@pytest.mark.parametrize("periodic, spherical", PERIODIC_MESHES)
def test_periodic_sampling_and_stage_match_plain(device, periodic, spherical):
    """dg1_sample_cfl's periodic form gives the plain speeds; dg1_rk_stage's
    (blended and not) the plain stage, also in the HO path's qv form (on the
    ring its metric instance), and its no-limit instance (the advection run,
    qv form) two plain unlimited steps, at 16-byte copies (ny = 72) and
    4-byte ones (ny = 70)."""
    for ny in (72, 70):
        model, carry, _, psi, rng = setup(device, n=40, ny=ny, spherical=spherical,
                                          periodic=PERIODIC[periodic])
        tr = model.transport
        u, v = carry[0] * 5.0, carry[1] * 5.0
        assert torch.equal(cc.dg1_sample_cfl(tr, u, v), cc.dg1_sample_cfl_reference(tr, u, v))
        faces = model.face_masks(device=device, dtype=torch.float32) or (torch.ones_like(u),) * 2
        base = psi.flip(-1).contiguous()
        for a, b in ((0.0, 1.0), (0.75, 0.25)):
            args = (tr, psi, base, carry[0], carry[1], *faces, a, b, 300.0)
            assert_close(cc.dg1_rk_stage(*args), cc.dg1_rk_stage_reference(*args), TOL_LAUNCH)
        qv = quad_velocity(model, rng, device)
        for a, b in ((0.0, 1.0), (0.75, 0.25)):
            args = (tr, psi, base, None, None, *faces, a, b, 300.0)
            assert_close(cc.dg1_rk_stage(*args, qv=qv), cc.dg1_rk_stage_reference(*args, qv=qv), TOL_LAUNCH)
        one = psi[:, :1].contiguous()
        assert_close(cc.transport_run(tr, one, qv, 100.0, 2), cc.transport_run_reference(tr, one, qv, 100.0, 2),
                     TOL_LAUNCH)


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("periodic, spherical", [("closed", False), ("closed", True)] + PERIODIC_MESHES)
def test_tvb_stage_and_limit_match_plain(device, degree, periodic, spherical):
    """The TVB form launch by launch: dg1_rk_stage's unlimited stage and
    dg1_limit (TVB, then positivity) against their plain versions, with an
    M that cuts some slopes and keeps others; the limiter leaves the means
    as they were."""
    axes = PERIODIC.get(periodic, (False, False))
    model, carry, _, psi, rng = setup(device, n=40, ny=72, degree=degree, spherical=spherical,
                                      periodic=axes, tvb_m=0.0)
    tr = model.transport
    width = float(np.mean(np.asarray(model.mesh.dx)))
    tr.tvb_m = float(psi[1].abs().median()) / width**2
    faces = model.face_masks(device=device, dtype=torch.float32) or (torch.ones_like(carry[0]),) * 2
    args = (tr, psi, psi.flip(-1).contiguous(), carry[0], carry[1], *faces, 0.5, 0.5, 300.0)
    cc.reset_launches()
    stage = cc.dg1_rk_stage(*args, tvb=True)
    assert_close(stage, cc.dg1_rk_stage_reference(*args, tvb=True), TOL_LAUNCH)
    limited = cc.dg1_limit(tr, stage)
    assert cc.launches["dg1_rk_stage"] == 1 and cc.launches["dg1_limit"] == 1
    ref = cc.dg1_limit_reference(tr, stage)
    assert_close(limited, ref, TOL_LAUNCH)
    assert torch.equal(limited[0], stage[0])
    cut = limited[1:3] != stage[1:3]
    assert bool(cut.any()) and not bool(cut.all())


@pytest.mark.parametrize("degree, scheme", [(1, "rk2"), (2, "rk3"), (1, "rk1")])
@pytest.mark.parametrize("periodic", ["closed", "x", "xy"])
@pytest.mark.parametrize("ny", [72, 70])
def test_tvb_transport_staged_equals_tiled_and_matches_plain(device, degree, scheme, periodic, ny):
    """k = 4 TVB substeps (M = 0, pure TVD) on the staged schedule (one
    stage and one dg1_limit launch a stage) and transport_tiled's TVB form
    (two rings a stage): equal to each other (the same bodies) and to the
    plain substeps within 1e-5."""
    model, carry, _, psi, rng = setup(device, n=40, ny=ny, degree=degree,
                                      periodic=PERIODIC.get(periodic, (False, False)), tvb_m=0.0)
    model.transport.scheme = scheme
    k = 4
    faces = tuple(torch.tensor((rng.uniform(size=(40, ny)) > 0.1).astype(np.float32), device=device)
                  for _ in range(2))
    args = (model.transport, psi, carry[0], carry[1], DT / k, k, faces)
    cc.reset_launches()
    staged = cc.transport_substeps(*args)
    stages = {"rk1": 1, "rk2": 2, "rk3": 3}[scheme]
    assert cc.launches["dg1_rk_stage"] == cc.launches["dg1_limit"] == k * stages
    cc.reset_launches()
    tiled = tt.transport_substeps_tiled(*args)
    assert cc.launches["transport_tiled"] >= 2 and cc.launches["dg1_limit"] == 0
    assert_same_schedule(tiled, staged)
    assert_close(staged, cc.transport_substeps_reference(*args), 1e-5)


@pytest.mark.parametrize("mevp, transport", [("pallas", "xla"), ("pallas-tiled", "tiled"), ("pallas-tiled", "xla")])
@pytest.mark.parametrize("degree", [1, 2])
def test_periodic_tvb_dynamics_phase_matches_plain(device, mevp, transport, degree):
    """The dynamics phase on a doubly periodic mesh with TVB (M = 0) on each
    schedule against the plain phase, with its launches."""
    model, carry, consts, psi, _ = setup(device, n=64, ny=72, degree=degree, periodic=(True, True), tvb_m=0.0)
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 100, mevp=mevp, transport=transport)
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100)
    for g, r in zip(got_carry, ref_carry):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert (counts["dg1_limit"] > 0) == (transport == "xla")


def test_spherical_ring_tvb_phase_matches_plain(device):
    """The 360 degree ring with a coastline and TVB: mevp_single, then the
    staged transport with dg1_limit (its tolerance planes), as "auto" takes
    them."""
    model, carry, consts, psi, _ = setup(device, n=40, ny=72, spherical=True, periodic=(True, False), tvb_m=0.0)
    assert model.schedule(device) == ("single", "xla")
    faces = model.face_masks(device=device, dtype=torch.float32)
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 100, faces, mevp="single", transport="xla")
    assert cc.launches["mevp_single"] == 1 and cc.launches["dg1_limit"] > 0
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100, faces)
    for g, r in zip(got_carry, ref_carry):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)


def test_tvb_and_periodic_wrappers_raise_on_what_the_kernels_do_not_take(device):
    model, carry, _, psi, _ = setup(device, n=40, ny=72, spherical=True, tvb_m=0.0)
    with pytest.raises(NotImplementedError, match="staged"):
        tt.transport_substeps_tiled(model.transport, psi, carry[0], carry[1], 60.0, 1)
    plain, _, _, psi, _ = setup(device, n=40, ny=72)
    with pytest.raises(ValueError, match="tvb_m"):
        cc.dg1_limit(plain.transport, psi)
    thin, carry, consts, psi, _ = setup(device, n=6, ny=72, periodic=(True, False), tvb_m=0.0)
    with pytest.raises(ValueError, match="periodic"):
        tt.transport_substeps_tiled(thin.transport, psi, carry[0], carry[1], 60.0, 3)
    with pytest.raises(ValueError, match="periodic"):
        mt.mevp_subcycles_tiled(thin.mevp, carry, consts, DT, 8, 16, 8, 256)


@pytest.mark.parametrize("transport", ["tiled", "xla"])
def test_ho_tvb_dynamics_phase_matches_plain(device, transport):
    """The HO step's transport with the TVB limiter (M = 0) on the CG2
    samples: transport_tiled's TVB form in its qv form, and the staged
    unlimited qv stage with dg1_limit, against the plain phase."""
    modules.get_loader().set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        model = CoupledModel(RectMesh(40, 72, 4e3, 4e3), n_subcycles=20, mevp_backend="pallas-tiled", tvb_m=0.0)
    finally:
        modules.get_loader().reset()
    _, carry, _ = ho_setup(device)
    psi = setup(device, n=40, ny=72)[3]
    consts = model.mevp.step_consts(
        mevp_ho.HOVelocityState(*carry), psi[0, 0], psi[0, 1].clamp(0.0, 1.0),
        mevp_ho.HODynamicsForcing(*(carry[0],) * 4), model.node_mask(device=device, dtype=torch.float32), DT,
    )
    cc.reset_launches()
    _, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 20, mevp="tiled", transport=transport)
    counts = dict(cc.launches)
    _, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 20)
    assert_close(got_tr, ref_tr, 1e-5)
    assert (counts["dg1_limit"] > 0) == (transport == "xla")


# -- the HO solver's A-weighted and periodic forms ------------------------------------
#: (periodic axes, A-weighted) of each new HO form.
HO_FORMS = {
    "weighted": ((False, False), True), "x": ((True, False), False), "y": ((False, True), False),
    "xy": ((True, True), False), "weighted-xy": ((True, True), True),
}


@pytest.mark.parametrize("n_sub", [1, 13])
@pytest.mark.parametrize("form", list(HO_FORMS))
def test_ho_forms_match_plain_and_each_other(device, form, n_sub):
    """Each A-weighted and periodic form of ho_single (its own tiles and a
    forced tile that divides the axes) and ho_tiled (the shipped window,
    2 x 2 clusters and windows wider than a periodic axis's tiles) against
    the plain subcycles, one launch at 1e-5 and 13 subcycles at 1e-3, and
    against each other (the same bodies: expected 0)."""
    periodic, weighted = HO_FORMS[form]
    solver, carry, consts = ho_setup(device, periodic=periodic, weighted=weighted)
    assert cc.kernel_form(solver) == cc.FORM_WEIGHTED * weighted | cc.wrap_bits(solver.mesh) << 2
    assert sorted(consts) == sorted(solver.const_names()) and len(consts) == (33 if weighted else 29)
    ref = hs.ho_single_reference(solver, carry, consts, DT, n_sub)
    cc.reset_launches()
    single = hs.ho_subcycles_single(solver, carry, consts, DT, n_sub)
    forced = hs.ho_subcycles_single(solver, carry, consts, DT, n_sub, tile=(10, 8))
    configs = (ht.SHIPPED, ht.CLUSTER_2X2, ht.LaunchConfig(2, 2, 16, 4, 256))
    tiled = [ht.ho_subcycles_tiled(solver, carry, consts, DT, n_sub, config) for config in configs]
    assert cc.launches["ho_single"] == 2
    assert cc.launches["ho_tiled"] == sum(-(-n_sub // c.halo) for c in configs)
    for planes in zip(ho_planes(ref), ho_planes(single), ho_planes(forced), *map(ho_planes, tiled)):
        r, g, rest = planes[0], planes[1], planes[2:]
        assert_close(g, r, TOL_LAUNCH if n_sub == 1 else 1e-3)
        for w in rest:
            assert_same_schedule(w, g)
    again = ho_setup(device, periodic=periodic, weighted=weighted)[1]
    assert all(torch.equal(x, y) for x, y in zip(ho_planes(carry), ho_planes(again)))


def test_ho_forms_take_their_const_planes_and_tiles(device):
    """The A-weighted form keeps its 33 const planes in shared memory where
    they fit (40 x 72) and not at 600^2; a periodic axis takes only tiles
    that divide it; the kernels refuse the unweighted consts for the
    weighted form."""
    solver, carry, consts = ho_setup(device, weighted=True)
    config = hs.tiling(40, 72, hs.sm_count(device), weighted=True)
    assert config.consts_shared and config.n_consts == 33
    assert config.n_tiles <= hs.max_blocks(device, config, cc.kernel_form(solver))
    assert not hs.tiling(600, 600, hs.sm_count(device), weighted=True).consts_shared
    ring = hs.tiling(40, 72, hs.sm_count(device), periodic=(True, True))
    assert 40 % ring.tile[0] == 0 and 72 % ring.tile[1] == 0
    with pytest.raises(ValueError, match="periodic"):
        hs.tiling(40, 72, hs.sm_count(device), (12, 8), (True, False))
    unweighted = {name: consts[name] for name in mevp_ho.HO_CONSTS}
    with pytest.raises(NotImplementedError, match="consts"):
        ht.ho_subcycles_tiled(solver, carry, unweighted, DT, 3)
    assert ht.max_clusters(device, ht.SHIPPED, cc.kernel_form(solver)) >= 1


def ho_forms_model(device, periodic, weighted, tvb_m=None, nx=40, ny=72):
    """A coupled HO model of the form, with seeded HO carry, tracers and
    step consts."""
    modules.get_loader().set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        model = CoupledModel(
            RectMesh(nx, ny, 4e3, 4e3, periodic_x=periodic[0], periodic_y=periodic[1]), n_subcycles=20,
            mevp_backend="pallas-tiled", tvb_m=tvb_m, mevp_params=MEVPParams(a_weighted_stress=weighted),
        )
    finally:
        modules.get_loader().reset()
    _, carry, _ = ho_setup(device, nx, ny, periodic=periodic, weighted=weighted)
    psi = setup(device, n=nx, ny=ny)[3]
    consts = model.mevp.step_consts(
        mevp_ho.HOVelocityState(*carry), psi[0, 0], psi[0, 1].clamp(0.0, 1.0),
        mevp_ho.HODynamicsForcing(*(carry[0],) * 4), model.node_mask(device=device, dtype=torch.float32), DT,
    )
    return model, carry, psi, consts


@pytest.mark.parametrize("degree, tvb", [(0, False), (1, False), (2, False), (1, True), (2, True)])
@pytest.mark.parametrize("periodic", ["x", "y", "xy"])
def test_periodic_qv_stage_and_transport_match_plain(device, periodic, degree, tvb):
    """The HO path's qv form on a periodic mesh: dg1_rk_stage's limited stage
    (and with TVB its unlimited stage and dg1_limit) launch by launch
    against the plain ones, and k = 4 substeps on the staged schedule and
    on transport_tiled's qv form (untouched or TVB) equal to each other and
    to the plain substeps."""
    model, _, _, psi, rng = setup(device, n=40, ny=72, degree=degree, periodic=PERIODIC[periodic],
                                  tvb_m=0.0 if tvb else None)
    tr = model.transport
    qv = quad_velocity(model, rng, device, scale=1.5)
    faces = tuple(torch.tensor((rng.uniform(size=(40, 72)) > 0.1).astype(np.float32), device=device)
                  for _ in range(2))
    args = (tr, psi, psi.flip(-1).contiguous(), None, None, *faces, 0.5, 0.5, 300.0)
    cc.reset_launches()
    stage = cc.dg1_rk_stage(*args, qv=qv, tvb=tvb)
    assert_close(stage, cc.dg1_rk_stage_reference(*args, qv=qv, tvb=tvb), TOL_LAUNCH)
    if tvb:
        assert_close(cc.dg1_limit(tr, stage), cc.dg1_limit_reference(tr, stage), TOL_LAUNCH)
    k = 4
    sub = (tr, psi, None, None, DT / k, k, faces)
    cc.reset_launches()
    staged = cc.transport_substeps(*sub, qv=qv)
    assert cc.launches["dg1_rk_stage"] == k * len(cc._RK_STAGES[tr.scheme])
    tiled = tt.transport_substeps_tiled(*sub, qv=qv)
    assert cc.launches["transport_tiled"] >= 1
    assert_same_schedule(tiled, staged)
    assert_close(staged, cc.transport_substeps_reference(*sub, qv=qv), 1e-5)


@pytest.mark.parametrize("mevp, transport", [("tiled", "tiled"), ("single", "xla"), ("tiled", "xla")])
@pytest.mark.parametrize("form, tvb_m", [("xy", None), ("xy", 0.0), ("x", None), ("weighted", None),
                                         ("weighted-xy", 0.0)])
def test_ho_forms_dynamics_phase_matches_plain(device, form, tvb_m, mevp, transport):
    """The HO dynamics phase of each form on each schedule against the plain
    phase: 20 subcycles at 1e-3, the tracers at 1e-5, with its launches."""
    periodic, weighted = HO_FORMS[form]
    model, carry, psi, consts = ho_forms_model(device, periodic, weighted, tvb_m)
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 20, mevp=mevp, transport=transport)
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 20)
    for g, r in zip(ho_planes(got_carry), ho_planes(ref_carry)):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert counts["ho_single" if mevp == "single" else "ho_tiled"] >= 1
    assert (counts["transport_tiled"] > 0) == (transport == "tiled")
    assert (counts["dg1_limit"] > 0) == (transport == "xla" and tvb_m is not None)


# -- the HO solver on graded and spherical meshes (the metric forms) ----------------
def metric_mesh(kind, nx=40, ny=72):
    """A graded RectMesh (dx graded along x, dy along y), the closed lon-lat
    window or the 360 degree ring (periodic in x)."""
    if kind == "graded":
        return RectMesh(nx, ny, 4e3 * (1.0 + 0.02 * np.arange(nx)), 3e3 * (1.0 + 0.01 * np.arange(ny)))
    lon = (0.0, 360.0) if kind == "ring" else (-40.0, 40.0)
    return SphericalMesh(nx, ny, lon[0], lon[1], 55.0, 85.0, periodic_x=kind == "ring")


def ho_metric_setup(device, kind, weighted=False, nx=40, ny=72):
    """ho_setup's seeded carry and consts on a metric mesh: an HO solver of
    the form, its 33 (37 A-weighted) const planes."""
    solver, carry, _ = ho_setup(device, nx, ny, periodic=(kind == "ring", False), weighted=weighted)
    solver = mevp_ho.MEVPSolverHO(metric_mesh(kind, nx, ny), MEVPParams(a_weighted_stress=weighted))
    rng = np.random.default_rng(1)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    field = lambda s, m=0.0: mevp_ho.HOField(*(t(m + rng.normal(0.0, s, (nx, ny))) for _ in range(4)))
    forcing = mevp_ho.HODynamicsForcing(field(2.0, 8.0), field(2.0, 2.0), field(0.05), field(0.05))
    a = t(rng.uniform(0.3, 1.0, (nx, ny)))
    if weighted:
        a[: nx // 4] = t(rng.uniform(0.0, 0.06, (nx // 4, ny)))
    consts = solver.step_consts(
        mevp_ho.HOVelocityState(*carry), t(rng.uniform(0.0, 2.0, (nx, ny))), a, forcing,
        solver.boundary_mask(device=device, dtype=torch.float32), DT,
    )
    return solver, carry, consts


HO_METRIC_FORMS = [("graded", False), ("spherical", False), ("spherical", True), ("ring", False), ("ring", True)]


@pytest.mark.parametrize("n_sub", [1, 13])
@pytest.mark.parametrize("kind, weighted", HO_METRIC_FORMS)
def test_ho_metric_forms_match_plain_and_each_other(device, kind, weighted, n_sub):
    """Each metric form of ho_single (its own tiles, consts in shared memory,
    and a forced tile) and ho_tiled (the shipped window, 2 x 2 clusters and
    small windows with aprons in every block) against the plain subcycles,
    one launch at 1e-5 and 13 subcycles at 1e-3, and against each other
    (the same bodies: expected 0)."""
    solver, carry, consts = ho_metric_setup(device, kind, weighted)
    assert cc.kernel_form(solver) & cc.HO_FORM_METRIC
    assert sorted(consts) == sorted(solver.const_names()) and len(consts) == (37 if weighted else 33)
    ref = hs.ho_single_reference(solver, carry, consts, DT, n_sub)
    cc.reset_launches()
    single = hs.ho_subcycles_single(solver, carry, consts, DT, n_sub)
    forced = hs.ho_subcycles_single(solver, carry, consts, DT, n_sub, tile=(10, 8))
    configs = (ht.SHIPPED, ht.CLUSTER_2X2, ht.LaunchConfig(2, 2, 16, 4, 256))
    tiled = [ht.ho_subcycles_tiled(solver, carry, consts, DT, n_sub, config) for config in configs]
    assert cc.launches["ho_single"] == 2
    assert cc.launches["ho_tiled"] == sum(-(-n_sub // c.halo) for c in configs)
    for planes in zip(ho_planes(ref), ho_planes(single), ho_planes(forced), *map(ho_planes, tiled)):
        r, g, rest = planes[0], planes[1], planes[2:]
        assert_close(g, r, TOL_LAUNCH if n_sub == 1 else 1e-3)
        for w in rest:
            assert_same_schedule(w, g)


def test_ho_metric_forms_take_their_const_planes(device):
    """The metric forms keep their 33 or 37 const planes in shared memory
    where they fit (40 x 72) and not at 600^2; the kernels refuse a metric
    mesh's consts without the widths."""
    solver, carry, consts = ho_metric_setup(device, "ring", weighted=True)
    config = hs.tiling(40, 72, hs.sm_count(device), periodic=(True, False), weighted=True, metric=True)
    assert config.consts_shared and config.n_consts == 37
    assert config.n_tiles <= hs.max_blocks(device, config, cc.kernel_form(solver))
    assert not hs.tiling(600, 600, hs.sm_count(device), metric=True).consts_shared
    assert ht.max_clusters(device, ht.SHIPPED, cc.kernel_form(solver)) >= 1
    no_widths = {name: consts[name] for name in mevp_ho.HO_WEIGHTED_CONSTS}
    for run in (hs.ho_subcycles_single, ht.ho_subcycles_tiled):
        with pytest.raises(NotImplementedError, match="consts"):
            run(solver, carry, no_widths, DT, 3)


@pytest.mark.parametrize("degree, tvb", [(0, False), (1, False), (2, False), (1, True), (2, True)])
def test_ring_metric_qv_stage_and_transport_match_plain(device, degree, tvb):
    """The HO path's qv form on the 360 degree ring with the coastline:
    dg1_rk_stage's periodic metric limited stage (and with TVB its
    unlimited stage and dg1_limit with the tolerance planes) launch by
    launch against the plain ones; without TVB, k = 4 substeps on the
    staged schedule and on transport_tiled's periodic metric qv form equal
    to each other and to the plain substeps."""
    model, _, _, psi, rng = setup(device, n=40, ny=72, degree=degree, spherical=True,
                                  periodic=(True, False), tvb_m=0.0 if tvb else None)
    tr = model.transport
    qv = quad_velocity(model, rng, device, scale=1.5)
    faces = model.face_masks(device=device, dtype=torch.float32)
    args = (tr, psi, psi.flip(-1).contiguous(), None, None, *faces, 0.5, 0.5, 300.0)
    stage = cc.dg1_rk_stage(*args, qv=qv, tvb=tvb)
    assert_close(stage, cc.dg1_rk_stage_reference(*args, qv=qv, tvb=tvb), TOL_LAUNCH)
    if tvb:
        assert_close(cc.dg1_limit(tr, stage), cc.dg1_limit_reference(tr, stage), TOL_LAUNCH)
        return
    k = 4
    sub = (tr, psi, None, None, DT / k, k, faces)
    cc.reset_launches()
    staged = cc.transport_substeps(*sub, qv=qv)
    assert cc.launches["dg1_rk_stage"] == k * len(cc._RK_STAGES[tr.scheme])
    tiled = tt.transport_substeps_tiled(*sub, qv=qv)
    assert cc.launches["transport_tiled"] >= 1
    assert_same_schedule(tiled, staged)
    assert_close(staged, cc.transport_substeps_reference(*sub, qv=qv), 1e-5)


@pytest.mark.parametrize("kind, tvb_m, mevp, transport", [
    (kind, None, mevp, transport)
    for kind in ("spherical", "ring", "graded")
    for mevp, transport in (("tiled", "tiled"), ("single", "xla"), ("single", "tiled"))
] + [("ring", 0.0, "tiled", "xla"), ("spherical", 0.0, "single", "xla")])
def test_ho_metric_dynamics_phase_matches_plain(device, kind, tvb_m, mevp, transport):
    """The HO dynamics phase on each metric mesh and schedule (TVB on the
    staged transport, which "auto" runs there) against the plain phase: 20
    subcycles at 1e-3, the tracers at 1e-5, with its launches."""
    modules.get_loader().set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        model = CoupledModel(metric_mesh(kind), n_subcycles=20, tvb_m=tvb_m,
                             ocean_mask=None if kind == "graded" else synthetic_coastline(40, 72))
    finally:
        modules.get_loader().reset()
    _, carry, consts = ho_metric_setup(device, kind)
    psi = setup(device, n=40, ny=72)[3]
    faces = model.face_masks(device=device, dtype=torch.float32)
    cc.reset_launches()
    got_carry, got_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 20, faces, mevp=mevp, transport=transport)
    counts = dict(cc.launches)
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 20, faces)
    for g, r in zip(ho_planes(got_carry), ho_planes(ref_carry)):
        assert_close(g, r, 1e-3)
    assert_close(got_tr, ref_tr, 1e-5)
    assert counts["ho_single" if mevp == "single" else "ho_tiled"] >= 1
    assert (counts["transport_tiled"] > 0) == (transport == "tiled")
    assert (counts["dg1_limit"] > 0) == (tvb_m is not None)


# -- the rank grid's forms: the metric round, the momentum forms, rings and TVB ------
GRID_FORMS = {
    # name: (mesh kind, rank grid, MEVPParams)
    "metric": ("spherical", (2, 2), MEVPParams()),
    "metric ring": ("ring", (2, 2), MEVPParams()),
    "metric ring along y bands": ("ring", (1, 2), MEVPParams()),
    "metric periodic y along x bands": ("graded periodic y", (2, 1), MEVPParams(a_weighted_stress=True)),
    "weighted": ("uniform", (2, 2), MEVPParams(a_weighted_stress=True)),
    "adaptive": ("uniform", (2, 2), MEVPParams(adaptive_alpha=True)),
    "weighted adaptive ring": ("periodic", (1, 2), MEVPParams(a_weighted_stress=True, adaptive_alpha=True)),
    "metric adaptive": ("graded", (2, 2), MEVPParams(adaptive_alpha=True)),
}


def grid_mesh(kind, shape):
    """The global mesh of ``kind`` whose ``shape`` rank blocks are LOCAL."""
    nx, ny = shape[0] * LOCAL[0], shape[1] * LOCAL[1]
    if kind in ("spherical", "ring"):
        ring = kind == "ring"
        return SphericalMesh(nx, ny, 0.0 if ring else -40.0, 360.0 if ring else 40.0, 55.0, 85.0, periodic_x=ring)
    if kind.startswith("graded"):
        dx = 2000.0 * (1.0 + 0.5 * np.cos(np.linspace(0, np.pi, nx)))
        return RectMesh(nx, ny, dx, 2000.0 * np.linspace(0.6, 1.4, ny), periodic_y=kind.endswith("y"))
    periodic = kind == "periodic"
    return RectMesh(nx, ny, 2000.0, 2000.0, periodic_x=periodic, periodic_y=periodic)


def on_form_grid(device, form, backend, fn, h=8, seed=0):
    """``fn(rank, solver, carry, consts)`` on every rank of the rank grid of
    ``form`` (``GRID_FORMS``) on ``device``: its solver on ``backend`` with
    its block (a ``LocalMeshView`` of a graded or spherical mesh), its block
    of seeded inputs (partial cover: some nodes below a_dyn_min) and its
    step consts; returns (grid, mesh, results in rank order)."""
    from nextsimdg_tpu_torch.dynamics.mesh import LocalMeshView

    kind, shape, params = GRID_FORMS[form]
    mesh = grid_mesh(kind, shape)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    size = (mesh.nx, mesh.ny)
    inputs = {k: t(rng.normal(0.0, s, size)) for k, s in zip(VELOCITY, (0.2, 0.2, 1e3, 1e3, 1e3))}
    for k, (m, s) in {"u_atm": (8.0, 2.0), "v_atm": (2.0, 2.0), "u_ocean": (0.0, 0.05), "v_ocean": (0.0, 0.05)}.items():
        inputs[k] = t(rng.normal(m, s, size))
    inputs["h"], inputs["a"] = t(rng.uniform(0.2, 2.0, size)), t(rng.uniform(0.02, 1.0, size))
    grid = RankGrid(*shape, device, timeout=120)
    grid.periodic = (mesh.periodic_x, mesh.periodic_y)
    parts = {k: grid.split(x) for k, x in inputs.items()}

    def body(rank):
        r = rank.rank
        block = LOCAL if mesh.uniform else None
        local = (RectMesh(*block, mesh.dx, mesh.dy, periodic_x=mesh.periodic_x, periodic_y=mesh.periodic_y)
                 if block else LocalMeshView(mesh, *shape, rank.coords))
        solver = MEVPSolver(local, params, backend=backend, spmd=rank.axes, block_halo=h)
        carry = tuple(parts[k][r] for k in VELOCITY)
        forcing = DynamicsForcing(*(parts[k][r] for k in ("u_atm", "v_atm", "u_ocean", "v_ocean")))
        mask = solver.boundary_mask(device=device, dtype=torch.float32)
        consts = solver.step_consts(VelocityState(*carry), parts["h"][r], parts["a"][r], forcing, mask, DT)
        return fn(rank, solver, carry, consts)

    return grid, mesh, inputs, run_ranks(grid.ring, body)


@pytest.mark.parametrize("form", list(GRID_FORMS))
def test_rdma_band_forms_match_plain_launch_by_launch(device, form):
    """Each new form of rdma_band (the metric round, a_node, the adaptive
    body, the ring along the band) one launch at a time against its plain
    version, in a round of 8 subcycles; rdma_stage beside it."""
    h = n_sub = 8

    def round_checked(rank, solver, carry, consts):
        axes, consts_w = solver.rdma_round_inputs(consts)
        checked = []

        def stage(src, axis):
            got = rdma.rdma_stage(src, axis)
            checked.append((got, rdma.rdma_stage_reference(src, axis)))
            return got

        def band(local, src, axis, consts_w, dt, n, state):
            ref = rdma.rdma_band_reference(local, src, axis, consts_w, dt, n, [x.clone() for x in state])
            got = rdma.rdma_band(local, src, axis, consts_w, dt, n, [x.clone() for x in state])
            checked.extend(zip(got, ref))
            return got

        rdma._round(solver.local(), carry, consts, consts_w, DT, n_sub, h, axes, stage, band,
                    mt.mevp_subcycles_tiled)
        return checked

    cc.reset_launches()
    _, _, _, results = on_form_grid(device, form, "rdma", round_checked, h=h)
    torch.cuda.synchronize()
    assert cc.launches["rdma_band"] > 0 and cc.launches["mevp_tiled"] > 0
    for checked in results:
        assert checked
        for got, ref in checked:
            assert_close(got, ref, TOL_LAUNCH)


@pytest.mark.parametrize("form", list(GRID_FORMS))
def test_rdma_round_forms_equal_blocked_and_single_device(device, form):
    """37 subcycles (rounds of 8 and a last of 5) of each form on the rdma
    schedule equal the blocked schedule bit for bit (the same bodies on the
    same values) and the single-device step on mevp_tiled (expected 0)."""
    run = lambda rank, solver, carry, consts: solver.spmd_subcycles(carry, consts, DT, 37)
    grid, mesh, g, rdma_out = on_form_grid(device, form, "rdma", run)
    _, _, _, blocked_out = on_form_grid(device, form, "blocked", run)
    params = GRID_FORMS[form][2]
    single = MEVPSolver(mesh, params)
    carry = tuple(g[k] for k in VELOCITY)
    forcing = DynamicsForcing(g["u_atm"], g["v_atm"], g["u_ocean"], g["v_ocean"])
    mask = single.boundary_mask(device=device, dtype=torch.float32)
    consts = single.step_consts(VelocityState(*carry), g["h"], g["a"], forcing, mask, DT)
    ref = mt.mevp_subcycles_tiled(single, carry, consts, DT, 37)
    for p in range(5):
        got = grid.gather([planes[p] for planes in rdma_out])
        assert torch.equal(got, grid.gather([planes[p] for planes in blocked_out]))
        assert_same_schedule(got, ref[p])


SPMD_TRANSPORT_FORMS = {
    # name: (mesh kind, rank grid, CoupledModel keywords)
    "tvb walls M=0": ("uniform", (2, 2), dict(tvb_m=0.0)),
    "tvb walls middle M": ("uniform", (2, 2), dict(tvb_m=1e-9, ocean=True)),
    "tvb walls dG2": ("uniform", (1, 2), dict(tvb_m=0.0, degree=2)),
    "tvb periodic": ("periodic", (2, 2), dict(tvb_m=1e-9)),
    "metric ring": ("ring", (2, 2), dict(ocean=True)),
    "metric window": ("spherical", (2, 1), dict(ocean=True)),
}


@pytest.mark.parametrize("form", list(SPMD_TRANSPORT_FORMS))
def test_spmd_transport_tiled_forms_match_plain_launch_by_launch(device, form, monkeypatch):
    """The spmd transport's new forms, each transport_tiled launch against
    its plain version on the same widened block: the TVB walls inside the
    block (the kernel's indices, the plain version's wall-delta masks), and
    the widened metric planes passed explicitly."""
    kind, shape, kwargs = SPMD_TRANSPORT_FORMS[form]
    kwargs = dict(kwargs)
    mesh = grid_mesh(kind, shape)
    ocean = synthetic_coastline(mesh.nx, mesh.ny) if kwargs.pop("ocean", False) else None
    grid = RankGrid(*shape, device, timeout=120)
    _, sharded = build_sharded_coupled_model(mesh, grid, ocean_mask=ocean, **kwargs)
    rng = np.random.default_rng(3)
    k = sharded.models[0].transport.basis.n_dofs
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    tracers = t(np.concatenate([rng.uniform(0.5, 2.0, (1, 3, mesh.nx, mesh.ny)),
                                rng.normal(0.0, 0.3, (k - 1, 3, mesh.nx, mesh.ny))]))
    u, v = t(rng.normal(0.0, 0.3, (mesh.nx, mesh.ny))), t(rng.normal(0.0, 0.3, (mesh.nx, mesh.ny)))
    parts = grid.split(tracers), grid.split(u), grid.split(v)
    checked = []
    kernel = tt.transport_substeps_tiled

    def checking(transport, psi, uu, vv, dt_sub, n, faces, **kw):
        got = kernel(transport, psi, uu, vv, dt_sub, n, faces, **kw)
        walls = kw.get("walls")
        masks = None if walls is None else tt.wall_masks(walls, psi.shape[-2:], psi[0, 0])
        ref = tt.transport_substeps_tiled_reference(
            transport, psi, uu, vv, dt_sub, n, faces, metric=kw.get("metric"), wall_masks=masks,
        )
        checked.append((got, ref, walls, kw.get("metric") is not None))
        return got

    monkeypatch.setattr(tt, "transport_substeps_tiled", checking)

    def body(rank):
        model = sharded.models[rank.rank]
        faces = model.face_masks(device=device, dtype=torch.float32)
        vw = tt.widen_velocity(model, parts[1][rank.rank], parts[2][rank.rank])
        return tt.transport_substeps_tiled_spmd(model, parts[0][rank.rank], vw, 300.0, 3, faces)

    cc.reset_launches()
    run_ranks(grid.ring, body)
    torch.cuda.synchronize()
    assert cc.launches["transport_tiled"] >= len(checked) > 0  # a call may take several launches
    for got, ref, walls, metric in checked:
        assert (walls is not None) == ("tvb_m" in kwargs) and metric == (not mesh.uniform)
        assert_close(got, ref, TOL_LAUNCH)


@pytest.mark.parametrize("case", [
    ("spherical", (2, 2), dict(mevp_backend="blocked", ocean=True)),
    ("ring", (2, 2), dict(mevp_backend="rdma", ocean=True)),
    ("ring", (1, 2), dict(mevp_backend="rdma")),
    ("periodic", (2, 2), dict(mevp_backend="blocked", tvb_m=1e-9)),
    ("uniform", (2, 2), dict(mevp_backend="rdma", mevp_params=MEVPParams(a_weighted_stress=True))),
], ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[2]['mevp_backend']}")
def test_decomposed_forms_step_equals_single_device(device, case):
    """The coupled step of each form on the grid against the single-device
    step on the card (expected 0, failure above 1e-6 of the plane's max)."""
    kind, shape, kwargs = case
    kwargs = dict(kwargs)
    mesh = grid_mesh(kind, shape)
    ocean = synthetic_coastline(mesh.nx, mesh.ny) if kwargs.pop("ocean", False) else None
    single = CoupledModel(mesh, n_subcycles=20, ocean_mask=ocean,
                          **{k: v for k, v in kwargs.items() if k != "mevp_backend"})
    state = single.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    phys, dyn = coupled_inputs(device, mesh)
    grid = RankGrid(*shape, device, timeout=120)
    model, step = build_sharded_coupled_model(mesh, grid, n_subcycles=20, ocean_mask=ocean,
                                              mevp_block_halo=8, **kwargs)
    assert model.schedule(device) == (kwargs["mevp_backend"], "tiled")
    cc.reset_launches()
    got = step(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    expected = single.step(state, phys, dyn, DT)
    for (_, g), (_, e) in zip(state_leaves(got), state_leaves(expected)):
        assert_same_schedule(g, e)
    assert counts["transport_tiled"] > 0
    assert (counts["rdma_band"] > 0) == (kwargs["mevp_backend"] == "rdma")


def widened_block(f, coords, shape, periodic):
    """The block at grid ``coords`` (``shape`` its size) of the global field
    ``f`` (..., nx, ny) widened by one ring: zeros beyond a closed wall, the
    wrapped cells on a periodic axis (what the exchange brings)."""
    for axis, wraps in ((-2, periodic[0]), (-1, periodic[1])):
        n = f.shape[axis]
        lo, hi = f.narrow(axis, n - 1, 1), f.narrow(axis, 0, 1)
        if not wraps:
            lo, hi = torch.zeros_like(lo), torch.zeros_like(hi)
        f = torch.cat([lo, f, hi], dim=axis)
    (ix, iy), (bx, by) = coords, shape
    return f[..., ix * bx: (ix + 1) * bx + 2, iy * by: (iy + 1) * by + 2].contiguous()


def mid_tvb_m(mesh) -> float:
    """A TVB constant whose tolerance M dx^2 is 0.1 at the mesh's median
    element width: the limiter cuts some of the seeded slopes, keeps others."""
    width = float(np.median(np.broadcast_to(np.asarray(mesh.dx, dtype=float), (mesh.nx, mesh.ny))))
    return float(f"{0.1 / width**2:.0e}")


HALO_FORM_MESHES = {
    # name: (mesh kind, rank grid, coastline)
    "spherical coast": ("spherical", (2, 2), True),
    "ring": ("ring", (1, 2), False),
    "uniform": ("uniform", (2, 2), False),
}


@pytest.mark.parametrize("velocity", ["cg1", "qv"])
@pytest.mark.parametrize("form", list(HALO_FORM_MESHES))
def test_tvb_on_a_metric_grid_is_refused_on_cuda_tensors(device, form, velocity):
    """The staged route's halo forms on the card (the name is from when
    TVB on a metric grid was refused there): on every block of the grid,
    dg1_rk_stage's halo form (positivity-limited with a == 0, and the TVB
    form's blended unlimited stage) and dg1_limit's (the block's tolerance
    planes, or two scalars on the uniform mesh) on the block widened by one
    ring, each launch against its plain version (1e-5 of the plane's max)
    and against the single domain's kernels restricted to the block (the
    same arithmetic: expected 0, failure above 1e-6)."""
    kind, shape, coast = HALO_FORM_MESHES[form]
    mesh = grid_mesh(kind, shape)
    periodic = (mesh.periodic_x, mesh.periodic_y)
    m = mid_tvb_m(mesh)
    ocean = synthetic_coastline(mesh.nx, mesh.ny) if coast else None
    grid = RankGrid(*shape, device, timeout=120)
    _, sharded = build_sharded_coupled_model(mesh, grid, n_subcycles=2, ocean_mask=ocean, tvb_m=m)
    single = CoupledModel(mesh, n_subcycles=2, ocean_mask=ocean, tvb_m=m)
    tr = single.transport
    rng = np.random.default_rng(8)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    n = (mesh.nx, mesh.ny)
    coeffs = lambda: t(np.concatenate([rng.uniform(0.2, 2.0, (1, 3, *n)), rng.normal(0.0, 0.4, (2, 3, *n))]))
    psi, base = coeffs(), coeffs()
    faces = single.face_masks(device=device, dtype=torch.float32) or (torch.ones(n, device=device),) * 2
    u = v = qv = None
    if velocity == "cg1":
        u, v = t(rng.normal(0.0, 0.3, n)), t(rng.normal(0.0, 0.3, n))
    else:
        qv = QuadVelocity(*(t(rng.normal(0.0, 0.3, (q, *n))) for q in (4, 4, 2, 2)))
    dt = 120.0
    stages = {
        "limited": (0.0, 1.0, cc.dg1_rk_stage(tr, psi, base, u, v, *faces, 0.0, 1.0, dt, qv=qv)),
        "tvb": (0.5, 0.5, cc.dg1_rk_stage(tr, psi, base, u, v, *faces, 0.5, 0.5, dt, qv=qv, tvb=True)),
    }
    limited = cc.dg1_limit(tr, stages["tvb"][2])
    cut = tr.limit_slopes(stages["tvb"][2])[1:] != stages["tvb"][2][1:]
    assert 0.05 < float(cut.double().mean()) < 0.95
    bx, by = mesh.nx // shape[0], mesh.ny // shape[1]
    cc.reset_launches()
    for rank, model in zip(grid.ranks, sharded.models):
        wide = lambda f: widened_block(f, rank.coords, (bx, by), periodic)
        own = (Ellipsis, slice(rank.coords[0] * bx, (rank.coords[0] + 1) * bx),
               slice(rank.coords[1] * by, (rank.coords[1] + 1) * by))
        walls = tt.spmd_walls(model, 1)
        local = model.widened_transport(1)
        metric = model.widened_metric(1, device=device, dtype=torch.float32)
        qv_w = None if qv is None else QuadVelocity(*(wide(f) for f in (qv.vx_vol, qv.vy_vol, qv.vn_x, qv.vn_y)))
        uv = (None, None) if u is None else (wide(u), wide(v))
        args = (wide(psi), base[own].contiguous(), *uv, wide(faces[0]), wide(faces[1]), walls)
        for name, (a, b, ref) in stages.items():
            kw = dict(qv=qv_w, metric=metric, tvb=name == "tvb")
            got = cc.dg1_rk_stage_halo(local, *args, a, b, dt, **kw)
            assert_close(got, cc.dg1_rk_stage_halo_reference(local, *args, a, b, dt, **kw), TOL_LAUNCH)
            assert_same_schedule(got, ref[own])
        stage, means_w = stages["tvb"][2][own].contiguous(), wide(stages["tvb"][2][0])
        got = cc.dg1_limit_halo(model.transport, stage, means_w, walls)
        assert_close(got, cc.dg1_limit_halo_reference(model.transport, stage, means_w, walls), TOL_LAUNCH)
        assert_same_schedule(got, limited[own])
    ranks = shape[0] * shape[1]
    assert cc.launches["dg1_rk_stage"] == 2 * ranks and cc.launches["dg1_limit"] == ranks


@pytest.mark.parametrize("case", [
    ("spherical", (2, 2), dict(tvb_m=0.0, ocean=True)),
    ("spherical", (2, 2), dict(tvb_m="mid", ocean=True, mevp_backend="rdma")),
    ("ring", (1, 2), dict(tvb_m="mid", ocean=True)),
    ("uniform", (2, 2), dict(transport_backend="xla")),
    ("periodic", (2, 2), dict(transport_backend="xla", tvb_m="mid")),
], ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-" + "-".join(f"{k}={v}" for k, v in c[2].items()))
def test_staged_grid_step_equals_single_device(device, case):
    """The decomposed coupled step on the staged route (TVB on a metric
    grid, and ``transport_backend="xla"``) against the single-device step
    on the card (expected 0, failure above 1e-6 of the plane's max); every
    transport launch is a halo form."""
    kind, shape, kwargs = case
    kwargs = dict(kwargs)
    mesh = grid_mesh(kind, shape)
    ocean = synthetic_coastline(mesh.nx, mesh.ny) if kwargs.pop("ocean", False) else None
    if kwargs.get("tvb_m") == "mid":
        kwargs["tvb_m"] = mid_tvb_m(mesh)
    backend = kwargs.pop("mevp_backend", "blocked")
    single = CoupledModel(mesh, n_subcycles=20, ocean_mask=ocean, **kwargs)
    state = single.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    phys, dyn = coupled_inputs(device, mesh)
    model, step = build_sharded_coupled_model(mesh, RankGrid(*shape, device, timeout=120), n_subcycles=20,
                                              ocean_mask=ocean, mevp_backend=backend, mevp_block_halo=8, **kwargs)
    assert model.schedule(device) == (backend, "xla")
    cc.reset_launches()
    got = step(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    expected = single.step(state, phys, dyn, DT)
    for (_, g), (_, e) in zip(state_leaves(got), state_leaves(expected)):
        assert_same_schedule(g, e)
    assert counts["transport_tiled"] == 0 and counts["dg1_rk_stage"] > 0
    assert (counts["dg1_limit"] > 0) == (kwargs.get("tvb_m") is not None)


# -- the HO solver on a rank grid's blocked schedule ---------------------------------
HO_BLOCK = 96  # a rank's block; the grid is 2 x 2 of them


def ho_grid_mesh(kind):
    """The 192^2 global mesh of ``kind``: config 4's uniform 2 km mesh or
    the lon-lat window 40W-40E, 55N-85N."""
    n = 2 * HO_BLOCK
    return RectMesh(n, n, 2e3, 2e3) if kind == "uniform" else SphericalMesh(n, n, -40.0, 40.0, 55.0, 85.0)


def ho_grid_model(device, kind, n_subcycles=20, mevp_backend="auto", **kwargs):
    """(single-device HO model, rank 0's model, the sharded step, seeded
    global HO state with the coastline's land) on a 2 x 2 grid of
    ``HO_BLOCK``^2 blocks, h = 8, on the exchange schedule
    ``mevp_backend``."""
    mesh = ho_grid_mesh(kind)
    ocean = synthetic_coastline(mesh.nx) if kind == "spherical" else None
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        single = CoupledModel(mesh, n_subcycles=n_subcycles, ocean_mask=ocean, **kwargs)
        model, sharded = build_sharded_coupled_model(
            mesh, RankGrid(2, 2, device, timeout=120), n_subcycles=n_subcycles, ocean_mask=ocean,
            mevp_backend=mevp_backend, mevp_block_halo=8, **kwargs,
        )
    finally:
        loader.reset()
    rng = np.random.default_rng(4)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    state = single.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    shape = (mesh.nx, mesh.ny)
    field = lambda: mevp_ho.HOField(*(t(rng.normal(0.0, 0.2, shape)) for _ in range(4)))
    velocity = mevp_ho.HOVelocityState(field(), field(), *(t(rng.normal(0.0, 500.0, (3, *shape))) for _ in range(3)))
    return single, model, sharded, dataclasses.replace(state, velocity=velocity)


def ho_state_leaves(state):
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        yield name, getattr(state, name)
    yield from zip(("u.v", "u.b", "u.l", "u.c", "v.v", "v.b", "v.l", "v.c", "s11", "s22", "s12"),
                   ho_planes(tuple(getattr(state.velocity, k) for k in VELOCITY)))


@pytest.mark.parametrize("kind", ["uniform", "spherical"])
def test_widened_ho_tiled_launch_matches_plain(device, kind, monkeypatch):
    """ho_tiled on each rank's widened block of the blocked schedule (its
    closed form on a uniform mesh, the metric form on the window, whose
    width planes are the global ones' slices and zero beyond a wall): one
    subcycle at 1e-5 and a round of h = 8 subcycles (one launch) at 1e-3
    against the plain subcycles, on the round's own inputs."""
    _, _, sharded, state = ho_grid_model(device, kind)
    checked = {}
    run = mevp_ho.MEVPSolverHO.subcycles

    def checking(solver, carry, consts, dt, n):
        import threading

        name = threading.current_thread().name
        if name not in checked:
            checked[name] = [
                (ht.ho_subcycles_tiled(solver, carry, consts, dt, m), ht.ho_tiled_reference(solver, carry, consts, dt, m),
                 m, tuple(carry[0].v.shape), cc.kernel_form(solver))
                for m in (1, n)
            ]
        return run(solver, carry, consts, dt, n)

    monkeypatch.setattr(mevp_ho.MEVPSolverHO, "subcycles", checking)
    cc.reset_launches()
    phys, dyn = coupled_inputs(device, ho_grid_mesh(kind))
    sharded(state, phys, dyn, DT)
    torch.cuda.synchronize()
    assert len(checked) == 4 and cc.launches["ho_tiled"] >= 8
    for launches in checked.values():
        for got, ref, m, shape, form in launches:
            assert shape == (HO_BLOCK + 16, HO_BLOCK + 16)
            assert bool(form & cc.HO_FORM_METRIC) == (kind == "spherical")
            for g, r in zip(ho_planes(got), ho_planes(ref)):
                assert_close(g, r, TOL_LAUNCH if m == 1 else 1e-3)


@pytest.mark.parametrize("kind", ["uniform", "spherical"])
def test_spmd_qv_transport_launch_matches_plain(device, kind, monkeypatch):
    """transport_substeps_tiled_spmd with the CG2 samples (``qv``, widened
    by H): each transport_tiled launch against its plain version on the
    same widened block (on the window with the widened metric planes)."""
    _, _, sharded, state = ho_grid_model(device, kind)
    blocks = sharded.grid.split_tree(state)
    checked = []
    kernel = tt.transport_substeps_tiled

    def checking(transport, psi, uu, vv, dt_sub, n, faces, **kw):
        got = kernel(transport, psi, uu, vv, dt_sub, n, faces, **kw)
        ref = tt.transport_substeps_tiled_reference(transport, psi, uu, vv, dt_sub, n, faces, qv=kw["qv"],
                                                    metric=kw.get("metric"))
        checked.append((got, ref, kw.get("metric") is not None))
        return got

    monkeypatch.setattr(tt, "transport_substeps_tiled", checking)

    def body(rank):
        model, st = sharded.models[rank.rank], blocks[rank.rank]
        qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, st.velocity.u, st.velocity.v, rank.axes)
        tracers = torch.stack([st.hice, st.cice, st.hsnow], dim=1)
        faces = model.face_masks(device=device, dtype=torch.float32)
        return tt.transport_substeps_tiled_spmd(model, tracers, None, 300.0, 3, faces, qv=qv)

    cc.reset_launches()
    run_ranks(sharded.grid.ring, body)
    torch.cuda.synchronize()
    assert cc.launches["transport_tiled"] >= len(checked) >= 4
    for got, ref, metric in checked:
        assert metric == (kind == "spherical")
        assert_close(got, ref, TOL_LAUNCH)


@pytest.mark.parametrize("kind", ["uniform", "spherical"])
def test_ho_grid_step_equals_single_device(device, kind):
    """The decomposed HO coupled step (ho_single on the 112^2 widened
    blocks, the spmd qv transport) against the single-device step on the
    card (expected 0, failure above 1e-6 of the plane's max)."""
    single, model, sharded, state = ho_grid_model(device, kind)
    assert model.schedule(device) == ("blocked", "tiled")
    phys, dyn = coupled_inputs(device, single.mesh)
    cc.reset_launches()
    got = sharded(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    expected = single.step(state, phys, dyn, DT)
    for (name, g), (_, e) in zip(ho_state_leaves(got), ho_state_leaves(expected)):
        assert bool(torch.isfinite(g).all()), name
        assert_same_schedule(g, e)
    assert counts["ho_single"] > 0 and counts["transport_tiled"] > 0


@pytest.mark.parametrize("kind", ["uniform", "periodic"])
def test_ho_tvb_on_a_grid_is_refused_on_cuda_tensors(device, kind, monkeypatch):
    """HO with TVB on a uniform rank grid, closed or a ring of ranks (the
    name is from when it was refused on the card): each launch of the spmd
    transport_tiled's qv + walls instance (the CG2 samples widened by H,
    the global walls by index) against its plain version on the same
    widened block (1e-5 of the plane's max), then the decomposed step
    against the single-device step (expected 0)."""
    mesh = ho_grid_mesh("uniform")
    if kind == "periodic":
        mesh = RectMesh(mesh.nx, mesh.ny, mesh.dx, mesh.dy, periodic_x=True, periodic_y=True)
    m = mid_tvb_m(mesh)
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        single = CoupledModel(mesh, n_subcycles=20, tvb_m=m)
        model, sharded = build_sharded_coupled_model(mesh, RankGrid(2, 2, device, timeout=120), n_subcycles=20,
                                                     mevp_block_halo=8, tvb_m=m)
    finally:
        loader.reset()
    assert model.schedule(device) == ("blocked", "tiled")
    rng = np.random.default_rng(4)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    state = single.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    shape = (mesh.nx, mesh.ny)
    field = lambda: mevp_ho.HOField(*(t(rng.normal(0.0, 0.2, shape)) for _ in range(4)))
    velocity = mevp_ho.HOVelocityState(field(), field(), *(t(rng.normal(0.0, 500.0, (3, *shape))) for _ in range(3)))
    state = dataclasses.replace(state, velocity=velocity)
    blocks = sharded.grid.split_tree(state)
    checked = []
    kernel = tt.transport_substeps_tiled

    def checking(transport, psi, uu, vv, dt_sub, n, faces, **kw):
        got = kernel(transport, psi, uu, vv, dt_sub, n, faces, **kw)
        masks = tt.wall_masks(kw["walls"], psi.shape[-2:], psi[0, 0])
        ref = tt.transport_substeps_tiled_reference(transport, psi, uu, vv, dt_sub, n, faces, qv=kw["qv"],
                                                    wall_masks=masks)
        checked.append((got, ref))
        return got

    def body(rank):
        model, st = sharded.models[rank.rank], blocks[rank.rank]
        qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, st.velocity.u, st.velocity.v, rank.axes)
        tracers = torch.stack([st.hice, st.cice, st.hsnow], dim=1)
        faces = (torch.ones_like(st.sst),) * 2
        return tt.transport_substeps_tiled_spmd(model, tracers, None, 300.0, 3, faces, qv=qv)

    with monkeypatch.context() as patched:
        patched.setattr(tt, "transport_substeps_tiled", checking)
        cc.reset_launches()
        run_ranks(sharded.grid.ring, body)
        torch.cuda.synchronize()
    assert cc.launches["transport_tiled"] >= len(checked) >= 4
    for got, ref in checked:
        assert_close(got, ref, TOL_LAUNCH)
    phys, dyn = coupled_inputs(device, mesh)
    cc.reset_launches()
    got = sharded(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    expected = single.step(state, phys, dyn, DT)
    for (name, g), (_, e) in zip(ho_state_leaves(got), ho_state_leaves(expected)):
        assert bool(torch.isfinite(g).all()), name
        assert_same_schedule(g, e)
    assert counts["transport_tiled"] > 0 and counts["dg1_rk_stage"] == 0


def test_ho_tvb_on_a_spherical_grid_equals_single_device(device):
    """The HO spherical window with the coastline and TVB on 2 x 2 ranks:
    the staged route with the widened CG2 samples (dg1_rk_stage's halo form
    in its qv form, then dg1_limit's with the tolerance planes) against
    the single-device step on the card (expected 0)."""
    mesh = ho_grid_mesh("spherical")
    single, model, sharded, state = ho_grid_model(device, "spherical", tvb_m=mid_tvb_m(mesh))
    assert model.schedule(device) == ("blocked", "xla")
    phys, dyn = coupled_inputs(device, single.mesh)
    cc.reset_launches()
    got = sharded(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    expected = single.step(state, phys, dyn, DT)
    for (name, g), (_, e) in zip(ho_state_leaves(got), ho_state_leaves(expected)):
        assert bool(torch.isfinite(g).all()), name
        assert_same_schedule(g, e)
    assert counts["transport_tiled"] == 0 and counts["dg1_rk_stage"] > 0 and counts["dg1_limit"] > 0


# -- K7's HO round: rdma_stage at 17 planes and rdma_band's HO form -------------------
#: (mesh kind, rank grid, A-weighted) of each HO band form: the closed
#: uniform instance, the metric one (a spherical window's views), the
#: A-weighted ones, and the ring along the band (a periodic box whose
#: unsplit axis wraps, the x bands on (2, 1) and the y bands on (1, 2), and
#: the 360 degree lon-lat ring on (1, 2), metric).
HO_RDMA_FORMS = {
    "closed": ("uniform", (2, 2), False), "metric": ("spherical", (2, 2), False),
    "weighted": ("uniform", (2, 2), True), "weighted metric": ("spherical", (2, 2), True),
    "ring x bands": ("periodic", (2, 1), False), "ring y bands": ("periodic", (1, 2), False),
    "metric ring": ("ring", (1, 2), False),
}


def ho_rdma_mesh(kind):
    n = 2 * HO_BLOCK
    if kind in ("uniform", "periodic"):
        return RectMesh(n, n, 2e3, 2e3, periodic_x=kind == "periodic", periodic_y=kind == "periodic")
    if kind == "ring":
        return SphericalMesh(n, n, 0.0, 360.0, 60.0, 85.0, periodic_x=True)
    return SphericalMesh(n, n, -40.0, 40.0, 55.0, 85.0)


def on_ho_rank_grid(device, form, h, fn, backend="rdma", seed=5):
    """``fn(rank, solver, carry, consts)`` on every rank of the grid of an
    HO_RDMA_FORMS form (each rank's HO solver on ``backend`` with ghost
    width h, its block of seeded global inputs and its step consts, A below
    a_dyn_min in places); returns (grid, results in rank order)."""
    from nextsimdg_tpu_torch.dynamics.mesh import LocalMeshView

    kind, shape, weighted = HO_RDMA_FORMS[form]
    mesh = ho_rdma_mesh(kind)
    grid = RankGrid(*shape, device, timeout=120)
    grid.periodic = (mesh.periodic_x, mesh.periodic_y)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    n = (mesh.nx, mesh.ny)
    fields = {k: [t(rng.normal(m, s, n)) for _ in range(4)] for k, (m, s) in {
        "u": (0.0, 0.2), "v": (0.0, 0.2), "u_atm": (8.0, 2.0), "v_atm": (2.0, 2.0),
        "u_ocean": (0.0, 0.05), "v_ocean": (0.0, 0.05)}.items()}
    stress = [t(rng.normal(0.0, 500.0, (3, *n))) for _ in range(3)]
    hh, aa = t(rng.uniform(0.2, 2.0, n)), t(rng.uniform(0.02, 1.0, n))
    parts = {k: [grid.split(p) for p in planes] for k, planes in fields.items()}
    stress_parts, h_parts, a_parts = [grid.split(s) for s in stress], grid.split(hh), grid.split(aa)
    params = MEVPParams(a_weighted_stress=weighted)
    px, py = shape

    def body(rank):
        r = rank.rank
        block = (RectMesh(mesh.nx // px, mesh.ny // py, mesh.dx, mesh.dy, periodic_x=mesh.periodic_x,
                          periodic_y=mesh.periodic_y)
                 if mesh.uniform else LocalMeshView(mesh, px, py, rank.coords))
        solver = mevp_ho.MEVPSolverHO(block, params, backend=backend, spmd=rank.axes, block_halo=h)
        field = lambda k: mevp_ho.HOField(*(p[r] for p in parts[k]))
        state = mevp_ho.HOVelocityState(field("u"), field("v"), *(s[r] for s in stress_parts))
        forcing = mevp_ho.HODynamicsForcing(*(field(k) for k in ("u_atm", "v_atm", "u_ocean", "v_ocean")))
        mask = solver.boundary_mask(device=device, dtype=torch.float32)
        consts = solver.step_consts(state, h_parts[r], a_parts[r], forcing, mask, DT)
        return fn(rank, solver, (state.u, state.v, state.s11, state.s22, state.s12), consts)

    return grid, run_ranks(grid.ring, body)


@pytest.mark.parametrize("h, n_sub", [(16, 1), (16, 7), (16, 16), (32, 32)])
@pytest.mark.parametrize("form", list(HO_RDMA_FORMS))
def test_ho_rdma_kernels_match_plain_launch_by_launch(device, form, h, n_sub):
    """One HO rdma round on every rank of a 2 x 2 (or 2 x 1, 1 x 2) grid of
    96^2 blocks: each rdma_stage launch (17-plane strips) and, on the first
    and the last rank (a wall on either side of each split axis), each
    launch of rdma_band's HO form (x and y bands where their axis is split)
    against its plain version on the same inputs (1e-5 of the plane's
    max), and every rank's round against the blocked schedule's round
    (ho_tiled on the widened block) bit for bit."""
    last = HO_RDMA_FORMS[form][1][0] * HO_RDMA_FORMS[form][1][1] - 1

    def round_checked(rank, solver, carry, consts):
        axes, consts_w = solver.rdma_round_inputs(consts)
        checked = []

        def stage(src, axis):
            got = rdma.rdma_stage(src, axis)
            checked.append(("rdma_stage", axis, got, rdma.rdma_stage_reference(src, axis)))
            return got

        def band(local, src, axis, cw, dt, n, state):
            got = rdma.rdma_band(local, src, axis, cw, dt, n, state.clone())
            if rank.rank in (0, last):  # the plain HO band is ~40 ms of host issue a subcycle
                checked.append(("rdma_band", axis, got, rdma.rdma_band_reference(local, src, axis, cw, dt, n,
                                                                                 state.clone())))
            return got

        out = rdma._round(solver.local(), cc.ho_flatten(carry), consts, consts_w, DT, n_sub, h, axes, stage,
                          band, rdma.ho_interior)
        blocked = mevp_ho.MEVPSolverHO(solver.mesh, solver.params, backend="blocked", spmd=solver.spmd,
                                       block_halo=h)
        return checked, out, cc.ho_flatten(blocked.spmd_subcycles(carry, consts, DT, n_sub))

    cc.reset_launches()
    grid, results = on_ho_rank_grid(device, form, h, round_checked)
    torch.cuda.synchronize()
    split = [n > 1 for n in grid.shape]
    ranks = len(results)
    assert cc.launches["rdma_band"] == sum(split) * ranks
    assert cc.launches["rdma_stage"] == sum(split) * ranks
    for r, (checked, out, blocked) in enumerate(results):
        kernels = ("rdma_band", "rdma_stage") if r in (0, last) else ("rdma_stage",)
        assert sorted({(name, axis) for name, axis, _, _ in checked}) == sorted(
            (name, axis) for name in kernels for axis in (0, 1) if split[axis])
        for _, _, got, ref in checked:
            assert_close(got, ref, TOL_LAUNCH)
        assert torch.equal(out, blocked)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("config", [
    rdma.HoBandConfig(1, 1, 24, 256), rdma.HoBandConfig(1, 3, 32, 128), rdma.HoBandConfig(4, 1, 8, 64),
    rdma.HoBandConfig(4, 2, 8, 96), rdma.HoBandConfig(2, 4, 16, 96), rdma.HoBandConfig(3, 5, 8, 32),
    rdma.HoBandConfig(8, 2, 8, 96, staged=False), rdma.HoBandConfig(2, 2, 12, 352),
    rdma.HoBandConfig(1, 1, 24, 384), *(config for _, _, config in rdma.HO_BANDS),
], ids=str)
def test_ho_rdma_band_launch_configurations_match_plain(device, axis, config):
    """rdma_band's HO form in one-block tiles, in clusters split along the
    band, across it (5 blocks over 24 cells: the last holds 4) and both,
    2 to 16 blocks, 32 to 384 threads (1 to 3 cells a thread), the consts
    staged or read from L2, and the shipped configurations, on the metric
    form of the spherical window's blocks, against its plain version on
    whole bands."""
    h, n_sub = 8, 7

    def band(rank, solver, carry, consts):
        _, consts_w = solver.rdma_round_inputs(consts)
        nx, ny = solver.mesh.nx, solver.mesh.ny
        src = rdma.RoundSources(
            own=tuple(cc.ho_flatten(carry)), h=h, split=(True, True),
            gx=tuple(torch.full((17, h, ny), 0.5, device=device) for _ in range(2)),
            gy=tuple(torch.full((17, nx + 2 * h, h), -0.25, device=device) for _ in range(2)),
        )
        state = torch.zeros((17, nx, ny), device=device)
        local = solver.local()
        ref = rdma.rdma_band_reference(local, src, axis, consts_w, DT, n_sub, state.clone())
        return rdma.rdma_band(local, src, axis, consts_w, DT, n_sub, state.clone(), config), ref

    cc.reset_launches()
    _, results = on_ho_rank_grid(device, "metric", h, band)
    torch.cuda.synchronize()
    assert cc.launches["rdma_band"] == 4
    for got, ref in results:
        assert_close(got, ref, TOL_LAUNCH)


@pytest.mark.parametrize("kind", ["uniform", "spherical"])
def test_ho_rdma_grid_step_equals_single_device(device, kind):
    """The decomposed HO coupled step on the rdma schedule (h = 8: rounds of
    rdma_stage, ho_single on the 96^2 blocks, the HO rdma_band; the spmd
    qv transport) against the single-device step on the card (expected 0,
    failure above 1e-6 of the plane's max) and the blocked schedule's
    decomposed step (bit for bit)."""
    single, model, sharded, state = ho_grid_model(device, kind, mevp_backend="rdma")
    _, _, blocked, _ = ho_grid_model(device, kind)
    assert model.schedule(device) == ("rdma", "tiled")
    phys, dyn = coupled_inputs(device, single.mesh)
    cc.reset_launches()
    got = sharded(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    expected = single.step(state, phys, dyn, DT)
    other = blocked(state, phys, dyn, DT)
    for (name, g), (_, e), (_, b) in zip(ho_state_leaves(got), ho_state_leaves(expected), ho_state_leaves(other)):
        assert bool(torch.isfinite(g).all()), name
        assert_same_schedule(g, e)
        assert torch.equal(g, b), name
    assert counts["rdma_stage"] > 0 and counts["rdma_band"] > 0 and counts["ho_single"] > 0
    assert counts["ho_tiled"] == 0 and counts["transport_tiled"] > 0


def test_ho_rdma_band_refuses_what_the_kernel_does_not_take(device):
    """The HO form takes an ``HoBandConfig`` of blocks of at most 384
    threads (256 with L2 consts), a multiple of 32, clusters of at most 16 blocks with a cell
    of the band in each, a (17, nx, ny) state that does not alias the
    pre-round planes, and a shared-memory footprint within the card's."""

    def bad_calls(rank, solver, carry, consts):
        axes, consts_w = solver.rdma_round_inputs(consts)
        own = cc.ho_flatten(carry)
        nx, ny = own.shape[1:]
        src = rdma.RoundSources(own=tuple(own), h=8, split=(True, True),
                                gx=tuple(torch.zeros((17, 8, ny), device=device) for _ in range(2)))
        local = solver.local()
        errors = []
        band = lambda config: rdma.rdma_band(local, src, 0, consts_w, DT, 8, own.clone(), config)
        for call in (
            lambda: band(rdma.HoBandConfig(1, 1, 64, 512)),
            lambda: rdma.rdma_band(local, src, 0, consts_w, DT, 8, own),
            lambda: band(rdma.HoBandConfig(1, 1, 200, 256)),
            lambda: rdma.rdma_band(local, src, 1, consts_w, DT, 8, own.clone()),  # the y ghosts have not arrived
            lambda: band(rdma.HoBandConfig(4, 5, 8, 64)),  # 20 blocks a cluster
            lambda: band(rdma.HoBandConfig(2, 25, 8, 64)),  # more blocks across than the band's 24 cells
            lambda: band(rdma.HoBandConfig(2, 2, 8, 100)),  # not a multiple of 32 threads
            lambda: band(rdma.BandConfig(2, 16, 128)),  # the CG1 form's configuration
        ):
            try:
                call()
            except ValueError as exc:
                errors.append(type(exc))
        return errors

    _, results = on_ho_rank_grid(device, "closed", 8, bad_calls)
    assert all(errors == [ValueError] * 8 for errors in results)


# -- the width-1 ("xla") mEVP schedule of a rank grid: the halves' halo forms ---------
def xla_block_solver(kind, high_order, weighted=False, adaptive=False):
    """A rank's solver: block (1, 0) of a 2 x 2 grid of LOCAL blocks of
    config 4's uniform mesh or the lon-lat window (a ``LocalMeshView``)."""
    from nextsimdg_tpu_torch.dynamics.mesh import LocalMeshView

    nx, ny = LOCAL
    if kind == "uniform":
        mesh = RectMesh(nx, ny, 4e3, 4e3)
    else:
        mesh = LocalMeshView(SphericalMesh(2 * nx, 2 * ny, -40.0, 40.0, 55.0, 85.0), 2, 2, (1, 0))
    params = MEVPParams(a_weighted_stress=weighted, adaptive_alpha=adaptive)
    return (mevp_ho.MEVPSolverHO if high_order else MEVPSolver)(mesh, params)


def xla_block_inputs(device, solver, seed):
    """Seeded state, the solver's step consts and a random generator."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = LOCAL
    h, a = t(rng.uniform(0.2, 2.0, shape)), t(rng.uniform(0.02, 1.0, shape))
    mask = solver.boundary_mask(device=device, dtype=torch.float32)
    if isinstance(solver, mevp_ho.MEVPSolverHO):
        field = lambda s, m=0.0: mevp_ho.HOField(*(t(m + rng.normal(0.0, s, shape)) for _ in range(4)))
        state = mevp_ho.HOVelocityState(field(0.2), field(0.2), *(t(rng.normal(0.0, 1e3, (3, *shape))) for _ in range(3)))
        forcing = mevp_ho.HODynamicsForcing(field(1.0, 8.0), field(1.0, 2.0), field(0.05), field(0.05))
    else:
        state = VelocityState(*(t(rng.normal(0.0, s, shape)) for s in (0.2, 0.2, 1e3, 1e3, 1e3)))
        forcing = DynamicsForcing(*(t(rng.normal(m, s, shape)) for m, s in ((8.0, 2.0), (2.0, 2.0), (0.0, 0.05), (0.0, 0.05))))
    return state, solver.step_consts(state, h, a, forcing, mask, DT), rng


@pytest.mark.parametrize("kind", ["uniform", "spherical"])
@pytest.mark.parametrize("form", [{}, {"weighted": True}, {"adaptive": True}, {"weighted": True, "adaptive": True}],
                         ids=["fixed", "weighted", "adaptive", "both"])
def test_mevp_halo_forms_match_plain_launch_by_launch(device, kind, form):
    """mevp_stress's and mevp_velocity's halo forms on a rank block and
    seeded strips (on a metric block also half_dx's and half_dy's) against
    their plain versions (TOL_LAUNCH), one launch each."""
    solver = xla_block_solver(kind, False, **form)
    state, consts, rng = xla_block_inputs(device, solver, 11)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    nx, ny = LOCAL
    carry = tuple(getattr(state, k) for k in VELOCITY)
    plus = (t(rng.normal(0.0, 0.2, (2, ny))), t(rng.normal(0.0, 0.2, (2, nx + 1))))
    cc.reset_launches()
    got = cc.mevp_stress_halo(solver, carry, consts, *plus)
    ref = cc.mevp_stress_halo_reference(solver, carry, consts, *plus)
    assert len(got) == len(ref) == 5 + bool(form.get("adaptive"))
    for g, r in zip(got, ref):
        assert_close(g, r, TOL_LAUNCH)
    minus = (t(rng.normal(0.0, 1e3, (3, ny))), t(rng.normal(0.0, 1e3, (3, nx + 1))))
    metric = (None, None)
    if kind != "uniform":
        metric = (t(rng.uniform(1e3, 3e3, (2, ny))), t(rng.uniform(1e3, 3e3, (2, nx + 1))))
    carry = (*carry[:2], *ref[:3])
    got = cc.mevp_velocity_halo(solver, carry, consts, ref[3], ref[4], DT, *minus, *metric, *ref[5:])
    expected = cc.mevp_velocity_halo_reference(solver, carry, consts, ref[3], ref[4], DT, *minus, *metric, *ref[5:])
    for g, r in zip(got, expected):
        assert_close(g, r, TOL_LAUNCH)
    assert cc.launches["mevp_stress"] == cc.launches["mevp_velocity"] == 1


@pytest.mark.parametrize("kind", ["uniform", "spherical"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ho_halves_match_plain_launch_by_launch(device, kind, weighted):
    """ho_stress and ho_velocity on a rank block's 17 planes and seeded
    strips (on a metric block also dx's and dy's) against their plain
    versions (TOL_LAUNCH), one launch each."""
    solver = xla_block_solver(kind, True, weighted)
    state, consts, rng = xla_block_inputs(device, solver, 12)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    nx, ny = LOCAL
    flat = cc.ho_flatten(tuple(getattr(state, k) for k in VELOCITY))
    plus = (t(rng.normal(0.0, 0.2, (8, ny))), t(rng.normal(0.0, 0.2, (8, nx + 1))))
    cc.reset_launches()
    got = cc.ho_stress_halo(solver, flat, consts, *plus)
    ref = cc.ho_stress_halo_reference(solver, flat, consts, *plus)
    for q in range(17):
        assert_close(got[q], ref[q], TOL_LAUNCH)
    minus = (t(rng.normal(0.0, 1e3, (9, ny))), t(rng.normal(0.0, 1e3, (9, nx + 1))))
    widths = (None, None)
    if kind != "uniform":
        widths = (t(rng.uniform(1e3, 3e3, (2, ny))), t(rng.uniform(1e3, 3e3, (2, nx + 1))))
    got = cc.ho_velocity_halo(solver, ref, consts, DT, *minus, *widths)
    expected = cc.ho_velocity_halo_reference(solver, ref, consts, DT, *minus, *widths)
    for q in range(17):
        assert_close(got[q], expected[q], TOL_LAUNCH)
    assert cc.launches["ho_stress"] == cc.launches["ho_velocity"] == 1


@pytest.mark.parametrize("high_order", [False, True], ids=["cg1", "ho"])
@pytest.mark.parametrize("case", [
    ("uniform", (2, 2), {}), ("spherical", (2, 2), {"ocean": True}), ("ring", (2, 2), {}),
    ("ring", (1, 2), {"ocean": True}), ("uniform", (2, 2), {"weighted": True}),
], ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}" + "".join(f"-{k}" for k in c[2]))
def test_xla_grid_step_equals_single_device_and_blocked(device, case, high_order):
    """The decomposed coupled step on the width-1 ("xla") mEVP schedule
    against the single-device step and the blocked step on the card (the
    same bodies on the same values: expected 0, failure above 1e-6 of the
    plane's max); the mEVP launches only the halo halves, two a subcycle
    and rank."""
    kind, shape, kwargs = case
    kwargs = dict(kwargs)
    mesh = grid_mesh(kind, shape)
    ocean = synthetic_coastline(mesh.nx, mesh.ny) if kwargs.pop("ocean", False) else None
    params = MEVPParams(a_weighted_stress=kwargs.pop("weighted", False))
    loader = modules.get_loader()
    if high_order:
        loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        single = CoupledModel(mesh, n_subcycles=20, ocean_mask=ocean, mevp_params=params)
        steps = {
            backend: build_sharded_coupled_model(
                mesh, RankGrid(*shape, device, timeout=120), n_subcycles=20, ocean_mask=ocean,
                mevp_params=params, mevp_backend=backend, mevp_block_halo=8)[1]
            for backend in ("xla", "blocked")
        }
    finally:
        loader.reset()
    state = single.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    phys, dyn = coupled_inputs(device, mesh)
    cc.reset_launches()
    got = steps["xla"](state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    halves = ("ho_stress", "ho_velocity") if high_order else ("mevp_stress", "mevp_velocity")
    ranks = shape[0] * shape[1]
    assert all(counts[h] == 20 * ranks for h in halves)
    others = ("mevp_stress", "mevp_velocity", "mevp_tiled", "mevp_single", "ho_single", "ho_tiled", "rdma_stage",
              "rdma_band", "ho_stress", "ho_velocity")
    assert all(counts[k] == 0 for k in others if k not in halves)
    leaves = ho_state_leaves if high_order else state_leaves
    for other in (single.step(state, phys, dyn, DT), steps["blocked"](state, phys, dyn, DT)):
        for (_, g), (_, e) in zip(leaves(got), leaves(other)):
            assert_same_schedule(g, e)


def test_host_staged_process_exchange_matches_the_thread_grid(device):
    """Two processes of one rank each on one card, joined over gloo: strips
    staged through pinned host buffers; the gathered state equals the
    thread grid's, and the blocked schedule's kernels ran in each process."""
    from nextsimdg_tpu_torch.parallel import multiprocess

    results = multiprocess.launch(2, 1, paths=("blocked",), n=64, steps=2, device="cuda", backend="gloo",
                                  timeout=600)
    for r in results:
        assert (r["backend"], r["host_staged"]) == ("gloo", True)
        entry = r["paths"]["blocked"]
        assert entry["finite_probe"] is True and entry["finite_probe_detects"] is True
        assert entry["launches"]["mevp_tiled"] > 0 and entry["launches"]["dg1_sample_cfl"] > 0
    assert results[0]["paths"]["blocked"]["threads_max_abs_error"] == 0.0


# -- K1 as one launch: fused_dynamics ---------------------------------------------
def fused_setup(device, shape, masked: bool, auto: bool, dx: float = 250.0, periodic=(False, False),
                **form):
    """(model, carry, consts, psi, faces) on seeded float32 inputs: 250 m
    elements, so that the relaxed velocity needs k > 1 substeps; a
    coastline with ``masked``; with ``auto`` off k = 3; ``periodic``: the
    (x, y) axes; ``form``: the model's degree, tvb_m, mevp_params."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    ocean = synthetic_coastline(*shape) if masked else None
    mesh = RectMesh(*shape, dx, dx, periodic_x=periodic[0], periodic_y=periodic[1])
    model = CoupledModel(mesh, n_subcycles=100, ocean_mask=ocean, auto_substeps=auto,
                         transport_substeps=1 if auto else 3, **form)
    carry = tuple(t(rng.normal(0.0, s_, shape)) for s_ in (0.2, 0.2, 1e3, 1e3, 1e3))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(8.0, 2.0, shape)), v_atm=t(rng.normal(2.0, 2.0, shape)),
        u_ocean=t(rng.normal(0.0, 0.05, shape)), v_ocean=t(rng.normal(0.0, 0.05, shape)),
    )
    h, a = t(rng.uniform(0.2, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), h, a, forcing, mask, DT)
    k = model.transport.basis.n_dofs
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (k - 1, 3, *shape))]))
    return model, carry, consts, psi, model.face_masks(device=device, dtype=torch.float32)


@pytest.mark.parametrize("auto", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (200, 136)])
def test_fused_dynamics_matches_plain_and_the_split_schedule(device, shape, masked, auto):
    """One launch of the whole phase against the plain phase (1e-3 on the
    mEVP planes, 1e-5 on the tracers) and K1's split schedule (the same
    bodies: expected 0, failure above 1e-6); its speeds equal
    dg1_sample_cfl's and its k the host's, k > 1 (3 with auto off)."""
    model, carry, consts, psi, faces = fused_setup(device, shape, masked, auto)
    cc.reset_launches()
    got_carry, got_tr, info = fd.fused_dynamics_single(model, carry, psi, consts, DT, 100, faces)
    torch.cuda.synchronize()
    assert cc.launches["fused_dynamics"] == 1 and sum(cc.launches.values()) == 1
    split_carry, split_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 100, faces, mevp="pallas",
                                              transport="xla")
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100, faces)
    for g, s_, r in zip(got_carry, split_carry, ref_carry):
        assert_same_schedule(g, s_)
        assert_close(g, r, 1e-3)
    assert_same_schedule(got_tr, split_tr)
    assert_close(got_tr, ref_tr, 1e-5)
    speeds = cc.dg1_sample_cfl(model.transport, split_carry[0], split_carry[1])
    assert torch.equal(info[:2], speeds)
    k = int(info[2])
    assert k == (cc._k_of_speeds(model, speeds, DT) if auto else 3) and k > 1


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_fused_dynamics_k_arithmetic_equals_the_host_on_the_card(device, degree):
    """The kernel's device function for k against the host's count on
    float32 CPU tensors and the plain mirror, on speeds at every ceil
    boundary up to k_max, with each degree's c_stab."""
    mesh = RectMesh(256, 256, 2000.0, 2000.0)
    speeds = fd.ceil_boundary_speeds(DT, mesh, degree)
    for k_floor in (1, 3):
        got = fd.substeps_on_card(torch.tensor(speeds, device=device), DT, mesh, degree,
                                  k_floor=k_floor).cpu().numpy()
        host = [int(substeps_from_speeds(torch.tensor(sx), torch.tensor(sy), DT, mesh, degree, k_floor=k_floor))
                for sx, sy in speeds]
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(
            got, fd.substeps_plain(speeds[:, 0], speeds[:, 1], DT, mesh, degree, k_floor=k_floor))


def test_fused_headline_steps_make_no_host_sync(device):
    """Warmed-up headline steps (dynamics only) on "fused" under
    torch.cuda.set_sync_debug_mode("error"): nothing on the step syncs."""
    model = CoupledModel(RectMesh(256, 256, 2000.0, 2000.0), mevp_backend="pallas")
    assert model.schedule(device) == ("fused", "xla")
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device=device, dtype=torch.float32)
    full = lambda value: torch.full((256, 256), value, device=device, dtype=torch.float32)
    forcing = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    state = model.run(state, None, forcing, DT, 2, do_thermo=False)
    torch.cuda.synchronize()
    cc.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.run(state, None, forcing, DT, 3, do_thermo=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cc.launches["fused_dynamics"] == 3 and cc.launches["mevp_stress"] == 0
    assert bool(torch.isfinite(out.hice).all())


def test_fused_dynamics_refuses_what_it_does_not_hold(device):
    model, carry, consts, psi, faces = fused_setup(device, (64, 64), True, True)
    with pytest.raises(TypeError, match="float32"):
        fd.fused_dynamics_single(model, tuple(c.double() for c in carry), psi, consts, DT, 10, faces)
    big = CoupledModel(RectMesh(1024, 1024, 2000.0, 2000.0), mevp_backend="pallas")
    assert big.schedule(device) == ("pallas", "xla")
    zeros = torch.zeros((1024, 1024), device=device)
    big_consts = {name: zeros for name in consts}
    with pytest.raises(ValueError, match="does not fit"):
        fd.fused_dynamics_single(big, (zeros,) * 5, torch.zeros((3, 3, 1024, 1024), device=device), big_consts,
                                 DT, 10)
    sphere = CoupledModel(SphericalMesh(64, 64, -40.0, 40.0, 55.0, 85.0))
    with pytest.raises(ValueError, match="graded or spherical"):
        fd.fused_dynamics_single(sphere, carry, psi, consts, DT, 10, faces)
    assert fd.max_blocks(device, fd.tiling(256, 256, cc.sm_count(device))) >= 128


#: The forms of fused_dynamics beside the headline's (the forms' kernel):
#: fused_setup's keywords.
FUSED_FORMS = {
    "periodic_x": dict(periodic=(True, False)),
    "periodic_both": dict(periodic=(True, True)),
    "a_weighted": dict(mevp_params=MEVPParams(a_weighted_stress=True)),
    "adaptive": dict(mevp_params=MEVPParams(adaptive_alpha=True, alpha_min=20.0)),
    "dg0": dict(degree=0),
    "dg2": dict(degree=2),
    "tvb_dg1": dict(tvb_m=0.0),
    "tvb_dg2": dict(degree=2, tvb_m=0.0),
    "every_form": dict(periodic=(True, True), degree=2, tvb_m=0.0,
                       mevp_params=MEVPParams(a_weighted_stress=True, adaptive_alpha=True, alpha_min=20.0)),
}


@pytest.mark.parametrize("auto", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", list(FUSED_FORMS))
def test_fused_dynamics_forms_match_plain_and_the_split_schedule(device, form, masked, auto):
    """Each form in one launch against the plain phase (1e-3 on the mEVP
    planes, 1e-5 on the tracers) and K1's split schedule in that form (the
    same bodies: expected 0, failure above 1e-6); its speeds equal
    dg1_sample_cfl's and its k the host's, k > 1 (3 with auto off)."""
    model, carry, consts, psi, faces = fused_setup(device, (64, 64), masked, auto, **FUSED_FORMS[form])
    assert not fd.form_of(model).headline and model.schedule(device) == ("fused", "xla")
    cc.reset_launches()
    got_carry, got_tr, info = fd.fused_dynamics_single(model, carry, psi, consts, DT, 100, faces)
    torch.cuda.synchronize()
    assert cc.launches["fused_dynamics"] == 1 and sum(cc.launches.values()) == 1
    split_carry, split_tr = cc.dynamics_phase(model, carry, psi, consts, DT, 100, faces, mevp="pallas",
                                              transport="xla")
    ref_carry, ref_tr = cc.fused_dynamics_reference(model, carry, psi, consts, DT, 100, faces)
    for g, s_, r in zip(got_carry, split_carry, ref_carry):
        assert_same_schedule(g, s_)
        assert_close(g, r, 1e-3)
    assert_same_schedule(got_tr, split_tr)
    assert_close(got_tr, ref_tr, 1e-5)
    speeds = cc.dg1_sample_cfl(model.transport, split_carry[0], split_carry[1])
    assert torch.equal(info[:2], speeds)
    k = int(info[2])
    assert k == (cc._k_of_speeds(model, speeds, DT) if auto else 3) and k > 1


@pytest.mark.parametrize("form", list(FUSED_FORMS))
def test_fused_dynamics_form_tilings_are_the_kernel_s(device, form):
    """At 256^2 every form's shared bytes are the kernel's own count, and
    all its tiles can be resident at once."""
    model = fused_setup(device, (256, 256), True, True, **FUSED_FORMS[form])[0]
    config = fd.tiling(256, 256, cc.sm_count(device), True, fd.form_of(model))
    assert fd.shared_bytes_on_card(config) == config.shared_bytes
    assert fd.max_blocks(device, config) >= config.n_tiles


@pytest.mark.parametrize("form", ["every_form", "dg0", "tvb_dg1"])
def test_fused_form_steps_make_no_host_sync(device, form):
    """Warmed-up steps (dynamics only) of a form on "fused" under
    torch.cuda.set_sync_debug_mode("error"): nothing on the step syncs."""
    model, carry, _, psi, _ = fused_setup(device, (128, 128), True, True, dx=2000.0, **FUSED_FORMS[form])
    assert model.schedule(device) == ("fused", "xla")
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device=device, dtype=torch.float32)
    full = lambda value: torch.full((128, 128), value, device=device, dtype=torch.float32)
    forcing = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    state = model.run(state, None, forcing, DT, 2, do_thermo=False)
    torch.cuda.synchronize()
    cc.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.run(state, None, forcing, DT, 3, do_thermo=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cc.launches["fused_dynamics"] == 3 and cc.launches["mevp_stress"] == 0
    assert bool(torch.isfinite(out.hice).all())
