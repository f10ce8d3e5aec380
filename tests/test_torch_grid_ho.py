"""The HO (CG2/dG1) mEVP solver on a rank grid: the port against the JAX package.

At float64 on the CPU, the same seeded numpy inputs go through the JAX
package's ``MEVPSolverHO`` (its single-domain "xla" solver, and once its
``shard_map`` program on the 8-device CPU mesh of ``tests/conftest.py``)
and through the port's solver on ``nextsimdg_tpu_torch.parallel``'s rank
grid, each rank a thread holding its block (a ``RectMesh``, or a
``LocalMeshView`` of a graded or spherical mesh) and its exchange: the
exchange forms of the CG2 node machinery and of ``boundary_mask``, and the
N subcycles on the blocked schedule (several ghost widths) and the
width-1 "xla" one, on uniform, periodic, graded, spherical and ring
meshes, with and without ``a_weighted_stress``; and what raises.

Twins of ``tests/test_shardmap.py``'s
``test_ho_blocked_halo_exchange_matches_per_subcycle`` and
``test_ho_blocked_periodic_matches_per_subcycle`` and
``tests/test_shardmap_metric.py``'s
``test_mevp_ho_blocked_nonuniform_matches_single_device`` and
``test_mevp_ho_blocked_ring_spherical_matches_single_device``.

Tolerances: exactly 0 between the port's grid and its single domain, and
between its schedules (the same operations on the same values); 1e-8 of
each plane's max against the JAX package after the subcycles (XLA fuses
the subcycle differently), as the JAX templates on a metric mesh hold
theirs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics import mevp_ho as jax_ho
from nextsimdg_tpu.dynamics.mesh import SphericalMesh as JaxSphericalMesh
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.mesh import LocalMeshView
from nextsimdg_tpu_torch.dynamics.mevp import BLOCK_HALO, MEVPParams
from nextsimdg_tpu_torch.parallel import RankGrid, run_ranks

torch.set_num_threads(1)

N = 32
DT = 600.0
N_SUB = 12
PLANES = ("v", "b", "l", "c")
FORCING = ("u_atm", "v_atm", "u_ocean", "v_ocean")
TIMEOUT = 60.0


def mesh_of(kind: str, n: int = N, side: str = "port"):
    """The global mesh ``kind``: "uniform", "periodic" (uniform, both axes
    periodic), "graded" (dx refined in the middle columns, dy toward y0),
    "spherical" (20W-20E, 60N-80N) or "ring" (the 360 degree ring at
    55N-75N), as the JAX templates build them."""
    rect, sphere = (RectMesh, SphericalMesh) if side == "port" else (JaxRectMesh, JaxSphericalMesh)
    if kind == "graded":
        dx = 512e3 / n * (1.0 + 0.5 * np.cos(np.linspace(0, np.pi, n)))
        dy = 512e3 / n * np.linspace(0.6, 1.4, n)
        return rect(n, n, dx, dy) if side == "port" else rect(nx=n, ny=n, dx=dx, dy=dy)
    if kind in ("spherical", "ring"):
        lon, lat = ((-20.0, 20.0), (60.0, 80.0)) if kind == "spherical" else ((0.0, 360.0), (55.0, 75.0))
        return sphere(n, n, lon[0], lon[1], lat[0], lat[1], periodic_x=kind == "ring") if side == "port" else (
            sphere(nx=n, ny=n, lon0=lon[0], lon1=lon[1], lat0=lat[0], lat1=lat[1], periodic_x=kind == "ring"))
    periodic = kind == "periodic"
    if side == "port":
        return rect(n, n, 512e3 / n, 512e3 / n, periodic_x=periodic, periodic_y=periodic)
    return rect(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n, periodic_x=periodic, periodic_y=periodic)


def assert_planes_close(got, ref, rtol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def ho_inputs(n: int = N, seed: int = 0) -> dict:
    """Global numpy leaves: a moving CG2 velocity and dG1 stresses, h (a
    corner of light ice, held at rest), A and a sheared CG2 forcing."""
    rng = np.random.default_rng(seed)
    field = lambda scale, mean=0.0: {k: mean + rng.normal(0.0, scale, (n, n)) for k in PLANES}
    h = rng.uniform(0.5, 2.5, (n, n))
    h[: n // 4, : n // 3] = 1e-4
    return dict(
        u=field(0.2), v=field(0.2), s11=rng.normal(0.0, 500.0, (3, n, n)),
        s22=rng.normal(0.0, 500.0, (3, n, n)), s12=rng.normal(0.0, 200.0, (3, n, n)),
        h=h, a=rng.uniform(0.02, 1.0, (n, n)),
        u_atm=field(1.0, 10.0), v_atm=field(0.5, 3.0), u_ocean=field(0.01, 0.02), v_ocean=field(0.01),
    )


def flat(out) -> tuple:
    """An HOVelocityState's 17 planes as numpy: u's v, b, l, c; v's; the
    stresses' 3 coefficients each."""
    return tuple(np.asarray(x) for x in (
        *(getattr(out.u, k) for k in PLANES), *(getattr(out.v, k) for k in PLANES),
        *out.s11, *out.s22, *out.s12,
    ))


# -- the JAX package -------------------------------------------------------------------
def _jax_leaves(d):
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    field = lambda f: jax_ho.HOField(**{k: j(f[k]) for k in PLANES})
    state = jax_ho.HOVelocityState(u=field(d["u"]), v=field(d["v"]), s11=j(d["s11"]), s22=j(d["s22"]),
                                   s12=j(d["s12"]))
    forcing = jax_ho.HODynamicsForcing(**{k: field(d[k]) for k in FORCING})
    return state, j(d["h"]), j(d["a"]), forcing


@functools.lru_cache(maxsize=None)
def jax_ho_step(kind: str, n_sub: int = N_SUB, weighted: bool = False, shape=None, h: int = 4) -> tuple:
    """The JAX package's HO step on the seeded inputs: its single-domain
    "xla" solver (``shape`` None), or its "blocked" schedule under
    ``shard_map`` on a uniform mesh's ``RectMesh`` blocks."""
    mesh = mesh_of(kind, side="jax")
    params = JaxMEVPParams(a_weighted_stress=weighted)
    args = _jax_leaves(ho_inputs())
    if shape is None:
        solver = jax_ho.MEVPSolverHO(mesh, params, backend="xla")
        return flat(solver.step(*args, solver.boundary_mask(jnp.float64), DT, n_sub))
    px, py = shape
    local = JaxRectMesh(nx=N // px, ny=N // py, dx=mesh.dx, dy=mesh.dy,
                        periodic_x=mesh.periodic_x, periodic_y=mesh.periodic_y)
    solver = jax_ho.MEVPSolverHO(local, params, backend="blocked", spmd=("X", "Y"), block_halo=h)

    def spec_of(leaf):
        return P(*([None] * (np.ndim(leaf) - 2) + ["X", "Y"]))

    def step(s, hh, aa, f):
        return solver.step(s, hh, aa, f, solver.boundary_mask(jnp.float64), DT, n_sub)

    state, hh, aa, forcing = args
    mapped = jax.shard_map(
        step, mesh=make_spatial_mesh(shape),
        in_specs=(jax.tree.map(spec_of, state), P("X", "Y"), P("X", "Y"), jax.tree.map(spec_of, forcing)),
        out_specs=jax.tree.map(spec_of, state), check_vma=False,
    )
    return flat(jax.jit(mapped)(*args))


# -- the port --------------------------------------------------------------------------
def _port_leaves(d):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    field = lambda f: mevp_ho.HOField(**{k: t(f[k]) for k in PLANES})
    state = mevp_ho.HOVelocityState(u=field(d["u"]), v=field(d["v"]), s11=t(d["s11"]), s22=t(d["s22"]),
                                    s12=t(d["s12"]))
    forcing = mevp_ho.HODynamicsForcing(**{k: field(d[k]) for k in FORCING})
    return state, t(d["h"]), t(d["a"]), forcing


def block_of(mesh, shape, coords):
    """A rank's block as ``build_sharded_coupled_model`` makes it."""
    px, py = shape
    if mesh.uniform:
        return RectMesh(mesh.nx // px, mesh.ny // py, mesh.dx, mesh.dy,
                        periodic_x=mesh.periodic_x, periodic_y=mesh.periodic_y)
    return LocalMeshView(mesh, px, py, coords)


@functools.lru_cache(maxsize=None)
def port_ho_step(kind: str, n_sub: int = N_SUB, weighted: bool = False, backend=None, shape=(2, 2),
                 h=4) -> tuple:
    """The port's HO step on the seeded inputs: its single domain
    (``backend`` None) or a rank grid of ``shape`` on ``backend``."""
    mesh = mesh_of(kind)
    params = MEVPParams(a_weighted_stress=weighted)
    state, hh, aa, forcing = _port_leaves(ho_inputs())

    def step(solver, s, hb, ab, f):
        return solver.step(s, hb, ab, f, solver.boundary_mask(device="cpu", dtype=torch.float64), DT, n_sub)

    if backend is None:
        return flat(step(mevp_ho.MEVPSolverHO(mesh, params), state, hh, aa, forcing))
    grid = RankGrid(*shape, "cpu", timeout=TIMEOUT)
    grid.periodic = (mesh.periodic_x, mesh.periodic_y)
    parts = [grid.split_tree(x) for x in (state, hh, aa, forcing)]

    def body(rank):
        solver = mevp_ho.MEVPSolverHO(block_of(mesh, shape, rank.coords), params, backend=backend,
                                      spmd=rank.axes, block_halo=h)
        return step(solver, *(p[rank.rank] for p in parts))

    return flat(grid.gather_tree(run_ranks(grid.ring, body)))


def port_single(kind: str, n_sub: int = N_SUB, weighted: bool = False) -> tuple:
    return port_ho_step(kind, n_sub, weighted)


def check(got, kind, n_sub=N_SUB, weighted=False, jax_ref=None):
    """``got`` equals the port's single domain exactly and the JAX
    package's (``jax_ref``, default its single domain) within 1e-8."""
    jax_ref = jax_ho_step(kind, n_sub, weighted) if jax_ref is None else jax_ref
    for i, (g, s, r) in enumerate(zip(got, port_single(kind, n_sub, weighted), jax_ref)):
        np.testing.assert_array_equal(g, s, err_msg=f"plane {i}")
        assert_planes_close(g, r, 1e-8, f"plane {i}")


# -- the exchange forms of the node machinery ---------------------------------------
@pytest.mark.parametrize("kind", ["uniform", "periodic", "ring"])
def test_node_machinery_and_masks_through_the_exchange_equal_one_domain(kind):
    """gather_local, scatter_local, from_vertex_field, ho_velocity_to_quad
    and boundary_mask on a 4 x 2 grid equal the single domain's slices."""
    from nextsimdg_tpu_torch.dynamics import dg_basis

    mesh = mesh_of(kind, 16)
    d = ho_inputs(16, seed=3)
    state = _port_leaves(d)[0]
    one = mevp_ho.MEVPSolverHO(mesh)
    basis = dg_basis(1)
    qv = mevp_ho.ho_velocity_to_quad(mesh, basis, state.u, state.v)
    ref = (one.gather_local(state.u), *one.scatter_local(one.gather_local(state.v)).planes(),
           *mevp_ho.HOField.from_vertex_field(state.u.v, mesh.periodic_x, mesh.periodic_y).planes(),
           qv.vx_vol, qv.vn_x, qv.vn_y, *one.boundary_mask(device="cpu", dtype=torch.float64).planes())
    grid = RankGrid(4, 2, "cpu", timeout=TIMEOUT)
    grid.periodic = (mesh.periodic_x, mesh.periodic_y)
    parts = grid.split_tree(state)

    def body(rank):
        solver = mevp_ho.MEVPSolverHO(block_of(mesh, (4, 2), rank.coords), spmd=rank.axes)
        s = parts[rank.rank]
        q = mevp_ho.ho_velocity_to_quad(solver.mesh, basis, s.u, s.v, rank.axes)
        return (solver.gather_local(s.u), *solver.scatter_local(solver.gather_local(s.v)).planes(),
                *mevp_ho.HOField.from_vertex_field(s.u.v, mesh.periodic_x, mesh.periodic_y, rank.axes).planes(),
                q.vx_vol, q.vn_x, q.vn_y, *solver.boundary_mask(device="cpu", dtype=torch.float64).planes())

    out = run_ranks(grid.ring, body)
    for i, r in enumerate(ref):
        assert torch.equal(grid.gather([o[i] for o in out]), r), i


# -- the exchange schedules -----------------------------------------------------------
@pytest.mark.parametrize("backend, shape, h", [("xla", (2, 2), 4), ("blocked", (4, 2), 4), ("blocked", (2, 2), 5)])
def test_ho_blocked_halo_exchange_matches_per_subcycle(backend, shape, h):
    """The uniform template: 12 subcycles per-subcycle, and blocked at h =
    4 (rounds of 4) on 4 x 2 ranks and 5 (5 + 5 + 2) on 2 x 2."""
    check(port_ho_step("uniform", backend=backend, shape=shape, h=h), "uniform")


def test_ho_blocked_matches_jax_blocked_under_shard_map():
    """The literal twin: JAX's blocked schedule on the 4 x 2 device mesh,
    whose widened block runs its plain subcycle on the CPU."""
    got = port_ho_step("uniform", backend="blocked", shape=(4, 2), h=4)
    check(got, "uniform", jax_ref=jax_ho_step("uniform", shape=(4, 2), h=4))


def test_ho_blocked_periodic_matches_per_subcycle():
    """Both axes periodic: the strips wrap round the rings of ranks, four
    in x (blocked, rounds of 4) and two (per subcycle)."""
    got = port_ho_step("periodic", backend="blocked", shape=(4, 2))
    xla = port_ho_step("periodic", backend="xla")
    for g, x in zip(got, xla):
        np.testing.assert_array_equal(g, x)
    check(got, "periodic")


@pytest.mark.parametrize("backend", ["xla", "blocked"])
@pytest.mark.parametrize("kind", ["graded", "spherical"])
def test_mevp_ho_blocked_nonuniform_matches_single_device(kind, backend):
    """A ``LocalMeshView`` a rank: the four width planes ride the consts
    and widen with them (zeros beyond a closed wall)."""
    check(port_ho_step(kind, backend=backend), kind)


@pytest.mark.parametrize("backend, shape", [("xla", (2, 2)), ("blocked", (4, 2))])
def test_mevp_ho_blocked_ring_spherical_matches_single_device(backend, shape):
    """The 360 degree ring: x wraps round two ranks, and four."""
    check(port_ho_step("ring", backend=backend, shape=shape), "ring")


def test_a_weighted_ho_on_a_grid_matches_one_domain():
    """The A-weighted form (the four a_{k} const planes widened with the
    others) on a graded mesh: the blocked schedule equals the per-subcycle
    one and the single domain exactly, and JAX's within 1e-8."""
    got = port_ho_step("graded", weighted=True, backend="blocked")
    for g, x in zip(got, port_ho_step("graded", weighted=True, backend="xla")):
        np.testing.assert_array_equal(g, x)
    check(got, "graded", weighted=True)


# -- what raises ---------------------------------------------------------------------
def test_ho_rank_grid_schedules_and_halo_are_checked(monkeypatch):
    grid = RankGrid(2, 2, "cpu")
    block = RectMesh(8, 8, 4e3, 4e3)
    # The rdma schedule builds since M10b part 2b (tests/test_torch_grid_ho_rdma.py).
    assert mevp_ho.MEVPSolverHO(block, backend="rdma", spmd=grid.ranks[0].axes).schedule() == "rdma"
    with pytest.raises(ValueError, match="backend"):
        mevp_ho.MEVPSolverHO(block, backend="blocked")  # no rank grid
    with pytest.raises(ValueError, match="block_halo"):
        mevp_ho.MEVPSolverHO(block, spmd=grid.ranks[0].axes, block_halo=9)
    solver = mevp_ho.MEVPSolverHO(RectMesh(64, 64, 4e3, 4e3), spmd=grid.ranks[0].axes)
    assert (solver.schedule(), solver.block_halo) == ("blocked", BLOCK_HALO)
    # The width-1 exchange runs the HO half kernels on a card (since M10d):
    # on tensors off the CPU (the CPU check answers as for CUDA tensors) it
    # checks the consts before any launch.
    xla = mevp_ho.MEVPSolverHO(block, backend="xla", spmd=grid.ranks[0].axes)
    carry = tuple(_port_leaves(ho_inputs(8))[0].__dict__.values())
    monkeypatch.setattr(cc, "_on_cpu", lambda t: False)
    calls = []
    monkeypatch.setattr(cc, "_launch", lambda *args, **kwargs: calls.append(args))
    with pytest.raises(NotImplementedError, match="HO kernels take the consts"):
        xla.spmd_subcycles(carry, {}, DT, 1)
    assert calls == []
