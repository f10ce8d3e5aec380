"""The mEVP's width-1 ("xla") schedule on a rank grid: the port against the JAX package.

At float64 on the CPU, the same seeded numpy inputs go through the JAX
package's mEVP solvers (CG1 and HO: one single-domain subcycle, and their
``shard_map`` "xla" step on the 8-device CPU mesh of ``tests/conftest.py``)
and through the port: the plain versions of the four halves that the
route launches on a card (``coupled_cuda.mevp_stress_halo_reference``,
``mevp_velocity_halo_reference``, ``ho_stress_halo_reference`` and
``ho_velocity_halo_reference``) on a rank block and its neighbours'
strips, and the route itself (``coupled_cuda.spmd_xla_subcycles`` and
``spmd_xla_ho_subcycles``) on ``nextsimdg_tpu_torch.parallel``'s rank
grid, whose CPU tensors run those plain versions: a 2 x 2 uniform box, a
spherical window's ``LocalMeshView`` blocks, the 360 degree ring on a ring
of ranks and with its periodic axis on one rank, a land mask, and the
A-weighted (CG1 and HO) and adaptive (CG1) forms.

Tolerances: 1e-8 of each plane's max against the JAX package after 15
subcycles (XLA fuses the subcycle differently, and the shared divide
amplifies an ulp; ROADMAP's notes on tolerances), 1e-12 after one half;
exactly 0 between the route and the port's single domain and its blocked
schedule on the same grid (the same operations on the same values).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics import mevp as jax_mevp
from nextsimdg_tpu.dynamics import mevp_ho as jax_ho
from nextsimdg_tpu.dynamics.mesh import LocalMeshView as JaxLocalMeshView
from nextsimdg_tpu.dynamics.mesh import SphericalMesh as JaxSphericalMesh
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu_torch.dynamics import RectMesh, SphericalMesh, mevp, mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.mesh import LocalMeshView
from nextsimdg_tpu_torch.parallel import RankGrid, run_ranks

torch.set_num_threads(1)

N = 16
DT = 600.0
N_SUB = 15
TIMEOUT = 60.0
PLANES = ("v", "b", "l", "c")
VELOCITY = ("u", "v", "s11", "s22", "s12")
FORCING = ("u_atm", "v_atm", "u_ocean", "v_ocean")


def mesh_of(kind: str, side: str = "port"):
    """The global N x N mesh ``kind``: "uniform" (closed), "spherical" (the
    lon-lat window 20W-20E, 60N-80N) or "ring" (the 360 degree ring at
    55N-75N, periodic in x), as the JAX templates build them."""
    if kind == "uniform":
        return RectMesh(N, N, 512e3 / N, 512e3 / N) if side == "port" else JaxRectMesh(
            nx=N, ny=N, dx=512e3 / N, dy=512e3 / N)
    lon, lat = ((-20.0, 20.0), (60.0, 80.0)) if kind == "spherical" else ((0.0, 360.0), (55.0, 75.0))
    if side == "port":
        return SphericalMesh(N, N, lon[0], lon[1], lat[0], lat[1], periodic_x=kind == "ring")
    return JaxSphericalMesh(nx=N, ny=N, lon0=lon[0], lon1=lon[1], lat0=lat[0], lat1=lat[1],
                            periodic_x=kind == "ring")


def land_mask() -> np.ndarray:
    """1 on the ocean, 0 on a rectangle of land across the ranks' edges."""
    land = np.ones((N, N))
    land[5:11, 3:9] = 0.0
    return land


def inputs(ho: bool, seed: int = 0) -> dict:
    """Global numpy leaves: a moving velocity (CG1 nodes or CG2 planes) and
    stresses (per element, or 3 dG1 coefficients), h (a corner of light
    ice, held at rest), A and a sheared forcing."""
    rng = np.random.default_rng(seed)
    field = (lambda s, m=0.0: {k: m + rng.normal(0.0, s, (N, N)) for k in PLANES}) if ho else (
        lambda s, m=0.0: m + rng.normal(0.0, s, (N, N)))
    stress = (3, N, N) if ho else (N, N)
    h = rng.uniform(0.5, 2.5, (N, N))
    h[: N // 4, : N // 3] = 1e-4
    return dict(
        u=field(0.2), v=field(0.2), s11=rng.normal(0.0, 500.0, stress), s22=rng.normal(0.0, 500.0, stress),
        s12=rng.normal(0.0, 200.0, stress), h=h, a=rng.uniform(0.02, 1.0, (N, N)),
        u_atm=field(1.0, 10.0), v_atm=field(0.5, 3.0), u_ocean=field(0.01, 0.02), v_ocean=field(0.01),
    )


def assert_planes_close(got, ref, rtol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def flat(out) -> tuple:
    """A step's planes as numpy: CG1 (u, v, s11, s22, s12); HO u's and v's
    four planes, then the stresses' 3 coefficients each."""
    if isinstance(out.u, (mevp_ho.HOField, jax_ho.HOField)):
        return tuple(np.asarray(x) for x in (
            *(getattr(out.u, k) for k in PLANES), *(getattr(out.v, k) for k in PLANES),
            *out.s11, *out.s22, *out.s12))
    return tuple(np.asarray(getattr(out, k)) for k in VELOCITY)


# -- the JAX package ---------------------------------------------------------------------
def _jax_leaves(d, ho: bool):
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    if ho:
        field = lambda f: jax_ho.HOField(**{k: j(f[k]) for k in PLANES})
        state = jax_ho.HOVelocityState(u=field(d["u"]), v=field(d["v"]), s11=j(d["s11"]), s22=j(d["s22"]),
                                       s12=j(d["s12"]))
        return state, j(d["h"]), j(d["a"]), jax_ho.HODynamicsForcing(**{k: field(d[k]) for k in FORCING})
    state = jax_mevp.VelocityState(*(j(d[k]) for k in VELOCITY))
    return state, j(d["h"]), j(d["a"]), jax_mevp.DynamicsForcing(*(j(d[k]) for k in FORCING))


def _jax_mask(solver, ho: bool, land):
    """The solver's boundary mask times the land mask (block or global)."""
    mask = solver.boundary_mask(jnp.float64)
    if land is None:
        return mask
    return jax_ho.HOField(*(getattr(mask, k) * land for k in PLANES)) if ho else mask * land


def _jax_solver(ho: bool, mesh, params, **kwargs):
    return (jax_ho.MEVPSolverHO if ho else jax_mevp.MEVPSolver)(mesh, params, **kwargs)


@functools.lru_cache(maxsize=None)
def jax_subcycle(kind: str, ho: bool, weighted: bool = False, adaptive: bool = False) -> tuple:
    """The JAX package's single-domain solver on the seeded inputs: its
    step consts and one subcycle, as numpy ((consts), (carry after))."""
    mesh = mesh_of(kind, "jax")
    solver = _jax_solver(ho, mesh, jax_mevp.MEVPParams(a_weighted_stress=weighted, adaptive_alpha=adaptive),
                         backend="xla")
    state, h, a, forcing = _jax_leaves(inputs(ho), ho)
    consts = solver.step_consts(state, h, a, forcing, solver.boundary_mask(jnp.float64), DT)
    out = solver.subcycle_body((state.u, state.v, state.s11, state.s22, state.s12), consts, DT)
    consts = {k: np.asarray(v) for k, v in consts.items()}
    if ho:
        out = jax_ho.HOVelocityState(*out)
    else:
        out = jax_mevp.VelocityState(*out)
    return consts, flat(out)


@functools.lru_cache(maxsize=None)
def jax_xla_step(kind: str, ho: bool, shape, weighted=False, adaptive=False, land=False) -> tuple:
    """The JAX package's "xla" step under ``shard_map`` on a device mesh of
    ``shape`` (``RectMesh`` blocks of a uniform mesh, else
    ``LocalMeshView``s), N_SUB subcycles, as numpy planes."""
    mesh = mesh_of(kind, "jax")
    params = jax_mevp.MEVPParams(a_weighted_stress=weighted, adaptive_alpha=adaptive)
    px, py = shape
    spmd = ("X" if px > 1 or py == 1 else None, "Y" if py > 1 else None)
    if mesh.uniform:
        local = JaxRectMesh(nx=N // px, ny=N // py, dx=mesh.dx, dy=mesh.dy,
                            periodic_x=mesh.periodic_x, periodic_y=mesh.periodic_y)
    else:
        local = JaxLocalMeshView(mesh, px, py)
    solver = _jax_solver(ho, local, params, backend="xla", spmd=spmd)
    state, h, a, forcing = _jax_leaves(inputs(ho), ho)
    mask = jnp.asarray(land_mask() if land else np.ones((N, N)))

    def spec_of(leaf):
        return P(*([None] * (np.ndim(leaf) - 2) + list(spmd)))

    def step(s, hh, aa, f, m):
        return solver.step(s, hh, aa, f, _jax_mask(solver, ho, m), DT, N_SUB)

    mapped = jax.shard_map(
        step, mesh=make_spatial_mesh(shape),
        in_specs=(jax.tree.map(spec_of, state), spec_of(h), spec_of(a), jax.tree.map(spec_of, forcing),
                  spec_of(mask)),
        out_specs=jax.tree.map(spec_of, state), check_vma=False,
    )
    return flat(jax.jit(mapped)(state, h, a, forcing, mask))


# -- the port --------------------------------------------------------------------------
def _port_leaves(d, ho: bool):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if ho:
        field = lambda f: mevp_ho.HOField(**{k: t(f[k]) for k in PLANES})
        state = mevp_ho.HOVelocityState(u=field(d["u"]), v=field(d["v"]), s11=t(d["s11"]), s22=t(d["s22"]),
                                        s12=t(d["s12"]))
        return state, t(d["h"]), t(d["a"]), mevp_ho.HODynamicsForcing(**{k: field(d[k]) for k in FORCING})
    return (mevp.VelocityState(*(t(d[k]) for k in VELOCITY)), t(d["h"]), t(d["a"]),
            mevp.DynamicsForcing(*(t(d[k]) for k in FORCING)))


def block_of(mesh, shape, coords):
    """A rank's block as ``build_sharded_coupled_model`` makes it."""
    px, py = shape
    if mesh.uniform:
        return RectMesh(mesh.nx // px, mesh.ny // py, mesh.dx, mesh.dy,
                        periodic_x=mesh.periodic_x, periodic_y=mesh.periodic_y)
    return LocalMeshView(mesh, px, py, coords)


def _port_mask(solver, ho: bool, land):
    mask = solver.boundary_mask(device="cpu", dtype=torch.float64)
    if land is None:
        return mask
    return mevp_ho.HOField(*(plane * land for plane in mask.planes())) if ho else mask * land


@functools.lru_cache(maxsize=None)
def port_step(kind: str, ho: bool, backend=None, shape=(2, 2), weighted=False, adaptive=False,
              land=False) -> tuple:
    """The port's step on the seeded inputs: its single domain (``backend``
    None) or a rank grid of ``shape`` on ``backend``, N_SUB subcycles."""
    mesh = mesh_of(kind)
    params = mevp.MEVPParams(a_weighted_stress=weighted, adaptive_alpha=adaptive)
    leaves = _port_leaves(inputs(ho), ho)
    mask = torch.from_numpy(land_mask()) if land else None
    cls = mevp_ho.MEVPSolverHO if ho else mevp.MEVPSolver

    def step(solver, state, h, a, forcing, land_block):
        return solver.step(state, h, a, forcing, _port_mask(solver, ho, land_block), DT, N_SUB)

    if backend is None:
        return flat(step(cls(mesh, params), *leaves, mask))
    grid = RankGrid(*shape, "cpu", timeout=TIMEOUT)
    grid.periodic = (mesh.periodic_x, mesh.periodic_y)
    parts = [grid.split_tree(x) for x in (*leaves, mask)]

    def body(rank):
        solver = cls(block_of(mesh, shape, rank.coords), params, backend=backend, spmd=rank.axes, block_halo=3)
        return step(solver, *(p[rank.rank] for p in parts))

    return flat(grid.gather_tree(run_ranks(grid.ring, body)))


def check_step(kind, ho, shape, **form):
    """The port's xla route on a rank grid of ``shape``: exactly its single
    domain and its blocked schedule, and JAX's shard_map "xla" step to
    1e-8 of each plane's max."""
    got = port_step(kind, ho, "xla", shape, **form)
    single = port_step(kind, ho, **form)
    blocked = port_step(kind, ho, "blocked", shape, **form)
    ref = jax_xla_step(kind, ho, shape, **form)
    for n, (g, s, b, r) in enumerate(zip(got, single, blocked, ref)):
        np.testing.assert_array_equal(g, s, err_msg=f"plane {n} vs the single domain")
        np.testing.assert_array_equal(g, b, err_msg=f"plane {n} vs blocked")
        assert_planes_close(g, r, 1e-8, f"plane {n} vs JAX")


# -- the plain halves on a block and its strips ----------------------------------------------
def widened(f, periodic):
    """Global (C, N, N) planes widened by one ring: zeros beyond a closed
    wall, the wrapped cells on a periodic axis."""
    pad = [(0, 0), (1, 1), (1, 1)]
    f = np.pad(f, pad)
    if periodic[0]:
        f[:, 0, :], f[:, -1, :] = f[:, -2, :], f[:, 1, :]
    if periodic[1]:
        f[:, :, 0], f[:, :, -1] = f[:, :, -2], f[:, :, 1]
    return f


def strips(f, coords, block, periodic):
    """(plus, minus) strips of the global planes ``f`` (C, N, N) for the
    block at ``coords``: what ``stencil.plus_strips`` and ``minus_strips``
    bring through the exchange (x then extended y: the corners from the
    diagonal block)."""
    (ix, iy), (bx, by) = coords, block
    w = widened(f, periodic)[:, ix * bx: ix * bx + bx + 2, iy * by: iy * by + by + 2]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    plus = (t(w[:, bx + 1, 1: by + 1]), t(w[:, 1: bx + 2, by + 1]))
    minus = (t(w[:, 0, 1: by + 1]), t(w[:, 0: bx + 1, 0]))
    return plus, minus


HALF_CASES = [
    ("uniform", (1, 0), {}), ("spherical", (0, 1), {"weighted": True}),
    ("ring", (0, 0), {"adaptive": True}), ("ring", (1, 1), {"weighted": True, "adaptive": True}),
]


@pytest.mark.parametrize("kind, coords, form", HALF_CASES)
def test_cg1_plain_halves_equal_jax_on_a_block(kind, coords, form):
    """mevp_stress's and mevp_velocity's halo forms' plain versions on a
    rank block of a 2 x 2 grid, fed the block of JAX's consts and state
    and the strips of the global state (the stress half's of u and v, the
    velocity half's of JAX's new stresses, and on a metric mesh of
    half_dx and half_dy), against JAX's single-domain subcycle on the
    block."""
    consts, after = jax_subcycle(kind, False, **form)
    d = inputs(False)
    mesh = mesh_of(kind)
    solver = mevp.MEVPSolver(block_of(mesh, (2, 2), coords),
                             mevp.MEVPParams(a_weighted_stress=form.get("weighted", False),
                                             adaptive_alpha=form.get("adaptive", False)))
    block, periodic = (N // 2, N // 2), (mesh.periodic_x, mesh.periodic_y)
    own = lambda f: torch.from_numpy(np.ascontiguousarray(
        f[coords[0] * block[0]: (coords[0] + 1) * block[0], coords[1] * block[1]: (coords[1] + 1) * block[1]]))
    consts_b = {k: own(v) for k, v in consts.items()}
    carry = tuple(own(d[k]) for k in VELOCITY)
    plus, _ = strips(np.stack([d["u"], d["v"]]), coords, block, periodic)
    s11, s22, s12, *nodes = cc.mevp_stress_halo_reference(solver, carry, consts_b, *plus)
    for name, g, r in zip(("s11", "s22", "s12"), (s11, s22, s12), after[2:]):
        assert_planes_close(g.numpy(), own(r).numpy(), 1e-12, name)
    _, minus = strips(np.stack(after[2:]), coords, block, periodic)
    metric = (None, None)
    if not mesh.uniform:
        metric = strips(np.stack([consts["half_dx"], consts["half_dy"]]), coords, block, periodic)[1]
    stresses = tuple(own(r) for r in after[2:])
    u, v = cc.mevp_velocity_halo_reference(solver, (*carry[:2], *stresses), consts_b, nodes[0], nodes[1], DT,
                                           *minus, *metric, *nodes[2:])
    for name, g, r in zip("uv", (u, v), after[:2]):
        assert_planes_close(g.numpy(), own(r).numpy(), 1e-12, name)


@pytest.mark.parametrize("kind, coords, form", [c for c in HALF_CASES if "adaptive" not in c[2]] + [
    ("ring", (0, 0), {})])
def test_ho_plain_halves_equal_jax_on_a_block(kind, coords, form):
    """ho_stress's and ho_velocity's plain versions on a rank block's 17
    planes and the strips of the global state (the 8 velocity planes', then
    JAX's new 9 stress planes', and on a metric mesh of dx and dy) against
    JAX's single-domain HO subcycle on the block."""
    consts, after = jax_subcycle(kind, True, **form)
    mesh = mesh_of(kind)
    solver = mevp_ho.MEVPSolverHO(block_of(mesh, (2, 2), coords),
                                  mevp.MEVPParams(a_weighted_stress=form.get("weighted", False)))
    block, periodic = (N // 2, N // 2), (mesh.periodic_x, mesh.periodic_y)
    cut = lambda f: f[..., coords[0] * block[0]: (coords[0] + 1) * block[0],
                      coords[1] * block[1]: (coords[1] + 1) * block[1]]
    own = lambda f: torch.from_numpy(np.ascontiguousarray(cut(f)))
    consts_b = {k: own(v) for k, v in consts.items()}
    d = inputs(True)
    before = np.stack([d["u"][k] for k in PLANES] + [d["v"][k] for k in PLANES]
                      + [*d["s11"], *d["s22"], *d["s12"]])
    plus, _ = strips(before[:8], coords, block, periodic)
    state = cc.ho_stress_halo_reference(solver, own(before), consts_b, *plus)
    for q in range(8, 17):
        assert_planes_close(state[q].numpy(), cut(after[q]), 1e-12, f"stress plane {q}")
    after_stress = np.stack(list(before[:8]) + list(after[8:]))
    _, minus = strips(after_stress[8:], coords, block, periodic)
    widths = (None, None)
    if not mesh.uniform:
        widths = strips(np.stack([consts["dx"], consts["dy"]]), coords, block, periodic)[1]
    state = cc.ho_velocity_halo_reference(solver, own(after_stress), consts_b, DT, *minus, *widths)
    for q in range(8):
        assert_planes_close(state[q].numpy(), cut(after[q]), 1e-12, f"velocity plane {q}")


# -- the route: N_SUB subcycles on the rank grid ------------------------------------------------
STEP_CASES = [
    ("uniform", (2, 2), {}),                     # the 2 x 2 box
    ("spherical", (2, 2), {"weighted": True}),   # LocalMeshView blocks, A-weighted
    ("ring", (2, 2), {}),                        # the ring of ranks
    ("ring", (1, 2), {}),                        # the ring's axis on one rank
    ("uniform", (2, 2), {"land": True}),         # a land mask across the ranks' edges
]


@pytest.mark.parametrize("kind, shape, form", STEP_CASES + [("uniform", (2, 2), {"adaptive": True}),
                                                           ("spherical", (2, 1), {"adaptive": True})])
def test_cg1_xla_route_equals_jax_shard_map(kind, shape, form):
    check_step(kind, False, shape, **form)


@pytest.mark.parametrize("kind, shape, form", STEP_CASES + [("uniform", (2, 2), {"weighted": True})])
def test_ho_xla_route_equals_jax_shard_map(kind, shape, form):
    check_step(kind, True, shape, **form)


def test_route_runs_the_halves_behind_width_one_strips(monkeypatch):
    """On the CPU the route runs the four plain halves (two a subcycle) and
    exchanges one strip a half and axis: 4 exchanges a rank and subcycle
    (on a metric mesh the consts' strips besides, once a step)."""
    import threading

    from nextsimdg_tpu_torch.parallel.exchange import AxisExchange

    called, starts, inside = [], [], threading.local()
    for name in ("mevp_stress_halo_reference", "mevp_velocity_halo_reference", "ho_stress_halo_reference",
                 "ho_velocity_halo_reference"):
        real = getattr(cc, name)
        monkeypatch.setattr(cc, name, lambda *a, _real=real, _name=name, **k: called.append(_name) or _real(*a, **k))
    for name in ("spmd_xla_subcycles", "spmd_xla_ho_subcycles"):
        real = getattr(cc, name)

        def route(*a, _real=real, **k):
            inside.on = True
            try:
                return _real(*a, **k)
            finally:
                inside.on = False

        monkeypatch.setattr(cc, name, route)
    start = AxisExchange.start

    def counted(self, *a):
        if getattr(inside, "on", False):
            starts.append(self.axis)
        return start(self, *a)

    monkeypatch.setattr(AxisExchange, "start", counted)
    port_step.cache_clear()
    try:
        port_step("uniform", False, "xla", (2, 2))
        port_step("spherical", True, "xla", (2, 2))
    finally:
        port_step.cache_clear()
    for half in ("mevp_stress", "mevp_velocity", "ho_stress", "ho_velocity"):
        assert called.count(half + "_halo_reference") == 4 * N_SUB, half
    assert len(called) == 16 * N_SUB
    # Two steps of four ranks: two strips (x, y) a half; the HO step on the
    # spherical mesh also the widths' strips once (x and y).
    assert starts.count(0) == starts.count(1) == 2 * 4 * 2 * N_SUB + 4
