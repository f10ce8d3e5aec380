"""The coupled step with the HO (CG2/dG1) solver on a rank grid: the port
against the JAX package.

At float64 on the CPU, the same seeded numpy state (a CG2 velocity and dG1
stresses) and forcing go through the JAX package's single-domain coupled
step with ``Nextsim::MEVPHighOrder`` selected and through the port's
``build_sharded_coupled_model``, whose ranks are threads of this process:
the HO mEVP on the blocked and width-1 schedules, the CG2 velocity sampled
at the quadrature points through the exchange, k agreed over the ranks,
and the transport on the spmd tiled wrapper with the widened samples
(``qv``) or staged with width-1 exchanges, with physics, on uniform
(closed and periodic), graded (A-weighted), spherical (with the coastline:
config 5's shape) and ring meshes, and with the TVB limiter (the card's
route of which ``test_ho_with_tvb_on_a_grid_is_refused_on_a_card`` drives
with its launches recorded). Twins of ``tests/test_shardmap.py``'s
``test_shardmap_ho_coupled_step_matches_single_device`` and
``test_shardmap_tiled_transport_ho_matches_staged`` and
``tests/test_shardmap_metric.py``'s
``test_shardmap_coupled_ho_spherical_matches_single_device``.

Tolerances: exactly 0 between the port's grid and its single domain, and
between its schedules; 1e-10 of each plane's max against the JAX package
on a coupled step, as the JAX templates and
``tests/test_torch_grid_metric.py`` hold theirs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.coupled import CoupledState as JaxCoupledState
from nextsimdg_tpu.dynamics import mevp_ho as jax_ho
from nextsimdg_tpu.dynamics.landmask import synthetic_coastline as jax_synthetic_coastline
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing as JaxDynamicsForcing
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu.state import Forcing as JaxForcing
from nextsimdg_tpu_torch import interop, modules
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import synthetic_coastline
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.mevp import MEVPParams
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model
from test_torch_grid_ho import PLANES, assert_planes_close, mesh_of

torch.set_num_threads(1)

N = 16
DT = 600.0
HO = ("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
TRACERS = ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice")
TIMEOUT = 60.0


def coupled_inputs(n: int = N, seed: int = 0):
    """A global HO CoupledState, physics forcing and dynamics forcing as
    numpy."""
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([rng.uniform(lo, hi, (1, n, n)), rng.normal(0.0, 0.05 * hi, (2, n, n))])
    field = lambda scale: {k: rng.normal(0.0, scale, (n, n)) for k in PLANES}
    velocity = dict(u=field(0.3), v=field(0.3), s11=rng.normal(0.0, 500.0, (3, n, n)),
                    s22=rng.normal(0.0, 500.0, (3, n, n)), s12=rng.normal(0.0, 200.0, (3, n, n)))
    state = dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.3, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=np.full((n, n), -1.6), sss=np.full((n, n), 32.0), tice=np.full((1, n, n), -5.0),
        new_ice=np.zeros((n, n)), velocity=velocity,
    )
    full = lambda v: np.full((n, n), v)
    phys = dict(tair=-10.0 + rng.normal(0.0, 1.0, (n, n)), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    dyn = dict(u_atm=8.0 + rng.normal(0.0, 1.0, (n, n)), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    return state, phys, dyn


def flat_state(d: dict) -> dict:
    """A numpy CoupledState with its HO velocity's planes as flat keys."""
    out = {k: d[k] for k in TRACERS}
    v = d["velocity"]
    out.update({f"{q}.{k}": v[q][k] for q in ("u", "v") for k in PLANES})
    out.update({q: v[q] for q in ("s11", "s22", "s12")})
    return out


@functools.lru_cache(maxsize=None)
def jax_coupled(kind: str, coast: bool = False, weighted: bool = False, **kwargs) -> dict:
    """The JAX package's single-domain HO coupled step on the seeded inputs
    (``weighted``: ``a_weighted_stress``)."""
    state, phys, dyn = coupled_inputs()
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    field = lambda f: jax_ho.HOField(**{k: j(f[k]) for k in PLANES})
    v = state["velocity"]
    velocity = jax_ho.HOVelocityState(u=field(v["u"]), v=field(v["v"]), s11=j(v["s11"]), s22=j(v["s22"]),
                                      s12=j(v["s12"]))
    loader = JaxModuleRegistry.get_loader()
    loader.set_implementation(*HO)
    try:
        model = JaxCoupledModel(mesh_of(kind, N, "jax"), degree=1, n_subcycles=10,
                                mevp_params=JaxMEVPParams(a_weighted_stress=weighted),
                                ocean_mask=jax_synthetic_coastline(N) if coast else None, **kwargs)
        out = model.step(
            JaxCoupledState(velocity=velocity, **{k: j(x) for k, x in state.items() if k != "velocity"}),
            JaxForcing(**{k: j(x) for k, x in phys.items()}),
            JaxDynamicsForcing(**{k: j(x) for k, x in dyn.items()}), dt=DT,
        )
    finally:
        loader.reset()
    return flat_state(interop.coupled_state_to_numpy(out))


def port_coupled(kind: str, shape=None, coast: bool = False, weighted: bool = False, **kwargs):
    """(model, the port's HO coupled step as flat numpy): its single domain
    (``shape`` None) or a rank grid of ``shape`` (rank 0's model)."""
    ocean = synthetic_coastline(N) if coast else None
    kwargs["mevp_params"] = MEVPParams(a_weighted_stress=weighted)
    state, phys, dyn = coupled_inputs()
    mesh = mesh_of(kind, N)
    loader = modules.get_loader()
    loader.set_implementation(*HO)
    try:
        if shape is None:
            model = CoupledModel(mesh, n_subcycles=10, ocean_mask=ocean, **kwargs)
            t = lambda f, d: f(d, device="cpu", dtype=torch.float64)
            out = model.step(t(interop.coupled_state_from_numpy, state), t(interop.forcing_from_numpy, phys),
                             t(interop.dynamics_forcing_from_numpy, dyn), DT)
            return model, flat_state(interop.coupled_state_to_numpy(out))
        grid = RankGrid(*shape, "cpu", timeout=TIMEOUT)
        model, sharded = build_sharded_coupled_model(mesh, grid, n_subcycles=10, ocean_mask=ocean, **kwargs)
    finally:
        loader.reset()
    blocks = sharded.run_blocks(
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float64),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float64),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float64),
        DT, 1,
    )
    return model, flat_state(interop.coupled_state_from_rank_blocks(blocks, grid))


@functools.lru_cache(maxsize=None)
def port_single(kind: str, coast: bool = False, weighted: bool = False, **kwargs) -> dict:
    return port_coupled(kind, coast=coast, weighted=weighted, **kwargs)[1]


def check(got: dict, kind: str, coast: bool = False, weighted: bool = False, **kwargs) -> None:
    """``got`` equals the port's single domain exactly and the JAX
    package's within 1e-10 of each plane's max."""
    single, ref = port_single(kind, coast, weighted, **kwargs), jax_coupled(kind, coast, weighted, **kwargs)
    for name, plane in got.items():
        np.testing.assert_array_equal(plane, single[name], err_msg=name)
        assert_planes_close(plane, ref[name], 1e-10, name)


@pytest.mark.parametrize("backend, shape", [("blocked", (4, 2)), ("xla", (2, 2))])
def test_shardmap_ho_coupled_step_matches_single_device(backend, shape):
    model, got = port_coupled("uniform", shape, mevp_backend=backend, mevp_block_halo=4)
    assert model.is_high_order and model.schedule("cpu") == (backend, "tiled")
    check(got, "uniform")


def test_shardmap_tiled_transport_ho_matches_staged():
    """The spmd tiled transport with the widened CG2 samples equals the
    staged transport with width-1 exchanges and the single domain."""
    model, tiled = port_coupled("uniform", (2, 2), mevp_block_halo=4)
    staged_model, staged = port_coupled("uniform", (2, 2), mevp_block_halo=4, transport_backend="xla")
    assert model.schedule("cpu") == ("blocked", "tiled")
    assert staged_model.schedule("cpu") == ("blocked", "xla")
    for name, plane in tiled.items():
        np.testing.assert_array_equal(plane, staged[name], err_msg=name)
    check(tiled, "uniform")


@pytest.mark.parametrize("kind, shape", [("spherical", (4, 2)), ("ring", (2, 2))])
def test_shardmap_coupled_ho_spherical_matches_single_device(kind, shape):
    """Config 5's shape: the spherical window (and the ring) with the
    synthetic coastline, HO dynamics, the blocked schedule and the spmd
    tiled transport with the widened metric planes and samples."""
    model, got = port_coupled(kind, shape, coast=True, mevp_block_halo=4)
    assert model.schedule("cpu") == ("blocked", "tiled")
    check(got, kind, coast=True)


@pytest.mark.parametrize("kind, weighted", [("graded", True), ("periodic", False)])
def test_ho_coupled_forms_on_a_grid_match_one_domain(kind, weighted):
    """A graded mesh with A-weighted stresses (the widened a_{k} and width
    planes), and a uniform mesh periodic in both axes (rings of ranks)."""
    model, got = port_coupled(kind, (2, 2), weighted=weighted, mevp_block_halo=4)
    assert model.schedule("cpu") == ("blocked", "tiled")
    check(got, kind, weighted=weighted)


def test_ho_with_tvb_on_a_grid_matches_one_domain():
    """HO with the TVB limiter on a uniform grid: the spmd tiled transport
    with the samples and the global walls inside the widened block."""
    model, got = port_coupled("uniform", (2, 2), mevp_block_halo=4, tvb_m=2.0)
    assert model.schedule("cpu") == ("blocked", "tiled")
    check(got, "uniform", tvb_m=2.0)


def card_route(monkeypatch, kind, coast=False, **kwargs):
    """The kernel launches of one HO grid step (2 x 2 ranks, float32 blocks)
    on the card's route, run on the CPU: the CPU check patched to answer
    as it does for CUDA tensors, every ``cc._launch`` recorded as (kernel,
    entry point, arguments) in place of launching, the HO subcycles
    skipped (they return the carry: no kernel of this route) and the plain
    halo forms patched to raise (none may run on the card's path). The
    outputs are the unlaunched kernels' empty buffers and are not read."""
    from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt

    loader = modules.get_loader()
    loader.set_implementation(*HO)
    try:
        grid = RankGrid(2, 2, "cpu", timeout=TIMEOUT)
        model, sharded = build_sharded_coupled_model(mesh_of(kind, N), grid, n_subcycles=2,
                                                     ocean_mask=synthetic_coastline(N) if coast else None,
                                                     **kwargs)
    finally:
        loader.reset()
    state, phys, dyn = coupled_inputs()
    blocks = (
        interop.coupled_state_to_rank_blocks(state, grid, dtype=torch.float32),
        interop.forcing_to_rank_blocks(phys, grid, dtype=torch.float32),
        interop.dynamics_forcing_to_rank_blocks(dyn, grid, dtype=torch.float32),
    )
    calls = []

    def refused(*args, **kw):
        raise AssertionError("a plain halo form ran on the card's path")

    monkeypatch.setattr(cc, "_on_cpu", lambda t: False)
    monkeypatch.setattr(cc, "_launch", lambda name, *args, entry=None: calls.append((name, entry, args)))
    monkeypatch.setattr(cc, "_stream", lambda device: 0)
    monkeypatch.setattr(cc, "sm_count", lambda device: 132)
    monkeypatch.setattr(tt, "blocks_per_sm", lambda *args, **kw: 1)
    monkeypatch.setattr(cc, "dg1_rk_stage_halo_reference", refused)
    monkeypatch.setattr(cc, "dg1_limit_halo_reference", refused)
    monkeypatch.setattr(type(model.mevp), "spmd_subcycles", lambda self, carry, consts, dt, n: tuple(carry))
    sharded.run_blocks(*blocks, DT, 1)
    return model, calls


def test_ho_with_tvb_on_a_grid_is_refused_on_a_card(monkeypatch):
    """The HO grid with TVB takes the card's route and raises nothing (see
    ``card_route``; the name is from when this route was refused): on a
    uniform mesh the spmd transport_tiled with the CG2 samples and the
    global walls (its qv + walls instance: both pointers given), on the
    spherical window with the coastline the staged route's halo forms of
    dg1_rk_stage (the qv form) and dg1_limit."""
    model, calls = card_route(monkeypatch, "uniform", tvb_m=2.0)
    assert model.schedule("cpu") == ("blocked", "tiled")
    tiled = [args for name, _, args in calls if name == "transport_tiled"]
    assert tiled and {name for name, _, _ in calls} == {"transport_tiled"}
    assert all(args[7] is not None and args[-6] is not None for args in tiled)  # qv, walls
    model, calls = card_route(monkeypatch, "spherical", coast=True, tvb_m=2.0)
    assert model.schedule("cpu") == ("blocked", "xla")
    entries = {(name, entry) for name, entry, _ in calls}
    assert entries == {("dg1_rk_stage", "dg1_rk_stage_halo"), ("dg1_limit", "dg1_limit_halo")}
    stages = [args for name, _, args in calls if name == "dg1_rk_stage"]
    limits = [args for name, _, args in calls if name == "dg1_limit"]
    assert len(stages) == len(limits) and len(stages) % (4 * 2) == 0  # 4 ranks, rk2
    assert all(args[7] is not None and args[2] is None for args in stages)  # qv, not (u, v)
