"""The mEVP phase on each of the port's schedules, and the sweeps that chose
the "auto" thresholds and the tile shapes, on a CUDA card.

The twin of ``benchmarks/mevp_large.py`` (the JAX backends at sizes, with
``**tiled_kwargs`` forcing a tile configuration). Usage (repository root)::

    python -m nextsimdg_tpu_torch.benchmarks.mevp_large [n ...]      # plain and mevp_tiled at n (1024 2048 4096)
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --thresholds  # the "auto" threshold sweeps
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --thresholds=ho_metric  # the HO one on the spherical window
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --tiles       # the tile sweeps
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --barriers    # a barrier's cost
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --phases=transport_tiled  # load/store against compute
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --kernel-times=rdma  # the closed kernels of config 5's rank blocks
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --kernel-times  # the single-launch kernels, transport_tiled, dg1_sample_cfl, dg1_rk_stage per call
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --steps       # the headline dynamics step
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --steps --kernel-times=dg1_rk_stage  # the step, then dg1_rk_stage and transport_tiled

``--thresholds``: ``mevp_backend="pallas"`` (fused_dynamics where it holds,
else K1's split schedule) against the tiled one on the dynamics step at
64^2-1024^2 (``coupled.TILED_MIN_ELEMENTS``; ``chip_smoke.check_fused``
derives ``coupled.FUSED_MAX_ELEMENTS``); ``mevp_single`` against
``mevp_tiled`` on the spherical mEVP phase and dynamics step at
128^2-1024^2 (``coupled.SINGLE_MAX_ELEMENTS``); ``ho_single`` against
``ho_tiled`` on the HO mEVP phase and dynamics step at 128^2-1024^2
(``mevp_ho.HO_SINGLE_MAX_ELEMENTS``), ``ho_single`` only up to the
largest grid it holds (``ho_single_cuda.tiling``); ``--thresholds=ho_metric``
the last at 256^2-1024^2 on the spherical coastline window (their metric
forms). ``--tiles``: the launch
configurations of ``mevp_tiled`` (tile, halo, threads; its call alone, with
its resident blocks per SM) at 1024^2, 2048^2 and 4096^2, uniform and
spherical; of ``ho_tiled`` (cluster shape, sub-window, halo, threads;
with the window's redundancy and the clusters the card holds at once) at 512^2, 1024^2 and 2048^2; of ``rdma_band`` (cluster,
segment, threads) on the x and y bands of config 5's 2048^2 rank blocks
at h = 16, and of its HO form on the x and y bands of the HO battery
configs' 512^2 and 2048^2 rank blocks at h = 16 and 32 (``--tiles=rdma_band_ho``
alone); then those of ``transport_tiled`` (tile, threads, window
buffers, copy form, persistent blocks or a block per tile) at 1024^2 and
4096^2; of ``mevp_single`` (which const plane stays in shared memory, and
tile shapes) at 1024^2 spherical. ``--tiles=mevp_tiled``, ``--tiles=ho_tiled``,
``--tiles=rdma_band``, ``--tiles=transport_tiled`` and ``--tiles=mevp_single``
run one part only. ``--barriers``: what one barrier between two phases
costs in ho_tiled's and rdma_band's cluster shapes, and ho_single's edge
exchange over its 256^2 tiles, by grid.sync() and by the neighbours' edge
words. ``--phases=transport_tiled``: a launch that only loads and stores
each window against a full one, for the block-per-tile launch of one
buffer (load, stages, store in turn) and the shipped persistent, double-buffered
one. ``--kernel-times``: ``transport_tiled`` at 1024^2 and 4096^2,
``ho_single`` at 256^2 and 512^2, ``ho_tiled`` at 1024^2 (one launch),
``mevp_single`` at 256^2 uniform and
512^2 and 1024^2 spherical, ``mevp_tiled`` on the same 1024^2 spherical
carry, ``dg1_sample_cfl`` at every shape the paths launch it, and
``dg1_rk_stage`` at the paths' shapes and forms (``STAGE_SHAPES``), per
call, as the host launches them (``kernel_times``, which also times an
earlier checkout's kernels); ``--kernel-times=dg1_rk_stage``: only
``transport_tiled`` (which shares the stage's body) and ``dg1_rk_stage``;
``--kernel-times=ho``: only ``ho_single`` and ``ho_tiled``;
``--kernel-times=rdma``: only the closed uniform kernels of config 5's
2 x 2 rank blocks, ``mevp_tiled`` at 2048^2 and 1024^2, ``transport_tiled``
at 1024^2, ``rdma_stage`` and ``rdma_band`` on a 2048^2 block (``--kernel-times``
includes them).
``--steps``: the headline dynamics step (256^2, ``mevp_backend="pallas"``:
fused_dynamics on the H100), mean and best of 20
(``headline_step``), before any profiler session. Each
line names the card and its power limit. Times are CUDA-event ms, the
pairs in turns (a b b a); the rdma_band and transport_tiled sweeps, the
phases and the kernel times also give the kernel's device time (the
profiler), since one call between two events can be the host's issue.
"""

from __future__ import annotations

import ctypes
import functools
import inspect
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from ..coupled import CoupledModel
from ..dynamics import RectMesh, SphericalMesh, synthetic_coastline
from ..dynamics import mevp_ho
from ..dynamics.kernels import coupled_cuda as cc
from ..dynamics.kernels import ho_single_cuda, ho_tiled_cuda, mevp_single_cuda, mevp_tiled_cuda
from ..dynamics.kernels import mevp_rdma_cuda as rdma_cuda
from ..dynamics.kernels import transport_tiled_cuda
from ..dynamics.mevp import UNIFORM_CONSTS, DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from ..dynamics.transport import velocity_from_cg
from .common import best_ms, card, device_ms, require_cuda, with_high_order

DT = 600.0

#: The schedules of the mEVP phase: CG1 (plain, K1's, mevp_tiled,
#: mevp_single) and HO (ho_single, ho_tiled).
SCHEDULES = {
    "plain": cc.mevp_subcycles_reference,
    "pallas": cc.mevp_subcycles,
    "pallas-tiled": mevp_tiled_cuda.mevp_subcycles_tiled,
    "single": mevp_single_cuda.mevp_subcycles_single,
    "ho_single": ho_single_cuda.ho_subcycles_single,
    "ho_tiled": ho_tiled_cuda.ho_subcycles_tiled,
}
TILED = ("pallas-tiled", "ho_tiled")


def _mesh(n: int, spherical: bool):
    if spherical:
        return SphericalMesh(n, n, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)
    return RectMesh(n, n, dx=4e6 / n, dy=4e6 / n)


def _phase_inputs(n: int, high_order: bool, spherical: bool, device):
    """(solver, state, step_consts arguments) of the JAX bench's mEVP phase:
    rest, wind (8, 2) m/s, ocean (0.02, 0) m/s, h = 1, a = 0.9."""
    kw = {"device": device, "dtype": torch.float32}
    full = lambda v: torch.full((n, n), v, **kw)
    mesh = _mesh(n, spherical)
    df = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    if high_order:
        solver = mevp_ho.MEVPSolverHO(mesh, MEVPParams())
        state = mevp_ho.HOVelocityState.zeros(n, n, **kw)
        df = mevp_ho.HODynamicsForcing.from_vertex_forcing(df)
        mask = solver.boundary_mask(**kw)
    else:
        solver = MEVPSolver(mesh, MEVPParams())
        state = VelocityState.zeros(n, n, **kw)
        mask = CoupledModel(mesh).node_mask(**kw)
    return solver, state, (full(1.0), full(0.9), df, mask)


def bench(n: int, backend: str, n_sub: int = 100, outer: int = None, reps: int = 3,
          spherical: bool = False, device=None, **tiled_kwargs) -> float:
    """Seconds per step (``step_consts`` and ``n_sub`` subcycles) of the
    mEVP phase at n^2 on ``backend`` (a key of ``SCHEDULES``), over
    ``outer`` steps, best of ``reps``; printed with the card. The tiled
    backends take a launch configuration (``tiled_kwargs``): ``tile``,
    ``halo`` and ``threads`` (mevp_tiled), ``config`` (ho_tiled).
    ``device="cpu"`` (the tests) runs every schedule's plain version."""
    device = require_cuda("cuda") if device is None else torch.device(device)
    if tiled_kwargs and backend not in TILED:
        raise ValueError(f"{backend} takes no tile configuration: {tiled_kwargs}")
    outer = outer or max(1, 2_000_000_000 // (n * n * n_sub))
    solver, state, args = _phase_inputs(n, backend.startswith("ho_"), spherical, device)
    run = SCHEDULES[backend]
    carry = (state.u, state.v, state.s11, state.s22, state.s12)

    def steps():
        for _ in range(outer):
            run(solver, carry, solver.step_consts(state, *args, DT), DT, n_sub, **tiled_kwargs)

    if device.type == "cuda":
        best = best_ms(steps, reps) * 1e-3 / outer
        where = card(device)["nvidia_smi"]
    else:
        steps()
        t0 = time.perf_counter()
        steps()
        best, where = (time.perf_counter() - t0) / outer, "cpu"
    config = f" {tiled_kwargs}" if tiled_kwargs else ""
    print(
        f"n={n} backend={backend}{config}{' spherical' if spherical else ''}: "
        f"{best * 1e3:.4f} ms / {n_sub} subcycles ({n * n * n_sub / best / 1e9:.3f}G "
        f"subcycle-elements/s, outer={outer}) on {where}", flush=True,
    )
    return best


def _in_turns(fns: dict, reps: int) -> dict:
    """Mean CUDA-event ms per call of each function, run a b ... b a."""
    runs = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        runs[name].append(best_ms(fns[name], reps))
    return {name: sum(ms) / len(ms) for name, ms in runs.items()}


def _dynamics(n: int, device, high_order: bool = False, spherical: bool = False, **backends):
    """(model, state, dynamics forcing) of config 4's state and forcing."""
    mesh = RectMesh(n, n, dx=4e3, dy=4e3) if not spherical else _mesh(n, True)
    ocean = synthetic_coastline(n) if spherical else None
    build = lambda: CoupledModel(mesh, n_subcycles=100, ocean_mask=ocean, **backends)
    model = with_high_order(build) if high_order else build()
    state = model.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    full = lambda v: torch.full((n, n), v, device=device, dtype=torch.float32)
    dyn = DynamicsForcing(u_atm=full(6.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0))
    return model, state, dyn


def _pair(device, tag, n, first, second, high_order=False, spherical=False) -> None:
    """Two schedules ((name, backends) each) of the dynamics step at n^2, in
    turns."""
    models = {
        name: _dynamics(n, device, high_order, spherical, **backends) for name, backends in (first, second)
    }
    ms = _in_turns({
        name: (lambda m=m: m[0].step_dynamics(m[1], m[2], DT)) for name, m in models.items()
    }, 5)
    print(f"{tag} dynamics step at {n}x{n}: " + ", ".join(
        f"{name} {v:.4f} ms" for name, v in ms.items()) + f" on {card(device)['nvidia_smi']}", flush=True)


def sweep_ho_thresholds(device, sizes=(128, 256, 512, 1024), spherical: bool = False) -> None:
    """ho_single against ho_tiled (``mevp_ho.HO_SINGLE_MAX_ELEMENTS``) on the
    HO mEVP phase and dynamics step, on the uniform mesh or, ``spherical``,
    on the lon-lat window with its coastline (their metric forms);
    ho_single only where it holds the grid."""
    sms = ho_single_cuda.sm_count(device)
    tag = "HO spherical" if spherical else "HO"
    for n in sizes:
        if not ho_single_cuda.holds(n, n, sms):
            print(f"{tag} at {n}x{n}: ho_tiled only; ho_single holds grids up to "
                  f"{ho_single_cuda.largest_square(sms)}^2 on {sms} SMs", flush=True)
            bench(n, "ho_tiled", outer=5, spherical=spherical, device=device)
            continue
        for name in ("ho_single", "ho_tiled"):
            bench(n, name, outer=5, spherical=spherical, device=device)
        _pair(device, tag, n, ("ho_single", {"mevp_backend": "pallas"}),
              ("ho_tiled", {"mevp_backend": "pallas-tiled"}), high_order=True, spherical=spherical)


def sweep_thresholds(device) -> None:
    """The three "auto" thresholds: each pair of schedules on the mEVP phase
    (100 subcycles) and the dynamics step, in turns."""
    pair = functools.partial(_pair, device)
    for n in (64, 128, 256, 1024):  # "pallas": fused_dynamics where it holds, else K1's split schedule
        pair("uniform", n, ("pallas", {"mevp_backend": "pallas"}),
             ("tiled", {"mevp_backend": "pallas-tiled", "transport_backend": "tiled"}))
    for n in (128, 256, 512, 1024):
        for name in ("single", "pallas-tiled"):
            bench(n, name, outer=5, spherical=True, device=device)
        pair("spherical", n, ("mevp_single", {"mevp_backend": "pallas"}),
             ("mevp_tiled", {"mevp_backend": "pallas-tiled"}), spherical=True)
    sweep_ho_thresholds(device)


#: mevp_tiled launch configurations (tile, halo, threads): windows of 5
#: planes 64 wide (two blocks an SM) with 2 to 8 subcycles a launch, and
#: windows 68 to 80 wide (one block an SM) beside them.
MEVP_TILED_CONFIGS = (
    (56, 4, 512), (56, 4, 640), (48, 8, 512), (52, 6, 512), (60, 2, 512),
    (64, 8, 1024), (64, 8, 800), (64, 8, 960), (64, 4, 1024), (60, 4, 1024), (48, 8, 1024),
)
TILE_SIZES = (1024, 2048, 4096)


def seeded_phase(n: int, spherical: bool, device, seed: int = 0):
    """(solver, carry, consts): seeded mEVP planes (a state in motion) and
    the consts of ``_phase_inputs``' forcing at n^2."""
    solver, _, args = _phase_inputs(n, False, spherical, device)
    rng = np.random.default_rng(seed)
    carry = tuple(
        torch.tensor(rng.normal(0.0, s, (n, n)), device=device, dtype=torch.float32)
        for s in (0.2, 0.2, 1e3, 1e3, 1e3)
    )
    return solver, carry, solver.step_consts(VelocityState(*carry), *args, DT)


def sweep_mevp_tiled(device, sizes=TILE_SIZES, configs=MEVP_TILED_CONFIGS, n_sub: int = 48) -> dict:
    """ms per 8 subcycles and ps per element and subcycle of ``mevp_tiled``
    alone (``n_sub`` subcycles per timed call, best of 5) for each launch
    configuration, uniform and spherical, at each size, with its resident
    blocks per SM; printed, and returned by (mesh, n, config). A
    configuration with no kernel or that fits no SM is printed as such. On
    the CPU (the tests) the plain version runs and no blocks are counted."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    where = card(device)["nvidia_smi"] if on_card else "cpu"
    out = {}
    for spherical in (False, True):
        mesh = "spherical" if spherical else "uniform"
        for n in sizes:
            solver, carry, consts = seeded_phase(n, spherical, device)
            for config in configs:
                tile, halo, threads = config
                run = lambda: mevp_tiled_cuda.mevp_subcycles_tiled(
                    solver, carry, consts, DT, n_sub, tile, halo, threads
                )
                if on_card:
                    blocks = mevp_tiled_cuda.max_blocks(device, tile, halo, threads, spherical)
                    if not blocks:
                        print(f"mevp_tiled {mesh} {n}x{n} {config}: no kernel, or it fits no SM", flush=True)
                        continue
                    ms = best_ms(run, 5)
                else:
                    blocks, t0 = None, time.perf_counter()
                    run()
                    ms = (time.perf_counter() - t0) * 1e3
                out[(mesh, n, config)] = ms
                print(
                    f"mevp_tiled {mesh} {n}x{n} tile {tile} halo {halo} threads {threads} "
                    f": {ms * 8 / n_sub:.4f} ms per 8 subcycles, "
                    f"{ms * 1e9 / (n * n * n_sub):.2f} ps per element and subcycle, "
                    f"{mevp_tiled_cuda.shared_bytes(tile, halo)} B shared, {blocks} resident "
                    f"blocks per SM on {where}", flush=True,
                )
    return out


#: ho_tiled launch configurations (cluster rows, cols, sub-window, halo,
#: threads): one 48^2 or 56^2 window a block (the design before clusters)
#: and one a cluster of 2 to 16 blocks, sub-windows of 32 to 56, halos of 8
#: and 10, 256 or 512 threads.
HO_TILED_CONFIGS = tuple(
    ho_tiled_cuda.LaunchConfig(*c) for c in (
        (1, 1, 48, 8, 512), (1, 1, 56, 8, 512), (1, 2, 48, 8, 512), (1, 2, 56, 8, 512),
        (2, 1, 56, 8, 512), (1, 4, 48, 8, 512), (2, 2, 48, 8, 512), (2, 2, 56, 8, 512),
        (2, 2, 40, 8, 512), (2, 2, 32, 8, 256), (2, 4, 48, 8, 512), (4, 2, 48, 8, 512),
        (4, 4, 48, 8, 512), (4, 4, 32, 8, 256),
    )
)
HO_TILE_SIZES = (512, 1024, 2048)


def seeded_ho_phase(n: int, device, seed: int = 0):
    """(solver, carry, consts): seeded HO planes (a state in motion) and the
    consts of ``_phase_inputs``' forcing at n^2."""
    solver, _, args = _phase_inputs(n, True, False, device)
    rng = np.random.default_rng(seed)
    noise = lambda s: torch.tensor(rng.normal(0.0, s, (n, n)), device=device, dtype=torch.float32)
    field = lambda s: mevp_ho.HOField(*(noise(s) for _ in range(4)))
    stress = lambda s: torch.stack([noise(s) for _ in range(3)])
    state = mevp_ho.HOVelocityState(u=field(0.2), v=field(0.2), s11=stress(1e3), s22=stress(1e3), s12=stress(5e2))
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    return solver, carry, solver.step_consts(state, *args, DT)


def sweep_ho_tiled(device, sizes=HO_TILE_SIZES, configs=HO_TILED_CONFIGS, n_sub: int = 16) -> dict:
    """ms per 8 subcycles and ps per element and subcycle of ``ho_tiled``
    alone (``n_sub`` subcycles per timed call, best of 5) for each launch
    configuration at each size, with its window's redundancy, its shared
    bytes, the clusters the card holds at once and the waves a launch
    takes; printed, and returned by (n, config). On the CPU (the tests) the
    plain version runs once each and no clusters are counted."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    where = card(device)["nvidia_smi"] if on_card else "cpu"
    out = {}
    for n in sizes:
        solver, carry, consts = seeded_ho_phase(n, device)
        for config in configs:
            run = lambda: ho_tiled_cuda.ho_subcycles_tiled(solver, carry, consts, DT, n_sub, config)
            ca, cb = config.clusters(n, n)
            if on_card:
                active = ho_tiled_cuda.max_clusters(device, config)
                if not active:
                    print(f"ho_tiled {n}x{n} {config}: fits no SM", flush=True)
                    continue
                ms = best_ms(run, 5)
                waves = f", {ca * cb / active:.2f} waves of {active}"
            else:
                waves, t0 = "", time.perf_counter()
                run()
                ms = (time.perf_counter() - t0) * 1e3
            out[(n, config)] = ms
            print(
                f"ho_tiled {n}x{n} cluster {config.rows}x{config.cols} sub {config.sub} halo "
                f"{config.halo} threads {config.threads}: "
                f"{ms * 8 / n_sub:.4f} ms per 8 subcycles, {ms * 1e9 / (n * n * n_sub):.2f} ps per "
                f"element and subcycle, redundancy {config.redundancy():.3f}, "
                f"{config.shared_bytes()} B shared, {ca}x{cb} clusters{waves} on {where}", flush=True,
            )
    return out


#: rdma_band launch configurations (cluster, seg, threads): tiles of one
#: block (cluster 1) 40 to 80 cells along the band, and clusters of 2 to
#: 16 blocks along it.
RDMA_BAND_CONFIGS = tuple(
    rdma_cuda.BandConfig(*c) for c in (
        (1, 40, 640), (1, 48, 768), (1, 56, 896), (1, 62, 992), (1, 64, 768), (1, 64, 1024),
        (1, 80, 1024), (2, 32, 512), (2, 64, 1024), (4, 32, 512), (8, 16, 256), (8, 24, 384),
        (16, 8, 128), (16, 16, 256),
    )
)


#: Launch configurations of rdma_band's HO form (``HoBandConfig``: blocks
#: along and across the band in a cluster, cells along a block, threads,
#: staged consts): clusters of 8 to 16 blocks split along only or also
#: across the band, a thread a cell or two, two blocks an SM with staged
#: consts, and the L2-const form (three blocks an SM) in the band's first
#: design's block shape (16 x 1 blocks of 16 cells) and others (``check`` drops those that do not fit
#: at a ghost width). Not built in a checkout without the class (the A/B
#: copy of this file in an earlier checkout; see ``kernel_times``).
HO_RDMA_BAND_CONFIGS = tuple(
    rdma_cuda.HoBandConfig(*c) for c in (
        (8, 2, 14, 384), (8, 2, 16, 384), (8, 2, 12, 288), (4, 4, 28, 384), (2, 8, 64, 384), (16, 1, 8, 384),
        (4, 2, 32, 384), (8, 2, 16, 256), (4, 3, 24, 384), (4, 4, 20, 256),
        (16, 1, 16, 256, False), (16, 1, 12, 256, False), (8, 2, 20, 256, False), (8, 2, 24, 256, False),
        (4, 4, 48, 256, False),
    )
) if hasattr(rdma_cuda, "HoBandConfig") else ()
#: The HO paths' bands that ``--kernel-times=rdma_band_ho`` times (label,
#: n, h, axis, form, ring): the closed and metric forms on the x bands of
#: a 512^2 block, the closed form on both bands at 2048^2 (the 16M config's
#: blocks), the A-weighted form on a 128^2 block's x bands and the ring on
#: a 256^2 block's y bands (chip_smoke.py's HO_RDMA_PATHS).
HO_BAND_SHAPES = (
    ("closed", 512, 16, 0, 0, False), ("metric", 512, 16, 0, 2, False), ("closed", 2048, 16, 0, 0, False),
    ("closed", 2048, 16, 1, 0, False), ("A-weighted", 128, 16, 0, 1, False), ("ring, metric", 256, 16, 1, 2, True),
)


def band_round_sources(n: int, h: int, device, seed: int = 0, planes: int = rdma_cuda.CG1_PLANES,
                       form: int = 0, ring: bool = False):
    """(band solver, RoundSources with both ghost pairs, widened consts,
    state) of one rank block of n^2 split on both axes, seeded: the CG1
    round's 5 planes and 7 consts (config 5's blocks: n = 2048, h = 16),
    or with ``planes`` 17 the HO round's planes (one (17, n, n) state) and
    its form's consts: the 29, with ``form`` bit 1 the A-weighted stress's
    four a_{k}, with bit 2 a graded mesh's four widths (dx, dy and their
    float32 reciprocals); ``ring``: x not split and periodic, so that the y
    bands wrap along the band (the 1 x 2 ring's)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    ho = planes == rdma_cuda.HO_PLANES
    scale = np.array([0.2] * (8 if ho else 2) + [1e3] * (9 if ho else 3))[:, None, None]
    width = 4e3 if ho else 2e3
    metric = ho and form & 2
    dx, dy = (rng.uniform(0.75, 1.25, n) * width for _ in range(2)) if metric else (width, width)
    mesh = RectMesh(n, n, dx, dy, periodic_x=ring)
    params = MEVPParams(a_weighted_stress=bool(ho and form & 1))
    solver = mevp_ho.MEVPSolverHO(mesh, params) if ho else MEVPSolver(mesh, params)
    split = (not ring, True)
    hx = h if split[0] else 0
    own = tuple(t(rng.normal(0.0, s, (n, n))) for s in scale[:, 0, 0])
    gx = tuple(t(rng.normal(0.0, 1.0, (planes, h, n)) * scale) for _ in range(2)) if split[0] else None
    gy = tuple(t(rng.normal(0.0, 1.0, (planes, n + 2 * hx, h)) * scale) for _ in range(2))
    src = rdma_cuda.RoundSources(own=own, h=h, split=split, gx=gx, gy=gy)
    wide = (n + 2 * hx, n + 2 * h)
    names = solver.const_names() if ho else UNIFORM_CONSTS
    consts_w = {name: t(rng.uniform(0.1, 2.0, wide)) for name in names}
    consts_w["strength"] = t(rng.uniform(0.0, 3e4, wide))
    if metric:
        for name in ("dx", "dy"):
            consts_w[name] = t(rng.uniform(0.75, 1.25, wide) * width)
            consts_w[f"inv_{name}"] = 1.0 / consts_w[name]
    state = torch.empty((17, n, n), device=device) if ho else [torch.empty_like(own[0]) for _ in range(5)]
    return solver.local(), src, consts_w, state


def sweep_rdma_band(device, sizes=(2048,), halos=(16,), configs=RDMA_BAND_CONFIGS,
                    planes: int = rdma_cuda.CG1_PLANES) -> dict:
    """ms per call of ``rdma_band`` (a pair of bands, h subcycles) for each
    launch configuration that fits, on the x bands (3h x n) and the y bands
    ((n + 2h) x 3h) of n^2 rank blocks (``sizes``) at each ghost width of
    ``halos``, of the CG1 form (``BandConfig``s) or (``planes`` 17,
    ``HoBandConfig``s) the closed HO form: back to back (best of 5 over 20
    calls; the wrapper's host path included) and, after all of those, the
    kernel's device duration (torch.profiler), with its blocks, the clusters
    the card holds at once, the waves of clusters they make and its shared
    bytes; printed, and returned by (n, h, axis, config) as device ms. On
    the CPU (the tests) one call each runs the plain version."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    where = card(device)["nvidia_smi"] if on_card else "cpu"
    ho = planes == rdma_cuda.HO_PLANES
    form = "rdma_band HO" if ho else "rdma_band"
    out, lines = {}, []
    for n in sizes:
        for h in halos:
            solver, src, consts_w, state = band_round_sources(n, h, device, planes=planes)
            for axis in (0, 1):
                along = rdma_cuda.band_shape(axis, h, n, n, h)[1 - axis]
                for config in configs:
                    try:
                        config.check(axis, h, h)
                    except ValueError:
                        continue
                    run = lambda a=axis, c=config, s=solver, r=src, w=consts_w, o=state, h=h: (
                        rdma_cuda.rdma_band(s, r, a, w, DT, h, o, c))
                    clusters = 2 * config.clusters(along, h)
                    blocks = config.cluster * clusters
                    if on_card:
                        active = rdma_cuda.max_clusters(device, axis, h, config, planes)
                        if not active:
                            print(f"{form} axis {axis} {config} at h = {h}: fits no SM", flush=True)
                            continue

                        def calls(run=run):
                            for _ in range(20):
                                run()

                        ms = best_ms(calls, 5) / 20
                    else:
                        active, t0 = None, time.perf_counter()
                        run()
                        ms = (time.perf_counter() - t0) * 1e3
                    shape = (f"cluster {config.along}x{config.across} seg {config.seg} rows {config.rows(h)}"
                             f"{'' if config.staged else ' L2 consts'}" if ho else
                             f"cluster {config.cluster} seg {config.seg}")
                    waves = f"{clusters / active:.2f}" if active else "?"
                    lines.append(((n, h, axis, config), run, (
                        f"{form} axis {axis} ({'x' if axis == 0 else 'y'} bands of {n}^2, h = {h}) {shape} "
                        f"threads {config.threads}: device {{device}} ms, {ms:.4f} ms per call back to back, "
                        f"{blocks} blocks, {active} clusters at once ({waves} waves), "
                        f"{config.shared_bytes(h, axis)} B shared on {where}"
                    ), ms))
    for key, run, line, ms in lines:
        out[key] = device_ms(run, "rdma_band") if on_card else ms
        print(line.format(device=f"{out[key]:.5f}" if on_card else "not measured"), flush=True)
    return out


#: Cluster shapes for the barrier probe (rows, cols, threads, shared
#: bytes): ho_tiled's shipped window a block and its 2 x 2 clusters, and
#: rdma_band's clusters of 16 at config 5's x bands.
BARRIER_SHAPES = ((1, 1, 512, 170000), (2, 2, 512, 170000), (1, 16, 256, 17280))


def sweep_barriers(device, shapes=BARRIER_SHAPES, n_barriers: int = 4096) -> dict:
    """ns per barrier between two phases (``window_sync`` of
    csrc/cluster_window.cuh: the block's barrier in a cluster of one,
    ``cluster.sync()`` in larger ones) in clusters of each shape, one wave
    of them on the card: a launch of ``n_barriers`` barriers less a launch
    of none (best of 5 each), over ``n_barriers``; printed, and returned by
    shape."""
    device = torch.device(device)
    lib, stream = cc._library(), cc._stream(device)
    where = card(device)["nvidia_smi"]
    clusters, out = ctypes.c_int(0), {}
    for rows, cols, threads, n_bytes in shapes:
        def run(n):
            err = lib.nst_window_syncs(
                rows, cols, threads, n_bytes, n, device.index or 0, stream, ctypes.byref(clusters)
            )
            if err != 0:
                raise RuntimeError(f"window_syncs: CUDA error {err}: {lib.nst_error_string(err).decode()}")

        empty, full = best_ms(lambda: run(0)), best_ms(lambda: run(n_barriers))
        out[(rows, cols, threads, n_bytes)] = ns = (full - empty) * 1e6 / n_barriers
        print(
            f"window_sync in clusters of {rows}x{cols} blocks of {threads} threads ({n_bytes} B shared, "
            f"{clusters.value} clusters at once, one wave): {ns:.1f} ns per barrier ({full:.4f} ms for "
            f"{n_barriers}, {empty:.4f} ms for none) on {where}", flush=True,
        )
    return out


def sweep_ho_single_syncs(device, n: int = 256, n_barriers: int = 4096) -> dict:
    """ns per exchange of ho_single over its tiles of an n^2 grid (one block
    a tile, its threads and shared bytes): the edge words written, then the
    apron's words polled from the three neighbours, by the words' own half
    numbers ("neighbours") or after grid.sync() ("grid"); a launch of
    ``n_barriers`` less a launch of none, best of 5 each, over
    ``n_barriers``; printed, and returned by sync."""
    device = torch.device(device)
    lib, stream = cc._library(), cc._stream(device)
    where = card(device)["nvidia_smi"]
    config = ho_single_cuda.tiling(n, n, ho_single_cuda.sm_count(device))
    out = {}
    for sync in ("neighbours", "grid"):
        def run(count):
            words = ho_single_cuda.exchange(config, device)
            err = lib.nst_ho_single_syncs(
                words.data_ptr(), *config.tile, *config.tiles, config.threads, config.shared_bytes(),
                count, int(sync == "grid"), device.index or 0, stream,
            )
            if err != 0:
                raise RuntimeError(f"ho_single_syncs: CUDA error {err}: {lib.nst_error_string(err).decode()}")

        empty, full = best_ms(lambda: run(0)), best_ms(lambda: run(n_barriers))
        out[sync] = ns = (full - empty) * 1e6 / n_barriers
        print(
            f"ho_single exchange by {sync} over {config.n_tiles} tiles of {config.tile} "
            f"({config.threads} threads, {config.shared_bytes()} B shared): {ns:.1f} ns per exchange "
            f"({full:.4f} ms for {n_barriers}, {empty:.4f} ms for none) on {where}", flush=True,
        )
    return out


def _seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def transport_inputs(n: int, device, seed: int = 0):
    """(transport, tracers, u, v): config 4's mesh at n^2 (4 km), seeded
    tracers and a velocity in motion."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, device=device, dtype=torch.float32)
    model = CoupledModel(RectMesh(n, n, 4e3, 4e3))
    u, v = t(rng.normal(0.0, 0.2, (n, n))), t(rng.normal(0.0, 0.2, (n, n)))
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, n, n)), rng.normal(0.0, 0.3, (2, 3, n, n))]))
    return model.transport, psi, u, v


#: mevp_single's shapes (n, spherical): the headline's 256^2 uniform, the
#: "auto" threshold's 512^2 and the spherical path's 1024^2.
SINGLE_SIZES = ((256, False), (512, True), (1024, True))
#: dg1_sample_cfl's shapes (n, halo, spherical): the headline's 256^2,
#: config 4's and the spherical path's 1024^2, config 5's single-device
#: 4096^2, and a 2 x 2 rank's 2048^2 block widened by the spmd transport's
#: H = 8.
CFL_SHAPES = ((256, 0, False), (1024, 0, False), (1024, 0, True), (4096, 0, False), (2048, 8, False))


#: dg1_rk_stage's shapes and forms (n, spherical, form): one rk2 stage
#: ("blend", a = b = 0.5) at the headline's 256^2, the first stage and rk1
#: ("first", a = 0) there, the blended stage at 1024^2 (rk3 on one device,
#: ``transport_backend="xla"``) and on the spherical coastline window (the
#: metric form), the HO path's qv form at 256^2, and the blended stage at
#: config 5's 4096^2 (rk3 on its single device).
STAGE_SHAPES = (
    (256, False, "blend"), (256, False, "first"), (1024, False, "blend"), (1024, True, "blend"),
    (256, False, "qv"), (4096, False, "blend"),
)


def stage_inputs(n: int, spherical: bool, device, seed: int = 0):
    """(transport, tracers, u, v, face masks): ``transport_inputs`` at n^2
    with all-ones face masks, or the spherical window with the synthetic
    coastline (its metric planes and face masks) and a seeded velocity."""
    if not spherical:
        transport, psi, u, v = transport_inputs(n, device, seed)
        ones = torch.ones_like(u)
        return transport, psi, u, v, (ones, ones)
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, device=device, dtype=torch.float32)
    model = CoupledModel(_mesh(n, True), ocean_mask=synthetic_coastline(n))
    u, v = t(rng.normal(0.0, 0.2, (n, n))), t(rng.normal(0.0, 0.2, (n, n)))
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, n, n)), rng.normal(0.0, 0.3, (2, 3, n, n))]))
    return model.transport, psi, u, v, model.face_masks(device=device, dtype=torch.float32)


def cfl_inputs(n: int, halo: int, spherical: bool, device, seed: int = 0):
    """(transport, u, v): config 4's mesh at n^2 (or the spherical window)
    and a seeded velocity, widened by ``halo`` on every side."""
    rng = np.random.default_rng(seed)
    mesh = _mesh(n, True) if spherical else RectMesh(n, n, 4e3, 4e3)
    shape = (n + 2 * halo, n + 2 * halo)
    u, v = (torch.tensor(rng.normal(0.0, 0.3, shape), device=device, dtype=torch.float32) for _ in range(2))
    return CoupledModel(mesh).transport, u, v


def kernel_times(device, transport_sizes=(1024, 4096), ho_sizes=(256, 512), n_sub: int = 100,
                 single_sizes=SINGLE_SIZES, tiled_sizes=((1024, True),), cfl_shapes=CFL_SHAPES,
                 stage_sizes=STAGE_SHAPES, k1_sizes=(), ho_tiled_sizes=(), rdma_sizes=(),
                 rdma_halo: int = 16, ho_band_shapes=()) -> dict:
    """ms per call of the launches the host picks for ``transport_tiled``
    (one rk2 substep on ``transport_inputs`` at each of ``transport_sizes``),
    ``ho_single`` (``n_sub`` HO subcycles on ``seeded_ho_phase`` at each of
    ``ho_sizes``), ``ho_tiled`` (one launch of its shipped subcycles on
    ``seeded_ho_phase`` at each of ``ho_tiled_sizes``), ``mevp_single`` and
    ``mevp_tiled`` (``n_sub`` subcycles on
    ``seeded_phase`` at each (n, spherical) of ``single_sizes`` and
    ``tiled_sizes``), ``dg1_sample_cfl`` (at each (n, halo, spherical)
    of ``cfl_shapes``) and ``dg1_rk_stage`` (one stage on ``stage_inputs``
    at each (n, spherical, form) of ``stage_sizes``: "blend" a = b = 0.5,
    "first" a = 0, "qv" the blended stage on the quadrature samples of the
    same velocity, skipped where the checkout's wrapper has no qv form) and
    K1's ``mevp_stress`` and ``mevp_velocity`` (one launch in place on
    ``seeded_phase``'s uniform carry at each of ``k1_sizes``), and
    ``rdma_stage`` (the x strips) and ``rdma_band`` (the x or the y bands,
    ``rdma_halo`` subcycles) on ``band_round_sources`` at each of
    ``rdma_sizes``, and ``rdma_band``'s HO form (the launch the host picks)
    at each (label, n, h, axis, form, ring) of ``ho_band_shapes``
    (``HO_BAND_SHAPES``: the HO paths' bands):
    the kernel's device
    duration per call (profiler,
    mean of 20 calls; a launch's mean times the launches of a call) and the
    call back to back (CUDA events, best of 5); printed, and returned by
    (kernel, n) (dg1_sample_cfl: (kernel, (n, halo, spherical));
    dg1_rk_stage: (kernel, (n, spherical, form)); rdma_band: (kernel,
    (n, axis)), its HO form (kernel, (n, axis, label))) as (device, back to
    back). It calls the wrappers by the signatures they
    have had since they were ported and nothing newer at import, so this
    file copied into an earlier checkout times that checkout's kernels on
    the same inputs (PERF.md). On the CPU (the tests) the plain versions
    run once each."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        device = require_cuda(device)  # with its index, as the wrappers check it
    where = card(device)["nvidia_smi"] if on_card else "cpu"
    cases = []
    for n in transport_sizes:
        transport, psi, u, v = transport_inputs(n, device)
        cases.append(("transport_tiled", n, "one rk2 substep", lambda t=transport, p=psi, u=u, v=v: (
            transport_tiled_cuda.transport_substeps_tiled(t, p, u, v, DT, 1))))
    for n in ho_sizes:
        solver, carry, consts = seeded_ho_phase(n, device)
        cases.append(("ho_single", n, f"{n_sub} HO subcycles", lambda s=solver, c=carry, k=consts: (
            ho_single_cuda.ho_subcycles_single(s, c, k, DT, n_sub))))
    for n in ho_tiled_sizes:
        solver, carry, consts = seeded_ho_phase(n, device)
        h = ho_tiled_cuda.HALO
        cases.append(("ho_tiled", n, f"{h} HO subcycles (one launch)", lambda s=solver, c=carry, k=consts: (
            ho_tiled_cuda.ho_subcycles_tiled(s, c, k, DT, h))))
    for kernel, run, sizes in (
        ("mevp_single", mevp_single_cuda.mevp_subcycles_single, single_sizes),
        ("mevp_tiled", mevp_tiled_cuda.mevp_subcycles_tiled, tiled_sizes),
    ):
        for n, spherical in sizes:
            solver, carry, consts = seeded_phase(n, spherical, device)
            what = f"{n_sub} subcycles, {'spherical' if spherical else 'uniform'}"
            cases.append((kernel, n, what, lambda r=run, s=solver, c=carry, k=consts: r(s, c, k, DT, n_sub)))
    for n in k1_sizes:
        solver, carry, consts = seeded_phase(n, False, device)
        for name in ("mevp_stress", "mevp_velocity"):
            if on_card:
                planes = tuple(p.clone() for p in carry)
                c_w, inv_drag = torch.empty_like(carry[0]), torch.empty_like(carry[0])
                fn = lambda name=name, p=planes, c=c_w, i=inv_drag, k=cc._mevp_consts(consts), \
                    s=cc._mevp_scalars(solver, DT): cc._mevp_half_(name, p, k, c, i, s, cc._stream(device))
            else:
                fn = lambda s=solver, c=carry, k=consts: s.subcycle_body(c, k, DT)
            cases.append((name, n, "one launch (uniform)", fn))
    for n, halo, spherical in cfl_shapes:
        transport, u, v = cfl_inputs(n, halo, spherical, device)
        what = f"{'spherical' if spherical else 'uniform'}" + (f", halo {halo}" if halo else "")
        if on_card:
            speeds, tables, stream = torch.zeros(2, device=device), cc._dg1_tables(transport), cc._stream(device)
            fn = lambda u=u, v=v, s=speeds, t=tables, h=halo: cc._dg1_sample_cfl_(u, v, s, t, stream, halo=h)
        else:
            fn = lambda t=transport, u=u, v=v, h=halo: cc.dg1_sample_cfl_reference(t, u, v, halo=h)
        cases.append(("dg1_sample_cfl", (n, halo, spherical), what, fn))
    has_qv = "qv" in inspect.signature(cc._dg1_rk_stage_).parameters
    for n, spherical, form in stage_sizes:
        if form == "qv" and not has_qv:
            print(f"dg1_rk_stage {n}x{n} qv form: not in this checkout", flush=True)
            continue
        transport, psi, u, v, faces = stage_inputs(n, spherical, device)
        a, b = (0.0, 1.0) if form == "first" else (0.5, 0.5)
        args = (transport, psi, psi.flip(-1).contiguous(), u, v, *faces, a, b, DT)
        qv = velocity_from_cg(transport.mesh, transport.basis, u, v) if form == "qv" else None
        if on_card:
            out_psi, tables, stream = torch.empty_like(psi), cc._dg1_tables(transport), cc._stream(device)
            metric = cc._dg1_metric(transport, device)
            # Checkouts before dG0 and dG2 pack the dG1 planes without a degree.
            degree = ((transport.basis.degree,) if "degree" in inspect.signature(cc._dg1_qv).parameters else ())
            qv_kw = {} if qv is None else {"qv": cc._dg1_qv(qv, (n, n), device, *degree)}
            fn = lambda a=args, o=out_psi, t=tables, m=metric, kw=qv_kw: cc._dg1_rk_stage_(
                *a[1:7], m, o, *a[7:], t, stream, **kw)
        else:
            fn = lambda a=args, q=qv: cc.dg1_rk_stage_reference(*a, **({} if q is None else {"qv": q}))
        what = f"one {'metric ' if spherical else ''}stage ({form}) of 3 tracers"
        cases.append(("dg1_rk_stage", (n, spherical, form), what, fn))
    for n in rdma_sizes:
        solver, src, consts_w, state = band_round_sources(n, rdma_halo, device)
        cases.append(("rdma_stage", n, "the x strips", lambda s=src: rdma_cuda.rdma_stage(s, 0)))
        for axis in (0, 1):
            what = f"the {'xy'[axis]} bands, {rdma_halo} subcycles"
            cases.append(("rdma_band", (n, axis), what, lambda a=axis, s=solver, r=src, c=consts_w, o=state: (
                rdma_cuda.rdma_band(s, r, a, c, DT, rdma_halo, o))))
    for label, n, h, axis, form, ring in ho_band_shapes:
        solver, src, consts_w, state = band_round_sources(n, h, device, planes=17, form=form, ring=ring)
        what = f"the {'xy'[axis]} bands, {h} HO subcycles, {label}"
        cases.append(("rdma_band", (n, axis, label), what, lambda a=axis, s=solver, r=src, c=consts_w, o=state,
                       h=h: rdma_cuda.rdma_band(s, r, a, c, DT, h, o)))
    out = {}
    for kernel, n, what, fn in cases:
        if on_card:
            before = cc.launches[kernel]
            ms = best_ms(fn)
            per_call = (cc.launches[kernel] - before) // 6  # best_ms: a warm-up and 5 timed calls
            dev = device_ms(fn, kernel) * per_call
        else:
            ms = dev = _seconds(fn) * 1e3
        out[(kernel, n)] = (dev, ms)
        size = f"{n[0]}x{n[0]}" if isinstance(n, tuple) else f"{n}x{n}"
        if kernel == "dg1_rk_stage":
            size += " spherical" if n[1] else ""
        print(f"{kernel} {size}: device {dev:.5f} ms, back to back {ms:.5f} ms per call of {what} on {where}",
              flush=True)
    return out


def headline_step(device, n: int = 256, reps: int = 20) -> tuple:
    """ms per headline dynamics step (``bench.py``'s configuration: a closed
    n^2 mesh of 512 km, 100 subcycles, ``mevp_backend="pallas"``: on the
    H100 fused_dynamics, the whole phase in one launch, where it holds the
    grid, else K1's split schedule): the mean of ``reps`` back-to-back
    steps and the best single step (CUDA events); printed with the card.
    On the CPU (the tests) the plain path runs once."""
    device = torch.device(device)
    mesh = RectMesh(n, n, dx=512e3 / n, dy=512e3 / n)
    model = CoupledModel(mesh, n_subcycles=100, mevp_backend="pallas")
    state = model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0, device=device, dtype=torch.float32,
    )
    full = lambda value: torch.full((n, n), value, device=device, dtype=torch.float32)
    forcing = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
    step = lambda: model.step(state, None, forcing, DT, do_thermo=False)
    if device.type != "cuda":
        return (_seconds(step) * 1e3,) * 2
    step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    end.record()
    torch.cuda.synchronize()
    mean, best = start.elapsed_time(end) / reps, best_ms(step, reps)
    print(f"headline dynamics step {n}x{n} ({model.schedule(device)[0]}): {mean:.4f} ms mean of {reps} back to back, "
          f"best {best:.4f} ms on {card(device)['nvidia_smi']}", flush=True)
    return mean, best


#: mevp_single's sweep, (n, const planes in shared memory, tile); None:
#: the host's. At the spherical path's 1024^2 one plane fits beside the
#: state: it, or none; two other tiles of 8192 cells. At 512^2 all 12 fit:
#: all, two, none.
SINGLE_SWEEP = (
    (1024, None, None), (1024, 0, None), (1024, None, (128, 64)), (1024, None, (32, 256)),
    (512, None, None), (512, 2, None), (512, 0, None),
)


def sweep_mevp_single(device, cases=SINGLE_SWEEP, n_sub: int = 100) -> dict:
    """Device ms per call of ``n_sub`` spherical subcycles of ``mevp_single``
    (profiler, mean of 20) for each (n, room, tile) of ``cases``: ``room``
    const planes in shared memory, ``tile`` forced (None: the host's);
    printed, and returned by case. The wrapper runs each case through a
    patched ``tiling``, restored after. On the CPU (the tests) the plain
    version runs once."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    where = card(device)["nvidia_smi"] if on_card else "cpu"
    sms = mevp_single_cuda.sm_count(device) if on_card else 132
    tiling = mevp_single_cuda.tiling
    inputs, out = {}, {}
    for case in cases:
        n, room, tile = case
        if n not in inputs:
            inputs[n] = seeded_phase(n, True, device)
        solver, carry, consts = inputs[n]
        config = tiling(n, n, sms, tile)
        if room is not None:
            config = replace(config, room=room)
        mevp_single_cuda.tiling = lambda *args, config=config: config
        try:
            fn = lambda: mevp_single_cuda.mevp_subcycles_single(solver, carry, consts, DT, n_sub)
            ms = device_ms(fn, "mevp_single") if on_card else _seconds(fn) * 1e3
        finally:
            mevp_single_cuda.tiling = tiling
        out[case] = ms
        print(
            f"mevp_single {n}x{n} spherical, {config.n_tiles} tiles of {config.tile}, {config.threads} "
            f"threads, const planes in shared memory {config.resident(True)}: device {ms:.5f} ms per "
            f"call of {n_sub} subcycles on {where}", flush=True,
        )
    return out


def transport_tiled_configs() -> tuple:
    """transport_tiled launches (LaunchConfig, copy form) for the sweep: the
    shipped persistent double-buffered one by 16-byte and 4-byte copies,
    tiles of 24 and 28, one buffer, the two-block alternative (tiles 30 and
    24) and the block-per-tile launch."""
    T = transport_tiled_cuda.LaunchConfig
    return (
        (T(32, 768, 2), "vector"), (T(32, 768, 2), "scalar"), (T(28, 768, 2), "vector"),
        (T(24, 768, 2), "vector"), (T(32, 512, 2), "vector"), (T(32, 768, 1), "vector"),
        (T(30, 384, 1), "vector"), (T(30, 384, 1), "scalar"), (T(24, 384, 1), "vector"),
        (T(32, 768, 1, False), "vector"), (T(32, 768, 1, False), "scalar"),
    )


def sweep_transport_tiled(device, sizes=(1024, 4096), configs=None, k: int = 1) -> dict:
    """ms per call of ``k`` rk2 substeps (one launch, halo 2 k + 1; a
    config's tile is narrowed to what fits the halo) of ``transport_tiled``
    for each launch at each size: the kernel's device duration (profiler, mean
    of 20) and the call back to back (CUDA events, best of 20, in turns a
    b ... b a: the host's issue rate where it is the slower), with its
    shared bytes and blocks an SM; printed, and the device ms returned by
    (n, config, copy). On the CPU (the tests) the plain version runs once."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    where = card(device)["nvidia_smi"] if on_card else "cpu"
    halo = transport_tiled_cuda.halo_for(k, 2)
    configs = [(transport_tiled_cuda.fitted(config, halo), copy)
               for config, copy in configs or transport_tiled_configs()]
    out = {}
    for n in sizes:
        transport, psi, u, v = transport_inputs(n, device)
        fns = {
            (config, copy): (lambda c=config, f=copy: transport_tiled_cuda.transport_substeps_tiled(
                transport, psi, u, v, DT / k, k, config=c, copy=f))
            for config, copy in configs if config is not None
        }
        ms = _in_turns(fns, 20) if on_card else {key: _seconds(fn) * 1e3 for key, fn in fns.items()}
        for (config, copy), t in ms.items():
            per_sm = transport_tiled_cuda.blocks_per_sm(device, config, halo, copy=copy) if on_card else 0
            dev = device_ms(fns[(config, copy)], "transport_tiled") if on_card else t
            out[(n, config, copy)] = dev
            print(
                f"transport_tiled {n}x{n} tile {config.tile} halo {halo} threads {config.threads} buffers "
                f"{config.buffers} {'persistent' if config.persistent else 'a block per tile'} {copy}: "
                f"device {dev:.4f} ms, back to back {t:.4f} ms per {k} rk2 substep(s), "
                f"{transport_tiled_cuda.shared_bytes(config.tile, halo, 3, config.buffers)} B shared, "
                f"{per_sm} blocks an SM on {where}", flush=True,
            )
    return out


def phases_transport_tiled(device, n: int = 1024) -> dict:
    """What a transport_tiled launch spends on moving its windows: a launch
    that only loads and stores each window (``compute=False``) against a
    full one (one rk2 substep at n^2), by the kernel's device duration
    (profiler, mean of 20), for the block-per-tile launch of one buffer (the
    sequence: load, barrier, stages, store) and the shipped
    persistent double-buffered one; printed, and returned by (config,
    phase)."""
    device = torch.device(device)
    where = card(device)["nvidia_smi"]
    transport, psi, u, v = transport_inputs(n, device)
    configs = {"block per tile, one buffer": transport_tiled_cuda.PER_TILE,
               "persistent, two buffers": transport_tiled_cuda.SHIPPED}
    out = {}
    for name, config in configs.items():
        for phase in ("full", "load and store"):
            out[(name, phase)] = device_ms(lambda: transport_tiled_cuda.transport_substeps_tiled(
                transport, psi, u, v, DT, 1, config=config, compute=phase == "full"), "transport_tiled")
        full, moves = out[(name, "full")], out[(name, "load and store")]
        print(
            f"transport_tiled {n}x{n} {name}: device {full:.4f} ms a full launch, {moves:.4f} ms "
            f"loading and storing only, the rest {full - moves:.4f} ms (one rk2 substep) on {where}",
            flush=True,
        )
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("mevp_large: no CUDA device; this benchmark runs only on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if "--thresholds=ho_metric" in argv:
        sweep_ho_thresholds(device, (256, 512, 1024), spherical=True)
    if "--thresholds" in argv:
        sweep_thresholds(device)
    if "--tiles" in argv or "--tiles=mevp_tiled" in argv:
        sweep_mevp_tiled(device)
    if "--tiles" in argv or "--tiles=ho_tiled" in argv:
        sweep_ho_tiled(device)
    if "--tiles" in argv or "--tiles=rdma_band" in argv:
        sweep_rdma_band(device)
    if "--tiles" in argv or "--tiles=rdma_band" in argv or "--tiles=rdma_band_ho" in argv:
        sweep_rdma_band(device, (512, 2048), (16, 32), HO_RDMA_BAND_CONFIGS, rdma_cuda.HO_PLANES)
        sweep_rdma_band(device, (512,), (64,), HO_RDMA_BAND_CONFIGS, rdma_cuda.HO_PLANES)
    if "--tiles" in argv or "--tiles=transport_tiled" in argv:
        sweep_transport_tiled(device)
    if "--barriers" in argv:
        sweep_barriers(device)
        sweep_ho_single_syncs(device)
    if "--phases=transport_tiled" in argv:
        phases_transport_tiled(device)
    if "--steps" in argv:  # host-bound: before any profiler session
        headline_step(device)
    if "--kernel-times" in argv:
        kernel_times(device, k1_sizes=(256,), ho_tiled_sizes=(1024,), rdma_sizes=(2048,))
    if "--kernel-times=rdma" in argv:
        kernel_times(device, transport_sizes=(1024,), ho_sizes=(), single_sizes=(),
                     tiled_sizes=((2048, False), (1024, False)), cfl_shapes=(), stage_sizes=(), rdma_sizes=(2048,))
    if "--kernel-times=ho" in argv:
        kernel_times(device, transport_sizes=(), single_sizes=(), tiled_sizes=(), cfl_shapes=(),
                     stage_sizes=(), ho_tiled_sizes=(1024,))
    if "--kernel-times=rdma_band_ho" in argv:
        kernel_times(device, transport_sizes=(), ho_sizes=(), single_sizes=(), tiled_sizes=(), cfl_shapes=(),
                     stage_sizes=(), ho_band_shapes=HO_BAND_SHAPES)
    if "--kernel-times=dg1_rk_stage" in argv:
        kernel_times(device, ho_sizes=(), single_sizes=(), tiled_sizes=(), cfl_shapes=())
    if "--tiles" in argv or "--tiles=mevp_single" in argv:
        sweep_mevp_single(device)
    sizes = [int(a) for a in argv if not a.startswith("--")]
    if sizes or not any(a.startswith("--") for a in argv):
        for n in sizes or [1024, 2048, 4096]:
            t_plain = bench(n, "plain", device=device)
            t_tiled = bench(n, "pallas-tiled", device=device)
            print(f"  -> tiled/plain speedup at {n}: {t_plain / t_tiled:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
