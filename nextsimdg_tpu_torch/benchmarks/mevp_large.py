"""The mEVP phase on each of the port's schedules, and the sweeps that chose
the "auto" thresholds and the tile shapes, on a CUDA card.

The twin of ``benchmarks/mevp_large.py`` (the JAX backends at sizes, with
``**tiled_kwargs`` forcing a tile configuration). Usage (repository root)::

    python -m nextsimdg_tpu_torch.benchmarks.mevp_large [n ...]      # plain and mevp_tiled at n (1024 2048 4096)
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --thresholds  # the "auto" threshold sweeps
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --tiles       # the tile sweeps
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --barriers    # a cluster barrier's cost

``--thresholds``: K1's schedule against the tiled one on the dynamics step
at 64^2-1024^2 (``coupled.TILED_MIN_ELEMENTS``); ``mevp_single`` against
``mevp_tiled`` on the spherical mEVP phase and dynamics step at
128^2-1024^2 (``coupled.SINGLE_MAX_ELEMENTS``); ``ho_single`` against
``ho_tiled`` on the HO mEVP phase and dynamics step at 128^2-1024^2
(``mevp_ho.HO_SINGLE_MAX_ELEMENTS``). ``--tiles``: the launch
configurations of ``mevp_tiled`` (tile, halo, threads; its call alone, with
its resident blocks per SM) at 1024^2, 2048^2 and 4096^2, uniform and
spherical; of ``ho_tiled`` (cluster shape, sub-window, halo, threads;
with the window's redundancy and the clusters the card holds at once) at 512^2, 1024^2 and 2048^2; of ``rdma_band`` (cluster,
segment, threads) on the x and y bands of config 5's 2048^2 rank blocks
at h = 16; then those of ``transport_tiled`` at 1024^2.
``--tiles=mevp_tiled``, ``--tiles=ho_tiled`` and ``--tiles=rdma_band``
run one part only. ``--barriers``: what one barrier between two phases
costs in ho_tiled's and rdma_band's cluster shapes. Each line names the card and its power limit. Times
are CUDA-event ms, the pairs in turns (a b b a).
"""

from __future__ import annotations

import ctypes
import sys
import time

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


def sweep_thresholds(device) -> None:
    """The three "auto" thresholds: each pair of schedules on the mEVP phase
    (100 subcycles) and the dynamics step, in turns."""
    where = card(device)["nvidia_smi"]

    def pair(tag, n, first, second, high_order=False, spherical=False):
        models = {
            name: _dynamics(n, device, high_order, spherical, **backends)
            for name, backends in (first, second)
        }
        ms = _in_turns({
            name: (lambda m=m: m[0].step_dynamics(m[1], m[2], DT)) for name, m in models.items()
        }, 5)
        print(f"{tag} dynamics step at {n}x{n}: " + ", ".join(
            f"{name} {v:.4f} ms" for name, v in ms.items()) + f" on {where}", flush=True)

    for n in (64, 128, 256, 1024):
        pair("uniform", n, ("K1", {"mevp_backend": "pallas"}),
             ("tiled", {"mevp_backend": "pallas-tiled", "transport_backend": "tiled"}))
    for n in (128, 256, 512, 1024):
        for name in ("single", "pallas-tiled"):
            bench(n, name, outer=5, spherical=True, device=device)
        pair("spherical", n, ("mevp_single", {"mevp_backend": "pallas"}),
             ("mevp_tiled", {"mevp_backend": "pallas-tiled"}), spherical=True)
    for n in (128, 256, 512, 1024):
        for name in ("ho_single", "ho_tiled"):
            bench(n, name, outer=5, device=device)
        pair("HO", n, ("ho_single", {"mevp_backend": "pallas"}),
             ("ho_tiled", {"mevp_backend": "pallas-tiled"}), high_order=True)


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


def band_round_sources(n: int, h: int, device, seed: int = 0):
    """(solver, RoundSources with both ghost pairs, widened consts, state)
    of one rank block of n^2 split on both axes, seeded (config 5's
    blocks: n = 2048, h = 16)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    scale = np.array([0.2, 0.2, 1e3, 1e3, 1e3])[:, None, None]
    solver = MEVPSolver(RectMesh(n, n, 2e3, 2e3), MEVPParams())
    own = tuple(t(rng.normal(0.0, s, (n, n))) for s in scale[:, 0, 0])
    gx = tuple(t(rng.normal(0.0, 1.0, (5, h, n)) * scale) for _ in range(2))
    gy = tuple(t(rng.normal(0.0, 1.0, (5, n + 2 * h, h)) * scale) for _ in range(2))
    src = rdma_cuda.RoundSources(own=own, h=h, split=(True, True), gx=gx, gy=gy)
    wide = (n + 2 * h, n + 2 * h)
    consts_w = {name: t(rng.uniform(0.1, 2.0, wide)) for name in UNIFORM_CONSTS}
    consts_w["strength"] = t(rng.uniform(0.0, 3e4, wide))
    state = [torch.empty_like(own[0]) for _ in range(5)]
    return solver, src, consts_w, state


def sweep_rdma_band(device, n: int = 2048, h: int = 16, configs=RDMA_BAND_CONFIGS) -> dict:
    """ms per call of ``rdma_band`` (a pair of bands, h subcycles) for each
    launch configuration, on the x bands (3h x n) and the y bands
    ((n + 2h) x 3h) of an n^2 rank block: back to back (best of 5 over 20
    calls; the wrapper's host path included) and, after all of those, the
    kernel's device duration (torch.profiler, 20 calls), with its blocks,
    the clusters the card holds at once and its shared bytes; printed, and
    returned by (axis, config) as device ms. On the CPU (the tests) one
    call each runs the plain version."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    where = card(device)["nvidia_smi"] if on_card else "cpu"
    solver, src, consts_w, state = band_round_sources(n, h, device)
    out, lines = {}, []
    for axis in (0, 1):
        along = rdma_cuda.band_shape(axis, h, n, n, h)[1 - axis]
        for config in configs:
            try:
                config.check(axis, h, h)
            except ValueError:
                continue
            run = lambda axis=axis, config=config: rdma_cuda.rdma_band(
                solver.local(), src, axis, consts_w, DT, h, state, config
            )
            blocks = 2 * config.cluster * config.clusters(along, h)
            if on_card:
                active = rdma_cuda.max_clusters(device, axis, h, config)
                if not active:
                    print(f"rdma_band axis {axis} {config}: fits no SM", flush=True)
                    continue

                def calls():
                    for _ in range(20):
                        run()

                ms = best_ms(calls, 5) / 20
            else:
                active, t0 = None, time.perf_counter()
                run()
                ms = (time.perf_counter() - t0) * 1e3
            lines.append((axis, config, run, ms, (
                f"rdma_band axis {axis} ({'x' if axis == 0 else 'y'} bands of {n}^2, h = {h}) cluster "
                f"{config.cluster} seg {config.seg} threads {config.threads}: device {{device}} ms, "
                f"{ms:.4f} ms per call back to back, {blocks} blocks, {active} clusters at once, "
                f"{config.shared_bytes(h, axis)} B shared, {config.cells_per_thread(h)} cells a thread "
                f"on {where}"
            )))
    for axis, config, run, ms, line in lines:
        out[(axis, config)] = device_ms(run, "rdma_band") if on_card else ms
        print(line.format(device=f"{out[(axis, config)]:.5f}" if on_card else "not measured"), flush=True)
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


def sweep_tiles(device, n: int = 1024) -> None:
    """Launch configurations (tile, threads) of ``transport_tiled`` at n^2
    (``mevp_tiled``'s: ``sweep_mevp_tiled``; ``ho_tiled``'s:
    ``sweep_ho_tiled``; ``rdma_band``'s: ``sweep_rdma_band``)."""
    where = card(device)["nvidia_smi"]
    # transport_tiled: one rk2 substep on seeded tracers and velocity.
    rng = np.random.default_rng(0)
    t = lambda x: torch.tensor(x, device=device, dtype=torch.float32)
    model = CoupledModel(RectMesh(n, n, 4e3, 4e3))
    u, v = t(rng.normal(0.0, 0.2, (n, n))), t(rng.normal(0.0, 0.2, (n, n)))
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, n, n)), rng.normal(0.0, 0.3, (2, 3, n, n))]))
    halo = transport_tiled_cuda.halo_for(1, 2)
    for tile, threads in ((24, 512), (32, 512), (32, 768), (40, 512), (40, 768), (44, 768)):
        ms = best_ms(lambda: transport_tiled_cuda.transport_substeps_tiled(
            model.transport, psi, u, v, DT, 1, tile=tile, threads=threads), 20)
        print(
            f"transport_tiled tile {tile} halo {halo} threads {threads} "
            f"({transport_tiled_cuda.shared_bytes(tile, halo)} B shared): {ms:.4f} ms per rk2 "
            f"substep at {n}x{n} on {where}", flush=True,
        )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("mevp_large: no CUDA device; this benchmark runs only on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if "--thresholds" in argv:
        sweep_thresholds(device)
    if "--tiles" in argv or "--tiles=mevp_tiled" in argv:
        sweep_mevp_tiled(device)
    if "--tiles" in argv or "--tiles=ho_tiled" in argv:
        sweep_ho_tiled(device)
    if "--tiles" in argv or "--tiles=rdma_band" in argv:
        sweep_rdma_band(device)
    if "--tiles" in argv:
        sweep_tiles(device)
    if "--barriers" in argv:
        sweep_barriers(device)
    sizes = [int(a) for a in argv if not a.startswith("--")]
    if sizes or not any(a.startswith("--") for a in argv):
        for n in sizes or [1024, 2048, 4096]:
            t_plain = bench(n, "plain", device=device)
            t_tiled = bench(n, "pallas-tiled", device=device)
            print(f"  -> tiled/plain speedup at {n}: {t_plain / t_tiled:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
