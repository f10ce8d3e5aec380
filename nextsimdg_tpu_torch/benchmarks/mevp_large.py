"""The mEVP phase on each of the port's schedules, and the sweeps that chose
the "auto" thresholds and the tile shapes, on a CUDA card.

The twin of ``benchmarks/mevp_large.py`` (the JAX backends at sizes, with
``**tiled_kwargs`` forcing a tile configuration). Usage (repository root)::

    python -m nextsimdg_tpu_torch.benchmarks.mevp_large [n ...]      # plain and mevp_tiled at n (1024 2048 4096)
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --thresholds  # the "auto" threshold sweeps
    python -m nextsimdg_tpu_torch.benchmarks.mevp_large --tiles       # the tile sweeps at 1024^2

``--thresholds``: K1's schedule against the tiled one on the dynamics step
at 64^2-1024^2 (``coupled.TILED_MIN_ELEMENTS``); ``mevp_single`` against
``mevp_tiled`` on the spherical mEVP phase and dynamics step at
128^2-1024^2 (``coupled.SINGLE_MAX_ELEMENTS``); ``ho_single`` against
``ho_tiled`` on the HO mEVP phase and dynamics step at 128^2-1024^2
(``mevp_ho.HO_SINGLE_MAX_ELEMENTS``). ``--tiles``: each launch
configuration of ``mevp_tiled``, ``transport_tiled`` and ``ho_tiled`` that
fits a block's 227 KB of shared memory. Each line names the card and its
power limit. Times are CUDA-event ms, the pairs in turns (a b b a).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..coupled import CoupledModel
from ..dynamics import RectMesh, SphericalMesh, synthetic_coastline
from ..dynamics import mevp_ho
from ..dynamics.kernels import coupled_cuda as cc
from ..dynamics.kernels import ho_single_cuda, ho_tiled_cuda, mevp_single_cuda, mevp_tiled_cuda
from ..dynamics.kernels import transport_tiled_cuda
from ..dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from .common import best_ms, card, require_cuda, with_high_order

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
    backends take ``tile``, ``halo`` and ``threads`` (``tiled_kwargs``).
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


def sweep_tiles(device, n: int = 1024) -> None:
    """Launch configurations (tile, halo, threads) of the tiled kernels at
    n^2 that fit a block's 227 KB of shared memory."""
    where = card(device)["nvidia_smi"]
    for tile, halo, threads in (
        (64, 8, 512), (64, 8, 1024), (48, 8, 512), (48, 8, 1024), (56, 8, 1024),
        (72, 8, 1024), (40, 8, 512), (32, 8, 256), (64, 12, 1024), (80, 4, 1024),
    ):
        bench(n, "pallas-tiled", outer=5, device=device, tile=tile, halo=halo, threads=threads)
    for tile, halo, threads in (
        (32, 8, 512), (32, 8, 256), (32, 8, 384), (40, 8, 512), (48, 4, 512), (42, 8, 512),
        (24, 8, 256), (16, 8, 256), (16, 4, 128), (32, 4, 256), (24, 12, 512), (26, 16, 512),
    ):
        bench(n, "ho_tiled", outer=2, device=device, tile=tile, halo=halo, threads=threads)
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
    if "--tiles" in argv:
        sweep_tiles(device)
    sizes = [int(a) for a in argv if not a.startswith("--")]
    if sizes or not any(a.startswith("--") for a in argv):
        for n in sizes or [1024, 2048, 4096]:
            t_plain = bench(n, "plain", device=device)
            t_tiled = bench(n, "pallas-tiled", device=device)
            print(f"  -> tiled/plain speedup at {n}: {t_plain / t_tiled:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
