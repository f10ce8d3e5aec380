"""Element updates/s of each battery config the port runs, on a CUDA card.

The twin of ``benchmarks/run_benchmarks.py``: the same config names, and
per config the same mesh, state and forcing. Usage (repository root)::

    python -m nextsimdg_tpu_torch.benchmarks.run_benchmarks [config ...|all] [--ranks PxQ]

Default: the fast subset ``dev1 box``. ``--ranks 2x2`` runs
``multihost_16m`` on a rank grid of the card (``parallel.RankGrid``), the
twin of the JAX function's multi-device branch; without it that config
runs single-device, as the JAX function does on one device. Each result
prints as one JSON line with its ``config``, its ``chunk`` of steps and the
card (name, ``nvidia-smi`` name and power limit).

Timing: a warm-up chunk, then the best of 3 chunks on the host clock, each
ending in ``torch.cuda.synchronize()``; the state carries on from chunk to
chunk, as in the JAX battery. The chunks are sized so that a timed chunk
takes about 0.3 s or more on an H100 at the port's step times (PERF.md);
the JAX ones were sized against its remote-dispatch latency.

The JAX configs the port cannot run yet stay out of ``CONFIGS``:
``advection`` (dG2 transport), ``box_adaptive``, ``coupled_1m_aweighted``,
``ho_coupled_1m_periodic`` and the ``*_spmd`` ones (ROADMAP M11b).
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import torch

from ..coupled import CoupledModel
from ..dynamics import RectMesh, SphericalMesh, synthetic_coastline
from ..dynamics.mevp import DynamicsForcing
from ..state import Forcing
from .common import card, require_cuda, with_high_order

DT = 600.0


def _device(device) -> torch.device:
    """The card unless the caller asks for the CPU (the tests do)."""
    return require_cuda("cuda") if device is None else torch.device(device)


def _timed_chunk(run, state, device) -> float:
    """Best of 3 seconds of ``run(state)`` after a warm-up call, each ending
    in a device synchronise on a card; the state carries on."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    state = run(state)
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state = run(state)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _result(metric: str, elements: int, chunk: int, best: float, unit: str = "elements/s") -> dict:
    return {
        "metric": metric,
        "value": float(f"{elements * chunk / best:.4g}"),
        "unit": unit,
        "chunk": chunk,
        "ms_per_step": float(f"{best / chunk * 1e3:.4g}"),
    }


def bench_dev1(n: int = 512, chunk: int = 100, device=None) -> dict:
    """Thermodynamics-only column physics throughput (dev1 physics, 512^2).

    The port's ``NextsimPhysics()`` with its default modules and parameters
    on ``state.dummy_forcing``; the JAX function calls ``configure()`` on
    it first, which reads the (empty) config and leaves the same defaults:
    the port has no config engine until ROADMAP M8.
    """
    from ..physics import NextsimPhysics
    from ..state import PrognosticBuilder, dummy_forcing

    device = _device(device)
    dtype = torch.float32
    phys = NextsimPhysics()
    prog = (
        PrognosticBuilder(n, n, nlayers=1, dtype=dtype, device=device)
        .hice(0.1).cice(0.5).hsnow(0.0).sst(-1.0).sss(32.0).tice(-1.0)
        .build()
    )
    forcing = dummy_forcing(n, n, dtype=dtype, device=device)
    new_ice = torch.zeros((n, n), device=device, dtype=dtype)

    def run(carry):
        p, ni = carry
        for _ in range(chunk):
            p, diags = phys.step(p, forcing, ni, DT)
            ni = diags.new_ice
        return p, ni

    best = _timed_chunk(run, (prog, new_ice), device)
    return _result(
        f"thermo column updates/s (dev1 physics, {n}x{n}, f32)", n * n, chunk, best, "columns/s"
    )


def _forcing(n: int, device, tair, dew2m, sw_in, lw_in, wind, v_atm):
    full = lambda v: torch.full((n, n), v, device=device, dtype=torch.float32)
    pf = Forcing(
        tair=full(tair), dew2m=full(dew2m), pair=full(1e5), sw_in=full(sw_in),
        lw_in=full(lw_in), mld=full(10.0), snowfall=full(1e-4), wind=full(wind),
    )
    df = DynamicsForcing(
        u_atm=full(wind), v_atm=full(v_atm), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    return pf, df


def bench_box(n: int = 256, n_subcycles: int = 100, chunk: int = 160, device=None) -> dict:
    """BASELINE config 3: wind-driven box, 100 mEVP subcycles, thermo off
    ("auto" schedule: the tiled kernels)."""
    device = _device(device)
    model = CoupledModel(RectMesh(n, n, dx=512e3 / n, dy=512e3 / n), degree=1, n_subcycles=n_subcycles)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device=device, dtype=torch.float32)
    pf, df = _forcing(n, device, -10.0, -12.0, 10.0, 250.0, 8.0, 2.0)
    best = _timed_chunk(lambda s: model.run(s, pf, df, DT, chunk, do_thermo=False), state, device)
    return _result(
        f"mEVP box element updates/s ({n}x{n}, {n_subcycles} subcycles, f32)", n * n, chunk, best
    )


def bench_coupled_1m(
    n: int = 1024, land_mask: bool = False, spherical: bool = False, high_order: bool = False,
    chunk: int = 40, n_subcycles: int = 100, device=None,
) -> dict:
    """BASELINE config 4: coupled thermo+dynamics, ~1M elements, on the
    "auto" schedule.

    ``land_mask=True`` adds the synthetic pan-Arctic-style coastline;
    ``spherical=True`` runs the lon-lat window 40W-40E, 55N-85N;
    ``high_order=True`` selects the CG2/dG1 solver through the registry
    (reset after the build).
    """
    device = _device(device)
    if spherical:
        mesh = SphericalMesh(n, n, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)
    else:
        mesh = RectMesh(n, n, dx=4e3, dy=4e3)
    ocean = synthetic_coastline(n) if land_mask else None
    build = lambda: CoupledModel(mesh, degree=1, n_subcycles=n_subcycles, ocean_mask=ocean)
    model = with_high_order(build) if high_order else build()
    state = model.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    pf, df = _forcing(n, device, -15.0, -17.0, 5.0, 240.0, 6.0, 3.0)
    best = _timed_chunk(lambda s: model.run(s, pf, df, DT, chunk), state, device)
    tags = "".join([
        ", synthetic coastline" if land_mask else "",
        ", spherical lon-lat" if spherical else "",
        ", CG2/dG1" if high_order else "",
    ])
    return _result(
        f"coupled thermo+dynamics element updates/s ({n}x{n} = {n * n / 1e6:.2g}M elements{tags}, "
        f"{model.mevp_schedule()}, f32)", n * n, chunk, best,
    )


def bench_multihost_16m(
    n: int = 4096, chunk: int = None, ranks=None, n_subcycles: int = 100, device=None,
) -> dict:
    """BASELINE config 5: 16M elements, config 4's state and forcing.

    Single-device by default, as the JAX function runs on one device; with
    ``ranks=(P, Q)`` on a P x Q ``RankGrid`` of the device (the blocked
    ghost-zone mEVP and the spmd tiled transport on resident rank blocks),
    the twin of its multi-device branch.
    """
    from ..parallel import RankGrid, build_sharded_coupled_model

    device = _device(device)
    mesh = RectMesh(n, n, dx=2e3, dy=2e3)
    model = CoupledModel(mesh, degree=1, n_subcycles=n_subcycles)
    state = model.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32)
    pf, df = _forcing(n, device, -15.0, -17.0, 5.0, 240.0, 6.0, 3.0)
    if ranks is None:
        chunk = 6 if chunk is None else chunk
        run = lambda s: model.run(s, pf, df, DT, chunk)
        scope = "single-device"
    else:
        chunk = 2 if chunk is None else chunk
        grid = RankGrid(*ranks, device)
        _, sharded = build_sharded_coupled_model(
            mesh, grid, degree=1, n_subcycles=n_subcycles, mevp_backend="blocked",
        )
        pf_blocks, df_blocks = grid.split_tree(pf), grid.split_tree(df)
        state = grid.split_tree(state)
        run = lambda blocks: sharded.run_blocks(blocks, pf_blocks, df_blocks, DT, chunk)
        scope = f"{ranks[0]}x{ranks[1]} rank grid on one device, blocked"
    best = _timed_chunk(run, state, device)
    return _result(
        f"full model element updates/s ({n}x{n} = {n * n / 1e6:.3g}M elements, {scope}, f32)",
        n * n, chunk, best,
    )


CONFIGS = {
    "dev1": bench_dev1,
    "box": bench_box,
    "coupled_1m": bench_coupled_1m,
    "coupled_1m_mask": partial(bench_coupled_1m, land_mask=True),
    "coupled_1m_spherical": partial(bench_coupled_1m, land_mask=True, spherical=True, chunk=32),
    "spherical_16m": partial(bench_coupled_1m, n=4096, land_mask=True, spherical=True, chunk=5),
    "ho_coupled_256": partial(bench_coupled_1m, n=256, high_order=True, chunk=24),
    "ho_coupled_512": partial(bench_coupled_1m, n=512, high_order=True, chunk=24),
    "ho_coupled_1m": partial(bench_coupled_1m, high_order=True, chunk=16),
    "multihost_16m": bench_multihost_16m,
}


def run_config(name: str, device=None, **overrides) -> dict:
    """One config's result with its ``config`` and ``device``; ``overrides``
    shrink it (the tests: n, n_subcycles, chunk) or give ``multihost_16m``
    its ``ranks``."""
    device = _device(device)
    result = CONFIGS[name](device=device, **overrides)
    result["config"] = name
    if device.type == "cuda":
        result["device"] = {"platform": "gpu", **card(device)}
    else:
        result["device"] = {"platform": device.type}
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ranks = None
    if "--ranks" in argv:
        i = argv.index("--ranks")
        ranks = tuple(int(x) for x in argv[i + 1].lower().split("x"))
        del argv[i:i + 2]
    names = argv or ["dev1", "box"]
    if names == ["all"]:
        names = list(CONFIGS)
    unknown = [name for name in names if name not in CONFIGS]
    if unknown:
        print(f"run_benchmarks: unknown configs {unknown}; known: {list(CONFIGS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("run_benchmarks: no CUDA device; the battery runs only on a GPU", file=sys.stderr)
        return 1
    for name in names:
        extra = {"ranks": ranks} if ranks and name == "multihost_16m" else {}
        print(json.dumps(run_config(name, torch.device("cuda", 0), **extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
