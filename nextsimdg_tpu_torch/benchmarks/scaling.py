"""Weak-scaling harness of the rank grid: elements/s against rank count.

The twin of ``benchmarks/scaling.py``. It runs the coupled dynamics step
on 1, 2, 4, ... ranks with the problem per rank held fixed (weak
scaling) and reports throughput and efficiency against one rank. Here the
ranks are the threads of one process's ``RankGrid`` (``run_once``), all on
the one device unless given several; on one card that shows what the
exchange costs, not how the step scales over cards.

Three schedules are measurable: ``shardmap`` (the width-1 "xla" mEVP,
strips before each half of every subcycle), ``blocked`` (ghost-zone
exchange, one strip pair per axis per h subcycles, mevp_tiled on the
widened block) and ``rdma`` (K7's overlapped round); ``auto`` is the port's
default (blocked, h = 16; JAX's default ``gspmd`` has no counterpart). The
harness prints each schedule's analytic per-rank communication budget
(``comm_budget``: messages and bytes per coupled step, the JAX package's
arithmetic).

The process leg (``--processes N``) spawns N workers joined by
``torch.distributed`` (``parallel.multiprocess.launch``), each holding
``--ranks-per-process`` ranks, and reports their gathered result against
the single domain and their step time; on one card the processes share it
by time slices over gloo with host-staged strips, which measures the
launch path, not a cluster's network.

Usage (repository root; the card unless ``--device cpu``)::

    python -m nextsimdg_tpu_torch.benchmarks.scaling [local_n] [path ...] [--max-ranks R]
    python -m nextsimdg_tpu_torch.benchmarks.scaling --processes N [--ranks-per-process K]
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from ..dynamics.mesh import RectMesh
from ..parallel import RankGrid, build_sharded_coupled_model, pick_mesh_shape
from ..parallel.multiprocess import PATHS, problem_inputs

#: Ghost width of the blocked and rdma exchanges in this harness.
BLOCK_HALO = 8


def comm_budget(local_n: int, n_subcycles: int = 100, itemsize: int = 4) -> dict:
    """Analytic per-rank halo traffic per coupled step, by schedule.

    The mEVP subcycle loop only (the dominant exchanger; the transport
    adds one ghost-zone exchange per round of CFL substeps). An interior
    rank of a 2-D grid exchanges with 4 neighbours; a strip is one column
    or row of ``local_n`` elements per plane.
    """
    strip = local_n * itemsize
    h = BLOCK_HALO
    rounds = math.ceil(n_subcycles / h)
    # Width-1: every neighbour shift of the 13-shift subcycle crosses the
    # block edge once, on both axes.
    per_sub = dict(messages=n_subcycles * 13 * 2, bytes=n_subcycles * 13 * 2 * strip)
    # Ghost zones: one strip pair per axis per h subcycles, h wide, of the
    # 5 state planes a round and the 7 const planes once a step.
    blocked = dict(messages=rounds * 2 * 2, bytes=(rounds * 5 + 7) * 2 * 2 * h * strip)
    # rdma: the blocked volume, its copies overlapped with the interior.
    rdma = dict(blocked)
    return {"shardmap": per_sub, "blocked": blocked, "rdma": rdma}


def _path_kwargs(path: str, local_n: int) -> dict:
    """The path's model arguments, the ghost width BLOCK_HALO, at most half
    the block (rdma's limit)."""
    kwargs = dict(PATHS[path])
    if path in ("blocked", "rdma"):
        kwargs["mevp_block_halo"] = min(BLOCK_HALO, local_n // 2)
    return kwargs


def run_once(devices, local_n: int, chunk: int = 8, path: str = "auto") -> tuple:
    """(elements/s, selected schedules) of ``chunk`` dynamics steps (thermo
    off) on a rank grid of ``len(devices)`` ranks (``devices``: one device a
    rank, in rank order), local_n^2 elements a rank, best of 3 chunks after
    a warm-up chunk (config 5's 2 km mesh and config 4's state, f32 on a
    card, f64 on the CPU)."""
    devices = [torch.device(d) for d in devices]
    px, py = pick_mesh_shape(len(devices), local_n * len(devices), local_n * len(devices))
    n_x, n_y = local_n * px, local_n * py
    dtype = torch.float32 if devices[0].type == "cuda" else torch.float64
    mesh = RectMesh(n_x, n_y, dx=2e3, dy=2e3)
    grid = RankGrid(px, py, devices)
    model, sharded = build_sharded_coupled_model(mesh, grid, degree=1, n_subcycles=100, **_path_kwargs(path, local_n))
    states, phys, dyns = (list(x) for x in zip(*(
        problem_inputs("config5", m, d, dtype) for m, d in zip(sharded.models, devices)
    )))

    def run(blocks):
        out = sharded.run_blocks(blocks, phys, dyns, 600.0, chunk, do_thermo=False)
        for device in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(device)
        return out

    states = run(states)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        states = run(states)
        best = min(best, time.perf_counter() - t0)
    mevp = model.mevp_schedule()
    if mevp in ("blocked", "rdma"):
        mevp = f"{mevp}/h={model.mevp.block_halo}"
    return n_x * n_y * chunk / best, {"mevp": mevp, "transport": model.transport_schedule()}


def run_multiprocess(num_processes: int, ranks_per_process: int = 1, n: int = 32, device: str = "cuda",
                     paths=("blocked", "shardmap"), timeout: float = 600.0) -> list:
    """The process leg: parity and step time of 1 and ``num_processes``
    processes (``parallel.multiprocess.launch``), one JSON line a path;
    returns the lines."""
    from ..parallel.multiprocess import launch

    lines = []
    for count in [1, num_processes] if num_processes > 1 else [1]:
        results = launch(
            count, ranks_per_process, paths=paths, n=n, steps=1, n_subcycles=20, bench_reps=3,
            device=device, timeout=timeout,
        )
        r0 = results[0]
        for path, entry in r0["paths"].items():
            lines.append({
                "processes": count,
                "global_ranks": r0["global_devices"],
                "backend": r0["backend"],
                "host_staged": r0["host_staged"],
                "path": path,
                "single_max_abs_error": entry["single_max_abs_error"],
                "threads_max_abs_error": entry["threads_max_abs_error"],
                "ms_per_step": entry["ms_per_step"],
                "elements_per_s": float(f"{entry['elements_per_s']:.4g}"),
                "global_grid": f"{n}x{n}",
            })
            print(json.dumps(lines[-1]), flush=True)
    return lines


def _flag(args: list, name: str, default):
    if name not in args:
        return default
    i = args.index(name)
    value = args[i + 1]
    del args[i: i + 2]
    return type(default)(value)


def main(argv) -> None:
    args = list(argv[1:])
    device = _flag(args, "--device", "cuda")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the CPU")
    if "--processes" in args:
        nproc = _flag(args, "--processes", 2)
        rpp = _flag(args, "--ranks-per-process", 1)
        run_multiprocess(nproc, rpp, n=32, device=device)
        return
    max_ranks = _flag(args, "--max-ranks", 4)
    local_n = int(args[0]) if args and args[0].isdigit() else 128
    paths = [a for a in args if not a.isdigit()] or ["auto"]
    counts = [1]
    while counts[-1] * 2 <= max_ranks:
        counts.append(counts[-1] * 2)

    for name, budget in comm_budget(local_n).items():
        print(json.dumps({
            "comm_budget_per_rank_per_step": name,
            "messages": budget["messages"],
            "bytes": budget["bytes"],
            "local_grid": f"{local_n}x{local_n}",
        }), flush=True)
    for path in paths:
        base = None
        for k in counts:
            throughput, selected = run_once([device] * k, local_n, chunk=8, path=path)
            base = throughput if base is None else base
            print(json.dumps({
                "ranks": k,
                "path": path,
                "elements_per_s": float(f"{throughput:.4g}"),
                "weak_scaling_efficiency": float(f"{throughput / (base * k):.4g}"),
                "local_grid": f"{local_n}x{local_n}",
                "selected_kernels": selected,
            }), flush=True)


if __name__ == "__main__":
    main(sys.argv)
