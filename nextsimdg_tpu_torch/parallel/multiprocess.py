"""Real multi-process execution of the rank grid, and its validation.

The port's counterpart of ``nextsimdg_tpu.parallel.multiprocess``. Every
other form of the port's rank grid runs its ranks as threads of one
process; this module runs them across processes joined by
``torch.distributed`` (``parallel.distributed``), each process holding
``ranks_per_process`` ranks of one ``RankGrid`` (``parallel.process_exchange``)
and stepping them as the single-process grid does.

Two pieces:

* :func:`worker_main`: one process of an N-process run. It joins the
  group, builds its ranks' blocks of the problem (JAX's ``_build_problem``,
  or BASELINE config 5), steps them, gathers the result to process 0,
  which compares it with the port's single domain and the in-process grid
  (small problems), probes the state's health over all processes, gathers
  and checkpoints it once, and times a step and an exchange round.
* :func:`launch`: spawn the workers on this host, joined by a ``file://``
  rendezvous in the run's directory, and collect their JSON verdicts.

Paths (``--paths``): ``blocked`` (the ghost-zone mEVP, h = 4, as the JAX
worker's), ``shardmap`` (the width-1 "xla" schedule and the staged
transport), ``auto`` (the port's default: blocked, h = 16) and ``rdma``
(K7's overlapped round); a ``-ring`` suffix runs the 360-degree
``SphericalMesh`` periodic in x, whose wrap crosses a process boundary.
``gspmd`` has no PyTorch counterpart and raises ``ValueError``.

Launch on this host's CPU::

    python -m nextsimdg_tpu_torch.parallel.multiprocess --device cpu \\
        --num-processes 2 --ranks-per-process 2 --paths blocked,shardmap,blocked-ring

On a card (the default ``--device cuda``) every process drives its ranks
on it. With one card for several processes the backend is gloo and the
strips cross through pinned host buffers; nccl needs a card a process
(``parallel.distributed.choose_backend``). On another host, one process
per host::

    python -m nextsimdg_tpu_torch.parallel.multiprocess --worker \\
        --coordinator tcp://<host0>:9876 --num-processes N --process-id i \\
        --out result_i.json ...
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

DT = 600.0

#: Model arguments of each path.
PATHS = {
    "blocked": dict(mevp_backend="blocked", mevp_block_halo=4),
    "shardmap": dict(mevp_backend="xla", transport_backend="xla"),
    "auto": dict(mevp_backend="auto"),
    "rdma": dict(mevp_backend="rdma"),
}

#: Each problem's initial state and forcing: JAX's ``_build_problem``
#: (``nextsimdg_tpu/parallel/multiprocess.py``), and BASELINE config 5
#: (``run_benchmarks.bench_multihost_16m``: config 4's state and forcing).
PROBLEMS = {
    "jax": dict(
        initial=dict(hice0=1.0, cice0=0.9, hsnow0=0.05),
        phys=dict(tair=-10.0, dew2m=-12.0, pair=1e5, sw_in=10.0, lw_in=250.0, mld=10.0,
                  snowfall=1e-4, wind=8.0),
        dyn=dict(u_atm=8.0, v_atm=2.0, u_ocean=0.02, v_ocean=0.0),
    ),
    "config5": dict(
        initial=dict(hice0=1.2, cice0=0.95, hsnow0=0.1),
        phys=dict(tair=-15.0, dew2m=-17.0, pair=1e5, sw_in=5.0, lw_in=240.0, mld=10.0,
                  snowfall=1e-4, wind=6.0),
        dyn=dict(u_atm=6.0, v_atm=3.0, u_ocean=0.02, v_ocean=0.0),
    ),
}

#: Seconds the launcher lets the other workers run on after one failed.
GRACE = 10.0


def problem_mesh(problem: str, n: int, ring: bool = False):
    """The global mesh: JAX's box (512 km, closed) or config 5's (2 km
    elements); ``ring``: the 360-degree lon-lat ring of 55N-75N, periodic
    in x (the config-5 topology of the JAX worker)."""
    from ..dynamics.mesh import RectMesh, SphericalMesh

    if ring:
        return SphericalMesh(n, n, lon0=0.0, lon1=360.0, lat0=55.0, lat1=75.0, periodic_x=True)
    if problem == "config5":
        return RectMesh(n, n, dx=2e3, dy=2e3)
    return RectMesh(n, n, dx=512e3 / n, dy=512e3 / n)


def problem_inputs(problem: str, model, device, dtype):
    """(state, physics forcing, dynamics forcing) of ``problem`` on
    ``model``'s mesh (a rank's block, or the whole domain): constant fields,
    so a block's inputs are the blocks of the domain's."""
    from ..dynamics.mevp import DynamicsForcing
    from ..state import Forcing

    spec = PROBLEMS[problem]
    shape = (model.mesh.nx, model.mesh.ny)
    full = lambda value: torch.full(shape, value, device=device, dtype=dtype)
    return (
        model.initial_state(**spec["initial"], device=device, dtype=dtype),
        Forcing(**{k: full(v) for k, v in spec["phys"].items()}),
        DynamicsForcing(**{k: full(v) for k, v in spec["dyn"].items()}),
    )


def _path_kwargs(path_name: str) -> tuple:
    path = path_name.removesuffix("-ring")
    if path == "gspmd":
        raise ValueError(
            "gspmd (XLA's automatic partitioning) has no PyTorch counterpart: "
            f"run one of {sorted(PATHS)}"
        )
    if path not in PATHS:
        raise ValueError(f"unknown path {path_name!r}: one of {sorted(PATHS)}, each with '-ring'")
    return PATHS[path], path_name.endswith("-ring")


def _errors(got, ref) -> tuple:
    """(max abs difference, max of each leaf's difference over its max
    |ref|) over the leaves of two states."""
    from ..state import tree_leaves

    worst = rel = 0.0
    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        err = float((g.to(r.device, r.dtype) - r).abs().max())
        scale = float(r.abs().max())
        worst = max(worst, err)
        rel = max(rel, err / scale if scale > 0 else err)
    return worst, rel


def _flat_host(host: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in host.items():
        if isinstance(value, dict):
            out.update(_flat_host(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def load_saved_state(path) -> dict:
    """A gathered state saved by a worker's ``--save-dir``: its leaves by
    name ("hice", "velocity/u", ...), as numpy."""
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _idle_share(step, device) -> dict:
    """One profiled step of this process: wall ms, device busy ms (the
    CUDA events' own time) and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": None if busy == 0.0 else 1.0 - busy / wall}


def _exchange_round(grid, sharded, blocks, rounds: int) -> float:
    """ms of one exchange round of the blocked schedule on every rank: the
    5 velocity planes widened by h along x, then along y."""
    from ..dynamics.stencil import halo_widen
    from .exchange import run_ranks

    h = sharded.models[0].mevp.block_halo

    def body(rank):
        v = blocks[rank.local].velocity
        planes = torch.stack([v.u, v.v, v.s11, v.s22, v.s12])
        for _ in range(rounds):
            wide = halo_widen(planes, h, 1, grid.periodic[0], rank.axes[0])
            wide = halo_widen(wide, h, 2, grid.periodic[1], rank.axes[1])
        return wide

    device = grid.ranks[0].device
    run_ranks(grid.ring, body)
    _sync(device)
    grid.ring.barrier()
    t0 = time.perf_counter()
    run_ranks(grid.ring, body)
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / rounds


class _Injected:
    """A rank model whose step fails or hangs (``--inject``): the launcher's
    fault handling under test."""

    def __init__(self, model, how: str, seconds: float) -> None:
        self.model, self.how, self.seconds = model, how, seconds

    def step(self, *args, **kwargs):
        if self.how == "hang":
            time.sleep(self.seconds)
        raise RuntimeError(f"injected failure ({self.how})")


def _run_path(args, path_name: str, grid_shape, device, dtype, abort) -> dict:
    from ..dynamics.kernels import coupled_cuda as cc
    from ..io import coupled_restart
    from ..interop import coupled_state_from_numpy
    from ..runtime.health import finite_probe
    from ..state import tree_map
    from .ranks import RankGrid
    from .shardmap import build_sharded_coupled_model

    kwargs, ring = _path_kwargs(path_name)
    mesh = problem_mesh(args.problem, args.n, ring)
    grid = RankGrid(*grid_shape, device, timeout=args.timeout, ranks_per_process=args.ranks_per_process)
    grid.ring.on_abort = abort
    model, sharded = build_sharded_coupled_model(mesh, grid, degree=1, n_subcycles=args.n_subcycles, **kwargs)
    inputs = [problem_inputs(args.problem, m, device, dtype) for m in sharded.models]
    states, phys, dyns = (list(x) for x in zip(*inputs))
    if args.inject and args.process_id == args.inject_process:
        sharded.models[0] = _Injected(sharded.models[0], args.inject, 10 * args.timeout)
    entry = {"mesh": f"{grid_shape[0]}x{grid_shape[1]}", "schedule": list(model.schedule(device))}

    cc.reset_launches()
    t0 = time.perf_counter()
    out = sharded.run_blocks(states, phys, dyns, DT, args.steps)
    _sync(device)
    entry["run_s"] = time.perf_counter() - t0
    entry["launches"] = {k: v for k, v in cc.launches.items() if v}
    t0 = time.perf_counter()
    gathered = grid.gather_tree(out, device="cpu")
    entry["gather_s"] = time.perf_counter() - t0

    # The health probe over all processes: every process's flag, then one
    # all-reduce MIN. The poisoned copy has one NaN in the last process.
    entry["finite_probe"] = grid.ring.all_true(finite_probe(out))
    poisoned = out
    if args.process_id == args.num_processes - 1:
        poisoned = [tree_map(torch.clone, out[0])] + list(out[1:])
        poisoned[0].hice[0, 0, 0] = float("nan")
    entry["finite_probe_detects"] = not grid.ring.all_true(finite_probe(poisoned))

    if gathered is not None:
        # Process 0 alone: the checkpoint of the gathered state, written
        # once and read back; where h5py is missing, an in-memory recorder
        # stands in for the file (what save_coupled_state would write).
        host = coupled_restart.fetch_coupled_state(gathered)
        try:
            import h5py  # noqa: F401
        except ImportError:
            back = coupled_state_from_numpy(host, device="cpu", dtype=dtype)
            entry["checkpoint"] = "gathered-recorded-in-memory-roundtripped"
        else:
            ckpt = os.path.join(os.path.dirname(args.out), f"mp_checkpoint_{path_name}.chk")
            coupled_restart.save_coupled_state(ckpt, gathered, time=123.0)
            back = coupled_restart.load_coupled_state(ckpt, device="cpu", dtype=dtype)
            entry["checkpoint"] = "gathered-written-once-roundtripped"
        entry["checkpoint_max_abs_error"] = _errors(back, gathered)[0]
        if entry["checkpoint_max_abs_error"] != 0.0:
            raise AssertionError(f"{path_name}: the checkpoint did not round-trip bit for bit")
        if args.save_dir:
            np.savez(os.path.join(args.save_dir, f"{path_name}.npz"), **_flat_host(host))
        if args.reference:
            entry.update(_references(args, mesh, grid_shape, kwargs, gathered, device, dtype))
        del host, gathered

    if args.bench_reps:
        ms = []
        for _ in range(args.bench_reps):
            grid.ring.barrier()
            t0 = time.perf_counter()
            out = sharded.run_blocks(out, phys, dyns, DT, 1)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        entry["ms_per_step"] = ms
        entry["elements_per_s"] = args.n * args.n / (min(ms) / 1e3)
        entry["exchange_ms_per_round"] = _exchange_round(grid, sharded, out, 10)
    if args.profile and device.type == "cuda":
        # One more step on every process, process 0's under the profiler.
        step = lambda: sharded.run_blocks(out, phys, dyns, DT, 1)
        grid.ring.barrier()
        if args.process_id == 0:
            entry["profile"] = _idle_share(step, device)
        else:
            step()
            _sync(device)
    grid.ring.barrier()
    return entry


def _references(args, mesh, grid_shape, kwargs, gathered, device, dtype) -> dict:
    """The gathered state against the port's single domain and the
    in-process rank grid of the same shape, same inputs (small problems)."""
    from ..coupled import CoupledModel
    from .ranks import RankGrid
    from .shardmap import build_sharded_coupled_model

    single = CoupledModel(mesh, degree=1, n_subcycles=args.n_subcycles)
    state, phys, dyn = problem_inputs(args.problem, single, device, dtype)
    for _ in range(args.steps):
        state = single.step(state, phys, dyn, DT)
    grid = RankGrid(*grid_shape, device, timeout=args.timeout)
    _, sharded = build_sharded_coupled_model(mesh, grid, degree=1, n_subcycles=args.n_subcycles, **kwargs)
    states, physs, dyns = (list(x) for x in zip(*(problem_inputs(args.problem, m, device, dtype)
                                                  for m in sharded.models)))
    threads = grid.gather_tree(sharded.run_blocks(states, physs, dyns, DT, args.steps), device="cpu")
    out = {}
    for name, ref in (("single", state), ("threads", threads)):
        out[f"{name}_max_abs_error"], out[f"{name}_max_rel_error"] = _errors(gathered, ref)
    return out


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    from . import distributed
    from .exchange import WAIT_TIMEOUT
    from .ranks import pick_mesh_shape

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host:port, tcp:// or file:// rendezvous")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ranks-per-process", type=int, default=2)
    ap.add_argument("--paths", default="blocked")
    ap.add_argument("--problem", default="jax", choices=sorted(PROBLEMS))
    ap.add_argument("--n", type=int, default=16, help="global grid edge")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--n-subcycles", type=int, default=10)
    ap.add_argument("--bench-reps", type=int, default=0,
                    help="timed steps per path after the checks (0 = validate only)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=WAIT_TIMEOUT,
                    help="seconds any wait for another rank or process may take")
    ap.add_argument("--no-reference", dest="reference", action="store_false",
                    help="skip the single-domain and in-process comparisons (large problems)")
    ap.add_argument("--save-dir", default=None, help="process 0 saves each path's gathered state here")
    ap.add_argument("--profile", action="store_true", help="process 0's idle share over one step")
    ap.add_argument("--inject", default=None, choices=("raise", "hang"),
                    help="make one process's first rank fail or hang in its first step")
    ap.add_argument("--inject-process", type=int, default=0)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    result = {"process_id": args.process_id, "paths": {}, "ok": True}
    written = threading.Lock()

    def write(failure=None) -> None:
        if failure is not None:
            result["ok"] = False
            result["error"] = f"{type(failure).__name__}: {failure}"
        Path(args.out).write_text(json.dumps(result))

    def abort(exc) -> None:
        """A rank of this process failed: the verdict, then an exit that
        ends the threads blocked in waits on other processes (their peers'
        waits then fail too)."""
        if written.acquire(blocking=False):
            write(exc)
            os._exit(1)

    try:
        device = torch.device(args.device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("--device cuda, but this machine has no CUDA card")
            device = torch.device("cuda", args.process_id % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dtype = torch.float64 if device.type == "cpu" else torch.float32
        distributed.initialize(
            args.coordinator, args.num_processes, args.process_id, backend=args.backend,
            device=device, ranks_per_process=args.ranks_per_process, timeout=args.timeout,
        )
        result.update(
            process_count=distributed.process_count(), local_devices=distributed.local_device_count(),
            global_devices=distributed.global_device_count(), backend=distributed.backend(),
            host_staged=distributed.host_staged(device), device=str(device), dtype=str(dtype),
        )
        if result["process_count"] != args.num_processes:
            raise RuntimeError(f"{result['process_count']} processes joined, not {args.num_processes}")
        shape = pick_mesh_shape(result["global_devices"], args.n, args.n)
        for path_name in args.paths.split(","):
            result["paths"][path_name] = _run_path(args, path_name, shape, device, dtype, abort)
    except Exception as err:  # noqa: BLE001 - reported to the launcher
        if written.acquire(blocking=False):
            write(err)
        return 1
    finally:
        distributed.shutdown()
    if written.acquire(blocking=False):
        write()
    return 0


# ---------------------------------------------------------------------------
# Launcher side
# ---------------------------------------------------------------------------

def launch(
    num_processes: int,
    ranks_per_process: int = 2,
    paths: Sequence[str] = ("blocked",),
    n: int = 16,
    steps: int = 2,
    n_subcycles: int = 10,
    bench_reps: int = 0,
    out_dir: Optional[str] = None,
    timeout: float = 600.0,
    device: str = "cuda",
    backend: Optional[str] = None,
    problem: str = "jax",
    worker_args: Sequence[str] = (),
) -> list:
    """Spawn an N-process run on this host; return the workers' verdicts.

    Each worker is a fresh Python process (one torch thread,
    ``OMP_NUM_THREADS=1``) holding ``ranks_per_process`` ranks; they join
    through a ``file://`` rendezvous in ``out_dir`` (a temporary directory
    by default), which no other run shares. On CUDA the kernels are
    built (or loaded) here first, so that no two workers build them.
    Raises ``RuntimeError`` on a timeout or a failed worker (its error and
    the others' after a grace of ``GRACE`` s), killing every process it
    spawned; returns the per-process result dicts. ``worker_args``: more
    flags of ``worker_main`` (``--timeout``, ``--save-dir``, ``--inject``).
    """
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda, but this machine has no CUDA card")
        from ..dynamics.kernels import coupled_cuda as cc

        cc.build()
    own_tmp = None
    if out_dir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="nextsim_mp_")
        out_dir = own_tmp.name
    out_dir = os.path.abspath(out_dir)
    rendezvous = Path(out_dir) / f"rendezvous_{uuid.uuid4().hex}"
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every worker is on this host
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))

    outs, logs, procs = [], [], []
    try:
        for i in range(num_processes):
            outs.append(Path(out_dir) / f"proc{i}.json")
            logs.append(Path(out_dir) / f"proc{i}.log")
            cmd = [
                sys.executable, "-m", "nextsimdg_tpu_torch.parallel.multiprocess", "--worker",
                "--coordinator", f"file://{rendezvous}", "--num-processes", str(num_processes),
                "--process-id", str(i), "--out", str(outs[i]),
                "--ranks-per-process", str(ranks_per_process), "--paths", ",".join(paths),
                "--problem", problem, "--n", str(n), "--steps", str(steps),
                "--n-subcycles", str(n_subcycles), "--bench-reps", str(bench_reps),
                "--device", str(device), *(["--backend", backend] if backend else []), *worker_args,
            ]
            with open(logs[i], "w") as log:
                procs.append(subprocess.Popen(cmd, env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT))
        _wait_all(procs, timeout, logs)
    finally:
        for p in procs:  # the exact processes spawned here, never a pattern
            if p.poll() is None:
                p.kill()
                p.wait()

    results, errors = [], []
    for i, out in enumerate(outs):
        if not out.exists():
            errors.append(f"worker {i} produced no result (rc={procs[i].returncode}); tail:\n{_tail(logs[i])}")
            continue
        results.append(json.loads(out.read_text()))
        if not results[-1]["ok"]:
            errors.append(f"worker {i} failed: {results[-1].get('error')}")
    if own_tmp is not None:
        own_tmp.cleanup()
    if errors:
        raise RuntimeError("; ".join(errors))
    return results


def _tail(path: Path, n: int = 2000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def _wait_all(procs, timeout: float, logs) -> None:
    """Until every worker has exited: kill the rest ``GRACE`` s after one
    failed; raise ``RuntimeError`` after ``timeout`` s."""
    deadline, failed_at = time.monotonic() + timeout, None
    while any(p.poll() is None for p in procs):
        now = time.monotonic()
        if failed_at is None and any(p.returncode not in (None, 0) for p in procs):
            failed_at = now
        if failed_at is not None and now - failed_at > GRACE:
            return
        if now > deadline:
            hung = [i for i, p in enumerate(procs) if p.poll() is None]
            raise RuntimeError(
                f"multiprocess run timed out after {timeout} s; workers {hung} still ran; tail of "
                f"worker {hung[0]}:\n{_tail(logs[hung[0]])}"
            )
        time.sleep(0.05)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--worker" in argv:
        argv.remove("--worker")
        return worker_main(argv)
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--ranks-per-process", type=int, default=2)
    ap.add_argument("--paths", default="blocked,shardmap,blocked-ring")
    ap.add_argument("--problem", default="jax", choices=sorted(PROBLEMS))
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--n-subcycles", type=int, default=10)
    ap.add_argument("--bench-reps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    results = launch(
        args.num_processes, args.ranks_per_process, paths=args.paths.split(","), n=args.n,
        steps=args.steps, n_subcycles=args.n_subcycles, bench_reps=args.bench_reps,
        timeout=args.timeout, device=args.device, backend=args.backend, problem=args.problem,
    )
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
