"""Smoke run of the PyTorch/CUDA port (nextsimdg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``nextsimdg_tpu_torch/csrc`` and
drives the port's roofline path and its six model paths. The roofline path
(``nextsimdg_tpu_torch.benchmarks.roofline``, the twin of
``benchmarks/roofline.py``): the ``chain`` kernel (csrc/roofline.cu, the
counterpart of the TPU kernel ``measure_vpu_peak``), a float32 chain held in
registers, measures the card's fused float32 ceilings (fma: the TPU kernel's
x = a*x + b; fma_imm: the addend an immediate, the FFMA issue rate) and its
unfused one (mul_add, as the port's kernels issue), and a streaming add its
HBM rate. The model paths run float32,
dG1 tracers (hice, cice, hsnow), 100 mEVP subcycles, dt = 600 s,
CFL-adaptive transport substeps:

* the headline dynamics-only step (BASELINE config 3, ``bench.py``): a
  closed 256 x 256 mesh of 2 km elements, wind (8, 2) m/s, ocean current
  (0.02, 0) m/s, on K1's kernel schedule (``mevp_backend="pallas"``:
  mevp_stress, mevp_velocity, dg1_sample_cfl, dg1_rk_stage);
* the coupled thermo+dynamics step of BASELINE config 4
  (``benchmarks/run_benchmarks.py`` ``bench_coupled_1m``): a closed
  1024 x 1024 mesh of 4 km elements, initial hice 1.2, cice 0.95, hsnow
  0.1, physics forcing tair -15, dew2m -17, pair 1e5, sw_in 5, lw_in 240,
  mld 10, snowfall 1e-4, wind 6; wind (6, 3) m/s, ocean (0.02, 0) m/s, on
  the default ("auto") schedule, the ghost-zone tiled kernels mevp_tiled
  and transport_tiled with dg1_sample_cfl, and the column physics;
* config 4's spherical coastline variant (``run_benchmarks.py``
  ``coupled_1m_spherical``, ``bench_coupled_1m(land_mask=True,
  spherical=True)``): the same step on a closed 1024 x 1024 lon-lat window
  (40W-40E, 55N-85N) with ``synthetic_coastline(1024)``, on
  ``mevp_backend="pallas"``: mevp_single (all 100 subcycles in one
  cooperative launch) with the metric planes, dg1_sample_cfl and the
  metric transport_tiled with the coastline face masks;
* the higher-order (CG2 velocity, dG1 stress) coupled step
  (``run_benchmarks.py`` ``ho_coupled_1m``, ``bench_coupled_1m(high_order=True)``):
  config 4's mesh, state and forcing with ``Nextsim::IDynamics =
  Nextsim::MEVPHighOrder`` selected through the module registry, on "auto":
  ho_tiled (ghost-zone windows of the 17 HO state planes, one a
  thread-block cluster launch, shipped as clusters of one block: one 48^2
  window a block; sm_90 or newer), the CG2 velocity
  sampled at the quadrature points, and the ``qv`` form of transport_tiled;
  and the same at 256^2 on ``mevp_backend="pallas"`` (``ho_coupled_256``):
  ho_single, all 100 HO subcycles in one cooperative launch;
* BASELINE config 5 (``run_benchmarks.py`` ``bench_multihost_16m``,
  ``multihost_16m``): a closed 4096 x 4096 mesh of 2 km elements with
  config 4's state and forcing, decomposed over a 2 x 2 grid of 2048^2 rank
  blocks held by this process on the one card (``parallel.RankGrid``; each
  rank a thread with a compute and a copy stream), on "auto" (the blocked
  exchange: mevp_tiled on blocks widened by h = 16 ghost cells once per 16
  subcycles) and on "rdma" (K7: rdma_stage, the strips copied while
  mevp_tiled runs the interior, rdma_band on the patch's cone of the edge
  bands, by clusters of blocks along each band); the
  transport is transport_tiled on the block widened by H ghost cells, the
  CFL count one max over the ranks.

Phases, each printed on its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the kernels' compile (or cache hit) time, registers and spills;
   the launch of the cluster kernels at their paths' shapes (ho_tiled at
   1024^2, shipped and in 2 x 2 clusters; rdma_band on config 5's bands,
   with its launch bound): cluster shape, sub-window or
   segment, threads, shared bytes, registers, the clusters the card holds
   at once, the blocks of a launch and the SMs it reaches; and, printed
   after the checks (``cuobjdump -sass`` of the library runs
   beside them), the FFMA, FMUL and FADD counts of the chain kernel's fma,
   fma_imm and mul_add forms: --fmad=false must leave the first two fused
   and the third unfused;
3. roofline: the chain kernel against its plain version for every link
   (fma, mul_add, div, sqrt, shift0, shift1, fma_imm) and both unrolls (16,
   64), on seeded planes at 512^2 and 1000 x 968, 160 and 128 links; then,
   from zeroed launch counts, ``measure_vpu_peak`` (fma, fma_imm, mul_add)
   and ``measure_hbm_peak``, each rate held below the data sheet's peak;
4. check: K1's four kernels against their plain PyTorch versions at 256^2,
   then mevp_tiled and transport_tiled against theirs and against K1's
   schedule on the same inputs, at 1024^2 and at a ragged 1000 x 968, with
   100 subcycles and with a count that is not a multiple of the halo; then
   mevp_single against its plain version (256^2 spherical, N = 1 and 13),
   K1's schedule (uniform consts, 256^2, N = 100) and mevp_tiled
   (spherical consts, 1024^2 and 1000 x 968), and the metric
   transport_tiled and dg1_rk_stage against their plain versions and each
   other at 1024^2 spherical with the coastline; then ho_single against its
   plain version (256^2, N = 1, 13, 100), ho_tiled against it (1024^2,
   N = 1 and 13, and 1000 x 968), the two against each other (256^2 and
   512^2), ho_tiled's shipped window (a cluster of one block) against
   clusters of 2 to 16 blocks that push their edges through distributed
   shared memory (1024^2, N = 13), and the qv form of transport_tiled
   against its plain version (1024^2); on config 5's 2048^2 rank blocks rdma_stage and rdma_band
   launch by launch against their plain versions, and the rdma round
   against the blocked round;
5. slice: for each path, one step on the kernels against the plain path on
   the card (the spherical one on "pallas" and on "auto", and one step of
   the uniform coastline variant ``coupled_1m_mask``; both HO paths), then
   20 steps from zeroed launch counters: every leaf finite, 0 <= cice <= 1,
   hice >= 0, hsnow >= 0, every kernel of the path launched, and with a
   coastline the land tracers unchanged and u = v = 0 on every node that
   touches land;
   for config 5 one decomposed step (blocked and rdma) against the
   single-device kernel step at 4096^2 (expected 0), the decomposed kernel
   step against the decomposed plain step at 512^2, and 4 steps of each
   form;
6. time (CUDA events, each function warmed up once; a plain path, run by
   the checks before, timed once): ms per step and element updates/s of
   each path, of the config-4 step on K1's schedule, on the tiled one and on
   the plain path, of the physics alone, the spherical step on mevp_single,
   on mevp_tiled and on the plain path, the HO paths' step on their kernels
   and on the plain path, and each kernel per call against its plain
   version and its bound; config 5's single-device, 2 x 2 blocked and 2 x 2
   rdma steps, the blocked round against the rdma round, the dynamics step
   at h = 4, 8, 16, the spmd transport at H = 4, 8, 16, and profiles; last,
   the profiler's device duration of rdma_stage and of rdma_band on the x
   and y bands, beside their back-to-back times (every row of the summary
   carries the back-to-back time per call). One card shows what
   the exchange costs, not how the step scales over cards.
   The "auto" threshold sweeps and the tile sweeps are
   ``python -m nextsimdg_tpu_torch.benchmarks.mevp_large``'s.

Any failure raises (non-zero exit); there is no CPU path. The script's wall
time, the card's ``nvidia-smi`` name and power limit and the kernels' JSON
summary come last but one; each kernel's row carries ``bound_ms`` on the
data sheet's peaks and ``measured_bound_ms`` on the measured HBM and
mul_add rates. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from nextsimdg_tpu_torch import coupled, modules
from nextsimdg_tpu_torch.benchmarks import mevp_large, roofline
from nextsimdg_tpu_torch.benchmarks.common import device_ms
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import MEVPParams, RectMesh, SphericalMesh, synthetic_coastline
from nextsimdg_tpu_torch.dynamics import mevp_ho
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import ho_single_cuda as hsc
from nextsimdg_tpu_torch.dynamics.kernels import ho_tiled_cuda as htc
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.kernels import mevp_single_cuda as single
from nextsimdg_tpu_torch.dynamics.kernels import mevp_tiled_cuda as mt
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, MEVPSolver, VelocityState
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model, run_ranks
from nextsimdg_tpu_torch.state import Forcing

N = 256
N4 = 1024  # BASELINE config 4
N16 = 4096  # BASELINE config 5: 16.8M elements
RANKS = (2, 2)  # config 5's rank grid, all ranks on the one card
N_PLAIN_GRID = 512  # the decomposed plain step's size
RAGGED = (1000, 968)  # a multiple of no tile
N_SUBCYCLES = 100
DT = 600.0
SEED = 0
#: Subcycles of a timed mevp_tiled call.
TILED_SUBCYCLES = 8
#: Steps of each config-5 form from zeroed launch counts (20 on the other
#: paths): every kernel of the form launches in each step, and a 2 x 2 step
#: takes 0.2-0.4 s of host issue.
N5_STEPS = 4
K1 = "nextsimdg_tpu/dynamics/kernels/coupled_pallas.py:62"
REPLACES = {
    "mevp_stress": K1, "mevp_velocity": K1, "dg1_sample_cfl": K1, "dg1_rk_stage": K1,
    "mevp_tiled": "nextsimdg_tpu/dynamics/kernels/mevp_tiled.py:173",
    "transport_tiled": "nextsimdg_tpu/dynamics/kernels/transport_tiled.py:105",
    "mevp_single": "nextsimdg_tpu/dynamics/kernels/mevp_pallas.py:49",
    "ho_single": "nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py:45",
    "ho_tiled": "nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py:118",
    "rdma_stage": "nextsimdg_tpu/dynamics/kernels/mevp_rdma.py:61",
    "rdma_band": "nextsimdg_tpu/dynamics/kernels/mevp_rdma.py:61",
    "chain": "benchmarks/roofline.py:154",
}
SOURCES = {
    "mevp_stress": "nextsimdg_tpu_torch/csrc/mevp.cu",
    "mevp_velocity": "nextsimdg_tpu_torch/csrc/mevp.cu",
    "dg1_sample_cfl": "nextsimdg_tpu_torch/csrc/transport.cu",
    "dg1_rk_stage": "nextsimdg_tpu_torch/csrc/transport.cu",
    "mevp_tiled": "nextsimdg_tpu_torch/csrc/mevp_tiled.cu",
    "transport_tiled": "nextsimdg_tpu_torch/csrc/transport_tiled.cu",
    "mevp_single": "nextsimdg_tpu_torch/csrc/mevp_single.cu",
    "ho_single": "nextsimdg_tpu_torch/csrc/ho_single.cu",
    "ho_tiled": "nextsimdg_tpu_torch/csrc/ho_tiled.cu",
    "rdma_stage": "nextsimdg_tpu_torch/csrc/mevp_rdma.cu",
    "rdma_band": "nextsimdg_tpu_torch/csrc/mevp_rdma.cu",
    "chain": "nextsimdg_tpu_torch/csrc/roofline.cu",
}
PATH_KERNELS = {
    "headline": ("mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage"),
    "config4": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "spherical": ("mevp_single", "dg1_sample_cfl", "transport_tiled"),
    "ho_coupled_1m": ("ho_tiled", "transport_tiled"),
    "ho_coupled_256": ("ho_single", "transport_tiled"),
    "multihost_16m": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled", "rdma_stage", "rdma_band"),
    "multihost_16m_blocked": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "roofline": ("chain",),
}
VELOCITY = ("u", "v", "s11", "s22", "s12")
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# float32 operations per element of each body, counted from
# csrc/mevp_body.cuh and csrc/dg1_body.cuh (a sqrt or a divide counts as
# one): the stress half, the velocity half (uniform consts), the CFL
# sampling, and one RK stage (velocity sampling + 3 tracers); and, counted
# from csrc/ho_body.cuh as the kernels run them (dense tables), the HO
# stress half per element and velocity half per node index.
OPS = {
    "stress": 80, "velocity": 42, "cfl": 92, "stage": 80 + 3 * 243,
    "ho_stress": 516, "ho_velocity": 398,
}
#: Planes one HO call moves: 17 state planes in, 29 consts in, 17 out.
HO_PLANES_MOVED = 17 + 29 + 17
HO = "Nextsim::MEVPHighOrder"
# Single launches: the kernel and the plain version run the same float32
# operations in the same order (a width divides through its float32
# reciprocal on both sides); 1e-5 of the plane's max covers an ulp where
# PyTorch's own kernels round differently.
TOL_LAUNCH = 1e-5
# One full step: 100 subcycles amplify single-ulp differences through the
# shared divide, hence 1e-3 for the mEVP planes; the tracers move by
# dt * velocity, 1e-5 of their max.
TOL_STEP_MEVP = 1e-3
TOL_STEP_TRACER = 1e-5
# The tiled kernels run the same element bodies as K1's kernels in the same
# order (--fmad=false), so they should equal K1's schedule exactly; 1e-6 of
# the plane's max is the failure line.
TOL_SAME_SCHEDULE = 1e-6
# The chain kernel's mul_add, div, sqrt and shift links round each operation
# as PyTorch's CUDA kernels do (IEEE divide and square root): expected 0,
# failure above 1e-6 of the plane's max. Its fma form rounds once per link
# where a * x + b rounds twice; the float64 chain's contraction (|a| < 1)
# keeps the error of L links below L x 2^-24 of the plane's max, held at 2 L x
# 2^-24 against the float64 chain.
TOL_CHAIN = 1e-6
#: The checks' chains: iterations per unroll, 160 and 128 links.
CHAIN_CHECK_ITERS = {16: 10, 64: 2}


@dataclass
class Row:
    """One kernel's line of the summary: its largest check error, ms per
    call of the kernel and of its plain version, the bytes (each input read
    once, each output written once) and float32 operations of that call,
    the ms of one PyTorch call of the same function, where there is one,
    and whether its operations issue as fused multiply-adds (the chain's
    fma form; the port's kernels issue each operation on its own)."""

    err: float
    ms: float
    plain_ms: float
    n_bytes: float
    n_ops: float
    library_ms: float = None
    fused: bool = False


def log(phase: str, message: str) -> None:
    print(f"[{phase}] {message}", flush=True)


def compare(name: str, got, ref, tol: float) -> float:
    """Max abs error; fails unless it is within tol x the plane's max |ref|."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / scale if scale > 0 else err
    ok = err <= tol * scale if scale > 0 else err == 0.0
    log("check", (
        f"{name}: max_abs_err={err:.3e} (tol {tol * scale:.3e}), max_rel_err={rel:.3e} "
        f"relative to max|ref|={scale:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}"
    ))
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {tol:g} x {scale:.3e}")
    return err


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for a call
    that moves n_bytes (each input read once, each output written once)
    and does n_ops float32 operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean ms per call, back to back, on the device timeline (CUDA events)
    after a warm-up call (none with ``warm=False``: fn ran before): where
    the host issues slower than the device runs, this is the issue rate."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_model(device, n: int = N):
    """The headline configuration (on a 512 km square; n elements a side)."""
    mesh = RectMesh(n, n, dx=512e3 / n, dy=512e3 / n)
    model = CoupledModel(
        mesh, degree=1, mevp_params=MEVPParams(), n_subcycles=N_SUBCYCLES,
        mevp_backend="pallas",
    )
    state = model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0,
        device=device, dtype=torch.float32,
    )
    full = lambda value: torch.full((n, n), value, device=device, dtype=torch.float32)
    forcing = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    return model, state, forcing


def check_kernels(model, device) -> dict:
    """Phase 3: each kernel against its plain version on seeded inputs."""
    rng = np.random.default_rng(SEED)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    solver, transport = model.mevp, model.transport
    u, v = t(rng.normal(0.0, 0.2, (N, N))), t(rng.normal(0.0, 0.2, (N, N)))
    s11, s22, s12 = (t(rng.normal(0.0, 1e3, (N, N))) for _ in range(3))
    h, a = t(rng.uniform(0.2, 2.0, (N, N))), t(rng.uniform(0.3, 1.0, (N, N)))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(8.0, 2.0, (N, N))), v_atm=t(rng.normal(2.0, 2.0, (N, N))),
        u_ocean=t(rng.normal(0.0, 0.05, (N, N))), v_ocean=t(rng.normal(0.0, 0.05, (N, N))),
    )
    mask = model.node_mask(device=device, dtype=torch.float32)
    state = VelocityState(u=u, v=v, s11=s11, s22=s22, s12=s12)
    consts = solver.step_consts(state, h, a, forcing, mask, DT)
    carry = (u, v, s11, s22, s12)
    results = {}

    ref = solver.stress_update(carry, consts)
    got = cc.mevp_stress(solver, carry, consts)
    names = ("s11", "s22", "s12", "c_w", "inv_drag")
    results["mevp_stress"] = max(
        compare(f"mevp_stress.{n}", g, r, TOL_LAUNCH) for n, g, r in zip(names, got, ref)
    )

    carry_v = (u, v, *ref[:3])
    ref_uv = solver.velocity_update(carry_v, consts, ref[3], ref[4], DT)
    got_uv = cc.mevp_velocity(solver, carry_v, consts, ref[3], ref[4], DT)
    results["mevp_velocity"] = max(
        compare(f"mevp_velocity.{n}", g, r, TOL_LAUNCH) for n, g, r in zip("uv", got_uv, ref_uv)
    )

    # The CFL speeds must be equal, so that k is equal.
    speeds = cc.dg1_sample_cfl(transport, u, v)
    speeds_ref = cc.dg1_sample_cfl_reference(transport, u, v)
    results["dg1_sample_cfl"] = compare("dg1_sample_cfl.speeds", speeds, speeds_ref, 0.0)
    k_of = lambda sp: int(cc.substeps_from_speeds(sp[0], sp[1], DT, model.mesh, 1))
    if k_of(speeds) != k_of(speeds_ref):
        raise AssertionError(f"k differs: {k_of(speeds)} != {k_of(speeds_ref)}")
    log("check", f"dg1_sample_cfl: k = {k_of(speeds)} on both paths")

    coeffs = lambda: t(np.concatenate([
        rng.uniform(0.1, 1.0, (1, 3, N, N)), rng.normal(0.0, 0.3, (2, 3, N, N))
    ]))
    psi, base = coeffs(), coeffs()
    face_x = t((rng.uniform(size=(N, N)) > 0.1).astype(np.float32))
    face_y = t((rng.uniform(size=(N, N)) > 0.1).astype(np.float32))
    errs = []
    for a_, b_ in ((0.0, 1.0), (0.5, 0.5)):
        args = (transport, psi, base, u, v, face_x, face_y, a_, b_, 300.0)
        errs.append(compare(
            f"dg1_rk_stage(a={a_}, b={b_})", cc.dg1_rk_stage(*args),
            cc.dg1_rk_stage_reference(*args), TOL_LAUNCH,
        ))
    results["dg1_rk_stage"] = max(errs)
    torch.cuda.synchronize()

    # Times: the in-place launches of the main path against the plain version.
    scalars, tables = cc._mevp_scalars(solver, DT), cc._dg1_tables(transport)
    stream = cc._stream(device)
    planes = tuple(p.clone() for p in carry)
    c_w, inv_drag = torch.empty_like(u), torch.empty_like(u)
    zeros2 = torch.zeros(2, device=device)
    out = torch.empty_like(psi)
    ptrs = cc._mevp_consts(consts)
    timed = {
        "mevp_stress": (
            lambda: cc._mevp_half_("mevp_stress", planes, ptrs, c_w, inv_drag, scalars, stream),
            lambda: solver.stress_update(carry, consts),
        ),
        "mevp_velocity": (
            lambda: cc._mevp_half_("mevp_velocity", planes, ptrs, c_w, inv_drag, scalars, stream),
            lambda: solver.velocity_update(carry_v, consts, ref[3], ref[4], DT),
        ),
        "dg1_sample_cfl": (
            lambda: cc._dg1_sample_cfl_(u, v, zeros2, tables, stream),
            lambda: cc.dg1_sample_cfl_reference(transport, u, v),
        ),
        "dg1_rk_stage": (
            lambda: cc._dg1_rk_stage_(
                psi, base, u, v, face_x, face_y, None, out, 0.5, 0.5, 300.0, tables, stream
            ),
            lambda: cc.dg1_rk_stage_reference(
                transport, psi, base, u, v, face_x, face_y, 0.5, 0.5, 300.0
            ),
        ),
    }
    n = N * N
    work = {  # (bytes, operations) of one call at N^2
        "mevp_stress": (15 * 4 * n, OPS["stress"] * n),
        "mevp_velocity": (14 * 4 * n, OPS["velocity"] * n),
        "dg1_sample_cfl": (2 * 4 * n + 8, OPS["cfl"] * n),
        "dg1_rk_stage": ((9 + 9 + 4 + 9) * 4 * n, OPS["stage"] * n),
    }
    rows = {}
    for name, (kernel, plain) in timed.items():
        rows[name] = Row(results[name], time_ms(kernel, 200), time_ms(plain, 20), *work[name])
        log("time", (
            f"{name}: kernel {rows[name].ms:.4f} ms, plain {rows[name].plain_ms:.4f} ms, "
            f"bound {bound(*work[name])[0]:.4f} ms ({bound(*work[name])[1]}) per call at {N}x{N}"
        ))
    return rows


def velocity_leaves(velocity):
    """(name, tensor) of a VelocityState, or of an HOVelocityState (its CG2
    fields plane by plane)."""
    for name in VELOCITY:
        leaf = getattr(velocity, name)
        if isinstance(leaf, mevp_ho.HOField):
            for k, plane in zip("vblc", leaf.planes()):
                yield f"{name}.{k}", plane
        else:
            yield name, leaf


def leaves(state, like):
    """(name, leaf, leaf of ``like``) for every tensor of a CoupledState."""
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        yield name, getattr(state, name), getattr(like, name)
    pairs = zip(velocity_leaves(state.velocity), velocity_leaves(like.velocity))
    for (name, leaf), (_, other) in pairs:
        yield f"velocity.{name}", leaf, other


def ptxas_report(text: str):
    """'kernel: registers, shared memory; spills' lines from the compilers'
    -v report."""
    kernel, spills = "?", ""
    for line in text.splitlines():
        found = re.search(r"entry function '_ZN3nst(\d+)(\w+)'", line)
        if found:
            kernel = found.group(2)[: int(found.group(1))]
            rest = found.group(2)[int(found.group(1)):]
            args = re.findall(r"L([bi])(\d+)E", rest.split("EE")[0] + "E") if rest.startswith("I") else []
            if kernel == "rdma_stage_kernel":  # its one template argument: 16-byte vectors
                kernel += "<float4>" if args[0][1] == "1" else "<scalar>"
            elif kernel == "rdma_band_kernel":  # the band's long axis, the launch bound
                axis = "along columns, x bands" if args[0][1] == "1" else "along rows, y bands"
                kernel += f"<{axis}, {args[1][1]} threads>"
            elif kernel == "ho_tiled_kernel" and args:  # the sub-window width, 0: any
                kernel += f"<width {args[0][1]}>" if args[0][1] != "0" else "<any width>"
            elif args and args[0][0] == "b":  # the metric template first: ILb1E = <true>
                names = ["metric" if args[0][1] == "1" else "uniform"]
                if kernel == "mevp_tiled_kernel":  # then the window width
                    names.append(f"width {args[1][1]}" if args[1][1] != "0" else "any width")
                kernel += "<" + ", ".join(names) + ">"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}"


def spherical_mesh(nx: int, ny: int = None):
    """The pan-Arctic lon-lat window of ``coupled_1m_spherical``."""
    return SphericalMesh(nx, nx if ny is None else ny, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)


def config4_model(device, **backends):
    """BASELINE config 4 as ``bench_coupled_1m`` builds it (no land mask):
    (model, initial state, physics forcing, dynamics forcing)."""
    return coupled_model(device, RectMesh(N4, N4, dx=4e3, dy=4e3), None, **backends)


def spherical_model(device, n: int = N4, **backends):
    """``bench_coupled_1m(land_mask=True, spherical=True)`` at n^2."""
    return coupled_model(device, spherical_mesh(n), synthetic_coastline(n), **backends)


def coupled_model(device, mesh, ocean, **backends):
    """Config 4's model, state and forcing on ``mesh`` with the coastline
    ``ocean`` (or none)."""
    model = CoupledModel(
        mesh, degree=1, mevp_params=MEVPParams(), n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
        **backends,
    )
    state = model.initial_state(
        hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32
    )
    shape = (mesh.nx, mesh.ny)
    full = lambda value: torch.full(shape, value, device=device, dtype=torch.float32)
    phys = Forcing(
        tair=full(-15.0), dew2m=full(-17.0), pair=full(1e5), sw_in=full(5.0),
        lw_in=full(240.0), mld=full(10.0), snowfall=full(1e-4), wind=full(6.0),
    )
    dyn = DynamicsForcing(
        u_atm=full(6.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    return model, state, phys, dyn


def plain_step(model, state, phys, dyn):
    """The coupled step on the plain PyTorch path (same device)."""
    state = model.step_dynamics(state, dyn, DT, phase=cc.fused_dynamics_reference)
    return model.step_thermo(state, phys, DT)


def tiled_inputs(nx, ny, device, seed, spherical=False):
    """Seeded mEVP planes and consts, dG1 tracers and face masks on a closed
    (nx, ny) mesh of 4 km elements (random face masks), or with
    ``spherical`` on the lon-lat window with the synthetic coastline (its
    metric consts and face masks)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (nx, ny)
    if spherical:
        model = CoupledModel(
            spherical_mesh(nx, ny), n_subcycles=N_SUBCYCLES,
            ocean_mask=synthetic_coastline(nx, ny),
        )
    else:
        model = CoupledModel(RectMesh(nx, ny, 4e3, 4e3), n_subcycles=N_SUBCYCLES)
    carry = tuple(t(rng.normal(0.0, s, shape)) for s in (0.2, 0.2, 1e3, 1e3, 1e3))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(6.0, 2.0, shape)), v_atm=t(rng.normal(3.0, 2.0, shape)),
        u_ocean=t(rng.normal(0.0, 0.05, shape)), v_ocean=t(rng.normal(0.0, 0.05, shape)),
    )
    h, a = t(rng.uniform(0.2, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), h, a, forcing, mask, DT)
    psi = t(np.concatenate([
        rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (2, 3, *shape))
    ]))
    if spherical:
        faces = model.face_masks(device=device, dtype=torch.float32)
    else:
        faces = tuple(t((rng.uniform(size=shape) > 0.1).astype(np.float32)) for _ in range(2))
    return model, carry, consts, psi, faces


def same_schedule(name: str, got, ref, other: str = "K1's schedule") -> float:
    """Max abs difference from another schedule on the same inputs; fails
    above TOL_SAME_SCHEDULE x the plane's max |value|."""
    err = float((got.double() - ref.double()).abs().max())
    limit = TOL_SAME_SCHEDULE * float(ref.abs().max())
    ok = err <= limit
    log("check", (
        f"{name} vs {other}: max_abs_diff={err:.3e} (expected 0, fail above "
        f"{limit:.3e}) {'ok' if ok else 'FAIL'}"
    ))
    if not ok:
        raise AssertionError(f"{name}: differs from {other} by {err:.3e}")
    return err


def check_tiled(device) -> dict:
    """Phase 3, second part: mevp_tiled and transport_tiled against their
    plain versions and against K1's schedule, at 1024^2 and a ragged shape
    (mevp_tiled in both shipped launch configurations), and mevp_tiled at
    config 5's 4096^2 in the configuration the host picks there; then each
    per call at 1024^2 against its plain version, and mevp_tiled at 4096^2."""
    errs = {"mevp_tiled": 0.0, "transport_tiled": 0.0}

    def mevp_tiled_against_plain_and_k1(tag, solver, carry, consts, configs):
        for n in (N_SUBCYCLES, 13):  # 13: a multiple of neither halo
            ref = mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, n)
            k1 = cc.mevp_subcycles(solver, carry, consts, DT, n)
            for config in configs:
                got = mt.mevp_subcycles_tiled(solver, carry, consts, DT, n, *config)
                for plane, g, r, q in zip(VELOCITY, got, ref, k1):
                    label = f"mevp_tiled {tag} {config} N={n} {plane}"
                    errs["mevp_tiled"] = max(errs["mevp_tiled"], compare(label, g, r, TOL_STEP_MEVP))
                    same_schedule(label, g, q)

    inputs = {shape: tiled_inputs(*shape, device, SEED + 1) for shape in ((N4, N4), RAGGED)}
    for (nx, ny), (model, carry, consts, psi, faces) in inputs.items():
        solver, transport = model.mevp, model.transport
        mevp_tiled_against_plain_and_k1(f"{nx}x{ny}", solver, carry, consts, (mt.SMALL, mt.LARGE))
        u, v = carry[0], carry[1]
        for k in (1, 4):  # 4 substeps run in two launches
            args = (transport, psi, u, v, DT / k, k, faces)
            got = tt.transport_substeps_tiled(*args)
            tag = f"transport_tiled {nx}x{ny} k={k}"
            err = compare(tag, got, tt.transport_substeps_tiled_reference(*args), TOL_STEP_TRACER)
            errs["transport_tiled"] = max(errs["transport_tiled"], err)
            same_schedule(tag, got, cc.transport_substeps(*args))
    torch.cuda.synchronize()

    model, carry, consts, psi, faces = inputs[(N4, N4)]
    solver, transport = model.mevp, model.transport
    u, v = carry[0], carry[1]
    timed = {
        # 8 subcycles, one launch at 1024^2; the plain version runs the same subcycles
        "mevp_tiled": (
            lambda: mt.mevp_subcycles_tiled(solver, carry, consts, DT, TILED_SUBCYCLES),
            lambda: mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, TILED_SUBCYCLES),
        ),
        # one launch: one rk2 substep with its velocity sampling
        "transport_tiled": (
            lambda: tt.transport_substeps_tiled(transport, psi, u, v, DT, 1, faces),
            lambda: tt.transport_substeps_tiled_reference(transport, psi, u, v, DT, 1, faces),
        ),
    }
    n = N4 * N4
    work = {  # (bytes, operations) of one call at 1024^2
        "mevp_tiled": ((5 + 7 + 5) * 4 * n, TILED_SUBCYCLES * (OPS["stress"] + OPS["velocity"]) * n),
        "transport_tiled": ((9 + 4 + 9) * 4 * n, 2 * OPS["stage"] * n),
    }
    results = {}
    for name, (kernel, plain) in timed.items():
        ms_, plain_ms = time_ms(kernel, 50), time_ms(plain, 3)
        results[name] = Row(errs[name], ms_, plain_ms, *work[name])
        log("time", (
            f"{name}: kernel {ms_:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound(*work[name])[0]:.4f} ms ({bound(*work[name])[1]}) per call at {N4}x{N4} "
            f"({'8 subcycles' if name == 'mevp_tiled' else 'one rk2 substep'})"
        ))
    # mevp_tiled at config 5's 4096^2 (seeded planes in motion, mevp_large's)
    # against its plain version and K1's schedule, then per call of 8
    # subcycles and per element and subcycle.
    solver, carry, consts = mevp_large.seeded_phase(N16, False, device, SEED + 1)
    config16 = mt.launch_config(N16, N16)
    mevp_tiled_against_plain_and_k1(f"{N16}x{N16}", solver, carry, consts, (config16,))
    results["mevp_tiled"].err = errs["mevp_tiled"]
    ms16 = time_ms(lambda: mt.mevp_subcycles_tiled(solver, carry, consts, DT, TILED_SUBCYCLES), 20)
    log("time", (
        f"mevp_tiled: kernel {results['mevp_tiled'].ms:.4f} ms per call at {N4}x{N4} "
        f"({results['mevp_tiled'].ms * 1e9 / (n * TILED_SUBCYCLES):.2f} ps per element and subcycle; "
        f"tile, halo, threads {mt.launch_config(N4, N4)}), {ms16:.4f} ms at {N16}x{N16} "
        f"({ms16 * 1e9 / (N16 * N16 * TILED_SUBCYCLES):.2f} ps; {config16}), "
        f"{TILED_SUBCYCLES} subcycles a call"
    ))
    return results


def check_single(device) -> dict:
    """Phase 3, third part: mevp_single against its plain version, K1's
    schedule and mevp_tiled, and the metric transport kernels against their
    plain versions and each other; then mevp_single per call at 256^2."""
    errs = []
    model, carry, consts, _, _ = tiled_inputs(N, N, device, SEED + 2, spherical=True)
    for n in (1, 13):
        got = single.mevp_subcycles_single(model.mevp, carry, consts, DT, n)
        ref = single.mevp_single_reference(model.mevp, carry, consts, DT, n)
        for name, g, r in zip(VELOCITY, got, ref):
            errs.append(compare(f"mevp_single {N}x{N} spherical N={n} {name}", g, r, TOL_LAUNCH))
    uniform = tiled_inputs(N, N, device, SEED + 3)
    model, carry, consts, _, _ = uniform
    got = single.mevp_subcycles_single(model.mevp, carry, consts, DT, N_SUBCYCLES)
    k1 = cc.mevp_subcycles(model.mevp, carry, consts, DT, N_SUBCYCLES)
    for name, g, q in zip(VELOCITY, got, k1):
        same_schedule(f"mevp_single {N}x{N} uniform N={N_SUBCYCLES} {name}", g, q)
    spherical = {
        shape: tiled_inputs(*shape, device, SEED + 4, spherical=True) for shape in ((N4, N4), RAGGED)
    }
    for (nx, ny), (model, carry, consts, _, _) in spherical.items():
        got = single.mevp_subcycles_single(model.mevp, carry, consts, DT, N_SUBCYCLES)
        ref = single.mevp_single_reference(model.mevp, carry, consts, DT, N_SUBCYCLES)
        tiled = mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, N_SUBCYCLES)
        for name, g, r, w in zip(VELOCITY, got, ref, tiled):
            tag = f"mevp_single {nx}x{ny} spherical N={N_SUBCYCLES} {name}"
            errs.append(compare(tag, g, r, TOL_STEP_MEVP))
            same_schedule(tag, g, w, "mevp_tiled")

    # The metric transport kernels with the coastline, at 1024^2.
    model, carry, _, psi, faces = spherical[(N4, N4)]
    transport, u, v = model.transport, carry[0], carry[1]
    transport_errs = []
    for k in (1, 4):
        args = (transport, psi, u, v, DT / k, k, faces)
        got = tt.transport_substeps_tiled(*args)
        tag = f"transport_tiled {N4}x{N4} spherical, coastline, k={k}"
        transport_errs.append(
            compare(tag, got, tt.transport_substeps_tiled_reference(*args), TOL_STEP_TRACER)
        )
        same_schedule(tag, got, cc.transport_substeps(*args), "the metric dg1_rk_stage schedule")
    stage = (transport, psi, psi.flip(-1).contiguous(), u, v, *faces, 0.5, 0.5, DT)
    stage_err = compare(
        f"dg1_rk_stage {N4}x{N4} spherical, coastline", cc.dg1_rk_stage(*stage),
        cc.dg1_rk_stage_reference(*stage), TOL_LAUNCH,
    )
    torch.cuda.synchronize()

    # Per call at the headline's size, uniform consts: 100 subcycles.
    model, carry, consts, _, _ = uniform
    solver = model.mevp
    runs = time_in_turns(
        {
            "mevp_single": lambda: single.mevp_subcycles_single(solver, carry, consts, DT, N_SUBCYCLES),
            "K1": lambda: cc.mevp_subcycles(solver, carry, consts, DT, N_SUBCYCLES),
            "plain": lambda: single.mevp_single_reference(solver, carry, consts, DT, N_SUBCYCLES),
        },
        {"mevp_single": 20, "K1": 10, "plain": 2},
    )
    mean = {name: sum(r) / len(r) for name, r in runs.items()}
    n = N * N
    work = (
        (5 + 7 + 5) * 4 * n, N_SUBCYCLES * (OPS["stress"] + OPS["velocity"]) * n
    )
    bound_ms, bound_by = bound(*work)
    log("time", (
        f"mevp_single: {mean['mevp_single']:.4f} ms per call of {N_SUBCYCLES} subcycles at "
        f"{N}x{N} (runs {', '.join(f'{m:.4f}' for m in runs['mevp_single'])}), K1's schedule "
        f"{mean['K1']:.4f}, plain {mean['plain']:.4f}, bound {bound_ms:.4f} ms "
        f"({bound_by}); {single.max_blocks(False, device)} resident blocks"
    ))
    return {
        "mevp_single": Row(max(errs), mean["mevp_single"], mean["plain"], *work),
        "transport_metric": max(transport_errs),
        "dg1_rk_stage_metric": stage_err,
    }


def ho_model(device, n: int = N4, **backends):
    """``bench_coupled_1m(high_order=True)`` at n^2: config 4 with the HO
    solver selected through the module registry (reset after the build)."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        return coupled_model(device, RectMesh(n, n, dx=4e3, dy=4e3), None, **backends)
    finally:
        loader.reset()


def ho_inputs(nx, ny, device, seed):
    """Seeded HO solver inputs on a closed (nx, ny) mesh of 4 km elements:
    (model, carry, consts, tracers, face masks)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (nx, ny)
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        model = CoupledModel(RectMesh(nx, ny, 4e3, 4e3), n_subcycles=N_SUBCYCLES)
    finally:
        loader.reset()
    field = lambda s, m=0.0: mevp_ho.HOField(*(t(m + rng.normal(0.0, s, shape)) for _ in range(4)))
    state = mevp_ho.HOVelocityState(
        u=field(0.2), v=field(0.2), s11=t(rng.normal(0.0, 1e3, (3, *shape))),
        s22=t(rng.normal(0.0, 1e3, (3, *shape))), s12=t(rng.normal(0.0, 5e2, (3, *shape))),
    )
    forcing = mevp_ho.HODynamicsForcing(field(2.0, 6.0), field(2.0, 3.0), field(0.05), field(0.05))
    h, a = t(rng.uniform(0.0, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(state, h, a, forcing, mask, DT)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    psi = t(np.concatenate([
        rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (2, 3, *shape))
    ]))
    faces = tuple(t((rng.uniform(size=shape) > 0.1).astype(np.float32)) for _ in range(2))
    return model, carry, consts, psi, faces


def ho_planes(carry):
    """(name, plane) of an HO carry: 8 velocity planes, 3 stress stacks."""
    return list(velocity_leaves(mevp_ho.HOVelocityState(*carry)))


def check_ho(device) -> dict:
    """Phase 3, fourth part: ho_single and ho_tiled against their plain
    version and each other, and the qv form of transport_tiled; then each
    per call at its path's shape against its plain version and bound."""
    errs = {"ho_single": 0.0, "ho_tiled": 0.0}

    def against_plain(kernel, run, tag, model, carry, consts, n):
        got = run(model.mevp, carry, consts, DT, n)
        ref = mevp_ho.ho_subcycles_reference(model.mevp, carry, consts, DT, n)
        tol = TOL_LAUNCH if n == 1 else TOL_STEP_MEVP
        for (name, g), (_, r) in zip(ho_planes(got), ho_planes(ref)):
            errs[kernel] = max(errs[kernel], compare(f"{tag} N={n} {name}", g, r, tol))
        return got

    # The inputs at the paths' shapes serve the timings below too.
    inputs = {N: ho_inputs(N, N, device, SEED + 6), N4: ho_inputs(N4, N4, device, SEED + 7)}
    model, carry, consts, _, _ = inputs[N]
    for n in (1, 13, N_SUBCYCLES):
        against_plain("ho_single", hsc.ho_subcycles_single, f"ho_single {N}x{N}", model, carry, consts, n)
    for (nx, ny), (model, carry, consts, _, _) in (
        ((N4, N4), inputs[N4]), (RAGGED, ho_inputs(*RAGGED, device, SEED + 7)),
    ):
        for n in (1, 13):  # 13 = 8 + 5: not a multiple of the halo
            against_plain("ho_tiled", htc.ho_subcycles_tiled, f"ho_tiled {nx}x{ny}", model, carry, consts, n)
    for n_side in (N, 2 * N):
        model, carry, consts, _, _ = ho_inputs(n_side, n_side, device, SEED + 8)
        single = hsc.ho_subcycles_single(model.mevp, carry, consts, DT, N_SUBCYCLES)
        tiled = htc.ho_subcycles_tiled(model.mevp, carry, consts, DT, N_SUBCYCLES)
        for (name, g), (_, w) in zip(ho_planes(single), ho_planes(tiled)):
            same_schedule(f"ho_single {n_side}x{n_side} N={N_SUBCYCLES} {name}", g, w, "ho_tiled")
    # The shipped window (a cluster of one block) against clusters of 2 to
    # 16 blocks, whose blocks push their edges into each other's shared
    # memory, at 1024^2, N = 13.
    model, carry, consts, _, _ = inputs[N4]
    shipped = htc.ho_subcycles_tiled(model.mevp, carry, consts, DT, 13, htc.SHIPPED)
    for other in (htc.CLUSTER_2X2, htc.LaunchConfig(1, 2, 48, 8, 512), htc.LaunchConfig(2, 4, 48, 8, 512),
                  htc.LaunchConfig(4, 4, 32, 8, 256)):
        got = htc.ho_subcycles_tiled(model.mevp, carry, consts, DT, 13, other)
        for (name, g), (_, w) in zip(ho_planes(got), ho_planes(shipped)):
            same_schedule(f"ho_tiled {other} {N4}x{N4} N=13 {name}", g, w, f"ho_tiled {htc.SHIPPED}")

    # The qv form of transport_tiled at 1024^2: the CG2 samples of a
    # velocity scaled so that k = 4 runs two launches.
    model, carry, _, psi, faces = inputs[N4]
    qv_errs = []
    for k in (1, 4):
        scaled = tuple(mevp_ho.HOField(*(k * x for x in f.planes())) for f in carry[:2])
        qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, *scaled)
        args = (model.transport, psi, None, None, DT / k, k, faces)
        got = tt.transport_substeps_tiled(*args, qv=qv)
        ref = tt.transport_substeps_tiled_reference(*args, qv=qv)
        qv_errs.append(compare(f"transport_tiled qv form {N4}x{N4} k={k}", got, ref, TOL_STEP_TRACER))
    torch.cuda.synchronize()

    # Per call at the paths' shapes: ho_single's 100 subcycles at 256^2,
    # one ho_tiled launch (HALO subcycles) at 1024^2.
    results = {}
    for kernel, n_side, n_sub, run in (
        ("ho_single", N, N_SUBCYCLES, hsc.ho_subcycles_single),
        ("ho_tiled", N4, htc.HALO, htc.ho_subcycles_tiled),
    ):
        model, carry, consts, _, _ = inputs[n_side]
        solver = model.mevp
        runs = time_in_turns(
            {
                "kernel": lambda: run(solver, carry, consts, DT, n_sub),
                "plain": lambda: mevp_ho.ho_subcycles_reference(solver, carry, consts, DT, n_sub),
            },
            {"kernel": 20, "plain": None},
        )
        mean = {name: sum(r) / len(r) for name, r in runs.items()}
        elements = n_side * n_side
        work = (
            HO_PLANES_MOVED * 4 * elements, n_sub * (OPS["ho_stress"] + OPS["ho_velocity"]) * elements
        )
        bound_ms, bound_by = bound(*work)
        results[kernel] = Row(errs[kernel], mean["kernel"], mean["plain"], *work)
        log("time", (
            f"{kernel}: kernel {mean['kernel']:.4f} ms (runs "
            f"{', '.join(f'{m:.4f}' for m in runs['kernel'])}), plain {mean['plain']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}) per call of {n_sub} subcycles at {n_side}x{n_side}"
        ))
    log("build", f"ho_single: {hsc.max_blocks(device)} resident blocks of 256 threads")
    return {**results, "transport_qv": max(qv_errs)}


def check_bounded(tag: str, out, first) -> None:
    for name, leaf, like in leaves(out, first):
        if leaf.shape != like.shape or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{tag}: {name} is not finite or has shape {tuple(leaf.shape)}")
    cice, hice, hsnow = out.cice[0], out.hice[0], out.hsnow[0]
    if not (bool((cice >= 0).all()) and bool((cice <= 1).all())):
        raise AssertionError(f"{tag}: cice outside [0, 1]")
    if not (bool((hice >= 0).all()) and bool((hsnow >= 0).all())):
        raise AssertionError(f"{tag}: negative hice or hsnow")
    log("slice", (
        f"{tag} finite and bounded: max|u| {max_u(out.velocity):.4f} m/s, "
        f"cice in [{float(cice.min()):.4f}, {float(cice.max()):.4f}], "
        f"hice >= {float(hice.min()):.4f}"
    ))


def max_u(velocity) -> float:
    """max |u| over the x velocity's planes."""
    return max(float(x.abs().max()) for n, x in velocity_leaves(velocity) if n[0] == "u")


def check_land(tag: str, model, out, first) -> None:
    """With a coastline: land elements keep their initial tracers exactly,
    and every node that touches land (node mask 0) is at rest."""
    device = out.hice.device
    land = torch.as_tensor(model.ocean_mask == 0.0, device=device)
    for name in ("hice", "cice", "hsnow"):
        if not torch.equal(getattr(out, name)[:, land], getattr(first, name)[:, land]):
            raise AssertionError(f"{tag}: {name} changed on land")
    pinned = model.node_mask(device=device, dtype=out.hice.dtype) == 0.0
    for name in ("u", "v"):
        if not bool((getattr(out.velocity, name)[pinned] == 0.0).all()):
            raise AssertionError(f"{tag}: {name} is not zero on a node that touches land")
    log("slice", (
        f"{tag}: land tracers unchanged on {int(land.sum())} elements, u = v = 0 on "
        f"{int(pinned.sum())} pinned nodes"
    ))


def compare_step(tag: str, got, ref) -> None:
    """Every leaf of one coupled step (12; 18 with the HO velocity) against
    the plain path."""
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        compare(f"{tag}.{name}", getattr(got, name), getattr(ref, name), TOL_STEP_TRACER)
    pairs = zip(velocity_leaves(got.velocity), velocity_leaves(ref.velocity))
    for (name, g), (_, r) in pairs:
        compare(f"{tag}.velocity.{name}", g, r, TOL_STEP_MEVP)


def drive_path(path: str, model, state, phys, dyn, do_thermo: bool) -> dict:
    """20 steps from zeroed launch counters; fails unless every kernel of
    the path was launched."""
    cc.reset_launches()
    out = model.run(state, phys, dyn, DT, 20, do_thermo=do_thermo)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    log("slice", f"{path}: 20 steps, launches: {counts}")
    check_bounded(f"{path}: 20 steps", out, state)
    if model.ocean_mask is not None:
        check_land(f"{path}: 20 steps", model, out, state)
    missing = [name for name in PATH_KERNELS[path] if counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")
    return counts


def check_slice(device) -> dict:
    """Phase 4: each main path against the plain path, then 20 steps."""
    model, state, forcing = bench_model(device)
    got = model.step(state, None, forcing, DT, do_thermo=False)
    ref = model.step_dynamics(state, forcing, DT, phase=cc.fused_dynamics_reference)
    for name in ("hice", "cice", "hsnow"):
        compare(f"step.{name}", getattr(got, name), getattr(ref, name), TOL_STEP_TRACER)
    for name in ("u", "v", "s11", "s22", "s12"):
        compare(
            f"step.velocity.{name}", getattr(got.velocity, name),
            getattr(ref.velocity, name), TOL_STEP_MEVP,
        )
    counts = {"headline": drive_path("headline", model, state, None, forcing, False)}

    model, state, phys, dyn = config4_model(device)
    schedule = (model.mevp_schedule(), model.transport_schedule())
    log("slice", f"config4: {N4}x{N4}, auto schedule {schedule}")
    if schedule != ("pallas-tiled", "tiled"):
        raise AssertionError(f"config 4 does not run the tiled kernels: {schedule}")
    compare_step("config4.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
    counts["config4"] = drive_path("config4", model, state, phys, dyn, True)

    # Config 4's uniform coastline variant (coupled_1m_mask), on "auto".
    model, state, phys, dyn = coupled_model(
        device, RectMesh(N4, N4, dx=4e3, dy=4e3), synthetic_coastline(N4)
    )
    got = model.step(state, phys, dyn, DT)
    compare_step("config4_mask.step", got, plain_step(model, state, phys, dyn))
    check_land("config4_mask: 1 step", model, got, state)

    # The spherical coastline variant (coupled_1m_spherical).
    model, state, phys, dyn = spherical_model(device, mevp_backend="pallas")
    schedule = (model.mevp_schedule(), model.transport_schedule())
    log("slice", (
        f"spherical: {N4}x{N4}, min dx {float(np.min(model.mesh.dx)):.1f} m, max dx "
        f"{float(np.max(model.mesh.dx)):.1f} m, dy {model.mesh.dy:.1f} m, ocean share "
        f"{float(model.ocean_mask.mean()):.4f}, schedule {schedule}"
    ))
    if schedule != ("single", "tiled"):
        raise AssertionError(f"the spherical path does not run mevp_single: {schedule}")
    model_auto = spherical_model(device)[0]
    log("slice", f"spherical: auto schedule {(model_auto.mevp_schedule(), model_auto.transport_schedule())}")
    for tag, m in (("spherical.pallas.step", model), ("spherical.auto.step", model_auto)):
        compare_step(tag, m.step(state, phys, dyn, DT), plain_step(m, state, phys, dyn))
    counts["spherical"] = drive_path("spherical", model, state, phys, dyn, True)

    # The HO paths: ho_coupled_1m on "auto", ho_coupled_256 on "pallas".
    for path, n, backend, expected in (
        ("ho_coupled_1m", N4, "auto", ("tiled", "tiled")),
        ("ho_coupled_256", N, "pallas", ("single", "tiled")),
    ):
        model, state, phys, dyn = ho_model(device, n, mevp_backend=backend)
        schedule = (model.mevp_schedule(), model.transport_schedule())
        log("slice", f"{path}: {n}x{n}, HO solver, {backend} schedule {schedule}")
        if not model.is_high_order or schedule != expected:
            raise AssertionError(f"{path} does not run {expected}: {schedule}")
        compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
        counts[path] = drive_path(path, model, state, phys, dyn, True)
    return counts


def report(what: str, ms: list, elements: int, card: str) -> float:
    mean = sum(ms) / len(ms)
    log("time", (
        f"{what}: {mean:.3f} ms/step (runs {', '.join(f'{m:.3f}' for m in ms)}), "
        f"{elements / (mean / 1e3):.4e} element updates/s, f32 on {card}"
    ))
    return mean


def time_in_turns(fns: dict, reps: dict) -> dict:
    """ms per call of each function, run in turns: a b ... b a, each warmed
    up in its first turn. A function whose reps is None (a plain path,
    100-1000x slower than the kernels, which the checks ran before at the
    same shapes) runs once after the turns, with no warm-up."""
    turns = [name for name in fns if reps[name]]
    runs = {name: [] for name in fns}
    for i, name in enumerate(turns + turns[::-1]):
        runs[name].append(time_ms(fns[name], reps[name], warm=i < len(turns)))
    for name in fns:
        if not reps[name]:
            runs[name].append(time_ms(fns[name], 1, warm=False))
    return runs


def profile(tag: str, step, n_steps: int = 5) -> None:
    """Device busy time per step and the device's idle share over n_steps
    back-to-back steps under torch.profiler, and the kernels that took the
    most device time. Busy time sums the CUDA events' own device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    events = [
        e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    per_step = lambda e: e.self_device_time_total / 1e3 / n_steps
    busy = sum(per_step(e) for e in events)
    top = sorted(events, key=per_step, reverse=True)[:5]
    log("time", (
        f"profile {tag}: wall {wall:.3f} ms/step (profiled), device busy {busy:.3f} ms/step, "
        f"idle share {1.0 - busy / wall:.3f}, {sum(e.count for e in events) / n_steps:.0f} "
        f"device activities/step; top: " + "; ".join(
            f"{e.key[:48]} {per_step(e):.3f} ms x{e.count / n_steps:g}" for e in top
        )
    ))


def time_paths(device, card: str) -> None:
    """Phase 5: ms per step of the paths and schedules, in turns."""
    model, state, forcing = bench_model(device)
    runs = time_in_turns(
        {
            "kernel": lambda: model.step(state, None, forcing, DT, do_thermo=False),
            "plain": lambda: model.step_dynamics(
                state, forcing, DT, phase=cc.fused_dynamics_reference
            ),
        },
        {"kernel": 10, "plain": None},
    )
    for name, ms in runs.items():
        report(f"headline {name} path ({N}x{N}, {N_SUBCYCLES} subcycles)", ms, N * N, card)

    # The config-4 coupled step: tiled (auto), K1's schedule, plain; physics alone.
    model, state, phys, dyn = config4_model(device)
    model_k1 = config4_model(device, mevp_backend="pallas")[0]
    runs = time_in_turns(
        {
            "tiled": lambda: model.step(state, phys, dyn, DT),
            "K1": lambda: model_k1.step(state, phys, dyn, DT),
            "plain": lambda: plain_step(model, state, phys, dyn),
        },
        {"tiled": 10, "K1": 10, "plain": None},
    )
    for name, ms in runs.items():
        report(f"config4 coupled step, {name} path ({N4}x{N4})", ms, N4 * N4, card)
    ms = [time_ms(lambda: model.step_thermo(state, phys, DT), 10) for _ in range(2)]
    report(f"config4 physics alone ({N4}x{N4})", ms, N4 * N4, card)
    profile(f"config4 coupled step, tiled path ({N4}x{N4})", lambda: model.step(state, phys, dyn, DT))

    # The spherical coupled step: mevp_single ("pallas"), mevp_tiled, plain.
    model, state, phys, dyn = spherical_model(device, mevp_backend="pallas")
    model_tiled = spherical_model(device, mevp_backend="pallas-tiled")[0]
    runs = time_in_turns(
        {
            "mevp_single": lambda: model.step(state, phys, dyn, DT),
            "mevp_tiled": lambda: model_tiled.step(state, phys, dyn, DT),
            "plain": lambda: plain_step(model, state, phys, dyn),
        },
        {"mevp_single": 10, "mevp_tiled": 10, "plain": None},
    )
    for name, ms in runs.items():
        report(f"spherical coupled step, {name} path ({N4}x{N4})", ms, N4 * N4, card)
    profile(f"spherical coupled step on mevp_single ({N4}x{N4})", lambda: model.step(state, phys, dyn, DT))
    profile(f"spherical coupled step on mevp_tiled ({N4}x{N4})", lambda: model_tiled.step(state, phys, dyn, DT))


def time_ho(device, card: str) -> None:
    """Phase 5, HO part: the HO paths' step on their kernels and on the
    plain path, and a profile of ho_coupled_1m."""
    for path, n, backend in (("ho_coupled_1m", N4, "auto"), ("ho_coupled_256", N, "pallas")):
        model, state, phys, dyn = ho_model(device, n, mevp_backend=backend)
        runs = time_in_turns(
            {
                "kernel": lambda: model.step(state, phys, dyn, DT),
                "plain": lambda: plain_step(model, state, phys, dyn),
            },
            {"kernel": 10, "plain": None},
        )
        for name, ms in runs.items():
            report(f"{path} coupled step, {name} path ({n}x{n}, {model.mevp_schedule()})", ms, n * n, card)

    model, state, phys, dyn = ho_model(device, N4)
    profile(f"ho_coupled_1m coupled step ({N4}x{N4}, {model.mevp_schedule()})", lambda: model.step(state, phys, dyn, DT))


# -- BASELINE config 5: the decomposed coupled step on a 2 x 2 rank grid --------
def config5_model(device, n: int = None, **backends):
    """Config 5 as ``bench_multihost_16m`` sets it (a closed n^2 RectMesh of
    2 km elements, n = N16 by default) with config 4's state and forcing, on
    one device: (model, initial state, physics forcing, dynamics forcing)."""
    n = N16 if n is None else n
    return coupled_model(device, RectMesh(n, n, dx=2e3, dy=2e3), None, **backends)


def sharded_model(device, n: int = None, **backends):
    """The decomposed model of config 5 (n = N16 by default) on a fresh
    2 x 2 rank grid of the one card: (rank 0's model, the ShardedCoupledModel)."""
    n = N16 if n is None else n
    grid = RankGrid(*RANKS, device)
    return build_sharded_coupled_model(
        RectMesh(n, n, dx=2e3, dy=2e3), grid, degree=1, mevp_params=MEVPParams(),
        n_subcycles=N_SUBCYCLES, **backends,
    )


def blocks_of(sharded, state, phys, dyn):
    return sharded.grid.split_tree(state), sharded.grid.split_tree(phys), sharded.grid.split_tree(dyn)


def step_consts_of(model, state, dyn):
    """(carry, consts) of one rank's mEVP step from its state block."""
    mask = model.node_mask(device=state.hice.device, dtype=state.hice.dtype)
    velocity = state.velocity
    consts = model.mevp.step_consts(
        velocity, state.hice[0], torch.clamp(state.cice[0], 0.0, 1.0), dyn, mask, DT
    )
    return (velocity.u, velocity.v, velocity.s11, velocity.s22, velocity.s12), consts


def rdma_round_checked(model, carry, consts):
    """One rdma round of h subcycles on a rank whose rdma_stage and
    rdma_band launches are each held against their plain versions on the
    same inputs (those launches are not counted), then the blocked round on
    the same inputs. Returns (errors, rdma round, blocked round, the x
    launch's inputs for timing)."""
    solver = model.mevp
    h = solver.block_halo
    axes, consts_w = solver.rdma_round_inputs(consts)
    errors, captured = [], {}

    def stage(src, axis):
        got = rdma.rdma_stage(src, axis)
        ref = rdma.rdma_stage_reference(src, axis)
        errors.append(("rdma_stage", f"axis {axis}", got, ref))
        return got

    def band(local, src, axis, consts_w, dt, n, state):
        ref = rdma.rdma_band_reference(local, src, axis, consts_w, dt, n, [x.clone() for x in state])
        got = rdma.rdma_band(local, src, axis, consts_w, dt, n, [x.clone() for x in state])
        errors.extend(("rdma_band", f"axis {axis} {name}", g, r) for name, g, r in zip(VELOCITY, got, ref))
        captured.setdefault(axis, (local, src, consts_w, [x.clone() for x in state]))
        return got

    out = rdma._round(
        solver.local(), carry, consts, consts_w, DT, h, h, axes, stage, band, mt.mevp_subcycles_tiled,
    )
    blocked = MEVPSolver(model.mesh, solver.params, backend="blocked", spmd=model.spmd, block_halo=h)
    return errors, out, blocked.spmd_subcycles(carry, consts, DT, h), captured


def rdma_band_work(axis: int, h: int, n_sub: int, nx: int, ny: int, hx: int) -> tuple:
    """(bytes, operations) that one rdma_band launch (a pair of bands) needs
    for its patch: the cone of dependence of the h patch rows (x) or
    columns (y), which narrows by one ring per subcycle. At subcycle s of
    n_sub it spans h + 2 (n_sub - s) cells across the band and, along it,
    the ny columns of an x band or nx + 2 (n_sub - s) of the nx + 2 hx rows
    of a y band. Bytes: the 5 state and 7 const planes of the first
    subcycle's cone read once, the patch written once."""
    across = lambda s: min(3 * h, h + 2 * (n_sub - s))
    along = lambda s: ny if axis == 0 else min(nx + 2 * hx, nx + 2 * (n_sub - s))
    cells = sum(across(s) * along(s) for s in range(1, n_sub + 1))
    patch = 5 * h * (ny if axis == 0 else nx) * 4
    return (
        2 * ((5 + 7) * across(1) * along(1) * 4 + patch),
        2 * cells * (OPS["stress"] + OPS["velocity"]),
    )


def compare_sharded_step(tag: str, got, ref, tol_same: bool = False) -> None:
    """Every leaf of a decomposed step against another step of the same
    state: the plain path (the step tolerances), or with ``tol_same``
    another schedule of the same bodies (expected 0)."""
    for name, g, r in leaves(got, ref):
        if tol_same:
            same_schedule(f"{tag}.{name}", g, r, "the single-device kernel step")
        else:
            compare(f"{tag}.{name}", g, r, TOL_STEP_MEVP if name.startswith("velocity") else TOL_STEP_TRACER)


def check_multihost(device) -> tuple:
    """Config 5 (4096^2 on 2 x 2 ranks of the one card), blocked ("auto")
    and rdma: K7's kernels launch by launch against their plain versions,
    the rdma round against the blocked round, one decomposed step against
    the single-device kernel step at 4096^2, the decomposed kernel step
    against the decomposed plain step at 512^2, and N5_STEPS steps of each form.
    Returns (launch counts per path, K7's Row per kernel, rank 0's
    rdma_stage and rdma_band launches for the profiler)."""
    model1, state, phys, dyn = config5_model(device)
    log("slice", (
        f"multihost_16m: {N16}x{N16} ({N16 * N16} elements) on a {RANKS[0]}x{RANKS[1]} rank grid "
        f"of one card ({RANKS[0] * RANKS[1]} ranks, one thread and two streams each); "
        f"single-device schedule {(model1.mevp_schedule(), model1.transport_schedule())}"
    ))
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref = model1.step(state, phys, dyn, DT)
    torch.cuda.synchronize()
    mem_single = (torch.cuda.max_memory_allocated() - before) / 2**30
    forms = {}
    for path, backend in (("multihost_16m_blocked", "auto"), ("multihost_16m", "rdma")):
        model, sharded = sharded_model(device, mevp_backend=backend)
        schedule = (model.mevp_schedule(), model.transport_schedule())
        log("slice", (
            f"{path}: rank blocks {model.mesh.nx}x{model.mesh.ny}, schedule {schedule}, h = "
            f"{model.mevp.block_halo}, spmd transport (H, k_cap) = {tt.transport_tiled_spmd_config(model)}"
        ))
        if schedule != ("rdma" if backend == "rdma" else "blocked", "tiled"):
            raise AssertionError(f"{path} does not run its kernels: {schedule}")
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = sharded(state, phys, dyn, DT)
        torch.cuda.synchronize()
        log("slice", (
            f"{path}: device memory of one global-shaped step, its peak above what the "
            f"state and forcing held before: {(torch.cuda.max_memory_allocated() - before) / 2**30:.3f} "
            f"GiB (the single-device step: {mem_single:.3f} GiB; one 4096^2 plane is 0.0625 GiB)"
        ))
        compare_sharded_step(f"{path}.step vs single-device", got, ref, tol_same=True)
        for name, g, r in leaves(got, ref):  # and within the step tolerances, printed
            compare(f"{path}.step vs single-device {name}", g, r,
                    TOL_STEP_MEVP if name.startswith("velocity") else TOL_STEP_TRACER)
        forms[path] = (model, sharded, got)

    # K7 launch by launch, and the rdma round against the blocked round, on
    # the state after one step (moving ice, nonzero stresses).
    _, sharded, after = forms["multihost_16m"]
    states, _, dyns = blocks_of(sharded, after, phys, dyn)

    def check_round(rank):
        model = sharded.models[rank.rank]
        carry, consts = step_consts_of(model, states[rank.rank], dyns[rank.rank])
        return rdma_round_checked(model, carry, consts)

    results = run_ranks(sharded.grid.ring, check_round)
    torch.cuda.synchronize()
    errs = {"rdma_stage": 0.0, "rdma_band": 0.0}
    for r, (errors, out, blocked, _) in enumerate(results):
        for kernel, what, g, ref_ in errors:
            errs[kernel] = max(errs[kernel], compare(f"{kernel} rank {r} {what}", g, ref_, TOL_LAUNCH))
        for name, g, b in zip(VELOCITY, out, blocked):
            same_schedule(f"rdma round rank {r} {name}", g, b, "the blocked round")

    # The decomposed kernel step of each form against the decomposed plain
    # step (the same plain step for both: it runs no mEVP schedule).
    _, state_p, phys_p, dyn_p = config5_model(device, N_PLAIN_GRID)
    plain = None
    for backend in ("rdma", "auto"):
        model_p, sharded_p = sharded_model(device, N_PLAIN_GRID, mevp_backend=backend)
        got = sharded_p(state_p, phys_p, dyn_p, DT)
        if plain is None:
            blocks = blocks_of(sharded_p, state_p, phys_p, dyn_p)
            plain = sharded_p.grid.gather_tree(run_ranks(sharded_p.grid.ring, lambda rank: plain_step(
                sharded_p.models[rank.rank], *(b[rank.rank] for b in blocks)
            )), device)
        compare_step(f"multihost_{N_PLAIN_GRID} ({model_p.mevp_schedule()}) decomposed step vs decomposed plain", got, plain)

    # N5_STEPS steps of each form from zeroed launch counters.
    counts = {}
    for path, (model, sharded, _) in forms.items():
        blocks = blocks_of(sharded, state, phys, dyn)
        cc.reset_launches()
        out = sharded.run_blocks(*blocks, DT, N5_STEPS)
        torch.cuda.synchronize()
        counts[path] = dict(cc.launches)
        log("slice", f"{path}: {N5_STEPS} steps, launches: {counts[path]}")
        check_bounded(f"{path}: {N5_STEPS} steps", sharded.grid.gather_tree(out, device), state)
        missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")

    # K7 per call at the path's shapes (rank 0's x launches of the checked
    # round), against the plain versions; rdma_stage's library yardstick is
    # one torch.stack of the ten strip slices. The y launches are printed.
    local, src, consts_w, state0 = results[0][3][0]
    h = src.h
    nx, ny = src.own[0].shape
    times = {}
    # rdma_stage as the main path runs it: on a round's new sources, so each
    # timed call fetches the round's stream, checks the planes and builds
    # the pointer arrays, the ghosts as received.
    fresh = lambda s: rdma.RoundSources(s.own, s.h, s.split, s.gx, s.gy, stream=cc._stream(device))
    for axis in (0, 1):
        local_a, src_a, consts_a, state_a = results[0][3][axis]
        rows, cols = (3 * h, ny) if axis == 0 else (nx + 2 * src_a.hx, 3 * h)
        strip = 5 * h * (ny if axis == 0 else nx + 2 * src_a.hx) * 4
        timed = {
            "rdma_stage": (
                lambda: rdma.rdma_stage(fresh(src_a), axis),
                lambda: rdma.rdma_stage_reference(src_a, axis),
                (2 * 2 * strip, 0),
            ),
            "rdma_band": (
                lambda: rdma.rdma_band(local_a, src_a, axis, consts_a, DT, h, state_a),
                lambda: rdma.rdma_band_reference(local_a, src_a, axis, consts_a, DT, h, state_a),
                rdma_band_work(axis, h, h, nx, ny, src_a.hx),
            ),
        }
        for name, (kernel, plain, work) in timed.items():
            ms_, plain_ms = time_ms(kernel, 50), time_ms(plain, 3)
            bound_ms, bound_by = bound(*work)
            times[(name, axis)] = (ms_, plain_ms, *work)
            log("time", (
                f"{name} axis {axis}: kernel {ms_:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}) per call on a {nx}x{ny} rank block, h = {h}, "
                f"n_sub = {h}{' (a pair of ' + str(rows) + 'x' + str(cols) + ' bands)' if name == 'rdma_band' else ''}"
            ))
    # rdma_stage's x launch on new sources and on built ones against its
    # yardstick, in turns (a b c c b a) on the same host.
    cached = fresh(src)
    runs = time_in_turns({
        "new": lambda: rdma.rdma_stage(fresh(src), 0),
        "built": lambda: rdma.rdma_stage(cached, 0),
        "stack": lambda: torch.stack([p[:h] for p in src.own] + [p[nx - h:] for p in src.own]),
    }, dict.fromkeys(("new", "built", "stack"), 50))
    mean = {name: sum(ms) / len(ms) for name, ms in runs.items()}
    log("time", (
        f"rdma_stage axis 0 in turns: {mean['new']:.4f} ms per call on a round's new sources "
        f"(stream, check and pointers included; runs {', '.join(f'{m:.4f}' for m in runs['new'])}), "
        f"{mean['built']:.4f} ms on sources already built, library yardstick (one torch.stack of "
        f"the strips) {mean['stack']:.4f} ms (runs {', '.join(f'{m:.4f}' for m in runs['stack'])}); "
        f"bound {bound(*times[('rdma_stage', 0)][2:])[0]:.5f} ms"
    ))
    kernels = {
        "rdma_stage": Row(errs["rdma_stage"], mean["new"], *times[("rdma_stage", 0)][1:], mean["stack"]),
        "rdma_band": Row(errs["rdma_band"], *times[("rdma_band", 0)]),
    }
    # The device durations (torch.profiler, last in the run) of these launches.
    probes = {"rdma_stage axis 0": lambda: rdma.rdma_stage(cached, 0)}
    for axis in (0, 1):
        local_a, src_a, consts_a, state_a = results[0][3][axis]
        probes[f"rdma_band axis {axis}"] = (
            lambda local_a=local_a, src_a=src_a, consts_a=consts_a, state_a=state_a, axis=axis:
            rdma.rdma_band(local_a, src_a, axis, consts_a, DT, h, state_a)
        )
    return counts, kernels, probes


def time_multihost(device, card: str) -> None:
    """Phase 5, config 5: the single-device 4096^2 step, the 2 x 2 blocked
    and rdma steps on resident blocks; the blocked round against the rdma
    round; an h sweep of the dynamics step; profiles. One card shows what
    the exchange costs, not how the step scales over cards."""
    model1, state, phys, dyn = config5_model(device)
    sharded = {name: sharded_model(device, mevp_backend=name)[1] for name in ("auto", "rdma")}
    blocks = {name: blocks_of(s, state, phys, dyn) for name, s in sharded.items()}
    runs = time_in_turns(
        {
            "single-device": lambda: model1.step(state, phys, dyn, DT),
            "2x2 blocked": lambda: sharded["auto"].run_blocks(*blocks["auto"], DT, 1),
            "2x2 rdma": lambda: sharded["rdma"].run_blocks(*blocks["rdma"], DT, 1),
        },
        {"single-device": 2, "2x2 blocked": 2, "2x2 rdma": 2},
    )
    for name, ms in runs.items():
        report(f"multihost_16m coupled step, {name} ({N16}x{N16})", ms, N16 * N16, card)

    # One round of h subcycles on every rank: blocked against rdma.
    for name in ("auto", "rdma"):
        s = sharded[name]
        states, _, dyns = blocks[name]
        inputs = run_ranks(s.grid.ring, lambda rank: step_consts_of(
            s.models[rank.rank], states[rank.rank], dyns[rank.rank]
        ))
        h = s.models[0].mevp.block_halo
        ms = [time_ms(lambda: run_ranks(s.grid.ring, lambda rank: s.models[rank.rank].mevp.spmd_subcycles(
            *inputs[rank.rank], DT, h
        )), 5) for _ in range(2)]
        log("time", (
            f"multihost_16m one {s.models[0].mevp_schedule()} round of {h} subcycles on 4 ranks: "
            f"{sum(ms) / 2:.4f} ms (runs {', '.join(f'{m:.4f}' for m in ms)}) on {card}"
        ))

    # The h sweep: the dynamics step (no physics) at h = 4, 8, 16.
    fns = {}
    for h in (4, 8, 16):
        for name in ("auto", "rdma"):
            s = sharded_model(device, mevp_backend=name, mevp_block_halo=h)[1]
            b = blocks_of(s, state, phys, dyn)
            fns[f"{'blocked' if name == 'auto' else 'rdma'} h={h}"] = (
                lambda s=s, b=b: s.run_blocks(*b, DT, 1, do_thermo=False)
            )
    runs = time_in_turns(fns, dict.fromkeys(fns, 1))
    for name, ms in runs.items():
        report(f"multihost_16m dynamics step, 2x2 {name} ({N16}x{N16})", ms, N16 * N16, card)

    # The spmd transport's exchange halo H, at k = 1 and 3: on every rank the
    # velocity widened by H, then one call of transport_substeps_tiled_spmd,
    # on the state after a step.
    s = sharded["auto"]
    stepped = s.run_blocks(*blocks["auto"], DT, 1)

    def spmd_transport(rank, k, H):
        model, st = s.models[rank.rank], stepped[rank.rank]
        return tt.transport_substeps_tiled_spmd(
            model, torch.stack([st.hice, st.cice, st.hsnow], dim=1),
            tt.widen_velocity(model, st.velocity.u, st.velocity.v, H), DT / k, k, None,
        )

    fns = {}
    for k in (1, 3):
        for H in (4, 8, 16):
            fns[f"k={k} H={H}"] = lambda k=k, H=H: run_ranks(
                s.grid.ring, lambda rank: spmd_transport(rank, k, H)
            )
    for name, ms in time_in_turns(fns, dict.fromkeys(fns, 2)).items():
        log("time", (
            f"multihost_16m spmd transport on 4 ranks, {name} (config: "
            f"{tt.transport_tiled_spmd_config(s.models[0])}): {sum(ms) / len(ms):.4f} ms "
            f"(runs {', '.join(f'{m:.4f}' for m in ms)}) on {card}"
        ))
    for name in ("auto", "rdma"):
        profile(
            f"multihost_16m coupled step, 2x2 {'blocked' if name == 'auto' else 'rdma'} ({N16}x{N16})",
            lambda: sharded[name].run_blocks(*blocks[name], DT, 1), n_steps=2,
        )
    profile(f"multihost_16m coupled step, single-device ({N16}x{N16})", lambda: model1.step(state, phys, dyn, DT))


# -- the roofline path: K8's chain kernel and the measured ceilings -------------
#: The chain forms whose SASS is counted: the two fused and the unfused.
SASS_FORMS = ("fma", "fma_imm", "mul_add")


def start_sass(library: Path) -> subprocess.Popen:
    """``cuobjdump -sass`` of the library, in the background: it takes ~10 s
    for the whole library, so it runs beside the checks."""
    tool = Path(cc._nvcc()).with_name("cuobjdump")
    return subprocess.Popen(
        [str(tool), "-sass", str(library)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )


def sass_report(job: subprocess.Popen) -> str:
    """FFMA, FMUL and FADD in the chain kernel's fma, fma_imm and mul_add
    forms, from ``start_sass``'s job; fails unless --fmad=false left the
    fma forms fused (FFMA) and the mul_add form unfused (FMUL and FADD, no
    FFMA)."""
    sass, errors = job.communicate()
    if job.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({job.returncode}): {errors}")
    counts = {}
    for section in sass.split("Function : ")[1:]:
        found = re.match(r"_ZN3nst12chain_kernelILi(\d)ELi(\d+)E", section)
        if found and roofline.LINKS[int(found.group(1))] in SASS_FORMS:
            form = f"{roofline.LINKS[int(found.group(1))]}/{found.group(2)}"
            counts[form] = {op: len(re.findall(rf"\b{op}\b", section)) for op in ("FFMA", "FMUL", "FADD")}
    expected = [f"{link}/{unroll}" for link in SASS_FORMS for unroll in roofline.UNROLLS]
    if sorted(counts) != sorted(expected):
        raise AssertionError(f"chain forms in the SASS: {sorted(counts)}, expected {expected}")
    for form, ops in counts.items():
        fused = not form.startswith("mul_add/")
        if fused != (ops["FFMA"] > 0) or (not fused and (ops["FMUL"] == 0 or ops["FADD"] == 0)):
            raise AssertionError(f"chain {form}: {ops} (fma must issue FFMA, mul_add FMUL + FADD only)")
    return "chain SASS (cuobjdump): " + "; ".join(
        f"{form}: " + ", ".join(f"{op} {n}" for op, n in ops.items()) for form, ops in sorted(counts.items())
    ) + " (fma and fma_imm fused, mul_add unfused under --fmad=false)"


def check_roofline(device, card: str) -> tuple:
    """The roofline path: the chain kernel against its plain version for
    every link and both unrolls, on seeded planes at 512^2 and a ragged
    shape; then, from zeroed launch counts, ``measure_vpu_peak`` (fma,
    fma_imm and mul_add) and ``measure_hbm_peak``, each held below the data
    sheet's peak. Returns (launch counts, chain's Row, measured ceilings)."""
    rng = np.random.default_rng(SEED + 13)
    err = 0.0
    for nx, ny in ((roofline.PEAK_N, roofline.PEAK_N), RAGGED):
        t = lambda x: torch.tensor(x, device=device, dtype=torch.float32)
        a, b = t(rng.uniform(0.5, 0.9999, (nx, ny))), t(rng.uniform(-1e-3, 1e-3, (nx, ny)))
        for unroll, iters in CHAIN_CHECK_ITERS.items():
            links = unroll * iters
            for link in roofline.LINKS:
                got = roofline.chain(a, b, link, iters, unroll)
                tag = f"chain {link} unroll {unroll} {nx}x{ny} ({links} links)"
                if link in ("fma", "fma_imm"):
                    ref = roofline.chain_reference(a.double(), b.double(), link, iters, unroll)
                    err = max(err, compare(f"{tag} vs float64", got, ref, 2 * links * 2.0**-24))
                else:
                    ref = roofline.chain_reference(a, b, link, iters, unroll)
                    err = max(err, compare(tag, got, ref, TOL_CHAIN))
    log("build", f"chain: tile {roofline.TILE[0]}x{roofline.TILE[1]} per block of 256 threads, 4 elements a thread")
    n, (unroll, iters) = roofline.PEAK_N, roofline.PEAK_CALLS[0]
    a, b = roofline._planes(device)
    # The plain version at the checks' 160 links (a K8 call's 1.6e6 would
    # take minutes of launches).
    plain_ms = time_ms(lambda: roofline.chain_reference(a, b, "fma", CHAIN_CHECK_ITERS[16], 16), 3)

    cc.reset_launches()
    peaks = roofline.measure_vpu_peak(device)
    hbm = roofline.measure_hbm_peak(device)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    if counts["chain"] == 0:
        raise AssertionError("measure_vpu_peak launched no chain kernel")
    fma, fma_imm, mul_add = (peaks[f"fp32_{link}_chain_ops_per_s"] for link in SASS_FORMS)
    log("roofline", (
        f"fp32 fma chain {fma:.4e} op/s, fma_imm chain {fma_imm:.4e} op/s, mul_add chain "
        f"{mul_add:.4e} op/s (mul_add / fma_imm {mul_add / fma_imm:.3f}), HBM streaming add "
        f"{hbm:.4e} B/s on {card}; best ms per call: "
        + ", ".join(f"{form} {ms:.4f}" for form, ms in peaks["ms"].items())
        + f"; {counts['chain']} chain launches"
    ))
    for what, rate, peak in (
        ("fma", fma, PEAK_FP32), ("fma_imm", fma_imm, PEAK_FP32), ("mul_add", mul_add, PEAK_FP32),
        ("HBM", hbm, PEAK_BYTES),
    ):
        if not 0 < rate < peak:
            raise AssertionError(
                f"{what} ceiling {rate:.4e} is not below the data sheet's {peak:.4e}: a counting fault"
            )
    work = (3 * n * n * 4, 2.0 * unroll * iters * n * n)
    ms = peaks["ms"][f"fma/{unroll}"]
    log("time", (
        f"chain: kernel {ms:.4f} ms per call ({unroll} x {iters} fma links at {n}x{n}), bound "
        f"{bound(*work)[0]:.4f} ms ({bound(*work)[1]}); plain {plain_ms:.4f} ms for 160 links at {n}x{n}"
    ))
    ceilings = {"bytes_per_s": hbm, "ops_per_s": mul_add, "fused_ops_per_s": fma_imm}
    return counts, Row(err, ms, plain_ms, *work, fused=True), ceilings


def kernel_summary(kernels: dict, counts: dict, ceilings: dict) -> dict:
    """The kernels' JSON line: per kernel its launches on the main paths,
    check error, times, ``bound_ms`` on the data sheet's peaks and
    ``measured_bound_ms`` on the measured HBM rate and the measured mul_add
    rate (the port's kernels issue unfused float32; the chain's fma form,
    fused, on the fma_imm rate)."""
    launches = dict.fromkeys(cc.KERNELS, 0)
    for path, names in PATH_KERNELS.items():
        for k in names:
            launches[k] += counts[path][k]

    def row_json(k: str) -> dict:
        row = kernels[k]
        bound_ms, bound_by = bound(row.n_bytes, row.n_ops)
        ops_per_s = ceilings["fused_ops_per_s" if row.fused else "ops_per_s"]
        measured = max(row.n_bytes / ceilings["bytes_per_s"], row.n_ops / ops_per_s) * 1e3
        return {
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": launches[k], "max_abs_err": row.err, "ms": row.ms, "plain_ms": row.plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "measured_bound_ms": measured,
            "library_ms": row.library_ms,
        }

    # No single PyTorch call computes these stencils or the chain, so
    # library_ms is null, except for rdma_stage's strip pack (one torch.stack).
    return {"kernels": [row_json(k) for k in cc.KERNELS]}


def cluster_report(device, ptxas: str):
    """[build] lines of the cluster kernels at their paths' shapes: the
    shipped launch (and ho_tiled's 2 x 2 clusters), shared bytes,
    registers and spills of the instantiation it runs (ptxas), the
    clusters the card holds at once (cudaOccupancyMaxActiveClusters), the
    blocks of a launch and the SMs it reaches."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    regs = {line.split(":")[0]: line.split(":", 1)[1].strip() for line in ptxas_report(ptxas)}
    n = N4  # the HO 1M path's size
    for config in (htc.launch_config(n, n), htc.CLUSTER_2X2):  # shipped, and the best cluster
        ca, cb = config.clusters(n, n)
        active = htc.max_clusters(device, config)
        blocks = config.grid(n, n)[0] * config.grid(n, n)[1]
        yield (
            f"ho_tiled at {n}x{n}{' (shipped)' if config == htc.launch_config(n, n) else ''}: clusters of "
            f"{config.rows}x{config.cols} blocks of {config.threads} "
            f"threads, {config.sub}^2 sub-windows and their aprons, window {config.window}, interior "
            f"{config.interior}, halo {config.halo} (redundancy {config.redundancy():.3f}), "
            f"{config.shared_bytes()} B shared; ptxas "
            f"{regs.get(f'ho_tiled_kernel<width {config.sub}>', regs.get('ho_tiled_kernel<any width>', '?'))}; "
            f"{active} clusters at once ({active * config.rows * config.cols} blocks); a launch: "
            f"{ca}x{cb} clusters, {blocks} blocks, {ca * cb / active:.2f} waves, reaches "
            f"{min(blocks, active * config.rows * config.cols, sms)} of {sms} SMs"
        )
    h = 16  # config 5's ghost width
    for axis, name in ((0, "along columns, x bands"), (1, "along rows, y bands")):
        band = rdma.launch_config(axis)
        bound = rdma.launch_bound(band.threads)
        along = rdma.band_shape(axis, h, N16 // 2, N16 // 2, h)[1 - axis]
        blocks = 2 * band.cluster * band.clusters(along, h)
        active = rdma.max_clusters(device, axis, h, band)
        yield (
            f"rdma_band {name.split(', ')[1]} of a {N16 // 2}^2 rank block, h = {h}: clusters of "
            f"{band.cluster} blocks of {band.threads} threads, {band.seg} cells along the band each, "
            f"{band.cells_per_thread(h)} cells a thread, {band.shared_bytes(h, axis)} B shared; ptxas "
            f"{regs.get(f'rdma_band_kernel<{name}, {bound} threads>', '?')}; {active} clusters at once; a launch "
            f"(a pair of bands): {blocks} blocks, reaches {min(blocks, active * band.cluster, sms)} "
            f"of {sms} SMs"
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log("device", (
        f"auto thresholds: tiled schedule from {coupled.TILED_MIN_ELEMENTS} elements "
        f"(uniform), mevp_tiled from {coupled.SINGLE_MAX_ELEMENTS} (graded, spherical), "
        f"ho_tiled from {mevp_ho.HO_SINGLE_MAX_ELEMENTS} (HO)"
    ))

    t_start = t0 = time.perf_counter()
    path = cc.build()
    cc._library()
    log("build", f"{path.name} ready in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(path.with_suffix(".log").read_text()):
        log("build", line)
    log("build", (
        f"mevp_single: {single.max_blocks(False, device)} resident blocks (uniform), "
        f"{single.max_blocks(True, device)} (metric), of 256 threads"
    ))
    for size, config in (("large uniform", mt.LARGE), ("other", mt.SMALL)):
        log("build", (
            f"mevp_tiled {size} grids: tile, halo, threads {config}, c_w and inv_drag in registers, "
            f"{mt.cells_per_thread(*config)} cells a thread, {mt.shared_bytes(*config[:2])} B shared; "
            f"{mt.max_blocks(device, *config)} resident blocks per SM (uniform), "
            f"{mt.max_blocks(device, *config, metric=True)} (metric)"
        ))
    for line in cluster_report(device, path.with_suffix(".log").read_text()):
        log("build", line)
    sass = start_sass(path)
    try:
        return run_phases(device, smi, sass, t_start)
    finally:
        sass.kill()  # nothing once it has been read
        sass.wait()


def run_phases(device, smi: str, sass: subprocess.Popen, t_start: float) -> int:
    """The phases after the build; the SASS count is read before the timings."""

    def phase(fn, *args):
        """fn(*args), with its wall time logged."""
        t0 = time.perf_counter()
        out = fn(*args)
        log("time", f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s wall")
        return out

    counts_roofline, chain_row, ceilings = phase(check_roofline, device, smi)
    model, _, _ = bench_model(device)
    kernels = phase(check_kernels, model, device)
    kernels.update(phase(check_tiled, device))
    extra = phase(check_single, device)
    kernels["mevp_single"] = extra["mevp_single"]
    extra_ho = phase(check_ho, device)
    kernels["ho_single"], kernels["ho_tiled"] = extra_ho["ho_single"], extra_ho["ho_tiled"]
    extra["transport_metric"] = max(extra["transport_metric"], extra_ho["transport_qv"])
    # The metric checks of the kernels with a uniform-mesh timing above.
    for kernel, key in (
        ("transport_tiled", "transport_metric"), ("dg1_rk_stage", "dg1_rk_stage_metric"),
    ):
        kernels[kernel] = replace(kernels[kernel], err=max(kernels[kernel].err, extra[key]))
    counts = phase(check_slice, device)
    counts_5, kernels_5, probes = phase(check_multihost, device)
    counts.update(counts_5, roofline=counts_roofline)
    kernels.update(kernels_5, chain=chain_row)
    log("build", sass_report(sass))
    phase(time_paths, device, smi)
    phase(time_ho, device, smi)
    phase(time_multihost, device, smi)
    # Last, as a profiler session slows the host's later launches. Every
    # row's ms stays the back-to-back time per call; the device durations
    # are logged beside it.
    for probe, fn in probes.items():
        ms = device_ms(fn, probe.split()[0])
        log("time", f"{probe} device duration {ms:.5f} ms (torch.profiler)")
        if probe == "rdma_band axis 0":
            log("time", f"rdma_band: back to back {kernels['rdma_band'].ms:.5f} ms per call, device {ms:.5f} ms")

    summary = kernel_summary(kernels, counts, ceilings)
    log("time", f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
