"""Smoke run of the PyTorch/CUDA port (nextsimdg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``nextsimdg_tpu_torch/csrc`` and
drives the port's main path, the dynamics-only coupled step of the
headline configuration: a closed 256 x 256 mesh of 2 km elements, dG1
tracers (hice, cice, hsnow), 100 mEVP subcycles, dt = 600 s, wind (8, 2)
m/s, ocean current (0.02, 0) m/s, CFL-adaptive transport substeps, float32.
Phases, each printed on its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the kernels' compile (or cache hit) time;
3. kernels: each kernel against its plain PyTorch version at 256^2 on
   inputs drawn from a numpy seed, max abs / rel error against the stated
   tolerance;
4. slice: one step on the kernel path against the plain path on the card;
   then 20 steps from zeroed launch counters: every leaf finite,
   0 <= cice <= 1, hice >= 0, hsnow >= 0, and every kernel launched;
5. times with CUDA events after warm-up: ms per step and element updates/s
   for the kernel path and the plain path, and each kernel's time.

Any failure raises (non-zero exit); there is no CPU path. The line before
the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import MEVPParams, RectMesh
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, VelocityState

N = 256
N_SUBCYCLES = 100
DT = 600.0
SEED = 0
REPLACES = "nextsimdg_tpu/dynamics/kernels/coupled_pallas.py:62"
SOURCES = {
    "mevp_stress": "nextsimdg_tpu_torch/csrc/mevp.cu",
    "mevp_velocity": "nextsimdg_tpu_torch/csrc/mevp.cu",
    "dg1_sample_cfl": "nextsimdg_tpu_torch/csrc/transport.cu",
    "dg1_rk_stage": "nextsimdg_tpu_torch/csrc/transport.cu",
}
# Single launches: the kernel and the plain version run the same float32
# operations in the same order; they differ where PyTorch on CUDA divides by
# a scalar through its reciprocal (a few ulp), so 1e-5 of the plane's max.
TOL_LAUNCH = 1e-5
# One full step: 100 subcycles amplify those ulps through the shared divide
# (a CPU emulation of the kernels measured ~3e-5 of the plane's max on the
# stresses after 300 subcycles), hence 1e-3 for the mEVP planes; the
# tracers move by dt * velocity, 1e-5 of their max.
TOL_STEP_MEVP = 1e-3
TOL_STEP_TRACER = 1e-5


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


def time_ms(fn, reps: int) -> float:
    """Mean ms per call, back to back, on the device timeline (CUDA events)
    after a warm-up call: where the host issues slower than the device
    runs, this is the issue rate."""
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


def bench_model(device):
    mesh = RectMesh(N, N, dx=512e3 / N, dy=512e3 / N)
    model = CoupledModel(mesh, degree=1, mevp_params=MEVPParams(), n_subcycles=N_SUBCYCLES)
    state = model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0,
        device=device, dtype=torch.float32,
    )
    full = lambda value: torch.full((N, N), value, device=device, dtype=torch.float32)
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
    timed = {
        "mevp_stress": (
            lambda: cc._mevp_stress_(planes, consts, c_w, inv_drag, scalars, stream),
            lambda: solver.stress_update(carry, consts),
        ),
        "mevp_velocity": (
            lambda: cc._mevp_velocity_(planes, consts, c_w, inv_drag, scalars, stream),
            lambda: solver.velocity_update(carry_v, consts, ref[3], ref[4], DT),
        ),
        "dg1_sample_cfl": (
            lambda: cc._dg1_sample_cfl_(u, v, zeros2, tables, stream),
            lambda: cc.dg1_sample_cfl_reference(transport, u, v),
        ),
        "dg1_rk_stage": (
            lambda: cc._dg1_rk_stage_(
                psi, base, u, v, face_x, face_y, out, 0.5, 0.5, 300.0, tables, stream
            ),
            lambda: cc.dg1_rk_stage_reference(
                transport, psi, base, u, v, face_x, face_y, 0.5, 0.5, 300.0
            ),
        ),
    }
    times = {}
    for name, (kernel, plain) in timed.items():
        times[name] = (time_ms(kernel, 200), time_ms(plain, 20))
        log("time", (
            f"{name}: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
            f"per call at {N}x{N}"
        ))
    return {name: (results[name], *times[name]) for name in cc.KERNELS}


def leaves(state, like):
    """(name, leaf, leaf of ``like``) for every tensor of a CoupledState."""
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        yield name, getattr(state, name), getattr(like, name)
    for name in ("u", "v", "s11", "s22", "s12"):
        yield f"velocity.{name}", getattr(state.velocity, name), getattr(like.velocity, name)


def ptxas_report(text: str):
    """'kernel: registers; spills' lines from the compiler's -v report."""
    kernel, spills = "?", ""
    for line in text.splitlines():
        found = re.search(r"entry function '_ZN3nst(\d+)(\w+)'", line)
        if found:
            kernel = found.group(2)[: int(found.group(1))]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}"


def check_slice(device) -> dict:
    """Phase 4: the main path against the plain path, then 20 steps."""
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

    cc.reset_launches()
    out = model.run(state, None, forcing, DT, 20, do_thermo=False)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    log("slice", f"20 steps, launches: {counts}")
    for name, leaf, first in leaves(out, state):
        if leaf.shape != first.shape or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"20 steps: {name} is not finite or has shape {tuple(leaf.shape)}")
    cice, hice, hsnow = out.cice[0], out.hice[0], out.hsnow[0]
    if not (bool((cice >= 0).all()) and bool((cice <= 1).all())):
        raise AssertionError("20 steps: cice outside [0, 1]")
    if not (bool((hice >= 0).all()) and bool((hsnow >= 0).all())):
        raise AssertionError("20 steps: negative hice or hsnow")
    missing = [name for name in cc.KERNELS if counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    log("slice", (
        f"20 steps finite and bounded: max|u| {float(out.velocity.u.abs().max()):.4f} m/s, "
        f"cice in [{float(cice.min()):.4f}, {float(cice.max()):.4f}], "
        f"hice >= {float(hice.min()):.4f}"
    ))
    return counts


def time_paths(device, card: str) -> None:
    """Phase 5: ms per step, kernel path and plain path, in turns."""
    model, state, forcing = bench_model(device)
    kernel = lambda: model.step(state, None, forcing, DT, do_thermo=False)
    plain = lambda: model.step_dynamics(state, forcing, DT, phase=cc.fused_dynamics_reference)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        fn = kernel if name == "kernel" else plain
        reps = 10 if name == "kernel" else 3
        runs[name].append(time_ms(fn, reps))
    for name, ms in runs.items():
        mean = sum(ms) / len(ms)
        log("time", (
            f"{name} path: {mean:.3f} ms/step (runs {', '.join(f'{m:.3f}' for m in ms)}), "
            f"{N * N / (mean / 1e3):.4e} element updates/s at {N}x{N}, "
            f"{N_SUBCYCLES} subcycles, f32 on {card}"
        ))


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

    t0 = time.perf_counter()
    path = cc.build()
    cc._library()
    log("build", f"{path.name} ready in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(path.with_suffix(".log").read_text()):
        log("build", line)

    model, _, _ = bench_model(device)
    kernels = check_kernels(model, device)
    counts = check_slice(device)
    time_paths(device, smi)

    summary = {"kernels": [
        {
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES,
            "launches": counts[k], "max_abs_err": kernels[k][0],
            "ms": kernels[k][1], "plain_ms": kernels[k][2],
        }
        for k in cc.KERNELS
    ]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
