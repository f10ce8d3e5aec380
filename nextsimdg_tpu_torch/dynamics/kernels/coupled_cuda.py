"""The dynamics phase on the H100: the hand-written CUDA kernels.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/coupled_pallas.py``, whose
``fused_dynamics_pallas`` runs N mEVP subcycles, the CG1 -> quadrature
velocity sampling, the CFL substep count and k limited SSP-RK dG steps in
one TPU kernel with the whole grid resident on one core. A 256^2 float32
plane is more than one SM's shared memory, so on Hopper the phase is a
sequence of launches over planes in global memory, on one of three
schedules (``dynamics_phase``):

=================== =========================== ===================================
kernel              source                      plain version (same inputs)
=================== =========================== ===================================
``mevp_stress``     ``csrc/mevp.cu``            ``MEVPSolver.stress_update``
                    (halo form:                 ``mevp_stress_halo_reference``
                    ``mevp_spmd*.cu``)
``mevp_velocity``   ``csrc/mevp.cu``            ``MEVPSolver.velocity_update``
                    (halo form:                 ``mevp_velocity_halo_reference``
                    ``mevp_spmd*.cu``)
``dg1_sample_cfl``  ``csrc/transport.cu``       ``dg1_sample_cfl_reference``
``dg1_rk_stage``    ``csrc/transport.cu``       ``dg1_rk_stage_reference``
                    (halo form:                 ``dg1_rk_stage_halo_reference``
                    ``transport_spmd*.cu``)
``dg1_limit``       ``csrc/transport_tvb.cu``   ``dg1_limit_reference``
                    (halo form:                 ``dg1_limit_halo_reference``
                    ``transport_tvb_spmd.cu``)
``mevp_tiled``      ``csrc/mevp_tiled.cu``      ``mevp_subcycles_reference``
``transport_tiled`` ``csrc/transport_tiled.cu`` ``transport_substeps_reference``
``mevp_single``     ``csrc/mevp_single.cu``     ``mevp_subcycles_reference``
``ho_single``       ``csrc/ho_single.cu``       ``ho_subcycles_reference``
``ho_tiled``        ``csrc/ho_tiled.cu``        ``ho_subcycles_reference``
``ho_stress``       ``csrc/ho_halves_spmd.cu``  ``ho_stress_halo_reference``
``ho_velocity``     ``csrc/ho_halves_spmd.cu``  ``ho_velocity_halo_reference``
``fused_dynamics``  ``csrc/fused_dynamics.cu``  ``fused_dynamics_reference``
``rdma_stage``      ``csrc/mevp_rdma.cu``       ``rdma_stage_reference``
``rdma_band``       ``csrc/mevp_rdma.cu``       ``rdma_band_reference``
                    (HO: ``mevp_rdma_ho.cu``)
``chain``           ``csrc/roofline.cu``        ``benchmarks.roofline.chain_reference``
=================== =========================== ===================================

The first four are K1's split schedule, wrapped here. Per step: 2 launches per
subcycle, one ``dg1_sample_cfl`` whose two max speeds are read back once
to fix k (one host sync), then one ``dg1_rk_stage`` per RK stage and
substep (a tile an element block, one thread an element and tracer, each
face's flux computed once; 3 tracers). ``dg1_rk_stage``
also takes the HO path's precomputed quadrature velocity (its ``qv`` form)
in place of the CG1 (u, v), and runs ``DGTransport.run``'s unlimited steps
(``transport_run``: its no-limit instance, one tracer a launch, in the
``qv`` form). The transport kernels run dG0, dG1 and dG2: each launch
takes the tables of its transport's degree (``_dg1_tables``), and the
tracers are (K, T, nx, ny) with K = 1, 3 or 6. The others have wrapper modules of their own:
``mevp_tiled_cuda`` and ``transport_tiled_cuda`` (the ghost-zone tiled
schedule, K2 and K3 of the JAX package) and ``mevp_single_cuda`` (all N
subcycles in one launch, K4), ``mevp_rdma_cuda`` (the overlapped
halo round of a rank block, K7) and ``fused_dynamics_cuda`` (K1 as one
launch: the whole phase, k computed on the card, no host sync, on the
uniform closed CG1 fixed-alpha dG1 rk2 forms; ``dynamics_phase(mevp=
"fused")``); ``chain``, the ceiling probe (K8), is wrapped by
``nextsimdg_tpu_torch.benchmarks.roofline``. Every mEVP kernel takes
the 7 uniform consts or, on a graded or spherical mesh, the 12 with the
metric planes, and ``a_node`` besides in the A-weighted form; the
momentum form (``mevp_form``: weighted, adaptive, both or neither) selects
a template instance of each CG1 mEVP kernel. The transport kernels read the
transport's metric planes on such a mesh.

A periodic axis (``wrap_bits``) selects the periodic template instances of
every single-domain kernel above (the mEVP kernels take it above the
momentum form's bits, ``kernel_form``): the loads wrap and no face is a
wall; the closed instances keep their code. With the transport's TVB limiter (``DGTransport(tvb_m=)``,
dG1 and dG2) each staged stage is ``dg1_rk_stage``'s unlimited instance
(``csrc/transport_tvb.cu``) and one ``dg1_limit`` launch, which applies
``limit_slopes`` and the positivity limiter in place (``dg1_limit``, plain
version ``dg1_limit_reference``); ``transport_tiled`` has a TVB form of its
own (``transport_tiled_cuda``).

With ``FreeDriftSolver`` the momentum part of the phase is its plain step
on every device (``free_drift_subcycles``: no TPU kernel exists for it
either), followed by the same CFL count and transport kernels.

With the higher-order solver (``MEVPSolverHO``) the phase runs
``ho_single`` (all N subcycles in one launch, K5 of the JAX package) or
``ho_tiled`` (ghost-zone tiles, K6), wrapped by ``ho_single_cuda`` and
``ho_tiled_cuda`` on the 17 state and 29 const planes packed here (33 with
``a_weighted_stress`` or on a graded or spherical mesh, whose element
widths are four more planes, 37 with both; the forms and the periodic axes
in the kernels' ``form``, ``kernel_form``); the CG2
velocity is sampled at the quadrature points in plain PyTorch
(``ho_velocity_to_quad``, as the JAX package does it in XLA), k comes from
those samples (one host sync), and ``transport_tiled`` or the staged
``dg1_rk_stage`` (``transport="xla"``, and rk3) advects the tracers with the
precomputed samples (their ``qv`` form).

On a rank grid (``parallel``) the phase runs the solver's exchange
schedule (``MEVPSolver.spmd_subcycles``: ``mevp_tiled`` on the widened
block, the rdma round, or the width-1 halves; ``MEVPSolverHO.spmd_subcycles``:
ho_tiled or ho_single on the widened block, the rdma round on 17 planes,
or ``ho_stress`` and ``ho_velocity``; free drift's plain step), samples the CFL
speeds of the rank's own elements (in its widened CG1 velocity, or its CG2
velocity's quadrature samples), agrees k over the ranks with one host sync
for the whole grid, and advects with ``transport_tiled`` on the widened
block (``transport_tiled_cuda.transport_substeps_tiled_spmd``: on a graded
or spherical mesh with the widened metric planes, with TVB with the global
walls inside the block, with the HO solver with the widened samples, and
both), or on the staged route (``spmd_staged_transport``: TVB on a graded,
spherical or ring mesh, and ``transport="xla"``), whose stages are the halo
forms of ``dg1_rk_stage`` and ``dg1_limit``: each reads the rank's block
widened by one ring (psi, or the stage's means, exchanged before each
launch) and the four global walls as indices, and writes the block's own
elements (``dg1_rk_stage_halo``, ``dg1_limit_halo``). On the width-1
("xla") mEVP schedule of a rank grid each subcycle is two launches behind
width-1 strip exchanges (``spmd_xla_subcycles``): the halo forms of
``mevp_stress`` and ``mevp_velocity``, or with the HO solver ``ho_stress``
and ``ho_velocity``, the two halves of K5's subcycle as grid-wide kernels
(``spmd_xla_ho_subcycles``); each reads the rank's own block and the
neighbour ranks' strips (``stencil.plus_strips``, ``minus_strips``) and
writes the block's own elements or nodes.

Each public wrapper runs the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (float32, contiguous, one device); it raises for
anything else and never falls back. ``launches`` counts the kernel
launches per kernel, those of the other modules included. Every
``csrc/*.cu`` is built with ``nvcc`` for ``sm_90a`` at first use (one
compiler process per source, all
started together, then one link) into one library in
``build/nextsimdg_tpu_torch/`` beside the package, keyed on a hash of the
sources and flags, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..mesh import block_mesh
from ..mevp import MEVP_CONSTS, MEVPSolver, VelocityState, const_names
from ..mevp_ho import (
    HO_KERNEL_CONSTS, HOField, MEVPSolverHO, ho_subcycles_reference, ho_velocity_to_quad,
)
from ..dgbasis import dg_basis
from ..transport import (
    DGTransport, QuadVelocity, max_speeds, sampling_weights, substeps_from_speeds,
    velocity_from_cg,
)

KERNELS = (
    "mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage", "dg1_limit",
    "mevp_tiled", "transport_tiled", "mevp_single", "ho_single", "ho_tiled",
    "rdma_stage", "rdma_band", "chain", "ho_stress", "ho_velocity", "fused_dynamics",
)

#: The entry points of the CG1 mEVP halves' halo forms (counted as
#: ``mevp_stress`` and ``mevp_velocity``).
_HALO_ENTRIES = ("mevp_stress_halo", "mevp_velocity_halo")

#: Launches per kernel since the last ``reset_launches()``.
launches = dict.fromkeys(KERNELS, 0)

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "nextsimdg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # Each multiply and add rounds on its own, like the plain version's
    # separate tensor operations, so kernel and plain version agree to the
    # ulp (measured: exactly, on the H100), and the schedules that share
    # an element body agree bit for bit.
    "--fmad=false",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-shared",)

#: The momentum forms' bits (kFormWeighted, kFormAdaptive of
#: csrc/mevp_body.cuh), and the HO kernels' metric form (kHoMetric of
#: csrc/ho_body.cuh: the HO solver has no adaptive form).
FORM_WEIGHTED, FORM_ADAPTIVE = 1, 2
HO_FORM_METRIC = 2
#: The periodic axes' bits (kWrapX, kWrapY of csrc/common.cuh), and their
#: shift in an mEVP kernel's form argument (kFormWrapShift).
WRAP_X, WRAP_Y = 1, 2
_FORM_WRAP_SHIFT = 2
#: dg1_rk_stage's modes (csrc/transport.cu): the advection run's no-limit
#: instance, the coupled step's limited stage, and the TVB form's stage
#: without the limiter (dg1_limit follows).
_STAGE_RUN, _STAGE_LIMITED, _STAGE_UNLIMITED = 0, 1, 2
#: The transport's metric planes in the order of Dg1MetricPlanes in
#: csrc/dg1_body.cuh.
_DG1_METRIC = ("inv_dx", "inv_dy", "face_x", "face_y", "inv_area")
_RK_STAGES = {
    "rk1": ((0.0, 1.0),),
    "rk2": ((0.0, 1.0), (0.5, 0.5)),
    "rk3": ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0)),
}

_lib = None
# The ranks of a rank grid launch from threads of their own: one build, and
# no launch count lost.
_lock = threading.Lock()


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


# -- build and bind -----------------------------------------------------------
def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libnextsimdg_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile the kernels unless the library of these sources exists.

    One ``nvcc -c`` per source runs in parallel, then one link. The
    compilers' report (registers, spills per kernel) is kept beside the
    library as ``.log``.
    """
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    work = BUILD_DIR / f"{path.stem}.{os.getpid()}.objects"
    work.mkdir(exist_ok=True)
    objects = [work / f"{src.stem}.o" for src in cu]
    jobs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], cwd=CSRC,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(cu, objects)
    ]
    reports = [job.communicate()[0] for job in jobs]
    log = "".join(f"== {src.name}\n{text}" for src, text in zip(cu, reports))
    failed = [src.name for src, job in zip(cu, jobs) if job.returncode != 0]
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    if not failed:
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    shutil.rmtree(work, ignore_errors=True)
    path.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, path)
    return path


def _library():
    if _lib is not None:
        return _lib
    with _lock:
        return _lib if _lib is not None else _bind()


def _bind():
    global _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [p, i, p]  # host scalars/tables, device index, stream
    lib.nst_mevp_stress.argtypes = [p] * 9 + [i, i, i] + tail
    lib.nst_mevp_velocity.argtypes = [p] * 9 + [i, i, i] + tail
    lib.nst_dg1_sample_cfl.argtypes = [p] * 4 + [i] * 9 + tail
    lib.nst_dg1_rk_stage.argtypes = [p] * 9 + [i] * 6 + [f, f, f] + tail
    lib.nst_dg1_limit.argtypes = [p, p, p, f, f] + [i] * 5 + tail
    lib.nst_dg1_rk_stage_halo.argtypes = [p] * 9 + [i] * 5 + [p, f, f, f] + tail
    lib.nst_dg1_rk_stage_halo.restype = i
    lib.nst_dg1_limit_halo.argtypes = [p, p, p, p, f, f] + [i] * 4 + [p] + tail
    lib.nst_dg1_limit_halo.restype = i
    lib.nst_mevp_tiled.argtypes = [p] * 11 + [i] * 7 + tail
    lib.nst_transport_tiled.argtypes = [p] * 8 + [i] * 15 + [p, p, p, f] + tail
    lib.nst_mevp_single.argtypes = [p] * 7 + [i] * 9 + [p] + tail
    lib.nst_ho_single.argtypes = [p] * 3 + [i] * 10 + [p] + tail
    lib.nst_ho_tiled.argtypes = [p] * 3 + [i] * 11 + [p] + tail
    lib.nst_rdma_stage.argtypes = [p, p, i, p, i, p]
    lib.nst_rdma_band.argtypes = [p, p, i, p, i, i, i, i, p, i, p, p, i, i, i, p]
    lib.nst_rdma_band_ho.argtypes = [p, p, i, p] + [i] * 6 + [p, i, p, p, p, i, i, p]
    lib.nst_rdma_band_ho.restype = i
    lib.nst_chain.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.nst_mevp_stress_halo.argtypes = [p] * 11 + [i] * 3 + tail
    lib.nst_mevp_velocity_halo.argtypes = [p] * 13 + [i] * 3 + tail
    lib.nst_ho_stress.argtypes = [p] * 4 + [i] * 3 + [p, p, i, p]
    lib.nst_ho_velocity.argtypes = [p] * 6 + [i] * 3 + [p, p, i, p]
    d = ctypes.c_double
    lib.nst_fused_dynamics.argtypes = [p] * 12 + [i] * 9 + [d] + [i] * 3 + [p] * 5 + tail[1:]
    lib.nst_fused_dynamics_max_blocks.argtypes = [i] * 5 + [p, i]
    lib.nst_fused_dynamics_max_blocks.restype = i
    lib.nst_fused_dynamics_shared_bytes.argtypes = [i] * 4 + [p]
    lib.nst_fused_dynamics_shared_bytes.restype = i
    lib.nst_fused_substeps.argtypes = [p, p, i, d, i, i, i, p, i, p]
    lib.nst_fused_substeps.restype = i
    for name in KERNELS + _HALO_ENTRIES:
        getattr(lib, "nst_" + name).restype = i
    lib.nst_mevp_tiled_max_blocks.argtypes = [i] * 6
    lib.nst_mevp_tiled_max_blocks.restype = i
    lib.nst_mevp_single_max_blocks.argtypes = [i] * 7
    lib.nst_mevp_single_max_blocks.restype = i
    lib.nst_ho_single_max_blocks.argtypes = [i] * 5
    lib.nst_ho_single_max_blocks.restype = i
    lib.nst_ho_single_syncs.argtypes = [p] + [i] * 9 + [p]
    lib.nst_ho_single_syncs.restype = i
    lib.nst_transport_tiled_blocks_per_sm.argtypes = [i] * 8
    lib.nst_transport_tiled_blocks_per_sm.restype = i
    lib.nst_transport_tiled_shared_bytes.argtypes = [i] * 6
    lib.nst_transport_tiled_shared_bytes.restype = i
    lib.nst_ho_tiled_max_clusters.argtypes = [i] * 7
    lib.nst_ho_tiled_max_clusters.restype = i
    lib.nst_rdma_band_max_clusters.argtypes = [i] * 6
    lib.nst_rdma_band_max_clusters.restype = i
    lib.nst_rdma_band_ho_max_clusters.argtypes = [i] * 9
    lib.nst_rdma_band_ho_max_clusters.restype = i
    lib.nst_window_syncs.argtypes = [i] * 6 + [p, p]
    lib.nst_window_syncs.restype = i
    for name in ("mevp_n_scalars", "dg1_n_table_floats", "ho_n_scalars", "ho_n_table_floats", "ho_n_consts"):
        getattr(lib, "nst_" + name).restype = i
    lib.nst_dg1_n_table_floats.argtypes = [i]
    lib.nst_error_string.argtypes = [i]
    lib.nst_error_string.restype = ctypes.c_char_p
    if lib.nst_mevp_n_scalars() != _N_MEVP_SCALARS:
        raise RuntimeError("csrc/mevp.cu MevpScalars disagrees with the packing")
    if any(lib.nst_dg1_n_table_floats(d) != _n_dg1_table(d) for d in DEGREES):
        raise RuntimeError("csrc/dg1_body.cuh DgTables disagrees with the packing")
    if (
        lib.nst_ho_n_scalars() != _N_HO_SCALARS or lib.nst_ho_n_table_floats() != _N_HO_TABLE
        or lib.nst_ho_n_consts() != len(HO_KERNEL_CONSTS)
    ):
        raise RuntimeError("csrc/ho_body.cuh HoScalars, HoTables or HoConsts disagrees with the packing")
    _lib = lib
    return lib


def _launch(name: str, *args, entry: str = None) -> None:
    """Calls ``nst_<entry>`` (default: ``nst_<name>``) and counts one launch
    of kernel ``name``; raises on its CUDA error."""
    lib = _library()
    err = getattr(lib, "nst_" + (entry or name))(*args)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: {lib.nst_error_string(err).decode()}"
        )
    with _lock:
        launches[name] += 1


# -- host-side packing of the kernels' scalars -------------------------------
_N_MEVP_SCALARS = 19
#: The DG degrees the transport kernels run.
DEGREES = (0, 1, 2)
_N_HO_SCALARS = 16
_N_HO_TABLE = 132


def _floats(values):
    return (ctypes.c_float * len(values))(*map(float, values))


def _f32_reciprocal(x: float) -> float:
    """1/x rounded as PyTorch on CUDA rounds the reciprocal of a Python
    scalar divisor: a float32 division of float32 values."""
    return float(np.float32(1.0) / np.float32(x))


def _mevp_scalars(solver: MEVPSolver, dt: float):
    """MevpScalars of csrc/mevp_body.cuh, field for field; the geometric
    ones are NaN on a non-uniform mesh, whose kernels read the metric
    planes instead."""
    p, mesh = solver.params, solver.mesh
    e2 = p.ellipse * p.ellipse
    f = p.f_coriolis if p.use_coriolis else 0.0
    if mesh.uniform:
        inv_dx, inv_dy = _f32_reciprocal(mesh.dx), _f32_reciprocal(mesh.dy)
        half_dx, half_dy = 0.5 * mesh.dx, 0.5 * mesh.dy
        inv_w = 1.0 / (mesh.dx * mesh.dy)
    else:
        inv_dx = inv_dy = half_dx = half_dy = inv_w = float("nan")
    values = [
        inv_dx, inv_dy,
        1.0 + 1.0 / e2, 1.0 - 1.0 / e2, 4.0 / e2,
        p.rho_ocean * p.cd_ocean, p.delta_min, 1.0 + p.beta, 1.0 / e2,
        1.0 / p.alpha, half_dx, half_dy, inv_w,
        p.beta, f, -f, dt, p.alpha_min, p.c_stab,
    ]
    assert len(values) == _N_MEVP_SCALARS
    return _floats(values)


def mevp_form(params) -> int:
    """The momentum form of ``MEVPParams`` as the kernels' template bits:
    ``FORM_WEIGHTED`` for ``a_weighted_stress``, ``FORM_ADAPTIVE`` for
    ``adaptive_alpha``."""
    return FORM_WEIGHTED * bool(params.a_weighted_stress) + FORM_ADAPTIVE * bool(params.adaptive_alpha)


def wrap_bits(mesh) -> int:
    """The mesh's periodic axes as the kernels' ``wrap`` bits: ``WRAP_X``
    for ``periodic_x``, ``WRAP_Y`` for ``periodic_y``; 0 when closed."""
    return WRAP_X * bool(mesh.periodic_x) + WRAP_Y * bool(mesh.periodic_y)


def kernel_form(solver) -> int:
    """An mEVP kernel's ``form`` argument: the momentum form's bits and,
    above them, the solver mesh's periodic axes; for ``MEVPSolverHO`` (no
    adaptive form) the form of ``ho_single`` and ``ho_tiled``, with
    ``HO_FORM_METRIC`` on a graded or spherical mesh."""
    form = mevp_form(solver.params) | wrap_bits(solver.mesh) << _FORM_WRAP_SHIFT
    if isinstance(solver, MEVPSolverHO) and not solver.mesh.uniform:
        form |= HO_FORM_METRIC
    return form


def _n_dg1_table(degree: int) -> int:
    """Floats of DgTables<degree> (csrc/dg1_body.cuh): the sampling weights
    of Q volume and E face points, the K x Q basis and two gradient tables,
    8 K x E face tables, K inverse masses and 4 widths."""
    b = dg_basis(degree)
    k, q, e = b.n_dofs, len(b.w_vol), len(b.s_edge)
    return 4 * q + 2 * e + 3 * k * q + 8 * k * e + k + 4


@lru_cache(maxsize=None)
def _table_type(degree: int):
    """The ctypes array of DgTables<degree>; its ``degree`` attribute is the
    template argument that the launches pass beside the tables."""
    return type(f"DgTables{degree}", (ctypes.c_float * _n_dg1_table(degree),), {"degree": degree})


def _qv_planes(degree: int) -> dict:
    """The planes of a QuadVelocity at ``degree``, in the order of
    DgQvPlanes in csrc/dg1_body.cuh: 12 at dG0 and dG1, 24 at dG2."""
    b = dg_basis(degree)
    q, e = len(b.w_vol), len(b.s_edge)
    return {"vx_vol": q, "vy_vol": q, "vn_x": e, "vn_y": e}


def _dg1_tables(transport: DGTransport):
    """DgTables of csrc/dg1_body.cuh at the transport's degree, field for
    field, from the port's basis (dG0 and dG1: 2x2 volume points and 2
    points a face; dG2: 3x3 and 3)."""
    b, mesh = transport.basis, transport.mesh
    w_vol, w_edge = sampling_weights(b)
    values = [x for w in w_vol for x in w] + [x for w in w_edge for x in w]
    for table in (
        transport._psi_vol, transport._wgx_vol.T, transport._wgy_vol.T,
        transport._psi_x0, transport._psi_x1, transport._psi_y0, transport._psi_y1,
        transport._wa_x0, transport._wa_x1, transport._wa_y0, transport._wa_y1,
    ):
        values += [float(x) for x in table.ravel()]
    values += [float(x) for x in transport._inv_mass]
    if mesh.uniform:
        values += [
            1.0 / mesh.dx, 1.0 / mesh.dy, _f32_reciprocal(mesh.dx), _f32_reciprocal(mesh.dy)
        ]
    else:  # the kernels read the transport's metric planes instead
        values += [float("nan")] * 4
    assert len(values) == _n_dg1_table(b.degree)
    return _table_type(b.degree)(*map(float, values))


#: Packed HoScalars and HoTables by the values that define them, so that a
#: launch packs nothing the step before it packed (a round's band solvers
#: are new objects on a periodic grid: ``mevp_rdma_cuda.phase_solvers``).
#: The arrays are never written after packing; a launch passes their
#: addresses, and the cache keeps them alive for it.
_HO_PACKED = {}


def _ho_scalars(solver: MEVPSolverHO, dt: float):
    """HoScalars of csrc/ho_body.cuh, field for field; the four widths are
    NaN on a graded or spherical mesh, whose kernels read the width planes
    instead. Packed once per (params, widths, dt)."""
    p, mesh = solver.params, solver.mesh
    key = ("scalars", p, (mesh.dx, mesh.dy) if mesh.uniform else None, float(dt))
    packed = _HO_PACKED.get(key)
    if packed is not None:
        return packed
    e2 = p.ellipse * p.ellipse
    f = p.f_coriolis if p.use_coriolis else 0.0
    if mesh.uniform:
        widths = [_f32_reciprocal(mesh.dx), _f32_reciprocal(mesh.dy), mesh.dx, mesh.dy]
    else:
        widths = [float("nan")] * 4
    values = [
        *widths,
        1.0 + 1.0 / e2, 1.0 - 1.0 / e2, 4.0 / e2, p.delta_min, 1.0 / e2, 1.0 / p.alpha,
        p.rho_ocean * p.cd_ocean, 1.0 + p.beta, p.beta, f, -f, dt,
    ]
    assert len(values) == _N_HO_SCALARS
    return _HO_PACKED.setdefault(key, _floats(values))


#: The packed HoTables of each live solver (the value cache's entry).
_HO_TABLES_OF = weakref.WeakKeyDictionary()


def _ho_tables(solver: MEVPSolverHO):
    """HoTables of csrc/ho_body.cuh, field for field, from the solver's CG2
    tables (the ~1e-17 quadrature residues included, as the plain version
    multiplies them). Packed once per set of table values, and looked up
    once per solver."""
    packed = _HO_TABLES_OF.get(solver)
    if packed is not None:
        return packed
    t = solver.tables
    tables = (t.grad_x_to_dg1, t.grad_y_to_dg1, t.phi_dg1, solver.proj, t.div_x, t.div_y)
    key = ("tables", b"".join(np.asarray(table, dtype=np.float64).tobytes() for table in tables))
    packed = _HO_PACKED.get(key)
    if packed is None:
        values = []
        for table in tables:
            values += [float(x) for x in np.asarray(table).ravel()]
        assert len(values) == _N_HO_TABLE
        packed = _HO_PACKED.setdefault(key, _floats(values))
    _HO_TABLES_OF[solver] = packed
    return packed


def ho_flatten(carry) -> torch.Tensor:
    """The HO carry (u, v, s11, s22, s12) as one new (17, nx, ny) tensor in
    the kernels' plane order: u's v, b, l, c; v's; s11, s22, s12."""
    u, v, s11, s22, s12 = carry
    return torch.cat([torch.stack(u.planes()), torch.stack(v.planes()), s11, s22, s12])


def ho_unflatten(state: torch.Tensor):
    """The inverse of ``ho_flatten``, as views of ``state``."""
    return (
        HOField(*state[0:4]), HOField(*state[4:8]), state[8:11], state[11:14], state[14:17],
    )


# -- checks --------------------------------------------------------------------
def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU (plain version), False for CUDA (kernel); raises else."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(
        f"tensors on {t.device} are not supported: the plain version runs on "
        "the CPU and the kernels on CUDA"
    )


def _check(shape, device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_mevp(solver: MEVPSolver, carry, consts) -> None:
    """The const set must be the solver's (the sorted names, as the JAX
    kernels key it): the 7 uniform planes, or the 12 with the metric planes
    on a graded or spherical mesh, and a_node besides in the A-weighted
    form."""
    expected = const_names(solver.params.a_weighted_stress, solver.mesh.uniform)
    if tuple(sorted(consts)) != tuple(sorted(expected)):
        raise NotImplementedError(
            f"the mEVP kernels take the consts {tuple(sorted(expected))} on this mesh, "
            f"got {tuple(sorted(consts))}"
        )
    names = ("u", "v", "s11", "s22", "s12")
    _check(
        (solver.mesh.nx, solver.mesh.ny), carry[0].device,
        **dict(zip(names, carry)), **consts,
    )


def _check_ho(solver: MEVPSolverHO, carry, consts) -> None:
    """The HO kernels take the solver's const set (``const_names``: the 29,
    the four a_{k} in the A-weighted form and the four widths on a graded
    or spherical mesh), float32 (nx, ny) planes, and the carry's 8 velocity
    and 3 x 3 stress planes."""
    expected = tuple(sorted(solver.const_names()))
    if tuple(sorted(consts)) != expected:
        raise NotImplementedError(
            f"the HO kernels take the consts {expected} for this solver, got {tuple(sorted(consts))}"
        )
    u, v, s11, s22, s12 = carry
    shape = (solver.mesh.nx, solver.mesh.ny)
    device = u.v.device
    planes = {f"u.{k}": x for k, x in zip("vblc", u.planes())}
    planes.update({f"v.{k}": x for k, x in zip("vblc", v.planes())})
    _check(shape, device, **planes, **consts)
    _check((3, *shape), device, s11=s11, s22=s22, s12=s12)


def _ho_consts(consts: dict):
    """The 37 const-plane pointers of HoConsts; the a_{k} and the widths
    null when the consts have none."""
    return _pointers([consts.get(name) for name in HO_KERNEL_CONSTS])


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@lru_cache(maxsize=8)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA card (cached: the query costs
    the host more than a launch)."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


def _pointers(tensors):
    """A C array of the tensors' device pointers (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors)
    )


def _mevp_consts(consts: dict):
    """The 13 const-plane pointers of MevpConsts; the metric ones and
    a_node null when the consts have none."""
    return _pointers([consts.get(name) for name in MEVP_CONSTS])


def _dg1_metric(transport: DGTransport, device, metric=None):
    """Dg1MetricPlanes of the transport's float32 metric planes on
    ``device`` (or of ``metric``, planes given in their place), or None (a
    null pointer) on a uniform mesh."""
    if metric is None:
        metric = transport.metric_planes(device=device, dtype=torch.float32)
    return None if metric is None else _pointers([metric[name] for name in _DG1_METRIC])


def _dg1_qv(qv: QuadVelocity, shape, device, degree: int):
    """DgQvPlanes of a ``QuadVelocity`` at ``degree``: the 12 (dG2: 24)
    plane pointers."""
    stacks = {"vx_vol": qv.vx_vol, "vy_vol": qv.vy_vol, "vn_x": qv.vn_x, "vn_y": qv.vn_y}
    counts = _qv_planes(degree)
    for name, count in counts.items():
        _check((count, *shape), device, **{name: stacks[name]})
    return _pointers([plane for name in counts for plane in stacks[name]])


# -- in-place launches (arguments already checked) ----------------------------
def _mevp_half_(name, planes, const_ptrs, c_w, inv_drag, scalars, stream, beta=None, wrap=0):
    """``mevp_stress`` or ``mevp_velocity`` in place on the five planes;
    ``const_ptrs`` from ``_mevp_consts``. The momentum form follows from
    the planes: weighted where a_node is among the consts, adaptive where
    the node plane ``beta`` is given; ``wrap``: the periodic axes
    (``wrap_bits``), the kernels' periodic instances."""
    u = planes[0]
    nx, ny = u.shape
    form = FORM_WEIGHTED * (const_ptrs[MEVP_CONSTS.index("a_node")] is not None)
    form += FORM_ADAPTIVE * (beta is not None)
    form |= wrap << _FORM_WRAP_SHIFT
    _launch(
        name, *(t.data_ptr() for t in planes), c_w.data_ptr(), inv_drag.data_ptr(),
        None if beta is None else beta.data_ptr(), const_ptrs, nx, ny, form,
        ctypes.addressof(scalars), u.device.index, stream,
    )


#: The tracer count that dg1_rk_stage's tiles are laid out for (one warp a
#: tracer and row; csrc/transport.cu kStageTracers); its no-limit instance
#: (``transport_run``) takes one.
STAGE_TRACERS = 3

#: Block pairs that a dg1_sample_cfl scratch holds: more blocks than the
#: card keeps resident, which is what a launch takes at most.
CFL_SCRATCH_BLOCKS = 4096
_cfl_scratch = {}


def _cfl_scratch_of(device, stream: int) -> torch.Tensor:
    """The scratch of ``dg1_sample_cfl``'s launches on one stream: the count
    of blocks done (zero between launches; each launch leaves it so) and a
    pair of maxima per block. One a stream, made once, so that launches on
    two streams (the ranks of a rank grid) never share one."""
    key = (device.index, stream)
    with _lock:
        scratch = _cfl_scratch.get(key)
        if scratch is None:
            scratch = torch.zeros(1 + 2 * CFL_SCRATCH_BLOCKS, device=device, dtype=torch.int32)
            _cfl_scratch[key] = scratch
    return scratch


def _dg1_sample_cfl_(u, v, speeds, tables, stream, halo: int = 0, wrap: int = 0):
    """The max speeds of the elements of (u, v) into ``speeds`` (nothing to
    zero before), or with ``halo`` of the elements of the block that (u, v)
    widen by ``halo`` on every side. 16-byte loads where both planes and
    their rows are 16-byte aligned and the last node column's 16 bytes lie
    inside the row. ``wrap``: the periodic axes (node nx is node 0), on the
    whole domain only."""
    nx, ny = u.shape
    ex, ey = nx - 2 * halo, ny - 2 * halo
    offset = (halo * ny + halo) * u.element_size()
    extent = (ex + 1, ey + 1) if halo else (nx, ny)
    pu, pv = u.data_ptr() + offset, v.data_ptr() + offset
    vector = (pu | pv) % 16 == 0 and ny % 4 == 0 and halo + -(-extent[1] // 4) * 4 <= ny
    scratch = _cfl_scratch_of(u.device, stream)
    _launch(
        "dg1_sample_cfl", pu, pv, speeds.data_ptr(), scratch.data_ptr(), CFL_SCRATCH_BLOCKS,
        ex, ey, *extent, ny, int(vector), wrap, tables.degree, ctypes.addressof(tables),
        u.device.index, stream,
    )


def _dg1_rk_stage_(
    psi, base, u, v, face_x, face_y, metric, out, a, b, dt_sub, tables, stream, qv=None,
    limit: bool = True, tvb: bool = False, wrap: int = 0,
):
    """One dg1_rk_stage launch (arguments already checked) into ``out`` at
    the degree of ``tables``: ``metric`` from ``_dg1_metric``; ``qv``, the
    plane pointers of ``_dg1_qv``, in place of (u, v), which are then not
    read. With ``limit`` the 3 tracers of the coupled step and the face
    masks, positivity-limited, or with ``tvb`` (dG1, dG2) not limited (the
    TVB form's stage, which ``_dg1_limit_`` limits); without ``limit`` one
    tracer in the ``qv`` form and no face masks (``transport_run``: face_x
    and face_y are None). ``wrap``: the periodic axes (``wrap_bits``)."""
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("dg1_rk_stage reads its neighbours' psi: out must not alias psi")
    _, n_tracers, nx, ny = psi.shape
    if limit and n_tracers != STAGE_TRACERS:
        raise ValueError(
            f"dg1_rk_stage runs {STAGE_TRACERS} tracers (hice, cice, hsnow), got {n_tracers}"
        )
    if not limit and (n_tracers != 1 or qv is None or face_x is not None or face_y is not None):
        raise ValueError(
            "dg1_rk_stage's no-limit instance runs one tracer in the qv form without face "
            f"masks, got {n_tracers} tracers{'' if qv is not None else ', no qv'}"
            f"{'' if face_x is None and face_y is None else ', face masks'}"
        )
    if tvb and (not limit or tables.degree == 0):
        raise ValueError("dg1_rk_stage's TVB form runs the coupled step's 3 tracers at dG1 and dG2")
    uv = (u.data_ptr(), v.data_ptr()) if qv is None else (None, None)
    faces = (face_x.data_ptr(), face_y.data_ptr()) if limit else (None, None)
    mode = (_STAGE_UNLIMITED if tvb else _STAGE_LIMITED) if limit else _STAGE_RUN
    _launch(
        "dg1_rk_stage",
        psi.data_ptr(), base.data_ptr(), *uv, *faces, metric, qv,
        out.data_ptr(), nx, ny, n_tracers, tables.degree, mode, wrap, a, b, dt_sub,
        ctypes.addressof(tables), psi.device.index, stream,
    )


def _dg1_limit_(psi, tolerances, tables, stream, wrap: int = 0):
    """One dg1_limit launch in place on ``psi`` (K, T, nx, ny), checked:
    TVB, then positivity, at the degree of ``tables`` (1 or 2);
    ``tolerances``: the transport's float32 ``tvb_tolerances`` (two floats,
    or on a graded or spherical mesh two planes on the card)."""
    _, n_tracers, nx, ny = psi.shape
    tol_x, tol_y = tolerances
    if isinstance(tol_x, torch.Tensor):
        planes, scalars = (tol_x.data_ptr(), tol_y.data_ptr()), (0.0, 0.0)
    else:
        planes, scalars = (None, None), (tol_x, tol_y)
    _launch(
        "dg1_limit", psi.data_ptr(), *planes, *scalars, nx, ny, n_tracers, tables.degree, wrap,
        ctypes.addressof(tables), psi.device.index, stream,
    )


def dg1_limit_reference(transport: DGTransport, psi):
    """``transport.limit(psi)``: the TVB slope limiter, then positivity."""
    return transport.limit(psi)


def dg1_limit(transport: DGTransport, psi):
    """The limiter of a TVB stage on (K, T, nx, ny) coefficients at dG1 or
    dG2: ``limit_slopes`` (with the transport's ``tvb_m``), then
    ``limit_positivity``. CPU tensors run the plain version; CUDA tensors
    one ``dg1_limit`` launch on a copy."""
    if _on_cpu(psi):
        return dg1_limit_reference(transport, psi)
    if not transport.limits_slopes:
        raise ValueError("dg1_limit runs the TVB limiter: the transport needs tvb_m at dG1 or dG2")
    mesh = transport.mesh
    _check((transport.basis.n_dofs, psi.shape[1], mesh.nx, mesh.ny), psi.device, psi=psi)
    out = psi.clone()
    tolerances = transport.tvb_tolerances(device=psi.device, dtype=torch.float32)
    if isinstance(tolerances[0], torch.Tensor):
        _check((mesh.nx, mesh.ny), psi.device, tol_x=tolerances[0], tol_y=tolerances[1])
    _dg1_limit_(out, tolerances, _dg1_tables(transport), _stream(psi.device), wrap_bits(mesh))
    return out


def _walls(walls):
    """The halo forms' four wall indices as a C int[4]."""
    if len(walls) != 4:
        raise ValueError(f"the halo forms take four wall indices, got {walls!r}")
    return (ctypes.c_int * 4)(*map(int, walls))


def _dg1_rk_stage_halo_(
    psi_w, base, u_w, v_w, face_x_w, face_y_w, metric, out, a, b, dt_sub, tables, stream, walls,
    qv=None, tvb: bool = False,
):
    """One launch of dg1_rk_stage's halo form (arguments already checked)
    into ``out``, the block's own (K, 3, nx, ny): ``psi_w``, the velocity
    (u_w, v_w, or the ``qv`` plane pointers of ``_dg1_qv``), the face masks
    and ``metric`` (``_dg1_metric`` of the widened planes) are the block
    widened by one ring; ``walls``: ``_walls`` of the global walls' indices
    in the widened block. Positivity-limited, or with ``tvb`` unlimited
    (``_dg1_limit_halo_`` follows). Counted as a ``dg1_rk_stage`` launch."""
    if out.data_ptr() == psi_w.data_ptr():
        raise ValueError("dg1_rk_stage reads its neighbours' psi: out must not alias psi")
    _, n_tracers, nx, ny = psi_w.shape
    if tvb and tables.degree == 0:
        raise ValueError("dg1_rk_stage's TVB form runs the coupled step's 3 tracers at dG1 and dG2")
    uv = (u_w.data_ptr(), v_w.data_ptr()) if qv is None else (None, None)
    _launch(
        "dg1_rk_stage",
        psi_w.data_ptr(), base.data_ptr(), *uv, face_x_w.data_ptr(), face_y_w.data_ptr(), metric, qv,
        out.data_ptr(), nx, ny, n_tracers, tables.degree, _STAGE_UNLIMITED if tvb else _STAGE_LIMITED,
        walls, a, b, dt_sub, ctypes.addressof(tables), psi_w.device.index, stream,
        entry="dg1_rk_stage_halo",
    )


def _dg1_limit_halo_(psi, means_w, tolerances, tables, stream, walls):
    """One launch of dg1_limit's halo form in place on the block's own
    ``psi`` (K, T, nx, ny), checked: the neighbours' means from ``means_w``
    (T, nx + 2, ny + 2), the stage's means widened by one ring; ``walls``:
    ``_walls`` of the global walls' indices in the widened block;
    ``tolerances`` as ``_dg1_limit_``'s (the block's own planes). Counted as
    a ``dg1_limit`` launch."""
    _, n_tracers, nx, ny = psi.shape
    tol_x, tol_y = tolerances
    if isinstance(tol_x, torch.Tensor):
        planes, scalars = (tol_x.data_ptr(), tol_y.data_ptr()), (0.0, 0.0)
    else:
        planes, scalars = (None, None), (tol_x, tol_y)
    _launch(
        "dg1_limit", psi.data_ptr(), means_w.data_ptr(), *planes, *scalars, nx, ny, n_tracers,
        tables.degree, walls, ctypes.addressof(tables), psi.device.index, stream,
        entry="dg1_limit_halo",
    )


def dg1_rk_stage_halo_reference(
    transport: DGTransport, psi_w, base, u_w, v_w, face_x_w, face_y_w, walls,
    a: float, b: float, dt_sub: float, qv: QuadVelocity = None, metric: dict = None,
    tvb: bool = False,
):
    """lim(a base + b (psi + dt_sub rhs(psi))) on a rank block's own
    elements, or lim(psi + dt_sub rhs(psi)) when a == 0, from the block
    widened by one ring: ``transport`` the widened block's
    (``CoupledModel.widened_transport(1)``), ``psi_w`` (K, T, nx + 2,
    ny + 2), the CG1 nodes (u_w, v_w) or the samples ``qv``, the face masks
    and ``metric`` (the widened planes; None on a uniform mesh) widened
    likewise; ``base`` the block's own. ``walls``: (fwd_x, bwd_x, fwd_y,
    bwd_y), the widened block's row (column) of the global last and first
    wall's elements, -1 for none (``transport_tiled_cuda.spmd_walls(model,
    1)``): the first's left (bottom) faces and the last's right (top) faces
    carry no flux, here by zeroing the face masks there. lim is the
    positivity limiter, or with ``tvb`` the identity."""
    if qv is None:
        qv = velocity_from_cg(transport.mesh, transport.basis, u_w, v_w)
    fwd_x, bwd_x, fwd_y, bwd_y = walls
    face_x, face_y = face_x_w.clone(), face_y_w.clone()
    for plane, axis, first, last in ((face_x, 0, bwd_x, fwd_x), (face_y, 1, bwd_y, fwd_y)):
        for face in (first, last + 1 if last >= 0 else -1):
            if 0 <= face < plane.shape[axis]:
                plane.narrow(axis, face, 1).zero_()
    own = (Ellipsis, slice(1, -1), slice(1, -1))
    value = psi_w[own] + dt_sub * transport.rhs(psi_w, qv, (face_x, face_y), metric)[own]
    if a != 0.0:
        value = a * base + b * value
    return value if tvb else transport.limit_positivity(value)


def dg1_rk_stage_halo(
    transport: DGTransport, psi_w, base, u_w, v_w, face_x_w, face_y_w, walls,
    a: float, b: float, dt_sub: float, qv: QuadVelocity = None, metric: dict = None,
    tvb: bool = False,
):
    """One SSP-RK stage of a rank block's 3 tracers from the block widened
    by one ring (see the reference): the block's own (K, 3, nx, ny). CPU
    tensors run the plain version; CUDA tensors one launch of
    dg1_rk_stage's halo form, positivity-limited or with ``tvb`` (dG1, dG2)
    unlimited for ``dg1_limit_halo``."""
    if _on_cpu(psi_w):
        return dg1_rk_stage_halo_reference(
            transport, psi_w, base, u_w, v_w, face_x_w, face_y_w, walls, a, b, dt_sub, qv=qv,
            metric=metric, tvb=tvb,
        )
    shape_w = (transport.mesh.nx, transport.mesh.ny)
    n_dofs, degree = transport.basis.n_dofs, transport.basis.degree
    _check(shape_w, psi_w.device, face_x=face_x_w, face_y=face_y_w)
    _check((n_dofs, STAGE_TRACERS, *shape_w), psi_w.device, psi=psi_w)
    _check((n_dofs, STAGE_TRACERS, shape_w[0] - 2, shape_w[1] - 2), psi_w.device, base=base)
    if qv is None:
        _check(shape_w, psi_w.device, u=u_w, v=v_w)
        qv_ptrs = None
    else:
        qv_ptrs = _dg1_qv(qv, shape_w, psi_w.device, degree)
    if metric is not None:
        _check(shape_w, psi_w.device, **{f"metric {name}": metric[name] for name in _DG1_METRIC})
    out = torch.empty_like(base)
    _dg1_rk_stage_halo_(
        psi_w, base, u_w, v_w, face_x_w, face_y_w, _dg1_metric(transport, psi_w.device, metric), out,
        a, b, dt_sub, _dg1_tables(transport), _stream(psi_w.device), _walls(walls), qv=qv_ptrs, tvb=tvb,
    )
    return out


def dg1_limit_halo_reference(transport: DGTransport, psi, means_w, walls):
    """``limit_positivity(limit_slopes(psi))`` of a rank block's own
    coefficients ``psi`` (``transport`` the block's), the neighbours' means
    taken from ``means_w`` (T, nx + 2, ny + 2), the block's means widened
    by one ring: each mean difference zeroed at the global walls ``walls``
    (as ``dg1_rk_stage_halo_reference``'s: the last wall's forward, the
    first's backward difference), as the single domain zeroes it at its
    edges."""
    mean = psi[0]
    deltas = (
        means_w[..., 2:, 1:-1] - mean, mean - means_w[..., :-2, 1:-1],
        means_w[..., 1:-1, 2:] - mean, mean - means_w[..., 1:-1, :-2],
    )
    for delta, axis, wall in zip(deltas, (-2, -2, -1, -1), walls):
        if wall >= 0:
            delta.narrow(axis, wall - 1, 1).zero_()
    return transport.limit_positivity(transport.limit_slopes_by(psi, deltas))


def dg1_limit_halo(transport: DGTransport, psi, means_w, walls):
    """The TVB limiter of a rank block's stage (``transport`` the block's),
    from its means widened by one ring (see the reference). CPU tensors run
    the plain version; CUDA tensors one launch of dg1_limit's halo form on
    a copy."""
    if _on_cpu(psi):
        return dg1_limit_halo_reference(transport, psi, means_w, walls)
    if not transport.limits_slopes:
        raise ValueError("dg1_limit runs the TVB limiter: the transport needs tvb_m at dG1 or dG2")
    mesh = transport.mesh
    _check((transport.basis.n_dofs, psi.shape[1], mesh.nx, mesh.ny), psi.device, psi=psi)
    _check((psi.shape[1], mesh.nx + 2, mesh.ny + 2), psi.device, means_w=means_w)
    out = psi.clone()
    tolerances = transport.tvb_tolerances(device=psi.device, dtype=torch.float32)
    if isinstance(tolerances[0], torch.Tensor):
        _check((mesh.nx, mesh.ny), psi.device, tol_x=tolerances[0], tol_y=tolerances[1])
    _dg1_limit_halo_(out, means_w, tolerances, _dg1_tables(transport), _stream(psi.device), _walls(walls))
    return out


# -- the four kernels, one launch each -----------------------------------------
def mevp_stress(solver: MEVPSolver, carry, consts):
    """First half of an mEVP subcycle: (s11, s22, s12, c_w, inv_drag), and
    with ``adaptive_alpha`` the per-node beta last.

    Plain version: ``solver.stress_update(carry, consts)``.
    """
    if _on_cpu(carry[0]):
        return solver.stress_update(carry, consts)
    _check_mevp(solver, carry, consts)
    u, v, s11, s22, s12 = carry
    planes = (u, v, s11.clone(), s22.clone(), s12.clone())
    c_w, inv_drag = torch.empty_like(u), torch.empty_like(u)
    beta = torch.empty_like(u) if solver.params.adaptive_alpha else None
    _mevp_half_(
        "mevp_stress", planes, _mevp_consts(consts), c_w, inv_drag,
        _mevp_scalars(solver, 0.0), _stream(u.device), beta=beta, wrap=wrap_bits(solver.mesh),
    )
    return (planes[2], planes[3], planes[4], c_w, inv_drag) + (() if beta is None else (beta,))


def mevp_velocity(solver: MEVPSolver, carry, consts, c_w, inv_drag, dt: float, beta=None):
    """Second half of an mEVP subcycle: the new (u, v); ``beta``: the
    per-node plane of ``mevp_stress`` with ``adaptive_alpha``.

    Plain version: ``solver.velocity_update(carry, consts, c_w, inv_drag, dt, beta)``.
    """
    if _on_cpu(carry[0]):
        return solver.velocity_update(carry, consts, c_w, inv_drag, dt, beta)
    _check_mevp(solver, carry, consts)
    if (beta is not None) != solver.params.adaptive_alpha:
        raise ValueError("mevp_velocity takes beta exactly in the adaptive form")
    u = carry[0]
    _check(u.shape, u.device, c_w=c_w, inv_drag=inv_drag)
    if beta is not None:
        _check(u.shape, u.device, beta=beta)
    planes = (u.clone(), carry[1].clone(), *carry[2:])
    _mevp_half_(
        "mevp_velocity", planes, _mevp_consts(consts), c_w, inv_drag,
        _mevp_scalars(solver, dt), _stream(u.device), beta=beta, wrap=wrap_bits(solver.mesh),
    )
    return planes[0], planes[1]


# -- the halo forms of the mEVP halves: a rank block and its strips ------------
_EXTENDED = weakref.WeakKeyDictionary()


def _extended(solver):
    """``solver``'s twin on a closed block one cell wider along both axes
    (a uniform ``RectMesh`` of its widths, or a ``MetricShim``): the plain
    halves' block with the strips in place. Made once per solver."""
    twin = _EXTENDED.get(solver)
    if twin is None:
        mesh = solver.mesh
        twin = _EXTENDED.setdefault(solver, type(solver)(block_mesh(mesh.nx + 1, mesh.ny + 1, mesh), solver.params))
    return twin


def _with_plus(f, strip_x, strip_y):
    """(C, nx, ny) planes with the +1 strips as row nx and column ny."""
    return torch.cat([torch.cat([f, strip_x[:, None, :]], dim=1), strip_y[:, :, None]], dim=2)


def _with_minus(f, strip_x, strip_y):
    """(C, nx, ny) planes with the -1 strips as row and column 0."""
    return torch.cat([strip_y[:, :, None], torch.cat([strip_x[:, None, :], f], dim=1)], dim=2)


def _padded(f, side: int):
    """(..., nx, ny) planes with a zero row and column after (side > 0) or
    before (side < 0) the block."""
    return torch.nn.functional.pad(f, (0, 1, 0, 1) if side > 0 else (1, 0, 1, 0))


def mevp_stress_halo_reference(solver: MEVPSolver, carry, consts, strip_x, strip_y):
    """The stress half of a rank block's subcycle (``solver`` the rank's):
    ``solver.stress_update`` on the block extended by the +1 strips of u
    and v (``stencil.plus_strips``: ``strip_x`` (2, ny), ``strip_y`` (2,
    nx + 1)), the consts and stresses padded, cut back to the block. The
    same values as the per-shift exchange's: (s11, s22, s12, c_w, inv_drag)
    and with ``adaptive_alpha`` beta."""
    u, v, s11, s22, s12 = carry
    nx, ny = u.shape
    uv = _with_plus(torch.stack([u, v]), strip_x, strip_y)
    stresses = _padded(torch.stack([s11, s22, s12]), 1)
    consts_w = dict(zip(consts, _padded(torch.stack(list(consts.values())), 1)))
    out = _extended(solver).stress_update((uv[0], uv[1], *stresses), consts_w)
    return tuple(f[:nx, :ny].contiguous() for f in out)


def mevp_velocity_halo_reference(
    solver: MEVPSolver, carry, consts, c_w, inv_drag, dt: float, strip_x, strip_y,
    metric_x=None, metric_y=None, beta=None,
):
    """The velocity half of a rank block's subcycle: ``solver.velocity_update``
    on the block extended by the -1 strips of s11, s22 and s12
    (``stencil.minus_strips``: ``strip_x`` (3, ny), ``strip_y`` (3,
    nx + 1)), and on a graded or spherical mesh by those of half_dx and
    half_dy (``metric_x`` (2, ny), ``metric_y`` (2, nx + 1)), the node planes
    padded, cut back to the block. Returns (u, v)."""
    u, v, s11, s22, s12 = carry
    nx, ny = u.shape
    stresses = _with_minus(torch.stack([s11, s22, s12]), strip_x, strip_y)
    consts_w = dict(zip(consts, _padded(torch.stack(list(consts.values())), -1)))
    if metric_x is not None:
        half = _with_minus(torch.stack([consts["half_dx"], consts["half_dy"]]), metric_x, metric_y)
        consts_w.update(half_dx=half[0], half_dy=half[1])
    nodes = _padded(torch.stack([u, v, c_w, inv_drag] + ([] if beta is None else [beta])), -1)
    u_w, v_w = _extended(solver).velocity_update(
        (nodes[0], nodes[1], *stresses), consts_w, nodes[2], nodes[3], dt, *nodes[4:],
    )
    return u_w[1:, 1:].contiguous(), v_w[1:, 1:].contiguous()


def _mevp_halo_(name, state, const_ptrs, c_w, inv_drag, beta, strips, metric, form, scalars, stream):
    """One launch of ``mevp_stress``'s or ``mevp_velocity``'s halo form in
    place on the rank's (5, nx, ny) ``state`` (arguments already checked):
    ``strips`` the half's (x, y) strips, ``metric`` the velocity half's
    half_dx and half_dy strips on a metric mesh (else None); ``form`` the
    momentum form (``mevp_form``). Counted as a launch of ``name``."""
    _, nx, ny = state.shape
    metric_ptrs = () if name == "mevp_stress" else (None, None) if metric is None else (
        metric[0].data_ptr(), metric[1].data_ptr())
    _launch(
        name, *(plane.data_ptr() for plane in state), c_w.data_ptr(), inv_drag.data_ptr(),
        None if beta is None else beta.data_ptr(), const_ptrs, strips[0].data_ptr(), strips[1].data_ptr(),
        *metric_ptrs, nx, ny, form, ctypes.addressof(scalars), state.device.index, stream,
        entry=name + "_halo",
    )


def _check_strips(shape, device, n_planes: int, **strips) -> None:
    """Strips of ``n_planes`` planes: an x strip (C, ny), a y strip (C, nx + 1)."""
    nx, ny = shape
    for name, t in strips.items():
        _check((n_planes, ny if name.endswith("x") else nx + 1), device, **{name: t})


def mevp_stress_halo(solver: MEVPSolver, carry, consts, strip_x, strip_y):
    """The stress half of a rank block's subcycle from the block and the
    +1 strips of u and v (see the reference): (s11, s22, s12, c_w,
    inv_drag), and with ``adaptive_alpha`` beta. CPU tensors run the plain
    version; CUDA tensors one launch of ``mevp_stress``'s halo form."""
    if _on_cpu(carry[0]):
        return mevp_stress_halo_reference(solver, carry, consts, strip_x, strip_y)
    _check_mevp(solver, carry, consts)
    u = carry[0]
    _check_strips(u.shape, u.device, 2, strip_x=strip_x, strip_y=strip_y)
    state = torch.stack(list(carry))
    c_w, inv_drag = torch.empty_like(u), torch.empty_like(u)
    beta = torch.empty_like(u) if solver.params.adaptive_alpha else None
    _mevp_halo_(
        "mevp_stress", state, _mevp_consts(consts), c_w, inv_drag, beta, (strip_x, strip_y), None,
        mevp_form(solver.params), _mevp_scalars(solver, 0.0), _stream(u.device),
    )
    return (state[2], state[3], state[4], c_w, inv_drag) + (() if beta is None else (beta,))


def mevp_velocity_halo(
    solver: MEVPSolver, carry, consts, c_w, inv_drag, dt: float, strip_x, strip_y,
    metric_x=None, metric_y=None, beta=None,
):
    """The velocity half of a rank block's subcycle from the block and the
    -1 strips of the stresses (and of half_dx and half_dy on a graded or
    spherical mesh; see the reference): the new (u, v). CPU tensors run the
    plain version; CUDA tensors one launch of ``mevp_velocity``'s halo
    form."""
    if _on_cpu(carry[0]):
        return mevp_velocity_halo_reference(
            solver, carry, consts, c_w, inv_drag, dt, strip_x, strip_y, metric_x, metric_y, beta,
        )
    _check_mevp(solver, carry, consts)
    if (beta is not None) != solver.params.adaptive_alpha:
        raise ValueError("mevp_velocity takes beta exactly in the adaptive form")
    if (metric_x is not None) != (not solver.mesh.uniform):
        raise ValueError("the velocity half takes the half_dx, half_dy strips exactly on a metric mesh")
    u = carry[0]
    _check(u.shape, u.device, c_w=c_w, inv_drag=inv_drag, **({} if beta is None else {"beta": beta}))
    _check_strips(u.shape, u.device, 3, strip_x=strip_x, strip_y=strip_y)
    metric = None
    if metric_x is not None:
        _check_strips(u.shape, u.device, 2, metric_x=metric_x, metric_y=metric_y)
        metric = (metric_x, metric_y)
    state = torch.stack(list(carry))
    _mevp_halo_(
        "mevp_velocity", state, _mevp_consts(consts), c_w, inv_drag, beta, (strip_x, strip_y), metric,
        mevp_form(solver.params), _mevp_scalars(solver, dt), _stream(u.device),
    )
    return state[0], state[1]


def spmd_xla_subcycles(solver: MEVPSolver, carry, consts, dt: float, n_subcycles: int):
    """(u, v, s11, s22, s12) after N subcycles of a rank's block on the
    width-1 ("xla") schedule (``solver`` the rank's, on its exchange axes):
    each subcycle exchanges the +1 strips of u and v (``stencil.
    plus_strips``), runs the stress half, exchanges the -1 strips of the
    stresses (``minus_strips``) and runs the velocity half; on a graded or
    spherical mesh the -1 strips of half_dx and half_dy are exchanged once.
    A closed global wall's strips are zeros, a ring's arrive round the
    ranks. CUDA tensors launch the halo forms of ``mevp_stress`` and
    ``mevp_velocity`` in place on one (5, nx, ny) copy of the carry (and
    nothing of the plain versions); CPU tensors run their plain versions,
    the same route."""
    from ..stencil import minus_strips, plus_strips

    mesh = solver.mesh
    periodic, axes = (mesh.periodic_x, mesh.periodic_y), solver.spmd
    metric = (None, None)
    if not mesh.uniform:
        metric = minus_strips(torch.stack([consts["half_dx"], consts["half_dy"]]), periodic, axes)
    state = torch.stack(list(carry))
    if _on_cpu(state):
        nodes = []

        def stress(state, strips):
            out = mevp_stress_halo_reference(solver, tuple(state), consts, *strips)
            nodes[:] = out[3:]  # c_w, inv_drag (and beta) for the velocity half
            return torch.stack([state[0], state[1], *out[:3]])

        def velocity(state, strips):
            u, v = mevp_velocity_halo_reference(
                solver, tuple(state), consts, nodes[0], nodes[1], dt, *strips, *metric, *nodes[2:],
            )
            return torch.stack([u, v, *state[2:]])
    else:
        _check_mevp(solver, tuple(state), consts)
        u = state[0]
        c_w, inv_drag = torch.empty_like(u), torch.empty_like(u)
        beta = torch.empty_like(u) if solver.params.adaptive_alpha else None
        const_ptrs, scalars = _mevp_consts(consts), _mevp_scalars(solver, dt)
        form, stream = mevp_form(solver.params), _stream(u.device)

        def stress(state, strips):
            _mevp_halo_("mevp_stress", state, const_ptrs, c_w, inv_drag, beta, strips, None, form, scalars, stream)
            return state

        def velocity(state, strips):
            _mevp_halo_(
                "mevp_velocity", state, const_ptrs, c_w, inv_drag, beta, strips,
                None if metric[0] is None else metric, form, scalars, stream,
            )
            return state

    for _ in range(n_subcycles):
        state = stress(state, plus_strips(state[0:2], periodic, axes))
        state = velocity(state, minus_strips(state[2:5], periodic, axes))
    return tuple(state)


def _ho_halo_form(solver: MEVPSolverHO) -> int:
    """The HO halo kernels' form: the A-weighted and metric bits of
    ``kernel_form``, no periodic axes (their wrap arrives in the strips)."""
    return kernel_form(solver) & (FORM_WEIGHTED | HO_FORM_METRIC)


def ho_stress_halo_reference(solver: MEVPSolverHO, state, consts, strip_x, strip_y):
    """The stress half of a rank block's HO subcycle (``solver`` the
    rank's) on its 17 planes ``state`` (``ho_flatten``'s order):
    ``solver.stress_update`` on the block extended by the +1 strips of the 8
    velocity planes (``strip_x`` (8, ny), ``strip_y`` (8, nx + 1)), the
    stresses and consts padded, cut back to the block. Returns the new
    (17, nx, ny) planes, the stresses updated."""
    _, nx, ny = state.shape
    wide = torch.cat([_with_plus(state[:8], strip_x, strip_y), _padded(state[8:], 1)])
    consts_w = dict(zip(consts, _padded(torch.stack(list(consts.values())), 1)))
    stresses = _extended(solver).stress_update(ho_unflatten(wide), consts_w)
    return torch.cat([state[:8], *(s[:, :nx, :ny] for s in stresses)])


def ho_velocity_halo_reference(
    solver: MEVPSolverHO, state, consts, dt: float, strip_x, strip_y, width_x=None, width_y=None,
):
    """The velocity half of a rank block's HO subcycle on its 17 planes:
    ``solver.velocity_update`` on the block extended by the -1 strips of
    the 9 stress planes (``strip_x`` (9, ny), ``strip_y`` (9, nx + 1)), and
    on a graded or spherical mesh by those of dx and dy (``width_x`` (2,
    ny), ``width_y`` (2, nx + 1)), the velocities and consts padded, cut
    back to the block. Returns the new (17, nx, ny) planes, the velocities
    updated."""
    wide = torch.cat([_padded(state[:8], -1), _with_minus(state[8:], strip_x, strip_y)])
    consts_w = dict(zip(consts, _padded(torch.stack(list(consts.values())), -1)))
    if width_x is not None:
        widths = _with_minus(torch.stack([consts["dx"], consts["dy"]]), width_x, width_y)
        consts_w.update(dx=widths[0], dy=widths[1])
    u, v = _extended(solver).velocity_update(ho_unflatten(wide), consts_w, dt)
    return torch.cat([torch.stack([p[1:, 1:] for p in (*u.planes(), *v.planes())]), state[8:]])


def _ho_halo_(name, state, const_ptrs, strips, widths, form, scalars, tables, stream):
    """One launch of ``ho_stress`` or ``ho_velocity`` in place on the
    rank's (17, nx, ny) ``state`` (arguments already checked): ``strips``
    the half's (x, y) strips, ``widths`` the velocity half's dx and dy
    strips in the metric form (else None)."""
    _, nx, ny = state.shape
    width_ptrs = () if name == "ho_stress" else (None, None) if widths is None else (
        widths[0].data_ptr(), widths[1].data_ptr())
    _launch(
        name, state.data_ptr(), const_ptrs, strips[0].data_ptr(), strips[1].data_ptr(), *width_ptrs,
        nx, ny, form, ctypes.addressof(scalars), ctypes.addressof(tables), state.device.index, stream,
    )


def _check_ho_state(solver: MEVPSolverHO, state, consts) -> None:
    _check_ho(solver, ho_unflatten(state), consts)
    _check((17, solver.mesh.nx, solver.mesh.ny), state.device, state=state)


def ho_stress_halo(solver: MEVPSolverHO, state, consts, strip_x, strip_y):
    """The stress half of a rank block's HO subcycle from its 17 planes and
    the +1 strips of the velocities (see the reference): the new (17, nx,
    ny) planes. CPU tensors run the plain version; CUDA tensors one
    ``ho_stress`` launch on a copy."""
    if _on_cpu(state):
        return ho_stress_halo_reference(solver, state, consts, strip_x, strip_y)
    _check_ho_state(solver, state, consts)
    _check_strips(state.shape[1:], state.device, 8, strip_x=strip_x, strip_y=strip_y)
    out = state.clone()
    _ho_halo_(
        "ho_stress", out, _ho_consts(consts), (strip_x, strip_y), None, _ho_halo_form(solver),
        _ho_scalars(solver, 0.0), _ho_tables(solver), _stream(state.device),
    )
    return out


def ho_velocity_halo(
    solver: MEVPSolverHO, state, consts, dt: float, strip_x, strip_y, width_x=None, width_y=None,
):
    """The velocity half of a rank block's HO subcycle from its 17 planes
    and the -1 strips of the stresses (and of dx and dy on a graded or
    spherical mesh; see the reference): the new (17, nx, ny) planes. CPU
    tensors run the plain version; CUDA tensors one ``ho_velocity`` launch
    on a copy."""
    if _on_cpu(state):
        return ho_velocity_halo_reference(solver, state, consts, dt, strip_x, strip_y, width_x, width_y)
    _check_ho_state(solver, state, consts)
    if (width_x is not None) != (not solver.mesh.uniform):
        raise ValueError("the HO velocity half takes the dx, dy strips exactly on a metric mesh")
    _check_strips(state.shape[1:], state.device, 9, strip_x=strip_x, strip_y=strip_y)
    if width_x is not None:
        _check_strips(state.shape[1:], state.device, 2, width_x=width_x, width_y=width_y)
    out = state.clone()
    _ho_halo_(
        "ho_velocity", out, _ho_consts(consts), (strip_x, strip_y),
        None if width_x is None else (width_x, width_y), _ho_halo_form(solver),
        _ho_scalars(solver, dt), _ho_tables(solver), _stream(state.device),
    )
    return out


def spmd_xla_ho_subcycles(solver: MEVPSolverHO, carry, consts, dt: float, n_subcycles: int):
    """The HO carry after N subcycles of a rank's block on the width-1
    ("xla") schedule, the twin of ``spmd_xla_subcycles`` on the 17 planes
    of ``ho_flatten``: each subcycle exchanges the +1 strips of the 8
    velocity planes and runs ``ho_stress``, then the -1 strips of the 9
    stress planes and runs ``ho_velocity``; on a graded or spherical mesh
    the -1 strips of dx and dy are exchanged once. CUDA tensors launch the
    two kernels in place on one flat copy of the carry; CPU tensors run
    their plain versions, the same route."""
    from ..stencil import minus_strips, plus_strips

    mesh = solver.mesh
    periodic, axes = (mesh.periodic_x, mesh.periodic_y), solver.spmd
    widths = (None, None)
    if not mesh.uniform:
        widths = minus_strips(torch.stack([consts["dx"], consts["dy"]]), periodic, axes)
    state = ho_flatten(carry)
    if _on_cpu(state):
        def stress(state, strips):
            return ho_stress_halo_reference(solver, state, consts, *strips)

        def velocity(state, strips):
            return ho_velocity_halo_reference(solver, state, consts, dt, *strips, *widths)
    else:
        _check_ho_state(solver, state, consts)
        const_ptrs, form, stream = _ho_consts(consts), _ho_halo_form(solver), _stream(state.device)
        scalars, tables = _ho_scalars(solver, dt), _ho_tables(solver)

        def stress(state, strips):
            _ho_halo_("ho_stress", state, const_ptrs, strips, None, form, scalars, tables, stream)
            return state

        def velocity(state, strips):
            _ho_halo_(
                "ho_velocity", state, const_ptrs, strips, None if widths[0] is None else widths, form,
                scalars, tables, stream,
            )
            return state

    for _ in range(n_subcycles):
        state = stress(state, plus_strips(state[:8], periodic, axes))
        state = velocity(state, minus_strips(state[8:], periodic, axes))
    return ho_unflatten(state)


def dg1_sample_cfl_reference(transport: DGTransport, u, v, halo: int = 0):
    """(max |vx|, max |vy|) over the quadrature points, as a (2,) tensor;
    with ``halo``, over the elements of the block that (u, v) widen by
    ``halo`` on every side (their +1 nodes are the widened planes')."""
    if halo:
        ex, ey = u.shape[0] - 2 * halo, u.shape[1] - 2 * halo
        nodes = (slice(halo, halo + ex + 1), slice(halo, halo + ey + 1))
        qv = velocity_from_cg(transport.mesh, transport.basis, u[nodes], v[nodes])
        qv = QuadVelocity(*(getattr(qv, f)[..., :ex, :ey] for f in ("vx_vol", "vy_vol", "vn_x", "vn_y")))
    else:
        qv = velocity_from_cg(transport.mesh, transport.basis, u, v)
    return torch.stack(max_speeds(qv))


def dg1_sample_cfl(transport: DGTransport, u, v):
    """The two max quadrature speeds of the CFL count, as a (2,) tensor."""
    if _on_cpu(u):
        return dg1_sample_cfl_reference(transport, u, v)
    _check((transport.mesh.nx, transport.mesh.ny), u.device, u=u, v=v)
    speeds = torch.empty(2, device=u.device, dtype=torch.float32)
    _dg1_sample_cfl_(
        u, v, speeds, _dg1_tables(transport), _stream(u.device), wrap=wrap_bits(transport.mesh)
    )
    return speeds


def dg1_rk_stage_reference(
    transport: DGTransport, psi, base, u, v, face_x, face_y,
    a: float, b: float, dt_sub: float, qv: QuadVelocity = None, limit: bool = True,
    tvb: bool = False,
):
    """lim(a base + b (psi + dt_sub rhs(psi))), or lim(psi + dt_sub rhs(psi))
    when a == 0, on (K, T, nx, ny) coefficients, with the velocity sampled
    from the CG1 nodes (u, v) or the quadrature velocity ``qv``; lim is the
    positivity limiter, or the identity without ``limit`` or with ``tvb``
    (the TVB form's stage, which ``dg1_limit`` limits); face_x and face_y
    may be None (every face open)."""
    if qv is None:
        qv = velocity_from_cg(transport.mesh, transport.basis, u, v)
    faces = None if face_x is None and face_y is None else (face_x, face_y)
    value = psi + dt_sub * transport.rhs(psi, qv, faces)
    if a != 0.0:
        value = a * base + b * value
    return transport.limit_positivity(value) if limit and not tvb else value


def dg1_rk_stage(
    transport: DGTransport, psi, base, u, v, face_x, face_y,
    a: float, b: float, dt_sub: float, qv: QuadVelocity = None, limit: bool = True,
    tvb: bool = False,
):
    """One SSP-RK stage of the (K, T, nx, ny) tracers at the transport's
    degree (see the reference); with ``qv`` (a quadrature velocity) u and v
    are not read. With ``limit`` T is 3, and ``tvb`` (dG1, dG2) leaves the
    stage unlimited for ``dg1_limit``; without it (the no-limit instance)
    T is 1, ``qv`` is given and face_x and face_y are None."""
    if _on_cpu(psi):
        return dg1_rk_stage_reference(
            transport, psi, base, u, v, face_x, face_y, a, b, dt_sub, qv=qv, limit=limit,
            tvb=tvb,
        )
    nx, ny = transport.mesh.nx, transport.mesh.ny
    if limit:
        _check((nx, ny), psi.device, face_x=face_x, face_y=face_y)
    if qv is None:
        _check((nx, ny), psi.device, u=u, v=v)
        qv_ptrs = None
    else:
        qv_ptrs = _dg1_qv(qv, (nx, ny), psi.device, transport.basis.degree)
    _check((transport.basis.n_dofs, psi.shape[1], nx, ny), psi.device, psi=psi, base=base)
    out = torch.empty_like(psi)
    _dg1_rk_stage_(
        psi, base, u, v, face_x, face_y, _dg1_metric(transport, psi.device), out, a, b,
        dt_sub, _dg1_tables(transport), _stream(psi.device), qv=qv_ptrs, limit=limit, tvb=tvb,
        wrap=wrap_bits(transport.mesh),
    )
    return out


# -- K1's schedule of the two halves of the phase --------------------------------
def mevp_subcycles_reference(solver: MEVPSolver, carry, consts, dt: float, n_subcycles: int):
    """N x ``solver.subcycle_body``: the five planes after N subcycles."""
    carry = tuple(carry)
    for _ in range(n_subcycles):
        carry = solver.subcycle_body(carry, consts, dt)
    return carry


def mevp_subcycles(solver: MEVPSolver, carry, consts, dt: float, n_subcycles: int):
    """(u, v, s11, s22, s12) after N subcycles on K1's schedule: one
    ``mevp_stress`` and one ``mevp_velocity`` launch per subcycle, in place
    on copies of the inputs (the node planes c_w, inv_drag and, in the
    adaptive form, beta in scratch). CPU tensors run the plain version."""
    if _on_cpu(carry[0]):
        return mevp_subcycles_reference(solver, carry, consts, dt, n_subcycles)
    _check_mevp(solver, carry, consts)
    planes = tuple(t.clone() for t in carry)
    c_w, inv_drag = torch.empty_like(planes[0]), torch.empty_like(planes[0])
    beta = torch.empty_like(planes[0]) if solver.params.adaptive_alpha else None
    scalars, stream = _mevp_scalars(solver, dt), _stream(planes[0].device)
    const_ptrs = _mevp_consts(consts)
    wrap = wrap_bits(solver.mesh)
    for _ in range(n_subcycles):
        _mevp_half_("mevp_stress", planes, const_ptrs, c_w, inv_drag, scalars, stream, beta, wrap)
        _mevp_half_("mevp_velocity", planes, const_ptrs, c_w, inv_drag, scalars, stream, beta, wrap)
    return planes


def free_drift_subcycles(solver, carry, consts, dt: float, n_subcycles: int):
    """The momentum part of a dynamics phase with ``FreeDriftSolver``: its
    step (``n_subcycles`` fixed-point iterations of the drag balance) on the
    carry (u, v, s11, s22, s12), with ``consts`` the step's inputs (h, a,
    forcing, mask) as ``CoupledModel.step_dynamics`` packs them. Plain
    PyTorch on every device: the JAX package has no kernel for it either."""
    out = solver.step(
        VelocityState(*carry), consts["h"], consts["a"], consts["forcing"], consts["mask"],
        dt, n_subcycles,
    )
    return out.u, out.v, out.s11, out.s22, out.s12


def transport_substeps_reference(
    transport: DGTransport, tracers, u, v, dt_sub: float, k: int, face_masks=None, qv=None,
    metric=None, wall_masks=None,
):
    """k x ``transport.step(limit=True)`` with the velocity sampled from the
    CG1 nodes (u, v), or with the precomputed quadrature velocity ``qv``
    (the HO path; u and v are then not read); ``tracers`` is (K, T, nx, ny).
    ``metric``: the metric planes in place of the transport's (a widened
    rank block's); ``wall_masks``: the TVB wall-delta masks (its global
    walls)."""
    if qv is None:
        qv = velocity_from_cg(transport.mesh, transport.basis, u, v)
    for _ in range(k):
        tracers = transport.step(
            tracers, qv, dt_sub, limit=True, face_masks=face_masks, metric=metric,
            wall_masks=wall_masks,
        )
    return tracers


def spmd_staged_transport(
    model, tracers, dt_sub: float, k: int, face_masks=None, velocity_w=None, qv: QuadVelocity = None,
):
    """The rank's tracers after k limited substeps of ``dt_sub`` on the
    staged route of a rank grid (``model``: the rank's ``CoupledModel``;
    ``tracers`` (K, T, nx, ny) and ``face_masks`` its block's): the JAX
    package's staged spmd transport, whose neighbour shifts exchange
    width-1 strips (TVB on a graded, spherical or ring mesh, and
    ``transport_backend="xla"``). The velocity is ``velocity_w``, the
    rank's (u, v) widened by one ring (``transport_tiled_cuda.
    widen_velocity(model, u, v, 1)``), or with the HO solver ``qv``, the
    block's quadrature samples, widened here. The face masks and the
    samples are widened once (one exchange per axis), the metric planes are
    the widened block's (``CoupledModel.widened_metric(1)``); then each RK
    stage of each substep widens psi by one ring (one exchange per axis)
    and runs ``dg1_rk_stage_halo`` into the block's own coefficients, and
    with the TVB limiter widens the stage's means and runs
    ``dg1_limit_halo``. The global walls are the widened block's indices
    (``spmd_walls(model, 1)``); a ring's wrap arrives through the exchange.
    CUDA tensors launch the two halo forms (and nothing of the plain
    versions); CPU tensors run their plain versions, the same route."""
    from .transport_tiled_cuda import _widen, spmd_walls

    tr, mesh = model.transport, model.mesh
    if (velocity_w is None) == (qv is None):
        raise ValueError("the staged spmd transport takes the widened (u, v) or the samples qv, one of them")
    nx, ny = mesh.nx, mesh.ny
    on_cpu = _on_cpu(tracers)
    local = model.widened_transport(1)
    walls = spmd_walls(model, 1)
    ones = torch.ones_like(tracers[0, 0])
    faces = (ones, ones) if face_masks is None else face_masks
    face_x, face_y = _widen(model, torch.stack(list(faces)), 1)
    metric = model.widened_metric(1, device=tracers.device, dtype=tracers.dtype)
    u_w = v_w = qv_w = None
    if qv is None:
        u_w, v_w = velocity_w[0], velocity_w[1]
    else:
        fields = ("vx_vol", "vy_vol", "vn_x", "vn_y")
        counts = [getattr(qv, f).shape[0] for f in fields]
        stacked = _widen(model, torch.cat([getattr(qv, f) for f in fields]), 1)
        qv_w = QuadVelocity(*torch.split(stacked, counts))
    tvb = tr.limits_slopes
    if on_cpu:
        def stage(cur, base, out, a, b):
            value = dg1_rk_stage_halo_reference(
                local, _widen(model, cur, 1), base, u_w, v_w, face_x, face_y, walls, a, b, dt_sub,
                qv=qv_w, metric=metric, tvb=tvb,
            )
            if tvb:
                value = dg1_limit_halo_reference(tr, value, _widen(model, value[0], 1), walls)
            out.copy_(value)

        return _staged_steps(tracers.clone(), _RK_STAGES[tr.scheme], k, stage)

    shape_w = (nx + 2, ny + 2)
    device = tracers.device
    _check((tr.basis.n_dofs, STAGE_TRACERS, nx, ny), device, tracers=tracers)
    _check(shape_w, device, face_x=face_x, face_y=face_y)
    if qv is None:
        _check((2, *shape_w), device, velocity_w=velocity_w)
        qv_ptrs = None
    else:
        qv_ptrs = _dg1_qv(qv_w, shape_w, device, tr.basis.degree)
    tables, stream = _dg1_tables(local), _stream(device)
    metric_ptrs = _dg1_metric(local, device, metric)
    wall_array = _walls(walls)
    tolerances = tr.tvb_tolerances(device=device, dtype=torch.float32) if tvb else None

    def stage(cur, base, out, a, b):
        _dg1_rk_stage_halo_(
            _widen(model, cur, 1), base, u_w, v_w, face_x, face_y, metric_ptrs, out, a, b, dt_sub,
            tables, stream, wall_array, qv=qv_ptrs, tvb=tvb,
        )
        if tvb:
            _dg1_limit_halo_(out, _widen(model, out[0], 1), tolerances, tables, stream, wall_array)

    return _staged_steps(tracers.clone(), _RK_STAGES[tr.scheme], k, stage)


def _face_planes(like, face_masks, shape):
    if face_masks is None:
        return torch.ones_like(like), torch.ones_like(like)
    face_x, face_y = face_masks
    _check(shape, like.device, face_x=face_x, face_y=face_y)
    return face_x, face_y


def transport_substeps(
    transport: DGTransport, tracers, u, v, dt_sub: float, k: int, face_masks=None, qv=None,
):
    """The tracers after k limited SSP-RK substeps on K1's schedule: one
    ``dg1_rk_stage`` launch per RK stage, with the velocity sampled from the
    CG1 nodes (u, v) or the precomputed quadrature velocity ``qv`` (the HO
    path; u and v are then not read); with the transport's TVB limiter
    (``limits_slopes``) the stage's unlimited form and one ``dg1_limit``
    launch after it. CPU tensors run the plain version."""
    if _on_cpu(tracers):
        return transport_substeps_reference(transport, tracers, u, v, dt_sub, k, face_masks, qv=qv)
    shape = (transport.mesh.nx, transport.mesh.ny)
    if qv is None:
        _check(shape, tracers.device, u=u, v=v)
        qv_ptrs = None
    else:
        qv_ptrs = _dg1_qv(qv, shape, tracers.device, transport.basis.degree)
    _check((transport.basis.n_dofs, tracers.shape[1], *shape), tracers.device, tracers=tracers)
    face_x, face_y = _face_planes(tracers[0, 0], face_masks, shape)
    tables, stream = _dg1_tables(transport), _stream(tracers.device)
    metric = _dg1_metric(transport, tracers.device)
    wrap, tvb = wrap_bits(transport.mesh), transport.limits_slopes
    tolerances = transport.tvb_tolerances(device=tracers.device, dtype=torch.float32) if tvb else None

    def stage(cur, base, out, a, b):
        _dg1_rk_stage_(
            cur, base, u, v, face_x, face_y, metric, out, a, b, dt_sub, tables, stream,
            qv=qv_ptrs, tvb=tvb, wrap=wrap,
        )
        if tvb:
            _dg1_limit_(out, tolerances, tables, stream, wrap)

    return _staged_steps(tracers.clone(), _RK_STAGES[transport.scheme], k, stage)


def _staged_steps(psi0, stages, k: int, stage):
    """k SSP-RK steps of one launch per stage, ``stage(cur, base, out, a,
    b)`` each; ``psi0`` (a fresh tensor) becomes the result or a buffer. A
    stage reads its neighbours' psi, so stages ping-pong between buffers;
    the last stage may overwrite the step's base in place (each element
    reads only its own base value)."""
    spare = [torch.empty_like(psi0) for _ in range(max(1, len(stages) - 1))]
    for _ in range(k):
        cur = psi0
        for s, (a, b) in enumerate(stages):
            out = psi0 if (s > 0 and s == len(stages) - 1) else spare[s]
            stage(cur, psi0, out, a, b)
            cur = out
        if cur is not psi0:  # rk1: the single stage wrote a spare buffer
            psi0, spare[0] = cur, psi0
    return psi0


def transport_run_reference(transport: DGTransport, psi, vel: QuadVelocity, dt: float, n_steps: int):
    """n_steps x ``transport.step`` (unlimited), as the JAX ``DGTransport.run``."""
    for _ in range(n_steps):
        psi = transport.step(psi, vel, dt)
    return psi


def transport_run(transport: DGTransport, psi, vel: QuadVelocity, dt: float, n_steps: int):
    """``DGTransport.run``: n_steps unlimited SSP-RK steps of the (K, ...,
    nx, ny) coefficients ``psi`` (extra middle dims: several tracers) in
    the quadrature velocity ``vel``. CPU tensors run the plain version;
    CUDA tensors one launch of dg1_rk_stage's no-limit instance per RK
    stage and tracer (float32, contiguous; no face masks)."""
    if _on_cpu(psi):
        return transport_run_reference(transport, psi, vel, dt, n_steps)
    mesh, degree = transport.mesh, transport.basis.degree
    shape, n_dofs = (mesh.nx, mesh.ny), transport.basis.n_dofs
    if psi.ndim < 3 or psi.shape[0] != n_dofs or tuple(psi.shape[-2:]) != shape:
        raise ValueError(
            f"psi has shape {tuple(psi.shape)}, expected ({n_dofs}, ..., {mesh.nx}, {mesh.ny})"
        )
    flat = psi.reshape(n_dofs, -1, *shape)
    _check(flat.shape, psi.device, psi=flat)
    qv_ptrs = _dg1_qv(vel, shape, psi.device, degree)
    tables, stream = _dg1_tables(transport), _stream(psi.device)
    metric = _dg1_metric(transport, psi.device)
    out = [
        _staged_steps(
            flat[:, t: t + 1].clone(memory_format=torch.contiguous_format), _RK_STAGES[transport.scheme], n_steps,
            lambda cur, base, dst, a, b: _dg1_rk_stage_(
                cur, base, None, None, None, None, metric, dst, a, b, dt, tables, stream,
                qv=qv_ptrs, limit=False, wrap=wrap_bits(mesh),
            ),
        )
        for t in range(flat.shape[1])
    ]
    return torch.cat(out, dim=1).reshape(psi.shape)


# -- the dynamics phase ----------------------------------------------------------
def _k_of_speeds(model, speeds, dt: float) -> int:
    """k from the (2,) max speeds: copied to the host (the one host sync of
    the step on a card; on a rank grid the max over the ranks, one copy for
    the whole grid) and turned into k there, so that the same speeds give
    the same k on every path and every rank."""
    if model.exchange is not None:
        speeds = model.exchange.max(speeds)
    else:
        speeds = speeds.cpu()
    return int(substeps_from_speeds(
        speeds[0], speeds[1], dt, model.mesh, model.transport.basis.degree,
        k_floor=model.transport_substeps,
    ))


def _substeps(model, qv, dt: float) -> int:
    """The transport substep count of the step: from the CFL number of the
    sampled velocity, or the model's fixed count."""
    if not model.auto_substeps:
        return model.transport_substeps
    return _k_of_speeds(model, torch.stack(max_speeds(qv)), dt)


def fused_dynamics_reference(
    model, state_arrays, tracers, consts: dict, dt: float, n_subcycles: int,
    face_masks=None,
):
    """Plain PyTorch dynamics phase: ``subcycle_body`` x N, then the
    quadrature velocity (``velocity_from_cg``, or ``ho_velocity_to_quad``
    with the HO solver), ``cfl_substeps`` and k x ``DGTransport.step``. On
    a rank grid every shift exchanges a width-1 halo (the "xla" schedule)
    and k comes from the max speeds over the ranks."""
    solver, transport, mesh = model.mevp, model.transport, model.mesh
    if model.is_high_order:
        carry = ho_subcycles_reference(solver, state_arrays, consts, dt, n_subcycles)
        qv = ho_velocity_to_quad(mesh, transport.basis, carry[0], carry[1])
    elif model.is_free_drift:
        carry = free_drift_subcycles(solver, state_arrays, consts, dt, n_subcycles)
        qv = velocity_from_cg(mesh, transport.basis, carry[0], carry[1])
    else:
        carry = mevp_subcycles_reference(solver, state_arrays, consts, dt, n_subcycles)
        qv = velocity_from_cg(mesh, transport.basis, carry[0], carry[1], model.spmd)
    k = _substeps(model, qv, dt)
    tr = transport_substeps_reference(transport, tracers, None, None, dt / k, k, face_masks, qv=qv)
    return carry, tr


def dynamics_phase(
    model, state_arrays, tracers, consts: dict, dt: float, n_subcycles: int,
    face_masks=None, *, mevp: str = "pallas", transport: str = "xla",
):
    """Returns ((u, v, s11, s22, s12), tracers) after one dynamics phase.

    ``state_arrays``: the five (nx, ny) velocity/stress planes; ``tracers``:
    (K, T, nx, ny) stacked DG coefficients (K = 1, 3, 6 at dG0, dG1, dG2); ``consts``: the output of
    ``MEVPSolver.step_consts``; ``face_masks``: optional (face_x, face_y).
    CPU tensors run ``fused_dynamics_reference``; CUDA tensors the kernels.
    The schedule on the card:

    * ``mevp="fused"``: the whole phase in one ``fused_dynamics`` launch,
      k on the card and no host sync (``fused_dynamics_cuda``; K1 as the
      TPU kernel runs it, on the forms that kernel holds; ``transport``
      must name a schedule but does not apply);
    * ``mevp="pallas"``: ``mevp_stress`` + ``mevp_velocity`` per subcycle
      (K1's split schedule, ``mevp_subcycles``); ``"single"``: ``mevp_single``,
      all N subcycles in one launch (``mevp_single_cuda``);
      ``"pallas-tiled"``: ``mevp_tiled``, H subcycles per launch
      (``mevp_tiled_cuda``); ``"free-drift"``: the free-drift step
      (``free_drift_subcycles``, plain: ``consts`` are the step's inputs);
    * then ``dg1_sample_cfl`` and one host sync for k;
    * ``transport="xla"``: one ``dg1_rk_stage`` per RK stage (K1's
      schedule, ``transport_substeps``); ``"tiled"``: ``transport_tiled``,
      whole substeps per launch (``transport_tiled_cuda``).

    With the HO solver (``model.is_high_order``) ``state_arrays`` is the HO
    carry and ``consts`` the output of ``MEVPSolverHO.step_consts``;
    ``mevp`` is ``"single"`` or ``"tiled"``, and the transport advects with
    the CG2 velocity's quadrature samples on either schedule
    (``_ho_dynamics_phase``).

    On a rank grid (``model.exchange``) ``mevp`` is the solver's exchange
    schedule and ``transport`` ``"tiled"`` or ``"xla"``; see
    ``_spmd_dynamics_phase``. It runs on CPU tensors too, with the plain
    versions inside the exchange schedules.
    """
    if model.exchange is not None:
        return _spmd_dynamics_phase(
            model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, mevp, transport
        )
    if _on_cpu(tracers):
        return fused_dynamics_reference(
            model, state_arrays, tracers, consts, dt, n_subcycles, face_masks
        )
    if model.is_high_order:
        return _ho_dynamics_phase(
            model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, mevp, transport
        )
    from .fused_dynamics_cuda import fused_dynamics_single
    from .mevp_single_cuda import mevp_subcycles_single
    from .mevp_tiled_cuda import mevp_subcycles_tiled
    from .transport_tiled_cuda import transport_substeps_tiled

    run_mevp = {
        "pallas": mevp_subcycles, "single": mevp_subcycles_single,
        "pallas-tiled": mevp_subcycles_tiled, "free-drift": free_drift_subcycles,
    }
    run_transport = {"xla": transport_substeps, "tiled": transport_substeps_tiled}
    if mevp not in (*run_mevp, "fused") or transport not in run_transport:
        raise ValueError(f"unknown schedule: mevp={mevp!r}, transport={transport!r}")
    if mevp == "fused":
        return fused_dynamics_single(
            model, state_arrays, tracers, consts, dt, n_subcycles, face_masks
        )[:2]
    solver, tr, mesh = model.mevp, model.transport, model.mesh
    device = tracers.device
    _check((tr.basis.n_dofs, tracers.shape[1], mesh.nx, mesh.ny), device, tracers=tracers)
    face_masks = _face_planes(state_arrays[0], face_masks, (mesh.nx, mesh.ny))
    planes = run_mevp[mevp](solver, state_arrays, consts, dt, n_subcycles)
    u, v = planes[0], planes[1]

    # CFL substep count: the one host sync of the step.
    if model.auto_substeps:
        speeds = torch.empty(2, device=device, dtype=torch.float32)
        _dg1_sample_cfl_(u, v, speeds, _dg1_tables(tr), _stream(device), wrap=wrap_bits(mesh))
        k = _k_of_speeds(model, speeds, dt)
    else:
        k = model.transport_substeps
    return planes, run_transport[transport](tr, tracers, u, v, dt / k, k, face_masks)


def _spmd_dynamics_phase(
    model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, mevp, transport,
):
    """``dynamics_phase`` on one rank of a rank grid: the N subcycles on the
    solver's exchange schedule (``mevp``: "blocked", "rdma" or "xla"; or
    the free-drift step, "free-drift", plain on every device); the
    max speeds of the rank's own elements, the max over the ranks and k;
    then ``transport="tiled"``: ``transport_substeps_tiled_spmd``
    (transport_tiled on the block widened by H), or ``"xla"``: the staged
    route with width-1 exchanges (``spmd_staged_transport``: the halo forms
    of dg1_rk_stage and dg1_limit on a card, their plain versions on the
    CPU).

    The velocity is widened once, by H for the tiled transport and by one
    ring for the staged route: on a card ``dg1_sample_cfl`` samples the
    block's own elements inside it (the nodes beyond the block are the
    neighbours'), and the transport advects with it. With the HO solver
    (``_spmd_ho_phase``) the CG2 velocity is sampled at the quadrature
    points through the exchange instead."""
    from .transport_tiled_cuda import transport_substeps_tiled_spmd, widen_velocity

    solver, tr, mesh = model.mevp, model.transport, model.mesh
    if mevp != model.mevp_schedule() or transport not in ("tiled", "xla"):
        raise ValueError(
            f"unknown rank-grid schedule: mevp={mevp!r} (the solver runs "
            f"{model.mevp_schedule()!r}), transport={transport!r}"
        )
    on_cpu = _on_cpu(tracers)
    if model.is_high_order:
        return _spmd_ho_phase(model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, transport)
    if mevp == "free-drift":  # plain on every device; its node averages exchange
        planes = free_drift_subcycles(solver, state_arrays, consts, dt, n_subcycles)
    else:
        planes = solver.spmd_subcycles(state_arrays, consts, dt, n_subcycles)
    u, v = planes[0], planes[1]
    velocity_w = widen_velocity(model, u, v, None if transport == "tiled" else 1)
    if not model.auto_substeps:
        k = model.transport_substeps
    elif on_cpu:
        k = _substeps(model, velocity_from_cg(mesh, tr.basis, u, v, model.spmd), dt)
    else:
        H = (velocity_w.shape[1] - mesh.nx) // 2
        speeds = torch.empty(2, device=u.device, dtype=torch.float32)
        _dg1_sample_cfl_(
            velocity_w[0], velocity_w[1], speeds, _dg1_tables(tr), _stream(u.device), halo=H
        )
        k = _k_of_speeds(model, speeds, dt)
    if transport == "tiled":
        return planes, transport_substeps_tiled_spmd(model, tracers, velocity_w, dt / k, k, face_masks)
    return planes, spmd_staged_transport(model, tracers, dt / k, k, face_masks, velocity_w=velocity_w)


def _spmd_ho_phase(model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, transport):
    """The HO solver's ``_spmd_dynamics_phase``: the N subcycles on the
    blocked, rdma or width-1 exchange schedule, the CG2 velocity
    sampled at the quadrature points through the exchange
    (``ho_velocity_to_quad``), k from the max speeds of the rank's own
    elements over the ranks (one host sync for the grid), then the spmd
    transport_tiled with the samples widened by H (``qv``; with TVB its
    instance with the global walls inside the widened block), or the
    staged route with the samples widened by one ring
    (``spmd_staged_transport``)."""
    from .transport_tiled_cuda import transport_substeps_tiled_spmd

    mesh, tr = model.mesh, model.transport
    planes = model.mevp.spmd_subcycles(state_arrays, consts, dt, n_subcycles)
    qv = ho_velocity_to_quad(mesh, tr.basis, planes[0], planes[1], model.spmd)
    k = _substeps(model, qv, dt)
    if transport == "tiled":
        return planes, transport_substeps_tiled_spmd(model, tracers, None, dt / k, k, face_masks, qv=qv)
    return planes, spmd_staged_transport(model, tracers, dt / k, k, face_masks, qv=qv)


def _ho_dynamics_phase(
    model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, mevp, transport,
):
    """``dynamics_phase`` with the HO solver on the card: ``mevp="single"``
    runs ho_single, ``"tiled"`` ho_tiled; the transport advects with the
    precomputed CG2 samples, on ``transport="tiled"`` transport_tiled and on
    ``"xla"`` one dg1_rk_stage per RK stage (their ``qv`` forms)."""
    from .ho_single_cuda import ho_subcycles_single
    from .ho_tiled_cuda import ho_subcycles_tiled
    from .transport_tiled_cuda import transport_substeps_tiled

    run_mevp = {"single": ho_subcycles_single, "tiled": ho_subcycles_tiled}
    run_transport = {"xla": transport_substeps, "tiled": transport_substeps_tiled}
    if mevp not in run_mevp or transport not in run_transport:
        raise ValueError(f"unknown HO schedule: mevp={mevp!r}, transport={transport!r}")
    mesh, tr = model.mesh, model.transport
    _check((tr.basis.n_dofs, tracers.shape[1], mesh.nx, mesh.ny), tracers.device, tracers=tracers)
    carry = run_mevp[mevp](model.mevp, state_arrays, consts, dt, n_subcycles)
    qv = ho_velocity_to_quad(mesh, tr.basis, carry[0], carry[1])
    k = _substeps(model, qv, dt)
    return carry, run_transport[transport](tr, tracers, None, None, dt / k, k, face_masks, qv=qv)


def fused_dynamics(
    model, state_arrays, tracers, consts: dict, dt: float, n_subcycles: int,
    face_masks=None,
):
    """The dynamics phase as the TPU kernel ``fused_dynamics_pallas`` runs
    it: one ``fused_dynamics`` launch on a card (``dynamics_phase`` with
    ``mevp="fused"``; raises ValueError for a form or grid that the kernel
    does not hold), the plain version on the CPU."""
    return dynamics_phase(
        model, state_arrays, tracers, consts, dt, n_subcycles, face_masks,
        mevp="fused", transport="xla",
    )
