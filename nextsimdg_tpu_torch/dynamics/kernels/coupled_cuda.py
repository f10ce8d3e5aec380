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
``mevp_velocity``   ``csrc/mevp.cu``            ``MEVPSolver.velocity_update``
``dg1_sample_cfl``  ``csrc/transport.cu``       ``dg1_sample_cfl_reference``
``dg1_rk_stage``    ``csrc/transport.cu``       ``dg1_rk_stage_reference``
``mevp_tiled``      ``csrc/mevp_tiled.cu``      ``mevp_subcycles_reference``
``transport_tiled`` ``csrc/transport_tiled.cu`` ``transport_substeps_reference``
``mevp_single``     ``csrc/mevp_single.cu``     ``mevp_subcycles_reference``
``ho_single``       ``csrc/ho_single.cu``       ``ho_subcycles_reference``
``ho_tiled``        ``csrc/ho_tiled.cu``        ``ho_subcycles_reference``
``rdma_stage``      ``csrc/mevp_rdma.cu``       ``rdma_stage_reference``
``rdma_band``       ``csrc/mevp_rdma.cu``       ``rdma_band_reference``
``chain``           ``csrc/roofline.cu``        ``benchmarks.roofline.chain_reference``
=================== =========================== ===================================

The first four are K1's schedule, wrapped here. Per step: 2 launches per
subcycle, one ``dg1_sample_cfl`` whose two max speeds are read back once
to fix k (one host sync), then one ``dg1_rk_stage`` per RK stage and
substep. The others have wrapper modules of their own:
``mevp_tiled_cuda`` and ``transport_tiled_cuda`` (the ghost-zone tiled
schedule, K2 and K3 of the JAX package) and ``mevp_single_cuda`` (all N
subcycles in one launch, K4), and ``mevp_rdma_cuda`` (the overlapped
halo round of a rank block, K7); ``chain``, the ceiling probe (K8), is
wrapped by ``nextsimdg_tpu_torch.benchmarks.roofline``. Every mEVP kernel
takes the 7 uniform consts or, on a graded or spherical mesh, the 12 with
the metric planes; the transport kernels read the transport's metric
planes on such a mesh.

With the higher-order solver (``MEVPSolverHO``) the phase runs
``ho_single`` (all N subcycles in one launch, K5 of the JAX package) or
``ho_tiled`` (ghost-zone tiles, K6), wrapped by ``ho_single_cuda`` and
``ho_tiled_cuda`` on the 17 state and 29 const planes packed here; the CG2
velocity is sampled at the quadrature points in plain PyTorch
(``ho_velocity_to_quad``, as the JAX package does it in XLA), k comes from
those samples (one host sync), and ``transport_tiled`` advects the tracers
with the precomputed samples (its ``qv`` form).

On a rank grid (``parallel``) the phase runs the solver's exchange
schedule (``MEVPSolver.spmd_subcycles``: ``mevp_tiled`` on the widened
block, or the rdma round), samples the CFL speeds of the rank's own
elements in its widened velocity, agrees k over the ranks with one host
sync for the whole grid, and advects with ``transport_tiled`` on the
widened block (``transport_tiled_cuda.transport_substeps_tiled_spmd``).

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
from pathlib import Path

import numpy as np
import torch

from ..mevp import METRIC_CONSTS, UNIFORM_CONSTS, MEVPSolver
from ..mevp_ho import (
    HO_CONSTS, HOField, MEVPSolverHO, ho_subcycles_reference, ho_velocity_to_quad,
)
from ..transport import (
    DGTransport, max_speeds, sampling_weights, substeps_from_speeds, velocity_from_cg,
)

KERNELS = (
    "mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage",
    "mevp_tiled", "transport_tiled", "mevp_single", "ho_single", "ho_tiled",
    "rdma_stage", "rdma_band", "chain",
)

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

#: The const planes in the order of MevpConsts in csrc/mevp_body.cuh.
_MEVP_CONSTS = UNIFORM_CONSTS + METRIC_CONSTS
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
    lib.nst_mevp_stress.argtypes = [p] * 8 + [i, i] + tail
    lib.nst_mevp_velocity.argtypes = [p] * 8 + [i, i] + tail
    lib.nst_dg1_sample_cfl.argtypes = [p] * 3 + [i] * 5 + tail
    lib.nst_dg1_rk_stage.argtypes = [p] * 8 + [i, i, i, f, f, f] + tail
    lib.nst_mevp_tiled.argtypes = [p] * 11 + [i] * 6 + tail
    lib.nst_transport_tiled.argtypes = [p] * 8 + [i] * 8 + [f, f, f] + tail
    lib.nst_mevp_single.argtypes = [p] * 8 + [i] * 4 + tail
    lib.nst_ho_single.argtypes = [p, p] + [i] * 4 + [p] + tail
    lib.nst_ho_tiled.argtypes = [p] * 3 + [i] * 10 + [p] + tail
    lib.nst_rdma_stage.argtypes = [p, p, i, p, i, p]
    lib.nst_rdma_band.argtypes = [p, p, i, p, i, i, i, i, p, i, p] + tail
    lib.nst_chain.argtypes = [p, p, p] + [i] * 6 + [p]
    for name in KERNELS:
        getattr(lib, "nst_" + name).restype = i
    lib.nst_mevp_tiled_max_blocks.argtypes = [i] * 5
    lib.nst_mevp_tiled_max_blocks.restype = i
    lib.nst_mevp_single_max_blocks.argtypes = [i, i]
    lib.nst_mevp_single_max_blocks.restype = i
    lib.nst_ho_single_max_blocks.argtypes = [i]
    lib.nst_ho_single_max_blocks.restype = i
    lib.nst_ho_tiled_max_clusters.argtypes = [i] * 6
    lib.nst_ho_tiled_max_clusters.restype = i
    lib.nst_rdma_band_max_clusters.argtypes = [i] * 6
    lib.nst_rdma_band_max_clusters.restype = i
    lib.nst_window_syncs.argtypes = [i] * 6 + [p, p]
    lib.nst_window_syncs.restype = i
    for name in ("mevp_n_scalars", "dg1_n_table_floats", "ho_n_scalars", "ho_n_table_floats"):
        getattr(lib, "nst_" + name).restype = i
    lib.nst_error_string.argtypes = [i]
    lib.nst_error_string.restype = ctypes.c_char_p
    if lib.nst_mevp_n_scalars() != _N_MEVP_SCALARS:
        raise RuntimeError("csrc/mevp.cu MevpScalars disagrees with the packing")
    if lib.nst_dg1_n_table_floats() != _N_DG1_TABLE:
        raise RuntimeError("csrc/transport.cu Dg1Tables disagrees with the packing")
    if lib.nst_ho_n_scalars() != _N_HO_SCALARS or lib.nst_ho_n_table_floats() != _N_HO_TABLE:
        raise RuntimeError("csrc/ho_body.cuh HoScalars or HoTables disagrees with the packing")
    _lib = lib
    return lib


def _launch(name: str, *args) -> None:
    lib = _library()
    err = getattr(lib, "nst_" + name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: {lib.nst_error_string(err).decode()}"
        )
    with _lock:
        launches[name] += 1


# -- host-side packing of the kernels' scalars -------------------------------
_N_MEVP_SCALARS = 17
_N_DG1_TABLE = 111
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
        p.beta, f, -f, dt,
    ]
    assert len(values) == _N_MEVP_SCALARS
    return _floats(values)


def _dg1_tables(transport: DGTransport):
    """Dg1Tables of csrc/transport.cu, field for field, from the port's
    dG1 basis (2x2 volume points, 2 points per face)."""
    b, mesh = transport.basis, transport.mesh
    if b.n_dofs != 3 or len(b.w_vol) != 4 or len(b.s_edge) != 2:
        raise NotImplementedError("the transport kernels are dG1 with 2-point Gauss")
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
    assert len(values) == _N_DG1_TABLE
    return _floats(values)


def _ho_scalars(solver: MEVPSolverHO, dt: float):
    """HoScalars of csrc/ho_body.cuh, field for field."""
    p, mesh = solver.params, solver.mesh
    e2 = p.ellipse * p.ellipse
    f = p.f_coriolis if p.use_coriolis else 0.0
    values = [
        _f32_reciprocal(mesh.dx), _f32_reciprocal(mesh.dy), mesh.dx, mesh.dy,
        1.0 + 1.0 / e2, 1.0 - 1.0 / e2, 4.0 / e2, p.delta_min, 1.0 / e2, 1.0 / p.alpha,
        p.rho_ocean * p.cd_ocean, 1.0 + p.beta, p.beta, f, -f, dt,
    ]
    assert len(values) == _N_HO_SCALARS
    return _floats(values)


def _ho_tables(solver: MEVPSolverHO):
    """HoTables of csrc/ho_body.cuh, field for field, from the solver's CG2
    tables (the ~1e-17 quadrature residues included, as the plain version
    multiplies them)."""
    t = solver.tables
    values = []
    for table in (t.grad_x_to_dg1, t.grad_y_to_dg1, t.phi_dg1, solver.proj, t.div_x, t.div_y):
        values += [float(x) for x in np.asarray(table).ravel()]
    assert len(values) == _N_HO_TABLE
    return _floats(values)


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
    on a graded or spherical mesh."""
    expected = UNIFORM_CONSTS if solver.mesh.uniform else _MEVP_CONSTS
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
    """The HO kernels take the 29 uniform consts, float32 (nx, ny) planes,
    and the carry's 8 velocity and 3 x 3 stress planes."""
    if tuple(sorted(consts)) != tuple(sorted(HO_CONSTS)):
        raise NotImplementedError(
            f"the HO kernels take the consts {tuple(sorted(HO_CONSTS))}, got {tuple(sorted(consts))}"
        )
    u, v, s11, s22, s12 = carry
    shape = (solver.mesh.nx, solver.mesh.ny)
    device = u.v.device
    planes = {f"u.{k}": x for k, x in zip("vblc", u.planes())}
    planes.update({f"v.{k}": x for k, x in zip("vblc", v.planes())})
    _check(shape, device, **planes, **consts)
    _check((3, *shape), device, s11=s11, s22=s22, s12=s12)


def _ho_consts(consts: dict):
    """The 29 const-plane pointers of HoConsts."""
    return _pointers([consts[name] for name in HO_CONSTS])


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _pointers(tensors):
    """A C array of the tensors' device pointers (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors)
    )


def _mevp_consts(consts: dict):
    """The 12 const-plane pointers of MevpConsts; the metric ones null when
    the consts have none."""
    return _pointers([consts.get(name) for name in _MEVP_CONSTS])


def _dg1_metric(transport: DGTransport, device):
    """Dg1MetricPlanes of the transport's float32 metric planes on
    ``device``, or None (a null pointer) on a uniform mesh."""
    metric = transport.metric_planes(device=device, dtype=torch.float32)
    return None if metric is None else _pointers([metric[name] for name in _DG1_METRIC])


# -- in-place launches (arguments already checked) ----------------------------
def _mevp_half_(name, planes, const_ptrs, c_w, inv_drag, scalars, stream):
    """``mevp_stress`` or ``mevp_velocity`` in place on the five planes;
    ``const_ptrs`` from ``_mevp_consts``."""
    u = planes[0]
    nx, ny = u.shape
    _launch(
        name, *(t.data_ptr() for t in planes), c_w.data_ptr(), inv_drag.data_ptr(),
        const_ptrs, nx, ny, ctypes.addressof(scalars), u.device.index, stream,
    )


def _dg1_sample_cfl_(u, v, speeds, tables, stream, halo: int = 0):
    """The max speeds of the elements of (u, v), or with ``halo`` of the
    elements of the block that (u, v) widen by ``halo`` on every side."""
    nx, ny = u.shape
    ex, ey = nx - 2 * halo, ny - 2 * halo
    offset = (halo * ny + halo) * u.element_size()
    extent = (ex + 1, ey + 1) if halo else (nx, ny)
    _launch(
        "dg1_sample_cfl",
        u.data_ptr() + offset, v.data_ptr() + offset, speeds.data_ptr(),
        ex, ey, *extent, ny, ctypes.addressof(tables), u.device.index, stream,
    )


def _dg1_rk_stage_(psi, base, u, v, face_x, face_y, metric, out, a, b, dt_sub, tables, stream):
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("dg1_rk_stage reads its neighbours' psi: out must not alias psi")
    nx, ny = u.shape
    _launch(
        "dg1_rk_stage",
        psi.data_ptr(), base.data_ptr(), u.data_ptr(), v.data_ptr(),
        face_x.data_ptr(), face_y.data_ptr(), metric, out.data_ptr(),
        nx, ny, psi.shape[1], a, b, dt_sub,
        ctypes.addressof(tables), u.device.index, stream,
    )


# -- the four kernels, one launch each -----------------------------------------
def mevp_stress(solver: MEVPSolver, carry, consts):
    """First half of an mEVP subcycle: (s11, s22, s12, c_w, inv_drag).

    Plain version: ``solver.stress_update(carry, consts)``.
    """
    if _on_cpu(carry[0]):
        return solver.stress_update(carry, consts)
    _check_mevp(solver, carry, consts)
    u, v, s11, s22, s12 = carry
    planes = (u, v, s11.clone(), s22.clone(), s12.clone())
    c_w, inv_drag = torch.empty_like(u), torch.empty_like(u)
    _mevp_half_(
        "mevp_stress", planes, _mevp_consts(consts), c_w, inv_drag,
        _mevp_scalars(solver, 0.0), _stream(u.device),
    )
    return planes[2], planes[3], planes[4], c_w, inv_drag


def mevp_velocity(solver: MEVPSolver, carry, consts, c_w, inv_drag, dt: float):
    """Second half of an mEVP subcycle: the new (u, v).

    Plain version: ``solver.velocity_update(carry, consts, c_w, inv_drag, dt)``.
    """
    if _on_cpu(carry[0]):
        return solver.velocity_update(carry, consts, c_w, inv_drag, dt)
    _check_mevp(solver, carry, consts)
    u = carry[0]
    _check(u.shape, u.device, c_w=c_w, inv_drag=inv_drag)
    planes = (u.clone(), carry[1].clone(), *carry[2:])
    _mevp_half_(
        "mevp_velocity", planes, _mevp_consts(consts), c_w, inv_drag,
        _mevp_scalars(solver, dt), _stream(u.device),
    )
    return planes[0], planes[1]


def dg1_sample_cfl_reference(transport: DGTransport, u, v):
    """(max |vx|, max |vy|) over the quadrature points, as a (2,) tensor."""
    qv = velocity_from_cg(transport.mesh, transport.basis, u, v)
    return torch.stack(max_speeds(qv))


def dg1_sample_cfl(transport: DGTransport, u, v):
    """The two max quadrature speeds of the CFL count, as a (2,) tensor."""
    if _on_cpu(u):
        return dg1_sample_cfl_reference(transport, u, v)
    _check((transport.mesh.nx, transport.mesh.ny), u.device, u=u, v=v)
    speeds = torch.zeros(2, device=u.device, dtype=torch.float32)
    _dg1_sample_cfl_(u, v, speeds, _dg1_tables(transport), _stream(u.device))
    return speeds


def dg1_rk_stage_reference(
    transport: DGTransport, psi, base, u, v, face_x, face_y,
    a: float, b: float, dt_sub: float,
):
    """lim(a base + b (psi + dt_sub rhs(psi))), or lim(psi + dt_sub rhs(psi))
    when a == 0, on (3, T, nx, ny) dG1 coefficients."""
    qv = velocity_from_cg(transport.mesh, transport.basis, u, v)
    value = psi + dt_sub * transport.rhs(psi, qv, (face_x, face_y))
    if a != 0.0:
        value = a * base + b * value
    return transport.limit_positivity(value)


def dg1_rk_stage(
    transport: DGTransport, psi, base, u, v, face_x, face_y,
    a: float, b: float, dt_sub: float,
):
    """One limited SSP-RK stage of the dG1 tracers (see the reference)."""
    if _on_cpu(psi):
        return dg1_rk_stage_reference(
            transport, psi, base, u, v, face_x, face_y, a, b, dt_sub
        )
    nx, ny = transport.mesh.nx, transport.mesh.ny
    _check((nx, ny), psi.device, u=u, v=v, face_x=face_x, face_y=face_y)
    _check((3, psi.shape[1], nx, ny), psi.device, psi=psi, base=base)
    out = torch.empty_like(psi)
    _dg1_rk_stage_(
        psi, base, u, v, face_x, face_y, _dg1_metric(transport, psi.device), out, a, b,
        dt_sub, _dg1_tables(transport), _stream(psi.device),
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
    on copies of the inputs. CPU tensors run the plain version."""
    if _on_cpu(carry[0]):
        return mevp_subcycles_reference(solver, carry, consts, dt, n_subcycles)
    _check_mevp(solver, carry, consts)
    planes = tuple(t.clone() for t in carry)
    c_w, inv_drag = torch.empty_like(planes[0]), torch.empty_like(planes[0])
    scalars, stream = _mevp_scalars(solver, dt), _stream(planes[0].device)
    const_ptrs = _mevp_consts(consts)
    for _ in range(n_subcycles):
        _mevp_half_("mevp_stress", planes, const_ptrs, c_w, inv_drag, scalars, stream)
        _mevp_half_("mevp_velocity", planes, const_ptrs, c_w, inv_drag, scalars, stream)
    return planes


def transport_substeps_reference(
    transport: DGTransport, tracers, u, v, dt_sub: float, k: int, face_masks=None, qv=None,
):
    """k x ``transport.step(limit=True)`` with the velocity sampled from the
    CG1 nodes (u, v), or with the precomputed quadrature velocity ``qv``
    (the HO path; u and v are then not read); ``tracers`` is (3, T, nx, ny)."""
    if qv is None:
        qv = velocity_from_cg(transport.mesh, transport.basis, u, v)
    for _ in range(k):
        tracers = transport.step(tracers, qv, dt_sub, limit=True, face_masks=face_masks)
    return tracers


def _face_planes(like, face_masks, shape):
    if face_masks is None:
        return torch.ones_like(like), torch.ones_like(like)
    face_x, face_y = face_masks
    _check(shape, like.device, face_x=face_x, face_y=face_y)
    return face_x, face_y


def transport_substeps(
    transport: DGTransport, tracers, u, v, dt_sub: float, k: int, face_masks=None,
):
    """The tracers after k limited SSP-RK substeps on K1's schedule: one
    ``dg1_rk_stage`` launch per RK stage. CPU tensors run the plain version."""
    if _on_cpu(tracers):
        return transport_substeps_reference(transport, tracers, u, v, dt_sub, k, face_masks)
    shape = (transport.mesh.nx, transport.mesh.ny)
    _check(shape, tracers.device, u=u, v=v)
    _check((3, tracers.shape[1], *shape), tracers.device, tracers=tracers)
    face_x, face_y = _face_planes(u, face_masks, shape)
    tables, stream = _dg1_tables(transport), _stream(tracers.device)
    metric = _dg1_metric(transport, tracers.device)
    # A stage reads its neighbours' psi, so stages ping-pong between
    # buffers; the last stage may overwrite the step's base in place (each
    # element reads only its own base value).
    stages = _RK_STAGES[transport.scheme]
    psi0 = tracers.clone()
    spare = [torch.empty_like(psi0) for _ in range(max(1, len(stages) - 1))]
    for _ in range(k):
        cur = psi0
        for s, (a, b) in enumerate(stages):
            out = psi0 if (s > 0 and s == len(stages) - 1) else spare[s]
            _dg1_rk_stage_(
                cur, psi0, u, v, face_x, face_y, metric, out, a, b, dt_sub, tables, stream
            )
            cur = out
        if cur is not psi0:  # rk1: the single stage wrote a spare buffer
            psi0, spare[0] = cur, psi0
    return psi0


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
    (3, T, nx, ny) stacked dG1 coefficients; ``consts``: the output of
    ``MEVPSolver.step_consts``; ``face_masks``: optional (face_x, face_y).
    CPU tensors run ``fused_dynamics_reference``; CUDA tensors the kernels.
    The schedule on the card:

    * ``mevp="pallas"``: ``mevp_stress`` + ``mevp_velocity`` per subcycle
      (K1's schedule, ``mevp_subcycles``); ``"single"``: ``mevp_single``,
      all N subcycles in one launch (``mevp_single_cuda``);
      ``"pallas-tiled"``: ``mevp_tiled``, H subcycles per launch
      (``mevp_tiled_cuda``);
    * then ``dg1_sample_cfl`` and one host sync for k;
    * ``transport="xla"``: one ``dg1_rk_stage`` per RK stage (K1's
      schedule, ``transport_substeps``); ``"tiled"``: ``transport_tiled``,
      whole substeps per launch (``transport_tiled_cuda``).

    With the HO solver (``model.is_high_order``) ``state_arrays`` is the HO
    carry and ``consts`` the output of ``MEVPSolverHO.step_consts``;
    ``mevp`` is ``"single"`` or ``"tiled"`` and ``transport`` must be
    ``"tiled"`` (``_ho_dynamics_phase``).

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
    from .mevp_single_cuda import mevp_subcycles_single
    from .mevp_tiled_cuda import mevp_subcycles_tiled
    from .transport_tiled_cuda import transport_substeps_tiled

    run_mevp = {
        "pallas": mevp_subcycles, "single": mevp_subcycles_single,
        "pallas-tiled": mevp_subcycles_tiled,
    }
    run_transport = {"xla": transport_substeps, "tiled": transport_substeps_tiled}
    if mevp not in run_mevp or transport not in run_transport:
        raise ValueError(f"unknown schedule: mevp={mevp!r}, transport={transport!r}")
    solver, tr, mesh = model.mevp, model.transport, model.mesh
    device = tracers.device
    _check((3, tracers.shape[1], mesh.nx, mesh.ny), device, tracers=tracers)
    face_masks = _face_planes(state_arrays[0], face_masks, (mesh.nx, mesh.ny))
    planes = run_mevp[mevp](solver, state_arrays, consts, dt, n_subcycles)
    u, v = planes[0], planes[1]

    # CFL substep count: the one host sync of the step.
    if model.auto_substeps:
        speeds = torch.zeros(2, device=device, dtype=torch.float32)
        _dg1_sample_cfl_(u, v, speeds, _dg1_tables(tr), _stream(device))
        k = _k_of_speeds(model, speeds, dt)
    else:
        k = model.transport_substeps
    return planes, run_transport[transport](tr, tracers, u, v, dt / k, k, face_masks)


def _spmd_dynamics_phase(
    model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, mevp, transport,
):
    """``dynamics_phase`` on one rank of a rank grid: the N subcycles on the
    solver's exchange schedule (``mevp``: "blocked", "rdma" or "xla"); the
    max speeds of the rank's own elements, the max over the ranks and k;
    then ``transport="tiled"``: ``transport_substeps_tiled_spmd``
    (transport_tiled on the block widened by H), or ``"xla"``: the plain
    staged transport with width-1 exchanges, on CPU tensors only.

    With the tiled transport the velocity is widened by H once: on a card
    ``dg1_sample_cfl`` samples the block's own elements inside it (the nodes
    beyond the block are the neighbours'), and the transport advects with
    it."""
    from .transport_tiled_cuda import transport_substeps_tiled_spmd, widen_velocity

    solver, tr, mesh = model.mevp, model.transport, model.mesh
    if mevp != solver.schedule() or transport not in ("tiled", "xla"):
        raise ValueError(
            f"unknown rank-grid schedule: mevp={mevp!r} (the solver runs "
            f"{solver.schedule()!r}), transport={transport!r}"
        )
    on_cpu = _on_cpu(tracers)
    if transport == "xla" and not on_cpu:
        raise NotImplementedError(
            "on a card the rank grid advects with transport_tiled only; the plain "
            "staged transport with width-1 exchanges ('xla') takes CPU tensors "
            f"(transport_backend={model.transport_backend!r}: {tr.scheme} on a "
            f"{mesh.nx} x {mesh.ny} block)"
        )
    planes = solver.spmd_subcycles(state_arrays, consts, dt, n_subcycles)
    u, v = planes[0], planes[1]
    velocity_w = widen_velocity(model, u, v) if transport == "tiled" else None
    if not model.auto_substeps:
        k = model.transport_substeps
    elif on_cpu:
        k = _substeps(model, velocity_from_cg(mesh, tr.basis, u, v, model.spmd), dt)
    else:
        H = (velocity_w.shape[1] - mesh.nx) // 2
        speeds = torch.zeros(2, device=u.device, dtype=torch.float32)
        _dg1_sample_cfl_(
            velocity_w[0], velocity_w[1], speeds, _dg1_tables(tr), _stream(u.device), halo=H
        )
        k = _k_of_speeds(model, speeds, dt)
    if transport == "tiled":
        return planes, transport_substeps_tiled_spmd(model, tracers, velocity_w, dt / k, k, face_masks)
    qv = velocity_from_cg(mesh, tr.basis, u, v, model.spmd)
    return planes, transport_substeps_reference(tr, tracers, None, None, dt / k, k, face_masks, qv=qv)


def _ho_dynamics_phase(
    model, state_arrays, tracers, consts, dt, n_subcycles, face_masks, mevp, transport,
):
    """``dynamics_phase`` with the HO solver on the card: ``mevp="single"``
    runs ho_single, ``"tiled"`` ho_tiled; the transport is transport_tiled
    on the precomputed CG2 samples (``transport="tiled"``; the staged
    dg1_rk_stage takes CG1 (u, v) only)."""
    from .ho_single_cuda import ho_subcycles_single
    from .ho_tiled_cuda import ho_subcycles_tiled
    from .transport_tiled_cuda import transport_substeps_tiled

    run_mevp = {"single": ho_subcycles_single, "tiled": ho_subcycles_tiled}
    if mevp not in run_mevp:
        raise ValueError(f"unknown HO schedule: mevp={mevp!r}")
    if transport != "tiled":
        raise NotImplementedError(
            f"the HO path on the card runs transport_tiled only, not {transport!r}: "
            "dg1_rk_stage takes CG1 (u, v)"
        )
    mesh, tr = model.mesh, model.transport
    _check((3, tracers.shape[1], mesh.nx, mesh.ny), tracers.device, tracers=tracers)
    carry = run_mevp[mevp](model.mevp, state_arrays, consts, dt, n_subcycles)
    qv = ho_velocity_to_quad(mesh, tr.basis, carry[0], carry[1])
    k = _substeps(model, qv, dt)
    return carry, transport_substeps_tiled(tr, tracers, None, None, dt / k, k, face_masks, qv=qv)


def fused_dynamics(
    model, state_arrays, tracers, consts: dict, dt: float, n_subcycles: int,
    face_masks=None,
):
    """The dynamics phase on K1's schedule (``dynamics_phase`` with
    ``mevp="pallas"``, ``transport="xla"``)."""
    return dynamics_phase(
        model, state_arrays, tracers, consts, dt, n_subcycles, face_masks,
        mevp="pallas", transport="xla",
    )
