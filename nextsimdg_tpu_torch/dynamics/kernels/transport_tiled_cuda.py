"""k limited SSP-RK dG1 substeps by ghost-zone tiles: the ``transport_tiled``
CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/transport_tiled.py``, whose
``transport_substeps_tiled`` runs up to ``K_CAP`` substeps per round on
halo'd blocks in VMEM, re-sampling the velocity per block. Here
(``csrc/transport_tiled.cu``) each thread block loads the
(tile + 2 halo)^2 window of u, v and the tracer coefficients into shared
memory, samples the quadrature velocity there, runs up to
``K_CAP = (halo - 1) // stages`` substeps and writes back its tile; one
launch per round, ``ceil(k / K_CAP)`` rounds, ping-ponging between two
buffers. The host knows k (``dynamics_phase`` reads it back once), so it
sizes the halo to k: ``stages * min(k, K_MAX) + 1``.

Plain version: ``velocity_from_cg`` and k x ``DGTransport.step(limit=True)``
(``transport_substeps_tiled_reference``). The kernel runs the element body
of ``dg1_rk_stage``, so it also equals k substeps of that schedule bit for
bit. rk1 and rk2 (the default) are covered; rk3 raises on CUDA tensors.
On a graded or spherical mesh it reads the transport's 5 metric planes
from global memory, beside the coastline face masks.

The HO path passes ``qv``, the quadrature velocity that
``ho_velocity_to_quad`` sampled from the CG2 velocity (at dG1 4 + 4 volume
and 2 + 2 face planes), instead of (u, v): the kernel reads those planes
from global memory and skips its own sampling, as the JAX kernel takes them
as constant planes.
"""

from __future__ import annotations

import ctypes

import torch

from ..transport import DGTransport, QuadVelocity
from . import coupled_cuda as cc

KERNEL = "transport_tiled"

#: Elements per side of a block's tile and threads per block; chosen on
#: the H100 by chip_smoke.py's sweep, see PERF.md.
TILE = 32
THREADS = 768
#: Most substeps per launch; more run in further launches.
K_MAX = 3

_STAGES = {"rk1": (1, 0.0, 1.0), "rk2": (2, 0.5, 0.5)}
#: The planes of a dG1 QuadVelocity, in the order of Dg1QvPlanes.
_QV_PLANES = {"vx_vol": 4, "vy_vol": 4, "vn_x": 2, "vn_y": 2}


#: The plain version: k x DGTransport.step(limit=True).
transport_substeps_tiled_reference = cc.transport_substeps_reference


def halo_for(k: int, stages: int) -> int:
    """The halo that fits min(k, K_MAX) substeps in one launch."""
    return stages * min(max(k, 1), K_MAX) + 1


def shared_bytes(tile: int, halo: int, n_tracers: int = 3) -> int:
    """Dynamic shared memory of one block: u, v and two coefficient buffers."""
    return (2 + 2 * 3 * n_tracers) * (tile + 2 * halo) ** 2 * 4


def _qv_planes(qv: QuadVelocity, shape, device):
    """Dg1QvPlanes of csrc/transport_tiled.cu: the 12 plane pointers."""
    stacks = {"vx_vol": qv.vx_vol, "vy_vol": qv.vy_vol, "vn_x": qv.vn_x, "vn_y": qv.vn_y}
    for name, count in _QV_PLANES.items():
        cc._check((count, *shape), device, **{name: stacks[name]})
    return cc._pointers([plane for name in _QV_PLANES for plane in stacks[name]])


def transport_substeps_tiled(
    transport: DGTransport, tracers, u, v, dt_sub: float, k: int, face_masks=None,
    tile: int = TILE, halo: int = None, threads: int = THREADS, qv: QuadVelocity = None,
):
    """The tracers after k limited substeps of ``dt_sub``.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``transport_tiled``. The velocity is the CG1 (u, v), or the
    precomputed quadrature velocity ``qv`` (u and v are then not read).
    ``face_masks``: optional (face_x, face_y), ones without a coastline.
    The inputs are not modified.
    """
    if cc._on_cpu(tracers):
        return transport_substeps_tiled_reference(
            transport, tracers, u, v, dt_sub, k, face_masks, qv=qv
        )
    if transport.scheme not in _STAGES:
        raise NotImplementedError(
            f"the tiled transport kernel runs rk1 and rk2, not {transport.scheme}"
        )
    n_stages, a2, b2 = _STAGES[transport.scheme]
    nx, ny = transport.mesh.nx, transport.mesh.ny
    device = tracers.device
    cc._check((3, tracers.shape[1], nx, ny), device, tracers=tracers)
    if qv is None:
        cc._check((nx, ny), device, u=u, v=v)
        u_ptr, v_ptr, qv_ptrs = u.data_ptr(), v.data_ptr(), None
    else:
        u_ptr, v_ptr, qv_ptrs = None, None, _qv_planes(qv, (nx, ny), device)
    face_x, face_y = cc._face_planes(tracers[0, 0], face_masks, (nx, ny))
    halo = halo_for(k, n_stages) if halo is None else halo
    k_cap = (halo - 1) // n_stages
    if tile < 1 or k_cap < 1:
        raise ValueError(f"tile {tile} / halo {halo} leaves no substep per launch")
    tables = cc._dg1_tables(transport)
    metric = cc._dg1_metric(transport, device)
    stream = cc._stream(device)
    src = tracers
    buffers = [torch.empty_like(tracers) for _ in range(2)]
    done = 0
    while done < k:
        n_sub = min(k_cap, k - done)
        dst = buffers[0] if src is not buffers[0] else buffers[1]
        cc._launch(
            KERNEL, src.data_ptr(), dst.data_ptr(), u_ptr, v_ptr, face_x.data_ptr(),
            face_y.data_ptr(), metric, qv_ptrs, nx, ny, tracers.shape[1], tile, halo,
            n_sub, n_stages, threads, a2, b2, dt_sub, ctypes.addressof(tables), device.index,
            stream,
        )
        src = dst
        done += n_sub
    return src
