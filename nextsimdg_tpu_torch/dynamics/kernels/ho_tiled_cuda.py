"""N higher-order mEVP subcycles by ghost-zone tiles: the ``ho_tiled`` CUDA
kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py``, whose
``ho_subcycles_tiled`` runs halo_x HO subcycles per round on full-row
halo'd blocks of the 17 state and 29 const planes in VMEM. Here
(``csrc/ho_tiled.cu``) each thread block loads the (tile + 2 halo)^2
window of the 17 state planes into shared memory, runs up to ``halo``
subcycles on it and writes back its tile; one launch per round,
``ceil(N / halo)`` rounds, ping-ponging between two (17, nx, ny) buffers.
The 29 const planes are read from global memory.

Plain version: N x ``MEVPSolverHO.subcycle_body``
(``ho_tiled_reference``). The kernel runs the element and node bodies of
``ho_single``, so the two schedules agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..mevp_ho import MEVPSolverHO, ho_subcycles_reference
from . import coupled_cuda as cc

KERNEL = "ho_tiled"

#: Tile and halo of the launch (elements per side; halo = subcycles per
#: launch) and threads per block. Chosen on the H100 by chip_smoke.py's
#: sweep; see PERF.md.
TILE = 32
HALO = 8
THREADS = 512

#: The plain version: N x MEVPSolverHO.subcycle_body.
ho_tiled_reference = ho_subcycles_reference


def shared_bytes(tile: int = TILE, halo: int = HALO) -> int:
    """Dynamic shared memory of one block: 17 planes of (tile + 2 halo)^2."""
    return 17 * (tile + 2 * halo) ** 2 * 4


def ho_subcycles_tiled(
    solver: MEVPSolverHO, carry, consts, dt: float, n_subcycles: int,
    tile: int = TILE, halo: int = HALO, threads: int = THREADS,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` HO subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``ho_tiled``, one launch per ``halo`` subcycles. The inputs are not
    modified.
    """
    if cc._on_cpu(carry[0].v):
        return ho_tiled_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_ho(solver, carry, consts)
    if tile < 1 or halo < 1:
        raise ValueError(f"tile ({tile}) and halo ({halo}) must be positive")
    src = cc.ho_flatten(carry)
    _, nx, ny = src.shape
    scalars, tables = cc._ho_scalars(solver, dt), cc._ho_tables(solver)
    stream = cc._stream(src.device)
    const_ptrs = cc._ho_consts(consts)
    buffers = [src, torch.empty_like(src)]
    done = 0
    while done < n_subcycles:
        n_sub = min(halo, n_subcycles - done)
        dst = buffers[1] if src is buffers[0] else buffers[0]
        cc._launch(
            KERNEL, src.data_ptr(), dst.data_ptr(), const_ptrs, nx, ny, tile, halo, n_sub,
            threads, ctypes.addressof(scalars), ctypes.addressof(tables), src.device.index,
            stream,
        )
        src = dst
        done += n_sub
    return cc.ho_unflatten(src)
