"""N CG1 mEVP subcycles by ghost-zone tiles: the ``mevp_tiled`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_tiled.py``, whose
``mevp_subcycles_tiled`` runs H subcycles per round on halo'd blocks in
VMEM. Here (``csrc/mevp_tiled.cu``) each thread block loads the
(tile + 2 halo)^2 window of the five state planes into shared memory, runs
up to ``halo`` subcycles on it and writes back its tile; one launch per
round, ``ceil(N / halo)`` rounds, ping-ponging between two sets of planes.

Plain version: N x ``MEVPSolver.subcycle_body``
(``mevp_subcycles_tiled_reference``). The kernel runs the same element and
node bodies as ``mevp_stress``/``mevp_velocity`` of ``coupled_cuda``, so
it also equals N rounds of that schedule bit for bit. It takes the 7
uniform consts or the 12 with the metric planes of a graded or spherical
mesh; the metric planes are read from global memory like the other
consts, so shared memory does not grow.
"""

from __future__ import annotations

import ctypes

import torch

from ..mevp import MEVPSolver
from . import coupled_cuda as cc

KERNEL = "mevp_tiled"

#: Tile and halo of the launch (elements per side; halo = subcycles per
#: launch) and threads per block. Chosen on the H100 by chip_smoke.py's
#: sweep; see PERF.md.
TILE = 64
HALO = 8
THREADS = 1024


#: The plain version: N x MEVPSolver.subcycle_body.
mevp_subcycles_tiled_reference = cc.mevp_subcycles_reference


def shared_bytes(tile: int = TILE, halo: int = HALO) -> int:
    """Dynamic shared memory of one block: 7 planes of (tile + 2 halo)^2."""
    return 7 * (tile + 2 * halo) ** 2 * 4


def mevp_subcycles_tiled(
    solver: MEVPSolver, carry, consts, dt: float, n_subcycles: int,
    tile: int = TILE, halo: int = HALO, threads: int = THREADS,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``mevp_tiled``, one launch per ``halo`` subcycles. The inputs are
    not modified.
    """
    if cc._on_cpu(carry[0]):
        return mevp_subcycles_tiled_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_mevp(solver, carry, consts)
    if tile < 1 or halo < 1:
        raise ValueError(f"tile ({tile}) and halo ({halo}) must be positive")
    u = carry[0]
    nx, ny = u.shape
    scalars = cc._mevp_scalars(solver, dt)
    stream = cc._stream(u.device)
    const_ptrs = cc._mevp_consts(consts)
    src = tuple(carry)
    buffers = [tuple(torch.empty_like(u) for _ in range(5)) for _ in range(2)]
    done = 0
    while done < n_subcycles:
        n_sub = min(halo, n_subcycles - done)
        dst = buffers[0] if src is not buffers[0] else buffers[1]
        cc._launch(
            KERNEL, *(t.data_ptr() for t in src), *(t.data_ptr() for t in dst), const_ptrs,
            nx, ny, tile, halo, n_sub, threads, ctypes.addressof(scalars), u.device.index,
            stream,
        )
        src = dst
        done += n_sub
    return src
