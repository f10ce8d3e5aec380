"""N CG1 mEVP subcycles by ghost-zone tiles: the ``mevp_tiled`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_tiled.py``, whose
``mevp_subcycles_tiled`` runs H subcycles per round on halo'd blocks in
VMEM. Here (``csrc/mevp_tiled.cu``) each thread block loads the
(tile + 2 halo)^2 window of the five state planes into shared memory, runs
up to ``halo`` subcycles on it and writes back its tile; one launch per
round, ``ceil(N / halo)`` rounds, ping-ponging between two sets of planes.
Each thread owns the same window cells (one column, every ``threads //
w``-th row) for the whole launch and keeps their c_w and inv_drag in
registers.

Plain version: N x ``MEVPSolver.subcycle_body``
(``mevp_subcycles_tiled_reference``). The kernel runs the same element and
node bodies as ``mevp_stress``/``mevp_velocity`` of ``coupled_cuda``, so
it also equals N rounds of that schedule bit for bit. It takes the 7
uniform consts or the 12 with the metric planes of a graded or spherical
mesh, and a_node besides in the A-weighted form, read from L1/L2 where
they are used; the solver's momentum form (``coupled_cuda.mevp_form``)
selects the kernel's template instance, and the adaptive form keeps each
cell's beta in registers beside c_w and inv_drag. On a periodic axis the
window loads wrap (the mesh's axes ride the form argument,
``coupled_cuda.kernel_form``).
"""

from __future__ import annotations

import ctypes

import torch

from ..mevp import MEVPSolver
from . import coupled_cuda as cc

KERNEL = "mevp_tiled"

#: Launch configurations (tile, halo, threads; halo = subcycles a launch),
#: chosen on the H100 by ``benchmarks.mevp_large --tiles`` (PERF.md): on a
#: uniform mesh from LARGE_MIN_ELEMENTS, two blocks of 512 threads an SM on
#: windows 64 wide; else (smaller grids, and the metric form, whose 12 const
#: planes gain nothing from the second block) one block of 1024 threads an
#: SM on windows 80 wide.
SMALL = (64, 8, 1024)
LARGE = (56, 4, 512)
LARGE_MIN_ELEMENTS = 2048 * 2048
#: Window rows a thread may own: the kernel's register slots (kTiledMaxCells, csrc/mevp_tiled.cu).
MAX_CELLS = 8


def launch_config(nx: int, ny: int, metric: bool = False) -> tuple:
    """(tile, halo, threads) that the host picks for an (nx, ny) grid, with
    or without the metric consts."""
    return LARGE if not metric and nx * ny >= LARGE_MIN_ELEMENTS else SMALL


#: The plain version: N x MEVPSolver.subcycle_body.
mevp_subcycles_tiled_reference = cc.mevp_subcycles_reference


def shared_bytes(tile: int, halo: int) -> int:
    """Dynamic shared memory of one block: the 5 state planes of the
    (tile + 2 halo)^2 window."""
    return 5 * (tile + 2 * halo) ** 2 * 4


def cells_per_thread(tile: int, halo: int, threads: int) -> int:
    """Window rows each thread owns (its column's cells), or 0 where a
    block has fewer threads than a window row."""
    w = tile + 2 * halo
    rows = threads // w
    return -(-w // rows) if rows else 0


def max_blocks(device, tile: int, halo: int, threads: int, metric: bool = False, form: int = 0) -> int:
    """Resident blocks per SM of a launch configuration on ``device`` in a
    momentum form (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; 0
    where it has no kernel or does not fit)."""
    device = torch.device(device)
    blocks = cc._library().nst_mevp_tiled_max_blocks(
        tile, halo, threads, int(metric), form, device.index or 0
    )
    if blocks < 0:
        raise RuntimeError(f"mevp_tiled occupancy: CUDA error {-1 - blocks}")
    return blocks


def mevp_subcycles_tiled(
    solver: MEVPSolver, carry, consts, dt: float, n_subcycles: int,
    tile: int = None, halo: int = None, threads: int = None,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``mevp_tiled``, one launch per ``halo`` subcycles, in the launch
    configuration given or else ``launch_config``'s. The inputs are not
    modified.
    """
    if cc._on_cpu(carry[0]):
        return mevp_subcycles_tiled_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_mevp(solver, carry, consts)
    u = carry[0]
    nx, ny = u.shape
    default = launch_config(nx, ny, not solver.mesh.uniform)
    tile, halo, threads = (d if x is None else x for x, d in zip((tile, halo, threads), default))
    if tile < 1 or halo < 1:
        raise ValueError(f"tile ({tile}) and halo ({halo}) must be positive")
    mesh = solver.mesh
    if (mesh.periodic_x and halo > nx) or (mesh.periodic_y and halo > ny):
        raise ValueError(f"halo {halo} is wider than a periodic axis of the {nx} x {ny} grid")
    scalars = cc._mevp_scalars(solver, dt)
    stream = cc._stream(u.device)
    const_ptrs = cc._mevp_consts(consts)
    form = cc.kernel_form(solver)
    src = tuple(carry)
    buffers = [tuple(torch.empty_like(u) for _ in range(5)) for _ in range(2)]
    done = 0
    while done < n_subcycles:
        n_sub = min(halo, n_subcycles - done)
        dst = buffers[0] if src is not buffers[0] else buffers[1]
        cc._launch(
            KERNEL, *(t.data_ptr() for t in src), *(t.data_ptr() for t in dst), const_ptrs,
            nx, ny, tile, halo, n_sub, threads, form, ctypes.addressof(scalars), u.device.index,
            stream,
        )
        src = dst
        done += n_sub
    return src
