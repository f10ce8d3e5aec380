"""N higher-order mEVP subcycles in one launch: the ``ho_single`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py``, whose
``ho_subcycles_pallas`` runs all N HO subcycles in one call with the 17
state planes (4 + 4 CG2 velocity, 3 x 3 dG1 stress coefficients) and the
29 const planes resident in VMEM. Here (``csrc/ho_single.cu``) one
cooperative launch of as many blocks as can be resident at once runs all
N subcycles: per subcycle a grid-stride pass over the elements (the stress
half), a grid-wide barrier, a pass over the node indices (the velocity
half) and another barrier, on planes in global memory (in L2 where they
fit).

Plain version: N x ``MEVPSolverHO.subcycle_body``
(``ho_single_reference``). The kernel runs the element and node bodies of
``ho_tiled``, so the two schedules agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..mevp_ho import MEVPSolverHO, ho_subcycles_reference
from . import coupled_cuda as cc

KERNEL = "ho_single"

#: The plain version: N x MEVPSolverHO.subcycle_body.
ho_single_reference = ho_subcycles_reference


def max_blocks(device) -> int:
    """The most 256-thread blocks that can be resident at once: the grid of
    a default launch (fewer when the grid has fewer elements)."""
    count = cc._library().nst_ho_single_max_blocks(torch.device(device).index)
    if count <= 0:
        raise RuntimeError(f"ho_single: no resident blocks (CUDA error {-count})")
    return count


def ho_subcycles_single(
    solver: MEVPSolverHO, carry, consts, dt: float, n_subcycles: int, blocks: int = 0,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` HO subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``ho_single``: one cooperative launch of ``blocks`` blocks (0: as
    many as can be resident), in place on a flat copy of the carry
    (``coupled_cuda.ho_flatten``), so the inputs are not modified. A grid
    larger than the resident limit raises.
    """
    if cc._on_cpu(carry[0].v):
        return ho_single_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_ho(solver, carry, consts)
    if n_subcycles < 0 or blocks < 0:
        raise ValueError(f"n_subcycles ({n_subcycles}) and blocks ({blocks}) must be >= 0")
    state = cc.ho_flatten(carry)
    if n_subcycles == 0:
        return cc.ho_unflatten(state)
    _, nx, ny = state.shape
    scalars, tables = cc._ho_scalars(solver, dt), cc._ho_tables(solver)
    cc._launch(
        KERNEL, state.data_ptr(), cc._ho_consts(consts), nx, ny, n_subcycles, blocks,
        ctypes.addressof(scalars), ctypes.addressof(tables), state.device.index,
        cc._stream(state.device),
    )
    return cc.ho_unflatten(state)
