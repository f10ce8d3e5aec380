"""N CG1 mEVP subcycles in one launch: the ``mevp_single`` CUDA kernel.

Counterpart of ``nextsimdg_tpu/dynamics/kernels/mevp_pallas.py``, whose
``mevp_subcycles_pallas`` runs all N subcycles in one call with the whole
grid resident in VMEM, over the 5 state planes and the solver's const set
(7 planes on a uniform mesh, 12 with the metric planes of a graded or
spherical one). Here (``csrc/mevp_single.cu``) one cooperative launch of
as many blocks as can be resident at once runs all N subcycles: per
subcycle a grid-stride pass over the elements, a grid-wide barrier, a pass
over the nodes and another barrier, on planes in global memory (in L2
where they fit).

Plain version: N x ``MEVPSolver.subcycle_body``
(``mevp_single_reference``). The kernel runs the element and node code of
``mevp_stress``/``mevp_velocity`` of ``coupled_cuda``, so it equals N
subcycles of that schedule, and of ``mevp_tiled``, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..mevp import MEVPSolver
from . import coupled_cuda as cc

KERNEL = "mevp_single"

#: The plain version: N x MEVPSolver.subcycle_body.
mevp_single_reference = cc.mevp_subcycles_reference


def max_blocks(metric: bool, device) -> int:
    """The most blocks that can be resident at once: the grid of a default
    launch (fewer when the grid has fewer 8 x 32 patches)."""
    count = cc._library().nst_mevp_single_max_blocks(int(metric), torch.device(device).index)
    if count <= 0:
        raise RuntimeError(f"mevp_single: no resident blocks (CUDA error {-count})")
    return count


def mevp_subcycles_single(
    solver: MEVPSolver, carry, consts, dt: float, n_subcycles: int, blocks: int = 0,
):
    """(u, v, s11, s22, s12) after ``n_subcycles`` subcycles.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    run ``mevp_single``: one cooperative launch of ``blocks`` blocks (0:
    as many as can be resident), in place on copies of the inputs, which
    are not modified. A grid larger than the resident limit raises.
    """
    if cc._on_cpu(carry[0]):
        return mevp_single_reference(solver, carry, consts, dt, n_subcycles)
    cc._check_mevp(solver, carry, consts)
    if n_subcycles < 0 or blocks < 0:
        raise ValueError(f"n_subcycles ({n_subcycles}) and blocks ({blocks}) must be >= 0")
    planes = tuple(t.clone() for t in carry)
    if n_subcycles == 0:
        return planes
    u = planes[0]
    nx, ny = u.shape
    c_w, inv_drag = torch.empty_like(u), torch.empty_like(u)
    scalars = cc._mevp_scalars(solver, dt)
    cc._launch(
        KERNEL, *(t.data_ptr() for t in planes), c_w.data_ptr(), inv_drag.data_ptr(),
        cc._mevp_consts(consts), nx, ny, n_subcycles, blocks, ctypes.addressof(scalars),
        u.device.index, cc._stream(u.device),
    )
    return planes
