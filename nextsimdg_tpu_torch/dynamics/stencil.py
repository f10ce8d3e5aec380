"""Neighbour-shift primitives with boundary conditions.

All dynamics fields use the *owned* layout: tensors are exactly (..., nx, ny).

* cell fields: value of element (i, j);
* node fields: value of CG node (i, j). The i = nx / j = ny boundary nodes
  are not stored: for closed domains they are Dirichlet-zero, for periodic
  ones they wrap to index 0;
* x-edge fields: the face between elements (i-1, j) and (i, j). The right
  domain-boundary face is implicit (zero flux when closed, wraps when
  periodic); y-edges likewise.

The CUDA kernels follow the same contract: a read beyond nx or ny (or
below 0) is a zero, never a clamped index.
"""

from __future__ import annotations

import torch


def _zero_slab(f: torch.Tensor, axis: int) -> torch.Tensor:
    shape = list(f.shape)
    shape[axis] = 1
    return f.new_zeros(shape)


def shift_p(f: torch.Tensor, axis: int, periodic: bool) -> torch.Tensor:
    """f[i+1] along ``axis``: the +1 neighbour; zero-filled when closed."""
    if periodic:
        return torch.roll(f, -1, dims=axis)
    n = f.shape[axis]
    return torch.cat([f.narrow(axis, 1, n - 1), _zero_slab(f, axis)], dim=axis)


def shift_m(f: torch.Tensor, axis: int, periodic: bool) -> torch.Tensor:
    """f[i-1] along ``axis``: the -1 neighbour; zero-filled when closed."""
    if periodic:
        return torch.roll(f, 1, dims=axis)
    n = f.shape[axis]
    return torch.cat([_zero_slab(f, axis), f.narrow(axis, 0, n - 1)], dim=axis)


def is_global_edge(side: str) -> bool:
    """Whether this block owns the global first/last row along an axis.

    Always True: the port runs on one device, so its block is the domain.
    """
    if side not in ("first", "last"):
        raise ValueError(f"side must be 'first' or 'last', got {side!r}")
    return True
