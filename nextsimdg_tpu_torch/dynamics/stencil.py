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

On a rank grid (``nextsimdg_tpu_torch.parallel``) a tensor is one rank's
block of the global domain. Each function then takes that rank's
``AxisExchange`` for the shifted axis (``RankExchange.axes[0]`` for x,
``[1]`` for y) where the JAX package takes a device-mesh axis name: the
missing slice comes from the neighbour rank, and a closed global wall
receives zeros. On a periodic axis the exchange is a ring of ranks
(``AxisExchange.periodic``): the last rank's +1 neighbour is the first, as
``lax.ppermute`` over the JAX package's ring permutation. With none given
they act on the whole domain.
"""

from __future__ import annotations

import torch


def _zero_slab(f: torch.Tensor, axis: int) -> torch.Tensor:
    shape = list(f.shape)
    shape[axis] = 1
    return f.new_zeros(shape)


def shift_p(f: torch.Tensor, axis: int, periodic: bool, exchange=None) -> torch.Tensor:
    """f[i+1] along ``axis``: the +1 neighbour; zero-filled when closed.

    With ``exchange`` the last slice is the +1 neighbour rank's first
    (zeros on the rank at the global last wall).
    """
    n = f.shape[axis]
    if exchange is not None:
        _, recv = exchange.wait(exchange.start(f.narrow(axis, 0, 1), None))
        return torch.cat([f.narrow(axis, 1, n - 1), recv], dim=axis)
    if periodic:
        return torch.roll(f, -1, dims=axis)
    return torch.cat([f.narrow(axis, 1, n - 1), _zero_slab(f, axis)], dim=axis)


def shift_m(f: torch.Tensor, axis: int, periodic: bool, exchange=None) -> torch.Tensor:
    """f[i-1] along ``axis``: the -1 neighbour; zero-filled when closed.

    With ``exchange`` the first slice is the -1 neighbour rank's last
    (zeros on the rank at the global first wall).
    """
    n = f.shape[axis]
    if exchange is not None:
        recv, _ = exchange.wait(exchange.start(None, f.narrow(axis, n - 1, 1)))
        return torch.cat([recv, f.narrow(axis, 0, n - 1)], dim=axis)
    if periodic:
        return torch.roll(f, 1, dims=axis)
    return torch.cat([_zero_slab(f, axis), f.narrow(axis, 0, n - 1)], dim=axis)


def halo_widen(f: torch.Tensor, h: int, axis: int, periodic: bool, exchange=None) -> torch.Tensor:
    """``f`` extended by h-wide neighbour strips on both sides of ``axis``.

    One strip pair per axis for h subcycles: the ghost-zone ("temporally
    blocked") exchange of the blocked mEVP and the spmd tiled transport.
    Without ``exchange`` (or at a closed global wall) the strips are zeros,
    the wall condition; periodic axes wrap (with ``exchange``, round the
    ring of ranks). Widening axis 0 first and then
    axis 1 of the result fills the corners: the second exchange carries
    the first one's strips.
    """
    n = f.shape[axis]
    if h > n:
        raise ValueError(f"halo {h} is wider than the block ({n} along axis {axis})")
    lo_strip, hi_strip = f.narrow(axis, 0, h), f.narrow(axis, n - h, h)
    if exchange is not None:
        lo, hi = exchange.wait(exchange.start(lo_strip, hi_strip))
    elif periodic:
        lo, hi = hi_strip, lo_strip
    else:
        lo, hi = torch.zeros_like(hi_strip), torch.zeros_like(lo_strip)
    return torch.cat([lo, f, hi], dim=axis)


def _neighbour_strip(strip: torch.Tensor, side: int, periodic: bool, exchange=None) -> torch.Tensor:
    """What the ``side`` (+1 or -1) neighbour sends of the strip that this
    rank sends the other way: through ``exchange``, or without one the
    strip itself on a periodic axis and zeros on a closed one."""
    if exchange is not None:
        sent = (strip, None) if side > 0 else (None, strip)
        from_prev, from_next = exchange.wait(exchange.start(*sent))
        return from_next if side > 0 else from_prev
    return strip if periodic else torch.zeros_like(strip)


def plus_strips(f: torch.Tensor, periodic=(False, False), axes=(None, None)):
    """(x, y): the +1 neighbours' strips of the stacked planes ``f`` (C, nx,
    ny) that a width-1 stencil reads beyond the block at i = nx and j = ny:
    x (C, ny) the +1 x neighbour's first row, y (C, nx + 1) the +1 y
    neighbour's first column of its block extended by the x strip it got,
    so that y[:, nx] is the diagonal neighbour's corner (x then extended y,
    as ``halo_widen``'s corners). ``axes``: the rank's (x, y) exchanges;
    without one an axis wraps or reads zeros. The strips sent are copies, so
    the planes may change in place as soon as this returns."""
    x = _neighbour_strip(f[:, 0, :].clone(memory_format=torch.contiguous_format), 1, periodic[0], axes[0])
    y = _neighbour_strip(torch.cat([f[:, :, 0], x[:, :1]], dim=1), 1, periodic[1], axes[1])
    return x, y


def minus_strips(f: torch.Tensor, periodic=(False, False), axes=(None, None)):
    """(x, y): the -1 neighbours' strips of ``f`` (C, nx, ny) at i = -1 and
    j = -1, as ``plus_strips``: x (C, ny) the -1 x neighbour's last row, y
    (C, nx + 1) the -1 y neighbour's last column extended by its x strip,
    y[:, 0] the diagonal neighbour's corner."""
    x = _neighbour_strip(f[:, -1, :].clone(memory_format=torch.contiguous_format), -1, periodic[0], axes[0])
    y = _neighbour_strip(torch.cat([x[:, -1:], f[:, :, -1]], dim=1), -1, periodic[1], axes[1])
    return x, y


def is_global_edge(side: str, exchange=None) -> bool:
    """Whether this block owns the global first or last slice along the
    axis of ``exchange``: always True without one (the block is the
    domain). It does not know whether the axis is periodic: callers test
    that first, as the JAX package's do."""
    if side not in ("first", "last"):
        raise ValueError(f"side must be 'first' or 'last', got {side!r}")
    if exchange is None:
        return True
    return exchange.index == 0 if side == "first" else exchange.index == exchange.size - 1
